"""MCP (Model Context Protocol) clients: stdio and HTTP transports.

The port's copy of ``semantic_router_tpu.mcp.client``: the router
consumes external MCP servers for tools and served classifiers.  Speaks
plain JSON-RPC 2.0:

- stdio: newline-delimited JSON to a spawned subprocess
  (``command`` + ``args``), the standard local MCP transport
- http: POST one JSON-RPC envelope per request

Surface: connect (initialize + capability load), tools/list,
tools/call, resources/list, prompts/list, ping, close.  Both transports
share request framing and error mapping through ``_BaseClient``.
"""

from __future__ import annotations

import itertools
import json
import queue
import subprocess
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PROTOCOL_VERSION = "2024-11-05"


class MCPError(Exception):
    def __init__(self, code: int, message: str, data: Any = None) -> None:
        super().__init__(f"MCP error {code}: {message}")
        self.code = code
        self.message = message
        self.data = data


@dataclass
class Tool:
    name: str
    description: str = ""
    input_schema: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ToolResult:
    content: List[Dict[str, Any]] = field(default_factory=list)
    is_error: bool = False

    @property
    def text(self) -> str:
        return "\n".join(c.get("text", "") for c in self.content
                         if c.get("type") == "text")


class _BaseClient:
    def __init__(self, name: str, timeout_s: float = 30.0) -> None:
        self.name = name
        self.timeout_s = timeout_s
        self.tools: List[Tool] = []
        self.resources: List[Dict[str, Any]] = []
        self.prompts: List[Dict[str, Any]] = []
        self.server_info: Dict[str, Any] = {}
        self._ids = itertools.count(1)
        self._connected = False

    # transport hook
    def _send(self, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def _request(self, method: str,
                 params: Optional[Dict[str, Any]] = None) -> Any:
        payload = {"jsonrpc": "2.0", "id": next(self._ids),
                   "method": method}
        if params is not None:
            payload["params"] = params
        reply = self._send(payload)
        if reply is None:
            raise MCPError(-32000, f"no reply to {method}")
        if "error" in reply:
            err = reply["error"] or {}
            raise MCPError(err.get("code", -32000),
                           err.get("message", "unknown error"),
                           err.get("data"))
        return reply.get("result")

    def _notify(self, method: str) -> None:
        try:
            self._send({"jsonrpc": "2.0", "method": method})
        except Exception:
            pass

    # -- MCPClient surface ----------------------------------------------

    def connect(self) -> "_BaseClient":
        result = self._request("initialize", {
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {},
            "clientInfo": {"name": "semantic-router-tpu",
                           "version": "0.2"},
        })
        self.server_info = (result or {}).get("serverInfo", {})
        self._notify("notifications/initialized")
        self.refresh_capabilities()
        self._connected = True
        return self

    def refresh_capabilities(self) -> None:
        try:
            listed = self._request("tools/list") or {}
            self.tools = [Tool(name=t.get("name", ""),
                               description=t.get("description", ""),
                               input_schema=t.get("inputSchema", {}) or {})
                          for t in listed.get("tools", [])]
        except MCPError:
            self.tools = []
        for attr, method, key in (("resources", "resources/list",
                                   "resources"),
                                  ("prompts", "prompts/list", "prompts")):
            try:
                listed = self._request(method) or {}
                setattr(self, attr, list(listed.get(key, [])))
            except MCPError:
                setattr(self, attr, [])

    def call_tool(self, name: str,
                  arguments: Optional[Dict[str, Any]] = None) -> ToolResult:
        result = self._request("tools/call", {
            "name": name, "arguments": arguments or {}}) or {}
        return ToolResult(content=list(result.get("content", [])),
                          is_error=bool(result.get("isError", False)))

    def ping(self) -> bool:
        try:
            self._request("ping")
            return True
        except Exception:
            return False

    @property
    def is_connected(self) -> bool:
        return self._connected

    def close(self) -> None:
        self._connected = False


class StdioClient(_BaseClient):
    """Spawns the MCP server as a child process; newline-delimited JSON
    over stdin/stdout (stdio_client.go role)."""

    def __init__(self, name: str, command: str,
                 args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 30.0) -> None:
        super().__init__(name, timeout_s)
        self.command = [command] + list(args or [])
        self.env = env
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._replies: "queue.Queue[dict]" = queue.Queue()

    def _pump_stdout(self, proc: subprocess.Popen) -> None:
        """Reader thread: a hung server must TIME OUT in _send (fail-open
        contract), never block a routing thread in readline()."""
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue  # non-JSON noise on stdout
            if "id" in msg:
                self._replies.put(msg)
            # server-initiated notifications are ignored

    def connect(self) -> "StdioClient":
        import os

        env = dict(os.environ)
        env.update(self.env or {})
        self._proc = subprocess.Popen(
            self.command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env, bufsize=1)
        threading.Thread(target=self._pump_stdout, args=(self._proc,),
                         daemon=True,
                         name=f"mcp-{self.name}-reader").start()
        try:
            super().connect()
        except Exception:
            # failed handshake must not leak the child process
            self.close()
            raise
        return self

    def _send(self, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if self._proc is None or self._proc.poll() is not None:
            raise MCPError(-32001, "server process not running")
        with self._lock:
            self._proc.stdin.write(json.dumps(payload) + "\n")
            self._proc.stdin.flush()
            if "id" not in payload:  # notification: no reply expected
                return None
            deadline = time.monotonic() + self.timeout_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise MCPError(-32002,
                                   f"timeout after {self.timeout_s}s "
                                   f"waiting for {payload.get('method')}")
                try:
                    msg = self._replies.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    if self._proc.poll() is not None:
                        raise MCPError(-32001, "server process exited")
                    continue
                if msg.get("id") == payload["id"]:
                    return msg
                # stale reply from a timed-out earlier request: drop

    def close(self) -> None:
        super().close()
        if self._proc is not None:
            try:
                self._proc.stdin.close()
                self._proc.terminate()
                self._proc.wait(timeout=5)
            except Exception:
                pass
            self._proc = None


class HTTPClient(_BaseClient):
    """One JSON-RPC envelope per POST (http_client.go role)."""

    def __init__(self, name: str, url: str,
                 headers: Optional[Dict[str, str]] = None,
                 timeout_s: float = 30.0) -> None:
        super().__init__(name, timeout_s)
        self.url = url
        self.headers = dict(headers or {})

    def _send(self, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(), method="POST")
        req.add_header("content-type", "application/json")
        for k, v in self.headers.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                raw = resp.read()
        except Exception as exc:
            raise MCPError(-32001, f"transport failure: {exc}")
        if "id" not in payload:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            raise MCPError(-32700, "invalid JSON from server")


def create_client(config: Dict[str, Any]) -> _BaseClient:
    """Factory from config (factory.go role):
    {name, transport: stdio|http, command/args/env | url/headers}."""
    name = str(config.get("name", "mcp"))
    transport = config.get("transport",
                           "stdio" if config.get("command") else "http")
    if transport == "stdio":
        return StdioClient(name, config["command"],
                           args=config.get("args"),
                           env=config.get("env"),
                           timeout_s=float(config.get("timeout_s", 30.0)))
    return HTTPClient(name, config["url"],
                      headers=config.get("headers"),
                      timeout_s=float(config.get("timeout_s", 30.0)))
