"""A live Kubernetes watch controller for the router's CRDs.

The port's copy of ``semantic_router_tpu.runtime.kubewatch`` (reference
role: pkg/k8s, the in-router controller that watches IntelligentPool /
IntelligentRoute and regenerates the config, and the operator's
controller loop, deploy/operator/semanticrouter_controller.go).  No
Kubernetes client package is needed: ``KubeClient`` speaks the verbs a
controller uses over ``urllib``:

- LIST  ``GET /apis/{group}/{version}/namespaces/{ns}/{plural}``;
- WATCH the same with ``?watch=1&resourceVersion=N``: a chunked stream of
  newline-delimited JSON events ``{"type": ADDED|MODIFIED|DELETED|
  BOOKMARK|ERROR, "object": {...}}``;
- PATCH ``.../{plural}/{name}/status`` (merge patch), best effort.

``KubeOperator`` keeps the informer discipline: list to seed its state
and resourceVersion, watch from there, reconcile (debounced) into the
config file on every event (``runtime/operator.py``'s ``reconcile``,
which the router's config watcher hot-swaps), re-list on 410 Gone and
reconnect with backoff when a stream dies.  ``stop()`` severs the live
streams, so shutdown is bounded.  ``attach_bus`` turns SLO alert
transitions and degradation-ladder moves on the runtime event bus into
``SLOAlertFiring`` / ``Degraded`` conditions and a ``scaleHint`` on the
first IntelligentPool's status, pushed from a thread of its own.

``MiniKubeAPI`` is the in-process stand-in (as ``MiniRedis`` is for
RESP): the same list / watch / status wire shapes over HTTP on loopback,
with ``apply`` / ``delete`` / ``expire_history`` for tests.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import ssl
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability.logging import component_event
from .operator import reconcile

GROUP, VERSION = "srt.tpu.dev", "v1alpha1"
_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeClient:
    """Minimal typed client: list + watch for one namespace."""

    def __init__(self, base_url: str, token: str = "",
                 namespace: str = "default",
                 ca_file: str = "", timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.namespace = namespace
        self.timeout_s = timeout_s
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if base_url.startswith("https"):
            self._ssl_ctx = ssl.create_default_context(
                cafile=ca_file or None)

    @classmethod
    def in_cluster(cls) -> "KubeClient":
        """Conventional in-cluster config: serviceaccount mounts +
        KUBERNETES_SERVICE_HOST/PORT."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(f"{_SA_DIR}/token") as f:
            token = f.read().strip()
        try:
            with open(f"{_SA_DIR}/namespace") as f:
                namespace = f.read().strip()
        except OSError:
            namespace = "default"
        return cls(f"https://{host}:{port}", token=token,
                   namespace=namespace, ca_file=f"{_SA_DIR}/ca.crt")

    def _path(self, plural: str) -> str:
        return (f"{self.base_url}/apis/{GROUP}/{VERSION}/namespaces/"
                f"{self.namespace}/{plural}")

    def _request(self, url: str, timeout: Optional[float] = None,
                 method: str = "GET", data: Optional[bytes] = None,
                 content_type: str = ""):
        req = urllib.request.Request(url, data=data, method=method)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        if content_type:
            req.add_header("Content-Type", content_type)
        kwargs: Dict[str, Any] = {"timeout": timeout or self.timeout_s}
        if self._ssl_ctx is not None:
            kwargs["context"] = self._ssl_ctx
        return urllib.request.urlopen(req, **kwargs)

    def patch_status(self, plural: str, name: str,
                     status: Dict[str, Any]) -> bool:
        """Merge-patch a CR's status subresource (the controller's
        reporting surface: SLO alert conditions + scale hints land
        here).  False on any failure — status is best-effort, the
        controller must keep reconciling without it."""
        body = json.dumps({"status": status}).encode()
        url = f"{self._path(plural)}/{name}/status"
        try:
            with self._request(url, method="PATCH", data=body,
                               content_type="application/"
                                            "merge-patch+json") as resp:
                return 200 <= resp.status < 300
        except (urllib.error.URLError, OSError, ValueError):
            return False

    def list(self, plural: str) -> Tuple[List[Dict], str]:
        """(items, resourceVersion)."""
        with self._request(self._path(plural)) as resp:
            body = json.loads(resp.read())
        return (body.get("items", []) or [],
                str((body.get("metadata") or {}).get(
                    "resourceVersion", "0")))

    def watch(self, plural: str, resource_version: str,
              on_event: Callable[[str, Dict], None],
              stop: threading.Event,
              timeout_s: float = 300.0,
              register: Optional[Callable] = None) -> None:
        """Stream events to ``on_event(type, object)`` until the server
        closes the stream or ``stop`` is set. Raises HTTPError(410) when
        the resourceVersion is too old — caller must re-list.

        ``register`` (optional) receives the live response stream, then
        None when the stream ends — the operator's stop() closes the
        registered stream so a watcher blocked in read1() wakes
        immediately instead of riding out the watch window (bounded
        shutdown)."""
        url = (f"{self._path(plural)}?watch=1"
               f"&resourceVersion={resource_version}"
               f"&timeoutSeconds={int(timeout_s)}")
        with self._request(url, timeout=timeout_s + 10) as resp:
            try:
                if register is not None:
                    register(resp)
                buf = b""
                while not stop.is_set():
                    try:
                        chunk = resp.read1(65536)
                    except Exception:
                        # a severed socket surfaces as OSError,
                        # ValueError, or http.client.IncompleteRead
                        # depending on where the reader was parked
                        if stop.is_set():
                            return  # stop() severed the stream under us
                        raise
                    if not chunk:
                        return  # server closed (watch window expired)
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        event = json.loads(line)
                        etype = event.get("type", "")
                        obj = event.get("object", {}) or {}
                        if etype == "ERROR":
                            code = int((obj.get("code") or 0))
                            if code == 410:
                                raise urllib.error.HTTPError(
                                    url, 410, "Gone", None, None)
                            component_event("kubewatch", "watch_error",
                                            level="warning",
                                            reason=str(obj)[:200])
                            continue
                        if etype != "BOOKMARK":
                            on_event(etype, obj)
            finally:
                if register is not None:
                    register(None)


class KubeOperator:
    """Informer-style controller: state from list+watch, debounced
    reconcile into the live config file (which the router's config
    watcher hot-swaps)."""

    PLURALS = ("intelligentpools", "intelligentroutes")

    def __init__(self, client: KubeClient, config_path: str,
                 debounce_s: float = 0.2,
                 backoff_s: float = 1.0) -> None:
        self.client = client
        self.config_path = config_path
        self.debounce_s = debounce_s
        self.backoff_s = backoff_s
        self._state: Dict[str, Dict[str, Dict]] = {
            p: {} for p in self.PLURALS}
        self._last_rv: Dict[str, int] = {}
        self._state_lock = threading.Lock()
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # live watch streams by plural: stop() closes them so watcher
        # threads blocked in read1() wake now, not at the watch-window
        # deadline (bounded shutdown)
        self._streams: Dict[str, Any] = {}
        self._streams_lock = threading.Lock()
        self.last_status = ""
        self.reconcile_count = 0
        # SLO / degradation reactions: runtime events land here as
        # Kubernetes-convention status conditions and a scale hint,
        # pushed to the IntelligentPool's /status
        self._bus_unsub: Optional[Callable[[], None]] = None
        self.status_conditions: Dict[str, Dict[str, Any]] = {}
        self.scale_hint = "steady"
        self._firing_objectives: Dict[str, str] = {}
        self._degradation_level = 0
        self.status_push_count = 0
        # status pushes run on their own thread: the event-bus callback
        # must never hold the SLO monitor's / degradation controller's
        # emitting thread hostage to a slow kube API (a 30s PATCH stall
        # inside the control loop would blind it during the incident)
        self._status_dirty = threading.Event()
        self._status_thread: Optional[threading.Thread] = None

    # -- SLO / degradation status surface ------------------------------

    def attach_bus(self, bus) -> "KubeOperator":
        """Subscribe to the runtime event bus: SLO alert transitions and
        degradation-ladder moves become CRD status conditions and a
        scale hint on the IntelligentPool — the operator now REACTS to
        the telemetry stack instead of only regenerating config."""
        if bus is None:
            return self
        if self._bus_unsub is not None:
            try:
                self._bus_unsub()
            except Exception:
                pass
        self._bus_unsub = bus.subscribe(self._on_runtime_event)
        if self._status_thread is None or not self._status_thread.is_alive():
            self._status_thread = threading.Thread(
                target=self._status_loop, daemon=True,
                name="kubewatch-status")
            self._status_thread.start()
        return self

    def _on_runtime_event(self, ev) -> None:
        """Event-bus callback: bookkeeping only — the PATCH happens on
        the status thread, so the emitter (SLO monitor / degradation
        controller) never blocks on the kube API."""
        try:
            from .events import (
                DEGRADATION_LEVEL_CHANGED,
                SLO_ALERT_FIRING,
                SLO_ALERT_RESOLVED,
            )

            if ev.stage == SLO_ALERT_FIRING:
                self._firing_objectives[str(ev.detail.get(
                    "objective", ""))] = str(ev.detail.get("severity",
                                                           "fast"))
            elif ev.stage == SLO_ALERT_RESOLVED:
                self._firing_objectives.pop(
                    str(ev.detail.get("objective", "")), None)
            elif ev.stage == DEGRADATION_LEVEL_CHANGED:
                self._degradation_level = int(ev.detail.get("to_level",
                                                            0))
            else:
                return
            self._recompute_conditions()
            self._status_dirty.set()
        except Exception:
            pass  # status reporting must never hurt the controller

    def _status_loop(self) -> None:
        while not self._stop.is_set():
            if not self._status_dirty.wait(timeout=0.5):
                continue
            self._status_dirty.clear()
            try:
                self._push_status()
            except Exception:
                pass

    def _recompute_conditions(self) -> None:
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

        def _set(ctype: str, status: bool, reason: str,
                 message: str) -> None:
            cur = self.status_conditions.get(ctype)
            changed = cur is None or cur["status"] != \
                ("True" if status else "False")
            self.status_conditions[ctype] = {
                "type": ctype,
                "status": "True" if status else "False",
                "reason": reason,
                "message": message,
                "lastTransitionTime": now if changed
                else cur["lastTransitionTime"],
            }

        firing = dict(self._firing_objectives)
        _set("SLOAlertFiring", bool(firing),
             ",".join(sorted(firing)) or "AllObjectivesHealthy",
             f"{len(firing)} SLO objective(s) burning budget"
             if firing else "no burn-rate alerts firing")
        lvl = self._degradation_level
        _set("Degraded", lvl > 0, f"DegradationLevel{lvl}",
             f"shed ladder at L{lvl}" if lvl
             else "serving at full quality")
        # scale hint: a fast-severity burn or a brownout+ ladder means
        # the pool needs replicas, not just patience
        fast = any(sev == "fast" for sev in firing.values())
        if fast or lvl >= 2:
            self.scale_hint = "scale_up"
        elif firing or lvl > 0:
            self.scale_hint = "hold"
        else:
            self.scale_hint = "steady"

    def _push_status(self) -> None:
        """Best-effort merge-patch onto the (first) IntelligentPool's
        status subresource; no pool = conditions stay local (served via
        operator introspection)."""
        with self._state_lock:
            pools = list(self._state.get("intelligentpools", {}).values())
        if not pools:
            return
        pool = sorted(pools, key=self._key)[0]
        meta = pool.get("metadata", {}) or {}
        name = meta.get("name", "")
        if not name:
            return
        ok = self.client.patch_status(
            "intelligentpools", name,
            {"conditions": sorted(self.status_conditions.values(),
                                  key=lambda c: c["type"]),
             "scaleHint": self.scale_hint})
        if ok:
            self.status_push_count += 1

    # -- state ---------------------------------------------------------

    def _key(self, obj: Dict) -> str:
        meta = obj.get("metadata", {}) or {}
        return f"{meta.get('namespace', '')}/{meta.get('name', '')}"

    def _apply_event(self, plural: str, etype: str, obj: Dict) -> None:
        with self._state_lock:
            # remember the newest rv seen on the stream — a DELETED
            # event carries the freshest rv while REMOVING its object,
            # so deriving the resume point from surviving objects would
            # rewind and replay already-applied events on re-watch
            try:
                rv = int((obj.get("metadata") or {}).get(
                    "resourceVersion", "0") or 0)
            except (TypeError, ValueError):
                rv = 0
            self._last_rv[plural] = max(self._last_rv.get(plural, 0), rv)
            if etype == "DELETED":
                self._state[plural].pop(self._key(obj), None)
            else:  # ADDED | MODIFIED
                self._state[plural][self._key(obj)] = obj
        self._dirty.set()

    def reconcile_once(self) -> str:
        with self._state_lock:
            pools = list(self._state["intelligentpools"].values())
            routes = list(self._state["intelligentroutes"].values())
        if not pools:
            self.last_status = "no IntelligentPool found"
            return self.last_status
        pool = sorted(pools, key=self._key)[0]
        changed, status = reconcile(pool, sorted(routes, key=self._key),
                                    self.config_path)
        self.last_status = status
        self.reconcile_count += 1
        return status

    # -- loops ---------------------------------------------------------

    def _watch_loop(self, plural: str) -> None:
        backoff = self.backoff_s
        while not self._stop.is_set():
            try:
                items, rv = self.client.list(plural)
                with self._state_lock:
                    self._state[plural] = {
                        self._key(o): o for o in items}
                self._dirty.set()
                while not self._stop.is_set():
                    self.client.watch(
                        plural, rv,
                        lambda t, o, p=plural: self._apply_event(p, t, o),
                        self._stop,
                        register=lambda resp, p=plural:
                        self._register_stream(p, resp))
                    # clean stream end: resume from the newest rv the
                    # stream DELIVERED (tracked in _apply_event) — not
                    # from surviving objects, which lose the rv of a
                    # trailing DELETED event
                    with self._state_lock:
                        seen = self._last_rv.get(plural, 0)
                    rv = str(max(seen,
                                 int(rv) if rv.isdigit() else 0))
                backoff = self.backoff_s
            except urllib.error.HTTPError as exc:
                if exc.code == 410:  # compacted: re-list immediately
                    continue
                component_event("kubewatch", "watch_http_error",
                                level="warning", plural=plural,
                                code=exc.code)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
            except Exception as exc:
                if self._stop.is_set():
                    return
                component_event("kubewatch", "watch_reconnect",
                                level="warning", plural=plural,
                                error=f"{type(exc).__name__}: {exc}"[:200])
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)

    def _reconcile_loop(self) -> None:
        while not self._stop.is_set():
            if not self._dirty.wait(timeout=0.5):
                continue
            # debounce: absorb the event burst of a kubectl apply
            time.sleep(self.debounce_s)
            self._dirty.clear()
            try:
                self.reconcile_once()
            except Exception as exc:
                component_event("kubewatch", "reconcile_error",
                                level="warning",
                                error=f"{type(exc).__name__}: {exc}"[:200])

    def start(self) -> "KubeOperator":
        for plural in self.PLURALS:
            t = threading.Thread(target=self._watch_loop, args=(plural,),
                                 daemon=True, name=f"kubewatch-{plural}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._reconcile_loop, daemon=True,
                             name="kubewatch-reconcile")
        t.start()
        self._threads.append(t)
        return self

    @staticmethod
    def _sever_stream(resp) -> None:
        """Shut the stream's SOCKET down, not resp.close() — close()
        drains the chunked body to EOF and would block behind the very
        read being interrupted."""
        try:
            raw = getattr(getattr(resp, "fp", None), "raw", None)
            sock = getattr(raw, "_sock", None)
            if sock is not None:
                sock.shutdown(socket.SHUT_RDWR)
        except Exception:
            pass

    def _register_stream(self, plural: str, resp) -> None:
        stopping = False
        with self._streams_lock:
            if resp is None:
                self._streams.pop(plural, None)
            else:
                self._streams[plural] = resp
                stopping = self._stop.is_set()
        if stopping:
            # stop() already swept the streams it could see; a stream
            # opened AFTER that sweep (watcher was mid-reconnect) must
            # sever itself or its thread rides out the watch window
            self._sever_stream(resp)

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self._status_dirty.set()
        # sever live watch streams: a watcher blocked in read1() would
        # otherwise ride out the watch window (up to 300s) after stop
        with self._streams_lock:
            streams = list(self._streams.values())
        for resp in streams:
            self._sever_stream(resp)
        for t in self._threads:
            t.join(timeout=5.0)
        st = self._status_thread
        if st is not None:
            st.join(timeout=5.0)
        if self._bus_unsub is not None:
            try:
                self._bus_unsub()
            except Exception:
                pass
            self._bus_unsub = None


# ---------------------------------------------------------------------------
# MiniKubeAPI: the in-process stand-in


class MiniKubeAPI:
    """List/watch wire shapes over HTTP + a test-side apply/delete API.
    One global resourceVersion counter, per-connection watch streams fed
    from a broadcast queue (the shape kube-apiserver serves)."""

    def __init__(self, port: int = 0, token: str = "") -> None:
        self.token = token
        self._objects: Dict[str, Dict[str, Dict]] = {}
        self._rv = 0
        self._lock = threading.Lock()
        self._watchers: List[Tuple[str, "_Queue"]] = []
        # close() sets this so in-flight watch-stream handler threads
        # exit within one queue poll instead of riding out their
        # timeoutSeconds window (a closed server must actually die, as
        # a closed MiniRedis does)
        self._closing = threading.Event()
        # end_watches() bumps the epoch: the streams opened under an older
        # one end cleanly, as an apiserver ends a watch at its window
        self._watch_epoch = 0
        # watches answered 410 Gone (after expire_history)
        self.expired_watches = 0

        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if api.token:
                    auth = self.headers.get("Authorization", "")
                    if auth != f"Bearer {api.token}":
                        self.send_response(401)
                        self.end_headers()
                        return
                path, _, query = self.path.partition("?")
                parts = path.strip("/").split("/")
                # apis/{group}/{version}/namespaces/{ns}/{plural}
                if len(parts) != 6 or parts[0] != "apis":
                    self.send_response(404)
                    self.end_headers()
                    return
                plural = parts[5]
                params = dict(kv.split("=", 1)
                              for kv in query.split("&") if "=" in kv)
                if params.get("watch") == "1":
                    self._serve_watch(plural, params)
                else:
                    with api._lock:
                        items = list(api._objects.get(plural,
                                                      {}).values())
                        rv = api._rv
                    body = json.dumps({
                        "apiVersion": f"{GROUP}/{VERSION}",
                        "kind": "List",
                        "metadata": {"resourceVersion": str(rv)},
                        "items": items}).encode()
                    self.send_response(200)
                    self.send_header("content-type", "application/json")
                    self.send_header("content-length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def do_PATCH(self):
                if api.token:
                    auth = self.headers.get("Authorization", "")
                    if auth != f"Bearer {api.token}":
                        self.send_response(401)
                        self.end_headers()
                        return
                parts = self.path.strip("/").split("/")
                # apis/{group}/{version}/namespaces/{ns}/{plural}/{name}
                # /status — the status subresource the operator patches
                if len(parts) != 8 or parts[0] != "apis" \
                        or parts[7] != "status":
                    self.send_response(404)
                    self.end_headers()
                    return
                plural, name, ns = parts[5], parts[6], parts[4]
                length = int(self.headers.get("content-length", 0))
                try:
                    patch = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self.send_response(400)
                    self.end_headers()
                    return
                with api._lock:
                    obj = api._objects.get(plural, {}).get(f"{ns}/{name}")
                    if obj is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    # merge-patch semantics on the status subresource
                    status = dict(obj.get("status", {}) or {})
                    status.update(patch.get("status", {}) or {})
                    obj["status"] = status
                    api._rv += 1
                    obj["metadata"]["resourceVersion"] = str(api._rv)
                    body = json.dumps(obj).encode()
                    # no watch broadcast: status-subresource updates are
                    # the operator's OWN writes — replaying them into
                    # its watch would only churn the reconcile debounce
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_watch(self, plural, params):
                q = _Queue()
                since = int(params.get("resourceVersion", "0") or 0)
                with api._lock:
                    if since and since < api._compacted_before():
                        # history gone: the real server sends an ERROR
                        # event with a 410 status object
                        api.expired_watches += 1
                        self.send_response(200)
                        self.send_header("content-type",
                                         "application/json")
                        self.end_headers()
                        self.wfile.write(json.dumps({
                            "type": "ERROR",
                            "object": {"kind": "Status", "code": 410,
                                       "reason": "Expired"}
                        }).encode() + b"\n")
                        return
                    # replay history after the caller's resourceVersion
                    # (real watch semantics: list→watch must not lose
                    # the events in between), then stream live
                    for obj in api._objects.get(plural, {}).values():
                        orv = int((obj.get("metadata") or {}).get(
                            "resourceVersion", "0") or 0)
                        if orv > since:
                            q.put({"type": "ADDED", "object": obj})
                    api._watchers.append((plural, q))
                    epoch = api._watch_epoch
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("transfer-encoding", "chunked")
                self.end_headers()
                deadline = time.time() + float(
                    params.get("timeoutSeconds", "300"))
                try:
                    while time.time() < deadline \
                            and not api._closing.is_set() \
                            and api._watch_epoch == epoch:
                        ev = q.get(timeout=0.25)
                        if ev is None:
                            continue
                        data = json.dumps(ev).encode() + b"\n"
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data +
                            b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    with api._lock:
                        try:
                            api._watchers.remove((plural, q))
                        except ValueError:
                            pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def _compacted_before(self) -> int:
        return 0  # compaction simulated via expire_history()

    def expire_history(self) -> None:
        """Test hook: make every future watch-from-old-rv answer 410."""
        with self._lock:
            current = self._rv
        self._compacted_before = lambda: current + 1  # type: ignore

    def end_watches(self) -> None:
        """Test hook: end every open watch stream cleanly (within one
        0.25 s queue poll), as the server does when a watch window ends;
        a client then watches again from the newest resourceVersion it
        saw, which after ``expire_history`` is answered 410."""
        with self._lock:
            self._watch_epoch += 1

    # -- test-side mutation API ---------------------------------------

    def apply(self, plural: str, obj: Dict) -> Dict:
        with self._lock:
            self._rv += 1
            meta = obj.setdefault("metadata", {})
            meta.setdefault("namespace", "default")
            meta["resourceVersion"] = str(self._rv)
            key = f"{meta.get('namespace')}/{meta.get('name')}"
            existed = key in self._objects.setdefault(plural, {})
            self._objects[plural][key] = obj
            etype = "MODIFIED" if existed else "ADDED"
            self._broadcast(plural, {"type": etype, "object": obj})
        return obj

    def delete(self, plural: str, name: str,
               namespace: str = "default") -> bool:
        with self._lock:
            key = f"{namespace}/{name}"
            obj = self._objects.get(plural, {}).pop(key, None)
            if obj is None:
                return False
            self._rv += 1
            obj["metadata"]["resourceVersion"] = str(self._rv)
            self._broadcast(plural, {"type": "DELETED", "object": obj})
            return True

    def _broadcast(self, plural: str, event: Dict) -> None:
        for p, q in self._watchers:
            if p == plural:
                q.put(event)

    def close(self) -> None:
        self._closing.set()
        # wait for in-flight watch handlers to notice (bounded: each
        # wakes within one 0.25s queue poll)
        deadline = time.time() + 3.0
        while time.time() < deadline:
            with self._lock:
                if not self._watchers:
                    break
            time.sleep(0.05)
        self._httpd.shutdown()
        self._httpd.server_close()


class _Queue:
    """Tiny blocking queue (queue.Queue with a None-on-timeout get)."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()

    def put(self, item) -> None:
        self._q.put(item)

    def get(self, timeout: float):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None
