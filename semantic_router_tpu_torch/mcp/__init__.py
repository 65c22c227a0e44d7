"""MCP integration: the stdio and HTTP clients and the MCP-served domain
classifier (the port's copy of ``semantic_router_tpu.mcp``)."""

from .classifier import MCPClassifySignal
from .client import (
    HTTPClient,
    MCPError,
    StdioClient,
    Tool,
    ToolResult,
    create_client,
)

__all__ = ["HTTPClient", "MCPClassifySignal", "MCPError", "StdioClient",
           "Tool", "ToolResult", "create_client"]
