"""MCP clients: JSON-RPC 2.0 over streamable HTTP and over stdio (a copy of
localai_tpu/mcp/client.py).

Reference: endpoints/localai/mcp.go wires remote/stdio MCP servers from the
model config's `mcp:` block and exposes their tools to an agent loop. The
protocol subset here is what tool use needs: initialize, tools/list,
tools/call.
"""

from __future__ import annotations

import json
import logging
import subprocess
import threading
import urllib.request
from typing import Any, Optional

log = logging.getLogger("localai_tpu_torch.mcp")

PROTOCOL_VERSION = "2024-11-05"


class MCPError(Exception):
    pass


class MCPClient:
    """Remote MCP server over streamable HTTP (JSON-RPC request/response)."""

    def __init__(self, url: str, token: str = "", name: str = ""):
        self.url = url
        self.token = token
        self.name = name or url
        self._id = 0
        self._lock = threading.Lock()
        self._initialized = False

    def _rpc(self, method: str, params: Optional[dict] = None) -> Any:
        with self._lock:
            self._id += 1
            rid = self._id
        payload = {"jsonrpc": "2.0", "id": rid, "method": method}
        if params is not None:
            payload["params"] = params
        headers = {
            "Content-Type": "application/json",
            "Accept": "application/json, text/event-stream",
        }
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(), headers=headers
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read().decode()
            ctype = r.headers.get("Content-Type", "")
        if "text/event-stream" in ctype:  # single-response SSE framing
            for line in raw.splitlines():
                if line.startswith("data:"):
                    raw = line[5:].strip()
                    break
        out = json.loads(raw)
        if "error" in out:
            raise MCPError(f"{self.name}: {out['error'].get('message')}")
        return out.get("result")

    def initialize(self) -> dict:
        result = self._rpc("initialize", {
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {},
            "clientInfo": {"name": "localai-tpu", "version": "1"},
        })
        try:
            self._rpc("notifications/initialized")
        except Exception:  # noqa: BLE001 — some servers reject notification POSTs
            pass
        self._initialized = True
        return result or {}

    def list_tools(self) -> list[dict]:
        if not self._initialized:
            self.initialize()
        result = self._rpc("tools/list") or {}
        return result.get("tools", [])

    def call_tool(self, name: str, arguments: dict) -> str:
        if not self._initialized:
            self.initialize()
        result = self._rpc("tools/call", {"name": name, "arguments": arguments}) or {}
        parts = []
        for c in result.get("content", []):
            if c.get("type") == "text":
                parts.append(c.get("text", ""))
            else:
                parts.append(json.dumps(c))
        if result.get("isError"):
            raise MCPError(f"{self.name}.{name}: {' '.join(parts)}")
        return "\n".join(parts)


class StdioMCPClient:
    """MCP server launched as a subprocess, JSON-RPC over stdin/stdout
    (reference: mcp.go stdio transport for local tool servers)."""

    def __init__(self, command: list[str], env: Optional[dict] = None, name: str = ""):
        self.name = name or command[0]
        self._proc = subprocess.Popen(
            command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=env, text=True, bufsize=1,
        )
        self._id = 0
        self._lock = threading.Lock()
        self._initialized = False

    def _rpc(self, method: str, params: Optional[dict] = None) -> Any:
        with self._lock:
            self._id += 1
            payload = {"jsonrpc": "2.0", "id": self._id, "method": method}
            if params is not None:
                payload["params"] = params
            assert self._proc.stdin and self._proc.stdout
            self._proc.stdin.write(json.dumps(payload) + "\n")
            self._proc.stdin.flush()
            while True:
                line = self._proc.stdout.readline()
                if not line:
                    raise MCPError(f"{self.name}: server exited")
                try:
                    out = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if out.get("id") == self._id:
                    break
        if "error" in out:
            raise MCPError(f"{self.name}: {out['error'].get('message')}")
        return out.get("result")

    initialize = MCPClient.initialize
    list_tools = MCPClient.list_tools
    call_tool = MCPClient.call_tool

    def close(self) -> None:
        try:
            self._proc.terminate()
        except OSError:
            pass


def clients_from_config(mcp_cfg: dict) -> list:
    """Build clients from a model config `mcp:` block:
    {remote: [{name, url, token}], stdio: [{name, command: [...], env}]}."""
    out: list = []
    for r in mcp_cfg.get("remote") or []:
        out.append(MCPClient(r["url"], token=r.get("token", ""), name=r.get("name", "")))
    for s in mcp_cfg.get("stdio") or []:
        out.append(StdioMCPClient(s["command"], env=s.get("env"), name=s.get("name", "")))
    return out
