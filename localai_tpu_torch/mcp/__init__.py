"""MCP (Model Context Protocol) client + agent loop (copies of
localai_tpu/mcp/, which imports no JAX)."""

from localai_tpu_torch.mcp.client import MCPClient, MCPError, StdioMCPClient  # noqa: F401
from localai_tpu_torch.mcp.agent import agent_loop, collect_tools  # noqa: F401
