"""Agent loop: chat completions that can call MCP tools until done (a copy
of localai_tpu/mcp/agent.py, over the port's engine).

Reference: endpoints/localai/mcp.go:326 (POST /mcp/v1/chat/completions runs
the model in a loop, executing MCP tool calls and feeding results back as
tool messages, bounded by max iterations).

The loop is decoupled from the serving stack through a `chat_fn` callable
(messages, tools) → assistant message dict, so it drives either a loaded
engine (server path) or any scripted function (tests, cron jobs).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Optional

log = logging.getLogger("localai_tpu_torch.mcp")

ChatFn = Callable[[list[dict], list[dict]], dict]


def collect_tools(clients: list) -> tuple[list[dict], dict[str, Any]]:
    """Gather tools from every MCP server → (OpenAI tool specs, name→client)."""
    specs: list[dict] = []
    owners: dict[str, Any] = {}
    for c in clients:
        try:
            for t in c.list_tools():
                name = t.get("name")
                if not name or name in owners:
                    continue
                owners[name] = c
                specs.append({
                    "type": "function",
                    "function": {
                        "name": name,
                        "description": t.get("description", ""),
                        "parameters": t.get("inputSchema") or {"type": "object"},
                    },
                })
        except Exception as e:  # noqa: BLE001 — a dead server loses its tools only
            log.warning("MCP server %s unavailable: %s", getattr(c, "name", c), e)
    return specs, owners


def agent_loop(
    chat_fn: ChatFn,
    messages: list[dict],
    clients: list,
    max_iterations: int = 10,
) -> dict:
    """Run the agent until a plain answer. Returns
    {message, iterations, tool_calls: [{name, arguments, result|error}]}."""
    specs, owners = collect_tools(clients)
    history = list(messages)
    executed: list[dict] = []
    for it in range(max_iterations):
        msg = chat_fn(history, specs)
        calls = msg.get("tool_calls") or []
        if not calls or not specs:
            return {"message": msg, "iterations": it + 1, "tool_calls": executed}
        history.append(msg)
        for call in calls:
            fn = (call.get("function") or {})
            name = fn.get("name", "")
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except json.JSONDecodeError:
                args = {}
            record: dict[str, Any] = {"name": name, "arguments": args}
            client = owners.get(name)
            if client is None:
                record["error"] = f"unknown tool {name!r}"
                content = record["error"]
            else:
                try:
                    content = client.call_tool(name, args)
                    record["result"] = content
                except Exception as e:  # noqa: BLE001 — feed the error back
                    record["error"] = str(e)
                    content = f"tool error: {e}"
            executed.append(record)
            history.append({
                "role": "tool",
                "tool_call_id": call.get("id", name),
                "content": content,
            })
    return {
        "message": {"role": "assistant",
                    "content": "agent reached max iterations without a final answer"},
        "iterations": max_iterations,
        "tool_calls": executed,
    }


def make_engine_chat_fn(lm, max_tokens: int = 512,
                        temperature: Optional[float] = None) -> ChatFn:
    """chat_fn over a loaded text model (same path as /v1/chat/completions)."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.functions import parse_function_calls, tools_prompt_for

    def chat(messages: list[dict], tools: list[dict]) -> dict:
        tprompt = tools_prompt_for(tools) if tools else ""
        prompt = lm.evaluator.template_messages(messages, tools_prompt=tprompt)
        ids = lm.engine.tokenizer.encode(
            prompt, add_bos=not lm.cfg.template.use_tokenizer_template
        )
        text, _final = lm.engine.submit(GenRequest(
            prompt_ids=ids,
            max_new_tokens=max_tokens,
            temperature=lm.cfg.temperature if temperature is None else temperature,
            stop=lm.evaluator.stop_sequences(),
        )).result()
        if tools:
            calls = parse_function_calls(text, lm.cfg)
            if calls:
                return {"role": "assistant", "content": None, "tool_calls": calls}
        return {"role": "assistant", "content": text}

    return chat
