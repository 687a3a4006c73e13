"""Tool definitions → prompt text; model output → OpenAI tool_calls.

Reference behaviors reproduced (pkg/functions/parse.go):
- JSON mode: the model emits one or more JSON objects with name+arguments
  (parse.go ParseFunctionCall JSON branch); we scan balanced JSON objects so
  surrounding prose or multiple calls are tolerated.
- llama3.1-style `<function=name>{...}</function>` tags
  (grammars/llama31_schema.go).
- Regex mode via config `options.function_response_regex` with named groups
  (parse.go ResponseRegex).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Optional

from localai_tpu_torch.config.model_config import ModelConfig

_LLAMA31_RE = re.compile(r"<function=(\w+)>(.*?)</function>", re.DOTALL)


def tools_prompt_for(tools: list[dict[str, Any]]) -> str:
    """System-prompt suffix describing available tools and the call format.

    The reference injects grammar + a Functions template
    (evaluator.go:96-230); the prompt contract here matches what
    parse_function_calls accepts.
    """
    defs = []
    for t in tools:
        fn = t.get("function", t)
        defs.append(
            {
                "name": fn.get("name", ""),
                "description": fn.get("description", ""),
                "parameters": fn.get("parameters", {}),
            }
        )
    return (
        "You have access to the following tools:\n"
        + json.dumps(defs, indent=2)
        + "\n\nTo call a tool, respond ONLY with a JSON object of the form "
        '{"name": "<tool name>", "arguments": {...}} — one JSON object per call, '
        "no other text. If no tool is needed, answer normally."
    )


def _balanced_json_objects(text: str) -> list[dict[str, Any]]:
    """Extract every balanced top-level JSON object from free-form text."""
    out = []
    depth = 0
    start: Optional[int] = None
    in_str = False
    esc = False
    for i, ch in enumerate(text):
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth > 0:
                depth -= 1
                if depth == 0 and start is not None:
                    try:
                        out.append(json.loads(text[start : i + 1]))
                    except json.JSONDecodeError:
                        pass
                    start = None
    return out


def _to_tool_call(name: str, arguments: Any) -> dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments or {})
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def parse_function_calls(text: str, cfg: Optional[ModelConfig] = None) -> list[dict[str, Any]]:
    """Parse model output into OpenAI tool_calls; [] when no call is found."""
    calls: list[dict[str, Any]] = []

    # Regex mode from model config (parse.go ResponseRegex named groups).
    pattern = (cfg.options.get("function_response_regex") if cfg else None)
    if pattern:
        for m in re.finditer(pattern, text, re.DOTALL):
            groups = m.groupdict()
            if "name" in groups:
                calls.append(_to_tool_call(groups["name"], groups.get("arguments", "{}")))
        if calls:
            return calls

    # llama3.1 <function=...> tags.
    for m in _LLAMA31_RE.finditer(text):
        args = m.group(2).strip()
        try:
            parsed = json.loads(args) if args else {}
        except json.JSONDecodeError:
            parsed = {"raw": args}
        calls.append(_to_tool_call(m.group(1), parsed))
    if calls:
        return calls

    # JSON objects with name/function + arguments.
    for obj in _balanced_json_objects(text):
        name = obj.get("name") or obj.get("function")
        if not isinstance(name, str) or not name:
            continue
        args = obj.get("arguments", obj.get("parameters", {}))
        calls.append(_to_tool_call(name, args))
    return calls
