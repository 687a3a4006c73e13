"""Incremental JSON-Schema constraint machine for grammar-constrained decoding.

Reference: pkg/functions/grammars/json_schema.go converts JSON-Schema to GBNF
and llama.cpp enforces it inside the engine. TPU-native re-design (SURVEY.md
§7 item 6): the constraint runs host-side as a character-level pushdown
machine; the engine consults it to pick the best valid token from the model's
top-k candidates each step (a logit mask evaluated lazily on candidates
instead of a [V]-sized mask per step — no device round-trip for the mask).

Supported schema subset: object (properties / required / additionalProperties),
array (items / minItems / maxItems), string, number, integer, boolean, null,
enum (of scalars), const, anyOf-by-type via "type": [...], and {} (any JSON).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Optional

# feed() results
CONSUMED = 0  # char accepted, frame continues
DONE = 1  # char accepted and frame finished — pop
END = 2  # char NOT accepted because frame already finished — pop, re-feed
REJECT = 3  # char invalid here
REPLACE = 4  # dispatch resolved to a concrete frame (in .replacement) — re-feed

_WS = " \t\n\r"


def _quote(s: str) -> str:
    return json.dumps(s)


class _Frame:
    replacement: Optional["_Frame"] = None

    def feed(self, ch: str) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def on_child_done(self) -> None:
        pass

    def in_string_body(self) -> bool:
        """True when chars are string content — exempt from the structural
        whitespace cap."""
        return False


class _Literal(_Frame):
    """Match exactly one of several literal strings (true/false/null, enum
    values, const — pre-rendered as JSON text)."""

    def __init__(self, options: list[str]):
        self.options = options
        self.pos = 0

    def feed(self, ch: str) -> int:
        viable = [o for o in self.options if self.pos < len(o) and o[self.pos] == ch]
        if not viable:
            # allow pop if some option is fully matched at pos
            if any(len(o) == self.pos for o in self.options):
                return END
            return REJECT
        self.options = viable
        self.pos += 1
        if len(self.options) == 1 and self.pos == len(self.options[0]):
            return DONE
        return CONSUMED


class _String(_Frame):
    """A JSON string: '"' chars* '"' with escapes."""

    def __init__(self):
        self.state = "open"  # open -> body -> (esc|hex*) -> closed

        self.hex_left = 0

    def feed(self, ch: str) -> int:
        s = self.state
        if s == "open":
            if ch == '"':
                self.state = "body"
                return CONSUMED
            return REJECT
        if s == "esc":
            if ch in '"\\/bfnrt':
                self.state = "body"
                return CONSUMED
            if ch == "u":
                self.state = "hex"
                self.hex_left = 4
                return CONSUMED
            return REJECT
        if s == "hex":
            if ch in "0123456789abcdefABCDEF":
                self.hex_left -= 1
                if self.hex_left == 0:
                    self.state = "body"
                return CONSUMED
            return REJECT
        # body
        if ch == '"':
            return DONE
        if ch == "\\":
            self.state = "esc"
            return CONSUMED
        if ch >= " ":
            return CONSUMED
        return REJECT

    def in_string_body(self) -> bool:
        return self.state != "open"


class _Number(_Frame):
    """-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)? ; integer forbids frac/exp.

    Numbers have no terminator: any non-number char pops with END once the
    DFA is in an accepting state.
    """

    def __init__(self, integer: bool):
        self.integer = integer
        self.state = "start"  # start sign int_zero int_digits frac_start frac exp_start exp_sign exp

    _ACCEPTING = {"int_zero", "int_digits", "frac", "exp"}

    def feed(self, ch: str) -> int:
        s = self.state
        if s == "start":
            if ch == "-":
                self.state = "sign"
                return CONSUMED
            if ch == "0":
                self.state = "int_zero"
                return CONSUMED
            if ch in "123456789":
                self.state = "int_digits"
                return CONSUMED
            return REJECT
        if s == "sign":
            if ch == "0":
                self.state = "int_zero"
                return CONSUMED
            if ch in "123456789":
                self.state = "int_digits"
                return CONSUMED
            return REJECT
        if s in ("int_zero", "int_digits"):
            if ch in "0123456789" and s == "int_digits":
                return CONSUMED
            if not self.integer:
                if ch == ".":
                    self.state = "frac_start"
                    return CONSUMED
                if ch in "eE":
                    self.state = "exp_start"
                    return CONSUMED
            return END
        if s == "frac_start":
            if ch in "0123456789":
                self.state = "frac"
                return CONSUMED
            return REJECT
        if s == "frac":
            if ch in "0123456789":
                return CONSUMED
            if ch in "eE":
                self.state = "exp_start"
                return CONSUMED
            return END
        if s == "exp_start":
            if ch in "+-":
                self.state = "exp_sign"
                return CONSUMED
            if ch in "0123456789":
                self.state = "exp"
                return CONSUMED
            return REJECT
        if s == "exp_sign":
            if ch in "0123456789":
                self.state = "exp"
                return CONSUMED
            return REJECT
        if s == "exp":
            if ch in "0123456789":
                return CONSUMED
            return END
        return REJECT


class _Object(_Frame):
    def __init__(self, schema: dict, machine: "JsonSchemaMachine"):
        self.machine = machine
        self.props: dict[str, Any] = schema.get("properties", {}) or {}
        self.required = set(schema.get("required", []) or [])
        ap = schema.get("additionalProperties")
        # Constrained mode default: closed objects when properties declared.
        self.additional = ap if ap is not None else (not self.props)
        self.seen: set[str] = set()
        self.state = "open"  # open key_or_close key colon value comma_or_close
        self.key_literal: Optional[_Literal] = None
        self.key_string: Optional[_String] = None
        self.current_key = ""
        self.n = 0

    def _key_options(self) -> list[str]:
        return [_quote(k) for k in self.props if k not in self.seen]

    def _close_ok(self) -> bool:
        return self.required <= self.seen

    def on_child_done(self) -> None:
        if self.state == "value":
            self.n += 1
            self.state = "comma_or_close"

    def feed(self, ch: str) -> int:
        s = self.state
        if s in ("open", "key_or_close", "colon", "comma_or_close") and ch in _WS:
            return CONSUMED
        if s == "open":
            if ch == "{":
                self.state = "key_or_close"
                return CONSUMED
            return REJECT
        if s == "key_or_close":
            if ch == "}" and self._close_ok() and self.n == 0:
                return DONE
            if ch == '"':
                opts = self._key_options()
                if opts:
                    self.key_literal = _Literal(opts)
                    self.key_literal.feed('"')
                    self.key_string = _String() if self.additional else None
                    if self.key_string:
                        self.key_string.feed('"')
                elif self.additional:
                    self.key_literal = None
                    self.key_string = _String()
                    self.key_string.feed('"')
                else:
                    return REJECT
                self.state = "key"
                self.key_chars = '"'
                return CONSUMED
            return REJECT
        if s == "key":
            lit_r = self.key_literal.feed(ch) if self.key_literal else REJECT
            str_r = self.key_string.feed(ch) if self.key_string else REJECT
            if lit_r in (CONSUMED, DONE):
                self.key_chars += ch
                if lit_r == DONE:
                    self.current_key = json.loads(self.key_chars)
                    self.key_literal = None
                    self.key_string = None
                    self.state = "colon"
                elif str_r not in (CONSUMED, DONE):
                    self.key_string = None
                return CONSUMED
            if str_r in (CONSUMED, DONE):
                self.key_chars += ch
                self.key_literal = None
                if str_r == DONE:
                    self.current_key = json.loads(self.key_chars)
                    self.key_string = None
                    self.state = "colon"
                return CONSUMED
            return REJECT
        if s == "colon":
            if ch == ":":
                if self.current_key in self.seen:
                    return REJECT  # duplicate key via the additionalProperties path
                self.seen.add(self.current_key)
                schema = self.props.get(self.current_key)
                if schema is None:
                    schema = self.additional if isinstance(self.additional, dict) else {}
                self.state = "value"
                self.machine.push(_Dispatch(schema, self.machine))
                return CONSUMED
            return REJECT
        if s == "value":
            # child frame handles chars; reaching here means child popped via
            # END and on_child_done already ran — retry in new state
            return REJECT
        if s == "comma_or_close":
            if ch in _WS:
                return CONSUMED
            if ch == ",":
                if self._key_options() or self.additional:
                    self.state = "key_or_close_after_comma"
                    return CONSUMED
                return REJECT
            if ch == "}" and self._close_ok():
                return DONE
            return REJECT
        if s == "key_or_close_after_comma":
            if ch in _WS:
                return CONSUMED
            if ch == '"':
                self.state = "key_or_close"
                return self.feed(ch)
            return REJECT
        return REJECT

    def in_string_body(self) -> bool:
        return self.state == "key"


class _Array(_Frame):
    def __init__(self, schema: dict, machine: "JsonSchemaMachine"):
        self.machine = machine
        self.items = schema.get("items", {}) or {}
        self.min_items = int(schema.get("minItems", 0) or 0)
        self.max_items = schema.get("maxItems")
        self.n = 0
        self.state = "open"  # open value_or_close value comma_or_close

    def on_child_done(self) -> None:
        if self.state == "value":
            self.n += 1
            self.state = "comma_or_close"

    def feed(self, ch: str) -> int:
        if ch in _WS and self.state != "value":
            return CONSUMED
        s = self.state
        if s == "open":
            if ch == "[":
                self.state = "value_or_close"
                return CONSUMED
            return REJECT
        if s == "value_or_close":
            if ch == "]" and self.n >= self.min_items:
                return DONE
            if self.max_items is not None and self.n >= int(self.max_items):
                return REJECT
            self.state = "value"
            self.machine.push(_Dispatch(self.items, self.machine))
            return self._refeed(ch)
        if s == "value":
            return REJECT
        if s == "comma_or_close":
            if ch == ",":
                if self.max_items is not None and self.n >= int(self.max_items):
                    return REJECT
                self.state = "value_or_close_no_close"
                return CONSUMED
            if ch == "]" and self.n >= self.min_items:
                return DONE
            return REJECT
        if s == "value_or_close_no_close":
            if ch in _WS:
                return CONSUMED
            self.state = "value"
            self.machine.push(_Dispatch(self.items, self.machine))
            return self._refeed(ch)
        return REJECT

    def _refeed(self, ch: str) -> int:
        # The char belongs to the just-pushed child: signal the machine to
        # re-dispatch without consuming.
        return REPLACE  # machine re-feeds ch to the new top frame


class _Dispatch(_Frame):
    """Resolves a schema to a concrete frame on the first non-ws char."""

    def __init__(self, schema: Any, machine: "JsonSchemaMachine"):
        self.schema = schema if isinstance(schema, dict) else {}
        self.machine = machine

    def feed(self, ch: str) -> int:
        if ch in _WS:
            return CONSUMED
        sch = self.schema
        if "const" in sch:
            self.replacement = _Literal([json.dumps(sch["const"])])
            return REPLACE
        if "enum" in sch:
            self.replacement = _Literal([json.dumps(v) for v in sch["enum"]])
            return REPLACE
        types = sch.get("type")
        if isinstance(types, str):
            types = [types]
        if not types:
            # any JSON value — infer from char
            if ch == "{":
                types = ["object"]
            elif ch == "[":
                types = ["array"]
            elif ch == '"':
                types = ["string"]
            elif ch in "-0123456789":
                types = ["number"]
            elif ch == "t" or ch == "f":
                types = ["boolean"]
            elif ch == "n":
                types = ["null"]
            else:
                return REJECT
        # choose the branch whose first char matches (cheap static probe —
        # no deepcopy; every frame type has a distinct start set)
        first_ok = {
            "object": ch == "{",
            "array": ch == "[",
            "string": ch == '"',
            "number": ch in "-0123456789",
            "integer": ch in "-0123456789",
            "boolean": ch in "tf",
            "null": ch == "n",
        }
        for t in types:
            if not first_ok.get(t, False):
                continue
            frame = self._frame_for(t)
            if frame is not None:
                self.replacement = frame
                return REPLACE
        return REJECT

    def _frame_for(self, t: str) -> Optional[_Frame]:
        sch = self.schema
        if t == "object":
            return _Object(sch, self.machine)
        if t == "array":
            return _Array(sch, self.machine)
        if t == "string":
            return _String()
        if t == "number":
            return _Number(integer=False)
        if t == "integer":
            return _Number(integer=True)
        if t == "boolean":
            return _Literal(["true", "false"])
        if t == "null":
            return _Literal(["null"])
        return None


class JsonSchemaMachine:
    """Feed characters; tells you whether a prefix stays schema-valid.

    Structural whitespace is capped at `max_ws_run` consecutive chars (and
    none before the first token): without the cap a constrained model can
    satisfy the grammar forever with whitespace and never emit content.
    """

    def __init__(self, schema: Any = None, max_ws_run: int = 1):
        self.stack: list[_Frame] = []
        self.push(_Dispatch(schema or {}, self))
        self.max_ws_run = max_ws_run
        self.ws_run = max_ws_run  # blocks leading whitespace

    def push(self, frame: _Frame) -> None:
        self.stack.append(frame)

    def feed(self, ch: str) -> bool:
        structural = not (self.stack and self.stack[-1].in_string_body())
        if ch in _WS and structural:
            if self.ws_run >= self.max_ws_run:
                return False
        guard = 0
        while True:
            guard += 1
            if guard > 200:
                return False
            if not self.stack:
                if ch in _WS and self.ws_run < self.max_ws_run:
                    self.ws_run += 1
                    return True
                return False
            top = self.stack[-1]
            r = top.feed(ch)
            if r == CONSUMED:
                self.ws_run = (self.ws_run + 1) if (ch in _WS and structural) else 0
                return True
            if r == DONE:
                self.stack.pop()
                if self.stack:
                    self.stack[-1].on_child_done()
                self.ws_run = 0
                return True
            if r == END:
                self.stack.pop()
                if self.stack:
                    self.stack[-1].on_child_done()
                continue
            if r == REPLACE:
                if top.replacement is not None:
                    self.stack[-1] = top.replacement
                # else: a child was pushed (array refeed path)
                continue
            return False

    def feed_text(self, text: str) -> bool:
        return all(self.feed(c) for c in text)

    def is_complete(self) -> bool:
        st = self.stack
        if not st:
            return True
        # A trailing _Number in accepting state (nothing else on the stack)
        # also counts as complete.
        if len(st) == 1 and isinstance(st[0], _Number):
            return st[0].state in _Number._ACCEPTING
        return False


class GrammarConstraint:
    """Per-request constrained-decoding state used by the engine.

    The engine asks `allowed(text)` for candidate token strings, commits with
    `advance(text)`, and may emit EOS only when `complete()`.
    """

    def __init__(self, schema: Any = None):
        self.schema = schema  # retained for DFA compilation (functions/dfa.py)
        self.machine = JsonSchemaMachine(schema)

    def allowed(self, token_text: str) -> bool:
        if not token_text:
            return False
        clone = copy.deepcopy(self.machine)
        return clone.feed_text(token_text)

    def advance(self, token_text: str) -> bool:
        return self.machine.feed_text(token_text)

    def complete(self) -> bool:
        """Output is a full value (EOS becomes legal)."""
        return self.machine.is_complete()

    def strictly_complete(self) -> bool:
        """Output cannot be extended — the engine may finish the request.

        Differs from complete() for trailing numbers: "12" is a complete
        integer but "123" remains valid, so generation must not be cut there
        (the model ends it with EOS instead)."""
        return not self.machine.stack


def tool_call_schema(tools: list[dict[str, Any]]) -> dict[str, Any]:
    """Schema for one tool call: {"name": <enum>, "arguments": <params>}.

    Reference: json_schema.go builds a GBNF alternation over functions; here
    the name enum and per-tool argument schemas combine into one object schema
    whose `arguments` accepts any declared tool's parameters. (Exact
    name→arguments coupling needs oneOf; the engine still validates the parse
    on the way out, matching the reference's parse step.)
    """
    names = []
    for t in tools:
        fn = t.get("function", t)
        if fn.get("name"):
            names.append(fn["name"])
    if len(names) == 1:
        fn = tools[0].get("function", tools[0])
        params = fn.get("parameters") or {}
        return {
            "type": "object",
            "properties": {"name": {"const": names[0]}, "arguments": params},
            "required": ["name", "arguments"],
        }
    return {
        "type": "object",
        "properties": {"name": {"enum": names}, "arguments": {}},
        "required": ["name", "arguments"],
    }
