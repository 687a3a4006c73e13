"""Raw GBNF grammar support: llama.cpp's grammar format as a first-class
constrained-decoding input.

Reference: the reference forwards an arbitrary `Grammar` string to llama.cpp
(backend.proto:139; grpc-server.cpp params_parse → llama_sampler_init_grammar)
and ships its own GBNF builders (pkg/functions/grammars/). The repo's JSON-
Schema path (functions/jsonschema.py) covers schema-driven constraints; this
module adds the externally-authored-grammar entry point.

Design (original, TPU-serving-shaped — not a port of llama.cpp's sampler):

  * parse GBNF → immutable rule table (groups/repetitions become synthesized
    rules, llama.cpp-style);
  * run it as a breadth-wise pushdown machine: the parse state is a
    frozenset of expanded stacks (tuples of elements), so cloning is free
    and states hash — which makes the machine BFS-compilable;
  * compile to the SAME device DFA/token-table path as JSON schemas
    (functions/dfa.py): character classes come from interval-splitting every
    range endpoint in the grammar, so the class alphabet is exact for any
    grammar (no ASCII-only approximation); grammars whose reachable config
    space exceeds the state budget host-walk instead, same as big schemas.

The host-walk constraint object (GbnfConstraint) speaks the exact interface
the engine already consumes (allowed/advance/complete/strictly_complete) and
carries `.schema = {"__gbnf__": text}` so the engine's untouched _dfa_for
path compiles and caches it like any schema.
"""

from __future__ import annotations

import bisect
from typing import Any, Optional

import numpy as np

# Elements: ("c", ranges, negated) matches one char (ranges: sorted tuple of
# inclusive (lo, hi) codepoint pairs); ("r", rule_id) invokes a rule.
MAX_STACKS = 512  # breadth cap: deterministic prune keeps serving bounded
MAX_STACK_DEPTH = 256


class GbnfParseError(ValueError):
    pass


# --------------------------------------------------------------------------- #
# Parser (GBNF: rules `name ::= alternates`, literals, char classes, groups,
# *, +, ?, {m}, {m,}, {m,n}, # comments)
# --------------------------------------------------------------------------- #


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[list[tuple]]] = {}
        self.anon = 0

    # -- lexing helpers ---------------------------------------------------- #

    def _ws(self, newlines: bool) -> None:
        """Skip spaces/comments; newlines only when `newlines` (a newline not
        followed by indentation/continuation ends a rule)."""
        t = self.text
        while self.pos < len(t):
            ch = t[self.pos]
            if ch == "#":
                while self.pos < len(t) and t[self.pos] != "\n":
                    self.pos += 1
            elif ch in " \t":
                self.pos += 1
            elif ch in "\r\n":
                if not newlines:
                    return
                self.pos += 1
            else:
                return

    def _name(self) -> str:
        t, start = self.text, self.pos
        while self.pos < len(t) and (t[self.pos].isalnum() or t[self.pos] in "-_"):
            self.pos += 1
        if self.pos == start:
            raise GbnfParseError(f"expected rule name at offset {start}")
        return t[start: self.pos]

    def _expect(self, s: str) -> None:
        if not self.text.startswith(s, self.pos):
            raise GbnfParseError(
                f"expected {s!r} at offset {self.pos}: "
                f"{self.text[self.pos: self.pos + 20]!r}"
            )
        self.pos += len(s)

    def _char(self, in_class: bool) -> int:
        """One (possibly escaped) character → codepoint."""
        t = self.text
        if self.pos >= len(t):
            raise GbnfParseError("unexpected end of grammar in character")
        ch = t[self.pos]
        self.pos += 1
        if ch != "\\":
            return ord(ch)
        if self.pos >= len(t):
            raise GbnfParseError("dangling escape")
        e = t[self.pos]
        self.pos += 1
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91,
                  "]": 93, "-": 45, "^": 94, "'": 39}
        if e in simple:
            return simple[e]
        if e in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[e]
            hexs = t[self.pos: self.pos + n]
            if len(hexs) != n:
                raise GbnfParseError(f"bad \\{e} escape")
            self.pos += n
            cp = int(hexs, 16)
            if cp > 0x10FFFF:
                raise GbnfParseError(f"\\{e}{hexs} is beyond U+10FFFF")
            return cp
        raise GbnfParseError(f"unknown escape \\{e}")

    # -- grammar productions ----------------------------------------------- #

    def parse(self) -> dict[str, list[list[tuple]]]:
        self._ws(True)
        while self.pos < len(self.text):
            name = self._name()
            self._ws(False)
            self._expect("::=")
            # llama.cpp allows the rule body to start on the next line
            # (parse_space after "::=" has newline_ok=true).
            self._ws(True)
            alts = self._alternates(name)
            if name in self.rules:
                raise GbnfParseError(f"duplicate rule {name!r}")
            self.rules[name] = alts
            self._ws(True)
        if "root" not in self.rules:
            raise GbnfParseError("grammar has no 'root' rule")
        return self.rules

    def _alternates(self, rule_name: str) -> list[list[tuple]]:
        alts = [self._sequence(rule_name)]
        self._ws(False)
        while self.text.startswith("|", self.pos):
            self.pos += 1
            self._ws(False)
            # an alternate may continue on the next line after '|'
            self._ws(True)
            alts.append(self._sequence(rule_name))
            self._ws(False)
        return alts

    def _sequence(self, rule_name: str) -> list[tuple]:
        seq: list[tuple] = []
        while True:
            self._ws(False)
            if self.pos >= len(self.text):
                break
            ch = self.text[self.pos]
            if ch in "|)\r\n":
                break
            # `unit` is what a postfix operator repeats: the WHOLE quoted
            # literal, but a single char class / ref / group (llama.cpp's
            # last_sym_start semantics).
            if ch == '"':
                self.pos += 1
                lits = []
                while not self.text.startswith('"', self.pos):
                    if self.pos >= len(self.text):
                        raise GbnfParseError("unterminated string literal")
                    lits.append(self._char(False))
                self.pos += 1
                unit = [("c", ((cp, cp),), False) for cp in lits]
            elif ch == "[":
                self.pos += 1
                neg = False
                if self.text.startswith("^", self.pos):
                    neg = True
                    self.pos += 1
                ranges = []
                while not self.text.startswith("]", self.pos):
                    if self.pos >= len(self.text):
                        raise GbnfParseError("unterminated char class")
                    lo = self._char(True)
                    hi = lo
                    if (self.text.startswith("-", self.pos)
                            and not self.text.startswith("-]", self.pos)):
                        self.pos += 1
                        hi = self._char(True)
                    if hi < lo:
                        raise GbnfParseError(f"inverted range in char class")
                    ranges.append((lo, hi))
                self.pos += 1
                if not ranges and not neg:
                    raise GbnfParseError("empty char class")
                unit = [("c", tuple(sorted(ranges)), neg)]
            elif ch == "(":
                self.pos += 1
                self._ws(True)
                sub = self._alternates(rule_name)
                self._ws(True)
                self._expect(")")
                unit = [("r", self._anon_rule(rule_name, sub))]
            else:
                unit = [("r", self._name())]

            rep = self._repetition()
            if rep is not None:
                if len(unit) != 1:
                    # repeat a multi-char (or empty) literal as one group
                    unit = [("r", self._anon_rule(rule_name, [unit]))]
                unit = [self._repeat(rule_name, unit[0], *rep)]
            seq.extend(unit)
        return seq

    def _repetition(self) -> Optional[tuple]:
        t = self.text
        if self.pos >= len(t):
            return None
        ch = t[self.pos]
        if ch == "*":
            self.pos += 1
            return (0, None)
        if ch == "+":
            self.pos += 1
            return (1, None)
        if ch == "?":
            self.pos += 1
            return (0, 1)
        if ch == "{":
            self.pos += 1
            start = self.pos
            while self.pos < len(t) and t[self.pos] != "}":
                self.pos += 1
            if self.pos >= len(t):
                raise GbnfParseError("unterminated {m,n} repetition")
            body = t[start: self.pos]
            self.pos += 1
            try:
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s) if lo_s.strip() else 0
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(body)
            except ValueError:
                raise GbnfParseError(f"bad repetition {{{body}}}") from None
            if hi is not None and hi < lo:
                raise GbnfParseError(f"bad repetition {{{body}}}")
            return (lo, hi)
        return None

    def _anon_rule(self, base: str, alts: list[list[tuple]]) -> str:
        self.anon += 1
        name = f"{base}@{self.anon}"
        self.rules[name] = alts
        return name

    def _repeat(self, base: str, elem: tuple, lo: int, hi: Optional[int]) -> tuple:
        """elem{lo,hi} → synthesized rules (llama.cpp rewrites the same way)."""
        if hi is None:
            # elem{lo,} = elem^lo  rest ;  rest ::= elem rest | ε
            rest = self._anon_rule(base, [[], []])
            self.rules[rest] = [[elem, ("r", rest)], []]
            return ("r", self._anon_rule(base, [[elem] * lo + [("r", rest)]]))
        # elem{lo,hi} = elem^lo (elem (elem (...)?)?)?  — nested optionals
        chain: list[tuple] = []
        for _ in range(hi - lo):
            if chain:
                chain = [elem, ("r", self._anon_rule(base, [chain, []]))]
            else:
                chain = [elem]
        tail = [("r", self._anon_rule(base, [chain, []]))] if chain else []
        return ("r", self._anon_rule(base, [[elem] * lo + tail]))


class CompiledGrammar:
    """Immutable rule table: rules[rid] = list of alternates, each a tuple of
    elements; refs hold integer rule ids."""

    def __init__(self, text: str):
        named = _Parser(text).parse()
        ids = {name: i for i, name in enumerate(named)}
        for alts in named.values():
            for alt in alts:
                for e in alt:
                    if e[0] == "r" and e[1] not in ids:
                        raise GbnfParseError(f"undefined rule {e[1]!r}")
        self.rules: list[list[tuple]] = [
            [tuple(("r", ids[e[1]]) if e[0] == "r" else e for e in alt)
             for alt in alts]
            for alts in named.values()
        ]
        self.root = ids["root"]
        self.text = text
        self._check_left_recursion()

    def _check_left_recursion(self) -> None:
        """Reject left-recursive grammars: stack expansion would not
        terminate (llama.cpp overflows on these; failing at parse is the
        honest version)."""
        # nullable rules (can derive ε) by fixpoint
        nullable = [False] * len(self.rules)
        changed = True
        while changed:
            changed = False
            for rid, alts in enumerate(self.rules):
                if nullable[rid]:
                    continue
                for alt in alts:
                    if all(e[0] == "r" and nullable[e[1]] for e in alt):
                        nullable[rid] = True
                        changed = True
                        break
        # left-ref graph: R → S when an alternate of R starts with refs of
        # nullable rules followed by a ref to S
        edges: list[set[int]] = [set() for _ in self.rules]
        for rid, alts in enumerate(self.rules):
            for alt in alts:
                for e in alt:
                    if e[0] != "r":
                        break
                    edges[rid].add(e[1])
                    if not nullable[e[1]]:
                        break
        # Iterative cycle check (user-supplied rule chains must not be able
        # to blow the Python stack): 0 unvisited, 1 in-stack, 2 done.
        state = [0] * len(self.rules)
        for r0 in range(len(self.rules)):
            if state[r0]:
                continue
            work: list[tuple[int, Any]] = [(r0, iter(edges[r0]))]
            state[r0] = 1
            while work:
                r, it = work[-1]
                nxt = next(it, None)
                if nxt is None:
                    state[r] = 2
                    work.pop()
                elif state[nxt] == 1:
                    raise GbnfParseError("left-recursive grammar is not supported")
                elif state[nxt] == 0:
                    state[nxt] = 1
                    work.append((nxt, iter(edges[nxt])))


# --------------------------------------------------------------------------- #
# Breadth-wise pushdown machine
# --------------------------------------------------------------------------- #


def _match(elem: tuple, cp: int) -> bool:
    _, ranges, neg = elem
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != neg


def _expand(g: CompiledGrammar, stack: tuple, out: set, seen: set) -> None:
    """Resolve leading rule refs until the top element is a char matcher (or
    the stack is empty). Branches into one stack per viable alternate.
    Iterative: grammar depth must not be able to blow the Python stack."""
    work = [stack]
    while work:
        st = work.pop()
        if not st or st[0][0] == "c":
            if len(st) <= MAX_STACK_DEPTH:
                out.add(st)
            continue
        if st in seen:
            continue  # ε-cycle (e.g. r ::= s, s ::= r): already expanding
        seen.add(st)
        rest = st[1:]
        for alt in g.rules[st[0][1]]:
            work.append(alt + rest)


def initial_state(g: CompiledGrammar) -> frozenset:
    out: set = set()
    _expand(g, (("r", g.root),), out, set())
    return frozenset(out)


def step_state(g: CompiledGrammar, stacks: frozenset, ch: str) -> frozenset:
    """Advance every viable stack past `ch`; empty result = rejected."""
    cp = ord(ch)
    out: set = set()
    for st in stacks:
        if st and st[0][0] == "c" and _match(st[0], cp):
            _expand(g, st[1:], out, set())
    if len(out) > MAX_STACKS:
        # Deterministic prune: keep the shallowest stacks (most likely to
        # complete). Pathological ambiguity only — real grammars stay tiny.
        out = set(sorted(out, key=lambda s: (len(s), s))[:MAX_STACKS])
    return frozenset(out)


def state_complete(stacks: frozenset) -> bool:
    return () in stacks


def state_strict(stacks: frozenset) -> bool:
    return bool(stacks) and all(not s for s in stacks)


class GbnfConstraint:
    """Engine-facing constraint (same interface as GrammarConstraint:
    allowed/advance/complete/strictly_complete). State is an immutable
    frozenset, so candidate checks need no deepcopy — they just walk a
    local variable."""

    def __init__(self, grammar: CompiledGrammar | str):
        if isinstance(grammar, str):
            grammar = CompiledGrammar(grammar)
        self.grammar = grammar
        self.state = initial_state(grammar)
        # The engine's untouched DFA path keys and compiles on .schema;
        # the marker dict routes compile_schema_dfa to the GBNF compiler.
        self.schema = {"__gbnf__": grammar.text}

    def _walk(self, stacks: frozenset, text: str) -> Optional[frozenset]:
        for ch in text:
            stacks = step_state(self.grammar, stacks, ch)
            if not stacks:
                return None
        return stacks

    def allowed(self, token_text: str) -> bool:
        if not token_text:
            return False
        return self._walk(self.state, token_text) is not None

    def advance(self, token_text: str) -> bool:
        nxt = self._walk(self.state, token_text)
        if nxt is None:
            return False
        self.state = nxt
        return True

    def complete(self) -> bool:
        return state_complete(self.state)

    def strictly_complete(self) -> bool:
        return state_strict(self.state)


# --------------------------------------------------------------------------- #
# DFA compilation (plugs into functions/dfa.py's token-table path)
# --------------------------------------------------------------------------- #


class GbnfCharDFA:
    """CharDFA-shaped object whose char classes are the intervals induced by
    every range endpoint in the grammar — exact for any codepoint."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray, bounds: list[int]):
        self.trans = trans  # [S, C] int32, -1 = reject
        self.accept = accept  # [S] bool
        self.bounds = bounds  # sorted interval starts; class i = [b[i], b[i+1])

    def class_of(self, ch: str) -> int:
        return bisect.bisect_right(self.bounds, ord(ch)) - 1


def _interval_bounds(g: CompiledGrammar) -> list[int]:
    """Split [0, 0x110000) at every range endpoint: inside one interval all
    codepoints are indistinguishable to every char element."""
    pts = {0}
    for alts in g.rules:
        for alt in alts:
            for e in alt:
                if e[0] == "c":
                    for lo, hi in e[1]:
                        pts.add(lo)
                        pts.add(hi + 1)
    pts.discard(0x110000)
    return sorted(pts)


def compile_gbnf_dfa(text: str, max_states: int = 3072) -> GbnfCharDFA:
    """BFS over reachable machine states → char-class DFA (the GBNF analogue
    of dfa.compile_schema_dfa; raises dfa.DfaUnsupported past the budget)."""
    from localai_tpu_torch.functions.dfa import DfaUnsupported

    try:
        g = CompiledGrammar(text)
    except GbnfParseError as e:  # API validation already rejected bad text;
        raise DfaUnsupported(str(e)) from None  # belt-and-braces for the cache

    bounds = _interval_bounds(g)
    reps = [chr(b) for b in bounds]
    C = len(reps)

    start = initial_state(g)
    states: list[frozenset] = [start]
    keys = {start: 0}
    rows: list[np.ndarray] = []
    from collections import deque

    queue = deque([0])
    while queue:
        i = queue.popleft()
        while len(rows) <= i:
            rows.append(np.full((C,), -1, np.int32))
        st = states[i]
        row = rows[i]
        for cid, ch in enumerate(reps):
            nxt = step_state(g, st, ch)
            if not nxt:
                continue
            j = keys.get(nxt)
            if j is None:
                if len(states) >= max_states:
                    raise DfaUnsupported(f"grammar needs > {max_states} DFA states")
                j = len(states)
                keys[nxt] = j
                states.append(nxt)
                queue.append(j)
            row[cid] = j
    trans = np.stack(rows) if rows else np.full((1, C), -1, np.int32)
    accept = np.asarray([state_complete(s) for s in states], bool)
    return GbnfCharDFA(trans, accept, bounds)
