"""JSON-Schema → token-level DFA tables for on-device constrained decoding.

The pushdown machine in functions/jsonschema.py is the semantic source of
truth; this module compiles it to a finite automaton so the constraint can
run INSIDE the fused decode blocks instead of a host round-trip per token
(SURVEY §7 hard part: "grammar decode without host round-trips per token —
mask precomputation / on-device DFA"; reference: llama.cpp applies its GBNF
grammar inside the sampler, grpc-server.cpp).

Why this terminates: a JSON Schema without recursive $refs has bounded
nesting, so the set of reachable machine configurations is finite — the
machine is effectively a DFA for a fixed schema. We enumerate reachable
configurations by BFS over a small character-class alphabet, then lift the
char-level DFA to the token vocabulary: for each (state, token) pair, walk
the token's characters through the DFA. The result is three small tables
the engine keeps on device (see TokenTables):

  mask_bits uint8 [S+1, ceil(V/8)]  bit v of row s = token v legal in state s
  trans     int16 [S+1, C]          char-class transitions (walked on device
                                    for the sampled token — no [S, V] table)
  tok_cls   int16 [V, MAX_TOK_LEN]  each token's char-class sequence

Row 0 is the reserved FREE state (everything legal, self-loop): slots not
under a grammar run through the same program unmasked, so constrained and
unconstrained requests batch together. The EOS column is legal exactly in
accepting states, which is also how a finished value terminates: a state
whose only legal continuation is EOS forces the model to stop.

Build cost is host-side and cached per (schema, tokenizer); schemas that
exceed the state budget raise DfaUnsupported and the engine falls back to
the host candidate-walk path.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Optional

import numpy as np

from localai_tpu_torch.functions.jsonschema import (
    JsonSchemaMachine,
    _Array,
    _Frame,
    _Object,
)

# Alphabet: every printable ASCII char is its own class (structure chars,
# literal/property-name spelling), plus \t \n \r, a control-char class, any
# non-ASCII chars that appear in the schema's own literals, and OTHER for
# every remaining char (string bodies treat them all alike).
_PRINTABLE = [chr(c) for c in range(0x20, 0x7F)]
_OTHER_REP = ""  # private-use: never appears in schemas
_CTRL_REP = "\x01"


class DfaUnsupported(Exception):
    """Schema doesn't fit the DFA budget — use the host-walk fallback."""


def _schema_strings(schema: Any, out: Optional[list] = None) -> list:
    """Every string literal a schema can force into the output."""
    if out is None:
        out = []
    if isinstance(schema, dict):
        for v in schema.values():
            _schema_strings(v, out)
        for k in schema.get("properties", {}) or {}:
            out.append(k)
    elif isinstance(schema, list):
        for v in schema:
            _schema_strings(v, out)
    elif isinstance(schema, str):
        out.append(schema)
    return out


def _clone_frame(f: _Frame, machine) -> _Frame:
    new = object.__new__(type(f))
    for k, v in f.__dict__.items():
        if k == "machine":
            v = machine
        elif isinstance(v, _Frame):
            v = _clone_frame(v, machine)
        elif isinstance(v, set):
            v = set(v)
        elif isinstance(v, list) and not (v and isinstance(v[0], (dict, _Frame))):
            v = list(v)
        # dicts (schemas) are read-only by construction — share them.
        new.__dict__[k] = v
    return new


def _clone_machine(m: JsonSchemaMachine) -> JsonSchemaMachine:
    """Structure-sharing clone: frames copy their scalar state but share the
    (immutable) schema dicts — orders of magnitude cheaper than deepcopy and
    keeps schema identity stable for config hashing."""
    new = object.__new__(JsonSchemaMachine)
    new.max_ws_run = m.max_ws_run
    new.ws_run = m.ws_run
    new.stack = []
    new.stack.extend(_clone_frame(f, new) for f in m.stack)
    return new


def _key_val(v: Any) -> Any:
    if isinstance(v, _Frame):
        return _frame_key(v)
    if isinstance(v, dict):
        return id(v)  # shared schema object — identity is stable (see clone)
    if isinstance(v, set):
        return frozenset(v)
    if isinstance(v, list):
        return tuple(_key_val(x) for x in v)
    return v


def _frame_key(f: _Frame) -> tuple:
    d = dict(f.__dict__)
    # Saturate unbounded counters so the config space stays finite: an
    # array's item count only matters against min/maxItems (without
    # maxItems, every n >= minItems behaves identically), and an object's
    # count is only ever compared against 0.
    if isinstance(f, _Array) and f.max_items is None:
        d["n"] = min(f.n, f.min_items)
    elif isinstance(f, _Object):
        d["n"] = min(f.n, 1)
    items = tuple(
        (k, _key_val(v)) for k, v in sorted(d.items()) if k != "machine"
    )
    return (type(f).__name__, items)


def _config_key(m: JsonSchemaMachine) -> tuple:
    return (m.ws_run, tuple(_frame_key(f) for f in m.stack))


class CharDFA:
    def __init__(self, trans: np.ndarray, accept: np.ndarray,
                 classes: dict[str, int], other_class: int, ctrl_class: int):
        self.trans = trans  # [S, C] int32, -1 = reject
        self.accept = accept  # [S] bool
        self.classes = classes
        self.other_class = other_class
        self.ctrl_class = ctrl_class

    def class_of(self, ch: str) -> int:
        cid = self.classes.get(ch)
        if cid is not None:
            return cid
        if ch < " ":  # control chars share one (rejected-in-strings) class
            return self.ctrl_class
        return self.other_class


def compile_schema_dfa(schema: Any, max_states: int = 3072,
                       max_ws_run: int = 1) -> CharDFA:
    """BFS over reachable machine configurations → char-class DFA.

    A `{"__gbnf__": <text>}` marker (functions/gbnf.py GbnfConstraint.schema)
    routes to the GBNF machine's compiler — raw grammars ride the same
    token-table path and cache as JSON schemas."""
    if isinstance(schema, dict) and "__gbnf__" in schema:
        from localai_tpu_torch.functions.gbnf import compile_gbnf_dfa

        return compile_gbnf_dfa(schema["__gbnf__"], max_states=max_states)
    extra = sorted({ch for s in _schema_strings(schema) for ch in s
                    if ord(ch) > 0x7E})
    reps = _PRINTABLE + ["\t", "\n", "\r", _CTRL_REP] + extra + [_OTHER_REP]
    classes = {ch: i for i, ch in enumerate(reps)}
    other_class = len(reps) - 1
    C = len(reps)

    start = JsonSchemaMachine(schema, max_ws_run=max_ws_run)
    states: list[JsonSchemaMachine] = [start]
    keys = {_config_key(start): 0}
    rows: list[np.ndarray] = []
    queue = deque([0])
    while queue:
        i = queue.popleft()
        while len(rows) <= i:
            rows.append(np.full((C,), -1, np.int32))
        m = states[i]
        row = rows[i]
        for cid, ch in enumerate(reps):
            c = _clone_machine(m)
            if not c.feed(ch):
                continue
            k = _config_key(c)
            j = keys.get(k)
            if j is None:
                if len(states) >= max_states:
                    raise DfaUnsupported(
                        f"schema needs > {max_states} DFA states"
                    )
                j = len(states)
                keys[k] = j
                states.append(c)
                queue.append(j)
            row[cid] = j
    trans = np.stack(rows)
    accept = np.asarray([s.is_complete() for s in states], bool)
    # Strictly-complete states (empty stack) admit ONLY EOS: the machine
    # itself tolerates one trailing whitespace char, but emitting it would
    # append junk to structured output — the host-walk path avoids that by
    # finishing at strictly_complete(), and the DFA must match ('false\r'
    # is not 'false'). Trailing-number states keep their digits (non-empty
    # stack), so "12" can still extend to "123".
    strict = np.asarray([not s.stack for s in states], bool)
    trans[strict] = -1
    return CharDFA(trans, accept, classes, other_class, classes[_CTRL_REP])


# Tokens longer than this many characters are never grammar-legal (the
# device transition walk is a fixed-length scan). Real vocabularies keep
# structural tokens short; only exotic whitespace/indent tokens exceed it.
MAX_TOK_LEN = 32


# A [S, V] next-state-by-token table costs (S+1)·V·2 bytes on device; for
# small automata that is cheap (64 MB at 256 states × 128k vocab) and
# replaces the per-step 32-gather char walk with ONE gather — worth ~40% of
# constrained decode throughput. Bigger automata keep the char walk.
NEXT_TOK_MAX_STATES = 256


class TokenTables:
    """Device-ready constraint tables.

    mask_bits uint8 [S+1, ceil(V/8)] — bit v of row s: token v legal in
      state s. Row 0 is FREE (everything legal); DFA state s is row s+1.
    trans     int16 [S+1, C] — char-class transition table (row 0
      self-loops); the decode block walks the SAMPLED token's classes
      through it to get the next state when next_tok is absent.
    tok_cls   int16 [V, MAX_TOK_LEN] — each token's char-class sequence,
      -1 padded.
    next_tok  int16 [S+1, V] or None — direct state-after-token table,
      built for automata with ≤ NEXT_TOK_MAX_STATES states (values for
      illegal tokens are meaningless; the mask rules them out first).
    init_state = 1 (the machine's start configuration).
    """

    def __init__(self, mask_bits, trans, tok_cls, accept, next_tok=None):
        self.mask_bits = mask_bits
        self.trans = trans
        self.tok_cls = tok_cls
        self.accept = accept  # [S+1] bool (FREE row accepting)
        self.next_tok = next_tok
        self.init_state = 1


def build_token_tables(
    dfa: CharDFA,
    tok_strs: list[str],
    eos_ids: set[int],
    vocab_size: int,
    chunk: int = 16384,
) -> TokenTables:
    """Lift the char DFA to the token vocabulary (mask only — transitions
    stay char-level and are walked on device).

    Raises DfaUnsupported if some reachable non-accepting state has no legal
    token (the constraint would wedge there).
    """
    S, C = dfa.trans.shape
    if S + 1 > np.iinfo(np.int16).max:
        raise DfaUnsupported("state count exceeds int16 table range")
    V = vocab_size
    n_tok = min(len(tok_strs), V)

    # Token → class-id sequences, grouped by length so the vectorized walk
    # only advances positions that still have characters.
    lens = np.zeros((V,), np.int32)
    seqs: list[list[int]] = [[] for _ in range(V)]
    for t in range(n_tok):
        s = tok_strs[t]
        if t in eos_ids or len(s) > MAX_TOK_LEN:
            continue
        lens[t] = len(s)
        seqs[t] = [dfa.class_of(ch) for ch in s]
    order = np.argsort(lens, kind="stable")

    build_next = S + 1 <= NEXT_TOK_MAX_STATES
    allowed = np.zeros((S, V), bool)
    final = np.zeros((S, V), np.int32) if build_next else None
    for c0 in range(0, V, chunk):
        ids = order[c0: c0 + chunk]
        clen = int(lens[ids].max()) if len(ids) else 0
        if clen == 0:
            continue
        cls_seq = np.full((len(ids), clen), -1, np.int16)
        for j, t in enumerate(ids):
            cls_seq[j, : lens[t]] = seqs[t]
        cur = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None],
                              (S, len(ids))).copy()
        alive = np.ones((S, len(ids)), bool)
        for p in range(clen):
            csel = cls_seq[:, p]
            act = csel >= 0
            if not act.any():
                break
            step = dfa.trans[np.maximum(cur, 0), np.maximum(csel, 0)[None, :]]
            upd = act[None, :] & alive
            cur = np.where(upd, step, cur)
            alive = np.where(upd, step >= 0, alive)
        ok = alive & (lens[ids] > 0)[None, :]
        allowed[:, ids] = ok
        if build_next:
            final[:, ids] = np.where(ok, cur, 0)

    # EOS legal exactly in accepting states.
    for e in eos_ids:
        if 0 <= e < V:
            allowed[:, e] = dfa.accept

    wedged = ~dfa.accept & ~allowed.any(axis=1)
    if wedged.any():
        raise DfaUnsupported(
            f"{int(wedged.sum())} reachable states admit no token from this "
            "vocabulary"
        )

    # Prepend FREE row 0; DFA state s lives at row s+1.
    mask = np.zeros((S + 1, V), bool)
    mask[0] = True
    mask[1:] = allowed
    mask_bits = np.packbits(mask, axis=1, bitorder="little")

    trans = np.zeros((S + 1, C), np.int16)  # FREE row self-loops at 0
    trans[1:] = np.where(dfa.trans >= 0, dfa.trans + 1, 0).astype(np.int16)

    tok_cls = np.full((V, MAX_TOK_LEN), -1, np.int16)
    for t in range(n_tok):
        if lens[t]:
            tok_cls[t, : lens[t]] = seqs[t]

    accept = np.zeros((S + 1,), bool)
    accept[0] = True
    accept[1:] = dfa.accept
    next_tok = None
    if build_next:
        next_tok = np.zeros((S + 1, V), np.int16)  # FREE row self-loops at 0
        next_tok[1:] = np.where(allowed, final + 1, 0).astype(np.int16)
    return TokenTables(mask_bits, trans, tok_cls, accept, next_tok)


# Host-side cache: schemas repeat across requests (tool-calling reuses one
# schema for a whole deployment), so compiled tables are memoized. Both maps
# are bounded — schemas arrive from the serving API, so unbounded growth
# would be a client-drivable leak.
_CACHE: dict[tuple, TokenTables] = {}
_CACHE_MAX = 8
_FAILED: dict[tuple, bool] = {}  # insertion-ordered — evicted FIFO
_FAILED_MAX = 256
_PINNED: set = set()  # prewarmed keys exempt from LRU eviction (operator-controlled)
_BUILDING: dict = {}  # key -> threading.Event, dedupes concurrent builds
_LOCK = threading.Lock()


def schema_key(schema: Any) -> str:
    return json.dumps(schema, sort_keys=True, separators=(",", ":"), default=str)


def unpin(tokenizer_id: Any = None) -> None:
    """Drop pinned tables (all, or those for one tokenizer fingerprint).

    Engines call this with their fingerprint at stop so prewarmed tables
    keyed to a dead tokenizer don't leak for the process lifetime across
    model hot-swaps."""
    with _LOCK:
        for key in list(_PINNED):
            if tokenizer_id is None or key[1] == tokenizer_id:
                _PINNED.discard(key)
                _CACHE.pop(key, None)


def is_cached(schema: Any, tokenizer_id: Any, vocab_size: int) -> bool:
    """True when tables_for will return instantly (hit or known-failure)."""
    key = (schema_key(schema), tokenizer_id, vocab_size)
    with _LOCK:
        return key in _CACHE or key in _FAILED


def tables_for(schema: Any, tok_strs: list[str], eos_ids: set[int],
               vocab_size: int, tokenizer_id: Any = None,
               max_states: int = 3072, pin: bool = False,
               cached_only: bool = False) -> Optional[TokenTables]:
    """Cached TokenTables for a schema, or None if unsupported.

    Concurrent calls for the same key build once: the second caller blocks
    on the first build's completion instead of burning a redundant
    multi-second compile. `pin=True` (prewarm path) exempts the entry from
    LRU eviction so a warmed schema stays resident regardless of how many
    request-driven schemas churn through the bounded cache. `cached_only`
    never builds — it returns the hit or None, so latency-critical threads
    (the engine loop) cannot become the builder even if the entry was
    evicted between an `is_cached` check and this call.
    """
    key = (schema_key(schema), tokenizer_id, vocab_size)
    while True:
        with _LOCK:
            if key in _FAILED:
                return None
            hit = _CACHE.pop(key, None)
            if hit is not None:
                _CACHE[key] = hit  # LRU bump
                if pin:
                    _PINNED.add(key)
                return hit
            if cached_only:
                return None
            ev = _BUILDING.get(key)
            if ev is None:
                ev = threading.Event()
                _BUILDING[key] = ev
                break  # we build
        ev.wait()  # someone else is building this key; wait and re-check
    try:
        try:
            dfa = compile_schema_dfa(schema, max_states=max_states)
            tables = build_token_tables(dfa, tok_strs, eos_ids, vocab_size)
        except Exception as ex:  # noqa: BLE001 — any build failure (incl. a
            # compiler bug on one input) must record the key as failed, or
            # the engine respawns doomed background builds for it forever.
            if not isinstance(ex, DfaUnsupported):
                import logging

                logging.getLogger("localai_tpu_torch.dfa").exception(
                    "grammar DFA build failed unexpectedly"
                )
            with _LOCK:
                _FAILED[key] = True
                while len(_FAILED) > _FAILED_MAX:
                    _FAILED.pop(next(iter(_FAILED)))
            return None
        with _LOCK:
            _CACHE[key] = tables
            if pin:
                _PINNED.add(key)
            # Request-driven (unpinned) entries stay bounded; pinned entries
            # are operator-controlled and never evicted.
            evictable = [k for k in _CACHE if k not in _PINNED]
            while len(evictable) > _CACHE_MAX:
                _CACHE.pop(evictable.pop(0))
        return tables
    finally:
        with _LOCK:
            _BUILDING.pop(key, None)
        ev.set()
