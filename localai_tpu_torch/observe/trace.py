"""Per-request span trees + W3C traceparent propagation (a copy of
localai_tpu/observe/trace.py; standard library only).

A `RequestTrace` is an append-only list of timestamped lifecycle notes for
ONE request leg on ONE engine; the span tree is DERIVED at read time (the
hot path only appends — `list.append` is the entire per-event cost). The
phase model tiles the request's wall clock exactly: consecutive notes
bound spans labeled by the state the earlier note entered, so phase
durations always sum to terminal−queued (the /debug/trace acceptance
contract: within 5% of measured wall time).

Trace identity follows W3C trace context: an incoming `traceparent` HTTP
header seeds the trace id and rides GenRequest.traceparent into the
engine (the server mints one when the client sent none), so every leg of
a request — each choice of an n > 1 group, a cluster replica once the
port has one — is retrievable from the process-wide `STORE` by request
id.

Thread model: notes are appended by whichever thread owns that lifecycle
step (engine loop, submit thread); readers snapshot via `list(events)`
(safe under the GIL against concurrent append). Terminal recording is
routed through the request handle's event queue (`engine.RequestHandle`),
so EVERY path that ends a stream — finish, cancel, deadline, loop death,
stop() — lands exactly one terminal note (later duplicates are ignored).
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Optional

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)

# Lifecycle note → the phase the request is in FROM that note on. Notes
# absent here (prefix_hit, annotations, chunk progress) are decorations —
# they do not change the phase.
PHASE_OF = {
    "queued": "queue",
    "admitted": "admit",
    "swap_in": "admit",
    "first_token": "decode",
    "resumed": "decode",
    "preempt": "preempted",
}


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a W3C traceparent header, or None
    on anything malformed (a bad header must never fail a request)."""
    m = _TRACEPARENT_RE.match((header or "").strip().lower())
    if not m:
        return None
    tid, sid = m.group(1), m.group(2)
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def new_traceparent() -> str:
    return format_traceparent(new_trace_id(), new_span_id())


class RequestTrace:
    """One request leg's lifecycle notes + derived span tree."""

    def __init__(self, request_id: str, traceparent: str = "",
                 engine: str = ""):
        parsed = parse_traceparent(traceparent)
        self.trace_id = parsed[0] if parsed else new_trace_id()
        self.parent_span_id = parsed[1] if parsed else ""
        self.span_id = new_span_id()
        self.request_id = request_id
        self.engine = engine
        self.events: list[tuple[float, str, Optional[dict]]] = []
        self.completed = False

    # ---------------- write side ---------------- #

    def note(self, name: str, **attrs: Any) -> None:
        """Record one lifecycle note. Hot-path cost: one list.append."""
        self.events.append((time.monotonic(), name, attrs or None))

    def terminal(self, ev: Any) -> None:
        """Record the terminal event (idempotent — only the FIRST terminal
        counts; stop()'s deliberate duplicate done events are ignored)."""
        if self.completed:
            return
        self.completed = True
        attrs: dict[str, Any] = {"kind": getattr(ev, "kind", "done")}
        reason = getattr(ev, "finish_reason", None)
        if reason:
            attrs["finish_reason"] = reason
        err = getattr(ev, "error", None)
        if err:
            attrs["error"] = str(err)
        ct = getattr(ev, "completion_tokens", 0)
        if ct:
            attrs["completion_tokens"] = ct
        self.events.append((time.monotonic(), "terminal", attrs))
        STORE.retire(self)

    # ---------------- read side ---------------- #

    def _ordered(self) -> list[tuple[float, str, Optional[dict]]]:
        evs = sorted(list(self.events), key=lambda e: e[0])
        out = []
        for e in evs:
            out.append(e)
            if e[1] == "terminal":
                break  # anything after the first terminal is noise
        return out

    def spans(self) -> list[dict]:
        """Phase spans tiling [first note, terminal]: each span runs from
        its entering note to the next phase-changing note (or terminal),
        so durations sum exactly to the leg's wall time."""
        evs = self._ordered()
        if not evs:
            return []
        marks = [(t, PHASE_OF[name], name) for t, name, _ in evs
                 if name in PHASE_OF]
        t_end = evs[-1][0]
        out = []
        for i, (t, phase, name) in enumerate(marks):
            nxt = marks[i + 1][0] if i + 1 < len(marks) else t_end
            out.append({
                "name": phase,
                "entered_by": name,
                "t_start": t,
                "t_end": nxt,
                "duration_ms": max(0.0, (nxt - t) * 1000.0),
            })
        return out

    def to_json(self) -> dict:
        evs = self._ordered()
        t0 = evs[0][0] if evs else 0.0
        t_end = evs[-1][0] if evs else 0.0
        return {
            "request_id": self.request_id,
            "engine": self.engine,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "traceparent": format_traceparent(self.trace_id, self.span_id),
            "complete": self.completed,
            "wall_ms": max(0.0, (t_end - t0) * 1000.0),
            "terminal_events": sum(1 for _, n, _a in evs if n == "terminal"),
            "spans": [
                {**s,
                 "t_start": round((s["t_start"] - t0) * 1000.0, 3),
                 "t_end": round((s["t_end"] - t0) * 1000.0, 3),
                 "duration_ms": round(s["duration_ms"], 3)}
                for s in self.spans()
            ],
            "events": [
                {"t_ms": round((t - t0) * 1000.0, 3), "name": n,
                 **({"attrs": a} if a else {})}
                for t, n, a in evs
            ],
        }


class TraceStore:
    """Process-wide registry of live + recently-completed request traces.

    The removal contract mirrors the engine's terminal-event discipline:
    the ONLY path that drops a live trace is `retire()`, which is invoked
    exactly by the trace's terminal recording — so a trace can never
    silently vanish while its request is still alive.
    """

    MAX_LIVE = 4096

    def __init__(self, keep: int = 256):
        self._lock = threading.Lock()
        self._live: dict[str, list[RequestTrace]] = {}
        self._done: deque[RequestTrace] = deque(maxlen=keep)
        self.dropped_live = 0

    def register(self, trace: RequestTrace) -> None:
        with self._lock:
            if len(self._live) >= self.MAX_LIVE and \
                    trace.request_id not in self._live:
                # Backstop against a producer that never terminates its
                # traces — bounded memory beats a perfect record.
                self.dropped_live += 1
                return
            self._live.setdefault(trace.request_id, []).append(trace)

    def retire(self, trace: RequestTrace) -> None:
        """Move a completed trace from the live table to the bounded done
        ring — the single sanctioned drop path from `_live`."""
        with self._lock:
            legs = self._live.get(trace.request_id)
            if legs is not None:
                legs = [t for t in legs if t is not trace]
                if legs:
                    self._live[trace.request_id] = legs
                else:
                    self._live.pop(trace.request_id, None)
            self._done.append(trace)

    def annotate(self, request_id: str, name: str, **attrs: Any) -> None:
        """Attach a note to the most recent LIVE leg of a request (the
        cluster layer marks reroutes/handoffs this way). No-op when the
        request is unknown or already completed."""
        with self._lock:
            legs = self._live.get(request_id)
            trace = legs[-1] if legs else None
        if trace is not None:
            trace.note(name, **attrs)

    def get(self, request_id: str) -> list[RequestTrace]:
        """All known legs for a request id, oldest first (live + done)."""
        with self._lock:
            live = list(self._live.get(request_id, ()))
            done = [t for t in self._done if t.request_id == request_id]
        seen: set[int] = set()
        out = []
        for t in done + live:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def get_json(self, request_id: str) -> Optional[dict]:
        legs = self.get(request_id)
        if not legs:
            return None
        return {
            "request_id": request_id,
            "trace_ids": sorted({t.trace_id for t in legs}),
            "legs": [t.to_json() for t in legs],
        }


STORE = TraceStore()
