"""Engine-loop runtime helpers (copies of the JAX package's
engine/runtime.py `LoopPhases` and `DeadlineIndex`; its `ControlStager`
has no counterpart in the port: it belongs with pipelined dispatch,
ROADMAP Queue A item 1, CUDA graphs beyond the decode block, and
pipelined dispatch).

- `LoopPhases` — a per-iteration monotonic phase accumulator whose vector
  rides the `loop_iter` journal event, so loop overhead per block is
  attributable from the journal alone. The port's loop is serial
  (Engine._loop); its phases map onto LOOP_PHASES as:
    drain        staged journal events moved into the ring;
    purge        _purge_pending, _enforce_deadlines, _finish_cancelled;
    admit        _admit_pending;
    prep         the block's plan and page growth in _run_block;
    commit       _stage_block (the control rows into the graph's buffers);
    dispatch     the graph replay or eager body, plus the chunk advance;
    process      the block's host read and token posting;
    housekeeping _spill_cold_pages and _service_forks;
    wait         self._wake.wait on an idle loop.
  An embed / rerank forward the loop runs for another thread
  (Engine._service_job) is in no phase: the reference runs it on the
  HTTP thread, outside its loop. Its time is the engine's
  `loop_jobs_ms_total`.
- `DeadlineIndex` — a lazy-deletion min-heap of absolute monotonic
  deadlines. Submit pushes each request's deadline / queue-timeout
  expiry; the loop's wait wakes at the earliest one, so an idle engine
  still expires a pending request on time.
"""

from __future__ import annotations

import heapq
import math
import threading
import time

# Host-phase names for one loop iteration, in emit order. observe/journal's
# LOOP_PHASES mirrors this tuple (the observe layer stays engine-free; a
# test pins the two equal).
LOOP_PHASES = (
    "drain",         # staged journal events moved into the ring
    "purge",         # pending purge + active-deadline enforcement
    "admit",         # admission (slot claim + prefill dispatch)
    "prep",          # control-plan build (variant / growth / spec plan)
    "commit",        # H2D control commit (the block's staged buffers)
    "dispatch",      # decode/spec block dispatch + chunk advance
    "process",       # the block's host read and token posting
    "housekeeping",  # cold-page spill, mid-stream forks
    "wait",          # idle wait on the loop's wake event
)


class LoopPhases:
    """Accumulates per-phase host milliseconds across loop iterations.

    The loop calls `mark()` at the top of an iteration and `lap(name)`
    after each phase; `vector()`/`total()` feed the coalesced `loop_iter`
    journal emission, after which `reset()` starts the next window.
    """

    __slots__ = ("names", "ms", "iters", "_mark")

    def __init__(self, names=LOOP_PHASES):
        # Loop-thread state, read best-effort by metrics after the fact.
        self.names = tuple(names)
        self.ms = {n: 0.0 for n in self.names}
        self.iters = 0
        self._mark = 0.0

    def mark(self) -> None:
        self._mark = time.monotonic()

    def lap(self, name: str) -> None:
        now = time.monotonic()
        self.ms[name] += (now - self._mark) * 1000.0
        self._mark = now

    def total(self, exclude: tuple = ("wait",)) -> float:
        return sum(v for n, v in self.ms.items() if n not in exclude)

    def vector(self) -> list:
        return [self.ms[n] for n in self.names]

    def reset(self) -> None:
        for n in self.names:
            self.ms[n] = 0.0
        self.iters = 0


class DeadlineIndex:
    """Lazy-deletion min-heap of absolute `time.monotonic()` deadlines.

    Submit-side threads push; the loop's housekeeping gate peeks. Entries
    are never individually removed — a deadline that resolved early
    (request finished, cancel) just pops as a no-op when it comes due, so
    `due()` may fire a tick with nothing to purge; the purge scan it
    triggers is the same one the serial loop ran every iteration.
    """

    def __init__(self):
        self._heap: list = []
        self._lock = threading.Lock()

    def push(self, t: float) -> None:
        with self._lock:
            heapq.heappush(self._heap, float(t))

    def next_due(self) -> float:
        with self._lock:
            return self._heap[0] if self._heap else math.inf

    def due(self, now: float) -> bool:
        """True when the earliest deadline has passed; pops every expired
        entry so the next peek is O(1) again."""
        with self._lock:
            if not self._heap or self._heap[0] > now:
                return False
            while self._heap and self._heap[0] <= now:
                heapq.heappop(self._heap)
            return True
