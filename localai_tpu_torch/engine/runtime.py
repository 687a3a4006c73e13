"""Engine-loop runtime helpers (a copy of the JAX package's
engine/runtime.py `DeadlineIndex`; its stager and phase accumulator have
no counterpart in the port).

- `DeadlineIndex` — a lazy-deletion min-heap of absolute monotonic
  deadlines. Submit pushes each request's deadline / queue-timeout
  expiry; the loop's wait wakes at the earliest one, so an idle engine
  still expires a pending request on time.
"""

from __future__ import annotations

import heapq
import math
import threading


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
