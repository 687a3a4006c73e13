"""Bounded ring-buffer event journal for the engine loop (a copy of
localai_tpu/observe/journal.py; numpy only, no torch).

Design constraints, in order:

- The append path is called from the engine loop between decode-block
  dispatches, so it must be O(1), allocation-free, and never touch the
  device. Storage is a preallocated numpy structured array; appends write
  FIELD-WISE into fixed storage (no tuple/dict is built), and the only
  state change is a monotonically-growing sequence counter. The loop
  thread is the single writer — no lock on the hot path.
- Other threads DO emit lifecycle events (submit queues a request on a
  caller thread, span export runs on HTTP threads). Those `stage()` into a
  small locked sidecar list the loop thread drains at the top of each
  iteration (`drain_staged` — same idiom as the engine's span inbox), so
  the ring stays single-writer.
- Readers (`snapshot`) are best-effort: they copy the buffer and walk it
  by sequence number. A reader racing the writer can observe a freshly
  overwritten slot — acceptable for a flight recorder; the alternative is
  a lock on every append.

Event types are declared here (`EVENTS`); the fault subset
(`FAULT_EVENTS`) mirrors `localai_tpu_torch.testing.faults.SITES`
one-to-one, and tests/test_torch_observe.py checks both directions. The
order of EVENTS is the wire code: events whose producers the port does
not have yet (the cluster's) keep their codes.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# Lifecycle + loop events. Order is the wire code (index), so append-only.
BASE_EVENTS = (
    "queued",        # request entered the pending queue (staged; rid)
    "admitted",      # slot claimed, admission program dispatched (slot, a=plen)
    "chunk",         # one mid prefill chunk dispatched (slot, a=tokens)
    "first_token",   # admission result produced the first token (slot)
    "decode_block",  # decode/spec block dispatched (a=block size, b=dispatch ms)
    "loop_iter",     # coalesced loop-iteration window (a=occupancy, b=host ms
    #                  spent this window — or fenced device ms under
    #                  trace_fence when the window dispatched; the per-phase
    #                  host-ms breakdown rides the `phases` vector)
    "preempt",       # slot preempted for pool pressure (slot, a=ctx rows)
    "swap_out",      # preempt-swap image written to the host tier (a=bytes)
    "swap_in",       # swap resume restored pool pages (slot, a=bytes)
    "resume",        # recompute resume re-admitted (slot)
    "prefix_hit",    # admission mapped a cached span (slot, a=matched tokens)
    "span_export",   # prefix span framed for transfer (staged; a=tokens)
    "span_import",   # transfer frame merged into the host tier (a=tokens)
    "terminal",      # request finished (slot, a=completion tokens)
    "error",         # a dispatch failed; affected requests got error events
    "loop_dead",     # the engine loop died (postmortem follows)
    "profile",       # a profiler capture window ran (a=seconds)
    "spec_draft",    # verify round dispatched (a=drafted tokens, b=window)
    "spec_verify",   # verify round processed (a=drafted, b=emitted tokens)
    "page_spill",    # cold middle pages copied to host, device pages freed
    #                  (slot, a=pages, b=bytes; docs/LONG_CONTEXT.md)
    "page_restore",  # spilled pages swapped back into fresh pool pages
    #                  (slot, a=pages, b=bytes)
    "forked",        # slot forked off a freshly-admitted sibling (slot=branch,
    #                  a=shared prompt/boundary rows, b=source slot;
    #                  docs/TREE_SAMPLING.md)
    "member_state",  # cluster replica lifecycle transition (staged; rid=
    #                  replica name, a=new state index, b=old state index —
    #                  indices into cluster.scheduler.MEMBER_STATES;
    #                  docs/CLUSTER.md "Membership lifecycle")
    "breaker_open",  # per-replica circuit breaker tripped open (staged;
    #                  rid=replica name, a=consecutive failures)
    "breaker_probe", # half-open breaker admitted its ONE probe call
    #                  (staged; rid=replica name, a=total probes) — chaos
    #                  runs assert ≤1 per half-open window from these
    "breaker_close", # breaker closed again after a successful probe
    #                  (staged; rid=replica name)
    "reroute_replay",# grammar-bearing request rerouted mid-stream: emitted
    #                  tokens replayed through a fresh grammar machine on
    #                  the survivor (staged; rid, a=replayed tokens,
    #                  b=reroute attempt number; docs/CLUSTER.md)
    "affinity_handoff",  # a draining/dead replica's span affinity moved to
    #                  a survivor instead of being dropped (staged; rid=
    #                  source replica, a=digests moved)
)

# One journal event type per fault-injection site (faults.SITES), checked
# both directions by tests/test_torch_observe.py: a site added without an
# event type (or vice versa) fails it. Literal on purpose — the check is
# AST-level.
FAULT_EVENTS = (
    "fault_device_dispatch",
    "fault_engine_loop",
    "fault_page_alloc",
    "fault_host_swap",
    "fault_manager_load",
    "fault_cluster_dispatch",
    "fault_span_transfer",
    "fault_host_partition",
    "fault_slow_network",
    "fault_collective_dispatch",
    "fault_adapter_fetch",
    "fault_spec_verify",
    "fault_page_spill",
    "fault_control_commit",
    "fault_slot_fork",
    "fault_gauge_scrape",
)

EVENTS = BASE_EVENTS + FAULT_EVENTS
CODES = {name: i for i, name in enumerate(EVENTS)}

# Host-phase names for one loop_iter window (engine/runtime.LOOP_PHASES is
# the writer-side source; this copy keeps the observe layer engine-free and
# a test pins the two tuples equal). The per-event `ph` vector stores
# milliseconds per phase in this order.
LOOP_PHASES = (
    "drain", "purge", "admit", "prep", "commit", "dispatch", "process",
    "housekeeping", "wait",
)

_DTYPE = np.dtype([
    ("t", np.float64),      # time.monotonic() at emit
    ("code", np.int16),     # index into EVENTS
    ("slot", np.int16),     # engine slot, -1 = engine-wide
    ("a", np.float64),      # event-specific scalar (see EVENTS comments)
    ("b", np.float64),      # second event-specific scalar
    ("rid", "U40"),         # request id (empty for engine-wide events)
    ("ph", np.float32, (len(LOOP_PHASES),)),  # loop_iter host-phase ms
])

_STAGED_CAP = 1024


class EventJournal:
    """Fixed-capacity ring of typed events. Single writer (the engine
    loop); `stage()` is the cross-thread entry point."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(int(capacity), 8)
        # thread: single-writer engine-loop — the ring is written by the
        # loop thread alone (appends + staged drain); snapshot() readers
        # are deliberately best-effort (may see a freshly overwritten slot)
        self._buf = np.zeros(self.capacity, dtype=_DTYPE)
        self.n = 0  # total events ever appended (monotonic sequence)
        self._staged: list[tuple] = []
        self._staged_lock = threading.Lock()
        self.dropped_staged = 0
        # Wall-clock anchor so exports can place monotonic stamps in time.
        self.t0_mono = time.monotonic()
        self.t0_wall = time.time()

    # ---------------- write side ---------------- #

    # thread: engine-loop-only
    def append(self, event: str, rid: str = "", slot: int = -1,
               a: float = 0.0, b: float = 0.0, phases=None) -> None:
        """Writer-thread append: O(1), no allocation, no lock, no device.
        Only the loop thread calls it; cross-thread emitters use stage().
        `phases` (loop_iter only) is a LOOP_PHASES-ordered ms sequence."""
        self._append_raw(time.monotonic(), event, rid, slot, a, b, phases)

    def _append_raw(self, t: float, event: str, rid: str, slot: int,
                    a: float, b: float, phases=None) -> None:
        i = self.n % self.capacity
        buf = self._buf
        buf["t"][i] = t
        buf["code"][i] = CODES[event]
        buf["slot"][i] = slot
        buf["a"][i] = a
        buf["b"][i] = b
        buf["rid"][i] = rid
        buf["ph"][i] = phases if phases is not None else 0.0
        self.n += 1

    def stage(self, event: str, rid: str = "", slot: int = -1,
              a: float = 0.0, b: float = 0.0) -> None:
        """Cross-thread emit: park the event for the writer thread to
        append in order. Bounded — a stalled writer drops (and counts)
        staged events instead of growing without limit."""
        rec = (time.monotonic(), event, rid, slot, a, b)
        with self._staged_lock:
            if len(self._staged) >= _STAGED_CAP:
                self.dropped_staged += 1
                return
            self._staged.append(rec)

    # thread: engine-loop-only
    def drain_staged(self) -> None:
        """Writer thread: move staged events into the ring (original
        timestamps preserved)."""
        if not self._staged:  # unlocked peek — len() is atomic in CPython
            return
        with self._staged_lock:
            staged, self._staged = self._staged, []
        for rec in staged:
            self._append_raw(*rec)

    # ---------------- read side ---------------- #

    def snapshot(self, last: int | None = None) -> list[dict]:
        """Best-effort ordered copy of the retained events (ring tail +
        currently staged), oldest first. Safe from any thread."""
        n = self.n
        buf = self._buf.copy()
        start = max(0, n - self.capacity)
        out = []
        for seq in range(start, n):
            rec = buf[seq % self.capacity]
            d = {
                "seq": seq,
                "t": float(rec["t"]),
                "event": EVENTS[int(rec["code"])],
                "slot": int(rec["slot"]),
                "a": float(rec["a"]),
                "b": float(rec["b"]),
                "rid": str(rec["rid"]),
            }
            ph = rec["ph"]
            if ph.any():
                d["phases"] = {LOOP_PHASES[k]: float(v)
                               for k, v in enumerate(ph) if v}
            out.append(d)
        with self._staged_lock:
            staged = list(self._staged)
        for t, event, rid, slot, a, b in staged:
            out.append({
                "seq": -1, "t": float(t), "event": event, "slot": int(slot),
                "a": float(a), "b": float(b), "rid": str(rid),
            })
        out.sort(key=lambda e: e["t"])
        if last is not None and last >= 0:
            out = out[-last:]
        return out
