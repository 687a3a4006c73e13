"""Journal → Chrome trace-event JSON (Perfetto-loadable), a copy of
localai_tpu/observe/timeline.py.

The export is the standard JSON-object form (`{"traceEvents": [...]}`)
that chrome://tracing and https://ui.perfetto.dev both load directly.
Mapping:

- one journal = one `pid` (process row), named by the engine/replica;
- `tid` is the engine slot (engine-wide events ride tid 0 labeled
  "engine-loop");
- events that carry a duration (`decode_block` dispatch wall, `loop_iter`
  fenced device time, `chunk`) become complete ("X") events ending at
  their journal timestamp; everything else is an instant ("i");
- timestamps are microseconds relative to the earliest journal anchor, so
  multi-journal exports (cluster replicas) share one timeline.
"""

from __future__ import annotations

from typing import Any

# Journal events whose `b` field is a duration in milliseconds.
_DUR_MS_EVENTS = {"decode_block", "loop_iter", "chunk"}


def chrome_trace(journals: dict[str, Any]) -> dict:
    """{"traceEvents": [...]} from {name: EventJournal}. Best-effort and
    read-only — safe to call against live engines."""
    events: list[dict] = []
    items = sorted(journals.items())
    anchor = min((j.t0_mono for _n, j in items), default=0.0)
    for pid, (name, j) in enumerate(items):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "engine-loop"},
        })
        for rec in j.snapshot():
            ts = max(0.0, (rec["t"] - anchor) * 1e6)
            tid = rec["slot"] if rec["slot"] >= 0 else 0
            args = {"seq": rec["seq"], "a": rec["a"], "b": rec["b"]}
            if rec["rid"]:
                args["rid"] = rec["rid"]
            if "phases" in rec:
                # loop_iter host-phase ms breakdown — visible in the
                # Perfetto args panel per window.
                args["phases"] = rec["phases"]
            ev: dict = {
                "name": rec["event"], "cat": "engine",
                "pid": pid, "tid": tid, "args": args,
            }
            dur_us = (rec["b"] * 1000.0
                      if rec["event"] in _DUR_MS_EVENTS else 0.0)
            if dur_us > 0:
                ev["ph"] = "X"
                ev["ts"] = max(0.0, ts - dur_us)
                ev["dur"] = dur_us
            else:
                ev["ph"] = "i"
                ev["ts"] = ts
                ev["s"] = "t"
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # The JAX package's generator name: both packages export the same
        # JSON for the same journal.
        "otherData": {"generator": "localai_tpu/observe"},
    }
