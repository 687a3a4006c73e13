"""Fenced device times from CUDA events (the port's counterpart of
localai_tpu/observe/fence.py, EngineConfig.trace_fence).

The JAX package blocks on a dispatch's output to time it. The port brackets
a dispatch with a pair of `torch.cuda.Event(enable_timing=True)` recorded
on the engine's stream, and reads their `elapsed_time` after the block's
own host read of its sampled ids (Engine._run_block), which has already
waited for the end event. Fencing therefore adds no synchronisation of its
own: `elapsed_ms` asks `query()` first and reports 0.0 rather than wait
when the end event has not completed. A CPU engine has no device clock and
always reads 0.0.
"""

from __future__ import annotations

import torch


class DeviceFence:
    """One reusable start / end event pair on a device. `begin()` and
    `end()` bracket a dispatch; `elapsed_ms()` reads the device time
    between them once, after the caller's own synchronising read."""

    __slots__ = ("_start", "_end", "_armed")

    def __init__(self, device: torch.device) -> None:
        self._start = self._end = None
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
        self._armed = False

    def begin(self, stream=None) -> None:
        if self._start is not None:
            self._start.record(stream)
            self._armed = False

    def end(self, stream=None) -> None:
        if self._end is not None:
            self._end.record(stream)
            self._armed = True

    def elapsed_ms(self) -> float:
        """Device ms between the last begin() and end(), or 0.0: on the
        CPU, with no pair recorded, or when the end event is still pending
        (never waited for). Reads a pair once."""
        if not self._armed:
            return 0.0
        self._armed = False
        try:
            if not self._end.query():
                return 0.0
            return float(self._start.elapsed_time(self._end))
        except RuntimeError:  # a measurement, never worth failing a block over
            return 0.0
