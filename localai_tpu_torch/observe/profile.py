"""On-demand `torch.profiler` capture windows (/debug/profile), the port's
counterpart of localai_tpu/observe/profile.py.

Gated behind ApplicationConfig.profile_dir (LOCALAI_PROFILE, the output
directory): profiling perturbs serving and writes traces to disk, so it is
an explicit operator opt-in. One capture at a time — the profiler keeps
process-global state; a second caller gets RuntimeError (HTTP 409). A
window records CPU activity and, when the process has a GPU, CUDA activity
(process-wide: every kernel the engine loop launches or replays from a
CUDA graph inside the window), and exports one Chrome trace JSON file that
Perfetto loads. `prepare()` must run first on the thread that imported
torch (the server does it at startup).
"""

from __future__ import annotations

import os
import threading
import time

_capture_lock = threading.Lock()
_prepared = False

MAX_SECONDS = 30.0


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    out = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        out.append(ProfilerActivity.CUDA)
    return out


def prepare() -> None:
    """Initialise the profiler's tracer on the calling thread, once. Kineto
    (torch.profiler's tracer) runs its one-time initialisation on the
    thread that registered it, the one that imported torch: a first window
    started on another thread (an HTTP handler's) records no device
    activity ("External init callback must run in same thread as
    registerClient"). The server calls this from its main thread at
    startup when capture windows are allowed."""
    global _prepared
    with _capture_lock:
        if _prepared:
            return
        from torch.profiler import profile

        with profile(activities=_activities()):
            pass
        _prepared = True


def capture(dirpath: str, seconds: float) -> dict:
    """Run one profiler capture window of `seconds` (clamped to [0.1,
    MAX_SECONDS]; blocking) and export it into `dirpath`. Returns {"dir",
    "file", "seconds"}. Raises RuntimeError when a capture is already in
    flight or the profiler fails."""
    seconds = max(0.1, min(float(seconds), MAX_SECONDS))
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    try:
        from torch.profiler import profile

        activities = _activities()
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"profile-{int(time.time() * 1000)}-{os.getpid()}.json")
        t0 = time.monotonic()
        try:
            prof = profile(activities=activities)
            prof.start()
            try:
                time.sleep(seconds)
            finally:
                prof.stop()
            elapsed = time.monotonic() - t0
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller as one error type
            raise RuntimeError(f"profiler capture failed: {type(e).__name__}: {e}") from e
        return {"dir": dirpath, "file": path, "seconds": round(elapsed, 3)}
    finally:
        _capture_lock.release()
