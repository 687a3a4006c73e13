"""Where chip_smoke.py's wall time goes.

    python -m localai_tpu_torch.smoke_profile [--script chip_smoke.py]
        [--out smoke_profile.json] [--interval 0.2]

Runs the smoke script in this process (its output and exit code are the
script's) while a sampling thread reads every `--interval` seconds the
stack of the main thread and of every engine loop thread (a thread whose
stack holds Engine._loop_guard). Each sample stands for the wall time
since the one before, and is charged to the phase the main thread is in
(the outermost `phase_*` function of the script on its stack) and to the
innermost of MARKERS on the sampled stack, so a decode
block's graph capture shows as `captured_counts` (recording the capture
and instantiating the graph) or `_capture_block` (its eager run before
the capture), an eager block as `_run_block`, a chunk as
`_dispatch_chunk`. `--out` gets one JSON object: {"interval": s,
"seconds": {phase: {"main" | "loop": {marker: seconds}}}}, and the
innermost frame of each sample as {"leaves": {"main" | "loop": {"file:
function": seconds}}}. A sample of a thread waiting (a `join`, a
request's event stream, an HTTP read) is charged to what it waits in: the
loop threads' samples say what the engines did meanwhile."""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

# Innermost first: a sample goes to the first of these on its stack.
MARKERS = (
    "captured_counts", "_capture_block", "_warm_admit", "_warm_block", "_warm_rounds", "warmup",
    "_install_first", "_dispatch_admit_pinned", "_dispatch_admit", "_dispatch_chunk", "_admit",
    "_dispatch_spec_block", "_run_spec_round", "_run_block", "_finish", "_stage_block",
    "prefill", "prefill_chunk_paged", "decode_step_windowed", "decode_step",
    "_teardown", "drop_device_state", "collect",
    "__init__", "load_hf_checkpoint", "init_params", "init_params_quantized",
    "params_from_numpy", "load_gguf_checkpoint", "write_gguf_model", "random_hf_checkpoint",
    "write_safetensors", "_load", "_load_vision", "encode", "vision_forward", "encode_image",
    "preprocess", "cuda_time_ms", "cuda_time_cold_ms", "_loop", "__iter__", "result", "_http",
    "_http_call", "_http_batch", "join", "wait", "sleep",
)
_RANK = {m: i for i, m in enumerate(MARKERS)}


class Sampler:
    """The sampling thread and its tallies (seconds)."""

    def __init__(self, script: str, interval: float):
        self.script = os.path.basename(script)
        self.interval = interval
        self.seconds = collections.defaultdict(lambda: collections.defaultdict(
            collections.Counter))
        self.leaves = collections.defaultdict(collections.Counter)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="smoke-profile")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _phase(self, frame) -> str:
        phase = "?"
        while frame is not None:
            code = frame.f_code
            if code.co_filename.endswith(self.script) and code.co_name.startswith("phase_"):
                phase = code.co_name  # the outermost one wins
            frame = frame.f_back
        return phase

    def _run(self) -> None:
        main = threading.main_thread().ident
        me = threading.get_ident()
        last = time.monotonic()
        while not self._stop.wait(self.interval):
            # A sample stands for the wall time since the last one (more
            # than the interval when this thread waited for the GIL).
            now = time.monotonic()
            dt, last = now - last, now
            frames = sys._current_frames()
            phase = self._phase(frames.get(main))
            for tid, frame in frames.items():
                if tid == me:
                    continue
                names, f = [], frame
                while f is not None:
                    names.append((os.path.basename(f.f_code.co_filename), f.f_code.co_name))
                    f = f.f_back
                if tid == main:
                    kind = "main"
                elif any(n == "_loop_guard" for _, n in names):
                    kind = "loop"
                else:
                    continue
                ranked = [n for _, n in names if n in _RANK]
                marker = min(ranked, key=_RANK.__getitem__) if ranked else "other"
                self.seconds[phase][kind][marker] += dt
                self.leaves[kind]["%s:%s" % names[0]] += dt

    def report(self) -> dict:
        return {"interval": self.interval,
                "seconds": {p: {k: dict(c.most_common()) for k, c in kinds.items()}
                            for p, kinds in self.seconds.items()},
                "leaves": {k: dict(c.most_common(60)) for k, c in self.leaves.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--script", default="chip_smoke.py")
    ap.add_argument("--out", default="smoke_profile.json")
    ap.add_argument("--interval", type=float, default=0.2)
    args = ap.parse_args(argv)
    script = os.path.abspath(args.script)
    sys.path.insert(0, os.path.dirname(script))
    sampler = Sampler(script, args.interval)
    sampler.start()
    rc = 0
    t0 = time.monotonic()
    try:
        sys.argv = [script]
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        sampler.stop()
        report = sampler.report()
        report["wall_s"] = time.monotonic() - t0
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
