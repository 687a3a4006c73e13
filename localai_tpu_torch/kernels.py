"""Build and load the port's hand-written CUDA kernels.

Each kernel source in `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`)
into a shared library with a plain C interface and loaded with `ctypes`;
nothing includes PyTorch's headers, so a build takes seconds. Libraries
land in `_build/` (listed in .gitignore) under a name that carries a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is built once per checkout; a process that finds a library built (a
subprocess backend's child, after its parent) loads it without nvcc. Nothing here runs at import: the first call of
a kernel's wrapper builds and loads its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> (source file, {C function: (argtypes, restype)})
LIBRARIES = {
    "flash_prefill": (
        "flash_prefill.cu",
        {"flash_prefill": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I)},
    ),
    "paged_attention": (
        "paged_attention.cu",
        {"paged_attention": ([_P] * 13 + [_I] * 12 + [_F] + [_I] * 5 + [_P], _I)},
    ),
    "quant_matmul": (
        "quant_matmul.cu",
        {"quant_matmul": ([_P] * 7 + [_I] * 12 + [_P], _I),
         "quant_unembed": ([_P] * 4 + [_I] * 7 + [_P], _I)},
    ),
    "lora_matmul": (
        "lora_matmul.cu",
        {"lora_bgmv_group": ([_P] * 11 + [_I] * 18 + [_P], _I)},
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_sm_counts: dict[int, int] = {}
# Every workspace store `grow_workspace` has filled (ids of the dicts).
_stores: dict[int, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the default
    toolkit location. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src_file, _ = LIBRARIES[name]
    digest = hashlib.sha256(
        (CSRC / src_file).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one library; returns (target, tmp, process) or None
    when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish_build(name: str, started) -> str:
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{out}")
    # Both renames are atomic, so processes that build at once (a server
    # and its subprocess backend's child) each see whole files or none.
    os.replace(tmp, target)
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(out)
    os.replace(log_tmp, target.with_suffix(".log"))
    return out


def build(names=None) -> dict[str, str]:
    """Build the named libraries (all by default), one nvcc process per
    source, all started together. Returns each library's compiler output
    (`-Xptxas -v`: registers, shared memory, spills), or the saved output
    of an earlier build. Raises if any build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    started = {n: _start_build(n) for n in names}
    logs = {}
    for n, st in started.items():
        if st is None:
            log = library_path(n).with_suffix(".log")
            logs[n] = log.read_text() if log.exists() else ""
        else:
            logs[n] = _finish_build(n, st)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built on first use, with argtypes and restype
    declared for every C function it exports."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return lib


def grow_workspace(store: dict, device, n_floats: int, n_counters: int):
    """A kernel's split workspace on `device` from `store` (device index ->
    (f32 partials, int32 counters)), grown to at least this size. Counters
    start at 0 and every launch leaves them at 0; nothing is allocated when
    the stored pair is big enough."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    _stores[id(store)] = store
    ws, cnt = store.get(idx, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(max(n_counters, 1), dtype=torch.int32, device=device)
    store[idx] = (ws, cnt)
    return ws, cnt


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (the split plans fill them)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def live_workspaces() -> list:
    """Every workspace and counter tensor the stores hold now. A CUDA graph
    captures their addresses, so its owner keeps these alive: a later call
    that grows a store replaces the tensor, and the graph must not write
    into memory handed to someone else."""
    return [t for store in _stores.values() for pair in store.values() for t in pair]


def _counters() -> tuple:
    """(holder, attribute) of every host-side launch counter on the decode
    path: the kernel wrappers' launches (B2's latent form and B3's expert
    form count apart, and B3's 2-D launches also by weight form) and
    the dequantize-then-matmul routes' calls."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import flash, lora_matmul, paged_flash, quant_matmul

    return ((flash.flash_prefill_attention, "launches"),
            (paged_flash.paged_partials_rows, "launches"),
            (paged_flash.paged_partials_rows, "latent_launches"),
            (quant_matmul.qmm, "launches"),
            (quant_matmul.qmm, "launches_q"),
            (quant_matmul.qmm, "launches_gq"),
            (quant_matmul.qmm, "launches_g4"),
            (quant_matmul.qmm_moe, "launches"),
            (quant_matmul.qunembed, "launches"),
            (lora_matmul.lora_bgmv_group, "launches"),
            (quant.matmul, "dequant_calls"),
            (quant.moe_matmul, "dequant_calls"),
            (quant.unembed_matmul, "dequant_calls"))


def _add_counts(deltas) -> None:
    for (holder, attr), d in zip(_counters(), deltas):
        setattr(holder, attr, getattr(holder, attr) + d)


def captured_counts(capture) -> tuple:
    """Run `capture()`, a CUDA graph capture: the wrappers it calls count
    launches that did not happen. Take each counter's increase back off and
    return the increases, which `replay_counted` adds on every replay."""
    before = tuple(getattr(h, a) for h, a in _counters())
    try:
        capture()
    finally:
        deltas = tuple(getattr(h, a) - b for (h, a), b in zip(_counters(), before))
        _add_counts(tuple(-d for d in deltas))
    return deltas


def replay_counted(graph, deltas) -> None:
    """Replay a captured graph and count the launches it replays, as the
    wrappers would have counted them."""
    graph.replay()
    _add_counts(deltas)
