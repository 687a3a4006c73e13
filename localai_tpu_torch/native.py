"""Build and load the port's host-side C++ libraries (the byte-level BPE
merge engine, `csrc/bpe.cpp`; localai_tpu/native/__init__.py).

A source is compiled by `g++` into a shared library with a plain C
interface and loaded with `ctypes`, at the first call that needs it. The
library lands in `_build/` (listed in .gitignore) under a name carrying a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is built once per checkout. A missing compiler or a failed
build raises: there is no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from localai_tpu_torch.kernels import BUILD_DIR, CSRC

GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# library name -> (source file, {C function: (argtypes, restype)})
LIBRARIES = {
    "bpe": ("bpe.cpp", {
        "bpe_new": ([ctypes.c_char_p, _L, ctypes.c_char_p, _L], _P),
        "bpe_encode_piece": ([_P, ctypes.c_char_p, _I, ctypes.POINTER(ctypes.c_int32), _I], _I),
        "bpe_free": ([_P], None),
    }),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def gxx_path() -> str:
    """The host C++ compiler on PATH; raises when there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native BPE encoder is built with it")
    return path


def library_path(name: str) -> str:
    src_file, _ = LIBRARIES[name]
    with open(CSRC / src_file, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return str(BUILD_DIR / f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile `name`'s source unless its library exists; returns the
    library's path. Raises with the compiler's output when the build fails."""
    target = library_path(name)
    if os.path.exists(target):
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx_path(), *GXX_FLAGS, str(CSRC / LIBRARIES[name][0]), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {name} (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built on first use, with argtypes and restype
    declared for every C function it exports."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return lib
