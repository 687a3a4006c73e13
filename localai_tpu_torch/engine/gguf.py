"""GGUF checkpoint ingestion: parse, dequantize, repack into the port's
grouped weight forms (localai_tpu/engine/gguf.py).

GGUF is the file format of llama.cpp, the reference's main LLM engine
(`core/config/gguf.go:15-60` reads its metadata; most gallery entries ship
as GGUF). Quantized tensors keep their bits: q4_0 / q4_K blocks map onto
B3's affine 4-bit form {"g4", "gs", "gz"} without loss (the same 32-wide
groups, nibbles re-paired so the low nibble is the first 16 rows of a
group, per-group zero points gz = 8·d for q4_0 and dmin·m for q4_K), q8_0
onto grouped int8 {"gq", "gs"}, and the types with no lossless grouped
form (q4_1, q5_0, q5_1, q5_K, q6_K) regrid to grouped int8. Embeddings and
norms dequantize to bf16; an untied `output.weight` becomes the
per-channel int8 head that B4 reads.

Everything here is numpy on the host (vectorized block decoders, zero-copy
`np.memmap` reads); the format follows the public GGUF spec (ggml.h /
gguf.md). `load_gguf_checkpoint` returns the JAX package's tree layout as
numpy leaves, which `engine/weights.params_from_numpy` puts on the device.
A leaf the JAX package keeps in bf16 travels as float32 numpy holding
values already rounded to bf16 (round to nearest even, by a torch cast), so
the device cast to bf16 is exact and an f32 arch sees the same values.

A DeepSeek (deepseek2) file builds the two-stack MLA / MoE tree
(`_load_gguf_deepseek`, the JAX package's loader): attention in bf16 with
the rope columns de-interleaved, kv_b split per head into w_kb / w_vb, the
fused expert stacks in grouped int8 per expert (B3's `gq` expert form)
where every in width is a multiple of 32, the head in per-channel int8.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.llama import check_supported
from localai_tpu_torch.models.quant import HOST_THREADS, quantize_tensor_np, threaded

log = logging.getLogger("localai_tpu_torch.gguf")

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types: name -> (type id, block size, bytes per block)
GGML_TYPES = {
    "F32": (0, 1, 4),
    "F16": (1, 1, 2),
    "Q4_0": (2, 32, 18),
    "Q4_1": (3, 32, 20),
    "Q5_0": (6, 32, 22),
    "Q5_1": (7, 32, 24),
    "Q8_0": (8, 32, 34),
    "Q2_K": (10, 256, 84),
    "Q3_K": (11, 256, 110),
    "Q4_K": (12, 256, 144),
    "Q5_K": (13, 256, 176),
    "Q6_K": (14, 256, 210),
    "BF16": (30, 1, 2),
}
_TYPE_BY_ID = {tid: (name, blk, bsz) for name, (tid, blk, bsz) in GGML_TYPES.items()}


@dataclass
class TensorInfo:
    name: str
    ne: tuple[int, ...]  # ggml dims, ne[0] fastest-varying (the "in" dim)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def type_name(self) -> str:
        return _TYPE_BY_ID[self.ggml_type][0]

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        _, blk, bsz = _TYPE_BY_ID[self.ggml_type]
        return self.n_elements // blk * bsz


class GGUFReadError(ValueError):
    pass


class GGUFFile:
    """Parsed GGUF container: metadata kv store + lazy tensor reads."""

    def __init__(self, path: str):
        self.path = path
        self.kv: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != GGUF_MAGIC:
                raise GGUFReadError(f"{path}: not a GGUF file (magic {magic:#x})")
            if version < 2 or version > 3:
                raise GGUFReadError(f"{path}: unsupported GGUF version {version}")
            self.version = version
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = self._read_str(f)
                vtype = struct.unpack("<I", f.read(4))[0]
                self.kv[key] = self._read_value(f, vtype)
            for _ in range(n_tensors):
                name = self._read_str(f)
                n_dims = struct.unpack("<I", f.read(4))[0]
                ne = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ttype, offset = struct.unpack("<IQ", f.read(12))
                if ttype not in _TYPE_BY_ID:
                    raise GGUFReadError(
                        f"{path}: tensor {name!r} has unsupported ggml type {ttype}"
                    )
                self.tensors[name] = TensorInfo(name, tuple(ne), ttype, offset)
            align = int(self.kv.get("general.alignment", 32))
            pos = f.tell()
            self.data_offset = (pos + align - 1) // align * align
        self._mm = np.memmap(path, mode="r")

    # ------------------------------------------------------------------ #
    # Header primitives
    # ------------------------------------------------------------------ #

    @staticmethod
    def _read_str(f) -> str:
        (n,) = struct.unpack("<Q", f.read(8))
        return f.read(n).decode("utf-8", errors="replace")

    def _read_value(self, f, vtype: int):
        if vtype in _SCALAR_FMT:
            fmt = _SCALAR_FMT[vtype]
            return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
        if vtype == _T_BOOL:
            return bool(f.read(1)[0])
        if vtype == _T_STR:
            return self._read_str(f)
        if vtype == _T_ARR:
            etype, count = struct.unpack("<IQ", f.read(12))
            if etype in _SCALAR_FMT and etype != _T_BOOL:
                fmt = _SCALAR_FMT[etype]
                sz = struct.calcsize(fmt)
                raw = f.read(sz * count)
                return list(np.frombuffer(raw, dtype=np.dtype(fmt[1:])).tolist())
            return [self._read_value(f, etype) for _ in range(count)]
        raise GGUFReadError(f"unknown metadata value type {vtype}")

    # ------------------------------------------------------------------ #
    # Tensor access
    # ------------------------------------------------------------------ #

    def _raw(self, ti: TensorInfo) -> np.ndarray:
        start = self.data_offset + ti.offset
        return np.asarray(self._mm[start:start + ti.nbytes])

    def tensor(self, name: str) -> np.ndarray:
        """Dequantized tensor in numpy layout (ne reversed: [..., out?, in])."""
        ti = self.tensors[name]
        shape = tuple(reversed(ti.ne))
        raw = self._raw(ti)
        tname = ti.type_name
        if tname == "F32":
            return raw.view(np.float32).reshape(shape)
        if tname == "F16":
            return raw.view(np.float16).reshape(shape)
        if tname == "BF16":  # the bf16 bits are the high half of an f32
            return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32).reshape(shape)
        if tname not in _DEQUANT:
            raise GGUFReadError(
                f"{self.path}: tensor {name!r} uses quant type {tname}, which "
                f"has no dequantizer yet (supported: {sorted(_DEQUANT)})"
            )
        return _dequant(tname, raw, ti.n_elements).reshape(shape)

    def grouped(self, name: str) -> Optional[dict[str, np.ndarray]]:
        """Native grouped repack for a 2D weight (lossless where possible):
        returns quant-dict with arrays shaped [G, ... , out] ready for
        models/quant.matmul once on the device, with no transpose — or None when
        the type has no lossless grouped form (caller dequantizes)."""
        ti = self.tensors[name]
        if len(ti.ne) != 2:
            return None
        n_in, n_out = ti.ne  # ne[0] = in (contiguous), ne[1] = out (rows)
        raw = self._raw(ti)
        tname = ti.type_name
        if tname == "Q4_0":
            rec = np.frombuffer(raw, dtype=np.dtype(
                [("d", "<f2"), ("qs", "u1", (16,))]
            )).reshape(n_out, n_in // 32)
            s = rec["d"].astype(np.float32)  # [out, G]
            qp = rec["qs"]  # [out, G, 16] — nibble layout == our g4 layout
            return {
                "g4": np.ascontiguousarray(qp.transpose(1, 2, 0)),
                "gs": np.ascontiguousarray(s.T)[:, None, :],
                "gz": np.ascontiguousarray((s * 8.0).T)[:, None, :],
            }
        if tname == "Q8_0":
            rec = np.frombuffer(raw, dtype=np.dtype(
                [("d", "<f2"), ("qs", "i1", (32,))]
            )).reshape(n_out, n_in // 32)
            return {
                "gq": np.ascontiguousarray(rec["qs"].transpose(1, 2, 0)),
                "gs": np.ascontiguousarray(
                    rec["d"].astype(np.float32).T
                )[:, None, :],
            }
        if tname == "Q4_K":
            d, dmin, sc, mn, qs = _q4k_fields(raw)
            n_blk = d.shape[0]
            # sub-block scale/min: s = d*sc, z = dmin*mn → 8 groups of 32
            s = (d[:, None] * sc).reshape(n_out, n_in // 32)
            z = (dmin[:, None] * mn).reshape(n_out, n_in // 32)
            # qs chunk j: low nibbles → sub-block 2j, high → 2j+1; our g4
            # wants [G, 16, out] bytes whose low/high nibbles are the first/
            # second half of each 32-group → re-pair nibbles.
            lo = qs & 0xF  # [n_blk, 4, 32] values of even sub-blocks
            hi = qs >> 4  # odd sub-blocks
            vals = np.empty((n_blk, 8, 32), np.uint8)
            vals[:, 0::2] = lo
            vals[:, 1::2] = hi
            packed = vals[:, :, :16] | (vals[:, :, 16:] << 4)  # [n_blk, 8, 16]
            packed = packed.reshape(n_out, n_in // 32, 16)
            return {
                "g4": np.ascontiguousarray(packed.transpose(1, 2, 0)),
                "gs": np.ascontiguousarray(s.T)[:, None, :],
                "gz": np.ascontiguousarray(z.T)[:, None, :],
            }
        if tname in ("Q5_K", "Q6_K", "Q5_0", "Q5_1", "Q4_1"):
            # no lossless 4-bit form — regrid to grouped int8 (finer grid
            # than the source, quality preserved)
            w = _dequant(tname, raw, ti.n_elements).reshape(n_out, n_in)
            return grouped_int8_from_dense(w)
        return None


def np_dequant_grouped(d: dict[str, np.ndarray]) -> np.ndarray:
    """Host-side grouped-dict → dense float32 [..., in, out]."""
    if "g4" in d:
        qp = d["g4"]
        nib = np.concatenate([qp & 0xF, qp >> 4], axis=-2).astype(np.float32)
        vals = nib * d["gs"] - d["gz"]
    else:
        vals = d["gq"].astype(np.float32) * d["gs"]
    *lead, g, gs, n_out = vals.shape
    return vals.reshape(*lead, g * gs, n_out)


def grouped_int8_from_dense(w_out_in: np.ndarray, group: int = 32) -> dict:
    """[out, in] float → {"gq" [G, gs, out], "gs" [G, 1, out]} (host-side)."""
    n_out, n_in = w_out_in.shape
    g = n_in // group
    wf = w_out_in.astype(np.float32).reshape(n_out, g, group)
    s = np.maximum(np.abs(wf).max(axis=-1, keepdims=True) / 127.0, 1e-9)
    q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    return {
        "gq": np.ascontiguousarray(q.transpose(1, 2, 0)),
        "gs": np.ascontiguousarray(s[:, :, 0].T)[:, None, :],
    }


# ------------------------------------------------------------------ #
# Block dequantizers (numpy, vectorized). Layouts follow the public
# ggml spec; each returns flat float32 [n_elements].
# ------------------------------------------------------------------ #


def _deq_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("qs", "u1", (16,))]))
    d = rec["d"].astype(np.float32)[:, None]
    lo = (rec["qs"] & 0xF).astype(np.int8) - 8
    hi = (rec["qs"] >> 4).astype(np.int8) - 8
    return (d * np.concatenate([lo, hi], axis=1)).reshape(-1)[:n]


def _deq_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))]
    ))
    d = rec["d"].astype(np.float32)[:, None]
    m = rec["m"].astype(np.float32)[:, None]
    lo = (rec["qs"] & 0xF).astype(np.float32)
    hi = (rec["qs"] >> 4).astype(np.float32)
    return (d * np.concatenate([lo, hi], axis=1) + m).reshape(-1)[:n]


def _deq_q5_0(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]
    ))
    d = rec["d"].astype(np.float32)[:, None]
    qh = rec["qh"][:, None]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1  # [blk, 32]
    lo = (rec["qs"] & 0xF).astype(np.int16)
    hi = (rec["qs"] >> 4).astype(np.int16)
    q = np.concatenate([lo, hi], axis=1) | (bits.astype(np.int16) << 4)
    return (d * (q - 16)).reshape(-1)[:n]


def _deq_q5_1(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]
    ))
    d = rec["d"].astype(np.float32)[:, None]
    m = rec["m"].astype(np.float32)[:, None]
    qh = rec["qh"][:, None]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    lo = (rec["qs"] & 0xF).astype(np.uint16)
    hi = (rec["qs"] >> 4).astype(np.uint16)
    q = np.concatenate([lo, hi], axis=1) | (bits.astype(np.uint16) << 4)
    return (d * q + m).reshape(-1)[:n]


def _deq_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("qs", "i1", (32,))]))
    return (rec["d"].astype(np.float32)[:, None] * rec["qs"]).reshape(-1)[:n]


def _q4k_fields(raw: np.ndarray):
    """Shared q4_K decode → (d, dmin, sc[blk,8], mn[blk,8], qs[blk,4,32])."""
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)), ("qs", "u1", (128,))]
    ))
    sc, mn = _unpack_k_scales(rec["scales"])
    qs = rec["qs"].reshape(-1, 4, 32)
    return (rec["d"].astype(np.float32), rec["dmin"].astype(np.float32), sc, mn, qs)


def _unpack_k_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """6-bit packed K-quant scales/mins: [blk, 12] bytes → ([blk, 8], [blk, 8])."""
    q = scales.astype(np.uint8)
    sc = np.empty((q.shape[0], 8), np.float32)
    mn = np.empty((q.shape[0], 8), np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = (q[:, j] & 63).astype(np.float32)
            mn[:, j] = (q[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)).astype(np.float32)
            mn[:, j] = ((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _deq_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    d, dmin, sc, mn, qs = _q4k_fields(raw)
    n_blk = d.shape[0]
    lo = (qs & 0xF).astype(np.float32)  # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32)  # sub-blocks 1,3,5,7
    vals = np.empty((n_blk, 8, 32), np.float32)
    vals[:, 0::2] = lo
    vals[:, 1::2] = hi
    y = d[:, None, None] * sc[:, :, None] * vals - (dmin[:, None, None] * mn[:, :, None])
    return y.reshape(-1)[:n]


def _deq_q5_k(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype([
        ("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
        ("qh", "u1", (32,)), ("qs", "u1", (128,)),
    ]))
    sc, mn = _unpack_k_scales(rec["scales"])
    d = rec["d"].astype(np.float32)
    dmin = rec["dmin"].astype(np.float32)
    qs = rec["qs"].reshape(-1, 4, 32)
    qh = rec["qh"]  # [blk, 32], bit 2j → even sub-block, bit 2j+1 → odd
    n_blk = d.shape[0]
    vals = np.empty((n_blk, 8, 32), np.float32)
    for j in range(4):
        u1 = np.uint8(1 << (2 * j))
        u2 = np.uint8(1 << (2 * j + 1))
        vals[:, 2 * j] = (qs[:, j] & 0xF) + np.where(qh & u1, 16, 0)
        vals[:, 2 * j + 1] = (qs[:, j] >> 4) + np.where(qh & u2, 16, 0)
    y = d[:, None, None] * sc[:, :, None] * vals - (dmin[:, None, None] * mn[:, :, None])
    return y.reshape(-1)[:n]


def _deq_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    rec = np.frombuffer(raw, dtype=np.dtype([
        ("ql", "u1", (128,)), ("qh", "u1", (64,)),
        ("scales", "i1", (16,)), ("d", "<f2"),
    ]))
    d = rec["d"].astype(np.float32)
    n_blk = d.shape[0]
    y = np.empty((n_blk, 256), np.float32)
    scales = rec["scales"].astype(np.float32)  # per 16 values
    for half in range(2):
        ql = rec["ql"][:, 64 * half:64 * half + 64]
        qh = rec["qh"][:, 32 * half:32 * half + 32]
        base = 128 * half
        q1 = ((ql[:, :32] & 0xF) | ((qh & 3) << 4)).astype(np.int16) - 32
        q2 = ((ql[:, 32:] & 0xF) | (((qh >> 2) & 3) << 4)).astype(np.int16) - 32
        q3 = ((ql[:, :32] >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int16) - 32
        q4 = ((ql[:, 32:] >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int16) - 32
        for part, q in enumerate((q1, q2, q3, q4)):
            sl = scales[:, 8 * half + 2 * part:8 * half + 2 * part + 2]
            s32 = np.repeat(sl, 16, axis=1)  # scale per 16 values
            y[:, base + 32 * part: base + 32 * part + 32] = d[:, None] * s32 * q
    return y.reshape(-1)[:n]


def _dequant(tname: str, raw: np.ndarray, n: int) -> np.ndarray:
    """_DEQUANT[tname] of n weights; a large tensor's blocks split over host
    threads (every block decodes alone, so the result is the same)."""
    _tid, blk, bsz = GGML_TYPES[tname]
    nb = n // blk
    if n < 1 << 22:
        return _DEQUANT[tname](raw, n)
    cuts = np.linspace(0, nb, HOST_THREADS + 1).astype(int)
    spans = [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    return np.concatenate(threaded(
        lambda ab: _DEQUANT[tname](raw[ab[0] * bsz: ab[1] * bsz], (ab[1] - ab[0]) * blk), spans))


_DEQUANT = {
    "Q4_0": _deq_q4_0,
    "Q4_1": _deq_q4_1,
    "Q5_0": _deq_q5_0,
    "Q5_1": _deq_q5_1,
    "Q8_0": _deq_q8_0,
    "Q4_K": _deq_q4_k,
    "Q5_K": _deq_q5_k,
    "Q6_K": _deq_q6_k,
}


# ------------------------------------------------------------------ #
# Arch detection (reference behavior: core/config/gguf.go:15-60 reads
# the same keys to guess context size / memory needs)
# ------------------------------------------------------------------ #


def arch_from_gguf(gf: GGUFFile) -> ArchConfig:
    kv = gf.kv
    a = kv.get("general.architecture", "llama")
    # phi3 GGUFs store fused attn_qkv/ffn_up tensors this loader's tensor
    # map doesn't split yet, and gemma2/gemma3 add pre/post-ffw norms +
    # softcap/qk-norm + sliding windows — mapping those as plain llama
    # produces fluent-looking garbage, so they hard-error (matching
    # arch_from_hf_config's strictness) instead of warning.
    _WRONG_SEMANTICS = {
        "phi3": "fused qkv/ffn_up tensors",
        "gemma2": "post-norms + attn/final softcap + sliding windows",
        "gemma3": "qk-norms + local/global rope + sliding windows",
    }
    if a in _WRONG_SEMANTICS:
        raise ValueError(
            f"GGUF arch {a!r} needs {_WRONG_SEMANTICS[a]} which this loader "
            "does not implement — serving it with llama semantics would "
            "produce wrong output. Use the HF safetensors checkpoint instead."
        )
    if a not in ("llama", "qwen2", "qwen3", "mistral", "gemma", "granite",
                 "deepseek2"):
        log.warning("GGUF arch %r not in the known set; mapping as llama-family", a)
    gemma = a == "gemma"

    def k(suffix: str, default=None):
        return kv.get(f"{a}.{suffix}", default)

    if a == "deepseek2":
        return _arch_from_deepseek2_gguf(gf, k)

    n_heads = int(k("attention.head_count", 32))
    head_dim = int(k("attention.key_length", 0)) or None
    vocab = int(kv.get(f"{a}.vocab_size", 0)) or len(
        kv.get("tokenizer.ggml.tokens", []) or []
    )
    rope_scaling = None
    scaling_factor = float(k("rope.scaling.factor", 0) or 0)
    orig_ctx = int(k("rope.scaling.original_context_length", 0) or 0)
    scaling_type = str(k("rope.scaling.type", ""))
    if scaling_type == "linear":
        rope_scaling = "linear"
        scaling_factor = scaling_factor or 1.0
    elif scaling_type == "yarn":
        # llama.cpp yarn GGUFs: factor + original context (beta_fast/slow
        # keys are llama.cpp runtime params, not stored — HF defaults apply).
        rope_scaling = "yarn"
        scaling_factor = scaling_factor or 1.0
    elif orig_ctx or "rope_freqs.weight" in gf.tensors:
        # llama-3.1-style scaling: llama.cpp records the original context
        # (and sometimes only a rope_freqs tensor); factor defaults to the
        # published llama-3.1 value when the key is absent.
        rope_scaling = "llama3"
        scaling_factor = scaling_factor or 8.0
    return ArchConfig(
        name=os.path.basename(gf.path),
        vocab_size=vocab,
        hidden_size=int(k("embedding_length", 4096)),
        intermediate_size=int(k("feed_forward_length", 11008)),
        num_layers=int(k("block_count", 32)),
        num_heads=n_heads,
        num_kv_heads=int(k("attention.head_count_kv", n_heads)),
        head_dim=head_dim,
        rope_theta=float(k("rope.freq_base", 10000.0)),
        rms_eps=float(k("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position=int(k("context_length", 4096)),
        rope_scaling=rope_scaling,
        rope_scaling_factor=scaling_factor or 1.0,
        rope_original_max_position=orig_ctx or 8192,
        tie_embeddings="output.weight" not in gf.tensors,
        attn_qkv_bias="blk.0.attn_q.bias" in gf.tensors,
        # Gemma GGUFs arrive with the (1+w) norm fold already applied by
        # llama.cpp's converter, so only the runtime quirks are flagged.
        activation=("gelu_tanh" if gemma else "silu"),
        embed_scale=gemma,
        num_experts=int(k("expert_count", 0) or 0),
        num_experts_per_token=int(k("expert_used_count", 2) or 2),
    )


def _arch_from_deepseek2_gguf(gf: GGUFFile, k):
    """DeepSeek-V2/V3 GGUF metadata → ArchConfig (llama.cpp deepseek2 keys;
    the reference serves these GGUFs via the llama.cpp backend). llama.cpp
    treats deepseek2 as a NORM-rope (pair-interleaved) arch with unpermuted
    HF-layout tensors, so rope_interleave=True routes the same column
    de-interleave the HF loader applies. The port reads it; loading its
    tree waits for ROADMAP Queue A item 10 (`load_gguf_params` says so)."""
    n_heads = int(k("attention.head_count", 16))
    rope_dim = int(k("rope.dimension_count", 64))
    key_len = int(k("attention.key_length", 192))
    q_lora = int(k("attention.q_lora_rank", 0) or 0) or None
    n_experts = int(k("expert_count", 0) or 0)
    kd = int(k("leading_dense_block_count", 0) or 0) if n_experts else 0
    gating = int(k("expert_gating_func", 1) or 1)  # 1=softmax, 2=sigmoid
    # the correction bias lives on MoE blocks — the first is blk.{kd}
    has_bias = f"blk.{kd}.exp_probs_b.bias" in gf.tensors
    sigmoid = gating == 2 or has_bias
    vocab = int(gf.kv.get("deepseek2.vocab_size", 0)) or len(
        gf.kv.get("tokenizer.ggml.tokens", []) or []
    )
    scaling_factor = float(k("rope.scaling.factor", 0) or 0)
    yarn = str(k("rope.scaling.type", "")) == "yarn"
    orig_ctx = int(k("rope.scaling.original_context_length", 0) or 0)
    # llama.cpp records yarn log-multiplier = 0.1·mscale_all_dim; the net
    # deepseek amplitude (see weights.arch_from_hf_config) is
    # 0.1·mscale·ln(factor)+1 — GGUFs carry mscale==mscale_all_dim models
    # (V2/V3/R1 all do), so the recorded multiplier reproduces it.
    logmul = k("rope.scaling.yarn_log_multiplier", None)
    attn_factor = None
    if yarn and logmul is not None and scaling_factor > 1:
        import math

        attn_factor = float(logmul) * math.log(scaling_factor) + 1.0
    return ArchConfig(
        name=os.path.basename(gf.path),
        vocab_size=vocab,
        hidden_size=int(k("embedding_length", 2048)),
        intermediate_size=int(k("feed_forward_length", 10944)),
        num_layers=int(k("block_count", 27)),
        num_heads=n_heads,
        num_kv_heads=n_heads,
        head_dim=rope_dim,
        rope_theta=float(k("rope.freq_base", 10000.0)),
        rope_scaling="yarn" if yarn else None,
        rope_scaling_factor=scaling_factor or 1.0,
        rope_original_max_position=orig_ctx or 4096,
        rope_attn_factor=attn_factor,
        rms_eps=float(k("attention.layer_norm_rms_epsilon", 1e-6)),
        max_position=int(k("context_length", 4096)),
        tie_embeddings="output.weight" not in gf.tensors,
        num_experts=n_experts,
        num_experts_per_token=int(k("expert_used_count", 6) or 6),
        moe_family="deepseek",
        first_k_dense=kd,
        n_shared_experts=int(k("expert_shared_count", 0) or 0),
        moe_intermediate_size=int(k("expert_feed_forward_length", 0) or 0) or None,
        routed_scaling_factor=float(k("expert_weights_scale", 1.0) or 1.0),
        scoring_func="sigmoid" if sigmoid else "softmax",
        router_bias=has_bias,
        norm_topk_prob=bool(k("expert_weights_norm", False)),
        n_group=int(k("expert_group_count", 1) or 1),
        topk_group=int(k("expert_group_used_count", 1) or 1),
        kv_lora_rank=int(k("attention.kv_lora_rank", 512)),
        q_lora_rank=q_lora,
        qk_nope_head_dim=key_len - rope_dim,
        qk_rope_head_dim=rope_dim,
        v_head_dim=int(k("attention.value_length", 128)),
        rope_interleave=True,
    )


# ------------------------------------------------------------------ #
# Tokenizer: synthesize an HF `tokenizer.json` from GGUF BPE metadata so the
# existing HFTokenizer/FastBPE path (incl. the native C++ merge engine)
# serves GGUF models with byte-exact tokenization.
# ------------------------------------------------------------------ #

# split regexes by tokenizer.ggml.pre (public llama.cpp pre-tokenizer table)
_PRE_REGEX = {
    "llama-bpe": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "qwen2": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "gpt-2": r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
}

_TOKEN_TYPE_CONTROL = 3


def tokenizer_json_from_gguf(gf: GGUFFile) -> Optional[dict]:
    """HF-tokenizers-compatible dict for GGUF gpt2-style BPE vocabularies;
    None when the model uses a non-BPE tokenizer (e.g. sentencepiece)."""
    kv = gf.kv
    model = kv.get("tokenizer.ggml.model", "")
    if model != "gpt2":
        return None
    tokens: list[str] = kv.get("tokenizer.ggml.tokens") or []
    merges: list[str] = kv.get("tokenizer.ggml.merges") or []
    ttypes: list[int] = kv.get("tokenizer.ggml.token_type") or []
    pre = kv.get("tokenizer.ggml.pre", "gpt-2")
    pattern = _PRE_REGEX.get(pre)
    if pattern is None:
        log.warning("GGUF pre-tokenizer %r unknown; using llama-bpe split", pre)
        pattern = _PRE_REGEX["llama-bpe"]
    vocab = {t: i for i, t in enumerate(tokens)}
    added = [
        {
            "id": i, "content": tokens[i], "special": True,
            "single_word": False, "lstrip": False, "rstrip": False,
            "normalized": False,
        }
        for i, tt in enumerate(ttypes) if tt == _TOKEN_TYPE_CONTROL
    ]
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {
            "type": "Sequence",
            "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": pattern},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": True, "use_regex": False},
            ],
        },
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": True, "use_regex": False},
        "model": {
            "type": "BPE",
            "dropout": None,
            "unk_token": None,
            "continuing_subword_prefix": None,
            "end_of_word_suffix": None,
            "fuse_unk": False,
            "byte_fallback": False,
            "vocab": vocab,
            "merges": merges,
        },
    }


def write_hf_tokenizer(gf: GGUFFile, out_dir: str) -> Optional[str]:
    """Materialize tokenizer.json (+config with bos/eos and the GGUF chat
    template) next to the converted model; returns the dir or None."""
    tj = tokenizer_json_from_gguf(gf)
    if tj is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump(tj, f)
    kv = gf.kv
    tokens = kv.get("tokenizer.ggml.tokens") or []

    def tok_at(key: str) -> Optional[str]:
        i = kv.get(f"tokenizer.ggml.{key}")
        return tokens[int(i)] if i is not None and int(i) < len(tokens) else None

    cfg: dict[str, Any] = {"tokenizer_class": "PreTrainedTokenizerFast"}
    for name, key in (("bos_token", "bos_token_id"), ("eos_token", "eos_token_id")):
        t = tok_at(key)
        if t is not None:
            cfg[name] = t
    tmpl = kv.get("tokenizer.chat_template")
    if tmpl:
        cfg["chat_template"] = tmpl
    cfg["add_bos_token"] = bool(kv.get("tokenizer.ggml.add_bos_token", False))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)
    return out_dir


# ------------------------------------------------------------------ #
# Parameter tree assembly
# ------------------------------------------------------------------ #

# GGUF tensor name templates → (our key, transpose to [in, out]?)
_LAYER_MAP = {
    "attn_norm": ("attn_norm", False),
    "attn_q": ("wq", True),
    "attn_k": ("wk", True),
    "attn_v": ("wv", True),
    "attn_output": ("wo", True),
    "ffn_norm": ("mlp_norm", False),
    "ffn_gate": ("w_gate", True),
    "ffn_up": ("w_up", True),
    "ffn_down": ("w_down", True),
}


def _unpermute_rows(w_out_in: np.ndarray, n_head: int) -> np.ndarray:
    """Undo llama.cpp's q/k row permutation (convert_hf_to_gguf `permute`,
    which is reshape(H, 2, hd/2).swapaxes(1,2)): GGUF stores interleaved-rope
    row order; our rope uses the HF half-split layout. This is the INVERSE
    transform — reshape(H, hd/2, 2).swapaxes(1,2) — on the out (row) axis."""
    n_out, n_in = w_out_in.shape
    hd = n_out // n_head
    return (
        w_out_in.reshape(n_head, hd // 2, 2, n_in)
        .swapaxes(1, 2)
        .reshape(n_out, n_in)
    )


def _permutation_indices(n_out: int, n_head: int) -> np.ndarray:
    """Row indices equivalent to `_unpermute_rows` (for permuting packed
    grouped forms along their out axis)."""
    idx = np.arange(n_out)
    hd = n_out // n_head
    return (
        idx.reshape(n_head, hd // 2, 2)
        .swapaxes(1, 2)
        .reshape(-1)
    )


def bf16_round(arr) -> np.ndarray:
    """float32 numpy of `arr` rounded to bf16 (round to nearest even, as
    ml_dtypes' cast does): the values of the JAX package's bf16 leaves."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if not a.flags.writeable:  # a memory-mapped F32 tensor: torch wants its own
        a = a.copy()
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def load_gguf_params(gf: GGUFFile, arch: ArchConfig) -> dict:
    """Assemble the stacked-layer param tree from a GGUF file.

    2D matmul weights keep their quantized bits via grouped repack (lossless
    for q4_0/q4_K/q8_0); embeddings/norms dequantize to bf16 values (float32
    numpy, see the module docstring); lm_head goes to per-channel int8 (the
    unembed path's form). All host-side numpy; `params_from_numpy` puts it
    on the device. An arch the port does not serve yet raises first; a
    DeepSeek file goes to `_load_gguf_deepseek`.
    """
    check_supported(arch)
    if arch.is_mla:
        return _load_gguf_deepseek(gf, arch)
    L = arch.num_layers
    layers: dict[str, Any] = {}
    # llama.cpp's convert script permutes q/k rows ONLY for the llama family
    # (rope type NORM); qwen2/gemma-class exports (rope type NEOX) keep the
    # HF row order.
    permute_qk = gf.kv.get("general.architecture", "llama") in ("llama", "mistral")

    def stack(key: str, parts: list) -> None:
        if any(p is None for p in parts):
            return
        if any(isinstance(p, dict) for p in parts):
            # Real GGUFs mix types per layer (Q4_K_M files quantize some
            # attn_v/ffn_down layers as Q6_K): a stacked tree needs ONE
            # representation per key, so heterogeneous keys regrid to
            # grouped int8 (finer grid than any 4/5/6-bit source).
            forms = {
                frozenset(p.keys()) if isinstance(p, dict) else None
                for p in parts
            }
            if len(forms) > 1:
                parts = [
                    grouped_int8_from_dense(
                        np_dequant_grouped(p).T if isinstance(p, dict)
                        else np.asarray(p, np.float32).T
                    )
                    for p in parts
                ]
            layers[key] = {
                k: np.stack([p[k] for p in parts]) for k in parts[0]
            }
        else:
            layers[key] = np.stack(parts)

    per_key: dict[str, list] = {}
    for i in range(L):
        for gname, (ours, is_mm) in _LAYER_MAP.items():
            tname = f"blk.{i}.{gname}.weight"
            if tname not in gf.tensors:
                per_key.setdefault(ours, []).append(None)
                continue
            if is_mm:
                w = _load_matmul_weight(gf, tname, arch, ours, permute_qk)
            else:
                w = bf16_round(gf.tensor(tname))
            per_key.setdefault(ours, []).append(w)
        for bname, ours in (("attn_q", "bq"), ("attn_k", "bk"), ("attn_v", "bv")):
            tname = f"blk.{i}.{bname}.bias"
            if tname in gf.tensors:
                b = gf.tensor(tname).astype(np.float32)
                if permute_qk and bname in ("attn_q", "attn_k"):
                    heads = arch.num_heads if bname == "attn_q" else arch.num_kv_heads
                    b = b[_permutation_indices(b.shape[0], heads)]
                per_key.setdefault(ours, []).append(bf16_round(b))

    for key, parts in per_key.items():
        if len(parts) == L:
            stack(key, parts)

    if arch.is_moe:
        # Fused expert tensors (blk.i.ffn_{gate,up,down}_exps.weight,
        # [E, out, in] in numpy layout) → grouped int8 per expert; router
        # stays bf16 (it feeds top_k, tiny matmul).
        routers = []
        moe_parts: dict[str, list] = {"w_gate": [], "w_up": [], "w_down": []}
        names = {"w_gate": "ffn_gate_exps", "w_up": "ffn_up_exps",
                 "w_down": "ffn_down_exps"}
        for i in range(L):
            rname = f"blk.{i}.ffn_gate_inp.weight"
            if rname not in gf.tensors:
                raise GGUFReadError(
                    f"MoE GGUF missing {rname!r} (per-expert split files are "
                    "not supported; re-export with fused _exps tensors)"
                )
            routers.append(bf16_round(gf.tensor(rname).astype(np.float32).T))
            for ours, nm in names.items():
                t3 = gf.tensor(f"blk.{i}.{nm}.weight").astype(np.float32)
                per_e = [grouped_int8_from_dense(t3[e]) for e in range(t3.shape[0])]
                moe_parts[ours].append(
                    {k: np.stack([p[k] for p in per_e]) for k in per_e[0]}
                )
        layers["router"] = np.stack(routers)
        for ours, parts in moe_parts.items():
            layers[ours] = {k: np.stack([p[k] for p in parts]) for k in parts[0]}

    params: dict[str, Any] = {
        "embed": bf16_round(gf.tensor("token_embd.weight")),
        "layers": layers,
        "final_norm": bf16_round(gf.tensor("output_norm.weight")),
    }
    if "output.weight" in gf.tensors:
        w = gf.tensor("output.weight").astype(np.float32)  # [V, D]
        params["lm_head"] = quantize_tensor_np(w, axis=-1)
    return params


def _load_gguf_deepseek(gf: GGUFFile, arch: ArchConfig) -> dict:
    """DeepSeek-V2/V3 GGUF → the two-stack MLA / MoE tree (the JAX
    package's _load_gguf_deepseek, leaf for leaf).

    llama.cpp's deepseek2 names (fused-expert layout): attn_q or attn_q_a /
    attn_q_a_norm / attn_q_b, attn_kv_a_mqa, attn_kv_a_norm, attn_kv_b,
    attn_output; ffn_gate_inp, exp_probs_b and ffn_{gate,up,down}_exps with
    ffn_{gate,up,down}_shexp on the MoE blocks; plain ffn_{gate,up,down} on
    the leading dense blocks. The rope columns de-interleave as in
    engine/weights._load_deepseek. Attention tensors go to bf16 values, the
    router to bf16 and its bias to f32; the expert stacks to grouped int8
    per expert when the hidden and expert widths are multiples of 32, else
    bf16 (all three projections share one form: the MoE route branches on
    w_gate's); kv_b splits per head into w_kb / w_vb; output.weight goes to
    per-channel int8."""
    from localai_tpu_torch.engine.weights import _deinterleave

    L = arch.num_layers
    kd = arch.first_k_dense if arch.is_moe else 0
    H = arch.num_heads
    n, rot, vd = arch.qk_nope_head_dim, arch.qk_rope_head_dim, arch.v_head_dim
    r = arch.kv_lora_rank

    def mm(i: int, gname: str, rope_block: int = 0) -> np.ndarray:
        """[in, out] bf16 values, rope columns de-interleaved."""
        w = np.ascontiguousarray(gf.tensor(f"blk.{i}.{gname}.weight").astype(np.float32).T)
        if rope_block:
            w = _deinterleave(torch.from_numpy(w), rot, rope_block).numpy()
        return bf16_round(w)

    def vec(i: int, gname: str) -> np.ndarray:
        return bf16_round(gf.tensor(f"blk.{i}.{gname}.weight"))

    def stacked(fn, gname: str, lo: int, hi: int, **kw) -> np.ndarray:
        return np.stack([fn(i, gname, **kw) for i in range(lo, hi)])

    def attn_stack(lo: int, hi: int) -> dict:
        out: dict[str, Any] = {
            "attn_norm": stacked(vec, "attn_norm", lo, hi),
            "mlp_norm": stacked(vec, "ffn_norm", lo, hi),
            "kv_norm": stacked(vec, "attn_kv_a_norm", lo, hi),
            "wo": stacked(mm, "attn_output", lo, hi),
            "wkv_a": stacked(mm, "attn_kv_a_mqa", lo, hi, rope_block=r + rot),
        }
        if arch.q_lora_rank:
            out["wq_a"] = stacked(mm, "attn_q_a", lo, hi)
            out["q_norm_a"] = stacked(vec, "attn_q_a_norm", lo, hi)
            out["wq_b"] = stacked(mm, "attn_q_b", lo, hi, rope_block=n + rot)
        else:
            out["wq"] = stacked(mm, "attn_q", lo, hi, rope_block=n + rot)
        kbs, vbs = [], []
        for i in range(lo, hi):
            name = f"blk.{i}.attn_kv_b.weight"
            if name not in gf.tensors:
                raise GGUFReadError(
                    f"deepseek2 GGUF missing {name!r} — exports that ship "
                    "only the pre-split attn_k_b/attn_v_b are not supported"
                )
            kb = gf.tensor(name).astype(np.float32).reshape(H, n + vd, r)
            kbs.append(bf16_round(kb[:, :n]))
            vbs.append(bf16_round(kb[:, n:]))
        out["w_kb"] = np.stack(kbs)
        out["w_vb"] = np.stack(vbs)
        return out

    mlp = (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down"))
    layers = attn_stack(kd, L)
    if arch.is_moe:
        groupable = arch.hidden_size % 32 == 0 and arch.moe_inter_size % 32 == 0
        layers["router"] = np.stack([
            bf16_round(gf.tensor(f"blk.{i}.ffn_gate_inp.weight").astype(np.float32).T)
            for i in range(kd, L)])
        if arch.router_bias:
            layers["router_bias"] = np.stack([
                gf.tensor(f"blk.{i}.exp_probs_b.bias").astype(np.float32)
                for i in range(kd, L)])
        for ours, nm in mlp:
            parts = []
            for i in range(kd, L):
                t3 = gf.tensor(f"blk.{i}.ffn_{nm}_exps.weight").astype(np.float32)
                if groupable:
                    per_e = threaded(grouped_int8_from_dense, list(t3))
                    parts.append({k: np.stack([p[k] for p in per_e]) for k in per_e[0]})
                else:
                    parts.append(bf16_round(t3.swapaxes(-1, -2)))
            layers[ours] = ({k: np.stack([p[k] for p in parts]) for k in parts[0]}
                            if groupable else np.stack(parts))
        if arch.n_shared_experts:
            for ours, nm in mlp:
                layers[f"shared_{nm}"] = stacked(mm, f"ffn_{nm}_shexp", kd, L)
    else:
        for ours, nm in mlp:
            layers[ours] = stacked(mm, f"ffn_{nm}", 0, L)

    params: dict[str, Any] = {
        "embed": bf16_round(gf.tensor("token_embd.weight")),
        "layers": layers,
        "final_norm": bf16_round(gf.tensor("output_norm.weight")),
    }
    if kd:
        dense = attn_stack(0, kd)
        for ours, nm in mlp:
            dense[ours] = stacked(mm, f"ffn_{nm}", 0, kd)
        params["dense_layers"] = dense
    if "output.weight" in gf.tensors:
        w = gf.tensor("output.weight").astype(np.float32)  # [V, D]
        params["lm_head"] = quantize_tensor_np(w, axis=-1)
    return params


def _load_matmul_weight(gf: GGUFFile, tname: str, arch, ours: str,
                        permute_qk: bool = True):
    """One 2D matmul weight → grouped quant dict [G, ..., out] or bf16
    [in, out]; q/k rows un-permuted back to the HF rope layout when the
    export permuted them (llama family)."""
    heads = {"wq": arch.num_heads, "wk": arch.num_kv_heads}.get(ours)
    if not permute_qk:
        heads = None
    grouped = gf.grouped(tname)
    if grouped is not None:
        if heads is not None:
            n_out = grouped["gs"].shape[-1]
            idx = _permutation_indices(n_out, heads)
            grouped = {k: np.ascontiguousarray(v[..., idx]) for k, v in grouped.items()}
        return grouped
    w = gf.tensor(tname).astype(np.float32)  # [out, in]
    if heads is not None:
        w = _unpermute_rows(w, heads)
    return bf16_round(w.T)


# Where a synthesized tokenizer goes when the model's directory is read-only:
# the port's own build directory (listed in .gitignore), one subdirectory a
# model path.
TOKENIZER_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "_build", "gguf-tok")


def _tokenizer_cache_dir(path: str) -> str:
    """Synthesized-tokenizer location: next to the model when writable
    (keeps things inspectable), else a path-keyed directory under
    TOKENIZER_CACHE — model volumes are often read-only mounts."""
    local = path + ".tokenizer"
    parent = os.path.dirname(os.path.abspath(path))
    if os.access(parent, os.W_OK):
        return local
    import hashlib

    digest = hashlib.sha256(os.path.abspath(path).encode()).hexdigest()[:16]
    return os.path.join(TOKENIZER_CACHE, digest)


def load_gguf_checkpoint(path: str):
    """(arch, params, tokenizer_dir_or_None) for a .gguf file: the port's
    counterpart of the reference's GGUF load (grpc-server.cpp:379-527).
    `params` is the numpy tree of `load_gguf_params`; an arch the port does
    not serve yet raises before any tensor is read."""
    gf = GGUFFile(path)
    arch = arch_from_gguf(gf)
    params = load_gguf_params(gf, arch)
    tok_dir = write_hf_tokenizer(gf, _tokenizer_cache_dir(path))
    return arch, params, tok_dir
