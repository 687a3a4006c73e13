"""Weight-only quantization for serving: per-channel int8 and grouped
int8 / int4 (localai_tpu/models/quant.py, the dense forms).

Quantized checkpoints are what the reference serves most (Q4 / Q8). The
weights stay int8 or packed int4 in device memory, so decode, which is
bound by the weight bytes it reads, reads a half or a quarter of them.

Representations consumed by `matmul` / `unembed_matmul`:
- {"q": int8 [..., in, out], "s": f32 [..., 1, out]} — per-output-channel
  symmetric int8 (mode "int8").
- {"gq": int8 [..., G, gs, out], "gs": f32 [..., G, 1, out]} — group-wise
  symmetric int8.
- {"g4": uint8 [..., G, gs//2, out], "gs": ..., "gz": f32 [..., G, 1, out]}
  — group-wise affine 4-bit, two nibbles per byte along the in-group axis
  (low nibbles = first gs/2 elements); value = nibble * gs - gz (mode
  "int4").
- the lm_head {"q": int8 [V, D], "s": f32 [V, 1]}, used transposed.
- mixture-of-experts stacks: each of the first three with a leading expert
  axis ([E, in, out] → q [E, in, out], s [E, 1, out]; gq / g4 [E, G, ...]),
  consumed by `moe_matmul` in the layer's two einsum shapes.

Decode-shape calls go to the fused kernels (ops/quant_matmul: B3 and B4 on
the card); everything else takes the dequantize-then-matmul forms here,
which are the JAX package's XLA forms. The quantizers give the JAX
package's integers and scales bit for bit: the torch ones those of its
compiled quantize_params, the numpy ones those of its numpy loader path.
`init_params_quantized` builds a random tree straight in the quantized
form, one layer at a time, so a model whose bf16 weights would not fit
(mixtral-8x7b on one 80 GB card) never exists in bf16.

GGUF files arrive already in these forms (engine/gguf.py): q4_0 / q4_K as
g4 with per-group zero points, q8_0 and the regridded types as gq.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from localai_tpu_torch.ops import quant_matmul

Params = dict[str, Any]

# Dense matmul weights that are quantized; embeddings stay in the model
# dtype (gather path). MLA's latent up-projections w_kb / w_vb stay
# unquantized (einsum paths, small beside the experts), as in the JAX
# package.
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "wq_a", "wq_b", "wkv_a",
                    "shared_gate", "shared_up", "shared_down")
# The stacked-layer subtrees: DeepSeek trees add the dense-layer prefix.
STACKS = ("layers", "dense_layers")

GROUP_SIZE = 32  # GGUF q4_0 / q8_0 blocks


def _int8_over(wf: torch.Tensor, dim: int) -> dict[str, torch.Tensor]:
    """Symmetric int8 of an f32 tensor with one scale per slice along
    `dim`. The scale is max|w| · (1/127): the JAX package quantizes inside
    jit, where XLA turns the division by a constant into that product."""
    s = torch.clamp(wf.abs().amax(dim=dim, keepdim=True) * (1.0 / 127.0), min=1e-9)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_tensor(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 over the reduction (-2) axis."""
    return _int8_over(w.float(), -2)


def quantize_tensor_g4(w: torch.Tensor, group: int = GROUP_SIZE) -> dict[str, torch.Tensor]:
    """Group-wise affine 4-bit over the reduction (-2) axis; value =
    nibble * gs - gz, nibbles packed two per byte (low = first half of the
    group)."""
    *lead, n_in, n_out = w.shape
    if n_in % group:
        raise ValueError(f"in dim {n_in} not divisible by group {group}")
    g = n_in // group
    wf = w.float().reshape(*lead, g, group, n_out)
    mn = wf.amin(dim=-2, keepdim=True)
    mx = wf.amax(dim=-2, keepdim=True)
    s = torch.clamp((mx - mn) * (1.0 / 15.0), min=1e-9)  # as XLA compiles "/ 15"
    nib = torch.clamp(torch.round((wf - mn) / s), 0, 15).to(torch.uint8)
    half = group // 2
    packed = nib[..., :half, :] | (nib[..., half:, :] << 4)
    return {"g4": packed, "gs": s, "gz": -mn}


def _grouped_values(w: dict, dtype) -> torch.Tensor:
    """[..., G, gs, out] values (still un-scaled) from a grouped dict."""
    return quant_matmul._grouped_values(w, dtype)


def grouped_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., in] @ grouped-quantized w [G, gs(, packed), out] → [..., out].

    The weight is dequantized in x's dtype (values times each group's
    scale) and multiplied in one matmul; the affine zero point contributes
    Σ_i x_i · z per group, a rank-1 correction. The JAX package scales the
    per-group partial sums instead, which differs only in rounding."""
    qv = _grouped_values(w, x.dtype)  # [G, gs, out]
    g, gs, n_out = qv.shape
    out = x @ (qv * w["gs"].to(x.dtype)).reshape(g * gs, n_out)
    if "gz" in w:
        xsum = x.reshape(*x.shape[:-1], g, gs).sum(dim=-1)  # [..., G]
        out = out - xsum @ w["gz"].to(x.dtype)[..., 0, :]
    return out


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or quantized w.

    Quantized decode-shape calls (at most QUANT_KERNEL_MAX_ROWS float rows)
    go to the fused dequant-matmul (B3); the rest, prefill-scale rows or a
    non-float x, take the dequantize-then-matmul forms below, split by shape
    and counted in `matmul.dequant_calls`."""
    if isinstance(w, dict):
        y = quant_matmul.dispatch_matmul(x, w)
        if y is not None:
            return y
        matmul.dequant_calls += 1
        if "q" in w:
            return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)[..., 0, :]
        return grouped_matmul(x, w)
    return x @ w


# Quantized calls served by the dequantize-then-matmul forms.
matmul.dequant_calls = 0


def _moe_grouped_mm(x: torch.Tensor, w: dict, sub: str) -> torch.Tensor:
    """Grouped int8 / int4 expert stacks [E, G, gs(, packed), out] in the
    two MoE einsum shapes: dequantized in x's dtype, one einsum, the int4
    zero point as the rank-1 correction (the JAX package scales each
    group's partial sum instead, which differs only in rounding)."""
    qv = _grouped_values(w, x.dtype)  # [E, G, gs, out]
    e, g, gs, n_out = qv.shape
    out = torch.einsum(sub, x, (qv * w["gs"].to(x.dtype)).reshape(e, g * gs, n_out))
    if "gz" in w:
        xsum = x.reshape(*x.shape[:-1], g, gs).sum(dim=-1)  # [..., (E,) G]
        xg = "...eg" if sub == quant_matmul.MOE_PER_EXPERT else "...g"
        out = out - torch.einsum(f"{xg},egn->...en", xsum, w["gz"].to(x.dtype)[..., 0, :])
    return out


def moe_matmul(x: torch.Tensor, w, sub: str) -> torch.Tensor:
    """Every expert's product for the mixture-of-experts layer's two einsum
    shapes (ops/quant_matmul.MOE_SHARED, MOE_PER_EXPERT), plain or quantized
    expert stacks w [E, in, out]. Quantized decode-shape calls go to B3's
    expert form (one launch for every expert); the rest take the
    dequantize-then-matmul forms, counted in `moe_matmul.dequant_calls`."""
    if isinstance(w, dict):
        y = quant_matmul.dispatch_moe_mm(x, w, sub)
        if y is not None:
            return y
        moe_matmul.dequant_calls += 1
        if "q" in w:
            return torch.einsum(sub, x, w["q"].to(x.dtype)) * w["s"].to(x.dtype)[..., 0, :]
        return _moe_grouped_mm(x, w, sub)
    return torch.einsum(sub, x, w)


# Quantized expert products served by the dequantize-then-matmul forms.
moe_matmul.dequant_calls = 0


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "gq" in w or "g4" in w)


def is_grouped(w) -> bool:
    return isinstance(w, dict) and ("gq" in w or "g4" in w)


# Host threads a large load-time array op splits over (numpy's array loops
# release the GIL); a host quantization of at least _HOST_SPLIT weights
# splits its output columns.
HOST_THREADS = min(8, os.cpu_count() or 1)
_HOST_SPLIT = 1 << 24


def threaded(fn, items: list) -> list:
    """[fn(x) for x in items] on HOST_THREADS threads: the same results in
    the same order."""
    if len(items) < 2 or HOST_THREADS == 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(HOST_THREADS) as ex:
        return list(ex.map(fn, items))


def _by_columns(fn, wf: np.ndarray) -> dict:
    """fn(wf) for a [..., in, out] array whose quantization groups run along
    `in`: each output column is quantized alone, so fn over blocks of
    columns on host threads, concatenated, is fn(wf) bit for bit."""
    if wf.size < _HOST_SPLIT:
        return fn(wf)
    edges = np.linspace(0, wf.shape[-1], HOST_THREADS + 1).astype(int)
    parts = threaded(lambda ab: fn(wf[..., ab[0]:ab[1]]), list(zip(edges[:-1], edges[1:])))
    return {k: np.concatenate([p[k] for p in parts], axis=-1) for k in parts[0]}


def quantize_tensor_np(arr, axis: int = -2) -> dict:
    """numpy variant for host-side load-time quantization (a checkpoint
    too big for device memory in bf16)."""
    wf = np.asarray(arr, np.float32)
    if axis in (-2, wf.ndim - 2):
        return _by_columns(_quantize_np, wf)
    if wf.ndim == 2 and axis in (-1, 1):  # a head [V, D]: a scale a row, rows alone
        return {k: np.ascontiguousarray(v.T)
                for k, v in _by_columns(lambda w: _quantize_np(w, -2), wf.T).items()}
    return _quantize_np(wf, axis)


def _quantize_np(wf: np.ndarray, axis: int = -2) -> dict:
    s = np.max(np.abs(wf), axis=axis, keepdims=True) / 127.0
    s = np.maximum(s, 1e-9)
    q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    return {"q": q, "s": s.astype(np.float32)}


def quantize_tensor_np_g4(arr, group: int = GROUP_SIZE) -> dict:
    """numpy variant of `quantize_tensor_g4` (host-side int4 load path).
    arr [..., in, out] → grouped affine 4-bit over the in axis."""
    wf = np.asarray(arr, np.float32)
    if wf.shape[-2] % group:
        raise ValueError(f"in dim {wf.shape[-2]} not divisible by group {group}")
    return _by_columns(lambda w: _quantize_np_g4(w, group), wf)


def _quantize_np_g4(wf: np.ndarray, group: int) -> dict:
    *lead, n_in, n_out = wf.shape
    g = n_in // group
    wf = wf.reshape(*lead, g, group, n_out)
    mn = wf.min(axis=-2, keepdims=True)
    mx = wf.max(axis=-2, keepdims=True)
    s = np.maximum((mx - mn) / 15.0, 1e-9)
    nib = np.clip(np.round((wf - mn) / s), 0, 15).astype(np.uint8)
    half = group // 2
    packed = nib[..., :half, :] | (nib[..., half:, :] << 4)
    return {"g4": packed, "gs": s.astype(np.float32), "gz": (-mn).astype(np.float32)}


def is_prequantized(params: Params) -> bool:
    return any(isinstance((params.get(stack) or {}).get(k), dict)
               for stack in STACKS for k in QUANT_LAYER_KEYS)


def dequantize_tensor(w) -> torch.Tensor:
    """Back to a dense f32 tensor (tests / debugging)."""
    if not isinstance(w, dict):
        return w
    if "q" in w:
        return w["q"].float() * w["s"]
    vals = _grouped_values(w, torch.float32) * w["gs"]  # [..., G, gs, out]
    if "gz" in w:
        vals = vals - w["gz"]
    *lead, g, gs, n_out = vals.shape
    return vals.reshape(*lead, g * gs, n_out)


def _quantizer(mode: str):
    if mode == "int8":
        return quantize_tensor
    if mode == "int4":
        return quantize_tensor_g4
    raise ValueError(f"unsupported quantization mode {mode!r}")


def quantize_params(cfg, params: Params, mode: str = "int8") -> Params:
    """Quantize a llama-family param tree's matmul weights where they lie,
    in both stacks of a DeepSeek tree. Each stacked weight is quantized one
    layer at a time (the reductions never cross layers or experts, so the
    result equals a whole-stack pass) to bound the f32 temporaries; an
    expert stack [L, E, in, out] gives s [L, E, 1, out] and gq / g4
    [L, E, G, ...]."""
    if mode in ("", "none", None):
        return params
    qfn = _quantizer(mode)
    out = dict(params)
    for stack in STACKS:
        if stack not in params:
            continue
        layers = dict(params[stack])
        for key in QUANT_LAYER_KEYS:
            if key in layers:
                parts = [qfn(w) for w in layers[key]]
                layers[key] = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
                del parts
        out[stack] = layers
    if "lm_head" in params and not cfg.tie_embeddings:
        # lm_head [V, D] is used transposed (h @ W.T): quantize over D so
        # the scale lands on the vocab axis.
        out["lm_head"] = _int8_over(params["lm_head"].float(), -1)  # q [V, D], s [V, 1]
    return out


def init_params_quantized(cfg, seed: int = 0, scale: float = 0.02, mode: str = "int8",
                          device=None) -> Params:
    """Random init that lands in the quantized form: the tree of
    `quantize_params(cfg, init_params(cfg), mode)` (same keys, shapes and
    dtypes), built leaf by leaf on `device`. Each matmul stack is drawn
    (normal · scale, f32, from a torch.Generator seeded with `seed`) and
    quantized one layer at a time into its preallocated stacked payload and
    scales, so device memory peaks at the quantized tree plus one layer's
    f32 weight (mixtral-8x7b int4: ~35 GB, where bf16 would need 93 GB).
    Its values are not the JAX package's `init_params_quantized`'s."""
    from localai_tpu_torch.device import resolve_device
    from localai_tpu_torch.models.llama import param_specs, torch_dtype

    qfn = _quantizer(mode)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale

    def leaf(name: str, shape, kind: str):
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if kind == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if kind == "zeros_f32":
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if name == "lm_head" and not cfg.tie_embeddings:
            return _int8_over(normal(shape), -1)  # q [V, D], s [V, 1]
        if name not in QUANT_LAYER_KEYS:
            return normal(shape).to(dt)
        stack = None
        for li in range(shape[0]):
            part = qfn(normal(shape[1:]))
            if stack is None:
                stack = {k: torch.empty((shape[0], *v.shape), dtype=v.dtype, device=device)
                         for k, v in part.items()}
            for k, v in part.items():
                stack[k][li].copy_(v)
        return stack

    specs = param_specs(cfg)
    return {name: ({k: leaf(k, shape, kind) for k, (shape, kind) in spec.items()}
                   if name in STACKS else leaf(name, *spec))
            for name, spec in specs.items()}


def unembed_matmul(h: torch.Tensor, w) -> torch.Tensor:
    """h @ W.T for the (possibly quantized) [V, D] lm_head / embed matrix
    → f32 logits.

    A quantized head goes to the fused unembed (B4) at decode row counts;
    the rest takes `(h @ qᵀ) · s` with f32 accumulation, counted in
    `unembed_matmul.dequant_calls`. A plain head: operands stay in the
    weight's dtype and only the accumulation and the result are f32 (the
    JAX package's preferred_element_type=f32): logits rounded to bf16 would
    tie near-equal candidates and break greedy parity. On the card, cuBLAS
    writes the f32 result directly; on the CPU both operands widen to f32
    first, which is exact for bf16 products."""
    if isinstance(w, dict):
        y = quant_matmul.dispatch_unembed(h, w)
        if y is not None:
            return y
        unembed_matmul.dequant_calls += 1
        return _dense_unembed(h, w["q"].to(h.dtype)) * w["s"][:, 0].float()
    return _dense_unembed(h, w)


# Quantized heads served by the dequantize-then-matmul form.
unembed_matmul.dequant_calls = 0


def _dense_unembed(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x = h.to(w.dtype)
    if w.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        lead = x.shape[:-1]
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[0])
    return x.float() @ w.float().t()
