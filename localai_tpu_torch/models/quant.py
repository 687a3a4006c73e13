"""Model-side matmuls (localai_tpu/models/quant.py), plain weights only.

Quantized weight dicts (int8 / grouped int8 / int4, the fused dequant
kernels) are not ported yet: ROADMAP Queue A item 13.
"""

from __future__ import annotations

import torch


def _reject_quantized(w) -> None:
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized weights are not ported yet (ROADMAP Queue A item 13)"
        )


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain [in, out] weight, in the operands' dtype."""
    _reject_quantized(w)
    return x @ w


def unembed_matmul(h: torch.Tensor, w) -> torch.Tensor:
    """h @ W.T for the [V, D] lm_head / embed matrix → f32 logits.

    Operands stay in the weight's dtype and only the accumulation and the
    result are f32 (the JAX package's preferred_element_type=f32): logits
    rounded to bf16 would tie near-equal candidates and break greedy
    parity. On the card, cuBLAS writes the f32 result directly; on the CPU
    both operands widen to f32 first, which is exact for bf16 products."""
    _reject_quantized(w)
    x = h.to(w.dtype)
    if w.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        lead = x.shape[:-1]
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[0])
    return x.float() @ w.float().t()
