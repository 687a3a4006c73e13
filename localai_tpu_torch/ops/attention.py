"""Attention ops: batched causal prefill and single-token decode against a
slot KV cache (localai_tpu/ops/attention.py).

- Prefill goes to the flash path (ops/flash.py: the CUDA kernel on the
  card, its plain version on the CPU) for power-of-two buckets without
  softcap or sliding window, exactly where the JAX package takes its Pallas
  kernel; everything else, or LOCALAI_FLASH=0, takes dense math.
- Decode reads the dense cache [B, S, K, Hd] with a length mask, in plain
  PyTorch, as the JAX package does in plain XLA.
- GQA: queries have H heads, the cache K kv heads; queries reshape to
  [B, K, H//K, ...] against the shared kv head.
"""

from __future__ import annotations

import os

import torch

from localai_tpu_torch.ops.flash import flash_prefill_attention

NEG_INF = -1e30


def softcap_scores(sc: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 attention-logit softcapping: cap·tanh(sc/cap). Applied BEFORE
    masking (tanh of NEG_INF would be finite and corrupt the mask)."""
    return cap * torch.tanh(sc / cap)


def prefill_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,  # [B, S, K, D]
    length_mask: torch.Tensor | None,  # [B, S] bool
    lengths: torch.Tensor | None = None,  # [B] int (enables the flash path)
    softcap: float = 0.0,
    window: int = 0,
    sliding: bool | None = None,  # this layer uses the sliding window
) -> torch.Tensor:
    """Prefill attention dispatcher: flash by default (opt out with
    LOCALAI_FLASH=0), dense math for softcap / sliding windows / buckets
    that are not a power of two."""
    S = q.shape[1]
    if (
        lengths is not None
        and not softcap
        and not window
        and os.environ.get("LOCALAI_FLASH", "1") != "0"
        and (S & (S - 1)) == 0  # power-of-two bucket
    ):
        return flash_prefill_attention(
            q, k, v, lengths.to(device=q.device, dtype=torch.int32).contiguous()
        )
    return causal_prefill_attention(q, k, v, length_mask, softcap=softcap,
                                    window=window, sliding=sliding)


def causal_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,  # [B, S, K, D]
    length_mask: torch.Tensor | None = None,  # [B, S] bool, True = valid token
    softcap: float = 0.0,
    window: int = 0,
    sliding: bool | None = None,
) -> torch.Tensor:
    """Dense causal attention for prompt processing. Returns [B, S, H, D]."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / (D**0.5)
    qf = q.float().reshape(B, S, K, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if softcap:
        scores = softcap_scores(scores, softcap)
    pos = torch.arange(S, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [S_q, S_k]
    if window and sliding:
        causal = causal & ((pos[:, None] - pos[None, :]) < window)
    mask = causal[None, None, None]
    if length_mask is not None:
        mask = mask & length_mask[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention_windowed(
    q: torch.Tensor,  # [B, H, D] current token's query
    k_cache: torch.Tensor,  # [B, S, K, D] — READ-ONLY cache (pre-block rows)
    v_cache: torch.Tensor,
    k_local: torch.Tensor,  # [B, n, K, D] — this decode block's earlier tokens
    v_local: torch.Tensor,
    k_new: torch.Tensor,  # [B, K, D] current token
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B] current token's position
    step: int,  # index of the current token within the block
    softcap: float = 0.0,
    window: int = 0,
    sliding: bool | None = None,
) -> torch.Tensor:
    """Decode attention over `cache[0:block_start] ⊕ local[0:step] ⊕ current`.

    Inside a decode block the cache stays read-only (the block's rows live
    in the local window) and is written once per block. Returns [B, H, D]."""
    B, H, D = q.shape
    S = k_cache.shape[1]
    n = k_local.shape[1]
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / (D**0.5)
    dev = q.device

    qf = (q.float() * scale).reshape(B, K, G, D)
    block_start = positions - step  # [B]
    rows = torch.arange(S, device=dev)
    sc = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    if softcap:
        sc = softcap_scores(sc, softcap)
    valid_c = rows[None, :] < block_start[:, None]
    if window and sliding:
        valid_c = valid_c & ((positions[:, None] - rows[None, :]) < window)
    sc = torch.where(valid_c[:, None, None, :], sc, NEG_INF)
    sl = torch.einsum("bkgd,bnkd->bkgn", qf, k_local.float())
    if softcap:
        sl = softcap_scores(sl, softcap)
    lrows = torch.arange(n, device=dev)
    valid_l = lrows < step
    if window and sliding:
        valid_l = valid_l & ((step - lrows) < window)
    sl = torch.where(valid_l[None, None, None, :], sl, NEG_INF)
    cur = torch.einsum("bkgd,bkd->bkg", qf, k_new.float())[..., None]
    if softcap:
        cur = softcap_scores(cur, softcap)
    probs = torch.softmax(torch.cat([sc, sl, cur], dim=-1), dim=-1)
    out = (
        torch.einsum("bkgs,bskd->bkgd", probs[..., :S], v_cache.float())
        + torch.einsum("bkgn,bnkd->bkgd", probs[..., S:S + n], v_local.float())
        + probs[..., S + n:] * v_new.float()[:, :, None, :]
    )
    return out.reshape(B, H, D).to(q.dtype)
