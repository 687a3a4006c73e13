"""Attention ops: batched causal prefill, and single-token decode against
a dense slot KV cache or a paged pool (localai_tpu/ops/attention.py).

- Prefill goes to the flash path (ops/flash.py: the CUDA kernel on the
  card, its plain version on the CPU) for power-of-two buckets without
  softcap or sliding window, exactly where the JAX package takes its Pallas
  kernel; everything else takes dense math. The split is by shape only.
- Dense decode reads the cache [B, S, K, Hd] with a length mask, in plain
  PyTorch, as the JAX package does in plain XLA.
- Paged decode and chunked prefill read a shared page pool [P, page, K, Hd]
  through per-slot page tables: online-softmax partials over each slot's
  pages (ops/paged_flash: the CUDA kernel on the card, its plain version on
  the CPU), merged with the block-local window and the current token by
  `_merge_partials*`. An fp8 pool may carry a per-head `kv_scale` [2, K]:
  its rows are multiplied back as they are read.
- GQA: queries have H heads, the cache K kv heads; queries reshape to
  [B, K, H//K, ...] against the shared kv head.
"""

from __future__ import annotations

import torch

from localai_tpu_torch.ops import paged_flash
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
    """Prefill attention dispatcher: flash for power-of-two buckets, dense
    math for softcap / sliding windows / buckets that are not a power of
    two."""
    S = q.shape[1]
    if (
        lengths is not None
        and not softcap
        and not window
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


# --------------------------------------------------------------------------- #
# Paged KV cache: one shared page pool, per-slot page tables
# --------------------------------------------------------------------------- #


def _merge_partials(q, acc_g, m_g, l_g, extra_k, extra_v, extra_mask,
                    softcap: float = 0.0):
    """Merge cache partials with a small dense tail (the block-local window
    and the current token). q [B, H, D]; partials [B, K, G, D|1];
    extra_k/v [B, E, K, D]; extra_mask [B, E] or [E]. Returns [B, H, D] in
    q's dtype. Empty partials (l == 0) get weight 0."""
    B, H, D = q.shape
    K = extra_k.shape[2]
    G = H // K
    qf = (q.float() * (1.0 / (D**0.5))).reshape(B, K, G, D)
    se = torch.einsum("bkgd,bekd->bkge", qf, extra_k.float())
    if softcap:
        se = softcap_scores(se, softcap)
    if extra_mask.dim() == 1:
        extra_mask = extra_mask[None, :]
    emask = extra_mask[:, None, None, :]
    se = torch.where(emask, se, NEG_INF)
    m_tot = torch.maximum(m_g, se.amax(dim=-1, keepdim=True))
    p_e = torch.where(emask, torch.exp(se - m_tot), 0.0)
    w_c = torch.exp(torch.clamp(m_g - m_tot, min=-80.0))
    w_c = torch.where(l_g > 0, w_c, 0.0)
    num = acc_g * w_c + torch.einsum("bkge,bekd->bkgd", p_e, extra_v.float())
    den = l_g * w_c + p_e.sum(dim=-1, keepdim=True)
    out = num / torch.clamp(den, min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _merge_partials_mq(q, acc_g, m_g, l_g, extra_k, extra_v, extra_mask,
                       softcap: float = 0.0):
    """Multi-query `_merge_partials`: q [B, T, H, D], partials
    [B, K, G, T, D|1], extra_k/v [B, E, K, D], extra_mask [B, T, E].
    Returns [B, T, H, D]."""
    B, T, H, D = q.shape
    K = extra_k.shape[2]
    G = H // K
    qf = (q.float() * (1.0 / (D**0.5))).reshape(B, T, K, G, D)
    se = torch.einsum("btkgd,bekd->bkgte", qf, extra_k.float())
    if softcap:
        se = softcap_scores(se, softcap)
    emask = extra_mask[:, None, None]  # [B, 1, 1, T, E]
    se = torch.where(emask, se, NEG_INF)
    m_tot = torch.maximum(m_g, se.amax(dim=-1, keepdim=True))
    p_e = torch.where(emask, torch.exp(se - m_tot), 0.0)
    w_c = torch.exp(torch.clamp(m_g - m_tot, min=-80.0))
    w_c = torch.where(l_g > 0, w_c, 0.0)
    num = acc_g * w_c + torch.einsum("bkgte,bekd->bkgtd", p_e, extra_v.float())
    den = l_g * w_c + p_e.sum(dim=-1, keepdim=True)
    out = num / torch.clamp(den, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


def paged_partials(q, k_pool, v_pool, table, limits, softcap: float = 0.0,
                   window: int = 0, sliding=None, q_pos=None, mesh=None, kv_scale=None,
                   sink: int = 0, swin: int = 0):
    """Paged decode partials over rows [0, limits[b]) of each slot's pages:
    the ragged kernel for tensors on the card, its plain version on the CPU
    (ops/paged_flash). q [B, H, D]; returns (acc [B, K, G, D],
    m [B, K, G, 1], l [B, K, G, 1]) f32, scale applied."""
    paged_flash.reject_unported(sink, swin, mesh)
    return paged_flash.paged_decode_partials(q, k_pool, v_pool, table, limits,
                                             softcap=softcap, window=window,
                                             sliding=sliding, q_pos=q_pos, kv_scale=kv_scale)


def paged_prefill_partials(q, k_pool, v_pool, table, limits, softcap: float = 0.0,
                           window: int = 0, sliding=None, q_pos=None, mesh=None,
                           kv_scale=None, sink: int = 0, swin: int = 0):
    """Paged partials for a prefill chunk (models/llama.prefill_chunk_paged):
    q [B, T, H, D] is the whole chunk, limits[b] the rows already resident
    (the chunk's offset). The kernel takes the chunk in one launch."""
    paged_flash.reject_unported(sink, swin, mesh)
    return paged_flash.paged_prefill_partials_mq(q, k_pool, v_pool, table, limits,
                                                 softcap=softcap, window=window,
                                                 sliding=sliding, q_pos=q_pos,
                                                 kv_scale=kv_scale)


def decode_attention_windowed_paged(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [P, page, K, D] shared page pool (one layer)
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, MP] int32 page ids per slot
    k_local: torch.Tensor,  # [B, n, K, D] block-local window
    v_local: torch.Tensor,
    k_new: torch.Tensor,  # [B, K, D]
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B]
    step: int,
    softcap: float = 0.0,
    window: int = 0,
    sliding: bool | None = None,
    mesh=None,
    kv_scale=None,
    sink: int = 0,
    swin: int = 0,
) -> torch.Tensor:
    """`decode_attention_windowed` over a paged pool: paged partials for
    rows [0, block_start), dense merge of the local window and the current
    token. Returns [B, H, D]."""
    n = k_local.shape[1]
    dev = q.device
    acc, m, l = paged_partials(
        q, k_pool, v_pool, table, positions - step, softcap=softcap, window=window,
        sliding=sliding, q_pos=positions, mesh=mesh, kv_scale=kv_scale,
        sink=sink, swin=swin,
    )
    ek = torch.cat([k_local.float(), k_new[:, None].float()], dim=1)
    ev = torch.cat([v_local.float(), v_new[:, None].float()], dim=1)
    lrows = torch.arange(n, device=dev)
    mask = torch.cat([lrows < step, torch.ones((1,), dtype=torch.bool, device=dev)])
    if window and sliding:
        dist = torch.cat([step - lrows, torch.zeros((1,), dtype=lrows.dtype, device=dev)])
        mask = mask & (dist < window)
    mask = mask[None, :].expand(q.shape[0], n + 1)
    return _merge_partials(q, acc, m, l, ek, ev, mask, softcap=softcap)
