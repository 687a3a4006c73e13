"""Llama-family decoder (Llama 2/3, Mistral, Qwen2, TinyLlama) in PyTorch
(localai_tpu/models/llama.py, dense branch).

- Parameters are a dict of stacked per-layer tensors ([L, ...] leading
  axis, matmul weights W [in, out]) — the JAX package's tree, so weights
  move between the two packages without reshaping (engine/weights.py).
  The JAX layer scan becomes a Python loop over the stack.
- Entry points: `prefill` (causal attention over a bucketed prompt),
  `decode_step_windowed` (one token per slot inside an N-step decode block
  whose rows ride a block-local KV window; the cache is written once per
  block) and `prefill_chunk_paged` (one chunk of a long prompt, written
  straight into the slot's pages).
- Two cache layouts: a dense slot cache [L, B, S, K, Hd]
  (`write_block_to_cache`, `write_prefill_to_cache`) and a paged pool
  [L, P, page, K, Hd] shared by every slot through per-slot page tables
  (`paged_cache_zeros`, `write_block_to_pool`, `write_chunk_to_pool`,
  `write_prefill_to_pool`); only the attention call differs between them.
  Either may be stored in fp8 (e4m3 / e5m2); a paged pool may also carry a
  per-head `kv_scale` [2, K] f32, so it stores value / scale and every
  reader multiplies back (`_pool_store`). Writes into fp8 go through
  `kv_cast`, which gives the JAX package's fp8 values.
- Matmul weights are plain [in, out] tensors or quantized dicts (int8,
  grouped int8, packed int4; models/quant.py), stacked [L, ...] like the
  rest; the lm_head may be an int8 dict. Decode-shape products go to the
  fused dequant kernels.
- Runtime LoRA: `prefill` and `decode_step_windowed` take
  `lora=(stacks, ids)`, the engine's stacked adapter factors {key: {"a":
  [L, NA, in, R], "b": [L, NA, R, out]}} and one adapter id per batch row;
  each targeted projection adds its row's delta (ops/lora_matmul.py) to
  the base product, quantized or not. `prefill_chunk_paged` takes none:
  adapter prompts admit single-shot, as in the JAX package.
- GQA, RoPE (every scaling family), RMSNorm, SwiGLU / GeGLU, optional qkv
  bias (Qwen2) and the gemma flags (softcaps, sandwich norms, q/k norms,
  sliding windows) chosen from ArchConfig.

Not ported yet, and rejected with NotImplementedError: MoE and MLA layers
(ROADMAP Queue A item 16), sequence-parallel ring attention and tp meshes
(item 20), m-rope (item 19), and sink+window decode
and hierarchical page tables (item 15).

The cache, the pool and the block-local windows are updated IN PLACE (the
JAX package returns new arrays): that saves a full copy of each per call.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.quant import is_quantized, matmul, unembed_matmul
from localai_tpu_torch.ops import ptable as _pt
from localai_tpu_torch.ops.lora_matmul import lora_delta
from localai_tpu_torch.ops.attention import (
    _merge_partials_mq,
    decode_attention_windowed,
    decode_attention_windowed_paged,
    paged_prefill_partials,
    prefill_attention,
)
from localai_tpu_torch.ops.norm import rms_norm
from localai_tpu_torch.ops.rope import (
    apply_rope,
    rope_frequencies,
    rope_frequencies_local,
    rope_query_amp,
)

Params = dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the architecture features this port does not serve yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            "mixture-of-experts layers are not ported yet (ROADMAP Queue A item 16)")
    if cfg.is_mla:
        raise NotImplementedError(
            "multi-head latent attention is not ported yet (ROADMAP Queue A item 16)")
    if cfg.mrope_section:
        raise NotImplementedError(
            "m-rope (Qwen2-VL) is not ported yet (ROADMAP Queue A item 19)")
    if cfg.attention_window or cfg.attention_sink:
        raise NotImplementedError(
            "sink+window decode is not ported yet (ROADMAP Queue A item 15)")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# fp8 e4m3fn has no infinity and 448 is its largest value: the JAX package's
# cast (ml_dtypes) rounds anything past 464 (448 plus half a step), and
# infinities, to NaN, where torch saturates to ±448.
_E4M3_NAN_ABOVE = 464.0
_E5M2_NAN_BITS = 0x7E  # ml_dtypes' e5m2 NaN; torch writes 0x7F


def kv_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to a cache's storage dtype with the JAX package's result:
    round-to-nearest-even inside an fp8 format's range, NaN past e4m3fn's,
    ±inf past e5m2's, and ml_dtypes' NaN bits. Other dtypes cast as is."""
    if dtype == torch.float8_e4m3fn:
        xf = x.float()
        nan = torch.copysign(torch.full_like(xf, float("nan")), xf)
        return torch.where(xf.abs() > _E4M3_NAN_ABOVE, nan, xf).to(dtype)
    if dtype == torch.float8_e5m2:
        xf = x.float()
        bits = xf.to(dtype).view(torch.uint8)
        fixed = (bits & 0x80) | _E5M2_NAN_BITS
        return torch.where(torch.isnan(xf), fixed, bits).view(dtype)
    return x.to(dtype)


class KVCache(NamedTuple):
    """Slot KV cache: k, v [L, B_slots, S_max, K_heads, head_dim], or a
    page pool [L, P, page, K_heads, head_dim] (`paged_cache_zeros`)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: ArchConfig, num_slots: int, max_seq: int, dtype=None,
              device=None) -> "KVCache":
        dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
        device = resolve_device(device)
        shape = (cfg.num_layers, num_slots, max_seq, cfg.num_kv_heads, cfg.head_dim_)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def init_params(cfg: ArchConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Params:
    """Random init (normal · scale) with the JAX package's tree structure,
    drawn from a torch.Generator seeded with `seed` on `device`."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rnd(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers: Params = {
        "attn_norm": ones(L, D),
        "mlp_norm": ones(L, D),
        "wq": rnd(L, D, H * Hd),
        "wk": rnd(L, D, K * Hd),
        "wv": rnd(L, D, K * Hd),
        "wo": rnd(L, H * Hd, D),
    }
    if cfg.post_norms:
        layers["post_attn_norm"] = ones(L, D)
        layers["post_ffw_norm"] = ones(L, D)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Hd)
        layers["k_norm"] = ones(L, Hd)
    if cfg.attn_qkv_bias:
        layers["bq"] = torch.zeros((L, H * Hd), dtype=dt, device=device)
        layers["bk"] = torch.zeros((L, K * Hd), dtype=dt, device=device)
        layers["bv"] = torch.zeros((L, K * Hd), dtype=dt, device=device)
    layers["w_gate"] = rnd(L, D, F_)
    layers["w_up"] = rnd(L, D, F_)
    layers["w_down"] = rnd(L, F_, D)
    params: Params = {
        "embed": rnd(cfg.vocab_size, D),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd(cfg.vocab_size, D)
    return params


def _layer(params: Params, li: int) -> Params:
    """Layer li's slice of every stacked tensor, quantized dicts leaf by
    leaf ({"q": [L, in, out], "s": [L, 1, out]} → layer li's views)."""
    return {name: ({k: v[li] for k, v in t.items()} if isinstance(t, dict) else t[li])
            for name, t in params["layers"].items()}


def _layer_sliding(cfg: ArchConfig, li: int) -> bool | None:
    """Which layers slide: li % pattern != pattern-1 (gemma-2: every other
    layer, gemma-3: 5 of 6). None when the arch has no sliding window."""
    if not cfg.sliding_window:
        return None
    p = cfg.sliding_pattern
    return (li % p) != (p - 1)


def _layer_inv_freq(cfg: ArchConfig, inv_global, inv_local, li: int):
    """Gemma-3 sliding layers rotate with their own unscaled base."""
    if inv_local is not None and _layer_sliding(cfg, li):
        return inv_local
    return inv_global


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; Gemma scales hidden states by sqrt(D) here
    while the tied unembed reads the raw matrix."""
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = (h.float() * (cfg.hidden_size**0.5)).to(h.dtype)
    return h


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated-MLP activation: SwiGLU (llama family) or GeGLU (gemma)."""
    if cfg.activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _unembed(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Final projection to f32 logits (f32 accumulation); an int8 lm_head
    dict goes through unembed_matmul's quantized route."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = unembed_matmul(h, w)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _lora_add(cfg: ArchConfig, lora, key: str, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """y + the per-row adapter delta of one target projection: unmerged
    B·(A·x) beside the base product, so the base weights stay shared (and
    possibly quantized) while each row rides its tenant's factors. lora =
    (this layer's stacks {key: {"a": [NA, in, R], "b": [NA, R, out]}}, ids
    [B]) or None; id 0 is the all-zero null adapter. The delta is rounded to
    x.dtype before the add, as in the JAX package."""
    if lora is None:
        return y
    stacks, ids = lora
    entry = stacks.get(key)
    if entry is None:
        return y
    return y + lora_delta(x, entry, ids)


def _layer_lora(lora, li: int):
    """Layer li's slice of the stacked adapter factors, with the ids."""
    if lora is None:
        return None
    stacks, ids = lora
    return {k: {"a": e["a"][li], "b": e["b"][li]} for k, e in stacks.items()}, ids


def _attn_proj_qkv(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None):
    """x: [..., D] -> q [..., H, Hd], k/v [..., K, Hd]."""
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = _lora_add(cfg, lora, "wq", x, matmul(x, lp["wq"]))
    k = _lora_add(cfg, lora, "wk", x, matmul(x, lp["wk"]))
    v = _lora_add(cfg, lora, "wv", x, matmul(x, lp["wv"]))
    if cfg.attn_qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    lead = x.shape[:-1]
    q = q.reshape(*lead, H, Hd)
    k = k.reshape(*lead, K, Hd)
    v = v.reshape(*lead, K, Hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    if cfg.query_scale:
        # Gemma-2 scales by query_pre_attn_scalar^-0.5; the attention ops
        # divide by sqrt(head_dim), so pre-multiply q by the ratio.
        q = q * float((cfg.head_dim_ / cfg.query_scale) ** 0.5)
    amp = rope_query_amp(cfg)
    if amp != 1.0:
        q = q * float(amp)  # yarn/longrope amplitude (m² on q ≡ m on cos/sin)
    return q, k, v


def _attn_out(cfg: ArchConfig, lp: Params, attn_flat: torch.Tensor,
              lora=None) -> torch.Tensor:
    """Output projection + optional gemma-2 post-attention sandwich norm."""
    a = _lora_add(cfg, lora, "wo", attn_flat, matmul(attn_flat, lp["wo"]))
    if cfg.post_norms:
        a = rms_norm(a, lp["post_attn_norm"], cfg.rms_eps)
    return a


def _mlp(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None) -> torch.Tensor:
    """Dense SwiGLU / GeGLU MLP."""
    gate = _act(cfg, _lora_add(cfg, lora, "w_gate", x, matmul(x, lp["w_gate"])))
    up = _lora_add(cfg, lora, "w_up", x, matmul(x, lp["w_up"]))
    gu = gate * up
    return _lora_add(cfg, lora, "w_down", gu, matmul(gu, lp["w_down"])).to(x.dtype)


def _mlp_out(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None) -> torch.Tensor:
    """MLP + optional gemma-2 post-feedforward sandwich norm."""
    m = _mlp(cfg, lp, x, lora)
    if cfg.post_norms:
        m = rms_norm(m, lp["post_ffw_norm"], cfg.rms_eps)
    return m


def _check_params(params: Params) -> None:
    if "dense_layers" in params or "router" in params["layers"]:
        raise NotImplementedError(
            "mixture-of-experts layers are not ported yet (ROADMAP Queue A item 16)")
    for name, t in [*params["layers"].items(), ("lm_head", params.get("lm_head"))]:
        if isinstance(t, dict) and not is_quantized(t):
            raise ValueError(f"{name}: a dict leaf must be a quantized weight, got keys "
                             f"{sorted(t)}")


def _forward_hidden(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    lengths: torch.Tensor,  # [B] int valid lengths
    collect_kv: bool,
    lora=None,  # (stacked adapter factors, ids [B]): per-row runtime LoRA
):
    """Shared full-sequence forward. Returns (h [B,S,D] after the final
    norm, length_mask [B,S], (ks, vs) [L,B,S,K,Hd] or None)."""
    check_supported(cfg)
    _check_params(params)
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    pos = torch.arange(S, device=dev)
    positions = pos[None, :].expand(B, S)
    length_mask = pos[None, :] < lengths[:, None]

    h = _embed(cfg, params, tokens)  # [B, S, D]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        llora = _layer_lora(lora, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        q, k, v = _attn_proj_qkv(cfg, lp, x, llora)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
        attn = prefill_attention(
            q, k, v, length_mask, lengths,
            softcap=cfg.attn_softcap, window=cfg.sliding_window,
            sliding=_layer_sliding(cfg, li),
        )
        h = h + _attn_out(cfg, lp, attn.reshape(B, S, -1), llora)
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, llora)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, length_mask, kv


def prefill(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    lengths: torch.Tensor,  # [B] int valid lengths
    lora=None,  # (stacked adapter factors, ids [B]): per-row runtime LoRA
):
    """Prompt processing. Returns (last_logits [B, V] f32, k [L,B,S,K,Hd], v).
    With `lora` each row adds its adapter's delta; x is 3-D here, so every
    delta takes the gather form (ops/lora_matmul.lora_delta)."""
    h, _, (ks, vs) = _forward_hidden(cfg, params, tokens, lengths, collect_kv=True, lora=lora)
    last_idx = torch.clamp(lengths.to(torch.int64) - 1, min=0)  # empty prompt reads 0
    last = h[torch.arange(h.shape[0], device=h.device), last_idx]  # [B, D]
    return _unembed(cfg, params, last), ks, vs


def decode_step_windowed(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B] current token per slot
    positions: torch.Tensor,  # [B] its position
    cache: KVCache,  # READ-ONLY within a decode block
    local_k: torch.Tensor,  # [L, B, n, K, Hd] — block-local KV window
    local_v: torch.Tensor,
    step: int,  # index within the block
    ptable: torch.Tensor | None = None,  # [B, MP] int32: `cache` is a page pool
    kv_scale: torch.Tensor | None = None,  # [2, K] f32 per-head (k, v) pool scales
    lora=None,  # (stacked adapter factors, ids [B] int32): per-slot runtime LoRA
):
    """One step of a decode block with a block-local KV window.

    The cache is never written here: each layer's new row goes into
    local_k / local_v[:, :, step] (in place), and the engine scatters the
    whole window into the cache once per block. With `ptable` the cache is
    a paged pool [L, P, page, K, Hd] and each slot reads its own pages,
    multiplied back by `kv_scale` when the pool is scaled. With `lora` each
    slot adds its adapter's delta (the ragged kernel on the card; id 0 for
    adapter-less slots).
    Returns (logits [B, V] f32, local_k, local_v)."""
    check_supported(cfg)
    _check_params(params)
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    h = _embed(cfg, params, tokens)  # [B, D]
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        llora = _layer_lora(lora, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        q, k, v = _attn_proj_qkv(cfg, lp, x, llora)  # q [B,H,Hd], k/v [B,K,Hd]
        q = apply_rope(q[:, None], positions[:, None], inv)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], inv)[:, 0]
        if ptable is not None:
            attn = decode_attention_windowed_paged(
                q, cache.k[li], cache.v[li], ptable, local_k[li], local_v[li], k, v,
                positions, step, softcap=cfg.attn_softcap,
                window=cfg.sliding_window, sliding=_layer_sliding(cfg, li), kv_scale=kv_scale,
            )
        else:
            attn = decode_attention_windowed(
                q, cache.k[li], cache.v[li], local_k[li], local_v[li], k, v,
                positions, step, softcap=cfg.attn_softcap,
                window=cfg.sliding_window, sliding=_layer_sliding(cfg, li),
            )
        h = h + _attn_out(cfg, lp, attn.reshape(B, -1), llora)
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, llora)
        local_k[li, :, step] = kv_cast(k, local_k.dtype)
        local_v[li, :, step] = kv_cast(v, local_v.dtype)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _unembed(cfg, params, h), local_k, local_v


def write_block_to_cache(
    cache: KVCache,
    local_k: torch.Tensor,  # [L, B, n, K, Hd]
    local_v: torch.Tensor,
    start_positions: torch.Tensor,  # [B] — block start per slot
) -> KVCache:
    """Scatter a decode block's local KV window into the cache, in place
    (once per block). Overshooting rows clamp to S-1 (the host discards
    those tokens)."""
    B, n = local_k.shape[1:3]
    S = cache.k.shape[2]
    dev = local_k.device
    span = torch.clamp(
        start_positions.to(torch.int64)[:, None] + torch.arange(n, device=dev)[None, :],
        max=S - 1,
    )
    bi = torch.arange(B, device=dev)[:, None]
    cache.k[:, bi, span] = kv_cast(local_k, cache.k.dtype)
    cache.v[:, bi, span] = kv_cast(local_v, cache.v.dtype)
    return cache


def write_prefill_to_cache(
    cache: KVCache,
    ks: torch.Tensor,  # [L, B_new, S, K, Hd] from prefill
    vs: torch.Tensor,
    slot: int,  # destination slot for batch row 0
) -> KVCache:
    """Copy a prefilled request's k/v (batch row 0) into its slot, in place."""
    S = ks.shape[2]
    cache.k[:, slot, :S] = kv_cast(ks[:, 0], cache.k.dtype)
    cache.v[:, slot, :S] = kv_cast(vs[:, 0], cache.v.dtype)
    return cache


# --------------------------------------------------------------------------- #
# Paged KV cache (page pool + per-slot page tables — ops/attention.py paged)
# --------------------------------------------------------------------------- #


def paged_cache_zeros(cfg: ArchConfig, num_pages: int, page_size: int, dtype=None,
                      device=None) -> KVCache:
    """Page pool: k/v [L, P, page, K, Hd]. One pool serves every slot; the
    engine assigns pages to slots and passes per-slot tables to each call,
    so device memory scales with the pages in use, not slots × max_seq.
    The engine sizes it kv_pages + 1: the last page is SCRATCH, where every
    unassigned table entry points."""
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _pool_store(rows: torch.Tensor, pool_dtype, scale_row) -> torch.Tensor:
    """KV rows [..., K, Hd] in the pool's storage dtype, divided by the
    per-head scale [K] first when the pool is scaled (stored = value /
    scale; every reader multiplies back). The division runs in f32, so bf16
    rows keep their mantissa until the final fp8 cast."""
    if scale_row is None:
        return kv_cast(rows, pool_dtype)
    return kv_cast(rows.float() / scale_row[:, None], pool_dtype)


def _scatter_rows(pool: KVCache, table, rows: torch.Tensor, ks: torch.Tensor,
                  vs: torch.Tensor, kv_scale=None) -> KVCache:
    """pool[:, table[b, row // page], row % page] = ks[:, b, i] for every
    rows[b, i], in place. Rows are clamped to the table's span."""
    page = pool.k.shape[2]
    rows = torch.clamp(rows.to(torch.int64), max=_pt.width(table) * page - 1)
    pid = _pt.gather_cols(table, rows // page)
    off = rows % page
    ksc = None if kv_scale is None else kv_scale[0]
    vsc = None if kv_scale is None else kv_scale[1]
    pool.k[:, pid, off] = _pool_store(ks, pool.k.dtype, ksc)
    pool.v[:, pid, off] = _pool_store(vs, pool.v.dtype, vsc)
    return pool


def write_block_to_pool(
    pool: KVCache,
    table: torch.Tensor,  # [B, MP] int32
    local_k: torch.Tensor,  # [L, B, n, K, Hd]
    local_v: torch.Tensor,
    start_positions: torch.Tensor,  # [B]
    kv_scale=None,  # [2, K] f32 → pool rows store value / scale
) -> KVCache:
    """Scatter a decode block's window into the page pool (once per block,
    in place). Row (b, step) lands at (table[b, row // page], row % page).
    Every slot is written: idle slots and rows past a slot's pages resolve
    through SCRATCH table entries to a page nobody attends."""
    n = local_k.shape[2]
    rows = start_positions.to(torch.int64)[:, None] + torch.arange(n, device=local_k.device)
    return _scatter_rows(pool, table, rows, local_k, local_v, kv_scale)


def write_chunk_to_pool(
    pool: KVCache,
    table: torch.Tensor,  # [B, MP] int32
    new_k: torch.Tensor,  # [L, B, T, K, Hd]
    new_v: torch.Tensor,
    positions: torch.Tensor,  # [B, T] row indices
    kv_scale=None,  # [2, K] f32 → pool rows store value / scale
) -> KVCache:
    """Scatter a chunk's rows into the page pool, in place."""
    return _scatter_rows(pool, table, positions, new_k, new_v, kv_scale)


def write_prefill_to_pool(
    pool: KVCache,
    table_row: torch.Tensor,  # [MP] int32: the destination slot's pages
    ks: torch.Tensor,  # [L, B_new, Sb, K, Hd] from prefill
    vs: torch.Tensor,
    j: int,  # batch row within ks / vs
    kv_scale=None,  # [2, K] f32 → pool rows store value / scale
) -> KVCache:
    """Copy one prefilled request's bucket of rows into its pages, in
    place. The prompt starts at row 0; bucket rows past the slot's pages
    land in SCRATCH."""
    Sb = ks.shape[2]
    rows = torch.arange(Sb, device=ks.device)[None, :]
    return _scatter_rows(pool, _pt.batch_row(table_row), rows, ks[:, j:j + 1], vs[:, j:j + 1],
                         kv_scale)


def prefill_chunk_paged(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] chunk tokens, right-padded
    lengths: torch.Tensor,  # [B] valid chunk lengths
    offsets: torch.Tensor,  # [B] rows already resident (the chunk starts here)
    pool: KVCache,
    table: torch.Tensor,  # [B, MP] int32 page tables (prefix + destination pages)
    with_logits: bool = True,
    kv_scale: torch.Tensor | None = None,  # [2, K] f32 per-head (k, v) pool scales
):
    """One chunk of a chunked prefill, written straight into the pages.

    Chunk token t attends the slot's rows [0, offsets[b]) through the paged
    partials (the ragged kernel on the card, one launch per layer) plus the
    in-chunk causal window, merged in plain PyTorch; the chunk's K/V rows
    then land in the slot's pages at rows [offsets, offsets + T), in place.
    Padding rows (t >= lengths[b]) write rows past the prompt inside the
    slot's own pages; decode overwrites each before any query reads it.
    Returns (last_logits [B, V] f32, or None when with_logits is False, and
    the pool)."""
    check_supported(cfg)
    _check_params(params)
    B, T = tokens.shape
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    offsets = offsets.to(device=dev, dtype=torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    tpos = torch.arange(T, device=dev)
    positions = offsets[:, None] + tpos[None, :]  # [B, T] global rows
    length_mask = tpos[None, :] < lengths[:, None]
    causal = tpos[None, :] <= tpos[:, None]  # [T, T]
    win_dist = tpos[:, None] - tpos[None, :]
    h = _embed(cfg, params, tokens)  # [B, T, D]
    new_k, new_v = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        sliding = _layer_sliding(cfg, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        q, k, v = _attn_proj_qkv(cfg, lp, x)  # q [B,T,H,Hd], k/v [B,T,K,Hd]
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
        wmask = causal[None] & length_mask[:, None, :]  # [B, T, T]
        if cfg.sliding_window and sliding:
            wmask = wmask & (win_dist[None] < cfg.sliding_window)
        acc, m, l = paged_prefill_partials(
            q, pool.k[li], pool.v[li], table, offsets,
            softcap=cfg.attn_softcap, window=cfg.sliding_window, sliding=sliding,
            q_pos=positions, kv_scale=kv_scale,
        )
        attn = _merge_partials_mq(q, acc, m, l, k, v, wmask, softcap=cfg.attn_softcap)
        h = h + _attn_out(cfg, lp, attn.reshape(B, T, -1).to(h.dtype))
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x)
        new_k.append(k)
        new_v.append(v)
    write_chunk_to_pool(pool, table, torch.stack(new_k), torch.stack(new_v), positions,
                        kv_scale)
    if not with_logits:
        return None, pool
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    last = h[torch.arange(B, device=dev), torch.clamp(lengths - 1, min=0)]  # [B, D]
    return _unembed(cfg, params, last), pool
