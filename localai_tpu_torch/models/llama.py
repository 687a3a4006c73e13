"""Llama-family decoder (Llama 2/3, Mistral, Qwen2, TinyLlama; Mixtral's
sparse-MoE MLP) in PyTorch (localai_tpu/models/llama.py).

- Parameters are a dict of stacked per-layer tensors ([L, ...] leading
  axis, matmul weights W [in, out]) — the JAX package's tree, so weights
  move between the two packages without reshaping (engine/weights.py).
  The JAX layer scan becomes a Python loop over the stack.
- Entry points: `prefill` (causal attention over a bucketed prompt),
  `decode_step_windowed` (one token per slot inside an N-step decode block
  whose rows ride a block-local KV window; the cache is written once per
  block), `prefill_chunk_paged` (one chunk of a long prompt, written
  straight into the slot's pages) and `prefill_tail` (a prompt's tail
  against cached prefix K/V: a dense prefix hit). Speculative decoding
  adds `decode_step` (one step on a dense cache: a draft model's, or the
  self-draft scratch over `self_draft_view`, the target's first layers)
  and `decode_chunk` (the verify pass: T tokens a slot, logits at every
  position). `encode` (mean-pooled, L2-normed embeddings) and
  `sequence_logprob` (rerank's mean conditional log-likelihood, unembedded
  in fixed chunks of rows) run the same full-sequence forward as prefill.
- Two cache layouts: a dense slot cache [L, B, S, K, Hd]
  (`write_block_to_cache`, `write_prefill_to_cache`) and a paged pool
  [L, P, page, K, Hd] shared by every slot through per-slot page tables
  (`paged_cache_zeros`, `write_block_to_pool`, `write_chunk_to_pool`,
  `write_prefill_to_pool`); only the attention call differs between them.
  The prefix cache's row movers are `write_rows_to_cache`,
  `write_rows_to_pool` (rows from any start row) and `gather_pages`.
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
- Mixture-of-experts MLP (expert stacks [L, E, in, out] beside a router
  [L, D, E]): mixtral's router (top-k of the logits, softmaxed) or
  DeepSeek-V2/V3's (softmax or sigmoid scores, a selection bias,
  group-limited top-k, `routed_scaling_factor`), with DeepSeek's
  always-on shared experts. Quantized experts take `_moe_dense` (every
  expert on every row, B3's expert form at decode), plain ones
  `_moe_ragged` (each row through its own top-k experts), as in the JAX
  package.
- DeepSeek's dense-layer prefix: the first `first_k_dense` layers live in
  params["dense_layers"] (plain MLP), the MoE layers in params["layers"];
  `_layer` hands layer li its slice of the right stack.
- Multi-head latent attention (DeepSeek-V2/V3, cfg.is_mla): the cache
  holds ONE latent row a token, [RMSNorm(c_kv) | RoPE(k_pe)] of width
  kv_lora_rank + qk_rope_head_dim, as a single kv head whose V is
  zero-width. Prefill runs full-rank MHA on the dense path; decode,
  verify, chunks and tails score the absorbed query against the latent
  rows, which serve as both K and V (B2's latent form on the paged pool),
  and W_vb lifts the result back to per-head values.

Not ported yet, and rejected with NotImplementedError: expert-parallel
capacity dispatch, sequence-parallel ring attention and tp meshes (ROADMAP
Queue A item 14, multi-GPU), and m-rope (item 13, satellite engines and
models).

Sink + window attention (`cfg.attention_sink` / `cfg.attention_window`,
which the engine sets from its EngineConfig) masks decode and the
chunked-prefill prefix walk, as in the JAX package; the paged pool's
tables may be flat or hierarchical (ops/ptable) everywhere a table goes.

The cache, the pool and the block-local windows are updated IN PLACE (the
JAX package returns new arrays): that saves a full copy of each per call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.quant import is_quantized, matmul, moe_matmul, unembed_matmul
from localai_tpu_torch.ops import ptable as _pt
from localai_tpu_torch.ops.lora_matmul import lora_deltas
from localai_tpu_torch.ops.attention import (
    _merge_partials_mq,
    decode_attention_windowed,
    decode_attention_windowed_paged,
    paged_prefill_partials,
    prefill_attention,
)
from localai_tpu_torch.ops.norm import rms_norm
from localai_tpu_torch.ops.quant_matmul import (
    MOE_PER_EXPERT,
    MOE_SHARED,
    QUANT_KERNEL_MAX_ROWS,
)
from localai_tpu_torch.ops.rope import (
    apply_rope,
    mrope_angles,
    rope_frequencies,
    rope_frequencies_local,
    rope_query_amp,
    rope_rotate,
)

Params = dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the architecture features this port does not serve yet."""
    if cfg.is_moe and cfg.moe_family not in ("mixtral", "deepseek"):
        raise ValueError(f"unknown mixture-of-experts family {cfg.moe_family!r}")


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
    page pool [L, P, page, K_heads, head_dim] (`paged_cache_zeros`). Under
    MLA k holds the latent rows [..., 1, kv_lora_rank + rope] and v is
    zero-width: the cfg's cache_kv_heads / cache_k_dim / cache_v_dim."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: ArchConfig, num_slots: int, max_seq: int, dtype=None,
              device=None) -> "KVCache":
        dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
        device = resolve_device(device)
        return _cache_zeros(cfg, (cfg.num_layers, num_slots, max_seq), dtype, device)


def _cache_zeros(cfg: ArchConfig, lead: tuple, dtype, device) -> KVCache:
    base = (*lead, cfg.cache_kv_heads)
    return KVCache(k=torch.zeros((*base, cfg.cache_k_dim), dtype=dtype, device=device),
                   v=torch.zeros((*base, cfg.cache_v_dim), dtype=dtype, device=device))


def _attn_specs(cfg: ArchConfig, L: int) -> dict:
    """Attention and norm leaves of a stack of L layers, standard or MLA
    (the JAX package's _init_attn_layers)."""
    D = cfg.hidden_size
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layers = {"attn_norm": ((L, D), "ones"), "mlp_norm": ((L, D), "ones")}
    if cfg.is_mla:
        r, rot = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        n, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            layers["wq_a"] = ((L, D, cfg.q_lora_rank), "normal")
            layers["q_norm_a"] = ((L, cfg.q_lora_rank), "ones")
            layers["wq_b"] = ((L, cfg.q_lora_rank, H * (n + rot)), "normal")
        else:
            layers["wq"] = ((L, D, H * (n + rot)), "normal")
        layers["wkv_a"] = ((L, D, r + rot), "normal")
        layers["kv_norm"] = ((L, r), "ones")
        # HF kv_b_proj [H·(n+v), r] split per head, in HF's [out, in]
        # orientation: the absorbed einsums contract the shared r axis.
        layers["w_kb"] = ((L, H, n, r), "normal")
        layers["w_vb"] = ((L, H, vd, r), "normal")
        layers["wo"] = ((L, H * vd, D), "normal")
        return layers
    layers.update({"wq": ((L, D, H * Hd), "normal"), "wk": ((L, D, K * Hd), "normal"),
                   "wv": ((L, D, K * Hd), "normal"), "wo": ((L, H * Hd, D), "normal")})
    if cfg.post_norms:
        layers["post_attn_norm"] = layers["post_ffw_norm"] = ((L, D), "ones")
    if cfg.qk_norm:
        layers["q_norm"] = layers["k_norm"] = ((L, Hd), "ones")
    if cfg.attn_qkv_bias:
        layers["bq"] = ((L, H * Hd), "zeros")
        layers["bk"] = layers["bv"] = ((L, K * Hd), "zeros")
    return layers


def _dense_mlp_specs(cfg: ArchConfig, L: int) -> dict:
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    return {"w_gate": ((L, D, F_), "normal"), "w_up": ((L, D, F_), "normal"),
            "w_down": ((L, F_, D), "normal")}


def param_specs(cfg: ArchConfig) -> dict:
    """The parameter tree's leaves as (shape, "normal" | "ones" | "zeros"
    | "zeros_f32"), {"layers": {name: ...}} for the stacked layer tensors
    and, for a DeepSeek dense-layer prefix, {"dense_layers": {...}}: the
    JAX package's tree structure."""
    check_supported(cfg)
    L, D = cfg.num_layers, cfg.hidden_size
    kd = cfg.first_k_dense if cfg.is_moe else 0
    Lm = L - kd
    layers = _attn_specs(cfg, Lm)
    if cfg.is_moe:  # expert stacks [L, E, in, out] beside the router
        E, Fm = cfg.num_experts, cfg.moe_inter_size
        layers["router"] = ((Lm, D, E), "normal")
        if cfg.router_bias:
            layers["router_bias"] = ((Lm, E), "zeros_f32")
        layers["w_gate"] = layers["w_up"] = ((Lm, E, D, Fm), "normal")
        layers["w_down"] = ((Lm, E, Fm, D), "normal")
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fm
            layers["shared_gate"] = layers["shared_up"] = ((Lm, D, Fs), "normal")
            layers["shared_down"] = ((Lm, Fs, D), "normal")
    else:
        layers.update(_dense_mlp_specs(cfg, L))
    specs = {"embed": ((cfg.vocab_size, D), "normal"), "layers": layers,
             "final_norm": ((D,), "ones")}
    if kd:
        specs["dense_layers"] = {**_attn_specs(cfg, kd), **_dense_mlp_specs(cfg, kd)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((cfg.vocab_size, D), "normal")
    return specs


_STACKS = ("layers", "dense_layers")
# Leaves of more elements than this (4 GiB of f32) are drawn layer by layer.
_WHOLE_DRAW = 1 << 30


def init_params(cfg: ArchConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Params:
    """Random init (normal · scale) with the JAX package's tree structure,
    drawn from a torch.Generator seeded with `seed` on `device`."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(shape, kind):
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if kind == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if kind == "zeros_f32":  # the router's selection bias stays f32
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if math.prod(shape) <= _WHOLE_DRAW:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return (w * scale).to(dt)
        # A large stack is drawn one layer at a time: the f32 draw of a
        # whole expert stack would double the peak (19 GB for
        # deepseek-v2-lite's w_gate beside its 31 GB of weights).
        out = torch.empty(shape, dtype=dt, device=device)
        for li in range(shape[0]):
            w = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=device)
            out[li] = (w * scale).to(dt)
        return out

    # The layer stack is drawn first, then the other leaves in spec order.
    specs = param_specs(cfg)
    layers = {k: leaf(*v) for k, v in specs.pop("layers").items()}
    params = {name: ({k: leaf(*v) for k, v in spec.items()} if name in _STACKS
                     else leaf(*spec))
              for name, spec in specs.items()}
    return {"embed": params.pop("embed"), "layers": layers, **params}


def _n_dense(params: Params) -> int:
    """Layers in the tree's dense-layer prefix (0 without one)."""
    dense = params.get("dense_layers")
    return 0 if dense is None else dense["attn_norm"].shape[0]


def _layer(params: Params, li: int) -> Params:
    """Layer li's slice of every stacked tensor, quantized dicts leaf by
    leaf ({"q": [L, in, out], "s": [L, 1, out]} → layer li's views). With a
    dense-layer prefix, layers [0, first_k_dense) read params["dense_layers"]
    and the rest params["layers"], shifted down by the prefix."""
    kd = _n_dense(params)
    stack, i = (params["dense_layers"], li) if li < kd else (params["layers"], li - kd)
    return {name: ({k: v[i] for k, v in t.items()} if isinstance(t, dict) else t[i])
            for name, t in stack.items()}


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


def _lora_add(lora, keys, x: torch.Tensor, ys: list) -> list:
    """ys[i] + the per-row adapter delta of target keys[i], for targets that
    share the input x (q / k / v, gate / up, or one key alone): unmerged
    B·(A·x) beside each base product, so the base weights stay shared (and
    possibly quantized) while each row rides its tenant's factors. lora =
    (this layer's stacks {key: {"a": [NA, in, R], "b": [NA, R, out]}}, ids
    [B]) or None; id 0 is the all-zero null adapter. The keys present in the
    stacks go to one grouped call (one kernel launch at decode); absent keys
    keep their base product. Each delta is rounded to x.dtype before the
    add, as in the JAX package, and is what its key would get alone."""
    if lora is None:
        return ys
    stacks, ids = lora
    present = [i for i, k in enumerate(keys) if k in stacks]
    if not present:
        return ys
    deltas = lora_deltas(x, [stacks[keys[i]] for i in present], ids)
    ys = list(ys)
    for i, d in zip(present, deltas):
        ys[i] = ys[i] + d
    return ys


def _layer_lora(lora, li: int):
    """Layer li's slice of the stacked adapter factors, with the ids."""
    if lora is None:
        return None
    stacks, ids = lora
    return {k: {"a": e["a"][li], "b": e["b"][li]} for k, e in stacks.items()}, ids


def _attn_proj_qkv(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None):
    """x: [..., D] -> q [..., H, Hd], k/v [..., K, Hd]."""
    H, K, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = _lora_add(lora, ("wq", "wk", "wv"), x,
                        [matmul(x, lp["wq"]), matmul(x, lp["wk"]), matmul(x, lp["wv"])])
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
    (a,) = _lora_add(lora, ("wo",), attn_flat, [matmul(attn_flat, lp["wo"])])
    if cfg.post_norms:
        a = rms_norm(a, lp["post_attn_norm"], cfg.rms_eps)
    return a


def _top_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of x along its last axis, largest first;
    ties go to the lower index, as jax.lax.top_k breaks them: a stable
    descending sort, whose order is the same on the CPU and the card, eager
    and in a graph (torch.topk's is unspecified)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _moe_route(cfg: ArchConfig, lp: Params, x: torch.Tensor):
    """Top-k router: (weights [..., k] f32, sel [..., k] int64). Mixtral's
    is the top-k of the logits x @ router (in x's dtype, then f32),
    softmaxed over the k; the deepseek family takes `_deepseek_route`."""
    if cfg.moe_family == "deepseek":
        return _deepseek_route(cfg, lp, x)
    logits = (x @ lp["router"]).float()  # [..., E]
    sel = _top_idx(logits, cfg.num_experts_per_token)
    return torch.softmax(torch.gather(logits, -1, sel), dim=-1), sel


def _deepseek_route(cfg: ArchConfig, lp: Params, x: torch.Tensor):
    """DeepSeek-V2/V3's router (HF DeepseekV2MoEGate / DeepseekV3TopkRouter):
    every expert scored in f32, softmax (V2) or sigmoid (V3); the selection
    adds the learned `router_bias` but the weights are the unbiased scores;
    with n_group > 1 only the topk_group best groups compete (V2 scores a
    group by its max, V3 by the sum of its top 2). The weights come back
    renormalized when norm_topk_prob, and scaled by routed_scaling_factor:
    the softmax route's normalization replaces the scaling, the sigmoid
    route does both. Ties go to the lower id, in the groups and the
    experts alike."""
    E, k = cfg.num_experts, cfg.num_experts_per_token
    logits = x.float() @ lp["router"].float()  # [..., E]
    sigmoid = cfg.scoring_func == "sigmoid"
    scores = torch.sigmoid(logits) if sigmoid else torch.softmax(logits, dim=-1)
    choice = scores + lp["router_bias"].float() if "router_bias" in lp else scores
    if cfg.n_group > 1:
        g = cfg.n_group
        cg = choice.reshape(*choice.shape[:-1], g, E // g)
        if sigmoid:  # V3: a group's score is the sum of its top-2 biased scores
            top2 = torch.sort(cg, dim=-1, descending=True, stable=True).values
            gscore = top2[..., 0] + top2[..., 1]
        else:  # V2's group-limited greedy: the group's max
            gscore = cg.amax(dim=-1)
        gidx = _top_idx(gscore, cfg.topk_group)  # [..., topk_group]
        keep = torch.zeros_like(gscore, dtype=torch.bool).scatter_(-1, gidx, True)
        choice = torch.where(keep.repeat_interleave(E // g, dim=-1), choice, 0.0)
    sel = _top_idx(choice, k)
    weights = torch.gather(scores, -1, sel)
    if cfg.norm_topk_prob and k > 1:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        if sigmoid:
            weights = weights * cfg.routed_scaling_factor
    else:
        weights = weights * cfg.routed_scaling_factor
    return weights, sel


def _moe_dense(cfg: ArchConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """All-experts MoE: every expert runs on every row (B3's expert form at
    decode, one launch a projection; the dequantize-then-matmul forms
    above 256 rows) and the rows combine their top-k experts' outputs by
    routing weight, in f32. The JAX package's route for quantized
    experts."""
    weights, sel = _moe_route(cfg, lp, x)
    combine = torch.zeros((*sel.shape[:-1], cfg.num_experts), dtype=torch.float32,
                          device=x.device).scatter_add_(-1, sel, weights)  # [..., E]
    gate = _act(cfg, moe_matmul(x, lp["w_gate"], MOE_SHARED))
    up = moe_matmul(x, lp["w_up"], MOE_SHARED)
    expert_out = moe_matmul(gate * up, lp["w_down"], MOE_PER_EXPERT)  # [..., E, D]
    return torch.einsum("...ed,...e->...d", expert_out.float(), combine).to(x.dtype)


def _expert_rows(xs: torch.Tensor, w: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """Row m of xs [M, in] times its own expert's w[eid[m]] (w [E, in, out])
    → [M, out]: lax.ragged_dot's function in fixed shapes, every expert's
    product of the rows and then each row's own, so nothing reads a group
    size back to the host and a decode block can be captured as a graph.
    One batched matmul over the experts with the rows broadcast: an einsum
    of this signature folds E into the output columns and copies the whole
    stack into that layout first (three times the weight bytes a call)."""
    every = torch.bmm(xs.unsqueeze(0).expand(w.shape[0], -1, -1), w)  # [E, M, out]
    return every[eid, torch.arange(xs.shape[0], device=xs.device)]


def _sorted_expert_rows(xg: torch.Tensor, lp: Params, cfg: ArchConfig,
                        eid: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU of each pair row xg[m] through expert eid[m],
    computing only each pair's own expert: the pairs are stably sorted by
    expert, each expert's contiguous group goes through its weights (one
    matmul a projection, lax.ragged_dot's function), and the outputs come
    back in pair order. The group sizes are read back to the host, so
    this serves eager calls only (admissions and chunks)."""
    order = torch.argsort(eid, stable=True)
    counts = torch.bincount(eid, minlength=cfg.num_experts).tolist()
    xs = xg[order]
    outs, lo = [], 0
    for e, c in enumerate(counts):
        if c:
            seg = xs[lo:lo + c]
            gu = _act(cfg, seg @ lp["w_gate"][e]) * (seg @ lp["w_up"][e])
            outs.append(gu.to(xs.dtype) @ lp["w_down"][e])
            lo += c
    dn = torch.empty((xg.shape[0], lp["w_down"].shape[-1]), dtype=xg.dtype, device=xg.device)
    dn[order] = torch.cat(outs)
    return dn


# Above this many rows an eager `_moe_ragged` computes only each pair's
# own expert (the sorted route); at or below it, every expert's product of
# the rows. The threshold is B3's (ops/quant_matmul.QUANT_KERNEL_MAX_ROWS).
MOE_SORTED_MIN_ROWS = QUANT_KERNEL_MAX_ROWS


def _moe_ragged(cfg: ArchConfig, lp: Params, x: torch.Tensor, eager: bool = False) -> torch.Tensor:
    """Exact top-k MoE for plain expert weights (the JAX package's
    sort + lax.ragged_dot route): each (row, choice) pair runs its expert's
    SwiGLU, and a row adds its k outputs times their routing weights in
    f32, in choice order. The pairs go through `_expert_rows` (fixed
    shapes, no host read, so decode blocks and verify rounds of any row
    count can be captured as graphs). `eager` is the caller's word that it
    runs outside a graph (admissions and prefill chunks): above
    MOE_SORTED_MIN_ROWS rows such a call takes `_sorted_expert_rows`,
    E / k times less work (10.7x at 64 experts, top 6). Both give each
    pair the same row product, so the sum over k is the same on either
    route."""
    k = cfg.num_experts_per_token
    lead, D = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, D)
    weights, sel = _moe_route(cfg, lp, xf)  # [N, k]
    xg = xf.repeat_interleave(k, dim=0)  # [N·k, D]: row n's choices side by side
    eid = sel.reshape(-1)
    if eager and xf.shape[0] > MOE_SORTED_MIN_ROWS:
        dn = _sorted_expert_rows(xg, lp, cfg, eid)
    else:
        gate = _act(cfg, _expert_rows(xg, lp["w_gate"], eid))
        up = _expert_rows(xg, lp["w_up"], eid)
        dn = _expert_rows((gate * up).to(xg.dtype), lp["w_down"], eid)  # [N·k, D]
    y = (dn.float() * weights.reshape(-1, 1)).reshape(-1, k, D).sum(dim=1)
    return y.reshape(*lead, D).to(x.dtype)


def _mlp(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None,
         eager: bool = False) -> torch.Tensor:
    """SwiGLU / GeGLU MLP, dense or mixture-of-experts ("router" in the
    layer, so a DeepSeek dense-prefix layer takes the plain branch):
    quantized expert stacks take the all-experts `_moe_dense`, plain ones
    the exact top-k `_moe_ragged`, as the JAX package picks; DeepSeek's
    MoE layers add the always-on shared-expert MLP. Runtime LoRA serves
    dense layers only (the engine refuses adapters on an MoE base).
    `eager`: the caller runs outside a CUDA graph (see `_moe_ragged`)."""
    if "router" in lp:
        y = (_moe_dense(cfg, lp, x) if isinstance(lp["w_gate"], dict)
             else _moe_ragged(cfg, lp, x, eager))
        if "shared_gate" in lp:
            sg = _act(cfg, matmul(x, lp["shared_gate"]))
            y = y + matmul(sg * matmul(x, lp["shared_up"]), lp["shared_down"]).to(x.dtype)
        return y
    gate, up = _lora_add(lora, ("w_gate", "w_up"), x,
                         [matmul(x, lp["w_gate"]), matmul(x, lp["w_up"])])
    gu = _act(cfg, gate) * up
    (down,) = _lora_add(lora, ("w_down",), gu, [matmul(gu, lp["w_down"])])
    return down.to(x.dtype)


def _mlp_out(cfg: ArchConfig, lp: Params, x: torch.Tensor, lora=None,
             eager: bool = False) -> torch.Tensor:
    """MLP + optional gemma-2 post-feedforward sandwich norm."""
    m = _mlp(cfg, lp, x, lora, eager)
    if cfg.post_norms:
        m = rms_norm(m, lp["post_ffw_norm"], cfg.rms_eps)
    return m


# --------------------------------------------------------------------------- #
# Multi-head latent attention (DeepSeek-V2/V3; the JAX package's MLA helpers)
#
# Prefill runs full-rank: per-head k = [W_kb·c_kv | rope(k_pe)] and
# v = W_vb·c_kv. Every other entry point runs the absorbed identity
# q·k = [W_kbᵀ q_nope | q_pe]·[c_kv | k_pe]: attention is MQA against the
# cached latent rows, which also serve as the value operand (the output's
# first kv_lora_rank dims are probs·c_kv, which W_vb lifts back to per-head
# values). One latent row a token is all the cache holds.
# --------------------------------------------------------------------------- #


def _mla_q(cfg: ArchConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """Query projection [..., H, qk_head_dim] (nope | rope, before the
    rope), through the q-lora bottleneck (V3) or direct (V2-Lite)."""
    if cfg.q_lora_rank:
        ql = rms_norm(matmul(x, lp["wq_a"]), lp["q_norm_a"], cfg.rms_eps)
        q = matmul(ql, lp["wq_b"])
    else:
        q = matmul(x, lp["wq"])
    return q.reshape(*x.shape[:-1], cfg.num_heads, cfg.qk_head_dim)


def _mla_rows(cfg: ArchConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    """Latent cache rows [B, T, 1, r+rot] = [RMSNorm(c_kv) | RoPE(k_pe)] of
    x [B, T, D] at positions [B, T]: all that MLA writes to the cache."""
    r = cfg.kv_lora_rank
    ckv = matmul(x, lp["wkv_a"])  # [B, T, r+rot]
    c = rms_norm(ckv[..., :r], lp["kv_norm"], cfg.rms_eps)
    k_pe = apply_rope(ckv[..., None, r:], positions, inv)  # [B, T, 1, rot]
    return torch.cat([c[..., None, :], k_pe], dim=-1)


def _mla_full_qkv(cfg: ArchConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                  inv: torch.Tensor):
    """Full-rank projections for prefill: x [B, T, D] → (q, k [B, T, H, Dq],
    v [B, T, H, Dq] zero-padded from v_head_dim, rows [B, T, 1, r+rot]).
    The attention op keeps q's head width, so v rides zero-padded and the
    caller slices [..., :v_head_dim]."""
    H = cfg.num_heads
    n, rot, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q = _mla_q(cfg, lp, x)
    q = torch.cat([q[..., :n], apply_rope(q[..., n:], positions, inv)], dim=-1)
    amp = rope_query_amp(cfg)
    if amp != 1.0:
        q = q * float(amp)
    rows = _mla_rows(cfg, lp, x, positions, inv)
    c, k_pe = rows[..., 0, :r], rows[..., :, r:]  # [B, T, r], [B, T, 1, rot]
    k_nope = torch.einsum("btr,hnr->bthn", c, lp["w_kb"]).to(x.dtype)
    k = torch.cat([k_nope, k_pe.expand(*k_pe.shape[:2], H, rot).to(x.dtype)], dim=-1)
    v = torch.einsum("btr,hvr->bthv", c, lp["w_vb"]).to(x.dtype)
    v = F.pad(v, (0, cfg.qk_head_dim - vd))
    return q, k, v, rows


def _mla_absorbed_q(cfg: ArchConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                    inv: torch.Tensor) -> torch.Tensor:
    """Absorbed query [B, T, H, r+rot] that scores the latent rows directly.
    The attention ops scale by the operand width (r+rot), so the ratio
    sqrt((r+rot)/qk_head_dim) is folded in here, with the rope scaling's
    amplitude, to give the true 1/sqrt(qk_head_dim) softmax scale."""
    n = cfg.qk_nope_head_dim
    q = _mla_q(cfg, lp, x)
    q_pe = apply_rope(q[..., n:], positions, inv)
    q_lat = torch.einsum("bthn,hnr->bthr", q[..., :n], lp["w_kb"]).to(x.dtype)
    q_eff = torch.cat([q_lat, q_pe.to(x.dtype)], dim=-1)
    scale = ((cfg.kv_lora_rank + cfg.qk_rope_head_dim) / cfg.qk_head_dim) ** 0.5
    # The factor is rounded to x's dtype first, as the JAX package's is.
    return q_eff * torch.tensor(scale * rope_query_amp(cfg), dtype=x.dtype).item()


def _mla_unlatent(cfg: ArchConfig, lp: Params, attn: torch.Tensor) -> torch.Tensor:
    """Absorbed attention output [..., H, r+rot] → per-head values
    [..., H·v_head_dim] through W_vb (the deferred value up-projection)."""
    lat = attn[..., :cfg.kv_lora_rank]
    out = torch.einsum("...hr,hvr->...hv", lat, lp["w_vb"].to(lat.dtype))
    return out.reshape(*attn.shape[:-2], -1)


def _mla_step_rows(cfg: ArchConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                   inv: torch.Tensor):
    """One token a slot (x [B, D], positions [B]): the absorbed query
    [B, H, r+rot] and the latent row [B, 1, r+rot]."""
    x1, p1 = x[:, None], positions[:, None]
    return (_mla_absorbed_q(cfg, lp, x1, p1, inv)[:, 0],
            _mla_rows(cfg, lp, x1, p1, inv)[:, 0])


def _mla_latent_attention(q_eff: torch.Tensor, prefix: torch.Tensor, pvalid: torch.Tensor,
                          rows: torch.Tensor, wmask: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of q_eff [B, T, H, De] over dense latent prefix
    rows [B, P, 1, De] (valid where pvalid [B, 1|T, P]) and the window's own
    rows [B, T, 1, De] (causal mask wmask, broadcastable to [B, 1, T, T]),
    one softmax over both, in f32 (the JAX package's XLA numerics).
    Returns [B, T, H, De] f32."""
    De = q_eff.shape[-1]
    qf = q_eff.float() / De ** 0.5
    kcf = prefix[..., 0, :].float()  # [B, P, De]
    rf = rows[..., 0, :].float()  # [B, T, De]
    sc = torch.einsum("bthd,bsd->bhts", qf, kcf)
    sc = torch.where(pvalid[:, None], sc, -1e30)
    sw = torch.einsum("bthd,bud->bhtu", qf, rf)
    sw = torch.where(wmask, sw, -1e30)
    P = kcf.shape[1]
    probs = torch.softmax(torch.cat([sc, sw], dim=-1), dim=-1)
    return (torch.einsum("bhts,bsd->bthd", probs[..., :P], kcf)
            + torch.einsum("bhtu,bud->bthd", probs[..., P:], rf))


def _check_params(cfg: ArchConfig, params: Params) -> None:
    if ("router" in params["layers"]) != cfg.is_moe:
        raise ValueError(f"{cfg.name}: the tree's layers "
                         f"{'have' if 'router' in params['layers'] else 'lack'} a router, the "
                         f"config has {cfg.num_experts} experts")
    kd = cfg.first_k_dense if cfg.is_moe else 0
    if _n_dense(params) != kd:
        raise ValueError(f"{cfg.name}: the tree has {_n_dense(params)} dense-prefix layers, "
                         f"the config {kd}")
    if ("wkv_a" in params["layers"]) != cfg.is_mla:
        raise ValueError(f"{cfg.name}: the tree's attention is "
                         f"{'MLA' if 'wkv_a' in params['layers'] else 'per-head'}, the "
                         f"config's kv_lora_rank is {cfg.kv_lora_rank}")
    leaves = [*params["layers"].items(), *params.get("dense_layers", {}).items(),
              ("lm_head", params.get("lm_head"))]
    for name, t in leaves:
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
    inject=None,  # (embeds [B, N, D], offsets [B]): VLM image features
    mrope=None,  # [B, 3, S] (t, h, w) position streams: Qwen2-VL m-rope
):
    """Shared full-sequence forward. Returns (h [B,S,D] after the final
    norm, length_mask [B,S], (ks, vs) [L,B,S,K,Hd] or None). Under MLA the
    attention is full-rank MHA on the dense path (no `lengths`, so no flash
    kernel: B1 takes head widths 64 / 128 and MLA's qk width is 192, as
    the JAX package's Pallas kernel tiles 128 lanes), and the K/V rows are
    the latents (rows, rows[..., :0]). `inject` overwrites each row's
    placeholder span [offset, offset + N) of the embeddings with projected
    image features (the start clamped so the span fits, as XLA's
    dynamic_update_slice); `mrope` rotates q and k of every layer by the
    section-selected stream angles (ops/rope.mrope_angles) in place of the
    row positions."""
    check_supported(cfg)
    _check_params(cfg, params)
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    pos = torch.arange(S, device=dev)
    positions = pos[None, :].expand(B, S)
    length_mask = pos[None, :] < lengths[:, None]
    mrope_ang = None
    if mrope is not None:
        if not cfg.mrope_section:
            raise ValueError("mrope positions passed but cfg.mrope_section empty")
        if inv_local is not None:
            raise ValueError("mrope + per-layer local rope is unsupported")
        mrope_ang = mrope_angles(mrope, inv_freq, tuple(cfg.mrope_section))

    h = _embed(cfg, params, tokens)  # [B, S, D]
    if inject is not None:
        embeds, offsets = inject
        N = embeds.shape[1]
        start = torch.clamp(offsets.to(torch.int64), 0, S - N)
        idx = (start[:, None] + torch.arange(N, device=dev))[..., None].expand(B, N, h.shape[-1])
        h = h.scatter(1, idx, embeds.to(h.dtype))
    ks, vs = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        llora = _layer_lora(lora, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        if cfg.is_mla:
            q, k, v, rows = _mla_full_qkv(cfg, lp, x, positions, inv)
            attn = prefill_attention(q, k, v, length_mask)[..., :cfg.v_head_dim]
            k, v = rows, rows[..., :0]
        else:
            q, k, v = _attn_proj_qkv(cfg, lp, x, llora)
            if mrope_ang is not None:
                q = rope_rotate(q, mrope_ang)
                k = rope_rotate(k, mrope_ang)
            else:
                q = apply_rope(q, positions, inv)
                k = apply_rope(k, positions, inv)
            attn = prefill_attention(
                q, k, v, length_mask, lengths,
                softcap=cfg.attn_softcap, window=cfg.sliding_window,
                sliding=_layer_sliding(cfg, li),
            )
        h = h + _attn_out(cfg, lp, attn.reshape(B, S, -1), llora)
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, llora, eager=True)
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
    inject=None,  # (embeds [B, N, D], offsets [B]): VLM image features
    mrope=None,  # [B, 3, S] m-rope position streams (Qwen2-VL)
):
    """Prompt processing. Returns (last_logits [B, V] f32, k [L,B,S,K,Hd], v).
    With `lora` each row adds its adapter's delta; x is 3-D here, so every
    delta takes the gather form (ops/lora_matmul.lora_deltas). `inject` and
    `mrope` as _forward_hidden."""
    h, _, (ks, vs) = _forward_hidden(cfg, params, tokens, lengths, collect_kv=True, lora=lora,
                                     inject=inject, mrope=mrope)
    last_idx = torch.clamp(lengths.to(torch.int64) - 1, min=0)  # empty prompt reads 0
    last = h[torch.arange(h.shape[0], device=h.device), last_idx]  # [B, D]
    return _unembed(cfg, params, last), ks, vs


def encode(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    lengths: torch.Tensor,  # [B] int valid lengths
) -> torch.Tensor:
    """Sentence embeddings [B, D] f32: the masked mean-pool of the final
    hidden state, L2-normalised (norm floored at 1e-9). An empty row pools
    to zero."""
    h, length_mask, _ = _forward_hidden(cfg, params, tokens, lengths, collect_kv=False)
    mask = length_mask[..., None].float()
    pooled = (h.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


# Rows of logits sequence_logprob materialises at once: 256 rows keep a
# quantized head on B4 (its ≤ 256-row dispatch), and cost 256 · V · 4 B,
# 131 MB at V = 128256.
LOGPROB_CHUNK_ROWS = 256


def sequence_logprob(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    lengths: torch.Tensor,  # [B] int total valid lengths
    cond_lengths: torch.Tensor,  # [B] int: score only positions >= cond_len
) -> torch.Tensor:
    """Mean log P(tokens[cond:len] | tokens[:cond]) per row, [B] f32 (the
    rerank score).

    The reference unembeds every position into [B, S-1, V] f32 and takes
    log_softmax of it all (4.19 GB at 16 × 512 on a 128256 vocab). Here
    only the scored positions are unembedded, LOGPROB_CHUNK_ROWS at a time: each
    chunk's f32 logits (softcapped where the config says) give the
    target's logit minus the logsumexp. Peak extra memory is about two
    chunks of logits, LOGPROB_CHUNK_ROWS · V · 4 B each (131 MB at
    V = 128256), whatever the batch or the bucket. A row with no scored
    position scores 0."""
    h, _, _ = _forward_hidden(cfg, params, tokens, lengths, collect_kv=False)
    B, S = tokens.shape
    dev = tokens.device
    pos = torch.arange(1, S, device=dev)[None, :]  # the position of each target token
    valid = (pos >= cond_lengths.to(dev)[:, None]) & (pos < lengths.to(dev)[:, None])
    rows = valid.reshape(-1).nonzero()[:, 0]  # h[:, :-1] rows that predict a scored token
    hs = h[:, :-1].reshape(B * (S - 1), -1)
    tgt = tokens[:, 1:].reshape(-1)
    tok_lp = torch.zeros(B * (S - 1), dtype=torch.float32, device=dev)
    chunk = LOGPROB_CHUNK_ROWS
    for i in range(0, rows.numel(), chunk):
        r = rows[i:i + chunk]
        logits = _unembed(cfg, params, hs[r])  # [c, V] f32
        picked = logits.gather(-1, tgt[r][:, None])[:, 0]
        tok_lp[r] = picked - torch.logsumexp(logits, dim=-1)
    n = valid.sum(dim=-1).clamp(min=1)
    return tok_lp.reshape(B, S - 1).sum(dim=-1) / n


def prefill_tail(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] tail tokens, right-padded
    lengths: torch.Tensor,  # [B] valid tail lengths
    offsets: torch.Tensor,  # [B] cached-prefix lengths (the tail starts here)
    prefix_k: torch.Tensor,  # [L, B, P, K, Hd] cached prefix KV; rows >= offsets[b] ignored
    prefix_v: torch.Tensor,
):
    """Prefill a prompt tail against cached prefix K/V: the compute half of
    the prefix cache. Tail token t attends the prefix rows [0, offsets[b])
    plus the tail causally, in one softmax over both (plain PyTorch, f32
    scores, the JAX package's XLA numerics); RoPE positions start at the
    offset, so the result is the whole prompt's prefill. Sliding layers and
    softcaps are applied as in `prefill`. Returns (last_logits [B, V] f32,
    tail_ks [L, B, T, K, Hd], tail_vs)."""
    check_supported(cfg)
    _check_params(cfg, params)
    B, T = tokens.shape
    P = prefix_k.shape[2]
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    offsets = offsets.to(device=dev, dtype=torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    tpos = torch.arange(T, device=dev)
    positions = offsets[:, None] + tpos[None, :]  # [B, T] global
    length_mask = tpos[None, :] < lengths[:, None]
    causal = tpos[None, :] <= tpos[:, None]  # [T, T]
    win_dist = tpos[:, None] - tpos[None, :]
    pvalid = torch.arange(P, device=dev)[None, :] < offsets[:, None]  # [B, P]
    scale = cfg.head_dim_ ** -0.5
    h = _embed(cfg, params, tokens)  # [B, T, D]
    new_k, new_v = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        sliding = _layer_sliding(cfg, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        if cfg.is_mla:
            # The absorbed identity holds for the tail's own tokens too, so
            # both segments score in latent space.
            q_eff = _mla_absorbed_q(cfg, lp, x, positions, inv)  # [B, T, H, De]
            rows = _mla_rows(cfg, lp, x, positions, inv)  # [B, T, 1, De]
            wm = causal[None, None] & length_mask[:, None, None, :]
            attn = _mla_latent_attention(q_eff, prefix_k[li], pvalid[:, None], rows, wm)
            h = h + _attn_out(cfg, lp, _mla_unlatent(cfg, lp, attn.to(h.dtype)))
            x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
            h = h + _mlp_out(cfg, lp, x, eager=True)
            new_k.append(rows)
            new_v.append(rows[..., :0])
            continue
        q, k, v = _attn_proj_qkv(cfg, lp, x)  # q [B,T,H,Hd], k/v [B,T,K,Hd]
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
        kc, vc = prefix_k[li].float(), prefix_v[li].float()  # [B, P, K, Hd]
        Kh = kc.shape[2]
        G = q.shape[2] // Kh
        qf = (q.float() * scale).reshape(B, T, Kh, G, cfg.head_dim_)
        sc = torch.einsum("btkgd,bskd->bkgts", qf, kc)
        sw = torch.einsum("btkgd,bukd->bkgtu", qf, k.float())
        if cfg.attn_softcap:
            sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
            sw = cfg.attn_softcap * torch.tanh(sw / cfg.attn_softcap)
        pmask = pvalid[:, None, :]  # [B, 1, P]
        cmask = causal
        if cfg.sliding_window and sliding:
            dist = positions[:, :, None] - torch.arange(P, device=dev)[None, None, :]
            pmask = pmask & (dist < cfg.sliding_window)
            cmask = cmask & (win_dist < cfg.sliding_window)
        sc = torch.where(pmask[:, None, None], sc, -1e30)
        wmask = cmask[None] & length_mask[:, None, :]  # [B, T, T]
        sw = torch.where(wmask[:, None, None], sw, -1e30)
        probs = torch.softmax(torch.cat([sc, sw], dim=-1), dim=-1)
        attn = (torch.einsum("bkgts,bskd->btkgd", probs[..., :P], vc)
                + torch.einsum("bkgtu,bukd->btkgd", probs[..., P:], v.float()))
        h = h + _attn_out(cfg, lp, attn.reshape(B, T, -1).to(h.dtype))
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, eager=True)
        new_k.append(k)
        new_v.append(v)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    last = h[torch.arange(B, device=dev), torch.clamp(lengths - 1, min=0)]  # [B, D]
    return _unembed(cfg, params, last), torch.stack(new_k), torch.stack(new_v)


def decode_step_windowed(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B] current token per slot
    positions: torch.Tensor,  # [B] its position
    cache: KVCache,  # READ-ONLY within a decode block
    local_k: torch.Tensor,  # [L, B, n, K, Hd] — block-local KV window
    local_v: torch.Tensor,
    step: int,  # index within the block
    ptable=None,  # [B, MP] int32 or the (l1, l0) pair: `cache` is a page pool
    kv_scale: torch.Tensor | None = None,  # [2, K] f32 per-head (k, v) pool scales
    lora=None,  # (stacked adapter factors, ids [B] int32): per-slot runtime LoRA
    rope_delta: torch.Tensor | None = None,  # [B] int: m-rope's per-slot offset
):
    """One step of a decode block with a block-local KV window.

    The cache is never written here: each layer's new row goes into
    local_k / local_v[:, :, step] (in place), and the engine scatters the
    whole window into the cache once per block. With `ptable` the cache is
    a paged pool [L, P, page, K, Hd] and each slot reads its own pages,
    multiplied back by `kv_scale` when the pool is scaled. Every read is
    masked by the sink + window of `cfg` (none when its window is 0). With
    `lora` each
    slot adds its adapter's delta (the ragged kernel on the card; id 0 for
    adapter-less slots). With `rope_delta` q and k rotate at positions +
    rope_delta while the rows stay at positions: after a Qwen2-VL image
    prefill the three m-rope streams are equal and offset from the row
    index by a per-request constant, so plain rope there is exact.
    Returns (logits [B, V] f32, local_k, local_v)."""
    check_supported(cfg)
    _check_params(cfg, params)
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    rope_pos = positions if rope_delta is None else positions + rope_delta
    h = _embed(cfg, params, tokens)  # [B, D]
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        llora = _layer_lora(lora, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        if cfg.is_mla:
            # The latent rides as both K and V (the JAX package's MLA
            # branch: no softcap, sliding window or sink + window).
            q_eff, rows = _mla_step_rows(cfg, lp, x, positions, inv)
            lk = local_k[li]
            if ptable is not None:
                attn = decode_attention_windowed_paged(
                    q_eff, cache.k[li], cache.k[li], ptable, lk, lk, rows, rows, positions,
                    step, kv_scale=kv_scale)
            else:
                attn = decode_attention_windowed(q_eff, cache.k[li], cache.k[li], lk, lk,
                                                 rows, rows, positions, step)
            h = h + _attn_out(cfg, lp, _mla_unlatent(cfg, lp, attn))
            x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
            h = h + _mlp_out(cfg, lp, x)
            local_k[li, :, step] = kv_cast(rows, local_k.dtype)
            continue
        q, k, v = _attn_proj_qkv(cfg, lp, x, llora)  # q [B,H,Hd], k/v [B,K,Hd]
        q = apply_rope(q[:, None], rope_pos[:, None], inv)[:, 0]
        k = apply_rope(k[:, None], rope_pos[:, None], inv)[:, 0]
        if ptable is not None:
            attn = decode_attention_windowed_paged(
                q, cache.k[li], cache.v[li], ptable, local_k[li], local_v[li], k, v,
                positions, step, softcap=cfg.attn_softcap,
                window=cfg.sliding_window, sliding=_layer_sliding(cfg, li), kv_scale=kv_scale,
                sink=cfg.attention_sink, swin=cfg.attention_window,
            )
        else:
            attn = decode_attention_windowed(
                q, cache.k[li], cache.v[li], local_k[li], local_v[li], k, v,
                positions, step, softcap=cfg.attn_softcap,
                window=cfg.sliding_window, sliding=_layer_sliding(cfg, li),
                sink=cfg.attention_sink, swin=cfg.attention_window,
            )
        h = h + _attn_out(cfg, lp, attn.reshape(B, -1), llora)
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, llora)
        local_k[li, :, step] = kv_cast(k, local_k.dtype)
        local_v[li, :, step] = kv_cast(v, local_v.dtype)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _unembed(cfg, params, h), local_k, local_v


def decode_step(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B] current token per slot
    positions: torch.Tensor,  # [B] its position
    cache: KVCache,  # dense [L, B, S, K, Hd]
    with_logits: bool = True,
    read_rows: int = 0,  # > 0: attention reads only the cache's first rows
):
    """One decode step on a dense cache, the speculative draft's step (a
    draft model's cache, or the self-draft scratch): each layer attends the
    rows [0, positions) plus the current token and writes the token's row
    at positions, in place. Plain PyTorch attention (the JAX package's XLA
    numerics: decode_attention_windowed with an empty block window is its
    decode_attention_appended). with_logits=False skips the unembed (a
    step run for its K/V rows only); read_rows > 0 (which must cover every
    position) reads only the cache's first read_rows rows. Returns (logits
    [B, V] f32 or None, cache)."""
    check_supported(cfg)
    _check_params(cfg, params)
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    rows = torch.arange(B, device=dev)
    pos = positions.to(torch.int64)
    h = _embed(cfg, params, tokens)  # [B, D]
    empty = cache.k.new_zeros((B, 0, *cache.k.shape[3:]))
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        kc, vc = cache.k[li], cache.v[li]
        if read_rows:
            kc, vc = kc[:, :read_rows], vc[:, :read_rows]
        if cfg.is_mla:  # the latent as both K and V
            q, k = _mla_step_rows(cfg, lp, x, pos, inv)
            v = k[..., :0]
            attn = decode_attention_windowed(q, kc, kc, empty, empty, k, k, pos, 0)
            attn = _mla_unlatent(cfg, lp, attn)
        else:
            q, k, v = _attn_proj_qkv(cfg, lp, x)  # q [B,H,Hd], k/v [B,K,Hd]
            q = apply_rope(q[:, None], pos[:, None], inv)[:, 0]
            k = apply_rope(k[:, None], pos[:, None], inv)[:, 0]
            attn = decode_attention_windowed(
                q, kc, vc, empty, empty, k, v, pos, 0,
                softcap=cfg.attn_softcap, window=cfg.sliding_window,
                sliding=_layer_sliding(cfg, li),
            )
        h = h + _attn_out(cfg, lp, attn.reshape(B, -1))
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x)
        cache.k[li, rows, pos] = kv_cast(k, cache.k.dtype)
        cache.v[li, rows, pos] = kv_cast(v, cache.v.dtype)
    if not with_logits:
        return None, cache
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _unembed(cfg, params, h), cache


def self_draft_view(cfg: ArchConfig, params: Params):
    """The early-exit draft of spec_mode=self_draft: the target's first
    `cfg.self_draft_layers` layers with the shared embedding, final norm
    and head. The layer stacks are sliced [:k] (views: no second copy of
    any weight, quantized leaves and scales included). Returns
    (draft_cfg with num_layers = k, draft_params)."""
    k = cfg.self_draft_layers
    assert 0 < k < cfg.num_layers, "the engine validates self_draft_layers"
    view = {name: leaf for name, leaf in params.items() if name != "layers"}
    view["layers"] = {name: ({kk: v[:k] for kk, v in t.items()} if isinstance(t, dict)
                             else t[:k])
                      for name, t in params["layers"].items()}
    return dataclasses.replace(cfg, num_layers=k), view


def decode_chunk(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] the window's tokens per slot
    positions: torch.Tensor,  # [B, T] their positions (contiguous per slot)
    cache: KVCache,
    ptable=None,  # [B, MP] int32 or the (l1, l0) pair: `cache` is a page pool
    kv_scale: torch.Tensor | None = None,  # [2, K] f32 per-head (k, v) pool scales
    lora=None,  # (stacked adapter factors, ids [B] int32): per-slot runtime LoRA
    read_rows: int = 0,  # dense: > 0 reads only the cache's first rows
):
    """T tokens a slot in one pass, the verify pass of speculative
    decoding: returns the logits of all T positions and writes the T rows.
    Token t attends the slot's rows before the window (< positions[b, 0])
    plus the window causally (and the model's sliding mask). On a page
    pool the prefix walk is the ragged kernel's multi-query form
    (ops/attention.paged_prefill_partials, limits = the window start) merged
    with the window by `_merge_partials_mq`, and the rows go through the
    table (`write_chunk_to_pool`); on a dense cache the scores are plain
    PyTorch, as the JAX package's are plain XLA (read_rows > 0, covering
    every window start, reads only the first rows). The projections run on
    the B·T rows as one 2-D batch, so quantized weights take the fused
    kernels and `lora` the ragged LoRA kernel, each row with its slot's
    adapter. Returns (logits [B, T, V] f32, cache)."""
    check_supported(cfg)
    _check_params(cfg, params)
    B, T = tokens.shape
    H, Hd = cfg.num_heads, cfg.head_dim_
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    inv_local = rope_frequencies_local(cfg, dev)
    positions = positions.to(device=dev, dtype=torch.int64)
    tpos = torch.arange(T, device=dev)
    causal = tpos[None, :] <= tpos[:, None]  # [T, T]
    win_dist = tpos[:, None] - tpos[None, :]  # in-window distance t - u
    scale = Hd ** -0.5
    if lora is not None:
        lora = (lora[0], lora[1][:, None].expand(B, T).reshape(-1))  # row b·T + t: slot b
    h = _embed(cfg, params, tokens.reshape(-1))  # [B·T, D]
    new_k, new_v = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        llora = _layer_lora(lora, li)
        sliding = _layer_sliding(cfg, li)
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        inv = _layer_inv_freq(cfg, inv_freq, inv_local, li)
        if cfg.is_mla:
            # The absorbed verify window: q_eff scores the latent prefix and
            # the window's fresh latent rows, and the values come back out
            # of the same latents.
            xb = x.reshape(B, T, -1)
            q_eff = _mla_absorbed_q(cfg, lp, xb, positions, inv)  # [B, T, H, De]
            rows = _mla_rows(cfg, lp, xb, positions, inv)  # [B, T, 1, De]
            if ptable is not None:
                acc, m, l = paged_prefill_partials(
                    q_eff, cache.k[li], cache.k[li], ptable, positions[:, 0],
                    q_pos=positions, kv_scale=kv_scale)
                attn = _merge_partials_mq(q_eff, acc, m, l, rows, rows,
                                          causal[None].expand(B, T, T))
            else:
                kc = cache.k[li][:, :read_rows] if read_rows else cache.k[li]
                prefix = torch.arange(kc.shape[1], device=dev)[None, None, :] < positions[:, :1, None]
                attn = _mla_latent_attention(q_eff, kc, prefix, rows,
                                             causal[None, None]).to(h.dtype)
            h = h + _attn_out(cfg, lp, _mla_unlatent(cfg, lp, attn).reshape(B * T, -1))
            x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
            h = h + _mlp_out(cfg, lp, x)
            new_k.append(rows)
            new_v.append(rows[..., :0])
            continue
        q, k, v = _attn_proj_qkv(cfg, lp, x, llora)
        q = apply_rope(q.reshape(B, T, H, Hd), positions, inv)
        k = apply_rope(k.reshape(B, T, -1, Hd), positions, inv)
        v = v.reshape(B, T, -1, Hd)
        wmask = causal
        if cfg.sliding_window and sliding:
            wmask = wmask & (win_dist < cfg.sliding_window)
        if ptable is not None:
            acc, m, l = paged_prefill_partials(
                q, cache.k[li], cache.v[li], ptable, positions[:, 0],
                softcap=cfg.attn_softcap, window=cfg.sliding_window, sliding=sliding,
                q_pos=positions, kv_scale=kv_scale,
            )
            attn = _merge_partials_mq(q, acc, m, l, k, v, wmask[None].expand(B, T, T),
                                      softcap=cfg.attn_softcap)
        else:
            kc, vc = cache.k[li], cache.v[li]
            if read_rows:
                kc, vc = kc[:, :read_rows], vc[:, :read_rows]
            kc, vc = kc.float(), vc.float()  # [B, S, K, Hd]
            S, Kh = kc.shape[1], kc.shape[2]
            qf = (q.float() * scale).reshape(B, T, Kh, H // Kh, Hd)
            sc = torch.einsum("btkgd,bskd->bkgts", qf, kc)
            sw = torch.einsum("btkgd,bukd->bkgtu", qf, k.float())
            if cfg.attn_softcap:
                sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
                sw = cfg.attn_softcap * torch.tanh(sw / cfg.attn_softcap)
            # The cache's rows before the window (later rows are stale).
            srows = torch.arange(S, device=dev)
            prefix = srows[None, None, :] < positions[:, :1, None]  # [B, 1, S]
            if cfg.sliding_window and sliding:
                prefix = prefix & ((positions[:, :, None] - srows[None, None, :])
                                   < cfg.sliding_window)
            sc = torch.where(prefix[:, None, None], sc, -1e30)
            sw = torch.where(wmask, sw, -1e30)
            probs = torch.softmax(torch.cat([sc, sw], dim=-1), dim=-1)
            attn = (torch.einsum("bkgts,bskd->btkgd", probs[..., :S], vc)
                    + torch.einsum("bkgtu,bukd->btkgd", probs[..., S:], v.float()))
        h = h + _attn_out(cfg, lp, attn.reshape(B * T, -1).to(h.dtype), llora)
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, llora)
        new_k.append(k)
        new_v.append(v)
    ks, vs = torch.stack(new_k), torch.stack(new_v)  # [L, B, T, K, Hd]
    if ptable is not None:
        write_chunk_to_pool(cache, ptable, ks, vs, positions, kv_scale)
    else:
        bi = torch.arange(B, device=dev)[:, None].expand(B, T)
        cache.k[:, bi, positions] = kv_cast(ks, cache.k.dtype)
        cache.v[:, bi, positions] = kv_cast(vs, cache.v.dtype)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _unembed(cfg, params, h).reshape(B, T, -1), cache


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


def write_rows_to_cache(
    cache: KVCache,
    slot: int,  # destination slot
    ks: torch.Tensor,  # [L, 1, T, K, Hd]
    vs: torch.Tensor,
    start_row: int,  # first destination row
) -> KVCache:
    """Write T contiguous rows from `start_row` into one dense slot, in
    place: a cached span at row 0, or a prefix hit's tail rows after it.
    Rows past the slot's end are dropped (the JAX package's
    dynamic_update_slice clamps the start instead; the engine never writes
    past max_seq)."""
    n = max(0, min(ks.shape[2], cache.k.shape[2] - start_row))
    cache.k[:, slot, start_row:start_row + n] = kv_cast(ks[:, 0, :n], cache.k.dtype)
    cache.v[:, slot, start_row:start_row + n] = kv_cast(vs[:, 0, :n], cache.v.dtype)
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
    return _cache_zeros(cfg, (cfg.num_layers, num_pages, page_size), dtype, device)


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
    """pool[:, page of column row // page, row % page] = ks[:, b, i] for
    every rows[b, i], in place, through a flat or hierarchical table
    (ops/ptable). Rows are clamped to the table's span."""
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
    table,  # [B, MP] int32 or the (l1, l0) pair
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
    table,  # [B, MP] int32 or the (l1, l0) pair
    new_k: torch.Tensor,  # [L, B, T, K, Hd]
    new_v: torch.Tensor,
    positions: torch.Tensor,  # [B, T] row indices
    kv_scale=None,  # [2, K] f32 → pool rows store value / scale
) -> KVCache:
    """Scatter a chunk's rows into the page pool, in place."""
    return _scatter_rows(pool, table, positions, new_k, new_v, kv_scale)


def write_prefill_to_pool(
    pool: KVCache,
    table_row,  # [MP] int32 or ([ML1], l0): the destination slot's pages
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


def write_rows_to_pool(
    pool: KVCache,
    table_row,  # [MP] int32 or ([ML1], l0): the destination slot's pages
    ks: torch.Tensor,  # [L, 1, R, K, Hd]
    vs: torch.Tensor,
    start_row: int,  # first destination row
    kv_scale=None,  # [2, K] f32 → pool rows store value / scale
) -> KVCache:
    """Scatter R contiguous rows from `start_row` into one slot's pages, in
    place (rows that start mid-page, such as a prefix hit's tail). Rows
    past the table's span clamp to its last row, as in the JAX package."""
    rows = start_row + torch.arange(ks.shape[2], device=ks.device)[None, :]
    return _scatter_rows(pool, _pt.batch_row(table_row), rows, ks, vs, kv_scale)


def gather_pages(
    pool: KVCache,
    pages: torch.Tensor,  # [NP] int page ids (SCRATCH-padded past the span)
    kv_scale=None,  # [2, K] f32 → rows come back dequantized (value · scale)
) -> tuple[torch.Tensor, torch.Tensor]:
    """A page list as contiguous K/V rows [L, 1, NP·page, K, Hd]: the dense
    prefix operand `prefill_tail` reads. A scaled pool's rows come back as
    f32 values, an unscaled pool's in its storage dtype."""
    pages = pages.to(device=pool.k.device, dtype=torch.int64)
    k, v = pool.k[:, pages], pool.v[:, pages]  # [L, NP, page, K, Hd]
    if kv_scale is not None:
        k = k.float() * kv_scale[0][:, None]
        v = v.float() * kv_scale[1][:, None]
    L, NP, page, K, Hd = k.shape
    return k.reshape(L, 1, NP * page, K, Hd), v.reshape(L, 1, NP * page, K, Hd)


def prefill_chunk_paged(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T] chunk tokens, right-padded
    lengths: torch.Tensor,  # [B] valid chunk lengths
    offsets: torch.Tensor,  # [B] rows already resident (the chunk starts here)
    pool: KVCache,
    table,  # [B, MP] int32 page tables (prefix + destination pages), or (l1, l0)
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
    Under the sink + window of `cfg` the prefix walk reads only the sink
    pages and the trailing window; the in-chunk part needs no mask, since
    the engine keeps the chunk within the window (prefill_chunk <=
    attention_window).
    Returns (last_logits [B, V] f32, or None when with_logits is False, and
    the pool)."""
    check_supported(cfg)
    _check_params(cfg, params)
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
        wmask = causal[None] & length_mask[:, None, :]  # [B, T, T]
        if cfg.is_mla:
            # The absorbed chunk: q_eff scores the latent prefix pages (B2's
            # latent form) and the chunk's fresh latent rows.
            q_eff = _mla_absorbed_q(cfg, lp, x, positions, inv)  # [B, T, H, De]
            rows = _mla_rows(cfg, lp, x, positions, inv)  # [B, T, 1, De]
            acc, m, l = paged_prefill_partials(
                q_eff, pool.k[li], pool.k[li], table, offsets, q_pos=positions,
                kv_scale=kv_scale)
            attn = _merge_partials_mq(q_eff, acc, m, l, rows, rows, wmask)
            h = h + _attn_out(cfg, lp, _mla_unlatent(cfg, lp, attn))
            x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
            h = h + _mlp_out(cfg, lp, x, eager=True)
            new_k.append(rows)
            new_v.append(rows[..., :0])
            continue
        q, k, v = _attn_proj_qkv(cfg, lp, x)  # q [B,T,H,Hd], k/v [B,T,K,Hd]
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
        if cfg.sliding_window and sliding:
            wmask = wmask & (win_dist[None] < cfg.sliding_window)
        acc, m, l = paged_prefill_partials(
            q, pool.k[li], pool.v[li], table, offsets,
            softcap=cfg.attn_softcap, window=cfg.sliding_window, sliding=sliding,
            q_pos=positions, kv_scale=kv_scale, sink=cfg.attention_sink,
            swin=cfg.attention_window,
        )
        attn = _merge_partials_mq(q, acc, m, l, k, v, wmask, softcap=cfg.attn_softcap)
        h = h + _attn_out(cfg, lp, attn.reshape(B, T, -1).to(h.dtype))
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + _mlp_out(cfg, lp, x, eager=True)
        new_k.append(k)
        new_v.append(v)
    write_chunk_to_pool(pool, table, torch.stack(new_k), torch.stack(new_v), positions,
                        kv_scale)
    if not with_logits:
        return None, pool
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    last = h[torch.arange(B, device=dev), torch.clamp(lengths - 1, min=0)]  # [B, D]
    return _unembed(cfg, params, last), pool
