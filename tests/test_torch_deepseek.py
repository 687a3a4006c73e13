"""The port's DeepSeek-V2/V3 decoder family against the JAX package on the
CPU: the router (both scoring rules, group-limited top-k, ties), the MLA
helpers, every entry point of models/llama.py under multi-head latent
attention, B2's plain latent form against the JAX walk and the Pallas
kernel in interpret mode, the sorted `_moe_ragged` route (eager calls
only: decode blocks and verify rounds above its threshold keep the
capturable route), the engines'
greedy ids (dense, paged, chunked, a prefix hit, prompt_lookup), HF
deepseek_v2 / deepseek_v3 exports, the int8 / int4 trees, and the refusals
that remain (runtime LoRA on an MLA base, the GGUF DeepSeek tree).

The models are tiny-mla in f32 with the JAX package's own init (scale
0.06, tests/test_deepseek.py) and, as "v2", a V2-style variant of it: the
softmax router with group-max selection, no selection bias, no
renormalization, a routed scaling of 1.5, and the direct q projection
(q_lora_rank None). Weights cross with `params_from_numpy`."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu.models import quant as jq
from localai_tpu.ops import attention as ja
from localai_tpu.ops import paged_flash as jpf
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.engine.engine import AdapterError, Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models import quant as tq
from localai_tpu_torch.ops import paged_flash as tpf

# f32 models: summation order only (the dense tests' tolerance).
LOGIT_ATOL = 1e-4
# Routing weights and the MLA helpers' outputs: one f32 op apart at most.
ROUTE_ATOL = 1e-6
HELPER_ATOL = 1e-5
# The plain partials against the JAX walks: summation order only.
PART_ATOL = 1e-5


def _cfg(variant: str):
    cfg = dataclasses.replace(get_arch("tiny-mla"), dtype="float32")
    if variant == "v2":
        cfg = dataclasses.replace(cfg, scoring_func="softmax", router_bias=False,
                                  norm_topk_prob=False, routed_scaling_factor=1.5,
                                  q_lora_rank=None)
    return cfg


def _trees(cfg, seed=0, bias_seed=None):
    """The JAX package's tree (numpy, f32) and the port's, from one init;
    with bias_seed a random selection bias replaces the zeros."""
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jl.init_params(cfg, jax.random.key(seed), scale=0.06))
    if bias_seed is not None and "router_bias" in jp["layers"]:
        rb = jp["layers"]["router_bias"]
        jp["layers"]["router_bias"] = (np.random.default_rng(bias_seed)
                                       .standard_normal(rb.shape).astype(np.float32) * 0.05)
    return jp, tw.params_from_numpy(cfg, jp, device="cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for v in ("v3", "v2"):
        cfg = _cfg(v)
        jp, tp = _trees(cfg, bias_seed=5)
        out[v] = (cfg, jax.tree.map(jnp.asarray, jp), tp)
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# --------------------------------------------------------------------------- #
# the router and the MoE layer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_deepseek_route_matches_jax(models, variant, ties):
    """Selections equal `_deepseek_route`'s exactly, weights within
    ROUTE_ATOL. With ties, experts 0 / 1 and 4 / 5 share router columns
    (and bias) and whole rows of x repeat, so scores and group scores tie
    and both packages must give them to the lower id."""
    cfg, jp, _ = models[variant]
    lp = {k: np.array(v[0]) for k, v in jp["layers"].items()
          if k in ("router", "router_bias")}
    if ties:
        for a, b in ((0, 1), (4, 5)):
            lp["router"][:, b] = lp["router"][:, a]
            if "router_bias" in lp:
                lp["router_bias"][b] = lp["router_bias"][a]
    x = np.random.default_rng(3).standard_normal((64, cfg.hidden_size)).astype(np.float32)
    if ties:
        x[32:] = x[:32]
    jw_, jsel = jl._deepseek_route(cfg, {k: jnp.asarray(v) for k, v in lp.items()},
                                   jnp.asarray(x))
    tw_, tsel = tl._moe_route(cfg, {k: _t(v) for k, v in lp.items()}, _t(x))
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))
    _close(tw_, jw_, ROUTE_ATOL)
    if ties:  # the tied pair is never split against the lower id
        s = tsel.numpy()
        assert not ((s == 1).any(-1) & ~(s == 0).any(-1)).any()


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_moe_layer_with_shared_experts_matches_jax(models, variant):
    """The MoE MLP of layer 1 (the first MoE layer): routed experts by the
    ragged route plus the always-on shared expert."""
    cfg, jp, tp = models[variant]
    x = np.random.default_rng(4).standard_normal((3, 5, cfg.hidden_size)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    want = jl._mlp(cfg, jlp, jnp.asarray(x))
    got = tl._mlp(cfg, tl._layer(tp, 1), _t(x))
    _close(got, want, HELPER_ATOL)


def test_sorted_moe_route_equals_every_expert_route(models, monkeypatch):
    """Above MOE_SORTED_MIN_ROWS rows an eager `_moe_ragged` computes only
    each pair's own expert; it gives the every-expert route's result (the
    same row products, summed over k in choice order) up to matmul
    blocking. Without `eager` the same rows keep the every-expert route."""
    cfg, _, tp = models["v3"]
    lp = tl._layer(tp, 2)
    x = _t(np.random.default_rng(6).standard_normal((300, cfg.hidden_size)).astype(np.float32))
    sorted_ = tl._moe_ragged(cfg, lp, x, eager=True)

    def refuse(*a, **k):
        raise AssertionError("the sorted route ran without eager")

    monkeypatch.setattr(tl, "_sorted_expert_rows", refuse)
    every = tl._moe_ragged(cfg, lp, x)
    np.testing.assert_allclose(sorted_.numpy(), every.numpy(), atol=ROUTE_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# MLA helpers and entry points
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_mla_helpers_match_jax(models, variant):
    cfg, jp, tp = models[variant]
    B, T = 2, 5
    x = np.random.default_rng(7).standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    pos = (np.arange(T)[None] + np.array([[3], [40]])).astype(np.int32)
    from localai_tpu.ops.rope import rope_frequencies as jrf
    from localai_tpu_torch.ops.rope import rope_frequencies as trf

    jinv, tinv = jrf(cfg), trf(cfg, "cpu")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = tl._layer(tp, 1)
    xj, xt, pj, pt = jnp.asarray(x), _t(x), jnp.asarray(pos), _t(pos).long()
    _close(tl._mla_q(cfg, tlp, xt), jl._mla_q(cfg, jlp, xj), HELPER_ATOL)
    _close(tl._mla_rows(cfg, tlp, xt, pt, tinv), jl._mla_rows(cfg, jlp, xj, pj, jinv),
           HELPER_ATOL)
    for got, want in zip(tl._mla_full_qkv(cfg, tlp, xt, pt, tinv),
                         jl._mla_full_qkv(cfg, jlp, xj, pj, jinv)):
        assert tuple(got.shape) == want.shape
        _close(got, want, HELPER_ATOL)
    q_eff = tl._mla_absorbed_q(cfg, tlp, xt, pt, tinv)
    _close(q_eff, jl._mla_absorbed_q(cfg, jlp, xj, pj, jinv), HELPER_ATOL)
    assert q_eff.shape[-1] == cfg.cache_k_dim
    _close(tl._mla_unlatent(cfg, tlp, q_eff), jl._mla_unlatent(cfg, jlp, jnp.asarray(q_eff)),
           HELPER_ATOL)


def _prefilled(cfg, jp, tp, B=2, S=16):
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([S, 9][:B], np.int32)
    jout = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    tout = tl.prefill(cfg, tp, _t(toks).long(), _t(lens).long())
    return lens, jout, tout


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_prefill_matches_jax(models, variant):
    """Full-rank prefill: logits within LOGIT_ATOL; the returned K rows are
    the latents [L, B, S, 1, r + rope] and V is zero-width."""
    cfg, jp, tp = models[variant]
    _, (jlog, jks, jvs), (tlog, tks, tvs) = _prefilled(cfg, jp, tp)
    _close(tlog, jlog, LOGIT_ATOL)
    assert tuple(tks.shape) == jks.shape == (cfg.num_layers, 2, 16, 1, cfg.cache_k_dim)
    assert tuple(tvs.shape) == jvs.shape and tvs.shape[-1] == 0
    _close(tks, jks, LOGIT_ATOL)


def _dense_caches(cfg, jks, tks, B=2, S_max=48):
    S = tks.shape[2]
    jc = jl.KVCache.zeros(cfg, B, S_max)
    jc = jl.KVCache(k=jc.k.at[:, :, :S].set(jks), v=jc.v)
    tc = tl.KVCache.zeros(cfg, B, S_max, device="cpu")
    tc.k[:, :, :S] = tks
    assert tc.v.shape[-1] == 0 and tc.k.shape[-2] == 1
    return jc, tc


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_decode_step_and_dense_windowed_decode_match_jax(models, variant):
    """`decode_step` (the draft's step) and three steps of a dense decode
    block: logits within LOGIT_ATOL, greedy ids equal, the latent rows
    written where the JAX package writes them."""
    cfg, jp, tp = models[variant]
    lens, (jlog, jks, _), (_, tks, _) = _prefilled(cfg, jp, tp)
    jc, tc = _dense_caches(cfg, jks, tks)
    tok, pos = np.asarray(jnp.argmax(jlog, -1), np.int32), lens.copy()
    jl_, tl_ = jl.decode_step(cfg, jp, jnp.asarray(tok), jnp.asarray(pos), jc)
    tlg, tc2 = tl.decode_step(cfg, tp, _t(tok).long(), _t(pos).long(),
                              tl.KVCache(tc.k.clone(), tc.v.clone()))
    _close(tlg, jl_, LOGIT_ATOL)
    _close(tc2.k, tl_.k, LOGIT_ATOL)
    L, B, n, De = cfg.num_layers, 2, 4, cfg.cache_k_dim
    jlk, jlv = jnp.zeros((L, B, n, 1, De)), jnp.zeros((L, B, n, 1, 0))
    tlk, tlv = torch.zeros((L, B, n, 1, De)), torch.zeros((L, B, n, 1, 0))
    for step in range(3):
        jo, jlk, jlv = jl.decode_step_windowed(cfg, jp, jnp.asarray(tok), jnp.asarray(pos), jc,
                                               jlk, jlv, step)
        to, tlk, tlv = tl.decode_step_windowed(cfg, tp, _t(tok).long(), _t(pos).long(), tc,
                                               tlk, tlv, step)
        _close(to, jo, LOGIT_ATOL)
        assert np.array_equal(to.argmax(-1).numpy(), np.asarray(jnp.argmax(jo, -1)))
        tok, pos = np.asarray(jnp.argmax(jo, -1), np.int32), pos + 1
    _close(tlk, jlk, LOGIT_ATOL)


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_dense_decode_chunk_and_prefill_tail_match_jax(models, variant):
    """The dense verify window (`decode_chunk`) and a dense prefix hit's
    tail (`prefill_tail` against cached latent rows)."""
    cfg, jp, tp = models[variant]
    lens, (_, jks, jvs), (_, tks, tvs) = _prefilled(cfg, jp, tp)
    jc, tc = _dense_caches(cfg, jks, tks)
    rng = np.random.default_rng(2)
    T = 3
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    pos = (lens[:, None] + np.arange(T)).astype(np.int32)
    jo, _ = jl.decode_chunk(cfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc)
    to, _ = tl.decode_chunk(cfg, tp, _t(toks).long(), _t(pos).long(),
                            tl.KVCache(tc.k.clone(), tc.v.clone()))
    _close(to, jo, LOGIT_ATOL)
    off, tlen = np.asarray([8, 5], np.int32), np.asarray([6, 4], np.int32)
    tt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jo, jk, _ = jl.prefill_tail(cfg, jp, jnp.asarray(tt), jnp.asarray(tlen), jnp.asarray(off),
                                jks, jvs)
    to, tk, tv = tl.prefill_tail(cfg, tp, _t(tt).long(), _t(tlen).long(), _t(off).long(), tks,
                                 tvs)
    _close(to, jo, LOGIT_ATOL)
    _close(tk, jk, LOGIT_ATOL)
    assert tv.shape[-1] == 0


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_paged_entry_points_match_jax(models, variant):
    """On a latent page pool (pages of 4, flat tables): two prefill chunks
    (`prefill_chunk_paged`, the second over the first's pages), two steps
    of a paged decode block and a paged verify window; logits within
    LOGIT_ATOL and the pool's latent rows equal to the JAX package's."""
    cfg, jp, tp = models[variant]
    B, page, P, T = 2, 4, 20, 8
    jpool, tpool = jl.paged_cache_zeros(cfg, P, page), tl.paged_cache_zeros(cfg, P, page,
                                                                            device="cpu")
    assert tuple(tpool.k.shape) == jpool.k.shape and tpool.v.shape[-1] == 0
    table = np.arange(16, dtype=np.int32).reshape(B, 8)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([8, 6], np.int32)
    for off in (np.zeros(B, np.int32), lens):
        jo, jpool = jl.prefill_chunk_paged(cfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                                           jnp.asarray(off), jpool, jnp.asarray(table))
        to, tpool = tl.prefill_chunk_paged(cfg, tp, _t(toks).long(), _t(lens).long(),
                                           _t(off).long(), tpool, _t(table))
        _close(to, jo, LOGIT_ATOL)
    _close(tpool.k, jpool.k, LOGIT_ATOL)
    pos = 2 * lens
    L, n, De = cfg.num_layers, 2, cfg.cache_k_dim
    jlk, jlv = jnp.zeros((L, B, n, 1, De)), jnp.zeros((L, B, n, 1, 0))
    tlk, tlv = torch.zeros((L, B, n, 1, De)), torch.zeros((L, B, n, 1, 0))
    tok = np.asarray([5, 7], np.int32)
    for step in range(n):
        jo, jlk, jlv = jl.decode_step_windowed(cfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                                               jpool, jlk, jlv, step, ptable=jnp.asarray(table),
                                               paged_impl="xla")
        to, tlk, tlv = tl.decode_step_windowed(cfg, tp, _t(tok).long(), _t(pos).long(), tpool,
                                               tlk, tlv, step, ptable=_t(table))
        _close(to, jo, LOGIT_ATOL)
        tok, pos = np.asarray(jnp.argmax(jo, -1), np.int32), pos + 1
    vt = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    vpos = (pos[:, None] + np.arange(3)).astype(np.int32)
    jo, _ = jl.decode_chunk(cfg, jp, jnp.asarray(vt), jnp.asarray(vpos), jpool,
                            ptable=jnp.asarray(table), paged_impl="xla")
    to, _ = tl.decode_chunk(cfg, tp, _t(vt).long(), _t(vpos).long(), tpool, ptable=_t(table))
    _close(to, jo, LOGIT_ATOL)


# --------------------------------------------------------------------------- #
# B2's latent form, plain version
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("pool", ["bf16_valued", "e4m3_scaled"])
def test_latent_partials_plain_match_jax_walk_and_pallas_kernel(pool):
    """The plain version of B2's latent form (K = 1, D = 48, the pool passed
    as K and V, 4 query heads) against the JAX package's XLA walk and its
    Pallas kernel in interpret mode, at decode and for a 3-token window:
    an f32 pool of bf16 values, and an e4m3 pool stored at kv_scale 2 (the
    V read multiplied by kv_scale[1])."""
    B, H, D, page, MP = 4, 4, 48, 16, 4
    rng = np.random.default_rng(11)
    P = B * MP + 1
    rows = rng.standard_normal((P, page, 1, D)).astype(np.float32)
    scale = None
    if pool == "bf16_valued":
        tpool = _t(rows).to(torch.bfloat16).float()
        jpool = jnp.asarray(tpool.numpy())
    else:
        scale = np.full((2, 1), 2.0, np.float32)
        tpool = tl.kv_cast(_t(rows) / 2.0, torch.float8_e4m3fn)
        jpool = jnp.asarray(rows / 2.0).astype(jnp.float8_e4m3fn)
        assert np.array_equal(np.asarray(jpool.astype(jnp.float32)), tpool.float().numpy())
    table = rng.permutation(P - 1)[: B * MP].reshape(B, MP).astype(np.int32)
    limits = np.asarray([MP * page, 17, 0, 1], np.int32)
    kw_j = {} if scale is None else {"kv_scale": jnp.asarray(scale)}
    kw_t = {} if scale is None else {"kv_scale": _t(scale)}
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    args_j = (jnp.asarray(q), jpool, jpool, jnp.asarray(table), jnp.asarray(limits))
    got = tpf.paged_decode_partials(_t(q), tpool, tpool, _t(table), _t(limits), **kw_t)
    for want in (ja._paged_cache_partials(*args_j, **kw_j),
                 jpf.paged_decode_partials(*args_j, interpret=True, **kw_j)):
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            _close(g, w, PART_ATOL)
    T = 3
    qm = rng.standard_normal((B, T, H, D)).astype(np.float32)
    qpos = (limits[:, None] + np.arange(T)).astype(np.int32)
    got = tpf.paged_decode_partials_mq(_t(qm), tpool, tpool, _t(table), _t(limits),
                                       q_pos=_t(qpos), **kw_t)
    want = jpf.paged_decode_partials_mq(jnp.asarray(qm), jpool, jpool, jnp.asarray(table),
                                        jnp.asarray(limits), q_pos=jnp.asarray(qpos),
                                        interpret=True, **kw_j)
    for g, w in zip(got, want):
        _close(g, w, PART_ATOL)


def test_latent_plan_takes_the_latent_forms_only():
    """The split plan takes D = 576 (bf16 / fp8) and D = 48 (f32) at one kv
    head only; D = 576 runs the latent kernel in 16-row tiles."""
    plan = tpf.paged_plan(4096, 128, 1, 16, 576, torch.bfloat16, 132)
    assert plan.kernel == "latent" and plan.row_tile == 16 and plan.splits == 16
    assert tpf.paged_plan(4096, 128, 1, 8192, 576, torch.float8_e4m3fn, 132).splits == 1
    assert tpf.paged_plan(256, 16, 1, 4, 48, torch.float32, 132).kernel == "scalar"
    assert plan.workspace_floats(8, 1, 16, 576) == 8 * 16 * 16 * 578
    for bad in ((2, 576, torch.bfloat16), (1, 576, torch.float32), (1, 48, torch.bfloat16),
                (4, 48, torch.float32)):
        with pytest.raises(ValueError, match="no plan"):
            tpf.paged_plan(4096, 128, bad[0], 16, bad[1], bad[2], 132)


# --------------------------------------------------------------------------- #
# engines
# --------------------------------------------------------------------------- #

BASE = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
LAYOUTS = {
    "dense": {},
    "paged": dict(kv_pages=40, kv_page_size=16),
    "chunked": dict(kv_pages=40, kv_page_size=16, prefill_chunk=32),
    "prompt_lookup": dict(kv_pages=40, kv_page_size=16, prefill_chunk=32,
                          spec_mode="prompt_lookup"),
}
# The last prompt repeats the continuation its logit bias pins, so
# prompt_lookup drafts from the first dispatch on (tests/test_speculative.py).
PROMPTS = [([65, 66, 67], {}), (list(range(40, 110)), {}), ([5, 6] * 20, {}),
           ([10] + [77] * 20, {77: 25.0})]


def _run(eng, Req, prompt, n=10, bias=None):
    evs = list(eng.submit(Req(prompt_ids=prompt, max_new_tokens=n, ignore_eos=True,
                              logit_bias=dict(bias or {}))))
    assert evs[-1].kind == "done", evs[-1]
    return [e.token_id for e in evs if e.kind == "token"]


def _engines(variant, models, **kw):
    cfg, jp, tp = models[variant]
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), engine_cfg=JaxEngineConfig(
        prefix_admit_async_compile=False, loop_prepare_ahead=False, **BASE, **kw))
    teng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                  engine_cfg=EngineConfig(**BASE, **kw))
    jeng.start()
    teng.start()
    return jeng, teng


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_greedy_ids_match_jax_engine(models, layout):
    """The port's Engine and the JAX Engine on tiny-mla (v3): the same
    greedy ids (exactly) on the dense cache, the paged pool, chunked
    prefill and prompt_lookup speculation."""
    jeng, teng = _engines("v3", models, prefix_cache_entries=0, **LAYOUTS[layout])
    try:
        want = [_run(jeng, JaxGenRequest, p, bias=b) for p, b in PROMPTS]
        got = [_run(teng, GenRequest, p, bias=b) for p, b in PROMPTS]
        assert got == want
        m = teng.metrics()
        if layout == "chunked":
            assert m["chunked_admits"] >= 2
        if layout == "prompt_lookup":
            assert m["spec_rounds"] > 0
    finally:
        jeng.stop()
        teng.stop()


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_prefix_hit_matches_jax_engine(models, variant):
    """A conversation whose later turns hit the prefix cache on the port's
    chunked paged engine (each hit's tail runs through B2's latent form
    over the shared latent pages) gives the ids and hits of the JAX
    engine's dense prefix cache (gather + prefill_tail). The JAX engine's
    own paged hit under MLA fails in its page gather (a zero-width V
    reshaped to K's width), so its dense cache is the reference here."""
    sys_ = list(range(100, 150))
    cfg, jp, tp = models[variant]
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), engine_cfg=JaxEngineConfig(
        prefix_admit_async_compile=False, loop_prepare_ahead=False, **BASE))
    teng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                  engine_cfg=EngineConfig(**BASE, **LAYOUTS["chunked"]))
    jeng.start()
    teng.start()
    try:
        def conv(eng, Req):
            a = sys_ + [3, 5, 8]
            ans = _run(eng, Req, a)
            out = [ans, _run(eng, Req, sys_ + [21, 34])]
            out.append(_run(eng, Req, a + ans + [89, 144]))
            return out

        assert conv(teng, GenRequest) == conv(jeng, JaxGenRequest)
        assert teng.metrics()["prefix_hits"] == jeng.metrics()["prefix_cache_hits"] >= 2
    finally:
        jeng.stop()
        teng.stop()


# Slot counts whose decode blocks (264 rows a step) and verify rounds
# (64 slots x 6 tokens = 384 rows) pass MOE_SORTED_MIN_ROWS = 256 rows.
MANY_ROWS = {
    "block": dict(max_slots=264, max_seq=512, min_prefill_bucket=16, block_sizes=(4,)),
    "verify": dict(max_slots=64, max_seq=512, min_prefill_bucket=16, block_sizes=(4,),
                   kv_pages=80, kv_page_size=16, spec_mode="prompt_lookup"),
}


@pytest.mark.parametrize("layout", list(MANY_ROWS))
def test_bodies_above_the_sorted_threshold_keep_the_capturable_route(models, monkeypatch,
                                                                    layout):
    """Decode blocks and verify rounds of more than MOE_SORTED_MIN_ROWS rows
    take `_expert_rows` (no host read, so the card can capture them), while
    a 300-token admission (512 rows) takes the sorted route; the greedy ids
    equal a 2-slot engine's exactly."""
    cfg, _, tp = models["v3"]
    seen, sorted_in = [], []  # (rows, inside a block or round body); sorted: inside
    inside = [False]
    ragged, sorted_rows = tl._moe_ragged, tl._sorted_expert_rows

    def spy(cfg, lp, x, eager=False):
        seen.append((x.reshape(-1, x.shape[-1]).shape[0], inside[0]))
        return ragged(cfg, lp, x, eager)

    def spy_sorted(*a, **k):
        sorted_in.append(inside[0])
        return sorted_rows(*a, **k)

    monkeypatch.setattr(tl, "_moe_ragged", spy)
    monkeypatch.setattr(tl, "_sorted_expert_rows", spy_sorted)
    long_ = [(j * 7) % 250 + 1 for j in range(300)]
    prompts = [(long_, {}), PROMPTS[3]]
    ecfg = MANY_ROWS[layout]
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(prefix_cache_entries=0, **ecfg))
    for name in ("_block_body", "_spec_body"):
        def body(*a, _f=getattr(eng, name), **k):
            inside[0] = True
            try:
                return _f(*a, **k)
            finally:
                inside[0] = False
        setattr(eng, name, body)
    small = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                   engine_cfg=EngineConfig(prefix_cache_entries=0,
                                           **{**ecfg, "max_slots": 2}))
    eng.start()
    small.start()
    try:
        got = [_run(eng, GenRequest, p, n=8, bias=b) for p, b in prompts]
        want = [_run(small, GenRequest, p, n=8, bias=b) for p, b in prompts]
        assert got == want
        if layout == "verify":
            assert eng.metrics()["spec_rounds"] > 0
    finally:
        eng.stop()
        small.stop()
    assert any(body and rows > tl.MOE_SORTED_MIN_ROWS for rows, body in seen)
    assert sorted_in and not any(sorted_in)  # the admission's route, never a body's


def test_register_adapter_refused_on_mla_base(models, tmp_path):
    cfg, _, tp = models["v3"]
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**BASE))
    try:
        with pytest.raises(AdapterError, match="is MLA"):
            eng.register_adapter("a", str(tmp_path))
    finally:
        eng.stop()


# --------------------------------------------------------------------------- #
# checkpoints and quantized trees
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_hf_export_loads_like_the_jax_loader(variant, tmp_path):
    """JAX `save_hf_checkpoint` of the v3 variant (a deepseek_v3 export,
    half-split rope) and of the v2 one (deepseek_v2, rope columns
    interleaved): `arch_from_hf_config` equals the JAX package's, and the
    port's load is bit-equal to the JAX load, leaf for leaf."""
    cfg = _cfg(variant)
    jp = jl.init_params(cfg, jax.random.key(2), scale=0.06)
    d = str(tmp_path / variant)
    jw.save_hf_checkpoint(cfg, jp, d)
    hf = json.load(open(f"{d}/config.json"))
    assert hf["model_type"] == ("deepseek_v3" if variant == "v3" else "deepseek_v2")
    ja_, ta_ = jw.arch_from_hf_config(d), tw.arch_from_hf_config(d)
    assert dataclasses.asdict(ta_) == dataclasses.asdict(ja_)
    assert ta_.rope_interleave == (variant == "v2")
    ja_ = dataclasses.replace(ja_, dtype="float32")
    want = jax.tree_util.tree_flatten_with_path(jw.load_hf_checkpoint(ja_, d))[0]
    got = tw.load_hf_checkpoint(dataclasses.replace(ta_, dtype="float32"), d, device="cpu")
    got_flat = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(got_flat) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, w in want:
        g = got_flat[jax.tree_util.keystr(path)]
        assert g.dtype == torch.float32, path
        assert np.array_equal(g.numpy(), np.asarray(w, np.float32)), path


def test_yarn_mscale_ingestion_is_the_jax_packages(tmp_path):
    """R1's published rope_scaling (yarn factor 40, mscale = mscale_all_dim
    = 1) and the attention_factor branch: the same ArchConfig as the JAX
    package's, amplitude included."""
    from localai_tpu_torch.ops.rope import rope_query_amp

    base = {"model_type": "deepseek_v3", "vocab_size": 512, "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "kv_lora_rank": 32, "q_lora_rank": 24, "qk_rope_head_dim": 16,
            "qk_nope_head_dim": 24, "v_head_dim": 24, "n_routed_experts": 8,
            "num_experts_per_tok": 2, "first_k_dense_replace": 1, "n_group": 4,
            "topk_group": 2, "max_position_embeddings": 163840}
    for i, rs in enumerate([
            {"type": "yarn", "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0,
             "original_max_position_embeddings": 4096, "beta_fast": 32, "beta_slow": 1},
            {"rope_type": "yarn", "factor": 40, "attention_factor": 1.2,
             "mscale_all_dim": 0.7, "original_max_position_embeddings": 4096}]):
        d = tmp_path / str(i)
        d.mkdir()
        (d / "config.json").write_text(json.dumps({**base, "rope_scaling": rs}))
        got, want = tw.arch_from_hf_config(str(d)), jw.arch_from_hf_config(str(d))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    expect = 0.1 * math.log(40.0) + 1.0
    assert rope_query_amp(tw.arch_from_hf_config(str(tmp_path / "0"))) == pytest.approx(
        expect * expect)


def _quant_cfg():
    """tiny-mla with every quantized matmul's in dim a multiple of int4's
    group of 32 (q_lora_rank 32, expert width 64)."""
    return dataclasses.replace(_cfg("v3"), q_lora_rank=32, moe_intermediate_size=64)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_tree_and_forward_match_jax(mode):
    """`quantize_params` over both stacks gives the JAX package's quantized
    tree bit for bit (w_kb / w_vb and the router stay float), and the
    quantized model's prefill logits and one decode step match the JAX
    package's within LOGIT_ATOL; `init_params_quantized` builds a tree of
    the same structure."""
    cfg = _quant_cfg()
    jp, tp = _trees(cfg, seed=4, bias_seed=6)
    # Inside jit, as the JAX engine quantizes (XLA's division by a constant).
    jqt = jax.jit(lambda p: jq.quantize_params(cfg, p, mode))(jax.tree.map(jnp.asarray, jp))
    tqt = tq.quantize_params(cfg, tp, mode)
    for stack in ("layers", "dense_layers"):
        for k in tq.QUANT_LAYER_KEYS:
            if k in jqt[stack]:
                assert isinstance(tqt[stack][k], dict), (stack, k)
                for leaf, w in jqt[stack][k].items():
                    assert np.array_equal(tqt[stack][k][leaf].numpy(), np.asarray(w)), (k, leaf)
        assert not isinstance(tqt[stack]["w_kb"], dict)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 11], np.int32)
    jlog, jks, _ = jl.prefill(cfg, jqt, jnp.asarray(toks), jnp.asarray(lens))
    tlog, tks, _ = tl.prefill(cfg, tqt, _t(toks).long(), _t(lens).long())
    _close(tlog, jlog, LOGIT_ATOL)
    jc, tc = _dense_caches(cfg, jks, tks)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    jo, _ = jl.decode_step(cfg, jqt, jnp.asarray(tok), jnp.asarray(lens), jc)
    to, _ = tl.decode_step(cfg, tqt, _t(tok).long(), _t(lens).long(), tc)
    _close(to, jo, LOGIT_ATOL)
    init = tq.init_params_quantized(cfg, seed=0, mode=mode, device="cpu")
    flat_i = jax.tree_util.tree_flatten_with_path(init)[0]
    flat_q = jax.tree_util.tree_flatten_with_path(tqt)[0]
    assert [p for p, _ in flat_i] == [p for p, _ in flat_q]
    for (path, a), (_, b) in zip(flat_i, flat_q):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


@pytest.mark.parametrize("arch", ["tiny-mla", "deepseek-v2-lite", "deepseek-r1"])
def test_param_specs_are_the_jax_trees(arch):
    """The port's parameter tree of each DeepSeek preset has the JAX
    package's keys, shapes and (f32 router bias) dtypes, leaf for leaf."""
    cfg = get_arch(arch)
    want = jax.eval_shape(lambda k: jl.init_params(cfg, k), jax.random.key(0))
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    specs = tl.param_specs(cfg)
    got = {}
    for name, spec in specs.items():
        items = spec.items() if name in ("layers", "dense_layers") else [(None, spec)]
        for k, (shape, kind) in items:
            key = f"['{name}']" + (f"['{k}']" if k else "")
            got[key] = (tuple(shape), "float32" if kind == "zeros_f32" else cfg.dtype)
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_server_serves_a_deepseek_checkpoint_like_the_jax_server(tmp_path):
    """The port's server on a tiny-mla deepseek_v3 HF checkpoint (bf16, the
    dense cache) answers a greedy completion with the JAX server's bytes
    and usage: a DeepSeek directory serves through the presets' route."""
    import urllib.request

    import yaml

    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from test_torch_server import _serve

    cfg = _cfg("v3")
    jw.save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(1), scale=0.06),
                          str(tmp_path / "ckpt"))
    (tmp_path / "ds.yaml").write_text(yaml.safe_dump(
        {"name": "ds", "model": "ckpt", "context_size": 128, "max_slots": 2,
         "max_tokens": 8, "temperature": 0.0}))
    jm = JaxModelManager(JaxAppConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path)))
    jr = JaxRouter()
    JaxOpenAIApi(jm).register(jr)
    js = jax_create_server(JaxAppConfig(address="127.0.0.1", port=0,
                                        models_dir=str(tmp_path)), jr)
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path))
    tm = ModelManager(app, device="cpu")
    tr = Router()
    OpenAIApi(tm).register(tr)
    ts = create_server(app, tr)
    try:
        out = {}
        for name, base in (("jax", _serve(js)), ("port", _serve(ts))):
            req = urllib.request.Request(
                base + "/v1/completions", method="POST",
                headers={"Content-Type": "application/json"},
                data=json.dumps({"model": "ds", "prompt": "Latent", "max_tokens": 8,
                                 "temperature": 0.0, "ignore_eos": True}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                body = json.loads(r.read())
            out[name] = (body["choices"][0]["text"], body["usage"])
        assert out["port"] == out["jax"]
    finally:
        for s in (js, ts):
            s.shutdown()
        jm.shutdown()
        tm.shutdown()
