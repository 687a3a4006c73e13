"""The PyTorch port's Llama forward against the JAX package on the same
weights: the JAX `init_params` tree goes through the weight bridge, and
both packages run the tiny preset in f32 on the CPU."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl

# f32 both sides; the two differ in summation order only (and the port's
# prefill attention runs the flash algorithm, the JAX package dense math).
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5


def _cfg(**kw):
    return dataclasses.replace(get_arch("tiny"), dtype="float32", **kw)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _prompts(cfg, B, S, lens, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


def test_init_params_tree_matches_jax():
    for cfg in (_cfg(), _cfg(attn_qkv_bias=True, tie_embeddings=True)):
        jp = jl.init_params(cfg, jax.random.key(1))
        tp = tl.init_params(cfg, seed=1, device="cpu")
        jshapes = {k: tuple(v.shape) for k, v in jp["layers"].items()}
        tshapes = {k: tuple(v.shape) for k, v in tp["layers"].items()}
        assert jshapes == tshapes
        assert sorted(jp) == sorted(tp)
        assert all(v.dtype == torch.float32 for v in tp["layers"].values())
    a = tl.init_params(_cfg(), seed=3, device="cpu")["layers"]["wq"]
    assert torch.equal(a, tl.init_params(_cfg(), seed=3, device="cpu")["layers"]["wq"])


@pytest.mark.parametrize("variant", ["llama", "qwen2_bias", "gemma_flags"])
def test_prefill_matches_jax(variant):
    kw = {
        "llama": {},
        "qwen2_bias": {"attn_qkv_bias": True},
        "gemma_flags": {"post_norms": True, "qk_norm": True, "activation": "gelu_tanh",
                        "embed_scale": True, "final_softcap": 30.0, "query_scale": 24.0,
                        "tie_embeddings": True},
    }[variant]
    cfg = _cfg(**kw)
    jp = jl.init_params(cfg, jax.random.key(2))
    if cfg.attn_qkv_bias:  # non-zero biases so the add is exercised
        rng = np.random.default_rng(7)
        for b in ("bq", "bk", "bv"):
            jp["layers"][b] = jnp.asarray(
                rng.standard_normal(jp["layers"][b].shape).astype(np.float32) * 0.1)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 3, 32
    toks, lens = _prompts(cfg, B, S, [32, 7, 1])
    jlog, jks, jvs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    tlog, tks, tvs = tl.prefill(cfg, tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    jks, jvs = np.asarray(jks), np.asarray(jvs)
    for b, n in enumerate(lens):  # padded rows legitimately differ
        np.testing.assert_allclose(tks.numpy()[:, b, :n], jks[:, b, :n], atol=KV_ATOL, rtol=0)
        np.testing.assert_allclose(tvs.numpy()[:, b, :n], jvs[:, b, :n], atol=KV_ATOL, rtol=0)


def test_greedy_decode_blocks_match_jax(models):
    """Prefill two prompts into a slot cache, then 32 greedy steps in four
    8-step blocks of decode_step_windowed + write_block_to_cache."""
    cfg, jp, tp = models
    B, S, MAXS, n = 2, 16, 64, 8
    toks, lens = _prompts(cfg, B, S, [5, 9], seed=1)

    jlog, jks, jvs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    jcache = jl.KVCache.zeros(cfg, B, MAXS)
    tlog, tks, tvs = tl.prefill(cfg, tp, torch.from_numpy(toks), torch.from_numpy(lens))
    tcache = tl.KVCache.zeros(cfg, B, MAXS, device="cpu")
    for b in range(B):
        jcache = jl.write_prefill_to_cache(jcache, jks[:, b:b + 1], jvs[:, b:b + 1], b)
        tl.write_prefill_to_cache(tcache, tks[:, b:b + 1], tvs[:, b:b + 1], b)

    jstep = jax.jit(partial(jl.decode_step_windowed, cfg))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    assert np.array_equal(np.asarray(jtok), ttok.numpy())
    jpos = jnp.asarray(lens)
    tpos = torch.from_numpy(lens).long()
    jids, tids = [], []
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    for _blk in range(4):
        jlk = jnp.zeros((L, B, n, K, Hd), jnp.float32)
        jlv = jnp.zeros_like(jlk)
        tlk = torch.zeros((L, B, n, K, Hd))
        tlv = torch.zeros_like(tlk)
        jstart, tstart = jpos, tpos
        for step in range(n):
            jlogits, jlk, jlv = jstep(jp, jtok, jpos, jcache, jlk, jlv, jnp.int32(step))
            tlogits, tlk, tlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, tcache, tlk, tlv, step)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=LOGIT_ATOL, rtol=0)
            jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
            ttok = torch.argmax(tlogits, -1)
            jids.append(np.asarray(jtok))
            tids.append(ttok.numpy())
            jpos, tpos = jpos + 1, tpos + 1
        jcache = jl.write_block_to_cache(jcache, jlk, jlv, jstart)
        tl.write_block_to_cache(tcache, tlk, tlv, tstart)
    assert np.array_equal(np.stack(tids), np.stack(jids))
    assert len(tids) == 32


def test_write_block_to_cache_clamps_overshoot():
    cfg = _cfg()
    cache = tl.KVCache.zeros(cfg, 2, 8, device="cpu")
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    local = torch.arange(1, 5, dtype=torch.float32)[None, None, :, None, None].expand(L, 2, 4, K, Hd)
    tl.write_block_to_cache(cache, local, local, torch.tensor([2, 6]))
    assert cache.k[0, 0, 2:6, 0, 0].tolist() == [1, 2, 3, 4]
    assert cache.k[0, 1, 6, 0, 0].item() == 1.0
    assert cache.k[0, 1, 7, 0, 0].item() in (2.0, 3.0, 4.0)  # rows past S-1 clamp onto it
    assert (cache.k[:, 1, :6] == 0).all()


@pytest.mark.parametrize("kw", [{"num_experts": 4, "moe_family": "deepseek"},
                                {"kv_lora_rank": 32}, {"mrope_section": (2, 3, 3)}])
def test_unported_features_raise(kw):
    """The deepseek MoE family, MLA and m-rope, each refused by an earlier
    slice and ported since, build the JAX package's tree: the same keys,
    shapes and dtypes, leaf for leaf."""
    cfg = _cfg(**kw)
    want = jax.tree_util.tree_flatten_with_path(jl.init_params(cfg, jax.random.key(0)))[0]
    got = jax.tree_util.tree_flatten_with_path(tl.init_params(cfg, device="cpu"))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), path
