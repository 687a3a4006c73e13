"""fp8 KV storage in the port against the JAX package on the CPU: the cast
(bit for bit with ml_dtypes, NaN past e4m3's range included), the pool and
cache writers with and without a per-head kv_scale, the plain paged walk
over fp8 pools against the JAX XLA walk and the Pallas kernel in interpret
mode, and a chunked prefill + paged decode over a scaled fp8 pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.models import llama as jl
from localai_tpu.ops import attention as ja
from localai_tpu.ops import paged_flash as jpf
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.ops import paged_flash as tpf

FP8 = [(torch.float8_e4m3fn, jnp.float8_e4m3fn), (torch.float8_e5m2, jnp.float8_e5m2)]
FP8_IDS = ["e4m3", "e5m2"]
# f32 arithmetic on both sides over the same fp8 bytes: summation order.
ATOL, RTOL = 2e-5, 2e-5
LOGIT_ATOL = 1e-4


def _jbytes(x, jdt) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jdt)).view(np.uint8)


def _from_jax_fp8(arr, tdt) -> torch.Tensor:
    """A JAX fp8 array → the torch tensor with the same bytes."""
    return torch.from_numpy(np.asarray(arr).view(np.uint8).copy()).view(tdt)


@pytest.mark.parametrize("tdt, jdt", FP8, ids=FP8_IDS)
def test_kv_cast_bit_identical_to_jax_astype(tdt, jdt):
    edges = np.array([0.0, -0.0, 2.6e-4, 1e-7, 300.3, 448, 449, 463.9, 464, 464.01, 470, 480,
                      500, 1e4, -1e4, -464, -465, 57344, 57345, 61439, 61440, 61441, 65536, 1e9,
                      np.inf, -np.inf, np.nan, -np.nan], np.float32)
    rng = np.random.default_rng(0)
    cases = [edges, rng.standard_normal(20000).astype(np.float32) * 100,
             rng.standard_normal(20000).astype(np.float32) * 3e4]
    for x in cases:
        got = tl.kv_cast(torch.from_numpy(x), tdt).view(torch.uint8).numpy()
        assert np.array_equal(got, _jbytes(x, jdt))
    # bf16 rows (the model dtype) cast the same way.
    xb = jnp.asarray(cases[1]).astype(jnp.bfloat16)
    tb = torch.from_numpy(np.asarray(xb).view(np.uint16).copy()).view(torch.bfloat16)
    assert np.array_equal(tl.kv_cast(tb, tdt).view(torch.uint8).numpy(), _jbytes(xb, jdt))
    if tdt == torch.float8_e4m3fn:  # the trap: torch alone saturates where JAX gives NaN
        assert torch.tensor([500.0]).to(tdt).float().item() == 448.0
        assert torch.isnan(tl.kv_cast(torch.tensor([500.0]), tdt).float()).all()


def _cfg():
    return dataclasses.replace(get_arch("tiny"), dtype="float32")


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("tdt, jdt", FP8, ids=FP8_IDS)
def test_pool_writers_match_jax(tdt, jdt, scaled):
    cfg = _cfg()
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    page, MP, P = 4, 3, 8
    rng = np.random.default_rng(1)
    rows = (rng.standard_normal((L, 2, 6, K, Hd)) * 300).astype(np.float32)  # some past 448
    table = rng.permutation(P)[: 2 * MP].reshape(2, MP).astype(np.int32)
    scale = np.array([[0.5, 2.0], [4.0, 1.5]], np.float32) if scaled else None
    jsc = None if scale is None else jnp.asarray(scale)
    tsc = None if scale is None else torch.from_numpy(scale)
    jpool = jl.paged_cache_zeros(cfg, P, page, dtype=jdt)
    tpool = tl.paged_cache_zeros(cfg, P, page, dtype=tdt, device="cpu")
    start = np.array([0, 5], np.int32)
    pos = start[:, None] + np.arange(6)[None, :]
    jpool = jl.write_block_to_pool(jpool, jnp.asarray(table), jnp.asarray(rows),
                                   jnp.asarray(rows[::-1]), jnp.asarray(start), kv_scale=jsc)
    tl.write_block_to_pool(tpool, torch.from_numpy(table), torch.from_numpy(rows),
                           torch.from_numpy(rows[::-1].copy()), torch.from_numpy(start),
                           kv_scale=tsc)
    jpool = jl.write_chunk_to_pool(jpool, jnp.asarray(table), jnp.asarray(rows * 0.5),
                                   jnp.asarray(rows), jnp.asarray(pos + 3), kv_scale=jsc)
    tl.write_chunk_to_pool(tpool, torch.from_numpy(table), torch.from_numpy(rows * 0.5),
                           torch.from_numpy(rows), torch.from_numpy(pos + 3), kv_scale=tsc)
    ks = rows[:, :, :5]
    jpool = jl.write_prefill_to_pool(jpool, jnp.asarray(table[1]), jnp.asarray(ks),
                                     jnp.asarray(ks * 2), 1, kv_scale=jsc)
    tl.write_prefill_to_pool(tpool, torch.from_numpy(table[1]), torch.from_numpy(ks),
                             torch.from_numpy(ks * 2), 1, kv_scale=tsc)
    for j, t in zip(jpool, tpool):
        assert t.dtype == tdt
        assert np.array_equal(t.view(torch.uint8).numpy(), np.asarray(j).view(np.uint8))


@pytest.mark.parametrize("tdt, jdt", FP8, ids=FP8_IDS)
def test_dense_cache_writers_match_jax(tdt, jdt):
    cfg = _cfg()
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rows = (np.random.default_rng(2).standard_normal((L, 2, 4, K, Hd)) * 300).astype(np.float32)
    jc = jl.KVCache(k=jnp.zeros((L, 2, 8, K, Hd), jdt), v=jnp.zeros((L, 2, 8, K, Hd), jdt))
    tc = tl.KVCache.zeros(cfg, 2, 8, dtype=tdt, device="cpu")
    jc = jl.write_prefill_to_cache(jc, jnp.asarray(rows[:, :1]), jnp.asarray(rows[:, 1:]), 1)
    tl.write_prefill_to_cache(tc, torch.from_numpy(rows[:, :1]), torch.from_numpy(rows[:, 1:]), 1)
    start = np.array([2, 6], np.int32)
    jc = jl.write_block_to_cache(jc, jnp.asarray(rows), jnp.asarray(rows * 3), jnp.asarray(start))
    tl.write_block_to_cache(tc, torch.from_numpy(rows), torch.from_numpy(rows * 3),
                            torch.from_numpy(start))
    for j, t in zip(jc, tc):
        assert np.array_equal(t.view(torch.uint8).numpy(), np.asarray(j).view(np.uint8))


def _fp8_pools(seed, B, K, D, page, MP, jdt, tdt, scale):
    rng = np.random.default_rng(seed)
    P = B * MP + 3
    vals = [(rng.standard_normal((P, page, K, D)) * 20).astype(np.float32) for _ in range(2)]
    jp = [jnp.asarray(v / s[None, None, :, None]).astype(jdt) for v, s in zip(vals, scale)]
    table = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    return jp, [_from_jax_fp8(p, tdt) for p in jp], table


@pytest.mark.parametrize("mq", [False, True])
@pytest.mark.parametrize("tdt, jdt", FP8, ids=FP8_IDS)
def test_plain_walk_fp8_matches_jax_walk_and_pallas_kernel(tdt, jdt, mq):
    B, H, K, D, page, MP, T = 4, 4, 2, 32, 16, 4, 3
    scale = np.array([[0.5, 3.0], [2.0, 0.25]], np.float32)
    (jk, jv), (tk, tv), table = _fp8_pools(3, B, K, D, page, MP, jdt, tdt, scale)
    limits = np.array([page + 5, 2 * page, 0, 1], np.int32)
    q = np.random.default_rng(4).standard_normal((B, T, H, D) if mq else (B, H, D))
    q = q.astype(np.float32)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(limits))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(table), torch.from_numpy(limits))
    if mq:
        qpos = limits[:, None] + np.arange(T)[None, :]
        walk = ja._paged_cache_partials_mq(*jargs, q_pos=jnp.asarray(qpos),
                                           kv_scale=jnp.asarray(scale))
        kern = jpf.paged_decode_partials_mq(*jargs, q_pos=jnp.asarray(qpos), interpret=True,
                                            kv_scale=jnp.asarray(scale))
        got = tpf.paged_decode_partials_mq(*targs, q_pos=torch.from_numpy(qpos),
                                           kv_scale=torch.from_numpy(scale))
    else:
        walk = ja._paged_cache_partials(*jargs, kv_scale=jnp.asarray(scale))
        kern = jpf.paged_decode_partials(*jargs, interpret=True, kv_scale=jnp.asarray(scale))
        got = tpf.paged_decode_partials(*targs, kv_scale=torch.from_numpy(scale))
    live = limits > 0
    for want in (walk, kern):
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy()[live], w[live], atol=ATOL * 20, rtol=RTOL,
                                       err_msg=name)


def test_chunked_prefill_and_decode_over_scaled_fp8_pool_match_jax():
    """Two prompts through prefill_chunk_paged into an e4m3 pool with a
    per-head kv_scale, then 8 greedy paged decode steps whose block-local
    window stays in the model dtype: logits equal the JAX package's."""
    cfg = _cfg()
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    page, MP, P, n = 16, 4, 10, 8
    table = np.random.default_rng(5).permutation(P)[: 2 * MP].reshape(2, MP).astype(np.int32)
    scale = np.array([[2.0, 0.5], [1.0, 4.0]], np.float32)
    jsc, tsc = jnp.asarray(scale), torch.from_numpy(scale)
    jpool = jl.paged_cache_zeros(cfg, P, page, dtype=jnp.float8_e4m3fn)
    tpool = tl.paged_cache_zeros(cfg, P, page, dtype=torch.float8_e4m3fn, device="cpu")
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    lens = np.array([20, 32], np.int32)
    zero = np.zeros(2, np.int32)
    jlog, jpool = jl.prefill_chunk_paged(cfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                                         jnp.asarray(zero), jpool, jnp.asarray(table),
                                         paged_impl="xla", kv_scale=jsc)
    tlog, _ = tl.prefill_chunk_paged(cfg, tp, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), torch.from_numpy(zero), tpool,
                                     torch.from_numpy(table), kv_scale=tsc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    for j, t in zip(jpool, tpool):
        assert np.array_equal(t.view(torch.uint8).numpy(), np.asarray(j).view(np.uint8))
    jstep = jax.jit(lambda *a: jl.decode_step_windowed(
        cfg, *a, ptable=jnp.asarray(table), paged_impl="xla", kv_scale=jsc))
    jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), torch.argmax(tlog, -1)
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens).long()
    jlk = jnp.zeros((L, 2, n, K, Hd), jnp.float32)
    jlv = jnp.zeros_like(jlk)
    tlk, tlv = torch.zeros((L, 2, n, K, Hd)), torch.zeros((L, 2, n, K, Hd))
    for step in range(n):
        jlogits, jlk, jlv = jstep(jp, jtok, jpos, jpool, jlk, jlv, jnp.int32(step))
        tlogits, tlk, tlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, tpool, tlk, tlv, step,
                                                    ptable=torch.from_numpy(table),
                                                    kv_scale=tsc)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
        jtok, ttok = jnp.argmax(jlogits, -1).astype(jnp.int32), torch.argmax(tlogits, -1)
        assert np.array_equal(np.asarray(jtok), ttok.numpy())
        jpos, tpos = jpos + 1, tpos + 1
    jpool = jl.write_block_to_pool(jpool, jnp.asarray(table), jlk, jlv, jnp.asarray(lens),
                                   kv_scale=jsc)
    tl.write_block_to_pool(tpool, torch.from_numpy(table), tlk, tlv, torch.from_numpy(lens),
                           kv_scale=tsc)
    for j, t in zip(jpool, tpool):
        assert np.array_equal(t.view(torch.uint8).numpy(), np.asarray(j).view(np.uint8))
