"""The PyTorch port's paged attention against the JAX package on the same
inputs, made with numpy from a seed: the port's plain partials (the CUDA
kernel's CPU route), through its entry points and its dispatchers, against
the JAX package's XLA walk and its Pallas kernel in interpret mode; the
merges and the full paged decode attention; a whole prefill chunk against
the same chunk split into token tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops import attention as ja
from localai_tpu.ops import paged_flash as jpf
from localai_tpu_torch.ops import attention as ta
from localai_tpu_torch.ops import paged_flash as tpf
from localai_tpu_torch.ops import ptable

# f32 on every side; the walks differ in summation order only. l sums up
# to a page-walk's worth of weights <= 1, hence the relative term.
ATOL, RTOL = 1e-5, 1e-5


def _inputs(seed, B, T, H, K, D, page, MP, limits, dtype=np.float32):
    rng = np.random.default_rng(seed)
    P = B * MP + 3
    q = rng.standard_normal((B, H, D) if T is None else (B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, D)).astype(dtype)
    vp = rng.standard_normal((P, page, K, D)).astype(dtype)
    # Distinct, permuted pages per slot (pages are exclusive in the engine).
    table = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    return q, kp, vp, table, np.asarray(limits, np.int32)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, atol=ATOL, rtol=RTOL):
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (name, tuple(g.shape), w.shape)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2), (4, 1)])
def test_decode_partials_match_jax_walk_and_pallas_kernel(H, K, page):
    B, D, MP = 4, 32, 4
    # Partial last page, page-aligned, idle slot (0 rows), one row.
    limits = [page + page // 2 + 5, 2 * page, 0, 1]
    q, kp, vp, table, lim = _inputs(H * 10 + K + page, B, None, H, K, D, page, MP, limits)
    want = ja._paged_cache_partials(*_j(q, kp, vp, table, lim))
    want_k = jpf.paged_decode_partials(*_j(q, kp, vp, table, lim), interpret=True)
    got = tpf.paged_decode_partials(*_t(q, kp, vp, table, lim))
    _close(got, want)
    _close(got, want_k)
    _close(ta.paged_partials(*_t(q, kp, vp, table, lim)), want)  # the dispatcher
    # The idle slot's partials are exactly empty.
    assert (got[1][2] == -1e30).all() and (got[2][2] == 0).all() and (got[0][2] == 0).all()


@pytest.mark.parametrize("sliding", [True, False])
@pytest.mark.parametrize("page", [16, 64])
def test_decode_partials_softcap_and_sliding_window(page, sliding):
    B, H, K, D, MP = 3, 4, 2, 32, 4
    limits = [2 * page + 7, page, 0]
    q, kp, vp, table, lim = _inputs(7 + page, B, None, H, K, D, page, MP, limits)
    q_pos = lim + 2
    kw = dict(softcap=30.0, window=20)
    want = ja._paged_cache_partials(*_j(q, kp, vp, table, lim), q_pos=jnp.asarray(q_pos),
                                    sliding=jnp.asarray(sliding), **kw)
    want_k = jpf.paged_decode_partials(*_j(q, kp, vp, table, lim), q_pos=jnp.asarray(q_pos),
                                       sliding=jnp.asarray(sliding), interpret=True, **kw)
    got = tpf.paged_decode_partials(*_t(q, kp, vp, table, lim), q_pos=torch.from_numpy(q_pos),
                                    sliding=sliding, **kw)
    _close(got, want)
    _close(got, want_k)
    routed = ta.paged_partials(*_t(q, kp, vp, table, lim), q_pos=torch.from_numpy(q_pos),
                               sliding=sliding, **kw)
    _close(routed, want)


@pytest.mark.parametrize("H,K,window", [(4, 2, 0), (2, 2, 0), (4, 2, 16)])
def test_mq_partials_match_jax(H, K, window):
    B, T, D, MP, page = 2, 3, 32, 4, 16
    q, kp, vp, table, lim = _inputs(11 + H + window, B, T, H, K, D, page, MP, [33, 48])
    q_pos = (lim[:, None] + np.arange(T)[None, :]).astype(np.int32)
    kw = dict(window=window, softcap=20.0 if window else 0.0)
    jkw = dict(kw, sliding=jnp.asarray(True) if window else None)
    tkw = dict(kw, sliding=True if window else None)
    want = ja._paged_cache_partials_mq(*_j(q, kp, vp, table, lim), q_pos=jnp.asarray(q_pos), **jkw)
    want_k = jpf.paged_decode_partials_mq(*_j(q, kp, vp, table, lim), q_pos=jnp.asarray(q_pos),
                                          interpret=True, **jkw)
    got = tpf.paged_decode_partials_mq(*_t(q, kp, vp, table, lim),
                                       q_pos=torch.from_numpy(q_pos), **tkw)
    _close(got, want)
    _close(got, want_k)
    routed = ta.paged_prefill_partials(*_t(q, kp, vp, table, lim),
                                       q_pos=torch.from_numpy(q_pos), **tkw)
    _close(routed, want)


def test_prefill_partials_tiling_is_exact():
    """The whole chunk in one call gives the partials of the chunk split
    into token tiles (the TPU kernel's VMEM-bound tiling): each token's
    partials are independent."""
    B, T, H, K, D, MP, page = 1, 12, 4, 2, 32, 4, 16
    q, kp, vp, table, lim = _inputs(20, B, T, H, K, D, page, MP, [40])
    q_pos = torch.from_numpy((lim[:, None] + np.arange(T)[None, :]).astype(np.int32))
    qt, kpt, vpt, tt, limt = _t(q, kp, vp, table, lim)
    tq = 4
    whole = tpf.paged_prefill_partials_mq(qt, kpt, vpt, tt, limt, q_pos=q_pos)
    tiles = [tpf.paged_prefill_partials_mq(qt[:, lo:lo + tq], kpt, vpt, tt, limt,
                                           q_pos=q_pos[:, lo:lo + tq])
             for lo in range(0, T, tq)]  # 3 tiles of 4 tokens
    for i, b in enumerate(whole):
        torch.testing.assert_close(torch.cat([t[i] for t in tiles], dim=3), b, atol=1e-6, rtol=0)
    _close(whole, jpf.paged_prefill_partials_mq(*_j(q, kp, vp, table, lim),
                                                 q_pos=jnp.asarray(q_pos.numpy()),
                                                 interpret=True, max_qrows=8))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_merge_partials_match_jax(softcap):
    rng = np.random.default_rng(3)
    B, T, H, K, D, E = 2, 3, 4, 2, 16, 5
    G = H // K
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    acc = rng.standard_normal((B, K, G, D)).astype(np.float32)
    m = rng.standard_normal((B, K, G, 1)).astype(np.float32)
    l = np.abs(rng.standard_normal((B, K, G, 1))).astype(np.float32)
    l[0] = 0.0  # an empty partial (first chunk, idle slot) weighs nothing
    m[0] = -1e30
    ek = rng.standard_normal((B, E, K, D)).astype(np.float32)
    ev = rng.standard_normal((B, E, K, D)).astype(np.float32)
    mask = rng.random((B, E)) < 0.7
    mask[:, 0] = True
    want = ja._merge_partials(*_j(q, acc, m, l, ek, ev, mask), softcap=softcap)
    got = ta._merge_partials(*_t(q, acc, m, l, ek, ev, mask), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    qm = rng.standard_normal((B, T, H, D)).astype(np.float32)
    accm = rng.standard_normal((B, K, G, T, D)).astype(np.float32)
    mm = rng.standard_normal((B, K, G, T, 1)).astype(np.float32)
    lm = np.abs(rng.standard_normal((B, K, G, T, 1))).astype(np.float32)
    lm[1] = 0.0
    mm[1] = -1e30
    maskm = rng.random((B, T, E)) < 0.7
    maskm[..., 0] = True
    want = ja._merge_partials_mq(*_j(qm, accm, mm, lm, ek, ev, maskm), softcap=softcap)
    got = ta._merge_partials_mq(*_t(qm, accm, mm, lm, ek, ev, maskm), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sliding", [None, True])
def test_decode_attention_windowed_paged_matches_jax(softcap, sliding):
    rng = np.random.default_rng(10)
    B, H, K, D, MP, n, page, step = 3, 4, 2, 32, 4, 4, 16, 2
    q, kp, vp, table, _ = _inputs(12, B, None, H, K, D, page, MP, [0, 0, 0])
    kl = rng.standard_normal((B, n, K, D)).astype(np.float32)
    vl = rng.standard_normal((B, n, K, D)).astype(np.float32)
    kn = rng.standard_normal((B, K, D)).astype(np.float32)
    vn = rng.standard_normal((B, K, D)).astype(np.float32)
    positions = np.asarray([39, 18, step], np.int32)  # the last slot: empty cache prefix
    kw = dict(softcap=softcap, window=12 if sliding else 0)
    want = ja.decode_attention_windowed_paged(
        *_j(q, kp, vp, table, kl, vl, kn, vn, positions), jnp.int32(step),
        sliding=None if sliding is None else jnp.asarray(True), impl="xla", **kw)
    got = ta.decode_attention_windowed_paged(
        *_t(q, kp, vp, table, kl, vl, kn, vn, positions), step, sliding=sliding, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper routes by the tensors' device alone: CPU tensors get the
    plain walk (no kernel launch counted); any device but the CPU and CUDA
    raises."""
    B, QR, K, D, page, MP = 2, 4, 2, 64, 16, 3
    q, kp, vp, table, lim = _inputs(4, B, None, QR * K, K, D, page, MP, [37, 16])
    qr = torch.from_numpy(q).reshape(B, K, QR, D) / D**0.5
    qpos = torch.from_numpy(np.repeat(lim[:, None], QR, 1))
    args = [qr, qpos, *_t(kp, vp, table, lim)]
    before = tpf.paged_partials_rows.launches
    got = tpf.paged_partials_rows(*args, 30.0, 20)
    assert tpf.paged_partials_rows.launches == before
    for g, w in zip(got, tpf.paged_partials_plain(*args, 30.0, 20)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        tpf.paged_partials_rows(*[a.to("meta") for a in args])


def test_unported_paged_features_raise():
    """Only the multi-GPU form still raises. The long-context forms it
    raised for before (sink + window, hierarchical tables) now serve: the
    sink + window walk equals the plain walk under the same mask, and a
    hierarchical pair has its logical width."""
    q, kp, vp, table, lim = _t(*_inputs(1, 2, None, 4, 2, 32, 16, 2, [5, 9]))
    with pytest.raises(NotImplementedError, match="Queue A item 14, multi-GPU"):
        ta.paged_partials(q, kp, vp, table, lim, mesh=object())
    got = ta.paged_partials(q, kp, vp, table, lim, sink=4, swin=8)
    qr = (q * (1.0 / 32**0.5)).reshape(2, 2, 2, 32)  # the wrapper's scaling
    want = tpf.paged_partials_plain(qr, lim[:, None].expand(2, 2), kp, vp, table, lim,
                                    sink=4, swin=8)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w) and torch.isfinite(g).all()
    l0 = torch.zeros(3, 4, dtype=torch.int32)
    assert ptable.width((table[:, :1], l0)) == 4 and ptable.is_hier((table[:, :1], l0))
    cols = torch.tensor([[1, 0], [0, 1]])
    assert ptable.gather_cols(table, cols).tolist() == [
        [table[0, 1].item(), table[0, 0].item()], [table[1, 0].item(), table[1, 1].item()]]
    assert torch.equal(ptable.batch_row(table[1]), table[1:2])
