"""The port's long-context attention against the JAX package on the same
inputs, made with numpy from a seed: the hierarchical page-table helpers,
the paged partials over hierarchical tables and under the sink + window
skip (the plain walk, which is the CUDA kernel's CPU route) against the
JAX XLA walk, the Pallas kernel in interpret mode and a brute-force mask,
and the dense and paged windowed decode attention with the sink + window
mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops import attention as ja
from localai_tpu.ops import paged_flash as jpf
from localai_tpu.ops import ptable as jpt
from localai_tpu_torch.ops import attention as ta
from localai_tpu_torch.ops import paged_flash as tpf
from localai_tpu_torch.ops import ptable as tpt

# f32 on every side; the walks differ in summation order only.
ATOL, RTOL = 1e-5, 1e-5
# Against the brute-force softmax over a whole slot (one sum instead of a
# page walk), as the reference's own test of the skip allows.
BRUTE_TOL = 5e-4
PAGE = 16


def _inputs(seed, B, T, H, K, D, MP, page=PAGE):
    rng = np.random.default_rng(seed)
    P = B * MP + 3
    q = rng.standard_normal((B, H, D) if T is None else (B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, D)).astype(np.float32)
    table = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    return q, kp, vp, table


def _hier_of(table, span):
    """A flat table as the hierarchical pair the reference's tests build:
    l0 row 0 unused, then each slot's table pages in order."""
    B, MP = table.shape
    ml1 = -(-MP // span)
    l0 = [np.zeros((span,), np.int32)]
    l1 = np.zeros((B, ml1), np.int32)
    for b in range(B):
        for c in range(ml1):
            row = np.zeros((span,), np.int32)
            chunk = table[b, c * span:(c + 1) * span]
            row[: len(chunk)] = chunk
            l1[b, c] = len(l0)
            l0.append(row)
    return l1, np.stack(l0)


def _j(x):
    return tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) else jnp.asarray(x)


def _t(x):
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in x)
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (name, tuple(g.shape), w.shape)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol, err_msg=name)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# ops/ptable
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("span", [1, 2, 3, 4])
def test_ptable_helpers_match_jax(span):
    """width, gather_cols, row_lookup, select_row and batch_row on both
    layouts give the reference's page ids and shapes."""
    _, _, _, table = _inputs(span, 3, None, 4, 2, 8, 6)
    rng = np.random.default_rng(span)
    cols = rng.integers(0, 6, (3, 5)).astype(np.int32)
    for tab in (table, _hier_of(table, span)):
        jt, tt = _j(tab), _t(tab)
        assert tpt.is_hier(tt) == jpt.is_hier(jt)
        assert tpt.width(tt) == jpt.width(jt)
        got = tpt.gather_cols(tt, _t(cols))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpt.gather_cols(jt, _j(cols))))
        np.testing.assert_array_equal(got.numpy(), np.take_along_axis(table, cols, 1))
        for b in range(3):
            jrow, trow = jpt.select_row(jt, b), tpt.select_row(tt, b)
            for idx in (0, 5, _t(cols[b])):
                jidx = idx if isinstance(idx, int) else _j(idx.numpy())
                np.testing.assert_array_equal(np.asarray(tpt.row_lookup(trow, idx)),
                                              np.asarray(jpt.row_lookup(jrow, jidx)))
            jb, tb = jpt.batch_row(jrow), tpt.batch_row(trow)
            for x, y in zip(jax_leaves(jb), jax_leaves(tb)):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def jax_leaves(t):
    return list(t) if isinstance(t, tuple) else [t]


# --------------------------------------------------------------------------- #
# Paged partials: hierarchical tables, the sink + window skip
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("span", [1, 2, 4])
def test_hier_partials_equal_flat_and_match_jax_walk_and_kernel(span):
    """A hierarchical table resolves to the flat table's pages: the port's
    walk gives the flat walk's bits, and both match the reference's XLA walk
    and its Pallas kernel (interpret mode) on the hierarchical pair."""
    B, H, K, D, MP = 3, 4, 2, 32, 4
    q, kp, vp, table = _inputs(10 + span, B, None, H, K, D, MP)
    lim = np.array([37, 64, 0], np.int32)
    hier = _hier_of(table, span)
    flat_got = tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(table), _t(lim))
    got = tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(hier), _t(lim))
    assert _equal(got, flat_got)
    want = ja._paged_cache_partials(_j(q), _j(kp), _j(vp), _j(hier), _j(lim))
    _close(got, want)
    want_k = jpf.paged_decode_partials(_j(q), _j(kp), _j(vp), _j(hier), _j(lim), interpret=True)
    _close(got, want_k)


def _brute(q, kp, vp, table, limits, q_pos, sink, swin, page=PAGE):
    """Every row of each slot, the sink + window mask applied, one softmax."""
    B, H, D = q.shape
    K = kp.shape[2]
    G = H // K
    qn = q * (1.0 / D**0.5)
    accs, ms, ls = [], [], []
    for b in range(B):
        g = np.arange(int(limits[b]))
        rk = kp[table[b, g // page], g % page]  # [S, K, D]
        rv = vp[table[b, g // page], g % page]
        keep = (g < sink) | (int(q_pos[b]) - g < swin)
        sc = np.einsum("kgd,skd->kgs", qn[b].reshape(K, G, D), rk)
        sc[:, :, ~keep] = -1e30
        m = sc.max(axis=-1, keepdims=True)
        p = np.exp(sc - m)
        p[:, :, ~keep] = 0.0
        accs.append(np.einsum("kgs,skd->kgd", p, rv))
        ms.append(m)
        ls.append(p.sum(axis=-1, keepdims=True))
    return np.stack(accs), np.stack(ms), np.stack(ls)


@pytest.mark.parametrize("span", [0, 2, 4])
def test_sink_window_decode_matches_brute_force_jax_walk_and_kernel(span):
    """Decode under sink/swin (the sink ends mid-page, the window spans
    about three pages): the port's skip walk against a brute-force mask over
    every row, the reference's XLA walk and its Pallas kernel, on a flat and
    a hierarchical table (bit for bit alike), and equal bit for bit to the
    same walk over a table whose skipped columns point at a page of noise
    (what a spilled slot's SCRATCH entries hold)."""
    B, H, K, D, MP = 3, 4, 2, 32, 8
    q, kp, vp, table = _inputs(12 + span, B, None, H, K, D, MP)
    lim = np.array([8 * PAGE, 5 * PAGE + 3, 20], np.int32)
    sink, swin = 20, 40
    tab = _hier_of(table, span) if span else table
    got = tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(tab), _t(lim), q_pos=_t(lim),
                                    sink=sink, swin=swin)
    _close(got, _brute(q, kp, vp, table, lim, lim, sink, swin), atol=BRUTE_TOL, rtol=BRUTE_TOL)
    jargs = (_j(q), _j(kp), _j(vp), _j(tab), _j(lim))
    _close(got, ja._paged_cache_partials(*jargs, q_pos=_j(lim), sink=sink, swin=swin))
    _close(got, jpf.paged_decode_partials(*jargs, q_pos=_j(lim), sink=sink, swin=swin,
                                          interpret=True))
    if span:
        flat = tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(table), _t(lim),
                                         q_pos=_t(lim), sink=sink, swin=swin)
        assert _equal(got, flat)
    spilled = table.copy()
    scratch = kp.shape[0] - 1  # a page no slot lists
    for b in range(B):
        _, sink_rows, gap = tpf.walk_rows(int(lim[b]), int(lim[b]), PAGE, MP, sink, swin)
        spilled[b, sink_rows // PAGE:(sink_rows + gap) // PAGE] = scratch
    tab_s = _hier_of(spilled, span) if span else spilled
    assert _equal(got, tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(tab_s), _t(lim),
                                                 q_pos=_t(lim), sink=sink, swin=swin))


@pytest.mark.parametrize("span", [0, 4])
def test_sink_window_chunk_walk_matches_jax_walk_and_kernel(span):
    """A multi-query chunk under sink/swin: the skip is bounded by the
    chunk's smallest query position, against the reference's XLA walk and
    its Pallas kernel (which tiles the chunk's rows, each tile its own
    skip: the skip is exact, so the partials agree)."""
    B, T, H, K, D, MP = 2, 6, 4, 2, 32, 8
    q, kp, vp, table = _inputs(14 + span, B, T, H, K, D, MP)
    lim = np.array([7 * PAGE, 4 * PAGE], np.int32)
    q_pos = (lim[:, None] + np.arange(T)[None, :]).astype(np.int32)
    sink, swin = PAGE, 3 * PAGE
    tab = _hier_of(table, span) if span else table
    got = tpf.paged_prefill_partials_mq(_t(q), _t(kp), _t(vp), _t(tab), _t(lim),
                                        q_pos=_t(q_pos), sink=sink, swin=swin)
    jargs = (_j(q), _j(kp), _j(vp), _j(tab), _j(lim))
    _close(got, ja._paged_cache_partials_mq(*jargs, q_pos=_j(q_pos), sink=sink, swin=swin))
    _close(got, jpf.paged_prefill_partials_mq(*jargs, q_pos=_j(q_pos), sink=sink, swin=swin,
                                              interpret=True, max_qrows=8))
    flat = tpf.paged_prefill_partials_mq(_t(q), _t(kp), _t(vp), _t(table), _t(lim),
                                         q_pos=_t(q_pos), sink=sink, swin=swin)
    assert _equal(got, flat)


def test_skip_walks_only_the_sink_and_window_pages(monkeypatch):
    """The plain walk reads each slot's sink and window columns and no
    other: a 64-page slot at sink 16, window 48 reads 1 + 3 pages."""
    B, H, K, D, MP = 1, 4, 2, 32, 64
    q, kp, vp, table = _inputs(3, B, None, H, K, D, MP)
    lim = np.array([MP * PAGE], np.int32)
    seen = []
    gather = tpt.gather_cols

    def spy(tab, cols):
        seen.append(int(cols[0, 0]))
        return gather(tab, cols)

    monkeypatch.setattr(tpt, "gather_cols", spy)
    tpf.paged_decode_partials(_t(q), _t(kp), _t(vp), _t(table), _t(lim), q_pos=_t(lim),
                              sink=16, swin=48)
    assert seen == [0, 61, 62, 63]


# --------------------------------------------------------------------------- #
# Windowed decode attention with the sink + window mask
# --------------------------------------------------------------------------- #


def _decode_inputs(seed, B, S, n, H, K, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, D), f(B, S, K, D), f(B, S, K, D), f(B, n, K, D), f(B, n, K, D),
            f(B, K, D), f(B, K, D))


@pytest.mark.parametrize("step", [0, 3, 7])
def test_dense_windowed_decode_with_sink_matches_jax(step):
    """The dense engine's decode attention masks cache and block-local rows
    by the sink + window, as the reference does."""
    B, S, n, H, K, D = 3, 96, 8, 4, 2, 32
    xs = _decode_inputs(step, B, S, n, H, K, D)
    positions = np.array([90, 40, 12], np.int32) + step
    kw = dict(sink=10, swin=24)
    want = ja.decode_attention_windowed(*map(jnp.asarray, xs), jnp.asarray(positions),
                                        jnp.int32(step), **kw)
    got = ta.decode_attention_windowed(*map(torch.from_numpy, xs), torch.from_numpy(positions),
                                       step, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("span", [0, 4])
@pytest.mark.parametrize("step", [0, 5])
def test_paged_windowed_decode_with_sink_matches_jax(span, step):
    """The paged decode attention: the skip walk over the pool, then the
    block-local rows and the current token masked by the sink + window,
    against the reference's paged and dense forms."""
    B, H, K, D, MP, n = 3, 4, 2, 32, 8, 8
    q, kp, vp, table = _inputs(20 + span + step, B, None, H, K, D, MP)
    _, _, _, kl, vl, kn, vn = _decode_inputs(step, B, 1, n, H, K, D)
    positions = np.array([7 * PAGE + 9, 3 * PAGE, 30], np.int32) + step
    tab = _hier_of(table, span) if span else table
    kw = dict(sink=PAGE + 4, swin=2 * PAGE)
    want = ja.decode_attention_windowed_paged(
        *map(_j, (q, kp, vp, tab, kl, vl, kn, vn, positions)), jnp.int32(step), **kw)
    got = ta.decode_attention_windowed_paged(
        *map(_t, (q, kp, vp, tab, kl, vl, kn, vn, positions)), step, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
