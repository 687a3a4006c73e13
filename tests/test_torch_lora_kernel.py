"""The port's LoRA delta (ops/lora_matmul.py) against the JAX package on
the CPU: the kernel's plain version against the Pallas kernel in interpret
mode and the XLA gather form, the port's gather form against the XLA one
in f32 and bf16, null rows, the dispatchers' shape split and grouping, the
kernel's plan, and an emulation of the kernel's clusters (segments, slices
of IN, column ranges) against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops.lora_matmul import _lora_call, lora_delta_xla
from localai_tpu_torch.ops import lora_matmul as lm


def _factors(seed, B, IN, R, OUT, NA, pad_rank=None):
    """x [B, IN], a [NA, IN, R], b [NA, R, OUT] f32 from a numpy seed; row 0
    of the stack is the null adapter, adapter 1 zero-padded past
    `pad_rank` (a real stack pads every adapter to the stack rank)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, IN)).astype(np.float32)
    a = rng.normal(size=(NA, IN, R)).astype(np.float32)
    b = rng.normal(size=(NA, R, OUT)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    if pad_rank is not None:
        a[1, :, pad_rank:] = 0.0
        b[1, pad_rank:, :] = 0.0
    return x, a, b


def _t(arr, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)


def _j(arr, dtype=jnp.float32):
    return jnp.asarray(arr, dtype)


def test_plain_matches_pallas_interpret_and_xla_gather():
    """The shapes of the JAX package's own interpret-mode check, rank
    padding included. f32 on all three sides: only the summation order
    differs (tolerance 1e-4 on values of magnitude ~30)."""
    B, IN, R, OUT, NA = 6, 64, 8, 128, 4
    x, a, b = _factors(0, B, IN, R, OUT, NA, pad_rank=6)
    ids = np.asarray([0, 1, 1, 2, 3, 0], np.int32)
    pallas = np.asarray(_lora_call(_j(x), _j(a), _j(b), jnp.asarray(ids)))
    xla = np.asarray(lora_delta_xla(_j(x), _j(a), _j(b), jnp.asarray(ids)))
    got = lm.lora_delta_plain(_t(x), _t(a), _t(b), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-4)
    # Null rows are exact zeros, as the Pallas kernel gives them.
    assert (got[0] == 0).all() and (got[5] == 0).all()
    assert (pallas[0] == 0).all()


@pytest.mark.parametrize("shape", [(5, 32), (3, 4, 32)], ids=["2d", "3d"])
def test_gather_matches_xla_f32(shape):
    """f32: the same casts (none) and roundings (none) on both sides; sums
    of 32 and 8 terms in another order: tolerance 1e-6 of the largest value
    (~40, so a few f32 steps)."""
    IN, R, OUT, NA = shape[-1], 8, 48, 3
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    _, a, b = _factors(2, 1, IN, R, OUT, NA)
    ids = np.asarray([2, 0, 1, 2, 1][: shape[0]], np.int32)
    want = np.asarray(lora_delta_xla(_j(x), _j(a), _j(b), jnp.asarray(ids)))
    got = lm.lora_delta_gather(_t(x), _t(a), _t(b), torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (*shape[:-1], OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert (got[ids == 0] == 0).all()


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 64)], ids=["2d", "3d"])
def test_gather_matches_xla_bf16(shape):
    """bf16: both sides cast the factors to bf16, form t in f32, round t to
    bf16 and form the output in f32 before one bf16 rounding. bf16 products
    are exact in f32, so the sides differ only in the f32 summation order,
    which can flip a rounding of t (one bf16 step, 2^-8 relative) and then
    the output by one step: tolerance 2^-7 relative plus 2^-7 of the
    largest value. Most elements are bit-identical."""
    IN, R, OUT, NA = shape[-1], 16, 64, 4
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    _, a, b = _factors(4, 1, IN, R, OUT, NA)
    ids = np.asarray([3, 1, 0, 2, 1, 3][: shape[0]], np.int32)
    want = np.asarray(
        lora_delta_xla(_j(x, jnp.bfloat16), _j(a, jnp.bfloat16), _j(b, jnp.bfloat16),
                       jnp.asarray(ids)).astype(jnp.float32))
    got = lm.lora_delta_gather(_t(x, torch.bfloat16), _t(a, torch.bfloat16),
                               _t(b, torch.bfloat16), torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert (np.abs(got - want) <= 2.0**-7 * (np.abs(want) + scale)).all()
    assert (got == want).mean() > 0.9
    assert (got[ids == 0] == 0).all()


def test_plain_null_rows_exact_zero_even_for_nonfinite_x():
    x, a, b = _factors(5, 4, 16, 4, 8, 3)
    x[1] = np.inf
    got = lm.lora_delta_plain(_t(x), _t(a), _t(b), torch.tensor([1, 0, 2, 0], dtype=torch.int32))
    assert (got[1] == 0).all() and (got[3] == 0).all()
    assert torch.isfinite(got[[0, 2]]).all()


def test_plain_rows_independent_of_the_batch():
    """A row's result is bit-identical to the same row computed alone."""
    x, a, b = _factors(6, 7, 64, 8, 40, 4)
    ids = torch.tensor([1, 2, 3, 0, 2, 1, 3], dtype=torch.int32)
    full = lm.lora_delta_plain(_t(x), _t(a), _t(b), ids)
    for n in range(7):
        solo = lm.lora_delta_plain(_t(x[n:n + 1]), _t(a), _t(b), ids[n:n + 1])
        assert torch.equal(full[n:n + 1], solo)


@pytest.mark.parametrize("case, routed", [
    ("2d", "kernel"), ("2d_256", "kernel"), ("3d", "gather"), ("2d_257", "gather"),
    ("int", "gather"),
])
def test_dispatcher_splits_by_shape(monkeypatch, case, routed):
    calls = []
    monkeypatch.setattr(lm, "lora_bgmv_group", lambda *a: calls.append("kernel") or ["k"])
    monkeypatch.setattr(lm, "lora_delta_gather", lambda *a: calls.append("gather") or "g")
    a = torch.zeros(2, 8, 4)
    b = torch.zeros(2, 4, 8)
    x = {"2d": torch.zeros(3, 8), "2d_256": torch.zeros(256, 8), "3d": torch.zeros(2, 5, 8),
         "2d_257": torch.zeros(257, 8), "int": torch.zeros(3, 8, dtype=torch.int32)}[case]
    lm.lora_delta(x, {"a": a, "b": b}, torch.zeros(x.shape[0], dtype=torch.int32))
    assert calls == [routed]


def test_wrapper_runs_the_plain_version_on_cpu_and_does_not_count():
    x, a, b = _factors(7, 3, 16, 4, 8, 3)
    ids = torch.tensor([2, 0, 1], dtype=torch.int32)
    before = lm.lora_bgmv_group.launches
    got = lm.lora_bgmv(_t(x), _t(a), _t(b), ids)
    assert torch.equal(got, lm.lora_delta_plain(_t(x), _t(a), _t(b), ids))
    assert lm.lora_bgmv_group.launches == before


def test_lora_part_matches_the_jax_package_and_every_target():
    # The base weight's tensor-parallel role per target key, which the later
    # multi-GPU wrapper reads: the same table as the reference, one entry
    # per key the loaders stack.
    from localai_tpu.ops.lora_matmul import LORA_PART as JAX_LORA_PART
    from localai_tpu_torch.engine.weights import lora_target_dims
    from localai_tpu_torch.models import get_arch

    assert lm.LORA_PART == JAX_LORA_PART
    assert set(lm.LORA_PART) == set(lora_target_dims(get_arch("tiny")))


# --------------------------------------------------------------------------- #
# The grouped dispatcher (one launch per group of targets that share x)
# --------------------------------------------------------------------------- #


def _group(seed, B, IN, R, outs, NA):
    """x [B, IN] and one (a, b) pair per output width, f32 from a numpy
    seed, row 0 of every stack the null adapter."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, IN)).astype(np.float32)
    pairs = []
    for out in outs:
        a = rng.normal(size=(NA, IN, R)).astype(np.float32)
        b = rng.normal(size=(NA, R, out)).astype(np.float32)
        a[0] = 0.0
        b[0] = 0.0
        pairs.append((a, b))
    return x, pairs


@pytest.mark.parametrize("outs", [(128,), (128, 32), (128, 32, 32)], ids=["1", "2", "3"])
def test_grouped_dispatcher_matches_each_target_and_the_jax_package(outs):
    """q / k / v shapes (unequal out): each target of the grouped call is
    bit-identical to the one-target plain version (decode rows) and gather
    form (prefill rows), and within 1e-4 (f32, summation order) of the JAX
    package's Pallas kernel in interpret mode and its XLA gather form."""
    B, IN, R, NA = 6, 64, 8, 4
    x, pairs = _group(10, B, IN, R, outs, NA)
    ids = np.asarray([0, 3, 1, 1, 2, 0], np.int32)
    entries = [{"a": _t(a), "b": _t(b)} for a, b in pairs]
    tid = torch.from_numpy(ids)
    got = lm.lora_deltas(_t(x), entries, tid)
    x3 = _t(x)[:, None, :].expand(B, 3, IN).contiguous()
    got3 = lm.lora_deltas(x3, entries, tid)
    assert len(got) == len(got3) == len(outs)
    for (a, b), e, g, g3 in zip(pairs, entries, got, got3):
        assert torch.equal(g, lm.lora_delta_plain(_t(x), e["a"], e["b"], tid))
        assert torch.equal(g, lm.lora_delta(_t(x), e, tid))
        assert torch.equal(g3, lm.lora_delta_gather(x3, e["a"], e["b"], tid))
        pallas = np.asarray(_lora_call(_j(x), _j(a), _j(b), jnp.asarray(ids)))
        xla = np.asarray(lora_delta_xla(_j(x), _j(a), _j(b), jnp.asarray(ids)))
        np.testing.assert_allclose(g.numpy(), pallas, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), xla, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g3[:, 1].numpy(), xla, rtol=0, atol=1e-4)
        assert (g[ids == 0] == 0).all()


@pytest.mark.parametrize("case, calls_want", [
    ("2d", [("kernel", 3)]), ("3d", [("gather", 1)] * 3), ("2d_257", [("gather", 1)] * 3),
])
def test_grouped_dispatcher_makes_one_kernel_call_per_group(monkeypatch, case, calls_want):
    calls = []
    monkeypatch.setattr(lm, "lora_bgmv_group",
                        lambda x, pairs, ids: calls.append(("kernel", len(pairs))) or
                        [torch.zeros(())] * len(pairs))
    monkeypatch.setattr(lm, "lora_delta_gather",
                        lambda *a: calls.append(("gather", 1)) or torch.zeros(()))
    entries = [{"a": torch.zeros(2, 8, 4), "b": torch.zeros(2, 4, n)} for n in (8, 16, 16)]
    x = {"2d": torch.zeros(3, 8), "3d": torch.zeros(2, 5, 8),
         "2d_257": torch.zeros(257, 8)}[case]
    out = lm.lora_deltas(x, entries, torch.zeros(x.shape[0], dtype=torch.int32))
    assert len(out) == 3 and calls == calls_want


def test_group_skips_absent_keys(monkeypatch):
    """models/llama._lora_add: only the keys in this layer's stacks go to
    the grouped call, in their order; absent keys keep the base product,
    and no stacks at all make no call."""
    from localai_tpu_torch.models import llama

    calls = []

    def fake(x, entries, ids):
        calls.append([e["tag"] for e in entries])
        return [torch.full_like(x, float(e["tag"])) for e in entries]

    monkeypatch.setattr(llama, "lora_deltas", fake)
    x = torch.zeros(2, 4)
    ys = [torch.ones(2, 4), 2 * torch.ones(2, 4), 3 * torch.ones(2, 4)]
    ids = torch.zeros(2, dtype=torch.int32)
    got = llama._lora_add(({"wq": {"tag": 10}, "wv": {"tag": 30}}, ids),
                                ("wq", "wk", "wv"), x, ys)
    assert calls == [[10, 30]]
    assert torch.equal(got[0], torch.full((2, 4), 11.0))
    assert got[1] is ys[1]
    assert torch.equal(got[2], torch.full((2, 4), 33.0))
    assert llama._lora_add(({"wo": {"tag": 1}}, ids), ("wq", "wk", "wv"), x, ys) is ys
    assert llama._lora_add(None, ("w_gate", "w_up"), x, ys) is ys
    assert calls == [[10, 30]]


# --------------------------------------------------------------------------- #
# The kernel's plan, and its clusters emulated on the CPU
# --------------------------------------------------------------------------- #

# The served group shapes (in, outs) and ranks: llama-3.2-1b q / k / v and
# gate / up, llama-3-8b q / v and down.
PLAN_SHAPES = [(2048, (2048, 512, 512)), (2048, (8192, 8192)), (4096, (4096, 1024)),
               (14336, (4096,)), (64, (96,))]


@pytest.mark.parametrize("R", [1, 8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("n_in, outs", PLAN_SHAPES)
def test_plan_depends_on_shapes_only(n_in, outs, R):
    """The cluster's blocks cover in and every out in multiples of 16; a pass
    holds at most 32 KB of bf16 factors and 512 rows; none of it changes
    with the row count (so a row's sums run in one order whatever the
    batch); the slots and the grid follow from the shapes, and the plan
    takes no ids at all."""
    import inspect

    assert "ids" not in inspect.signature(lm.lora_plan).parameters
    NA = 9
    plans = {N: lm.lora_plan(n_in, outs, R, N, NA) for N in (1, 8, 9, 200, 256)}
    p = plans[9]
    C = p.cluster
    assert p.rank_pad % 16 == 0 and p.rank_pad - 16 < R <= p.rank_pad
    assert 1 <= C <= 16
    assert p.slice_rows % 16 == 0 and p.slice_rows * C >= n_in > p.slice_rows * C - 16 * C
    assert p.pass_rows % 16 == 0 and 16 <= p.pass_rows <= min(p.slice_rows, 512)
    assert p.pass_rows * (p.rank_pad + 8) * 2 <= 32768 or p.pass_rows == 16
    assert len(p.cols) == len(outs)
    for c, o in zip(p.cols, outs):
        assert c % 16 == 0 and c * C >= o > c * C - 16 * C
    assert p.pass_cols % 16 == 0 and p.pass_cols <= max(p.cols)
    assert p.pass_cols * p.rank_pad * 2 <= 32768 or p.pass_cols == 16
    for N, q in plans.items():
        assert q._replace(slots=0) == p._replace(slots=0)
        assert q.slots == min(N, NA - 1)
        assert q.blocks() == q.slots * len(outs) * C


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="rank"):
        lm.lora_plan(64, (64,), 129, 4, 3)
    assert lm.lora_plan(64, (64,), 8, 4, 1).slots == 1  # the null adapter only: fill rows


def _emulate_kernel(x, pairs, ids, plan):
    """csrc/lora_matmul.cu's clusters in torch on the CPU: the cluster of
    (slot k, target t) serves the k-th distinct valid non-null id in row
    order; block c owns rows [c * slice_rows, ...) of IN and cols[t] output
    columns; its f32 partial of t over its slice joins the others' in rank
    order, t is split into bf16 hi + lo for bf16 operands, and each block
    writes its columns once; slot 0's clusters write the null (0) and
    bad-id (NaN) rows. Checks that every output element is written exactly
    once."""
    N, n_in = x.shape
    NA, _, R = pairs[0][0].shape
    C = plan.cluster
    mma = x.dtype == torch.bfloat16 and pairs[0][0].dtype == torch.bfloat16
    host = ids.tolist()
    leaders = []
    for i in host:
        if 0 < i < NA and i not in leaders:
            leaders.append(i)
    outs = [torch.full((N, b.shape[2]), float("nan")) for _, b in pairs]
    writes = [torch.zeros((N, b.shape[2]), dtype=torch.int32) for _, b in pairs]
    xf = x.float()
    for k in range(plan.slots):
        for t, (a_all, b_all) in enumerate(pairs):
            OUT = b_all.shape[2]
            if k == 0:
                for c in range(C):
                    lo, hi = c * plan.cols[t], min(OUT, (c + 1) * plan.cols[t])
                    for n, i in enumerate(host):
                        if not 0 < i < NA and lo < hi:
                            outs[t][n, lo:hi] = 0.0 if i == 0 else float("nan")
                            writes[t][n, lo:hi] += 1
            if k >= len(leaders):
                continue
            rows = [n for n, i in enumerate(host) if i == leaders[k]]
            a, b = a_all[leaders[k]].float(), b_all[leaders[k]].float()
            partials = []
            for c in range(C):
                lo, hi = min(n_in, c * plan.slice_rows), min(n_in, (c + 1) * plan.slice_rows)
                partials.append(xf[rows, lo:hi] @ a[lo:hi])
            tsum = partials[0]
            for part in partials[1:]:
                tsum = tsum + part
            if mma:
                t_hi = tsum.bfloat16().float()
                y = t_hi @ b + (tsum - t_hi).bfloat16().float() @ b
            else:
                y = tsum @ b
            for c in range(C):
                lo, hi = c * plan.cols[t], min(OUT, (c + 1) * plan.cols[t])
                if lo < hi:
                    outs[t][rows, lo:hi] = y[:, lo:hi].to(x.dtype).float()
                    writes[t][rows, lo:hi] += 1
    assert all(bool((w == 1).all()) for w in writes)
    return [o.to(x.dtype) for o in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids", [
    [1, 2, 3, 4, 0, 5, 6, 7, 8],            # 8 tenants and a null row
    [3, 3, 0, 3, 1, 1, 3, 2, 0],            # repeated ids: segments of 1-4 rows
    [0, 0, 0, 0, 0, 0, 0, 0, 0],            # no tenant: fill items only
    [5, 5, 5, 5, 5, 5, 5, 5, 5],            # one segment of 9 rows
    [2, 9, 0, -1, 2, 1, 4, 6, 8],           # bad ids (9, -1): NaN rows
], ids=["distinct", "repeated", "all_null", "one_segment", "bad"])
def test_kernel_items_emulated_match_the_plain_version(ids, dtype):
    """Whatever the ids, the plan's fixed clusters cover each output element
    exactly once, and their arithmetic matches lora_delta_plain: f32 within
    1e-5 of the largest value (summation order); bf16 within one bf16 step
    (2^-7) plus 1e-4 of the largest value, with t split into hi + lo."""
    N, IN, R, NA, outs = 9, 400, 24, 9, (264, 128, 136)  # ragged last slice and tiles
    x, pairs = _group(11, N, IN, R, outs, NA)
    xt = _t(x, dtype)
    tp = [(_t(a * 0.1, dtype), _t(b * 0.1, dtype)) for a, b in pairs]
    tid = torch.tensor(ids, dtype=torch.int32)
    plan = lm.lora_plan(IN, outs, R, N, NA)
    assert plan.slice_rows * plan.cluster > IN  # ragged and empty slices at the end
    got = _emulate_kernel(xt, tp, tid, plan)
    safe = torch.tensor([0 if not 0 <= i < NA else i for i in ids], dtype=torch.int32)
    bad = torch.tensor([not 0 <= i < NA for i in ids])
    for (a, b), g in zip(tp, got):
        want = lm.lora_delta_plain(xt, a, b, safe).float()
        gf = g.float()
        assert torch.isnan(gf[bad]).all() and not torch.isnan(gf[~bad]).any()
        assert (gf[tid == 0] == 0).all()
        err = (gf[~bad] - want[~bad]).abs()
        scale = want.abs().max().item()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * max(scale, 1e-30)
        else:
            assert (err <= 2.0**-7 * want[~bad].abs() + 1e-4 * scale).all()
