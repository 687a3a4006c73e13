"""B2's split-KV kernel (localai_tpu_torch/csrc/paged_attention.cu) on the
CPU: its split plan, and a torch emulation of the kernel's arithmetic held
against `paged_partials_plain` and, through the port's entry points,
against the JAX package's XLA walk.

The emulation repeats what the CUDA source does, in f32: the plan's
splits, each walking its rows in 64-key tiles; the softmax states the
kernel keeps (the mma kernel: one per 16-key quarter of a tile when a
block owns 16 query rows, one per row otherwise; the scalar f32 kernel:
one per warp of 32-row tiles), combined in state order; q and p split
into bf16 hi + lo for the tensor cores (K / V widened exactly); kv_scale
folded into q and the finished acc; and the merge of the live splits in
split order. A wrong split edge, mask, merge or scale shows here as a
wrong partial, before any run on the card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops import attention as ja
from localai_tpu_torch.models.llama import kv_cast
from localai_tpu_torch.ops import paged_flash as tpf

H100_SMS = 132
NEG_INF = -1e30
L2E = 1.4426950408889634
# The card's tolerance (chip_smoke.py, tests/test_torch_cuda.py): f32 on
# both sides, summation order and the hi / lo residue only.
TOL = 2e-4
ENGINE_CAPACITY = 4096  # chip_smoke's paged engines: max_seq 4096, pages of 128


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small tensor ops: one intra-op thread runs them fastest, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# The split plan
# --------------------------------------------------------------------------- #

PLAN_CASES = [  # (capacity, page, K, QR, D, pool dtype)
    (4096, 128, 8, 4, 64, torch.bfloat16),      # llama-3.2-1b decode
    (4096, 128, 8, 4, 128, torch.float8_e4m3fn),  # llama-3-8b decode, fp8 pool
    (4096, 128, 4, 7, 128, torch.bfloat16),     # qwen2-7b decode, G = 7
    (4096, 128, 8, 16, 64, torch.bfloat16),     # a 4-token verify, G = 4
    (4096, 128, 8, 2048, 64, torch.bfloat16),   # a 512-token chunk, G = 4
    (512, 16, 2, 2, 64, torch.float32),         # tiny-d64, f32
    (32, 16, 2, 4, 64, torch.bfloat16),         # smaller than a key tile
    (131072, 16, 8, 4, 128, torch.bfloat16),    # a 128k-token slot
    (8192, 1, 8, 4, 64, torch.bfloat16),        # pages of one row
    (24576, 1, 1, 4, 64, torch.bfloat16),       # the widest table of one-row pages
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_splits_cover_each_slot_once_in_order(case):
    capacity, page, K, QR, D, dt = case
    plan = tpf.paged_plan(capacity, page, K, QR, D, dt, H100_SMS)
    assert plan.unit % tpf.KEY_TILE == 0 and 1 <= plan.splits <= tpf._MAX_SPLITS
    u = plan.unit
    for n in sorted({0, 1, u - 1, u, u + 1, 2 * u, capacity // 3, capacity - 1, capacity}):
        if not 0 <= n <= capacity:
            continue
        edges = plan.split_edges(n)
        # Consecutive, disjoint, the union [0, n), in merge order, at most
        # `splits` of them, every one but the last the same whole units.
        assert edges[0][0] == 0 and edges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        assert all(b > a for a, b in edges) or edges == [(0, 0)]
        assert len(edges) <= plan.splits
        rows = plan.split_rows(n)
        assert rows % u == 0 and all(b - a == rows for a, b in edges[:-1])
        # The kernel's page-table slice holds the split's pages.
        assert (rows - 1) // page + 2 <= tpf._TABLE_SLICE
    if dt == torch.float32:
        assert plan.kernel == "scalar" and plan.row_tile == (4 if QR <= 4 else 16)
    else:
        assert plan.kernel == "mma" and plan.row_tile == (16 if QR <= 16 else 64)


def test_plan_never_sees_the_batch_or_the_limits():
    """The plan takes no B and no limits, and the wrapper's plan of a call
    is the same whatever its batch: a slot's partials then do not depend on
    what else the batch holds."""
    params = inspect.signature(tpf.paged_plan).parameters
    assert list(params) == ["capacity", "page", "K", "QR", "D", "pool_dtype", "sm_count"]
    plans = set()
    for B in (1, 2, 3, 8, 64):
        qr = torch.zeros(B, 8, 4, 64)
        pool = torch.zeros(B * 32 + 1, 128, 8, 64, dtype=torch.bfloat16)
        table = torch.zeros(B, 32, dtype=torch.int32)
        plans.add(tpf.plan_for(qr, pool, table, H100_SMS))
    assert len(plans) == 1


@pytest.mark.parametrize("D", [64, 128])
def test_plan_fills_the_card_at_the_engine_shapes(D):
    dec = tpf.paged_plan(ENGINE_CAPACITY, 128, 8, 4, D, torch.bfloat16, H100_SMS)
    # One slot at full length spreads over the card; 8 fill it 8 times.
    assert dec.tiles(1, 8, 4) * len(dec.split_edges(ENGINE_CAPACITY)) >= H100_SMS - 4
    assert dec.tiles(8, 8, 4) * len(dec.split_edges(ENGINE_CAPACITY)) >= 4 * H100_SMS
    # A short context spreads too, in short splits: 8 slots of 500 rows.
    assert len(dec.split_edges(500)) == 4 and dec.tiles(8, 8, 4) * 4 >= H100_SMS
    # A 512-token chunk (G = 4): 32 row tiles of each of 8 heads fill the
    # card unsplit, so it is not split (no partials to merge).
    chunk = tpf.paged_plan(ENGINE_CAPACITY, 128, 8, 2048, D, torch.bfloat16, H100_SMS)
    assert chunk.tiles(1, 8, 2048) >= H100_SMS and chunk.splits == 1


def test_plan_values_at_the_engine_shapes():
    assert tpf.paged_plan(4096, 128, 8, 4, 64, torch.bfloat16, H100_SMS) == \
        tpf.PagedPlan("mma", 16, 16, 128)
    assert tpf.paged_plan(4096, 128, 8, 2048, 64, torch.bfloat16, H100_SMS) == \
        tpf.PagedPlan("mma", 64, 1, 128)
    assert tpf.paged_plan(32, 16, 2, 4, 64, torch.bfloat16, H100_SMS) == \
        tpf.PagedPlan("mma", 16, 16, 128)
    plan = tpf.paged_plan(4096, 128, 8, 4, 64, torch.bfloat16, H100_SMS)
    assert [plan.split_rows(n) for n in (0, 1, 500, 2048, 2049, 4096)] == \
        [128, 128, 128, 128, 256, 256]
    assert plan.workspace_floats(8, 8, 4, 64) == 8 * 8 * 16 * 16 * 66
    assert tpf.paged_plan(4096, 128, 8, 2048, 64, torch.bfloat16, H100_SMS).workspace_floats(
        1, 8, 2048, 64) == 0  # one split: no workspace


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no plan"):
        tpf.paged_plan(4096, 128, 8, 4, 96, torch.bfloat16, H100_SMS)
    with pytest.raises(ValueError, match="no plan"):
        tpf.paged_plan(4096, 128, 8, 4, 64, torch.float16, H100_SMS)
    with pytest.raises(ValueError, match="at most 64"):  # 1M rows in one-row pages
        tpf.paged_plan(1 << 20, 1, 8, 4, 64, torch.bfloat16, H100_SMS)


# --------------------------------------------------------------------------- #
# A torch emulation of the kernel's arithmetic
# --------------------------------------------------------------------------- #


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _split_parts(hilo, kernel):
    """The tensor cores' operands: q and p as bf16 hi + lo (or, to show
    what it buys, one bf16 rounding); the scalar kernel keeps f32."""
    if kernel == "scalar":
        return lambda x: (x, torch.zeros_like(x))
    if hilo:
        return _hi_lo
    return lambda x: (_bf16(x), torch.zeros_like(x))


def _merge(m, l, acc, dim):
    """Softmax states along `dim` combined as emit_tile and the split merge
    do: weights exp(m - max), the acc weighted in the same way."""
    mx = m.amax(dim)
    f = torch.exp(m - mx.unsqueeze(dim))
    return mx, (l * f).sum(dim), (acc * f.unsqueeze(-1)).sum(dim)


def _slot_partials(q, qpos, k, v, n_rows, plan, softcap, window, hilo, vsc):
    """One slot's partials as the kernel forms them: q [K, QR, D] (ksc
    applied), k / v [n_rows, K, D] f32. The slot's rows go to its splits
    (plan.split_edges); in a split, key o belongs to softmax state
    (o % span) // group: the mma kernel's 4 warps take 16 keys of each
    64-key tile when a block owns 16 rows (one state a warp), else all 64
    (one state); the scalar kernel's 8 warps take 32-key tiles w, w + 8,
    ... of each 256 keys. Each state's online softmax over its tiles is
    taken in one step here (the same function up to rounding); the states
    combine in order, acc takes the V scale, and the splits merge in order.
    Returns (m [K, QR], l [K, QR], acc [K, QR, D])."""
    K, QR, D = q.shape
    if n_rows == 0:
        return torch.full((K, QR), NEG_INF), torch.zeros(K, QR), torch.zeros(K, QR, D)
    if plan.kernel == "mma":
        span, group = tpf.KEY_TILE, (16 if plan.row_tile == 16 else 64)
    else:
        span, group = 256, 32
    rows, n_sp = plan.split_rows(n_rows), len(plan.split_edges(n_rows))
    padded = -(-rows // span) * span
    o = torch.arange(padded)
    g = torch.arange(n_sp)[:, None] * rows + o[None, :]  # [n_sp, padded] the slot's rows
    live = (o[None, :] < rows) & (g < n_rows)
    idx = g.clamp(max=n_rows - 1)
    kt = torch.where(live[..., None, None], k[idx], 0.0)  # past a split's end zero-filled
    vt = torch.where(live[..., None, None], v[idx], 0.0)
    split = _split_parts(hilo, plan.kernel)
    qh, ql = split(q)
    s = torch.einsum("krd,snkd->skrn", qh, kt) + torch.einsum("krd,snkd->skrn", ql, kt)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = live[:, None, None, :].expand(n_sp, K, QR, padded)
    if window:
        ok = ok & ((qpos[None, None, :, None] - g[:, None, None, :]) < window)
    s = torch.where(ok, s, NEG_INF)
    shape = (n_sp, K, QR, padded // span, span // group, group)  # keys -> (tile, state, key)
    s, ok = s.reshape(shape), ok.reshape(shape)
    m = s.amax(dim=(3, 5))  # [n_sp, K, QR, states]
    if plan.kernel == "mma":
        p = torch.exp2(s * L2E - (m * L2E)[:, :, :, None, :, None])
    else:
        p = torch.exp(s - m[:, :, :, None, :, None])
    p = torch.where(ok, p, 0.0)
    l = p.sum(dim=(3, 5))
    vg = vt.reshape(n_sp, padded // span, span // group, group, K, D)
    ph, pl = split(p)
    acc = (torch.einsum("skrtwj,stwjkd->skrwd", ph, vg)
           + torch.einsum("skrtwj,stwjkd->skrwd", pl, vg))
    m, l, acc = _merge(m, l, acc, dim=3)  # the block's states, in order
    acc = acc * vsc[None, :, None, None]
    return (m[0], l[0], acc[0]) if n_sp == 1 else _merge(m, l, acc, dim=0)


def emulate(qr, qpos, k_pool, v_pool, table, limits, softcap=0.0, window=0, kv_scale=None,
            plan=None, hilo=True, row_block=256):
    """The kernel's partials (acc, m, l) by its own arithmetic, on the CPU
    (q rows in blocks of `row_block`: each row's partials are its own)."""
    B, K, QR, D = qr.shape
    P, page = k_pool.shape[:2]
    MP = table.shape[1]
    plan = plan or tpf.plan_for(qr, k_pool, table, H100_SMS)
    kf, vf = k_pool.float(), v_pool.float()  # exact widening of bf16 / fp8
    ksc = kv_scale[0] if kv_scale is not None else torch.ones(K)
    vsc = kv_scale[1] if kv_scale is not None else torch.ones(K)
    acc_o = torch.zeros(B, K, QR, D)
    m_o = torch.full((B, K, QR), NEG_INF)
    l_o = torch.zeros(B, K, QR)
    for b in range(B):
        n_rows = min(max(int(limits[b]), 0), MP * page)
        g = torch.arange(n_rows)
        pid = table[b, g // page].long().clamp(0, P - 1)
        kb, vb = kf[pid, g % page], vf[pid, g % page]  # [n_rows, K, D]
        q = qr[b] * ksc[:, None, None]
        for r0 in range(0, QR, row_block):
            r1 = min(r0 + row_block, QR)
            m_o[b, :, r0:r1], l_o[b, :, r0:r1], acc_o[b, :, r0:r1] = _slot_partials(
                q[:, r0:r1], qpos[b, r0:r1].long(), kb, vb, n_rows, plan, softcap, window,
                hilo, vsc)
    return acc_o, m_o, l_o


def _inputs(seed, B, K, QR, D, page, MP, dtype, limits, G=4, scaled=False):
    rng = np.random.default_rng(seed)
    P = B * MP + 1
    qr = torch.from_numpy(rng.standard_normal((B, K, QR, D)).astype(np.float32)) / D**0.5
    kp = torch.from_numpy(rng.standard_normal((P, page, K, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, K, D)).astype(np.float32))
    scale = None
    if dtype.itemsize == 1 and scaled:  # stored = value / scale
        scale = torch.stack([torch.linspace(0.5, 4.0, K), torch.linspace(3.0, 0.25, K)])
        kp, vp = kp / scale[0][:, None], vp / scale[1][:, None]
    kp, vp = kv_cast(kp, dtype), kv_cast(vp, dtype)
    table = torch.from_numpy(rng.permutation(P - 1)[: B * MP].reshape(B, MP).astype(np.int32))
    lim = torch.tensor(limits, dtype=torch.int32)
    qpos = (lim[:, None] + torch.arange(QR)[None, :] // G).to(torch.int32)
    return qr, qpos, kp, vp, table, lim, scale


def _assert_close(got, want, limits, tol=TOL):
    """chip_smoke's measure: acc / l, m, and l relative, over live slots;
    idle slots exact."""
    acc, m, l = got
    racc, rm, rl = want
    live = torch.as_tensor(limits) > 0
    o = acc / l.clamp(min=1e-30)[..., None]
    ro = racc / rl.clamp(min=1e-30)[..., None]
    scale = max(1.0, ro[live].abs().max().item())
    assert (o - ro)[live].abs().max().item() <= tol * scale
    assert ((m - rm)[live].abs() / rm[live].abs().clamp(min=1.0)).max().item() <= tol
    assert ((l - rl)[live].abs() / rl[live]).max().item() <= tol
    idle = ~live
    assert (m[idle] == NEG_INF).all() and (l[idle] == 0).all() and (acc[idle] == 0).all()


# Capacity 4096 in splits of 128-row units, at most 16 a slot (K = 2):
# limits at a split edge and one row either side (2, 2 and 3 splits of
# 128), idle, full (16 of 256), one row past 16 units (9 of 256: a 1-row
# last split), one row, 16 units (16 of 128).
EDGES = [256, 255, 257, 0, 4096, 2049, 1, 2048]
EDGE_SPLITS = [2, 2, 3, 1, 16, 9, 1, 16]

EMULATED = [  # (name, G, T, K, D, page, MP, dtype, limits, softcap, window, scaled)
    ("decode_page32", 4, 1, 2, 64, 32, 128, torch.bfloat16, EDGES, 0.0, 0, False),
    ("decode_g7_page128", 7, 1, 2, 128, 128, 32, torch.bfloat16, EDGES, 0.0, 0, False),
    ("decode_g1", 1, 1, 2, 64, 64, 64, torch.bfloat16, EDGES, 0.0, 0, False),
    ("softcap_window", 2, 1, 2, 64, 64, 64, torch.bfloat16, EDGES, 30.0, 300, False),
    ("verify_t4", 4, 4, 2, 64, 128, 32, torch.bfloat16, EDGES, 0.0, 0, False),
    ("mq_t15", 4, 15, 2, 64, 128, 32, torch.bfloat16, EDGES, 20.0, 200, False),
    ("fp8_e4m3", 4, 1, 2, 128, 128, 32, torch.float8_e4m3fn, EDGES, 0.0, 0, True),
    ("fp8_e5m2_mq", 4, 5, 2, 64, 64, 64, torch.float8_e5m2, EDGES, 0.0, 0, True),
    ("f32", 4, 1, 2, 64, 128, 32, torch.float32, EDGES, 0.0, 0, False),
    ("f32_mq_window", 4, 6, 2, 64, 64, 64, torch.float32, EDGES, 30.0, 300, False),
]


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_kernel_matches_plain_version(case):
    name, G, T, K, D, page, MP, dt, limits, softcap, window, scaled = case
    QR = G * T
    qr, qpos, kp, vp, table, lim, scale = _inputs(len(name), len(limits), K, QR, D, page, MP,
                                                  dt, limits, G, scaled)
    plan = tpf.plan_for(qr, kp, table, H100_SMS)
    assert plan.splits == 16 and plan.unit == 128  # the limits above sit at split edges
    assert [len(plan.split_edges(n)) for n in EDGES] == EDGE_SPLITS
    args = (qr, qpos, kp, vp, table, lim, softcap, window, scale)
    got = emulate(*args)
    _assert_close(got, tpf.paged_partials_plain(*args), limits)


@pytest.mark.parametrize("mq", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float8_e4m3fn, torch.float32])
def test_emulated_kernel_through_the_entry_points_matches_jax_walk(monkeypatch, dt, mq):
    """The port's decode / multi-query entry points with the kernel's
    arithmetic in place of paged_partials_rows, against the JAX package's
    XLA walk on the same bytes (fp8 pools with a per-head kv_scale)."""
    B, H, K, D, page, MP, T = len(EDGES), 4, 2, 64, 16, 256, 3
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, T, H, D) if mq else (B, H, D)).astype(np.float32)
    kp = rng.standard_normal((B * MP + 1, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((B * MP + 1, page, K, D)).astype(np.float32)
    scale = np.array([[0.5, 3.0], [2.0, 0.25]], np.float32) if dt.itemsize == 1 else None
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    if scale is not None:
        tk, tv = tk / torch.from_numpy(scale[0])[:, None], tv / torch.from_numpy(scale[1])[:, None]
    tk, tv = kv_cast(tk, dt), kv_cast(tv, dt)
    # The JAX walk reads the same stored values, widened to f32.
    jk, jv = jnp.asarray(tk.float().numpy()), jnp.asarray(tv.float().numpy())
    table = rng.permutation(B * MP)[: B * MP].reshape(B, MP).astype(np.int32)
    limits = np.asarray(EDGES, np.int32)
    kw = dict(softcap=30.0, window=300)
    monkeypatch.setattr(tpf, "paged_partials_rows", emulate)
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(table), torch.from_numpy(limits))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(limits))
    tsc = None if scale is None else torch.from_numpy(scale)
    jsc = None if scale is None else jnp.asarray(scale)
    if mq:
        qpos = (limits[:, None] + np.arange(T)[None, :]).astype(np.int32)
        got = tpf.paged_decode_partials_mq(*targs, q_pos=torch.from_numpy(qpos), sliding=True,
                                           kv_scale=tsc, **kw)
        want = ja._paged_cache_partials_mq(*jargs, q_pos=jnp.asarray(qpos),
                                           sliding=jnp.asarray(True), kv_scale=jsc, **kw)
    else:
        got = tpf.paged_decode_partials(*targs, sliding=True, kv_scale=tsc, **kw)
        want = ja._paged_cache_partials(*jargs, sliding=jnp.asarray(True), kv_scale=jsc, **kw)
    want = [torch.from_numpy(np.array(w)) for w in want]
    _assert_close([got[0], got[1][..., 0], got[2][..., 0]],
                  [want[0], want[1][..., 0], want[2][..., 0]], EDGES)


@pytest.mark.parametrize("shape", ["chunk", "decode_d128"])
def test_hi_lo_products_hold_the_card_tolerance(shape):
    """At chip_smoke's chunk (one 512-token chunk of G = 4 rows at offset
    1536, D = 64) and its D = 128 decode shape, the hi / lo bf16 products
    stay inside 2e-4 of the f32 walk, where one bf16 rounding of q and p
    would not."""
    if shape == "chunk":
        B, G, T, K, D, limits = 1, 4, 512, 8, 64, [1536]
    else:
        B, G, T, K, D, limits = 8, 4, 1, 8, 128, [4096, 0, 3001, 17, 2048, 256, 4095, 900]
    qr, qpos, kp, vp, table, lim, _ = _inputs(5, B, K, G * T, D, 128, 32, torch.bfloat16,
                                              limits, G)
    args = (qr, qpos, kp, vp, table, lim)
    want = tpf.paged_partials_plain(*args)
    _assert_close(emulate(*args), want, limits)
    with pytest.raises(AssertionError):
        _assert_close(emulate(*args, hilo=False), want, limits)
