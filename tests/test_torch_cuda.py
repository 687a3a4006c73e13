"""The PyTorch port's kernels on the card: each CUDA kernel against its
plain PyTorch version, and the wrappers' refusal to route a CUDA tensor
anywhere but the kernel.

Every test here carries the `cuda` marker and skips without a GPU or
without nvcc. The file imports neither jax nor the JAX package, so on the
GPU machine it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from localai_tpu_torch import kernels
from localai_tpu_torch.ops import attention, flash

# bf16 output: both sides round once to bf16, whose step at the outputs'
# magnitude (|o| < 4) is at most 2^-6; f32: summation order only.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        kernels.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")


def _qkv(seed, B, S, H, K, D, dtype):
    g = torch.Generator().manual_seed(seed)
    shapes = ((B, S, H, D), (B, S, K, D), (B, S, K, D))
    return tuple(torch.randn(s, generator=g).to(device="cuda", dtype=dtype) for s in shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])  # query heads per kv head
# 200: the last query / kv tile is partial; 16: one partial tile.
@pytest.mark.parametrize("S", [16, 64, 200, 256, 1024])
def test_flash_kernel_matches_plain_version(card, S, G, D, dtype):
    K = 4
    H = G * K
    # A full row, a single token, one past a 64-key tile edge, a ragged row.
    lens = [S, 1, min(S, 65), min(S, 37)]
    q, k, v = _qkv(S + D + G, len(lens), S, H, K, D, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = flash.flash_prefill_attention.launches
    out = flash.flash_prefill_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert flash.flash_prefill_attention.launches == before + 1
    ref = flash.flash_prefill_attention_plain(q, k, v, lengths)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for b, n in enumerate(lens):
        assert (out[b, n:] == 0).all()  # padded rows are exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("check", ["repeat", "row_alone"])
def test_flash_kernel_is_deterministic_per_row(card, check, D, dtype):
    """No block mixes batch rows and nothing sums in a varying order: a
    second launch on the same inputs, and a launch on one batch row alone,
    give the same bits."""
    B, S, H, K = 3, 200, 16, 4
    q, k, v = _qkv(7 + D, B, S, H, K, D, dtype)
    lengths = torch.tensor([S, 1, 130], dtype=torch.int32, device="cuda")
    out = flash.flash_prefill_attention(q, k, v, lengths)
    if check == "repeat":
        assert torch.equal(out, flash.flash_prefill_attention(q, k, v, lengths))
    else:
        for b in range(B):
            alone = flash.flash_prefill_attention(
                q[b:b + 1].contiguous(), k[b:b + 1].contiguous(), v[b:b + 1].contiguous(),
                lengths[b:b + 1].contiguous())
            assert torch.equal(out[b:b + 1], alone)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_route(card, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(flash, "flash_prefill_attention_plain", refuse)
    q, k, v = _qkv(1, 2, 64, 4, 2, 64, torch.bfloat16)
    lengths = torch.tensor([64, 9], dtype=torch.int32, device="cuda")
    mask = torch.arange(64, device="cuda")[None, :] < lengths[:, None]
    before = flash.flash_prefill_attention.launches
    attention.prefill_attention(q, k, v, mask, lengths)  # the dispatcher's flash route
    torch.cuda.synchronize()
    assert flash.flash_prefill_attention.launches == before + 1
    # A head dim the kernel does not take raises; it is not served otherwise.
    q48, k48, v48 = _qkv(2, 2, 64, 4, 2, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_prefill_attention(q48, k48, v48, lengths)


# --------------------------------------------------------------------------- #
# B2: ragged paged attention (csrc/paged_attention.cu)
# --------------------------------------------------------------------------- #

# f32 arithmetic on both sides (bf16 pools widen exactly): summation order
# only, over up to 4096 rows.
PAGED_TOL = 2e-4


def _paged_inputs(seed, B, QR, K, D, page, MP, dtype, limits):
    g = torch.Generator().manual_seed(seed)
    P = B * MP + 1
    qr = (torch.randn(B, K, QR, D, generator=g) / D**0.5).cuda()
    kp = torch.randn(P, page, K, D, generator=g).to(device="cuda", dtype=dtype)
    vp = torch.randn(P, page, K, D, generator=g).to(device="cuda", dtype=dtype)
    table = torch.randperm(P - 1, generator=g)[: B * MP].reshape(B, MP).to(torch.int32).cuda()
    lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
    return qr, kp, vp, table, lim


def _assert_partials_match(got, want, limits):
    acc, m, l = got
    racc, rm, rl = want
    live = torch.tensor(limits, device="cuda") > 0
    o = acc / l.clamp(min=1e-30)[..., None]
    ro = racc / rl.clamp(min=1e-30)[..., None]
    assert (o - ro)[live].abs().max().item() <= PAGED_TOL
    assert (m - rm)[live].abs().max().item() <= PAGED_TOL
    assert ((l - rl)[live].abs() / rl[live]).max().item() <= PAGED_TOL
    idle = ~live  # limit 0: m = -1e30, l = 0, acc = 0 exactly
    assert (m[idle] == -1e30).all() and (l[idle] == 0).all() and (acc[idle] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("mode", ["decode", "mq"])
def test_paged_kernel_matches_plain_version(card, mode, page, D, dtype):
    from localai_tpu_torch.ops import paged_flash as pf

    B, K, MP = 4, 8, 2048 // page
    QR = 4 if mode == "decode" else 3 * 4 * 5  # G=4; T=15 tokens of G=4 rows
    limits = [2048, 0, 1000 + page // 2, 37]  # full, idle, partial last page, short
    qr, kp, vp, table, lim = _paged_inputs(page + D, B, QR, K, D, page, MP, dtype, limits)
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // 4).to(torch.int32)
    for softcap, window in ((0.0, 0), (30.0, 700)):
        before = pf.paged_partials_rows.launches
        got = pf.paged_partials_rows(qr, qpos, kp, vp, table, lim, softcap, window)
        torch.cuda.synchronize()
        assert pf.paged_partials_rows.launches == before + 1
        want = pf.paged_partials_plain(qr, qpos, kp, vp, table, lim, softcap, window)
        _assert_partials_match(got, want, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(576, torch.bfloat16), (576, torch.float8_e4m3fn),
                                     (48, torch.float32)])
@pytest.mark.parametrize("QR", [16, 96])  # decode (16 heads), a 6-token verify
def test_paged_latent_form_matches_plain_version(card, QR, D, dtype):
    """B2's latent form (one kv head, the pool passed as K and V) against
    its plain version; at D = 576 it refuses a V pool that is not K's."""
    from localai_tpu_torch.ops import paged_flash as pf

    B, page, MP = 4, 128, 16
    limits = [2048, 0, 1000 + page // 2, 37]
    qr, kp, _vp, table, lim = _paged_inputs(D + QR, B, QR, 1, D, page, MP, torch.float32,
                                            limits)
    pool = kp.to(dtype)
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // 16).to(torch.int32)
    before = pf.paged_partials_rows.latent_launches
    got = pf.paged_partials_rows(qr, qpos, pool, pool, table, lim)
    torch.cuda.synchronize()
    assert pf.paged_partials_rows.latent_launches == before + 1
    _assert_partials_match(got, pf.paged_partials_plain(qr, qpos, pool, pool, table, lim),
                           limits)
    if D == 576:
        with pytest.raises(ValueError, match="v_pool must be k_pool"):
            pf.paged_partials_rows(qr, qpos, pool, pool.clone(), table, lim)


@pytest.mark.cuda
def test_paged_cuda_tensors_never_take_the_plain_route(card, monkeypatch):
    from localai_tpu_torch.ops import attention as att
    from localai_tpu_torch.ops import paged_flash as pf

    def refuse(*_a, **_k):
        raise AssertionError("a plain paged walk ran on CUDA tensors")

    monkeypatch.setattr(pf, "paged_partials_plain", refuse)
    qr, kp, vp, table, lim = _paged_inputs(3, 2, 4, 2, 64, 16, 4, torch.bfloat16, [40, 9])
    q = qr.reshape(2, 8, 64).to(torch.bfloat16)
    before = pf.paged_partials_rows.launches
    att.paged_partials(q, kp, vp, table, lim)  # the dispatcher's "auto" route
    torch.cuda.synchronize()
    assert pf.paged_partials_rows.launches == before + 1
    qpos = lim[:, None].expand(2, 4).contiguous()
    with pytest.raises(ValueError, match="head dim"):
        pf.paged_partials_rows(qr[..., :48].contiguous(), qpos, kp[..., :48].contiguous(),
                               vp[..., :48].contiguous(), table, lim)
    with pytest.raises(TypeError, match="table"):
        pf.paged_partials_rows(qr, qpos, kp, vp, table.long(), lim)
    # The long-context forms launch too: a hierarchical table, the skip.
    att.paged_partials(q, kp, vp, _hier_of(table, 2), lim, sink=4, swin=8)
    torch.cuda.synchronize()
    assert pf.paged_partials_rows.launches == before + 2
    with pytest.raises(TypeError, match="l0"):
        pf.paged_partials_rows(qr, qpos, kp, vp, (_hier_of(table, 2)[0], table.long()), lim)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode", ["decode", "mq"])
def test_paged_kernel_fp8_pools_match_plain_version(card, mode, D, dtype):
    """fp8 pools with a per-head kv_scale (not all ones): the kernel widens
    the stored bytes exactly and applies the head's scales to q and to the
    finished acc, the plain walk scales every element, on the same bytes."""
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops import paged_flash as pf

    B, K, page, MP = 4, 8, 128, 16
    QR = 4 if mode == "decode" else 3 * 4 * 5
    limits = [2048, 0, 1000 + page // 2, 37]
    qr, kp, vp, table, lim = _paged_inputs(D + 7, B, QR, K, D, page, MP, torch.float32, limits)
    scale = torch.stack([torch.linspace(0.5, 4.0, K), torch.linspace(3.0, 0.25, K)]).cuda()
    kp = kv_cast(kp * 20.0 / scale[0][:, None], dtype)  # stored = value / scale (< 448)
    vp = kv_cast(vp * 20.0 / scale[1][:, None], dtype)
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // 4).to(torch.int32)
    before = pf.paged_partials_rows.launches
    got = pf.paged_partials_rows(qr, qpos, kp, vp, table, lim, 0.0, 0, scale)
    torch.cuda.synchronize()
    assert pf.paged_partials_rows.launches == before + 1
    want = pf.paged_partials_plain(qr, qpos, kp, vp, table, lim, 0.0, 0, scale)
    # Values are ~20x the unit-scale case: hold them to the same relative tolerance.
    acc, m, l = got
    racc, rm, rl = want
    live = lim > 0
    o = acc / l.clamp(min=1e-30)[..., None]
    ro = racc / rl.clamp(min=1e-30)[..., None]
    assert (o - ro)[live].abs().max().item() <= PAGED_TOL * ro[live].abs().max().item()
    assert ((m - rm)[live].abs() / rm[live].abs().clamp(min=1.0)).max().item() <= PAGED_TOL
    assert ((l - rl)[live].abs() / rl[live]).max().item() <= PAGED_TOL
    idle = ~live
    assert (m[idle] == -1e30).all() and (l[idle] == 0).all() and (acc[idle] == 0).all()
    with pytest.raises(ValueError, match="kv_scale"):
        pf.paged_partials_rows(qr, qpos, kp, vp, table, lim, 0.0, 0, scale[:, :4].contiguous())
    with pytest.raises(ValueError, match="fp8 pools"):  # bf16 / f32 pools are unscaled
        pf.paged_partials_rows(qr, qpos, kp.to(torch.bfloat16), vp.to(torch.bfloat16), table,
                               lim, 0.0, 0, scale)


def _paged_bits_hold(pf, args, B):
    """A second launch, and each slot launched alone, give the same bits."""
    qr, qpos, kp, vp, table, lim, softcap, window, scale = args
    got = pf.paged_partials_rows(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, pf.paged_partials_rows(*args)))
    for b in range(B):
        alone = pf.paged_partials_rows(qr[b:b + 1], qpos[b:b + 1], kp, vp, table[b:b + 1],
                                       lim[b:b + 1], softcap, window, scale)
        assert all(torch.equal(a[b:b + 1], x) for a, x in zip(got, alone))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("page", [16, 48, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_paged_kernel_split_edges_repeat_and_alone(card, G, page, D):
    """Limits at a split edge and one row either side of it, an idle slot,
    a full slot: the kernel against its plain version, the idle slot exact,
    and every output bit-identical on a repeat and for each slot alone.
    48-row pages put split edges inside pages."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.ops import paged_flash as pf

    K, MP = 4, 3072 // page
    probe = torch.zeros(1, K, G, D, device="cuda")
    plan = pf.paged_plan(MP * page, page, K, G, D, torch.bfloat16,
                         kernels.sm_count(probe.device))
    # A split edge and a row either side; full; one row past `splits`
    # splits of one unit, so splits of two units with a 1-row last one.
    edge = plan.unit
    limits = [edge, edge - 1, edge + 1, 0, MP * page, plan.splits * edge + 1, 1, 1000]
    assert [len(plan.split_edges(n)) for n in limits[:3]] == [1, 1, 2]
    assert plan.split_edges(limits[5])[-1] == (limits[5] - 1, limits[5])
    assert len(plan.split_edges(MP * page)) > 2
    B = len(limits)
    qr, kp, vp, table, lim = _paged_inputs(G * page + D, B, G, K, D, page, MP, torch.bfloat16,
                                           limits)
    qpos = lim[:, None].expand(B, G).contiguous()  # decode: every row at the slot's end
    for softcap, window in ((0.0, 0), (30.0, edge + 7)):
        args = (qr, qpos, kp, vp, table, lim, softcap, window, None)
        got = _paged_bits_hold(pf, args, B)
        _assert_partials_match(got, pf.paged_partials_plain(*args), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [4, 64])
def test_paged_kernel_multi_query_rows_on_the_tensor_cores(card, T, D, dtype):
    """Multi-query rows (a 4-token verify: 16 rows, one tile; 64 tokens of
    G = 4: four 64-row tiles) over bf16 and scaled fp8 pools, with a sliding
    window: against the plain version, repeat and alone bit-identical."""
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops import paged_flash as pf

    B, K, G, page, MP = 4, 2, 4, 64, 32
    QR = T * G
    limits = [2048, 0, 513, 700]
    qr, kp, vp, table, lim = _paged_inputs(T + D, B, QR, K, D, page, MP, torch.float32, limits)
    scale = None
    if dtype.itemsize == 1:
        scale = torch.tensor([[0.5, 3.0], [2.0, 0.25]], device="cuda")
        kp, vp = kp / scale[0][:, None], vp / scale[1][:, None]
    kp, vp = kv_cast(kp, dtype), kv_cast(vp, dtype)
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
    args = (qr, qpos, kp, vp, table, lim, 20.0, 300, scale)
    got = _paged_bits_hold(pf, args, B)
    _assert_partials_match(got, pf.paged_partials_plain(*args), limits)


@pytest.mark.cuda
def test_paged_workspace_is_reused_across_calls(card):
    """After the first call at a shape, calls allocate nothing but their
    outputs: the workspace is the same tensor and the counters are back at
    zero after every launch."""
    from localai_tpu_torch.ops import paged_flash as pf

    limits = [2048, 0, 1000, 37]
    qr, kp, vp, table, lim = _paged_inputs(5, 4, 4, 8, 64, 128, 16, torch.bfloat16, limits)
    qpos = lim[:, None].expand(4, 4).contiguous()
    pf.paged_partials_rows(qr, qpos, kp, vp, table, lim)
    idx = qr.device.index if qr.device.index is not None else torch.cuda.current_device()
    ws, cnt = pf._workspaces[idx]
    for _ in range(3):
        pf.paged_partials_rows(qr, qpos, kp, vp, table, lim)
        torch.cuda.synchronize()
        assert pf._workspaces[idx][0].data_ptr() == ws.data_ptr()
        assert not pf._workspaces[idx][1].any()
    assert pf._workspaces[idx][1].data_ptr() == cnt.data_ptr()


def _hier_of(table, span):
    """The flat table [B, MP] as the hierarchical pair: l0 row 0 all
    SCRATCH-like zeros, then each slot's table pages in order."""
    B, MP = table.shape
    l0 = torch.cat([torch.zeros(1, span, dtype=torch.int32, device=table.device),
                    table.reshape(B * MP // span, span)])
    l1 = (1 + torch.arange(B * MP // span, dtype=torch.int32, device=table.device)).reshape(B, -1)
    return l1.contiguous(), l0.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float32])
@pytest.mark.parametrize("span", [1, 4, 32])
@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_paged_kernel_hier_tables_and_skip_match_plain_version(card, mode, span, dtype):
    """The hierarchical tables and the sink + window skip on the card: the
    kernel launches (the counter moves) and matches its plain version; the
    hierarchical table gives the flat table's bits, a table whose skipped
    columns point at SCRATCH the hot table's bits, and every output is
    bit-identical on a repeat and for each slot alone."""
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops import paged_flash as pf

    B, K, G, D, page, MP = 6, 2, 4, 64, 64, 64
    T = 1 if mode == "decode" else 40
    QR = G * T
    limits = [4096 - T, 0, 1, 700, 2600, 4095 - T]
    qr, kp, vp, table, lim = _paged_inputs(span + T, B, QR, K, D, page, MP, torch.float32,
                                           limits)
    scale = None
    if dtype.itemsize == 1:
        scale = torch.tensor([[0.5, 3.0], [2.0, 0.25]], device="cuda")
        kp, vp = kp / scale[0][:, None], vp / scale[1][:, None]
    kp, vp = kv_cast(kp, dtype), kv_cast(vp, dtype)
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
    sink, swin = 100, 1000
    hier = _hier_of(table, span)
    spilled = table.clone()
    for b, n in enumerate(limits):
        _, sink_rows, gap = pf.walk_rows(n, n, page, MP, sink, swin)
        spilled[b, sink_rows // page:(sink_rows + gap) // page] = kp.shape[0] - 1  # SCRATCH
    outs = {}
    for name, tab in (("flat", table), ("hier", hier), ("spilled", _hier_of(spilled, span))):
        before = pf.paged_partials_rows.launches
        outs[name] = pf.paged_partials_rows(qr, qpos, kp, vp, tab, lim, 0.0, 0, scale, sink,
                                            swin)
        torch.cuda.synchronize()
        assert pf.paged_partials_rows.launches == before + 1
        again = pf.paged_partials_rows(qr, qpos, kp, vp, tab, lim, 0.0, 0, scale, sink, swin)
        assert all(torch.equal(a, x) for a, x in zip(outs[name], again))
    assert all(torch.equal(a, x) for a, x in zip(outs["hier"], outs["flat"]))
    assert all(torch.equal(a, x) for a, x in zip(outs["spilled"], outs["flat"]))
    for b in range(B):
        alone = pf.paged_partials_rows(qr[b:b + 1], qpos[b:b + 1], kp, vp,
                                       (hier[0][b:b + 1], hier[1]), lim[b:b + 1], 0.0, 0,
                                       scale, sink, swin)
        assert all(torch.equal(a[b:b + 1], x) for a, x in zip(outs["hier"], alone))
    want = pf.paged_partials_plain(qr, qpos, kp, vp, table, lim, 0.0, 0, scale, sink, swin)
    _assert_partials_match(outs["hier"], want, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_pool_writes_match_the_cpu(card, dtype):
    """The pool writers (fp8 cast, per-head scale, scatter through the page
    table) give the same bytes on the card as on the CPU."""
    import dataclasses

    from localai_tpu_torch.models import get_arch
    from localai_tpu_torch.models import llama

    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    g = torch.Generator().manual_seed(5)
    rows = torch.randn(L, 2, 8, K, Hd, generator=g) * 300.0  # some past e4m3's range
    table = torch.tensor([[3, 1], [0, 2]], dtype=torch.int32)
    scale = torch.tensor([[1.0, 2.0], [0.5, 4.0]])
    out = {}
    for dev in ("cpu", "cuda"):
        pool = llama.paged_cache_zeros(cfg, 5, 4, dtype=dtype, device=dev)
        llama.write_block_to_pool(pool, table.to(dev), rows[:, :, :6].to(dev),
                                  rows[:, :, 2:].to(dev), torch.tensor([0, 1], device=dev),
                                  kv_scale=scale.to(dev))
        out[dev] = [t.view(torch.uint8).cpu() for t in pool]
    assert all(torch.equal(a, b) for a, b in zip(out["cpu"], out["cuda"]))


# --------------------------------------------------------------------------- #
# B3 / B4: fused dequant-matmul and int8 unembed (csrc/quant_matmul.cu)
# --------------------------------------------------------------------------- #

# llama-3-8b's projections (in, out): wk/wv, wq/wo, w_gate/w_up, w_down; and
# a small ragged shape whose int4 groups put different in-rows in the two
# nibbles of a byte.
QMM_SHAPES = [(96, 80), (4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096)]


def _grouped_int8(w, group=32):
    """Group-wise symmetric int8 (GGUF q8_0's layout) over the in (-2) axis,
    leading axes kept: {"gq", "gs"}."""
    g = w.shape[-2] // group
    wg = w.float().reshape(*w.shape[:-2], g, group, w.shape[-1])
    s = torch.clamp(wg.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-9)
    return {"gq": torch.clamp(torch.round(wg / s), -127, 127).to(torch.int8), "gs": s}


def _quantized(form, w):
    from localai_tpu_torch.models import quant

    if form == "int8":
        return quant.quantize_tensor(w)
    if form == "grouped_int8":
        return _grouped_int8(w)
    return quant.quantize_tensor_g4(w)


def _assert_qmm_close(got, x, qw):
    """f32 x: summation order only, 1e-4 of the output's largest value.
    bf16 x: both sides round the f32 sum once to bf16, so they may differ by
    one bf16 step (2^-7 of the value), plus the summation-order term."""
    from localai_tpu_torch.ops.quant_matmul import qmm_plain

    want = qmm_plain(x, qw)
    assert got.dtype == x.dtype and got.shape == want.shape
    scale = qmm_plain(x.float(), qw).abs().max().item()
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_qmm_kernel_matches_plain_version(card, shape, dtype, form):
    from localai_tpu_torch.ops.quant_matmul import qmm

    n_in, n_out = shape
    g = torch.Generator(device="cuda").manual_seed(n_in + n_out)
    qw = _quantized(form, torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02)
    # 1-16 rows: decode batches (8 and 16 the two row tiles, 3 and 13 ragged
    # ones); 64 and 256: the 64-row tiles of admissions.
    for N in (1, 3, 8, 13, 16, 64, 256):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        before = qmm.launches
        got = qmm(x, qw)
        torch.cuda.synchronize()
        assert qmm.launches == before + 1
        _assert_qmm_close(got, x, qw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_qmm_kernel_is_deterministic_per_row(card, shape, dtype, form):
    """Launched again, the same bits; up to 16 rows, every row the same bits
    as that row launched alone (the split plan and every sum's order do not
    depend on how many rows decode together)."""
    from localai_tpu_torch.ops.quant_matmul import qmm

    n_in, n_out = shape
    g = torch.Generator(device="cuda").manual_seed(n_in * 3 + n_out)
    qw = _quantized(form, torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02)
    for N in (8, 13, 16, 64):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        got = qmm(x, qw)
        assert torch.equal(got, qmm(x, qw))
        if N <= 16:
            for i in range(N):
                assert torch.equal(got[i:i + 1], qmm(x[i:i + 1], qw)), (N, i)


@pytest.mark.cuda
def test_qmm_workspace_is_reused_across_products(card):
    """The split-K workspace and counters are the wrapper's, one pair per
    device: a smaller product reuses them, a larger one grows them, and
    products of different shapes back to back give the bits each gives
    alone (every launch leaves its tile counters at 0)."""
    from localai_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for (n_in, n_out), form, N in (((4096, 1024), "int4", 8), ((4096, 4096), "int8", 16),
                                   ((14336, 4096), "grouped_int8", 1), ((4096, 1024), "int8", 64),
                                   ((4096, 14336), "int4", 3)):
        qw = _quantized(form, torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02)
        x = torch.randn(N, n_in, generator=g, device="cuda").to(torch.bfloat16)
        plan = qm.qmm_plan(n_in, n_out, N, kernels.sm_count(x.device))
        assert plan.splits > 1, (n_in, n_out, N)  # every case takes the split path
        cases.append((x, qw, plan.workspace_floats(N, n_out)))
    alone = []
    for x, qw, _ in cases:
        alone.append(qm.qmm(x, qw))
        torch.cuda.synchronize()
    idx = torch.cuda.current_device()
    ws, cnt = qm._workspaces[idx]
    assert ws.numel() >= max(need for _x, _w, need in cases)
    assert not cnt.any()
    for _ in range(3):  # back to back, no synchronisation between them
        together = [qm.qmm(x, qw) for x, qw, _ in cases]
        assert all(torch.equal(a, b) for a, b in zip(alone, together))
    assert qm._workspaces[idx][0].data_ptr() == ws.data_ptr()  # nothing grew
    assert not qm._workspaces[idx][1].any()
    # A product that needs more: the workspace grows, once.
    x = torch.randn(256, 4096, generator=g, device="cuda").to(torch.bfloat16)
    qw = _quantized("int4", torch.randn(4096, 1024, generator=g, device="cuda") * 0.02)
    need = qm.qmm_plan(4096, 1024, 256, kernels.sm_count(x.device)).workspace_floats(256, 1024)
    got = qm.qmm(x, qw)
    _assert_qmm_close(got, x, qw)
    assert qm._workspaces[idx][0].numel() >= need
    grown = qm._workspaces[idx][0].data_ptr()
    assert torch.equal(got, qm.qmm(x, qw))
    assert qm._workspaces[idx][0].data_ptr() == grown


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
# (1000, 80): a ragged vocab tile and a last chunk of 16 columns.
@pytest.mark.parametrize("V, D", [(1000, 64), (1000, 80), (128256, 4096)])
def test_unembed_kernel_matches_plain_version(card, V, D, dtype):
    """Against the plain version at 1-256 rows (1-16: one and two n-tiles of
    the bf16 kernel; 64 and 256: 64-row tiles); launched again, the same
    bits; up to 16 bf16 rows, each row launched alone, the same bits."""
    from localai_tpu_torch.ops.quant_matmul import qunembed, qunembed_plain

    g = torch.Generator(device="cuda").manual_seed(V + D)
    w = torch.randn(V, D, generator=g, device="cuda") * 0.02
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
    head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
    for N in (1, 8, 16, 64, 256):
        h = torch.randn(N, D, generator=g, device="cuda").to(dtype)
        before = qunembed.launches
        got = qunembed(h, head)
        torch.cuda.synchronize()
        assert qunembed.launches == before + 1
        want = qunembed_plain(h, head)
        assert got.dtype == torch.float32 and got.shape == (N, V)
        # f32 arithmetic on both sides (bf16 h widens exactly): summation order.
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        assert torch.equal(got, qunembed(h, head))
        if dtype == torch.bfloat16 and N <= 16:
            for i in range(N):
                assert torch.equal(got[i:i + 1], qunembed(h[i:i + 1].contiguous(), head)), (N, i)


@pytest.mark.cuda
def test_unembed_kernel_takes_an_unaligned_h_and_refuses_d_off_16(card):
    """bf16 h that is not 16-byte aligned is staged with 2-byte loads (the
    same bits as an aligned copy); D % 16 != 0 raises ValueError."""
    from localai_tpu_torch.ops.quant_matmul import qunembed

    g = torch.Generator(device="cuda").manual_seed(3)
    V, D = 300, 96
    w = torch.randn(V, D, generator=g, device="cuda") * 0.02
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
    head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
    h = torch.randn(4, D, generator=g, device="cuda").to(torch.bfloat16)
    shifted = torch.empty(4 * D + 1, dtype=torch.bfloat16, device="cuda")[1:].view(4, D)
    shifted.copy_(h)
    assert shifted.data_ptr() % 16
    assert torch.equal(qunembed(shifted, head), qunembed(h, head))
    w40 = w[:, :40].contiguous()
    head40 = {"q": torch.clamp(torch.round(w40 / s), -127, 127).to(torch.int8), "s": s}
    with pytest.raises(ValueError, match="16-byte aligned"):
        qunembed(h[:, :40].contiguous(), head40)


@pytest.mark.cuda
def test_quant_cuda_tensors_never_take_the_plain_route(card, monkeypatch):
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul as qm

    def refuse(*_a, **_k):
        raise AssertionError("a plain quantized matmul ran on CUDA tensors")

    monkeypatch.setattr(qm, "qmm_plain", refuse)
    monkeypatch.setattr(qm, "qunembed_plain", refuse)
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 96, generator=g, device="cuda")
    x = torch.randn(2, 3, 64, generator=g, device="cuda").to(torch.bfloat16)
    before = qm.qmm.launches, qm.qunembed.launches
    for form in ("int8", "grouped_int8", "int4"):
        assert quant.matmul(x, _quantized(form, w)).shape == (2, 3, 96)
    head = quant.quantize_tensor(w)  # over the 64 D rows: one scale per vocab column
    head = {"q": head["q"].t().contiguous(), "s": head["s"].t().contiguous()}  # [96, 64], [96, 1]
    assert quant.unembed_matmul(x, head).shape == (2, 3, 96)
    torch.cuda.synchronize()
    assert (qm.qmm.launches, qm.qunembed.launches) == (before[0] + 3, before[1] + 1)
    # What the kernel does not take raises; it is not served otherwise.
    with pytest.raises(ValueError, match="multiple of 4"):
        qm.qmm(x[0], quant.quantize_tensor(w[:, :90].contiguous()))
    with pytest.raises(ValueError, match="group size"):
        qm.qmm(x[0], quant.quantize_tensor_g4(w, group=8))
    with pytest.raises(TypeError, match="x must be"):
        qm.qmm(x[0].half(), quant.quantize_tensor(w))
    with pytest.raises(ValueError, match="at most"):
        qm.qmm(torch.zeros(300, 64, device="cuda"), quant.quantize_tensor(w))


# B3's expert form: (sub, E, in, out). Mixtral-8x7b's gate / up (x shared
# by the 8 experts) and down (one x row per expert; two k-splits at decode),
# then small ragged shapes (a partial column tile, three int4 groups).
MOE_SHAPES = [("...d,edf->...ef", 8, 4096, 14336), ("...ef,efd->...ed", 8, 14336, 4096),
              ("...d,edf->...ef", 4, 96, 80), ("...ef,efd->...ed", 3, 96, 80)]


def _moe_case(g, sub, E, n_in, n_out, form, N, dtype):
    qw = _quantized(form, torch.randn(E, n_in, n_out, generator=g, device="cuda") * 0.02)
    xshape = (N, n_in) if sub == "...d,edf->...ef" else (N, E, n_in)
    return qw, torch.randn(xshape, generator=g, device="cuda").to(dtype)


def _assert_moe_close(got, x, qw, sub):
    """_assert_qmm_close's tolerance on every expert's product."""
    from localai_tpu_torch.ops.quant_matmul import qmm_moe_plain

    want = qmm_moe_plain(x, qw, sub)
    assert got.dtype == x.dtype and got.shape == want.shape
    scale = qmm_moe_plain(x.float(), qw, sub).abs().max().item()
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub, E, n_in, n_out", MOE_SHAPES)
def test_qmm_moe_kernel_matches_plain_version(card, sub, E, n_in, n_out, dtype, form):
    """Every expert in one launch, against the plain version; the output
    [N, E, out] lands in the layout the MoE combine reads."""
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    g = torch.Generator(device="cuda").manual_seed(E + n_in + n_out)
    for N in (1, 3, 8, 13, 16, 64, 256):
        qw, x = _moe_case(g, sub, E, n_in, n_out, form, N, dtype)
        before = qmm_moe.launches
        got = qmm_moe(x, qw, sub)
        torch.cuda.synchronize()
        assert qmm_moe.launches == before + 1
        assert got.shape == (N, E, n_out)
        _assert_moe_close(got, x, qw, sub)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub, E, n_in, n_out", MOE_SHAPES)
def test_qmm_moe_kernel_is_deterministic_per_row(card, sub, E, n_in, n_out, dtype, form):
    """Launched again, the same bits; up to 16 rows, every row the same bits
    as that row launched alone (the plan depends on (E, in, out) only)."""
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    g = torch.Generator(device="cuda").manual_seed(3 * E + n_in + n_out)
    for N in (8, 13, 64):
        qw, x = _moe_case(g, sub, E, n_in, n_out, form, N, dtype)
        got = qmm_moe(x, qw, sub)
        assert torch.equal(got, qmm_moe(x, qw, sub))
        if N <= 16:
            for i in range(N):
                assert torch.equal(got[i:i + 1], qmm_moe(x[i:i + 1].contiguous(), qw, sub)), (N, i)


@pytest.mark.cuda
def test_moe_cuda_tensors_never_take_the_plain_route(card, monkeypatch):
    """The MoE layer's quantized products launch the expert form (one launch
    a projection) and never the plain version; what the kernel does not
    take raises."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul as qm

    def refuse(*_a, **_k):
        raise AssertionError("a plain quantized matmul ran on CUDA tensors")

    monkeypatch.setattr(qm, "qmm_moe_plain", refuse)
    monkeypatch.setattr(qm, "qmm_plain", refuse)
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(4, 64, 96, generator=g, device="cuda")
    x = torch.randn(2, 3, 64, generator=g, device="cuda").to(torch.bfloat16)
    xe = torch.randn(2, 3, 4, 96, generator=g, device="cuda").to(torch.bfloat16)
    wd = torch.randn(4, 96, 64, generator=g, device="cuda")
    before = qm.qmm_moe.launches, qm.qmm.launches
    for form in ("int8", "grouped_int8", "int4"):
        assert quant.moe_matmul(x, _quantized(form, w), qm.MOE_SHARED).shape == (2, 3, 4, 96)
        assert quant.moe_matmul(xe, _quantized(form, wd), qm.MOE_PER_EXPERT).shape == \
            (2, 3, 4, 64)
    torch.cuda.synchronize()
    assert (qm.qmm_moe.launches, qm.qmm.launches) == (before[0] + 6, before[1])
    with pytest.raises(ValueError, match="experts"):
        qm.qmm_moe(xe[0, :, :3].contiguous(), _quantized("int8", wd), qm.MOE_PER_EXPERT)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.qmm_moe(x[0], _quantized("int8", w[..., :88].contiguous()), qm.MOE_SHARED)
    with pytest.raises(ValueError, match="at most"):
        qm.qmm_moe(torch.zeros(300, 64, device="cuda"), _quantized("int8", w), qm.MOE_SHARED)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [
    dict(max_slots=264, block_sizes=(4,)),
    dict(max_slots=64, block_sizes=(4,), kv_pages=80, kv_page_size=16,
         spec_mode="prompt_lookup")], ids=["block_264_rows", "verify_384_rows"])
def test_plain_moe_bodies_above_256_rows_capture(card, layout):
    """f32 tiny MoE with plain experts: decode blocks of 264 rows and
    verify rounds of up to 64 x 6 rows are captured by warmup() and
    replayed (their MoE layers take the fixed-shape route, no host read);
    the greedy ids of a 300-token prompt (a sorted-route admission) and a
    pinned-bias prompt equal the CPU engine's."""
    import dataclasses

    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch("tiny-moe"), name="tiny-moe-d64", hidden_size=256,
                              intermediate_size=512, num_heads=4, num_kv_heads=2,
                              dtype="float32")
    params = llama.init_params(cfg, 0, device="cpu")
    prompts = [([(j * 7) % 250 + 1 for j in range(300)], {}), ([10] + [77] * 20, {77: 25.0})]
    ids = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else {
            k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
            for k, v in params.items()}
        eng = Engine(cfg, p, ByteTokenizer(cfg.vocab_size), device=dev,
                     engine_cfg=EngineConfig(max_seq=512, min_prefill_bucket=16,
                                             prefix_cache_entries=0, **layout))
        try:
            if dev == "cuda":
                eng.warmup()
                graphs = eng.metrics()["decode_graph_captures"]
            ids[dev] = [_tiny_ids(eng, pr, n=8, logit_bias=b) for pr, b in prompts]
            if dev == "cuda":
                m = eng.metrics()
                assert m["decode_graph_captures"] == graphs > 0
                assert m["decode_graph_replays"] > 0
        finally:
            eng.stop()
    assert ids["cuda"] == ids["cpu"]


# --------------------------------------------------------------------------- #
# B5: ragged LoRA delta (csrc/lora_matmul.cu)
# --------------------------------------------------------------------------- #

# Every target projection (in, out) of llama-3.2-1b and llama-3-8b.
LORA_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _lora_stack(g, n_in, n_out, R, NA, dtype):
    """Stacked factors [NA, in, R] / [NA, R, out] with the null adapter at
    row 0 and adapter 1 zero-padded past rank R // 2 (mixed ranks)."""
    a = (torch.randn(NA, n_in, R, generator=g, device="cuda") * 0.05).to(dtype)
    b = (torch.randn(NA, R, n_out, generator=g, device="cuda") * 0.05).to(dtype)
    a[0] = 0
    b[0] = 0
    if R > 1:
        a[1, :, R // 2:] = 0
        b[1, R // 2:] = 0
    return a, b


def _assert_lora_close(got, want):
    """f32: the same f32 arithmetic in another summation order, 1e-4 of the
    largest value. bf16: both round the f32 result once to bf16, so they may
    differ by one bf16 step (2^-7 of the value) plus that term."""
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
# 32 is the served stacks' rank (lora_http pads its rank-16 tenants to it);
# 24 pads to 32 ranks in the tensor-core tiles (a multiple of 8: 16-byte rows of A);
# 1 is narrower than 16 bytes and loads element by element.
@pytest.mark.parametrize("R", [1, 8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_lora_kernel_matches_plain_version(card, shape, R, dtype):
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_bgmv_group, lora_delta_plain

    n_in, n_out = shape
    NA = 9  # 8 adapters and the null one
    g = torch.Generator(device="cuda").manual_seed(n_in + n_out + R)
    a, b = _lora_stack(g, n_in, n_out, R, NA, dtype)
    for N in (1, 8, 256):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        ids = (torch.arange(N, device="cuda") % NA).to(torch.int32)
        if N == 1:
            ids[0] = 1
        before = lora_bgmv_group.launches
        got = lora_bgmv(x, a, b, ids)
        torch.cuda.synchronize()
        assert lora_bgmv_group.launches == before + 1
        _assert_lora_close(got, lora_delta_plain(x, a, b, ids))
        null = ids == 0
        assert (got[null] == 0).all()  # exact zeros, not approximate ones
        if N == 8:  # each row bit-identical to a launch on that row alone
            for n in range(N):
                assert torch.equal(got[n:n + 1], lora_bgmv(x[n:n + 1], a, b, ids[n:n + 1]))


@pytest.mark.cuda
def test_lora_cuda_tensors_never_take_the_plain_route(card, monkeypatch):
    from localai_tpu_torch.ops import lora_matmul as lm

    def refuse(*_a, **_k):
        raise AssertionError("a plain LoRA delta ran on CUDA tensors")

    monkeypatch.setattr(lm, "lora_delta_plain", refuse)
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = _lora_stack(g, 64, 96, 8, 3, torch.bfloat16)
    x = torch.randn(4, 64, generator=g, device="cuda").to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device="cuda")
    before = lm.lora_bgmv_group.launches
    assert lm.lora_delta(x, {"a": a, "b": b}, ids).shape == (4, 96)
    # Host ids are checked on the host and copied to the card.
    assert torch.equal(lm.lora_bgmv(x, a, b, ids.cpu()), lm.lora_bgmv(x, a, b, ids))
    torch.cuda.synchronize()
    assert lm.lora_bgmv_group.launches == before + 3
    # A group of targets is one launch; the gather form never serves 2-D rows.
    a2, b2 = _lora_stack(g, 64, 32, 8, 3, torch.bfloat16)
    group = lm.lora_deltas(x, [{"a": a, "b": b}, {"a": a2, "b": b2}], ids)
    assert [t.shape for t in group] == [(4, 96), (4, 32)]
    assert lm.lora_bgmv_group.launches == before + 4
    # An id outside [0, NA) on the card reads nothing: its row is NaN.
    bad = lm.lora_bgmv(x, a, b, torch.tensor([1, 3, -1, 0], dtype=torch.int32, device="cuda"))
    assert torch.isnan(bad[1]).all() and torch.isnan(bad[2]).all() and (bad[3] == 0).all()
    # What the kernel does not take raises; it is not served otherwise.
    with pytest.raises(ValueError, match="outside"):
        lm.lora_bgmv(x, a, b, torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    with pytest.raises(TypeError, match="x must be"):
        lm.lora_bgmv(x.half(), a, b, ids)
    with pytest.raises(TypeError, match="factors"):
        lm.lora_bgmv(x, a.float(), b, ids)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_bgmv(x, a.transpose(1, 2).contiguous().transpose(1, 2), b, ids)
    with pytest.raises(ValueError, match="rank"):
        a2, b2 = _lora_stack(g, 64, 96, 129, 2, torch.bfloat16)
        lm.lora_bgmv(x, a2, b2, torch.zeros(4, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="multiples of 8"):
        a3, b3 = _lora_stack(g, 64, 90, 8, 3, torch.bfloat16)
        lm.lora_bgmv(x, a3, b3, ids)
    with pytest.raises(ValueError, match="int32"):
        lm.lora_bgmv(x, a, b, ids.long())
    with pytest.raises(ValueError, match="at most"):
        lm.lora_bgmv(torch.zeros(300, 64, dtype=torch.bfloat16, device="cuda"), a, b,
                     torch.zeros(300, dtype=torch.int32, device="cuda"))
    # A group shares NA and the rank, and takes at most three targets.
    a4, b4 = _lora_stack(g, 64, 96, 16, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="share NA and the rank"):
        lm.lora_bgmv_group(x, [(a, b), (a4, b4)], ids)
    with pytest.raises(ValueError, match="targets"):
        lm.lora_bgmv_group(x, [(a, b)] * 4, ids)
    with pytest.raises(TypeError, match="alike"):
        lm.lora_bgmv_group(x, [(a, b), (a.float(), b.float())], ids)
    with pytest.raises(ValueError, match="16-byte aligned"):
        xs = torch.zeros(4 * 64 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(4, 64)
        lm.lora_bgmv_group(xs, [(a, b)], ids)
    torch.cuda.synchronize()
    assert lm.lora_bgmv_group.launches == before + 5  # the bad-id call; nothing refused


# The served groups (in, outs): llama-3.2-1b {wq, wk, wv} and {w_gate, w_up},
# llama-3-8b {wq, wv} and {w_down} alone.
LORA_GROUPS = [(2048, (2048, 512, 512)), (2048, (8192, 8192)), (4096, (4096, 1024)),
               (14336, (4096,))]


def _lora_ids(N, NA, g):
    """Row ids with repeats: at 9 rows the segments are 1-3 rows long."""
    if N == 1:
        return torch.tensor([3], dtype=torch.int32, device="cuda")
    if N == 9:
        return torch.tensor([3, 1, 3, 0, 2, 3, 1, 8, 0], dtype=torch.int32, device="cuda")
    return torch.randint(0, NA, (N,), generator=g, device="cuda", dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("group", LORA_GROUPS, ids=["1b_qkv", "1b_gate_up", "8b_qv", "8b_down"])
def test_lora_group_kernel_matches_plain_version(card, group, R, dtype):
    """One launch for the group against lora_delta_plain target by target,
    at 1, 8, 9 and 256 rows with repeated ids; null rows exact zeros; each
    row bit-identical to a launch on it alone; two launches bit-identical;
    one launch counted per call."""
    from localai_tpu_torch.ops import lora_matmul as lm

    n_in, outs = group
    NA = 9
    g = torch.Generator(device="cuda").manual_seed(n_in + R + len(outs))
    pairs = [_lora_stack(g, n_in, o, R, NA, dtype) for o in outs]
    for N in (1, 8, 9, 256):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        ids = _lora_ids(N, NA, g)
        before = lm.lora_bgmv_group.launches
        got = lm.lora_bgmv_group(x, pairs, ids)
        torch.cuda.synchronize()
        assert lm.lora_bgmv_group.launches == before + 1
        again = lm.lora_bgmv_group(x, pairs, ids)
        for (a, b), y, y2 in zip(pairs, got, again):
            assert y.shape == (N, b.shape[2])
            _assert_lora_close(y, lora_plain(x, a, b, ids))
            assert (y[ids == 0] == 0).all()
            assert torch.equal(y, y2)
        for n in (range(N) if N <= 9 else (0, 1, 77, N - 1)):
            alone = lm.lora_bgmv_group(x[n:n + 1], pairs, ids[n:n + 1])
            assert all(torch.equal(y[n:n + 1], z) for y, z in zip(got, alone))


def lora_plain(x, a, b, ids):
    from localai_tpu_torch.ops.lora_matmul import lora_delta_plain

    return lora_delta_plain(x, a, b, ids)


@pytest.mark.cuda
def test_lora_launch_allocates_only_its_outputs_and_keeps_no_state(card):
    """The kernel needs no workspace: a launch allocates its outputs and
    nothing else, and a launch with bad ids or only null rows between two
    others changes nothing for the later one (no state carries over)."""
    from localai_tpu_torch.ops import lora_matmul as lm

    g = torch.Generator(device="cuda").manual_seed(5)
    pairs = [_lora_stack(g, 2048, o, 32, 9, torch.bfloat16) for o in (2048, 512, 512)]
    x = torch.randn(256, 2048, generator=g, device="cuda").to(torch.bfloat16)
    ids9 = _lora_ids(9, 9, g)
    first = lm.lora_bgmv_group(x[:9], pairs, ids9)
    for ids in (torch.tensor([1, 12, -3, 0, 1, 2, 0, 5], dtype=torch.int32, device="cuda"),
                torch.zeros(8, dtype=torch.int32, device="cuda"),
                _lora_ids(256, 9, g)):
        allocations = torch.cuda.memory_stats()["allocation.all.allocated"]
        out = lm.lora_bgmv_group(x[:len(ids)], pairs, ids)
        torch.cuda.synchronize()
        # One device allocation per output and none else.
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocations == len(out)
        bad = (ids < 0) | (ids >= 9)
        for y in out:
            assert torch.isnan(y[bad]).all() and not torch.isnan(y[~bad]).any()
            assert (y[ids == 0] == 0).all()
    again = lm.lora_bgmv_group(x[:9], pairs, ids9)
    assert all(torch.equal(y, z) for y, z in zip(first, again))


# --------------------------------------------------------------------------- #
# Prefix cache and swap tier on the card (tiny f32 engines)
# --------------------------------------------------------------------------- #

def _tiny_engine(**kw):
    import dataclasses

    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    # Head dim 64, which B1 serves (tiny's is 16).
    cfg = dataclasses.replace(get_arch("tiny"), name="tiny-d64", hidden_size=256,
                              intermediate_size=512, num_heads=4, num_kv_heads=2,
                              dtype="float32")
    params = llama.init_params(cfg, 0, device="cuda")
    ecfg = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
    ecfg.update(kw)
    return Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                  engine_cfg=EngineConfig(**ecfg))


def _tiny_ids(eng, prompt, n=10, **kw):
    from localai_tpu_torch.engine.engine import GenRequest

    evs = list(eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=n, ignore_eos=True,
                                     **kw)))
    assert evs[-1].kind == "done"
    return [e.token_id for e in evs if e.kind == "token"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [{}, dict(kv_pages=40, kv_page_size=16, prefill_chunk=32),
                                    dict(kv_pages=40, kv_page_size=16, kv_l1_span=2)],
                         ids=["dense", "chunked", "hier"])
def test_prefix_hits_equal_misses_and_add_no_graph(card, layout):
    """f32 on the card: a chat's hits give the ids its misses give; after
    warmup() the hits capture no graph (mapping shared pages changes table
    contents only), and every decode block replays."""
    sys_ids = [(j * 7) % 250 + 1 for j in range(70)]
    outs = []
    for entries in (8, 0):
        eng = _tiny_engine(prefix_cache_entries=entries, **layout)
        try:
            eng.warmup()
            graphs = eng.metrics()["decode_graphs"]
            a = sys_ids + [3, 5, 8]
            ids = [_tiny_ids(eng, a), _tiny_ids(eng, sys_ids + [21, 34], temperature=0.8,
                                                top_p=0.9, seed=7)]
            ids.append(_tiny_ids(eng, a + ids[0] + [9, 10]))
            m = eng.metrics()
            assert m["decode_graphs"] == graphs and m["decode_graph_captures"] == graphs
            assert m["decode_graph_replays"] == m["decode_blocks"] > 0
            assert m["prefix_hits"] == (2 if entries else 0)
            outs.append(ids)
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_swap_preemption_restores_pages_on_the_card(card):
    """f32 on the card: a 12-page pool swaps the younger of two growing
    requests to pinned host memory and back; both end with the ids of a
    40-page pool, greedy and seeded."""
    import time

    from localai_tpu_torch.engine.engine import GenRequest

    pa, pb = [(j * 7) % 250 + 1 for j in range(40)], [(j * 3) % 250 + 1 for j in range(41)]
    got = {}
    for pages in (40, 12):
        eng = _tiny_engine(kv_pages=pages, kv_page_size=16, prefix_cache_entries=0,
                           kv_preempt="swap")
        try:
            ha = eng.submit(GenRequest(prompt_ids=pa, max_new_tokens=100, ignore_eos=True))
            time.sleep(0.05)
            hb = eng.submit(GenRequest(prompt_ids=pb, max_new_tokens=100, ignore_eos=True,
                                       temperature=0.9, top_p=0.9, seed=1234))
            got[pages] = [[e.token_id for e in h if e.kind == "token"] for h in (ha, hb)]
            m = eng.metrics()
            if pages == 12:
                assert m["kv_preempt_swaps"] > 0
                assert m["kv_swap_bytes_in"] == m["kv_swap_bytes_out"]
        finally:
            eng.stop()
    assert got[12] == got[40]


# --------------------------------------------------------------------------- #
# Grammar-constrained decoding on the card (tiny f32 engines)
# --------------------------------------------------------------------------- #

# test_grammar_dfa.py's SCHEMAS[1] (a "fast" automaton) and TOOL_SCHEMA
# (~678 states: "walk"), written out: this file imports no JAX test module.
GRAMMAR_SCHEMAS = {
    "fast": {"type": "object", "properties": {"a": {"type": "integer"},
                                              "b": {"type": "boolean"}},
             "required": ["a", "b"]},
    "walk": {"type": "object", "required": ["name", "arguments"], "properties": {
        "name": {"enum": ["get_weather", "search_web"]},
        "arguments": {"type": "object", "required": ["location"], "properties": {
            "location": {"type": "string"}, "unit": {"enum": ["celsius", "fahrenheit"]},
            "days": {"type": "integer"}}}}},
}


def _grammar_serve(eng, mode, eager):
    """Two requests under `mode`'s schema beside one unconstrained, with
    every block's DFA states held against a host walk of each DFA slot's
    emitted ids. Returns the three id lists."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.functions.jsonschema import GrammarConstraint
    from localai_tpu_torch.ops.grammar import dfa_state_after

    if eager:
        eng._decode_block = eng._block_body
    run = eng._run_block
    held = []

    def checked():
        ok = run()
        gs = eng.d_gstate.cpu().tolist()
        for i, s in enumerate(eng.slots):
            if s is not None and eng.h_active[i] and s.dfa:
                held.append(gs[i] == dfa_state_after(eng._dfa["host"], s.generated))
        return ok

    eng._run_block = checked
    schema = GRAMMAR_SCHEMAS[mode]
    hs = [eng.submit(GenRequest(prompt_ids=[5 + i, 9, 40], max_new_tokens=48,
                                grammar=GrammarConstraint(schema),
                                **(dict(temperature=0.8, top_p=0.9, seed=3) if i else {})))
          for i in range(2)]
    hs.append(eng.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=40, ignore_eos=True)))
    out = []
    for h in hs:
        evs = list(h)
        assert evs[-1].kind == "done", evs[-1]
        out.append([e.token_id for e in evs if e.kind == "token"])
    assert held and all(held)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "walk"])
def test_dfa_block_graph_equals_the_eager_body(card, mode):
    """A DFA block captured as a graph gives the eager body's ids and DFA
    states; after warmup(grammar=True) on a prewarmed schema serving it
    captures nothing."""
    outs = {}
    for eager in (False, True):
        eng = _tiny_engine(kv_pages=40, kv_page_size=16, max_slots=4)
        try:
            assert eng.prewarm_grammar(GRAMMAR_SCHEMAS[mode])
            eng.warmup(grammar=True)
            graphs = eng.metrics()["decode_graph_captures"]
            dfa0 = eng.m_dfa_tokens
            outs[eager] = _grammar_serve(eng, mode, eager)
            assert eng.m_dfa_tokens > dfa0 and eng._dfa["mode"] == mode
            if not eager:
                assert eng.metrics()["decode_graph_captures"] == graphs
        finally:
            eng.stop()
    assert outs[False] == outs[True]


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["allowed", "advance_fast", "advance_walk"])
def test_ops_grammar_gives_the_cpus_bits(card, fn):
    from localai_tpu_torch.engine.tokenizer import SyntheticByteTokenizer
    from localai_tpu_torch.functions.dfa import build_token_tables, compile_schema_dfa
    from localai_tpu_torch.ops import grammar

    V = 32000
    mode = fn.split("_")[-1] if fn != "allowed" else "walk"
    tok = SyntheticByteTokenizer(V)
    tables = build_token_tables(compile_schema_dfa(GRAMMAR_SCHEMAS[mode]), tok.token_strings(),
                                set(tok.eos_ids), V)
    g = torch.Generator().manual_seed(1)
    state = torch.randint(0, tables.trans.shape[0], (8,), generator=g, dtype=torch.int32)
    toks = torch.randint(0, V, (8,), generator=g)
    mask = torch.from_numpy(tables.mask_bits)
    table = torch.from_numpy(tables.next_tok if mode == "fast" else tables.trans)
    cls = torch.from_numpy(tables.tok_cls)

    def run(dev):
        if fn == "allowed":
            return grammar.dfa_allowed(mask.to(dev), state.to(dev), V).cpu()
        return grammar.dfa_advance(mode, table.to(dev), cls.to(dev), state.to(dev),
                                   toks.to(dev)).cpu()

    assert torch.equal(run("cuda"), run("cpu"))


@pytest.mark.cuda
def test_host_walk_block_candidates_are_the_topk_of_its_logits(card):
    """A host-walk ("grammar") block's candidates, replayed from its graph,
    equal the eager body's, and the eager body's are torch.topk of the
    step's logits + bias."""
    from localai_tpu_torch.engine import engine as engine_mod
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.functions.gbnf import GbnfConstraint

    # test_gbnf.py's ARITH (center-recursive: no DFA, so the host walk).
    recursive = r"""
root  ::= (expr "=" ws term "\n")+
expr  ::= term ([-+*/] term)*
term  ::= ident | num | "(" ws expr ")" ws
ident ::= [a-z] [a-z0-9_]* ws
num   ::= [0-9]+ ws
ws    ::= [ \t\n]*
"""
    cands = {}
    for eager in (False, True):
        eng = _tiny_engine(max_slots=2)
        logits_seen = []
        sample = engine_mod.sample
        try:
            if eager:
                eng._decode_block = eng._block_body

                def spy(logits, *a, **kw):
                    logits_seen.append(logits.float().clone())
                    return sample(logits, *a, **kw)

                engine_mod.sample = spy
            else:
                eng.warmup(grammar=True)
            run, rows = eng._run_block, []

            def record():
                ok = run()
                rows.append(eng._b_out[eng._tk_row:eng._lp_row].T.cpu().clone())
                if eager:
                    want = torch.topk(logits_seen[-1] + eng.bias, rows[-1].shape[1], dim=-1)
                    assert torch.equal(rows[-1], want.indices.cpu())
                return ok

            eng._run_block = record
            dfa0 = eng.m_dfa_tokens  # warmup's boolean request may ride a DFA
            h = eng.submit(GenRequest(prompt_ids=[7, 8, 9], max_new_tokens=12,
                                      grammar=GbnfConstraint(recursive)))
            evs = list(h)
            assert evs[-1].kind == "done"
            assert eng.m_dfa_tokens == dfa0 and rows
            cands[eager] = ([e.token_id for e in evs if e.kind == "token"], rows)
        finally:
            engine_mod.sample = sample
            eng.stop()
    assert cands[False][0] == cands[True][0]
    assert all(torch.equal(a, b) for a, b in zip(cands[False][1], cands[True][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("plan", ["q4_k_m", "q8_0"])
def test_gguf_forms_match_plain_version(card, tmp_path, plan, dtype):
    """B3 on every projection of a GGUF file's first layer as the loader
    repacked it (g4 with per-group zero points from q4_K; gq from q8_0 and
    the regridded q6_K), counted by form, and B4 on an untied q8_0 head."""
    import numpy as np

    import chip_smoke
    from localai_tpu_torch.engine.gguf import load_gguf_checkpoint
    from localai_tpu_torch.models.config import ArchConfig
    from localai_tpu_torch.ops import quant_matmul as qm

    cfg = ArchConfig(name="g", vocab_size=1024, hidden_size=256, intermediate_size=512,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                     tie_embeddings=plan == "q4_k_m")
    path = str(tmp_path / "m.gguf")
    chip_smoke.write_gguf_model(path, cfg, 2, plan)
    _arch, tree, _tok = load_gguf_checkpoint(path)
    g = torch.Generator().manual_seed(3)
    forms = set()
    for key, w in tree["layers"].items():
        if not isinstance(w, dict):
            continue
        wd = {k: torch.from_numpy(np.ascontiguousarray(v[0])).cuda() for k, v in w.items()}
        form = "g4" if "g4" in wd else "gq"
        forms.add(form)
        x = torch.randn(8, wd[form].shape[0] * 32, generator=g).to(device="cuda", dtype=dtype)
        before = getattr(qm.qmm, "launches_" + form)
        out = qm.qmm(x, wd)
        assert getattr(qm.qmm, "launches_" + form) == before + 1, key
        ref = qm.qmm_plain(x, wd).float()
        scale = ref.abs().max().item()
        err = (out.float() - ref).abs()
        bound = 1e-4 * scale if dtype == torch.float32 else 2.0**-7 * ref.abs() + 1e-4 * scale
        assert bool((err <= bound).all()), key
    assert forms == ({"g4", "gq"} if plan == "q4_k_m" else {"gq"})
    if plan == "q8_0":
        head = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in tree["lm_head"].items()}
        h = torch.randn(8, 256, generator=g).to(device="cuda", dtype=dtype)
        ref = qm.qunembed_plain(h, head)
        assert (qm.qunembed(h, head) - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# --------------------------------------------------------------------------- #
# Observability and faults on the card (tiny f32 engines)
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_fence_reads_the_device_time_of_a_block(card):
    """trace_fence: each dispatched loop window carries its block's device
    ms from the CUDA event pair (> 0, and no longer than the window's
    wall), read after the block's own host read."""
    eng = _tiny_engine(trace_fence=True, kv_pages=40, kv_page_size=16)
    try:
        eng.start()
        _tiny_ids(eng, [5, 6, 7, 8], n=24)
        import time
        time.sleep(0.1)
        snap = eng.journal.snapshot()
        blocks = [e for e in snap if e["event"] == "decode_block"]
        windows = [e for e in snap if e["event"] == "loop_iter" and e["b"] > 0
                   and "phases" in e and e["phases"].get("dispatch")]
        assert blocks and windows
        for w in windows:
            wall = sum(w["phases"].values())
            assert 0 < w["b"] <= wall + 1e-3, (w["b"], w["phases"])
    finally:
        eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["device_dispatch", "control_commit"])
def test_fault_before_a_first_capture_leaves_no_graph_and_no_capture(card, site):
    """A fault on a block shape not yet captured fails that block's
    requests before any capture begins: the stream is out of capture mode,
    no graph entry is left half built, and the next block of the shape
    captures and serves."""
    from localai_tpu_torch.testing import faults

    eng = _tiny_engine(kv_pages=40, kv_page_size=16)
    try:
        eng.start()
        # device_dispatch fires twice in an admission, then at the block.
        after = 2 if site == "device_dispatch" else 0
        with faults.active(faults.ChaosScript(0, [faults.ChaosPhase(site, after_calls=after)],
                                              threads={eng._thread.ident})):
            from localai_tpu_torch.engine.engine import GenRequest

            evs = list(eng.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=10,
                                             ignore_eos=True)))
        assert evs[-1].kind == "error" and "InjectedFault" in evs[-1].error
        assert torch.cuda.is_current_stream_capturing() is False
        assert eng.metrics()["decode_graph_captures"] == 0 and not eng._graph_cache
        assert len(eng._free_pages) == eng.ecfg.kv_pages
        assert len(_tiny_ids(eng, [5, 6, 7], n=10)) == 10
        assert eng.metrics()["decode_graph_captures"] == len(eng._graph_cache) > 0
        assert sum(e["event"] == f"fault_{site}" for e in eng.journal.snapshot()) == 1
    finally:
        eng.stop()


@pytest.mark.cuda
def test_engines_loaded_and_dropped_leave_no_memory(card):
    """A crash-only restart builds a new engine for each death: an engine
    that served (graphs captured) and was stopped and dropped leaves no
    device memory behind (cuBLAS keeps a workspace for each stream it ran
    on, so every engine captures on one shared side stream)."""
    import gc

    after = []
    for _ in range(3):
        eng = _tiny_engine(kv_pages=40, kv_page_size=16)
        eng.start()
        assert len(_tiny_ids(eng, [5, 6, 7], n=12)) == 12
        assert eng.metrics()["decode_graph_captures"] > 0
        eng.stop()
        eng.drop_device_state()
        del eng
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[2] == after[1], after


# deepseek-v2-lite's experts as a deepseek2 GGUF loads them: grouped int8 per
# expert (GGUF q8_0 / the regridded K-quants), E = 64, gate / up 2048 -> 1408,
# down 1408 -> 2048, one layer of a stacked [L, E, G, 32, out] tree.
DEEPSEEK_GQ_SHAPES = [("...d,edf->...ef", 64, 2048, 1408), ("...ef,efd->...ed", 64, 1408, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub, E, n_in, n_out", DEEPSEEK_GQ_SHAPES)
def test_qmm_moe_grouped_int8_at_deepseek_experts_matches_plain_version(sub, E, n_in, n_out,
                                                                        dtype):
    """B3's expert form on the `gq` stacks of a deepseek2 GGUF layer (layer
    1 of a two-layer stack, so the payload and scales are slices) at 8 and
    48 rows, against qmm_moe_plain; a second launch the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit (nvcc) to build "
                    "localai_tpu_torch/csrc/quant_matmul.cu")
    try:
        kernels.nvcc_path()
    except RuntimeError:
        pytest.skip("needs the CUDA toolkit's nvcc to build localai_tpu_torch/csrc/quant_matmul.cu")
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    g = torch.Generator(device="cuda").manual_seed(n_in)
    stack = _quantized("grouped_int8", torch.randn(2, E, n_in, n_out, generator=g,
                                                   device="cuda") * 0.02)
    qw = {k: v[1] for k, v in stack.items()}
    assert qw["gq"].shape == (E, n_in // 32, 32, n_out) and qw["gs"].shape == (E, n_in // 32, 1,
                                                                             n_out)
    for N in (8, 48):
        x = torch.randn((N, n_in) if sub == "...d,edf->...ef" else (N, E, n_in), generator=g,
                        device="cuda").to(dtype)
        before = qmm_moe.launches
        got = qmm_moe(x, qw, sub)
        torch.cuda.synchronize()
        assert qmm_moe.launches == before + 1 and got.shape == (N, E, n_out)
        _assert_moe_close(got, x, qw, sub)
        assert torch.equal(got, qmm_moe(x, qw, sub))


@pytest.mark.cuda
def test_whisper_engine_replays_its_graph_and_captures_beside_a_busy_thread():
    """WhisperEngine on the card keeps its graphs (the encoder and one step)
    for each chunk count: a second request of a count replays them (no
    capture), and the ids are those of eager steps on the card. A new count
    captures while another thread launches, allocates and synchronizes its
    stream, as an engine's loop thread does; neither side fails (the
    capture is thread-local, on the engines' capture stream under their
    lock). A request of more than MAX_KEPT_BATCH chunks captures for itself
    and keeps nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (whisper's decode graph is captured on the card)")
    import threading

    import numpy as np

    from localai_tpu_torch.engine.audio_engine import WhisperEngine
    from localai_tpu_torch.models import whisper as W

    cfg = W.WHISPER_PRESETS["whisper-test"]
    eng = WhisperEngine(cfg, W.init_params(cfg, seed=0, device="cuda"))

    def eager(audio) -> list[list[int]]:
        with torch.no_grad():
            mel, prompt = eng.mels(audio), eng._prompt_ids(None, False)
            st = W._Greedy(cfg, eng.params, mel, len(prompt), eng.MAX_NEW_TOKENS)
            st.reset(mel, prompt)
            st.encode()
            for _ in range(st.ids.shape[1]):
                st.steps(1)
            toks = st.ids[:, len(prompt):]
            n = (toks != cfg.eot_id).sum(dim=-1)
            return [toks[c, : int(n[c])].tolist() for c in range(mel.shape[0])]

    audio = np.random.default_rng(0).normal(0, 0.1, 5 * eng.chunk_samples).astype(np.float32)
    one = audio[: eng.chunk_samples]
    first = eng.transcribe(one)
    captures = eng.graphs.captures  # the encoder, one step
    assert captures == 2
    assert eng.transcribe(one) == first and eng.graphs.captures == captures
    assert [s["tokens"] for s in first["segments"]] == eager(one)
    stop, errors = threading.Event(), []

    def busy() -> None:
        """What a loop thread does: launches, allocations, reads that
        synchronize its stream (no device-wide synchronize: that is invalid
        during any capture, and the port makes it only under the capture
        lock)."""
        try:
            while not stop.is_set():
                x = torch.ones(512, 512, device="cuda") + stop.is_set()
                (x @ x).sum().item()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=busy, daemon=True)
    th.start()
    try:
        two = eng.transcribe(audio[: 2 * eng.chunk_samples])
    finally:
        stop.set()
        th.join()
    assert not errors and eng.graphs.captures == 2 * captures
    assert [s["tokens"] for s in two["segments"]] == eager(audio[: 2 * eng.chunk_samples])
    assert eng.graphs.MAX_KEPT_BATCH < 5
    for _ in range(2):
        five = eng.transcribe(audio)
        assert len(eng.graphs._shapes) == 2
    assert eng.graphs.captures == 4 * captures
    assert [s["tokens"] for s in five["segments"]] == eager(audio)
