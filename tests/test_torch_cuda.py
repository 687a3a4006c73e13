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
@pytest.mark.parametrize("S", [256, 200])  # 200: the last query / kv tile is partial
def test_flash_kernel_matches_plain_version(card, S, D, dtype):
    B, H, K = 3, 32, 8
    q, k, v = _qkv(S + D, B, S, H, K, D, dtype)
    lengths = torch.tensor([S, 1, 37], dtype=torch.int32, device="cuda")
    before = flash.flash_prefill_attention.launches
    out = flash.flash_prefill_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert flash.flash_prefill_attention.launches == before + 1
    ref = flash.flash_prefill_attention_plain(q, k, v, lengths)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for b, n in enumerate(lengths.tolist()):
        assert (out[b, n:] == 0).all()  # padded rows are exact zeros


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode", ["decode", "mq"])
def test_paged_kernel_fp8_pools_match_plain_version(card, mode, D, dtype):
    """fp8 pools with a per-head kv_scale (not all ones): the kernel widens
    and scales in registers, the plain walk in PyTorch, on the same bytes."""
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
    """Group-wise symmetric int8 (GGUF q8_0's layout): {"gq", "gs"}."""
    g = w.shape[0] // group
    wg = w.float().reshape(g, group, w.shape[1])
    s = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-9)
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
    for N in (1, 8, 256):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        before = qmm.launches
        got = qmm(x, qw)
        torch.cuda.synchronize()
        assert qmm.launches == before + 1
        _assert_qmm_close(got, x, qw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("V, D", [(1000, 64), (128256, 4096)])
def test_unembed_kernel_matches_plain_version(card, V, D, dtype):
    from localai_tpu_torch.ops.quant_matmul import qunembed, qunembed_plain

    g = torch.Generator(device="cuda").manual_seed(V + D)
    w = torch.randn(V, D, generator=g, device="cuda") * 0.02
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
    head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
    for N in (1, 8, 256):
        h = torch.randn(N, D, generator=g, device="cuda").to(dtype)
        before = qunembed.launches
        got = qunembed(h, head)
        torch.cuda.synchronize()
        assert qunembed.launches == before + 1
        want = qunembed_plain(h, head)
        assert got.dtype == torch.float32 and got.shape == (N, V)
        # f32 arithmetic on both sides (bf16 h widens exactly): summation order.
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


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
# 24 is rounded up to a power of two in the kernel's thread mapping.
@pytest.mark.parametrize("R", [1, 8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_lora_kernel_matches_plain_version(card, shape, R, dtype):
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_delta_plain

    n_in, n_out = shape
    NA = 9  # 8 adapters and the null one
    g = torch.Generator(device="cuda").manual_seed(n_in + n_out + R)
    a, b = _lora_stack(g, n_in, n_out, R, NA, dtype)
    for N in (1, 8, 256):
        x = torch.randn(N, n_in, generator=g, device="cuda").to(dtype)
        ids = (torch.arange(N, device="cuda") % NA).to(torch.int32)
        if N == 1:
            ids[0] = 1
        before = lora_bgmv.launches
        got = lora_bgmv(x, a, b, ids)
        torch.cuda.synchronize()
        assert lora_bgmv.launches == before + 1
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
    before = lm.lora_bgmv.launches
    assert lm.lora_delta(x, {"a": a, "b": b}, ids).shape == (4, 96)
    # Host ids are checked on the host and copied to the card.
    assert torch.equal(lm.lora_bgmv(x, a, b, ids.cpu()), lm.lora_bgmv(x, a, b, ids))
    torch.cuda.synchronize()
    assert lm.lora_bgmv.launches == before + 3
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
