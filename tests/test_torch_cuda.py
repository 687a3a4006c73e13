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
