"""Prefill flash attention of the PyTorch port against the JAX package.

The port's plain flash version (what the CUDA kernel is held against on the
card) must match the JAX Pallas kernel run in interpret mode, on the same
numpy inputs, in f32. The CUDA kernel itself runs only on the card: its
tests are in test_torch_cuda.py.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops.attention import causal_prefill_attention as jax_dense
from localai_tpu.ops.flash import flash_prefill_attention as jax_flash
from localai_tpu_torch import kernels
from localai_tpu_torch.ops import attention as tatt
from localai_tpu_torch.ops.flash import (
    _check_cuda_args,
    flash_prefill_attention,
    flash_prefill_attention_plain,
)

# f32 on the CPU on both sides: the two differ only in summation order.
ATOL = 1e-5


def _qkv(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, K, D), np.float32),
            rng.standard_normal((B, S, K, D), np.float32))


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("H,K", [(4, 4), (8, 2)])
def test_plain_flash_matches_pallas_interpret(H, K, S, D):
    B = 3
    q, k, v = _qkv(S + D + H, B, S, H, K, D)
    lengths = np.array([S, 1, S // 2 + 3], np.int32)  # full, single token, ragged
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), interpret=True))
    out = flash_prefill_attention_plain(*_t(q, k, v), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    for b, n in enumerate(lengths):
        assert (out[b, n:] == 0.0).all()  # padded rows are exact zeros


def test_wrapper_takes_plain_route_on_cpu():
    q, k, v = _t(*_qkv(1, 2, 64, 4, 2, 32))
    lengths = torch.tensor([64, 10], dtype=torch.int32)
    before = flash_prefill_attention.launches
    out = flash_prefill_attention(q, k, v, lengths)
    assert torch.equal(out, flash_prefill_attention_plain(q, k, v, lengths))
    assert flash_prefill_attention.launches == before  # no kernel launch on the CPU


def test_dispatcher_flash_route_matches_dense_on_valid_rows():
    B, S, H, K, D = 2, 128, 8, 2, 32
    q, k, v = _qkv(3, B, S, H, K, D)
    lengths = np.array([S, 77], np.int32)
    mask = np.arange(S)[None, :] < lengths[:, None]
    ref = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask)))
    out = tatt.prefill_attention(*_t(q, k, v), torch.from_numpy(mask),
                                 torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(out[mask], ref[mask], atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", ["flash_off", "softcap", "odd_bucket"])
def test_dispatcher_dense_routes(route, monkeypatch):
    """Softcap and odd buckets take the dense route; the reference's
    LOCALAI_FLASH=0 opt-out is not read: the flash route stays (no env var
    routes a tensor away from its kernel)."""
    B, H, K, D = 2, 4, 2, 32
    S = 48 if route == "odd_bucket" else 64
    softcap = 30.0 if route == "softcap" else 0.0
    if route == "flash_off":
        monkeypatch.setenv("LOCALAI_FLASH", "0")
    q, k, v = _qkv(4, B, S, H, K, D)
    lengths = np.array([S, 21], np.int32)
    mask = np.arange(S)[None, :] < lengths[:, None]
    tq, tk, tv = _t(q, k, v)
    tmask = torch.from_numpy(mask)
    out = tatt.prefill_attention(tq, tk, tv, tmask, torch.from_numpy(lengths),
                                 softcap=softcap)
    if route == "flash_off":
        want = flash_prefill_attention_plain(tq, tk, tv, torch.from_numpy(lengths))
        assert torch.equal(out, want)  # still the flash route
    else:
        dense = tatt.causal_prefill_attention(tq, tk, tv, tmask, softcap=softcap)
        assert torch.equal(out, dense)  # the dense route, not flash
    ref = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), softcap=softcap))
    np.testing.assert_allclose(out.numpy()[mask], ref[mask], atol=ATOL, rtol=0)


def test_dense_sliding_window_matches_jax():
    B, S, H, K, D = 1, 32, 4, 2, 16
    q, k, v = _qkv(5, B, S, H, K, D)
    mask = np.ones((B, S), bool)
    ref = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), window=8, sliding=jnp.asarray(True)))
    out = tatt.causal_prefill_attention(*_t(q, k, v), torch.from_numpy(mask),
                                        window=8, sliding=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("change,err", [
    ("head_dim", ValueError), ("dtype", TypeError), ("lengths", TypeError),
    ("heads", ValueError), ("contiguous", ValueError), ("misaligned", ValueError),
])
def test_kernel_argument_checks(change, err):
    B, S, H, K, D = 2, 64, 8, 2, 64
    q, k, v = (torch.zeros(B, S, H, D), torch.zeros(B, S, K, D), torch.zeros(B, S, K, D))
    lengths = torch.full((B,), S, dtype=torch.int32)
    _check_cuda_args(q, k, v, lengths)  # the valid call passes
    if change == "head_dim":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous()
    elif change == "dtype":
        q = q.half()
    elif change == "lengths":
        lengths = lengths.long()
    elif change == "heads":
        k, v = torch.zeros(B, S, 3, D), torch.zeros(B, S, 3, D)
    elif change == "misaligned":  # contiguous, but 4 bytes past a 16-byte boundary
        k = torch.zeros(B * S * K * D + 1)[1:].view(B, S, K, D)
        assert k.is_contiguous() and k.data_ptr() % 16 == 4
    else:
        q = torch.zeros(B, H, S, D).transpose(1, 2)
    with pytest.raises(err):
        _check_cuda_args(q, k, v, lengths)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails leaves nothing behind and raises: the wrapper
    has no other route for CUDA tensors."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: shutil.which("false"))
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed for flash_prefill"):
        kernels.load("flash_prefill")
    assert not kernels.library_path("flash_prefill").exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_wrapper_refuses_other_devices():
    q, k, v = (torch.zeros(1, 64, 4, 64, device="meta"), torch.zeros(1, 64, 2, 64, device="meta"),
               torch.zeros(1, 64, 2, 64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill_attention(q, k, v, torch.zeros(1, dtype=torch.int32, device="meta"))
