"""The port's LoRA delta (ops/lora_matmul.py) against the JAX package on
the CPU: the kernel's plain version against the Pallas kernel in interpret
mode and the XLA gather form, the port's gather form against the XLA one
in f32 and bf16, null rows, and the dispatcher's shape split."""

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
    monkeypatch.setattr(lm, "lora_bgmv", lambda *a: calls.append("kernel") or "k")
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
    before = lm.lora_bgmv.launches
    got = lm.lora_bgmv(_t(x), _t(a), _t(b), ids)
    assert torch.equal(got, lm.lora_delta_plain(_t(x), _t(a), _t(b), ids))
    assert lm.lora_bgmv.launches == before


def test_lora_part_matches_the_jax_package_and_every_target():
    # The base weight's tensor-parallel role per target key, which the later
    # multi-GPU wrapper reads: the same table as the reference, one entry
    # per key the loaders stack.
    from localai_tpu.ops.lora_matmul import LORA_PART as JAX_LORA_PART
    from localai_tpu_torch.engine.weights import lora_target_dims
    from localai_tpu_torch.models import get_arch

    assert lm.LORA_PART == JAX_LORA_PART
    assert set(lm.LORA_PART) == set(lora_target_dims(get_arch("tiny")))
