"""Layer math of the PyTorch port against the JAX package: RMSNorm, rotary
embeddings (every scaling family) and sampling. Inputs are numpy arrays
from a fixed seed, handed to both packages; f32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.models import get_arch as jax_get_arch
from localai_tpu.ops import norm as jnorm
from localai_tpu.ops import rope as jrope
from localai_tpu.ops import sampling as jsamp
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.ops import norm as tnorm
from localai_tpu_torch.ops import rope as trope
from localai_tpu_torch.ops import sampling as tsamp


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches_jax():
    rng = _rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _rope_cfgs():
    tiny = get_arch("tiny")
    hd = tiny.head_dim_
    table = tuple(1.0 + 0.25 * i for i in range(hd // 2))
    return {
        "none": tiny,
        "llama3": get_arch("llama-3.2-1b"),
        "linear": dataclasses.replace(tiny, rope_scaling="linear", rope_scaling_factor=4.0),
        "yarn": dataclasses.replace(tiny, rope_scaling="yarn", rope_scaling_factor=8.0,
                                    rope_original_max_position=64),
        "longrope": dataclasses.replace(tiny, rope_scaling="longrope", max_position=1024,
                                        rope_original_max_position=256,
                                        rope_long_factor=table, rope_short_factor=table),
    }


@pytest.mark.parametrize("kind", ["none", "llama3", "linear", "yarn", "longrope"])
def test_rope_frequencies_and_amp_match_jax(kind):
    cfg = _rope_cfgs()[kind]
    ref = np.asarray(jrope.rope_frequencies(cfg))
    out = trope.rope_frequencies(cfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert trope.rope_query_amp(cfg) == jrope.rope_query_amp(cfg)


def test_rope_local_frequencies_match_jax():
    cfg = dataclasses.replace(get_arch("tiny"), rope_local_theta=10000.0, rope_theta=1e6)
    np.testing.assert_allclose(trope.rope_frequencies_local(cfg).numpy(),
                               np.asarray(jrope.rope_frequencies_local(cfg)), rtol=1e-6)
    assert trope.rope_frequencies_local(get_arch("tiny")) is None


def test_config_copy_matches_jax_presets():
    from localai_tpu.models.config import PRESETS as JP
    from localai_tpu_torch.models.config import PRESETS as TP

    assert sorted(JP) == sorted(TP)
    for name in JP:
        assert dataclasses.asdict(JP[name]) == dataclasses.asdict(TP[name])
    assert jax_get_arch("tiny").head_dim_ == get_arch("tiny").head_dim_


def test_apply_rope_matches_jax():
    cfg = get_arch("llama-3.2-1b")
    rng = _rng(2)
    x = rng.standard_normal((2, 10, 4, cfg.head_dim_)).astype(np.float32)
    pos = np.stack([np.arange(10), np.arange(500, 510)]).astype(np.int32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      jrope.rope_frequencies(cfg)))
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           trope.rope_frequencies(cfg)).numpy()
    # Angles up to ~500 rad in f32: the two libraries' cos/sin differ by ulps.
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def _params_np(B, rng):
    return dict(
        temperature=np.where(rng.random(B) < 0.3, 0.0, 0.7).astype(np.float32),
        top_k=rng.choice([0, 1, 5, 40], B).astype(np.int32),
        top_p=rng.choice([1.0, 0.9, 0.5], B).astype(np.float32),
        min_p=rng.choice([0.0, 0.05, 0.2], B).astype(np.float32),
        repeat_penalty=rng.choice([1.0, 1.3], B).astype(np.float32),
        presence_penalty=rng.choice([0.0, 0.5], B).astype(np.float32),
        frequency_penalty=rng.choice([0.0, 0.25], B).astype(np.float32),
    )


def _both_params(p):
    return (jsamp.SamplingParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            tsamp.SamplingParams(**{k: torch.from_numpy(v) for k, v in p.items()}))


def test_apply_penalties_matches_jax():
    rng = _rng(3)
    B, V = 8, 97
    logits = rng.standard_normal((B, V)).astype(np.float32) * 4
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    jp, tp = _both_params(_params_np(B, rng))
    ref = np.asarray(jsamp.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), jp))
    out = tsamp.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), tp).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_filter_sorted_matches_jax():
    rng = _rng(4)
    B, K = 16, 64
    sl = -np.sort(-rng.standard_normal((B, K)).astype(np.float32) * 3, axis=-1)
    jp, tp = _both_params(_params_np(B, rng))
    ref = np.asarray(jsamp._filter_sorted(jnp.asarray(sl), jp))
    out = tsamp._filter_sorted(torch.from_numpy(sl), tp).numpy()
    np.testing.assert_array_equal(out <= tsamp.NEG_INF, ref <= jsamp.NEG_INF)
    np.testing.assert_array_equal(out, ref)


def test_greedy_samplers_match_jax():
    rng = _rng(5)
    B, V = 8, 300
    logits = rng.standard_normal((B, V)).astype(np.float32) * 2
    counts = rng.integers(0, 2, (B, V)).astype(np.int32)
    bias = np.where(rng.random((B, V)) < 0.05, -1e30, 0.0).astype(np.float32)
    p = _params_np(B, rng)
    p["temperature"][:] = 0.0
    jp, tp = _both_params(p)
    args_j = (jnp.asarray(logits), jp, jnp.asarray(counts), jnp.asarray(bias))
    args_t = (torch.from_numpy(logits), tp, torch.from_numpy(counts), torch.from_numpy(bias))
    ref = np.asarray(jsamp.sample_greedy(*args_j))
    np.testing.assert_array_equal(tsamp.sample_greedy(*args_t).numpy(), ref)
    # The greedy branch of the full sampler and of the simple one.
    keys = jax.random.split(jax.random.key(0), B)
    ref_full = np.asarray(jsamp.sample(args_j[0], keys, jp, args_j[2], args_j[3]))
    np.testing.assert_array_equal(ref_full, ref)
    gens = [None] * B
    np.testing.assert_array_equal(
        tsamp.sample(args_t[0], gens, tp, args_t[2], args_t[3]).numpy(), ref)
    np.testing.assert_array_equal(
        tsamp.sample_simple(args_t[0], gens, tp, args_t[2], args_t[3]).numpy(), ref)


def _gens(seed, B):
    return [torch.Generator().manual_seed(seed + b) for b in range(B)]


def test_seeded_sampling_is_reproducible_and_respects_filters():
    rng = _rng(6)
    B, V = 6, 200
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32) * 2)
    p = tsamp.SamplingParams.make(B, temperature=1.0)
    a = tsamp.sample(logits, _gens(3, B), p)
    b = tsamp.sample(logits, _gens(3, B), p)
    assert torch.equal(a, b)
    # Unfiltered rows: the simple sampler consumes the same noise.
    assert torch.equal(tsamp.sample_simple(logits, _gens(3, B), p), a)
    # top_k=1 keeps only the argmax, whatever the noise.
    p1 = tsamp.SamplingParams.make(B, temperature=1.0, top_k=1)
    assert torch.equal(tsamp.sample(logits, _gens(9, B), p1), logits.argmax(-1))
    # top_k=3: every draw lands in the row's top 3.
    p3 = tsamp.SamplingParams.make(B, temperature=5.0, top_k=3)
    top3 = logits.topk(3, dim=-1).indices
    for seed in range(5):
        tok = tsamp.sample(logits, _gens(seed * 10, B), p3)
        assert (top3 == tok[:, None]).any(-1).all()


def test_sample_distribution_follows_softmax():
    # 2000 single-row draws of a 4-way categorical at temperature 1.
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    p = tsamp.SamplingParams.make(1, temperature=1.0)
    g = torch.Generator().manual_seed(0)
    hits = np.zeros(4)
    for _ in range(2000):
        hits[int(tsamp.sample_simple(logits, [g], p)[0])] += 1
    want = torch.softmax(logits[0], -1).numpy()
    np.testing.assert_allclose(hits / 2000, want, atol=0.04)


def test_update_counts_matches_jax():
    B, V = 4, 10
    counts = np.zeros((B, V), np.int32)
    tokens = np.array([1, 1, 9, 0], np.int32)
    active = np.array([True, False, True, True])
    ref = np.asarray(jsamp.update_counts(jnp.asarray(counts), jnp.asarray(tokens),
                                         jnp.asarray(active)))
    out = tsamp.update_counts(torch.from_numpy(counts), torch.from_numpy(tokens).long(),
                              torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(out, ref)
