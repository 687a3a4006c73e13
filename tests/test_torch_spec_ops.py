"""The port's speculative-decoding ops against the JAX package on the CPU,
from the same numpy-seeded inputs: `processed_logprobs` over every sampler
knob, `deterministic_accept`, the draft's dense `decode_step`,
`self_draft_view`, the verify pass `decode_chunk` (dense, paged, an fp8
pool with a per-head kv_scale, LoRA rows) and the prompt-lookup suffix
index. Then the port against itself: processed log-probs plus Gumbel noise
draw the sampler's token, noise stream 0 keeps its bits, and the accept
step (ops/sampling.verify_step) recovers the target distribution for a
stochastic and for a point-mass draft."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import speclookup as jax_speclookup
from localai_tpu.models import llama as jl
from localai_tpu.ops import sampling as js
from localai_tpu_torch.engine import speclookup
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.ops import sampling as ts

# f32 both sides, summation order only (tests/test_torch_paged_engine.py).
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
# Log-probs of excluded tokens are ~-1e30 on both sides: compared clipped.
LP_FLOOR = -1e4


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


SAMPLERS = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=0.9, top_k=5),
    "top_p": dict(temperature=1.1, top_p=0.8),
    "min_p": dict(temperature=0.8, min_p=0.05),
    "penalties": dict(temperature=0.9, repeat_penalty=1.3, presence_penalty=0.4,
                      frequency_penalty=0.2),
    "bias": dict(temperature=0.6),
}


def _params(kw, B):
    return js.SamplingParams.make(B, **kw), ts.SamplingParams.make(B, **kw, device="cpu")


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_processed_logprobs_matches_jax(name):
    rng = np.random.default_rng(list(SAMPLERS).index(name))
    B, V = 4, 300
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) if name == "penalties" else None
    bias = None
    if name == "bias":
        bias = np.zeros((B, V), np.float32)
        bias[np.arange(B), rng.integers(0, V, B)] = 8.0
        bias[:, :7] = js.NEG_INF
    jp, tp = _params(SAMPLERS[name], B)
    want = np.asarray(js.processed_logprobs(
        jnp.asarray(logits), jp, None if counts is None else jnp.asarray(counts),
        None if bias is None else jnp.asarray(bias)))
    got = ts.processed_logprobs(
        torch.from_numpy(logits), tp, None if counts is None else torch.from_numpy(counts),
        None if bias is None else torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(np.maximum(got, LP_FLOOR), np.maximum(want, LP_FLOOR),
                               atol=LOGIT_ATOL, rtol=0)
    assert np.allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_deterministic_accept_matches_jax():
    rng = np.random.default_rng(1)
    B, V = 5, 64
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    jp, tp = _params(dict(temperature=0.8), B)
    pl_j = js.processed_logprobs(jnp.asarray(logits), jp)
    pl_t = ts.processed_logprobs(torch.from_numpy(logits), tp)
    x = rng.integers(0, V, B).astype(np.int32)
    x[0] = int(np.argmax(logits[0]))
    rj, resj = js.deterministic_accept(pl_j, jnp.asarray(x))
    rt, rest = ts.deterministic_accept(pl_t, torch.from_numpy(x))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=LOGIT_ATOL, rtol=0)
    # The removed token's log-prob is log(1e-38): a subnormal the JAX
    # package's XLA flushes to -inf and torch keeps (-87.5), p = 0 either way.
    got, want = rest.numpy(), np.asarray(resj)
    np.testing.assert_allclose(np.exp(got), np.exp(want), atol=1e-6, rtol=0)
    live = want > -80
    np.testing.assert_allclose(got[live], want[live], atol=LOGIT_ATOL, rtol=0)
    assert np.all(got[np.arange(B), x] < -80) and not live[np.arange(B), x].any()


def _prefilled(cfg, jp, tp, B, S, lens, seed):
    """Both packages' dense caches [L, B, S, K, Hd] after a prefill of
    random prompts of `lens`, written from row 0 (identical numpy rows)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)
    _, ks, vs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens, jnp.int32))
    k = np.zeros((cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim_), np.float32)
    v = np.zeros_like(k)
    k[:, :, :32], v[:, :, :32] = np.asarray(ks), np.asarray(vs)
    jc = jl.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = tl.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    return jc, tc


@pytest.mark.parametrize("view", [False, True], ids=["full", "self_draft_view"])
def test_decode_step_matches_jax(weights, view):
    """Two steps of the dense decode_step (the draft's step), through the
    model or through its self-draft view: logits and the written rows."""
    cfg, jp, tp = weights
    B, S = 3, 64
    lens = [5, 17, 30]
    jc, tc = _prefilled(cfg, jp, tp, B, S, lens, seed=2)
    jcfg = tcfg = cfg
    jpar, tpar = jp, tp
    if view:
        cfg1 = dataclasses.replace(cfg, self_draft_layers=1)
        jcfg, jpar = jl.self_draft_view(cfg1, jp)
        tcfg, tpar = tl.self_draft_view(cfg1, tp)
        assert jcfg.num_layers == tcfg.num_layers == 1
        assert tpar["layers"]["wq"].data_ptr() == tp["layers"]["wq"].data_ptr()  # a view
        jc = jl.KVCache(k=jc.k[:1], v=jc.v[:1])
        tc = tl.KVCache(k=tc.k[:1].clone(), v=tc.v[:1].clone())
    toks = np.asarray([3, 99, 400], np.int32)
    pos = np.asarray(lens, np.int32)
    for step in range(2):
        jlog, jc = jl.decode_step(jcfg, jpar, jnp.asarray(toks), jnp.asarray(pos), jc)
        tlog, tc = tl.decode_step(tcfg, tpar, torch.from_numpy(toks).long(),
                                  torch.from_numpy(pos).long(), tc,
                                  read_rows=32 if step else 0)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(t.numpy()[:, np.arange(B), pos],
                                       np.asarray(j)[:, np.arange(B), pos], atol=KV_ATOL, rtol=0)
        toks = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        pos = pos + 1


def _lora_stacks(cfg, rng, NA=3, R=4):
    """Stacked adapter factors {key: {"a": [L, NA, in, R], "b": [L, NA, R,
    out]}} on wq / wv / w_down, row 0 the null adapter."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    dims = {"wq": (D, cfg.num_heads * cfg.head_dim_), "wv": (D, cfg.num_kv_heads * cfg.head_dim_),
            "w_down": (F, D)}
    out = {}
    for key, (d_in, d_out) in dims.items():
        a = rng.normal(0, 0.1, (cfg.num_layers, NA, d_in, R)).astype(np.float32)
        b = rng.normal(0, 0.1, (cfg.num_layers, NA, R, d_out)).astype(np.float32)
        a[:, 0], b[:, 0] = 0, 0
        out[key] = {"a": a, "b": b}
    return out


@pytest.mark.parametrize("case", ["dense", "paged", "paged_fp8_scale", "dense_lora"])
def test_decode_chunk_matches_jax(weights, case):
    """The verify pass: a 4-token window a slot over a written prefix
    (ragged starts), logits at every position and the window's rows, the
    JAX package's paged walk through its XLA implementation."""
    cfg, jp, tp = weights
    rng = np.random.default_rng(3)
    B, T, S, page, MP = 3, 4, 64, 16, 4
    starts = np.asarray([6, 21, 40], np.int64)
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = (starts[:, None] + np.arange(T)[None, :]).astype(np.int32)
    lora_j = lora_t = None
    if case == "dense_lora":
        stacks = _lora_stacks(cfg, rng)
        ids = np.asarray([1, 0, 2], np.int32)
        lora_j = (jax.tree.map(jnp.asarray, stacks), jnp.asarray(ids))
        lora_t = (jax.tree.map(torch.from_numpy, stacks), torch.from_numpy(ids))
    kv_j = kv_t = None
    table = None
    if case.startswith("paged"):
        P = B * MP + 1
        table = rng.permutation(P - 1)[: B * MP].reshape(B, MP).astype(np.int32)
        k = rng.standard_normal((L, P, page, K, Hd)).astype(np.float32)
        v = rng.standard_normal((L, P, page, K, Hd)).astype(np.float32)
        if case == "paged_fp8_scale":
            scale = np.stack([np.linspace(0.5, 2.0, K), np.linspace(1.5, 0.75, K)]).astype(
                np.float32)
            kv_j, kv_t = jnp.asarray(scale), torch.from_numpy(scale)
            k8 = tl.kv_cast(torch.from_numpy(k / scale[0][:, None]), torch.float8_e4m3fn)
            v8 = tl.kv_cast(torch.from_numpy(v / scale[1][:, None]), torch.float8_e4m3fn)
            jc = jl.KVCache(*(jax.lax.bitcast_convert_type(
                jnp.asarray(t.view(torch.uint8).numpy()), jnp.float8_e4m3fn) for t in (k8, v8)))
            tc = tl.KVCache(k=k8.clone(), v=v8.clone())
        else:
            jc = jl.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
            tc = tl.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
        jlog, jc = jl.decode_chunk(cfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc,
                                   ptable=jnp.asarray(table), paged_impl="xla", kv_scale=kv_j)
        tlog, tc = tl.decode_chunk(cfg, tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                   tc, ptable=torch.from_numpy(table), kv_scale=kv_t)
        rows_j = [np.asarray(a.astype(jnp.float32))[:, table[np.arange(B)[:, None], pos // page],
                                                    pos % page] for a in jc]
        rows_t = [a.float().numpy()[:, table[np.arange(B)[:, None], pos // page], pos % page]
                  for a in tc]
    else:
        k = rng.standard_normal((L, B, S, K, Hd)).astype(np.float32)
        v = rng.standard_normal((L, B, S, K, Hd)).astype(np.float32)
        jc = jl.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
        tc = tl.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
        jlog, jc = jl.decode_chunk(cfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc, lora=lora_j)
        tlog, tc = tl.decode_chunk(cfg, tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                   tc, lora=lora_t, read_rows=48)
        bi = np.arange(B)[:, None]
        rows_j = [np.asarray(a)[:, bi, pos] for a in jc]
        rows_t = [a.numpy()[:, bi, pos] for a in tc]
    assert tlog.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    for t, j in zip(rows_t, rows_j):
        if case == "paged_fp8_scale":
            # Stored fp8: equal bits but where the f32 inputs straddle a
            # rounding boundary (one e4m3 step, 2^-3 relative, apart).
            assert np.mean(t != j) < 0.01
            np.testing.assert_allclose(t, j, rtol=0.125, atol=2.0 ** -9)
        else:
            np.testing.assert_allclose(t, j, atol=KV_ATOL, rtol=0)


def test_suffix_index_matches_jax_on_random_streams():
    rng = np.random.default_rng(4)
    for trial in range(40):
        vocab = int(rng.integers(2, 12))
        stream = rng.integers(0, vocab, int(rng.integers(1, 80))).tolist()
        a, b = speclookup.SuffixIndex(), jax_speclookup.SuffixIndex()
        cut = int(rng.integers(0, len(stream) + 1))
        for part in (stream[:cut], stream[cut:]):
            a.extend(part)
            b.extend(part)
            for k in (1, 3, 5):
                assert a.propose(k) == b.propose(k), (trial, k)
        assert len(a) == len(b) == len(stream)
    assert speclookup.build_index([1, 2, 3, 1, 2]).propose(3) == [3, 1, 2]


@pytest.mark.parametrize("name", ["greedy", "temperature", "top_k", "top_p", "min_p"])
def test_processed_logprobs_with_noise_draws_the_samplers_token(name):
    """argmax(processed_logprobs + gumbel_noise) is `sample`'s token at the
    same (seed, position): a speculative round's bonus draw is a plain
    step's."""
    rng = np.random.default_rng(5)
    B, V = 64, 300
    logits = torch.from_numpy((rng.standard_normal((B, V)) * 2).astype(np.float32))
    seeds = torch.arange(B, dtype=torch.int64) * 7 + 3
    pos = torch.arange(B, dtype=torch.int64) + 11
    sp = ts.SamplingParams.make(B, **SAMPLERS[name], device="cpu")
    want = ts.sample(logits, seeds, pos, sp)
    got = torch.argmax(ts.processed_logprobs(logits, sp) + ts.gumbel_noise(seeds, pos, V), -1)
    assert torch.equal(got, want)


def _noise_bits_before_streams(seeds, positions, vocab):
    """noise_bits as it was before streams existed (the bits every seeded
    test pins)."""
    s = ts._fmix32((seeds.to(torch.int64) & ts._M32) ^ 0x9E3779B9)
    row = ts._fmix32((s + ts._mul32(positions.to(torch.int64) & ts._M32, 0x27D4EB2F)) & ts._M32)
    cols = ts._mul32(torch.arange(vocab, dtype=torch.int64), 0x165667B1)
    return ts._fmix32(row[:, None] ^ cols[None, :])


def test_stream_zero_keeps_its_bits_and_streams_differ():
    seeds = torch.tensor([0, 1, 12345, 2**31 - 1])
    pos = torch.tensor([0, 7, 100, 4095])
    base = _noise_bits_before_streams(seeds, pos, 97)
    assert torch.equal(ts.noise_bits(seeds, pos, 97), base)
    assert torch.equal(ts.noise_bits(seeds, pos, 97, stream=ts.STREAM_DRAW), base)
    draft = ts.noise_bits(seeds, pos, 97, stream=ts.STREAM_DRAFT)
    accept = ts.noise_bits(seeds, pos, 97, stream=ts.STREAM_ACCEPT)
    assert (draft != base).float().mean() > 0.99 and (accept != draft).float().mean() > 0.99
    u = ts.uniform_noise(torch.arange(20000), torch.zeros(20000, dtype=torch.int64))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("draft", ["stochastic_q", "point_mass_q"])
def test_accept_step_recovers_the_target_distribution(draft):
    """The accept scan's one step (verify_step) over 40k seeds: the draft
    token drawn from q on its own stream, accepted with probability
    min(1, p/q), else the residual draw. The emitted tokens follow p
    (total variation < 0.02); a bonus step draws from p itself."""
    V, n = 8, 40_000
    rng = np.random.default_rng(0)
    sp = ts.SamplingParams.make(1, temperature=0.9, device="cpu")
    pl = ts.processed_logprobs(torch.from_numpy(rng.standard_normal((1, V)) * 2).float(), sp)
    ql = ts.processed_logprobs(torch.from_numpy(rng.standard_normal((1, V)) * 2).float(), sp)
    p = np.exp(pl.numpy()[0].astype(np.float64))
    seeds = torch.arange(n, dtype=torch.int64)
    pos = torch.full((n,), 17, dtype=torch.int64)
    PL = pl.expand(n, V)
    if draft == "stochastic_q":
        QL = ql.expand(n, V)
        x = torch.argmax(QL + ts.gumbel_noise(seeds, pos, V, ts.STREAM_DRAFT), -1)
    else:
        QL = None
        x = torch.full((n,), int(np.argsort(p)[-2]), dtype=torch.int64)  # p's runner-up
    no_bonus = torch.zeros(n, dtype=torch.bool)
    take, tok = ts.verify_step(PL, x, QL, no_bonus, seeds, pos)
    emp = np.bincount(tok.numpy(), minlength=V) / n
    assert 0.5 * np.abs(emp - p / p.sum()).sum() < 0.02
    assert 0.05 < float(take.float().mean()) < 0.95
    _, bonus_tok = ts.verify_step(PL, x, QL, torch.ones(n, dtype=torch.bool), seeds, pos)
    emp = np.bincount(bonus_tok.numpy(), minlength=V) / n
    assert 0.5 * np.abs(emp - p / p.sum()).sum() < 0.02
