"""The decode block as a capturable body: counter-based sampling noise (a
pure function of seed, token position and column, checked bit for bit
against a numpy uint32 version of the hash), `Engine._block_body` driven
directly against the JAX engine's greedy ids on the dense and the paged
engine, `Engine.warmup`, and the launch accounting of captured graphs
(kernels.captured_counts / replay_counted) with a stub graph. Graphs exist
only on the card; here the body runs eagerly. Every engine is stopped."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch import kernels
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest, RequestHandle
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import quant
from localai_tpu_torch.ops import flash, lora_matmul, paged_flash, quant_matmul
from localai_tpu_torch.ops import sampling as tsamp

# --------------------------------------------------------------------------- #
# Sampling noise
# --------------------------------------------------------------------------- #


def _np_fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _np_noise_bits(seeds, positions, vocab) -> np.ndarray:
    """The hash in plain uint32 arithmetic (products wrap at 2^32)."""
    with np.errstate(over="ignore"):
        s = _np_fmix32(np.asarray(seeds, np.uint32) ^ np.uint32(0x9E3779B9))
        row = _np_fmix32(s + np.asarray(positions, np.uint32) * np.uint32(0x27D4EB2F))
        cols = np.arange(vocab, dtype=np.uint32) * np.uint32(0x165667B1)
        return _np_fmix32(row[:, None] ^ cols[None, :])


@pytest.mark.parametrize("case", ["small", "wide_seeds", "late_positions"])
def test_noise_bits_match_a_numpy_uint32_hash(case):
    rng = np.random.default_rng({"small": 0, "wide_seeds": 1, "late_positions": 2}[case])
    B, V = 6, 1000
    seeds = {"small": np.arange(B), "wide_seeds": rng.integers(0, 2**31, B),
             "late_positions": rng.integers(0, 2**31, B)}[case].astype(np.int64)
    positions = {"small": np.arange(B), "wide_seeds": rng.integers(0, 4096, B),
                 "late_positions": rng.integers(2**20, 2**31, B)}[case].astype(np.int64)
    got = tsamp.noise_bits(torch.from_numpy(seeds), torch.from_numpy(positions), V)
    want = _np_noise_bits(seeds, positions, V)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # The Gumbel noise is -log(-log(u)) of the top 23 bits, u in (0, 1).
    u = ((want >> np.uint32(9)).astype(np.float64) + 0.5) / 2**23
    assert 0.0 < u.min() and u.max() < 1.0
    noise = tsamp.gumbel_noise(torch.from_numpy(seeds), torch.from_numpy(positions), V)
    np.testing.assert_allclose(noise.numpy(), -np.log(-np.log(u)), rtol=1e-5, atol=1e-5)


def test_a_row_depends_only_on_its_seed_and_position():
    V = 512
    alone = tsamp.noise_bits(torch.tensor([77]), torch.tensor([31]), V)[0]
    # The same (seed, position) in another row of another batch.
    batch = tsamp.noise_bits(torch.tensor([5, 9, 77, 1]), torch.tensor([0, 31, 31, 8]), V)
    assert torch.equal(batch[2], alone)
    # Another seed or another position gives another row; seeds i and i + 1
    # (the server's n clones) give unrelated uniforms.
    assert not torch.equal(batch[1], alone)
    nxt = tsamp.noise_bits(torch.tensor([77, 78, 77]), torch.tensor([32, 31, 31]), V)
    assert not torch.equal(nxt[0], alone)
    u = (nxt[1:].double() / 2**32).numpy()
    assert abs(np.corrcoef(u[0], u[1])[0, 1]) < 0.15
    assert 0.45 < u.mean() < 0.55


@pytest.mark.parametrize("sampler", ["simple", "filtered"])
def test_categorical_over_2000_positions_follows_softmax(sampler):
    """One seed, 2000 token positions, one batched call: the 4-way
    categorical's frequencies follow softmax."""
    N = 2000
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(N, 4).contiguous()
    seeds = torch.full((N,), 1234, dtype=torch.int64)
    positions = torch.arange(N, dtype=torch.int64)
    if sampler == "simple":
        p = tsamp.SamplingParams.make(N, temperature=1.0)
        toks = tsamp.sample_simple(logits, seeds, positions, p)
    else:  # top_k = 4 keeps every candidate: the filtered path, same law
        p = tsamp.SamplingParams.make(N, temperature=1.0, top_k=4)
        toks = tsamp.sample(logits, seeds, positions, p)
    hits = np.bincount(toks.numpy(), minlength=4) / N
    want = torch.softmax(logits[0], -1).numpy()
    np.testing.assert_allclose(hits, want, atol=0.04)


def test_greedy_rows_ignore_the_noise():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    p = tsamp.SamplingParams.make(5, temperature=0.0, top_p=0.5)
    for seed in (0, 1, 2**30):
        seeds = torch.full((5,), seed, dtype=torch.int64)
        pos = torch.arange(5, dtype=torch.int64) * 13
        assert torch.equal(tsamp.sample(logits, seeds, pos, p), logits.argmax(-1))
        assert torch.equal(tsamp.sample_simple(logits, seeds, pos, p), logits.argmax(-1))


# --------------------------------------------------------------------------- #
# The block body against the JAX engine
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


ENGINES = {
    "dense": dict(max_slots=2, max_seq=512, min_prefill_bucket=16),
    "paged": dict(max_slots=2, max_seq=256, min_prefill_bucket=16, kv_pages=16,
                  kv_page_size=16),
}
# Two prompts of one bucket (32), so one admission takes both.
BODY_PROMPTS = [list(range(40, 60)), [(j * 7) % 250 + 1 for j in range(27)]]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_block_body_gives_the_jax_engines_greedy_ids(weights, kind):
    """One fused admission, then two n-step blocks through `_block_body`
    called directly (staged as `_run_block` stages them): the first token
    and every id of each block equal the JAX engine's greedy ids."""
    cfg, jp, tp = weights
    n = 8
    kw = ENGINES[kind]
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, block_sizes=(n,), **kw))
    try:
        want = []
        for p in BODY_PROMPTS:
            h = jeng.submit(JaxGenRequest(prompt_ids=p, max_new_tokens=1 + 2 * n,
                                          ignore_eos=True))
            want.append([ev.token_id for ev in h if ev.kind == "token"])
    finally:
        jeng.stop()
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(block_sizes=(n,), **kw))
    try:
        group = [(GenRequest(prompt_ids=p, max_new_tokens=1 + 2 * n, ignore_eos=True),
                  RequestHandle()) for p in BODY_PROMPTS]
        eng._dispatch_admit(group, eng._bucket_for(len(BODY_PROMPTS[0])), [0, 1])
        got = [[h._q.get_nowait().token_id] for _r, h in group]
        win = 0 if eng._paged else 256  # the read window covering 27 + 8 rows
        for _block in range(2):
            assert eng._grow_for_decode(n)
            eng._stage_block(eng.h_active.copy())
            eng._block_body(n, "greedy", win)
            out = eng._b_out[:n].numpy()
            for s in range(2):
                got[s] += out[:, s].tolist()
                eng.slots[s].scheduled += n
                eng.slots[s].sched_rows += n
        assert got == want
        assert not eng._graph_cache  # the CPU captures nothing
    finally:
        eng.stop()


def _state(eng):
    return [t.clone() for t in (eng.counts, eng.bias, eng.d_tokens, eng.d_positions,
                                eng.d_seed)]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_warmup_leaves_the_state_and_later_output_unchanged(weights, kind):
    cfg, _, tp = weights
    kw = dict(ENGINES[kind], block_sizes=(8, 2), max_slots=3)

    def make():
        return Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                      engine_cfg=EngineConfig(**kw))

    warm, cold = make(), make()
    try:
        before = _state(warm)
        pages = len(warm._free_pages)
        warm.warmup()
        for a, b in zip(before, _state(warm)):
            assert torch.equal(a, b)
        assert warm.slots == [None] * 3 and not warm.h_active.any()
        assert len(warm._free_pages) == pages
        assert warm.metrics()["decode_graphs"] == 0  # graphs exist only on the card
        prompt = [(j * 5) % 200 + 3 for j in range(21)]
        a = warm.generate(prompt, max_new_tokens=13, ignore_eos=True)
        b = cold.generate(prompt, max_new_tokens=13, ignore_eos=True)
        assert a[0] == b[0] and a[1].completion_tokens == b[1].completion_tokens == 13
    finally:
        warm.stop()
        cold.stop()


def test_warmup_refuses_a_busy_engine(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**ENGINES["dense"]))
    try:
        eng._dispatch_admit([(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=40),
                              RequestHandle())], 16, [0])
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.warmup()
    finally:
        eng.stop()


def test_the_engine_keeps_no_generator_and_a_preempted_request_keeps_its_seed(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**ENGINES["paged"]))
    try:
        assert not any(isinstance(v, torch.Generator) for v in vars(eng).values())
        h = RequestHandle()
        eng._dispatch_admit([(GenRequest(prompt_ids=[4, 5, 6], max_new_tokens=40,
                                         temperature=0.8), h)], 16, [1])
        seed = int(eng.h_seed[1])
        assert int(eng.d_seed[1]) == seed and 0 <= seed < 2**31
        eng._preempt_youngest()
        (req, _h), = list(eng._pending)
        assert req.resume["seed"] == seed and "gen_state" not in req.resume
        samp, _bias, seeds = eng._request_controls([(req, h)])
        assert seeds.tolist() == [seed]
    finally:
        eng.stop()


def test_a_lora_rebuild_drops_the_graphs_of_the_old_stacks(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**ENGINES["dense"]))
    try:
        plain = eng._block_key(8, "greedy", 256)
        assert plain == ("greedy", 8, 256, None)
        eng._lora_rebuild(("wq", "wv"), 2, 4)
        old = eng._block_key(8, "greedy", 256)
        assert old == ("greedy", 8, 256, (("wq", "wv"), 2, 4))
        eng._graph_cache = {plain: "plain graph", old: "old-stack graph"}
        eng._lora_rebuild(("wq", "wv"), 3, 4)
        assert eng._graph_cache == {plain: "plain graph"}
        assert eng._block_key(8, "greedy", 256)[3] == (("wq", "wv"), 3, 4)
    finally:
        eng.stop()


# --------------------------------------------------------------------------- #
# Launch accounting of captured graphs
# --------------------------------------------------------------------------- #

COUNTERS = ((flash.flash_prefill_attention, "launches"),
            (paged_flash.paged_partials_rows, "launches"),
            (paged_flash.paged_partials_rows, "latent_launches"),
            (quant_matmul.qmm, "launches"),
            (quant_matmul.qmm, "launches_q"),
            (quant_matmul.qmm, "launches_gq"),
            (quant_matmul.qmm, "launches_g4"),
            (quant_matmul.qmm_moe, "launches"),
            (quant_matmul.qunembed, "launches"),
            (lora_matmul.lora_bgmv_group, "launches"),
            (quant.matmul, "dequant_calls"),
            (quant.moe_matmul, "dequant_calls"),
            (quant.unembed_matmul, "dequant_calls"))


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _read():
    return [getattr(h, a) for h, a in COUNTERS]


@pytest.fixture
def counters():
    saved = _read()
    yield
    for (h, a), v in zip(COUNTERS, saved):
        setattr(h, a, v)


def test_replays_add_the_counts_their_capture_took_back(counters):
    bumps = (0, 2, 5, 7, 4, 0, 3, 3, 1, 3, 0, 2, 1)

    def capture():  # what the wrappers count while a block is captured
        for (h, a), d in zip(COUNTERS, bumps):
            setattr(h, a, getattr(h, a) + d)

    start = _read()
    deltas = kernels.captured_counts(capture)
    assert tuple(deltas) == bumps
    assert _read() == start  # the capture launched nothing
    g = _StubGraph()
    for k in range(1, 4):
        kernels.replay_counted(g, deltas)
        assert g.replays == k
        assert _read() == [s + k * d for s, d in zip(start, bumps)]


def test_a_failed_capture_leaves_the_counts(counters):
    def capture():
        quant_matmul.qmm.launches += 5
        raise RuntimeError("capture failed")

    start = _read()
    with pytest.raises(RuntimeError, match="capture failed"):
        kernels.captured_counts(capture)
    assert _read() == start
