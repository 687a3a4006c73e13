"""The PyTorch port's speculative decoding through its Engine on the tiny f32
weights (max_slots=2, max_seq=128), against the JAX package's plain engine
and against itself: greedy ids of prompt_lookup, self_draft and
draft_model (n_draft = 5) equal the port's plain engine and the JAX plain
engine, dense and paged, with rounds firing (the pinned-bias prompt of the
JAX package's tests/test_speculative.py); seeded sampled ids are the same
on the dense and paged engines and alone or beside another request; each
slot's acceptance EWMA follows its own stream; DFA grammar slots and LoRA
tenants under the model-free modes give the plain engine's ids; a draft
engine refuses adapters and clones fork groups; a model-free slot swapped
out and back in gives the ids of an ample pool; the knobs are validated
with the reference's texts. Every engine is stopped."""

import dataclasses

import jax
import numpy as np
import pytest

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu.models.config import ArchConfig as JaxArchConfig
from localai_tpu_torch.engine.engine import AdapterError, Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy, random_lora_adapter
from localai_tpu_torch.functions.jsonschema import GrammarConstraint
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models.config import ArchConfig

MODES = ("prompt_lookup", "self_draft", "draft_model")
# A prompt that repeats the biased continuation: the first dispatch after
# admission is a round in every mode (tests/test_speculative.py).
PINNED = ([10] + [77] * 20, {77: 25.0})
PROMPTS = [([65, 66, 67], {}), ([1, 2], {}), PINNED]
BASE = dict(max_slots=2, max_seq=128, min_prefill_bucket=16)
PAGED = dict(kv_pages=14, kv_page_size=16)
NEW = 24
DRAFT = dict(name="tiny-draft", hidden_size=32, intermediate_size=64, num_layers=1,
             num_heads=2, num_kv_heads=1, max_position=256, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    dcfg = ArchConfig(vocab_size=cfg.vocab_size, **DRAFT)
    jdp = jl.init_params(JaxArchConfig(vocab_size=cfg.vocab_size, **DRAFT), jax.random.key(9))
    dp = params_from_numpy(dcfg, jax.tree.map(np.asarray, jdp), device="cpu")
    return cfg, jp, tp, dcfg, dp


def _engine(weights, mode="off", paged=False, **kw):
    cfg, _jp, tp, dcfg, dp = weights
    ecfg = dict(BASE, spec_mode=mode, **(PAGED if paged else {}))
    ecfg.update(kw)
    draft = dict(draft_cfg=dcfg, draft_params=dp, n_draft=5) if mode == "draft_model" else {}
    return Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**ecfg),
                  device="cpu", **draft)


def _ids(handle):
    return [ev.token_id for ev in handle if ev.kind == "token"]


def _run(eng, prompts=PROMPTS, **kw):
    return [_ids(eng.submit(GenRequest(prompt_ids=list(p), max_new_tokens=NEW, ignore_eos=True,
                                       logit_bias=dict(b), **kw)))
            for p, b in prompts]


@pytest.fixture(scope="module")
def plain_ids(weights):
    """The port's plain engine ids, held equal to the JAX plain engine's."""
    cfg, jp = weights[:2]
    je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                   engine_cfg=JaxEngineConfig(**BASE, spec_mode="off"))
    je.start()
    pe = _engine(weights)
    try:
        want = [[ev.token_id for ev in je.submit(JaxGenRequest(
            prompt_ids=list(p), max_new_tokens=NEW, ignore_eos=True, logit_bias=dict(b)))
                 if ev.kind == "token"] for p, b in PROMPTS]
        got = _run(pe)
    finally:
        je.stop()
        pe.stop()
    assert got == want
    return got


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
def test_greedy_spec_ids_equal_plain_and_jax(weights, plain_ids, mode, paged):
    eng = _engine(weights, mode, paged)
    try:
        assert _run(eng) == plain_ids
        m = eng.metrics()
        assert m["spec_rounds"] > 0 and m["spec_dispatches"] > 0
        assert 0.0 < m["spec_accept_rate"] <= 1.0 and m["spec_tokens_drafted"] > 0
        assert m["spec_draft_len_hist_5"] > 0
        assert (eng.sd_cache is not None) == (mode == "self_draft")
        assert (eng.d_cache is not None) == (mode == "draft_model")
        if mode == "self_draft":
            assert eng.sd_cache.k.shape[0] == eng.cfg.self_draft_layers == 1
    finally:
        eng.stop()


SAMPLED = dict(temperature=0.9, top_k=40, repeat_penalty=1.1, seed=11)


@pytest.mark.parametrize("mode", MODES)
def test_seeded_sampled_ids_repeat_across_pools_and_batches(weights, mode):
    """A seeded sampled request's ids depend only on its seed: the same on
    the dense and paged engines, alone and beside a greedy request (whose
    ids stay the plain engine's). Short plain blocks (4 steps) plan often,
    so rounds fire where the stream repeats; a mild bias keeps both accepts
    and rejections in the run."""
    runs = []
    for paged, beside in ((False, False), (True, False), (False, True)):
        eng = _engine(weights, mode, paged, block_sizes=(4, 1))
        try:
            h = eng.submit(GenRequest(prompt_ids=PINNED[0], max_new_tokens=NEW, ignore_eos=True,
                                      logit_bias={77: 4.0}, **SAMPLED))
            other = None
            if beside:
                other = eng.submit(GenRequest(prompt_ids=[65, 66, 67], max_new_tokens=NEW,
                                              ignore_eos=True))
            runs.append(_ids(h))
            if other is not None:
                assert _ids(other) == _run(_plain(weights), PROMPTS[:1])[0]
            assert eng.metrics()["spec_rounds"] > 0
        finally:
            eng.stop()
    assert len(runs[0]) == NEW and runs[0] == runs[1] == runs[2]


_PLAIN = {}


def _plain(weights):
    if "eng" not in _PLAIN:
        _PLAIN["eng"] = _engine(weights)
    return _PLAIN["eng"]


@pytest.fixture(scope="module", autouse=True)
def _stop_plain():
    yield
    if "eng" in _PLAIN:
        _PLAIN.pop("eng").stop()


def test_acceptance_ewma_diverges_per_slot(weights):
    """One slot whose drafts are always wrong beside one that repeats: the
    cold slot's draft length reaches 0, the hot one's stays at the full
    window, and both keep the plain engine's ids."""
    eng = _engine(weights, "prompt_lookup")
    orig = type(eng)._lookup_propose

    def patched(self, i, kmax):
        if self.slots[i].request.prompt_ids[0] == 99:
            return [3, 5, 7, 9, 11][:kmax]  # never the biased argmax
        return orig(self, i, kmax)

    eng._lookup_propose = patched.__get__(eng)
    reqs = [([40, 41, 42], {77: 25.0}), ([99, 98, 97], {88: 25.0})]
    try:
        hs = [eng.submit(GenRequest(prompt_ids=p, max_new_tokens=60, ignore_eos=True,
                                    logit_bias=b)) for p, b in reqs]
        got = [_ids(h) for h in hs]
        hist = eng.m_spec_dlen_hist
        assert hist.get(0, 0) > 0 and hist.get(5, 0) > 0, hist
        assert set(hist) <= set(eng._spec_buckets) | {1, 3, 4}
    finally:
        eng.stop()
    plain = _plain(weights)
    assert got == [_ids(plain.submit(GenRequest(prompt_ids=p, max_new_tokens=60, ignore_eos=True,
                                                logit_bias=b))) for p, b in reqs]


SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "boolean"}},
          "required": ["a", "b"]}


@pytest.mark.parametrize("mode", ["prompt_lookup", "self_draft"])
def test_dfa_grammar_slots_keep_plain_ids(weights, mode):
    plain = _engine(weights)
    spec = _engine(weights, mode)
    try:
        out = []
        for eng in (plain, spec):
            assert eng.prewarm_grammar(SCHEMA)
            before = eng.m_dfa_tokens
            h = eng.submit(GenRequest(prompt_ids=[10, 20, 30], max_new_tokens=40,
                                      grammar=GrammarConstraint(SCHEMA)))
            out.append(_ids(h))
            assert eng.m_dfa_tokens > before
        assert out[0] == out[1]
        if mode == "self_draft":
            assert spec.metrics()["spec_rounds"] > 0
    finally:
        plain.stop()
        spec.stop()


@pytest.mark.parametrize("mode", ["prompt_lookup", "self_draft"])
def test_lora_tenants_keep_plain_ids(weights, tmp_path, mode):
    cfg = weights[0]
    dirs = [random_lora_adapter(cfg, str(tmp_path / f"a{t}"), 4, 8, ("wq", "wv", "w_down"),
                                seed=t, scale=0.1) for t in range(2)]
    reqs = [(PINNED[0], PINNED[1], "a0"), ([65, 66, 67], {}, "a1"), ([1, 2, 3], {}, None)]
    out = []
    for m in ("off", mode):
        eng = _engine(weights, m, paged=True)
        try:
            for t, d in enumerate(dirs):
                eng.register_adapter(f"a{t}", d)
            hs = [eng.submit(GenRequest(prompt_ids=list(p), max_new_tokens=NEW, ignore_eos=True,
                                        logit_bias=b, adapter=a)) for p, b, a in reqs]
            out.append([_ids(h) for h in hs])
            if m != "off":
                assert eng.metrics()["spec_rounds"] > 0
        finally:
            eng.stop()
    assert out[0] == out[1]


def test_draft_engine_refuses_adapters_and_clones_forks(weights, tmp_path):
    eng = _engine(weights, "draft_model", paged=True)
    try:
        with pytest.raises(AdapterError, match="separate draft model"):
            eng.register_adapter("a", random_lora_adapter(weights[0], str(tmp_path / "a"), 4, 8))
        with pytest.raises(AdapterError, match="model-free spec_mode"):
            eng.submit(GenRequest(prompt_ids=[1, 2], adapter="a"))
        reqs = [GenRequest(prompt_ids=PINNED[0], max_new_tokens=8, ignore_eos=True,
                           temperature=0.8, seed=s) for s in (1, 2)]
        hs = eng.submit_fork(reqs)
        assert all(len(_ids(h)) == 8 for h in hs)
        m = eng.metrics()
        assert m["fork_branches"] == 0 and m["spec_rounds"] > 0
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", ["prompt_lookup", "self_draft"])
def test_model_free_swap_resume_keeps_ids(weights, mode):
    """A pool too small for two slots' growth: the younger is swapped out
    and back in (the self-draft scratch syncs from the restored pages), and
    both end with the ids of an ample pool."""
    kw = dict(max_new_tokens=120, ignore_eos=True)
    pa, pb = list(range(1, 41)), list(range(60, 101))
    pool = dict(max_slots=4, max_seq=256, kv_page_size=32, kv_preempt="swap")
    ample = _engine(weights, mode, kv_pages=32, **pool)
    try:
        want = [_ids(ample.submit(GenRequest(prompt_ids=p, **kw))) for p in (pa, pb)]
    finally:
        ample.stop()
    eng = _engine(weights, mode, kv_pages=8, kv_page_headroom=1, **pool)
    try:
        ha = eng.submit(GenRequest(prompt_ids=pa, **kw))  # older than b: b is the victim
        hb = eng.submit(GenRequest(prompt_ids=pb, **kw))
        got = [_ids(ha), _ids(hb)]
        m = eng.metrics()
        assert m["kv_preempt_swaps"] >= 1 and m["spec_rounds"] > 0
    finally:
        eng.stop()
    assert got == want


def _jax_error(weights, ecfg, **kw):
    cfg, jp = weights[:2]
    try:
        JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                  engine_cfg=JaxEngineConfig(**ecfg), **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"the JAX engine accepted {ecfg}")


@pytest.mark.parametrize("ecfg, draft", [
    (dict(spec_mode="bogus"), False),
    (dict(spec_mode="prompt_lookup"), True),
    (dict(spec_mode="draft_model"), False),
    (dict(spec_mode="self_draft", self_draft_layers=2), False),
    (dict(spec_mode="prompt_lookup", spec_accept_ewma=1.5), False),
    (dict(spec_mode="self_draft", spec_draft_buckets=(0,)), False),
    (dict(spec_mode="prompt_lookup", attention_window=64), False),
], ids=["mode", "model_free_with_draft", "draft_model_without_draft", "self_draft_layers",
        "ewma", "buckets", "attention_window"])
def test_validation_texts_match_the_reference(weights, ecfg, draft):
    cfg, jp, tp, dcfg, dp = weights
    jkw, tkw = {}, {}
    if draft:
        jdcfg = JaxArchConfig(vocab_size=cfg.vocab_size, **DRAFT)
        jkw = dict(draft_cfg=jdcfg, draft_params=jl.init_params(jdcfg, jax.random.key(9)))
        tkw = dict(draft_cfg=dcfg, draft_params=dp)
    want = _jax_error(weights, dict(BASE, **ecfg), **jkw)
    with pytest.raises(ValueError) as e:
        Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**BASE, **ecfg),
               device="cpu", **tkw)
    assert str(e.value) == want
    bad = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="must match the target vocab"):
        Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**BASE),
               device="cpu", draft_cfg=bad, draft_params=dp)
