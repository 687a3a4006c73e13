"""The PyTorch port's tree sampling (`Engine.submit_fork`, `Engine.fork`) on
the tiny f32 weights, against the JAX engine and against itself (the JAX
package's tests/test_fork_sampling.py cases that apply on one device). A
same-prompt group admits one prefill and forks the primary's slot per
branch: greedy fork ids equal the JAX engine's submit_fork, on flat and
hierarchical tables; seeded fork bytes equal the port's own clones (noise
is a function of seed and position), on paged and dense engines, with a
page-aligned prompt, a chunked primary, a prefix-hit primary and DFA
branches; a dense engine and fork_sampling off clone; best_of 8 peaks at
<= 1.5x the pages of best_of 1; a mid-stream fork continues its source and
a dead source errors; a primary cancelled before admission requeues its
live branches; mixed prompts are refused. After each group every page
reference is back. Every engine is stopped."""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.functions.jsonschema import GrammarConstraint
from localai_tpu_torch.models import get_arch

PAGE = 16
PAGED = dict(max_slots=8, max_seq=256, min_prefill_bucket=16, kv_pages=64, kv_page_size=PAGE)


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _mk(weights, **kw):
    cfg, _jp, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**kw),
                 device="cpu")
    eng.start()
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    cfg, jp, _tp = weights
    je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                   engine_cfg=JaxEngineConfig(prefix_admit_async_compile=False, **PAGED))
    je.start()
    out = {"jax": je, "paged": _mk(weights, **PAGED), "hier": _mk(weights, **PAGED, kv_l1_span=2),
           "dense": _mk(weights, max_slots=8, max_seq=256, min_prefill_bucket=16)}
    yield out
    for e in out.values():
        e.stop()


def _drain_all(handles):
    outs = [None] * len(handles)

    def one(i):
        toks, final = [], None
        for ev in handles[i]:
            if ev.kind == "token":
                toks.append(ev.token_id)
            else:
                final = ev
        outs[i] = (toks, final)

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(handles))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return outs


def _run_group(eng, reqs, fork):
    handles = eng.submit_fork(reqs) if fork else [eng.submit(r) for r in reqs]
    outs = _drain_all(handles)
    for toks, final in outs:
        assert final is not None and final.kind == "done", getattr(final, "error", final)
    return [toks for toks, _f in outs]


def _reqs(prompt, n, max_new=12, G=GenRequest, **kw):
    return [G(prompt_ids=list(prompt), max_new_tokens=max_new, ignore_eos=True, **kw)
            for _ in range(n)]


def _seeded(prompt, n, **kw):
    return [GenRequest(prompt_ids=list(prompt), max_new_tokens=12, ignore_eos=True,
                       temperature=0.9, top_k=24, seed=900 + i, **kw) for i in range(n)]


def _clean(eng):
    """Every page reference is back once the engine is idle: the free list
    plus the prefix entries' pages cover the pool, and no refcount is
    negative."""
    deadline = time.monotonic() + 10
    while any(s is not None for s in eng.slots) or eng._pending:
        assert time.monotonic() < deadline, "the engine did not go idle"
        time.sleep(0.01)
    held = {p for e in eng._prefix_entries for p in e["pages"]}
    assert (eng._page_refs >= 0).all()
    assert len(eng._free_pages) + len(held) == eng.ecfg.kv_pages


@pytest.mark.parametrize("layout", ["paged", "hier"])
@pytest.mark.parametrize("n", [50, 64], ids=["boundary-page", "page-aligned"])
def test_greedy_fork_equals_the_jax_engines_fork_and_the_clones(engines, layout, n):
    je, te = engines["jax"], engines[layout]
    prompt = [(j * 7) % 250 + 1 for j in range(n)]
    f0 = te.m_forks
    want = _run_group(je, _reqs(prompt, 4, G=JaxGenRequest), fork=True)
    got = _run_group(te, _reqs(prompt, 4), fork=True)
    assert te.m_forks - f0 == 3, "the group did not fork"
    assert got == want
    assert _run_group(te, _reqs(prompt, 4), fork=False) == got
    _clean(te)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_seeded_fork_bytes_equal_the_clones(engines, layout):
    """Branch i's seed is its clone's: the same draws, the same bytes. A
    dense engine clones behind the same API."""
    te = engines[layout]
    prompt = [(j * 11) % 250 + 1 for j in range(45)]
    f0, c0 = te.m_forks, te.m_fork_clone_fallbacks
    got = _run_group(te, _seeded(prompt, 4), fork=True)
    want = _run_group(te, _seeded(prompt, 4), fork=False)
    assert got == want and len(set(map(tuple, got))) > 1
    assert te.m_forks - f0 == (3 if layout == "paged" else 0)
    assert te.m_fork_clone_fallbacks == c0


def test_fork_sampling_off_clones(weights):
    eng = _mk(weights, **PAGED, fork_sampling=False)
    try:
        prompt = list(range(30, 70))
        got = _run_group(eng, _seeded(prompt, 3), fork=True)
        assert got == _run_group(eng, _seeded(prompt, 3), fork=False)
        assert eng.m_forks == 0
    finally:
        eng.stop()


def test_chunked_and_prefix_hit_primaries_fork(weights):
    """A long prompt's primary admits in chunks and forks at its final
    chunk; a primary that hits the prefix cache maps the span and its
    branches reference the same pages."""
    eng = _mk(weights, **{**PAGED, "max_seq": 512, "kv_pages": 96, "prefill_chunk": 64})
    try:
        prompt = [(j * 13) % 250 + 1 for j in range(200)]
        c0 = eng.metrics()["chunked_admits"]
        got = _run_group(eng, _seeded(prompt, 4), fork=True)
        assert eng.m_forks == 3 and eng.metrics()["chunked_admits"] == c0 + 1
        assert got == _run_group(eng, _seeded(prompt, 4), fork=False)
        hits0 = eng.m_prefix_hits
        again = _run_group(eng, _seeded(prompt, 3), fork=True)
        assert eng.m_prefix_hits > hits0 and eng.m_forks == 5
        assert again == got[:3]
        _clean(eng)
    finally:
        eng.stop()


def test_dfa_branches_equal_the_clones(weights):
    """Each branch starts in the primary's first DFA state and carries its
    own machine; constrained forks equal constrained clones."""
    schema = {"type": "object", "properties": {"a": {"type": "integer"},
                                               "b": {"type": "boolean"}},
              "required": ["a", "b"]}
    eng = _mk(weights, **PAGED)
    try:
        assert eng.prewarm_grammar(schema)
        prompt = list(range(60, 100))
        for seeded in (False, True):
            def group():
                return [GenRequest(prompt_ids=list(prompt), max_new_tokens=24,
                                   grammar=GrammarConstraint(schema),
                                   temperature=0.8 if seeded else 0.0,
                                   seed=70 + i if seeded else None) for i in range(3)]
            got = _run_group(eng, group(), fork=True)
            assert got == _run_group(eng, group(), fork=False), f"seeded={seeded}"
        assert eng.m_forks == 4 and eng.m_dfa_tokens > 0
    finally:
        eng.stop()


def test_best_of_8_pages_within_1_5x_of_one(weights):
    eng = _mk(weights, max_slots=9, max_seq=576, min_prefill_bucket=16, kv_pages=80,
              kv_page_size=PAGE, prefix_cache_entries=0)
    try:
        prompt = [(j * 29) % 250 + 1 for j in range(512)]  # 32 full pages
        _run_group(eng, _reqs(prompt, 1, max_new=8), fork=True)
        peak1 = eng.metrics()["kv_pages_peak"]
        assert peak1 >= 32
        eng.m_kv_pages_peak = 0
        _run_group(eng, _reqs(prompt, 8, max_new=8), fork=True)
        peak8 = eng.metrics()["kv_pages_peak"]
        assert eng.m_forks == 7 and eng.m_fork_clone_fallbacks == 0
        assert peak8 <= 1.5 * peak1, (peak8, peak1)
        _clean(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_midstream_fork_continues_its_source(weights, layout):
    kw = dict(PAGED, max_seq=512) if layout == "paged" else dict(max_slots=8, max_seq=512)
    eng = _mk(weights, **kw)
    try:
        # The fork runs after the block in flight (64 steps): the source
        # outlives it.
        h = eng.submit(GenRequest(prompt_ids=list(range(40, 90)), max_new_tokens=200,
                                  ignore_eos=True))
        assert next(iter(h)).kind == "token"
        bhs = eng.fork(h, n=2, seeds=[7, 8])
        outs = _drain_all([h] + bhs)
        assert len(outs[0][0]) == 199  # the source's stream is whole
        for toks, final in outs[1:]:
            assert final.kind == "done", final.error
            assert 0 < len(toks) <= 199  # only tokens after the fork point
        if layout == "paged":
            assert eng.m_forks == 2
        else:
            assert eng.m_fork_clone_fallbacks == 2
    finally:
        eng.stop()


def test_midstream_fork_of_a_finished_stream_errors(engines):
    te = engines["paged"]
    h = te.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=4, ignore_eos=True))
    list(h)
    for toks, final in _drain_all(te.fork(h, n=2)):
        assert final.kind == "error" and "not an active stream" in final.error


def test_primary_cancelled_before_admission_requeues_live_branches(weights):
    eng = _mk(weights, **{**PAGED, "max_slots": 2})
    try:
        busy = eng.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=10_000,
                                     ignore_eos=True))
        busy2 = eng.submit(GenRequest(prompt_ids=[5, 6, 8], max_new_tokens=10_000,
                                      ignore_eos=True))
        handles = eng.submit_fork(_reqs(list(range(10, 60)), 3, max_new=8))
        handles[0].cancel()
        handles[2].cancel()
        busy.cancel()
        outs = _drain_all(handles)
        assert all(final is not None and final.kind == "done" for _t, final in outs)
        assert len(outs[1][0]) == 8 and outs[0][0] == outs[2][0] == []
        busy2.cancel()
        list(busy2)
    finally:
        eng.stop()


def test_submit_fork_refuses_mixed_prompts(engines):
    with pytest.raises(ValueError, match="identical prompts"):
        engines["paged"].submit_fork([GenRequest(prompt_ids=[1, 2]),
                                      GenRequest(prompt_ids=[1, 3])])
