"""The PyTorch port's logprobs on the tiny f32 weights, against the JAX
engine and against itself. On every admission path (dense single-shot,
paged single-shot, paged chunks, dense chunks, a paged prefix hit, a dense
prefix hit taking the cached single-shot path and one taking chunks) the
port's greedy ids equal the JAX engine's, and every token's logprob and
top-5 (ids and values) equal the JAX engine's within 1e-4 (f32 on both
sides: summation order only). So do they under a grammar: the device DFA,
and the host walk, whose overridden tokens take their logprob from the
top list. The port's own invariants: logprobs equal log_softmax of a
teacher-forced prefill of prompt + ids; a logprob request beside plain ones
gives the ids it gives without logprobs (greedy and seeded), and the plain
ones theirs; warmup(logprobs=True) leaves the engine serving the same ids.
Every engine is stopped."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.functions import gbnf as jgbnf
from localai_tpu.functions import jsonschema as jjs
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.functions import gbnf as tgbnf
from localai_tpu_torch.functions import jsonschema as tjs
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl

from test_gbnf import ARITH
from test_grammar_dfa import SCHEMAS

TOL = 1e-4  # f32 on both sides
LAYOUTS = {
    "dense": dict(max_slots=4, max_seq=256),
    "dense_chunked": dict(max_slots=4, max_seq=256, prefill_chunk=32),
    "paged": dict(max_slots=4, max_seq=256, kv_pages=64, kv_page_size=16, prefill_chunk=32),
}


def _prompt(first, n):
    return [first] + [(first * 7 + j * 13) % 250 + 1 for j in range(n - 1)]


@pytest.fixture(scope="module")
def engines():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    out = {"cfg": cfg, "tp": tp}
    for name, kw in LAYOUTS.items():
        je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                       engine_cfg=JaxEngineConfig(prefix_admit_async_compile=False, **kw))
        te = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**kw),
                    device="cpu")
        for e in (je, te):
            e.start()
        out[name] = (je, te)
    yield out
    for name in LAYOUTS:
        for e in out[name]:
            e.stop()


def _run(eng, req):
    evs = list(eng.submit(req))
    assert evs[-1].kind == "done", evs[-1].error
    return [e for e in evs if e.kind == "token"]


def _hold(got, want, k=5):
    """The port's token events against the JAX engine's: ids, logprobs and
    top-k ids and values."""
    assert [e.token_id for e in got] == [e.token_id for e in want]
    for g, w in zip(got, want):
        assert (g.logprob is None) == (w.logprob is None)
        if w.logprob is not None:
            assert abs(g.logprob - w.logprob) <= TOL, (g.logprob, w.logprob)
        assert len(g.top_logprobs) == len(w.top_logprobs) == k
        assert [i for i, _v in g.top_logprobs] == [i for i, _v in w.top_logprobs]
        assert np.allclose([v for _i, v in g.top_logprobs], [v for _i, v in w.top_logprobs],
                           atol=TOL, rtol=0)


# (layout, prompt length, warm the prefix first, the port metric the path moves)
PATHS = {
    "dense": ("dense", 20, False, "admissions"),
    "paged": ("paged", 20, False, "admissions"),
    "paged_chunked": ("paged", 90, False, "chunked_admits"),
    "dense_chunked": ("dense_chunked", 90, False, "chunked_admits"),
    "paged_prefix_hit": ("paged", 70, True, "prefix_hits"),
    "dense_prefix_hit": ("dense", 70, True, "prefix_hits"),
    "dense_chunked_prefix_hit": ("dense_chunked", 120, True, "chunked_admits"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_logprobs_equal_the_jax_engines_on_every_admission_path(engines, path):
    layout, n, warm, metric = PATHS[path]
    je, te = engines[layout]
    prompt = _prompt(3 + list(PATHS).index(path), n)
    if warm:  # store the prompt's span (a 40-token head, then the whole)
        for e, G in ((je, JaxGenRequest), (te, GenRequest)):
            _run(e, G(prompt_ids=prompt[:40] if "chunked" in path else prompt,
                      max_new_tokens=2, ignore_eos=True))
    before = te.metrics()
    want = _run(je, JaxGenRequest(prompt_ids=prompt, max_new_tokens=6, ignore_eos=True,
                                  logprobs=5))
    got = _run(te, GenRequest(prompt_ids=prompt, max_new_tokens=6, ignore_eos=True,
                              logprobs=5))
    _hold(got, want)
    after = te.metrics()
    assert after[metric] > before[metric], (path, metric)
    if warm:
        assert after["prefix_hits"] > before["prefix_hits"]


@pytest.mark.parametrize("kind", ["dfa", "host_walk"])
def test_logprobs_under_a_grammar_equal_the_jax_engines(engines, kind):
    """A DFA slot's logprob is its sampled token's; a host-walk slot's
    emitted token takes its logprob from the top-20 list, or None."""
    je, te = engines["dense"]
    if kind == "dfa":
        for e in (je, te):
            assert e.prewarm_grammar(SCHEMAS[1])
        make = (lambda: jjs.GrammarConstraint(SCHEMAS[1]),
                lambda: tjs.GrammarConstraint(SCHEMAS[1]))
    else:
        make = (lambda: jgbnf.GbnfConstraint(jgbnf.CompiledGrammar(ARITH)),
                lambda: tgbnf.GbnfConstraint(tgbnf.CompiledGrammar(ARITH)))
    dfa0 = te.m_dfa_tokens
    want = _run(je, JaxGenRequest(prompt_ids=[10, 20, 30], max_new_tokens=24, logprobs=5,
                                  grammar=make[0]()))
    got = _run(te, GenRequest(prompt_ids=[10, 20, 30], max_new_tokens=24, logprobs=5,
                              grammar=make[1]()))
    _hold(got, want)
    assert (te.m_dfa_tokens > dfa0) == (kind == "dfa")
    if kind == "host_walk":
        # The walk overrode sampled tokens: their logprobs are the top
        # list's entries (or None past it).
        for e in got:
            tops = dict(e.top_logprobs)
            if e.token_id in tops:
                assert e.logprob == tops[e.token_id]


def test_logprobs_equal_a_teacher_forced_prefill(engines):
    """Each token's logprob and top-5 equal log_softmax of one plain
    prefill of the prompt and the ids before it."""
    _je, te = engines["paged"]
    cfg, tp = engines["cfg"], engines["tp"]
    prompt = _prompt(41, 25)
    got = _run(te, GenRequest(prompt_ids=prompt, max_new_tokens=8, ignore_eos=True,
                              logprobs=5, temperature=0.8, seed=3))
    seq = list(prompt)
    for e in got:
        logits = tl.prefill(cfg, tp, torch.tensor([seq]), torch.tensor([len(seq)]))[0][0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        assert abs(float(logp[e.token_id]) - e.logprob) <= TOL
        vals, ids = torch.topk(logp, 5)
        assert [i for i, _v in e.top_logprobs] == ids.tolist()
        assert np.allclose([v for _i, v in e.top_logprobs], vals.numpy(), atol=TOL, rtol=0)
        seq.append(e.token_id)


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_k=20, seed=8)],
                         ids=["greedy", "seeded"])
def test_logprob_requests_beside_plain_ones_keep_their_ids(engines, sampling):
    _je, te = engines["paged"]
    prompts = [_prompt(60 + i, 12 + 5 * i) for i in range(3)]

    def batch(lp):
        hs = [te.submit(GenRequest(prompt_ids=p, max_new_tokens=10, ignore_eos=True,
                                   logprobs=lp if i == 0 else 0, **sampling))
              for i, p in enumerate(prompts)]
        return [[e for e in h if e.kind == "token"] for h in hs]

    mixed, plain = batch(3), batch(0)
    assert [[e.token_id for e in r] for r in mixed] == [[e.token_id for e in r] for r in plain]
    assert all(e.logprob is not None and len(e.top_logprobs) == 3 for e in mixed[0])
    assert all(e.logprob is None and e.top_logprobs is None for r in mixed[1:] for e in r)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warmup_with_logprobs_serves_the_same_ids(engines, layout):
    _je, te = engines[layout]
    cfg, tp = engines["cfg"], engines["tp"]
    req = dict(prompt_ids=_prompt(90, 30), max_new_tokens=6, ignore_eos=True, logprobs=2)
    want = _run(te, GenRequest(**req))
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size),
                 engine_cfg=EngineConfig(**{**LAYOUTS[layout], "block_sizes": (4, 1)}),
                 device="cpu")
    try:
        eng.warmup(logprobs=True)
        assert not eng.counts.any() and not eng.h_active.any()
        got = _run(eng, GenRequest(**req))
    finally:
        eng.stop()
    assert [e.token_id for e in got] == [e.token_id for e in want]
    for g, w in zip(got, want):
        assert [i for i, _v in g.top_logprobs] == [i for i, _v in w.top_logprobs]
        assert abs(g.logprob - w.logprob) <= TOL
