"""The PyTorch port's grammar-constrained decoding on the tiny f32 weights,
against the JAX engine and against itself. Greedy constrained ids equal the
JAX engine's exactly, on the port's dense and paged engines, for the device
DFA in "fast" mode (a small schema), in "walk" mode (the tool schema, ~678
states), for a GBNF grammar's DFA, and for the host candidate walk (the
first request of a schema never prewarmed, which both engines build off
their loops, and a recursive GBNF grammar, which has no DFA). The port's
own invariants: seeded constrained bytes are the same on the dense, paged
and chunked engines; a prefix hit gives the ids of a miss under a grammar;
a DFA slot preempted by recompute on a pool too small for its slots (every
live slot constrained, so a grammar slot is the victim) resumes through the
host walk with its machine replayed and ends with the ids of an ample pool;
an unconstrained slot beside DFA slots gives the ids it gives alone. Every
constrained output is a legal prefix of its grammar. Every engine is
stopped."""

import dataclasses
import time

import jax
import numpy as np
import pytest

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

from test_gbnf import ARITH, CHESS
from test_grammar_dfa import SCHEMAS, TOOL_SCHEMA

PROMPT = [10, 20, 30]
SEEDED = dict(temperature=0.8, top_p=0.9, seed=11)
# Schemas no other test compiles: their first request host-walks on both
# engines, one per port layout (a port engine's build caches it for all).
HOST_SCHEMA = {layout: {"type": "object", "properties": {f"{layout}_n": {"type": "integer"},
                                                         "ok": {"type": "boolean"}},
                        "required": [f"{layout}_n", "ok"]}
               for layout in ("dense", "paged")}


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _prewarm(eng):
    """Compile (or re-pin) the DFA schemas: an engine's stop() unpins every
    table of its tokenizer, which the engines here share."""
    for schema in (SCHEMAS[1], TOOL_SCHEMA, {"__gbnf__": CHESS}):
        assert eng.prewarm_grammar(schema)


def _port(cfg, tp, **kw):
    ecfg = dict(max_slots=4, max_seq=256)
    ecfg.update(kw)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**ecfg),
                 device="cpu")
    _prewarm(eng)
    assert not eng.prewarm_grammar({"__gbnf__": ARITH})
    eng.start()
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    cfg, jp, tp = weights
    je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                   engine_cfg=JaxEngineConfig(max_slots=4, max_seq=256,
                                              prefix_admit_async_compile=False))
    je.start()
    for schema in (SCHEMAS[1], TOOL_SCHEMA, {"__gbnf__": CHESS}):
        assert je.prewarm_grammar(schema)
    engs = {"jax": je, "dense": _port(cfg, tp),
            "paged": _port(cfg, tp, kv_pages=64, kv_page_size=16)}
    yield engs
    for e in engs.values():
        e.stop()


def _grammar(kind, jax_side, layout="dense"):
    js, gb = (jjs, jgbnf) if jax_side else (tjs, tgbnf)
    if kind == "fast":
        return js.GrammarConstraint(SCHEMAS[1])
    if kind == "walk":
        return js.GrammarConstraint(TOOL_SCHEMA)
    if kind == "host_schema":
        return js.GrammarConstraint(HOST_SCHEMA[layout])
    return gb.GbnfConstraint(gb.CompiledGrammar(CHESS if kind == "gbnf" else ARITH))


def _legal_prefix(kind, text, layout="dense"):
    g = _grammar(kind, False, layout)
    return all(g.advance(ch) for ch in text)


def _run(eng, req):
    evs = list(eng.submit(req))
    assert evs[-1].kind == "done", evs[-1]
    return [e.token_id for e in evs if e.kind == "token"], "".join(e.text for e in evs), evs[-1]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["fast", "walk", "gbnf", "host_schema", "host_gbnf"])
def test_greedy_constrained_ids_equal_the_jax_engine(engines, kind, layout):
    je, te = engines["jax"], engines[layout]
    dfa = not kind.startswith("host")
    before = (je.m_dfa_tokens, te.m_dfa_tokens)
    want = _run(je, JaxGenRequest(prompt_ids=PROMPT, max_new_tokens=48,
                                  grammar=_grammar(kind, True, layout)))
    got = _run(te, GenRequest(prompt_ids=PROMPT, max_new_tokens=48,
                              grammar=_grammar(kind, False, layout)))
    assert got[0] == want[0] and got[2].finish_reason == want[2].finish_reason
    assert (je.m_dfa_tokens > before[0]) == (te.m_dfa_tokens > before[1]) == dfa
    assert _legal_prefix(kind, got[1], layout), got[1]
    if kind == "host_schema":
        # The first request built the tables off the loop: the next one
        # rides the DFA, on both engines, with the same ids again.
        deadline = time.monotonic() + 30
        while te._dfa_building and time.monotonic() < deadline:
            time.sleep(0.02)
        while je._dfa_building and time.monotonic() < deadline:
            time.sleep(0.02)
        mid = (je.m_dfa_tokens, te.m_dfa_tokens)
        w2 = _run(je, JaxGenRequest(prompt_ids=PROMPT, max_new_tokens=48,
                                    grammar=_grammar(kind, True, layout)))
        g2 = _run(te, GenRequest(prompt_ids=PROMPT, max_new_tokens=48,
                                 grammar=_grammar(kind, False, layout)))
        assert g2[0] == w2[0] and je.m_dfa_tokens > mid[0] and te.m_dfa_tokens > mid[1]


def test_seeded_constrained_bytes_equal_on_dense_paged_and_chunked(weights, engines):
    cfg, _jp, tp = weights
    chunked = _port(cfg, tp, kv_pages=64, kv_page_size=16, prefill_chunk=32)
    try:
        prompt = [(j * 11) % 250 + 1 for j in range(75)]  # three chunks
        outs = {}
        for name, eng in (("dense", engines["dense"]), ("paged", engines["paged"]),
                          ("chunked", chunked)):
            for kind in ("fast", "walk"):
                before = eng.m_dfa_tokens
                outs[name, kind] = _run(eng, GenRequest(prompt_ids=prompt, max_new_tokens=40,
                                                        grammar=_grammar(kind, False),
                                                        **SEEDED))[1]
                assert eng.m_dfa_tokens > before
                assert _legal_prefix(kind, outs[name, kind]), outs[name, kind]
        assert chunked.m_chunked_admits == 2
        for kind in ("fast", "walk"):
            assert outs["dense", kind] == outs["paged", kind] == outs["chunked", kind]
    finally:
        chunked.stop()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefix_hit_gives_the_ids_of_a_miss_under_a_grammar(engines, layout):
    eng = engines[layout]
    _prewarm(eng)
    prompt = [(j * 13 + (layout == "paged")) % 250 + 1 for j in range(70)]
    hits, dfa0 = eng.m_prefix_hits, eng.m_dfa_tokens
    miss = _run(eng, GenRequest(prompt_ids=prompt, max_new_tokens=48,
                                grammar=_grammar("fast", False)))
    assert eng.m_prefix_hits == hits
    dfa1 = eng.m_dfa_tokens
    hit = _run(eng, GenRequest(prompt_ids=prompt, max_new_tokens=48,
                               grammar=_grammar("fast", False)))
    assert eng.m_prefix_hits == hits + 1
    assert eng.m_dfa_tokens - dfa1 == dfa1 - dfa0 > 0  # both on the DFA
    assert hit[0] == miss[0] and _legal_prefix("fast", hit[1]), hit[1]


PRINTABLE = r'root ::= [ -~]+'  # never strictly complete: slots run to their budget


def test_preempted_dfa_slot_resumes_through_the_host_walk(weights):
    """Two slots under one DFA grammar on a pool that covers one: the
    younger is preempted (recompute), its machine is replayed over its
    generated tokens, and it resumes host-walking to the ids it has on an
    ample pool."""
    cfg, _jp, tp = weights
    pa = [(j * 7) % 250 + 1 for j in range(40)]
    pb = [(j * 3) % 250 + 1 for j in range(41)]
    runs = {}
    for pool in ("ample", "tight"):
        eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                     engine_cfg=EngineConfig(max_slots=2, max_seq=256, min_prefill_bucket=16,
                                             block_sizes=(8,), kv_page_size=16,
                                             kv_pages=40 if pool == "ample" else 12,
                                             prefix_cache_entries=0))
        assert eng.prewarm_grammar({"__gbnf__": PRINTABLE})
        eng.start()
        try:
            resumed = []
            choose = eng._grammar_choose

            def spy(request, sampled, cands, choose=choose, resumed=resumed):
                resumed.append(request.prompt_ids[-1])
                return choose(request, sampled, cands)

            eng._grammar_choose = spy
            ha = eng.submit(GenRequest(prompt_ids=pa, max_new_tokens=100,
                                       grammar=tgbnf.GbnfConstraint(PRINTABLE)))
            time.sleep(0.05)  # a strictly older than b: b is the victim
            hb = eng.submit(GenRequest(prompt_ids=pb, max_new_tokens=100,
                                       grammar=tgbnf.GbnfConstraint(PRINTABLE)))
            runs[pool] = (_run_handle(ha), _run_handle(hb), eng.metrics(), len(resumed))
        finally:
            eng.stop()
    (a0, b0, m0, walked0), (a1, b1, m1, walked1) = runs["ample"], runs["tight"]
    assert m0["kv_preemptions"] == 0 and walked0 == 0
    assert m1["kv_preempt_recomputes"] > 0 and m1["kv_preempt_swaps"] == 0
    assert walked1 > 0  # the resume host-walked
    assert a1 == a0 and b1 == b0
    for text in (a1[1], b1[1]):
        g = tgbnf.GbnfConstraint(PRINTABLE)
        assert len(text) == 100 and g.advance(text)


def _run_handle(h):
    evs = list(h)
    assert evs[-1].kind == "done", evs[-1]
    return [e.token_id for e in evs if e.kind == "token"], "".join(e.text for e in evs)


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_unconstrained_slot_beside_dfa_slots_gives_its_ids_alone(engines, sampling):
    eng = engines["paged"]
    _prewarm(eng)
    kw = dict(SEEDED, seed=5) if sampling == "seeded" else {}
    plain = GenRequest(prompt_ids=[1, 2, 3, 4], max_new_tokens=40, ignore_eos=True, **kw)
    alone = _run(eng, dataclasses.replace(plain))[0]
    before = eng.m_dfa_tokens
    hs = [eng.submit(GenRequest(prompt_ids=[5 + i, 9], max_new_tokens=40,
                                grammar=_grammar(kind, False), **SEEDED))
          for i, kind in enumerate(("fast", "fast"))]
    h = eng.submit(dataclasses.replace(plain))
    beside = _run_handle(h)[0]
    texts = [_run_handle(x)[1] for x in hs]
    assert beside == alone and eng.m_dfa_tokens > before
    assert all(_legal_prefix("fast", t) for t in texts), texts


def test_engine_state_is_clean_after_grammar_traffic(engines):
    for layout in ("dense", "paged"):
        eng = engines[layout]
        deadline = time.monotonic() + 10
        while eng.h_active.any() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.h_gmask.any() and not eng.h_active.any()
        assert eng.metrics()["grammar_dfa_tokens"] > 0
