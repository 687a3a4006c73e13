"""The PyTorch port's bounded admission and main-path completeness on the
tiny f32 weights, against the JAX engine (the JAX package's
tests/test_robustness.py cases at :156-290) and against itself: on a
saturated engine a queue timeout and a pending deadline shed the request
with the JAX engine's error text, an active deadline cancels its slot (its
pages back in the pool), the engine default covers requests with none,
cancelling a pending request ends its stream, an expired fork primary
fails its whole group, and `cancel_all` ends every request with a live
loop and without one. Chunked prefill over a dense cache gives the JAX
dense chunked engine's ids and the port's own single-shot ids, greedy and
seeded, with a request decoding beside the chunks. Every engine is
stopped."""

import dataclasses
import re
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
from localai_tpu_torch.models import get_arch

# One-step blocks and a long context: a blocker holds the one slot for
# seconds, whatever the load.
ONE_SLOT = dict(max_slots=1, max_seq=4096, min_prefill_bucket=16, block_sizes=(1,))


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _port(weights, start=True, **kw):
    cfg, _jp, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**kw),
                 device="cpu")
    if start:
        eng.start()
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    """One-slot engines whose bounded-admission knobs each test sets."""
    cfg, jp, _tp = weights
    je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                   engine_cfg=JaxEngineConfig(prefix_admit_async_compile=False, **ONE_SLOT))
    je.start()
    out = {"jax": (je, JaxGenRequest), "port": (_port(weights, **ONE_SLOT), GenRequest)}
    yield out
    for e, _g in out.values():
        e.stop()


def _drain(h):
    return list(h)


def _set(eng, **kw):
    eng.ecfg = dataclasses.replace(eng.ecfg, **kw)


def _blocked(eng, G, **kw):
    """A request holding the engine's one slot (its first token out), and
    a victim queued behind it."""
    blocker = eng.submit(G(prompt_ids=[1, 2, 3], max_new_tokens=100_000, ignore_eos=True))
    assert next(iter(blocker)).kind == "token"
    return blocker, eng.submit(G(prompt_ids=[5, 5], max_new_tokens=4, **kw))


@pytest.mark.parametrize("why", ["queue_timeout", "deadline"])
def test_pending_requests_are_shed_with_the_jax_engines_error(engines, why):
    texts = {}
    for side, (eng, G) in engines.items():
        m0 = eng.metrics()
        if why == "queue_timeout":
            _set(eng, queue_timeout_s=0.3)
            blocker, victim = _blocked(eng, G)
        else:
            blocker, victim = _blocked(eng, G, deadline_s=0.3)
        t0 = time.monotonic()
        evs = _drain(victim)
        waited = time.monotonic() - t0
        _set(eng, queue_timeout_s=0.0)
        blocker.cancel()
        _drain(blocker)
        assert evs[-1].kind == "error" and len(evs) == 1
        key = "queue_timeouts" if why == "queue_timeout" else "deadline_expired"
        assert eng.metrics()[key] == m0[key] + 1
        assert waited < 2.0  # the loop woke for it
        texts[side] = re.sub(r"after \d+\.\ds", "after Ns", evs[-1].error)
    assert texts["port"] == texts["jax"]
    assert f"({why}_s)" in texts["port"]


def test_active_deadline_cancels_the_slot_and_returns_its_pages(weights):
    eng = _port(weights, max_slots=2, max_seq=2048, kv_pages=128, kv_page_size=16,
                prefix_cache_entries=0, block_sizes=(1,))
    try:
        h = eng.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=100_000,
                                  ignore_eos=True, deadline_s=0.5))
        evs = _drain(h)
        assert evs[-1].kind == "done" and evs[-1].finish_reason == "stop"
        assert evs[-1].completion_tokens < 2000
        assert eng.metrics()["deadline_expired"] == 1
        _, ev = eng.generate([9, 9], max_new_tokens=2, ignore_eos=True)
        assert ev.kind == "done"
        time.sleep(0.05)
        assert len(eng._free_pages) == 128
    finally:
        eng.stop()


def test_engine_default_deadline_covers_requests_with_none(engines):
    for eng, G in engines.values():
        _set(eng, deadline_s=0.4)
        blocker, victim = _blocked(eng, G)
        evs = _drain(victim)
        # Shed, or admitted once the blocker (submitted first) expired.
        assert evs[-1].kind == "done" or "deadline" in evs[-1].error
        evs = _drain(blocker)  # the blocker carries the default too
        assert evs[-1].kind == "done" and evs[-1].finish_reason == "stop"
        _set(eng, deadline_s=0.0)


def test_cancel_while_pending_ends_the_stream(engines):
    eng, G = engines["port"]
    blocker, victim = _blocked(eng, G)
    victim.cancel()
    t0 = time.monotonic()
    evs = _drain(victim)
    assert evs[-1].kind == "done" and time.monotonic() - t0 < 2.0
    blocker.cancel()
    _drain(blocker)


def test_expired_fork_primary_fails_its_group(weights):
    eng = _port(weights, max_slots=1, max_seq=2048, kv_pages=136, kv_page_size=16,
                block_sizes=(1,))
    try:
        blocker = eng.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=100_000,
                                        ignore_eos=True))
        assert next(iter(blocker)).kind == "token"
        hs = eng.submit_fork([GenRequest(prompt_ids=list(range(10, 40)), max_new_tokens=4,
                                         deadline_s=0.3) for _ in range(3)])
        for h in hs:
            evs = _drain(h)
            assert evs[-1].kind == "error" and "(deadline_s)" in evs[-1].error
        blocker.cancel()
        _drain(blocker)
    finally:
        eng.stop()


@pytest.mark.parametrize("loop", [True, False], ids=["live-loop", "no-loop"])
def test_cancel_all_ends_every_request(weights, engines, loop):
    if loop:
        eng, G = engines["port"]
        handles = [eng.submit(G(prompt_ids=[1, 2, 3], max_new_tokens=100_000,
                                ignore_eos=True)) for _ in range(3)]
        assert next(iter(handles[0])).kind == "token"
        assert eng.cancel_all() == 3
    else:
        eng = _port(weights, **ONE_SLOT)
        eng.stop()  # a submit now finds no live loop
        handles = [eng.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=4))
                   for _ in range(2)]
        eng._thread.join(timeout=10)
        assert eng.cancel_all() == 2
    for h in handles:
        evs = _drain(h)
        assert evs[-1].kind == "done"


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_p=0.9, seed=4)],
                         ids=["greedy", "seeded"])
def test_dense_chunked_prefill_gives_the_single_shot_and_jax_ids(weights, sampling):
    """A 200-token prompt in 32-token chunks over a dense cache, a short
    request decoding beside it (its idle writes must miss the chunks'
    rows): the ids of the single-shot admission, and greedy, of the JAX
    dense chunked engine."""
    cfg, jp, _tp = weights
    kw = dict(max_slots=4, max_seq=256)
    prompt = [(j * 17) % 250 + 1 for j in range(200)]
    short = [7, 8, 9, 10]
    runs = {}
    for label, chunk in (("chunked", 32), ("single", 0)):
        eng = _port(weights, prefill_chunk=chunk, **kw)
        try:
            hs = [eng.submit(GenRequest(prompt_ids=short, max_new_tokens=40, ignore_eos=True)),
                  eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=12, ignore_eos=True,
                                        **sampling))]
            runs[label] = [[e.token_id for e in _drain(h) if e.kind == "token"] for h in hs]
            assert eng.metrics()["chunked_admits"] == (1 if chunk else 0)
        finally:
            eng.stop()
    assert runs["chunked"] == runs["single"]
    if not sampling:
        je = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                       engine_cfg=JaxEngineConfig(prefill_chunk=32,
                                                  prefix_admit_async_compile=False, **kw))
        try:
            je.start()
            want = [e.token_id for e in je.submit(JaxGenRequest(
                prompt_ids=prompt, max_new_tokens=12, ignore_eos=True)) if e.kind == "token"]
        finally:
            je.stop()
        assert runs["chunked"][1] == want
