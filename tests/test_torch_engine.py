"""The PyTorch port's serving engine: greedy parity with the JAX engine on
the same tiny f32 weights, and the engine's own request-lifecycle
invariants (stop sequences, backpressure, one event per token, a terminal
event on every exit path, seeded reproducibility). Every engine is
stopped, so the thread-leak guard in conftest.py holds."""

import dataclasses
import queue
import threading

import jax
import numpy as np
import pytest

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import (
    Engine,
    EngineConfig,
    GenRequest,
    QueueFullError,
    TokenEvent,
)
from localai_tpu_torch.engine.tokenizer import ByteTokenizer, SyntheticByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch

TIMEOUT = 120.0


def _drain(handle, timeout=TIMEOUT) -> list[TokenEvent]:
    """Every event of one stream, up to and including its terminal one."""
    events = []
    while True:
        ev = handle._q.get(timeout=timeout)
        events.append(ev)
        if ev.kind in ("done", "error"):
            return events


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


@pytest.fixture(scope="module")
def engine(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, SyntheticByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(max_slots=3, max_seq=64, min_prefill_bucket=16,
                                         block_sizes=(8, 2)))
    eng.start()
    yield eng
    eng.stop()


PROMPTS = [[3, 1, 4], list(range(40, 60)), [9] * 9, list(range(100, 140)), [7, 7, 2, 8, 1]]


def test_greedy_batch_matches_jax_engine(weights):
    """More requests than slots, prompts over three buckets: both engines
    emit the same greedy token ids for every request. max_seq 512 puts the
    decode blocks on the read-side KV window (256 rows) in both engines."""
    cfg, jp, tp = weights
    kw = dict(max_slots=2, max_seq=512, min_prefill_bucket=16, block_sizes=(8,))
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, **kw))
    teng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**kw),
                  device="cpu")
    try:
        jh = [jeng.submit(JaxGenRequest(prompt_ids=p, max_new_tokens=12, ignore_eos=True))
              for p in PROMPTS]
        th = [teng.submit(GenRequest(prompt_ids=p, max_new_tokens=12, ignore_eos=True))
              for p in PROMPTS]
        for a, b in zip(jh, th):
            ja, tb = _drain(a), _drain(b)
            jids = [e.token_id for e in ja if e.kind == "token"]
            tids = [e.token_id for e in tb if e.kind == "token"]
            assert tids == jids
            assert len(tids) == 12 and tb[-1].kind == "done"
            assert tb[-1].finish_reason == "length" and tb[-1].completion_tokens == 12
        assert teng.metrics()["admissions"] >= 3
    finally:
        jeng.stop()
        teng.stop()


def test_one_event_per_token_and_length_finish(engine):
    h = engine.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=11, ignore_eos=True))
    evs = _drain(h)
    toks = [e for e in evs if e.kind == "token"]
    done = evs[-1]
    assert done.kind == "done" and done.finish_reason == "length"
    assert len(toks) == done.completion_tokens == 11
    assert done.prompt_tokens == 3 and done.timing_prompt_processing >= 0


def test_stop_sequence_cuts_text(engine):
    prompt = [11, 12, 13, 14]
    full, _ = engine.generate(prompt, max_new_tokens=24, ignore_eos=True)
    stop = full[6:8]
    want = full[: full.find(stop)]
    h = engine.submit(GenRequest(prompt_ids=prompt, max_new_tokens=24, ignore_eos=True,
                                 stop=[stop]))
    evs = _drain(h)
    text = "".join(e.text for e in evs if e.kind == "token")
    assert text == want
    assert evs[-1].finish_reason == "stop"
    assert len([e for e in evs if e.kind == "token"]) == evs[-1].completion_tokens


def test_seeded_sampling_repeats_whatever_the_batch(engine):
    req = dict(prompt_ids=[21, 22, 23], max_new_tokens=16, temperature=0.9, top_p=0.9,
               seed=1234, ignore_eos=True)
    alone, _ = engine.generate(**req)
    # Same request again, this time sharing the batch with two others.
    others = [engine.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=16,
                                       temperature=0.7, seed=s, ignore_eos=True))
              for s in (1, 2)]
    again, _ = engine.submit(GenRequest(**req)).result()
    for h in others:
        _drain(h)
    assert again == alone
    other, _ = engine.generate(**{**req, "seed": 99})
    assert other != alone  # the seed matters


def test_cancel_posts_terminal_event(engine):
    h = engine.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=60, ignore_eos=True))
    first = h._q.get(timeout=TIMEOUT)
    assert first.kind == "token"
    h.cancel()
    evs = _drain(h)
    assert evs[-1].kind == "done" and evs[-1].finish_reason == "stop"
    assert evs[-1].completion_tokens < 60


def test_queue_full_and_stop_post_terminal_events(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(max_slots=1, max_seq=64, min_prefill_bucket=16,
                                         block_sizes=(2,), max_pending=1))
    handles = []
    try:
        with pytest.raises(QueueFullError) as exc:
            for _ in range(4):  # one slot + one pending place: the third submit sheds
                handles.append(eng.submit(GenRequest(prompt_ids=[1, 2, 3],
                                                     max_new_tokens=60, ignore_eos=True)))
        assert exc.value.limit == 1 and exc.value.retry_after_s >= 1.0
        assert eng.metrics()["queue_shed"] == 1.0
    finally:
        eng.stop()
    assert len(handles) >= 1
    for h in handles:  # the active one and the pending one both end
        assert _drain(h, timeout=10)[-1].kind == "done"


def test_loop_death_fails_requests_with_error_event(weights, monkeypatch):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(max_slots=1, max_seq=64, min_prefill_bucket=16))

    def boom():
        raise RuntimeError("injected")

    monkeypatch.setattr(eng, "_purge_pending", boom)
    try:
        h = eng.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=4))
        assert _drain(h)[-1].kind == "error"
        assert eng.is_dead and eng.metrics()["loop_dead"] == 1.0
        late = eng.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=4))
        assert _drain(late)[-1].error.startswith("engine loop died")
    finally:
        eng.stop()


def test_concurrent_submitters_all_finish(engine):
    results: "queue.Queue[tuple[int, TokenEvent]]" = queue.Queue()

    def run(i):
        h = engine.submit(GenRequest(prompt_ids=[30 + i] * (1 + 3 * i), max_new_tokens=5,
                                     temperature=0.5 if i % 2 else 0.0, seed=i,
                                     ignore_eos=True))
        results.put((i, _drain(h)[-1]))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finals = [results.get_nowait() for _ in range(7)]
    assert all(ev.kind == "done" and ev.completion_tokens == 5 for _, ev in finals)
