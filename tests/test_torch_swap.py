"""The PyTorch port's host swap tier on the tiny f32 weights: on a pool too
small for its slots, swap preemption (kv_preempt = swap and auto) ends every
preempted request with the ids of an unpressured run, greedy and seeded,
and moves exactly its pages' bytes out and back in; kv_swap_bytes = 0 and
spans over a quarter of the budget recompute; a windowed slot with spilled
cold pages swaps out with their images spliced in and resumes exactly; the
restore of spilled pages before a prefix save gives the same later hit as
an engine that never spilled; a cancelled swap resume gives its host bytes
back; and the model manager hands the YAML knobs to the engine. Every
engine is stopped."""

import dataclasses
import logging
import time

import jax
import numpy as np
import pytest
import yaml

from localai_tpu.models import llama as jl
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.server import ModelManager

from test_torch_prefix_cache import _check_refs, _stop_idle

PA = [(j * 7) % 250 + 1 for j in range(40)]
PB = [(j * 3) % 250 + 1 for j in range(41)]
SEEDED = dict(temperature=0.9, top_p=0.9, top_k=40, repeat_penalty=1.1, presence_penalty=0.3,
              frequency_penalty=0.2, seed=1234)


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


# One page of tiny's f32 K and V over its 2 layers: 16 rows x 2 heads x 16.
PAGE_BYTES = 2 * 2 * 16 * 2 * 16 * 4


def _engine(tp, cfg, **kw):
    # The prefix cache is off unless a test turns it on, so the swap tier's
    # byte counts are the preemptions' alone.
    ecfg = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,),
                kv_page_size=16, prefix_cache_entries=0)
    ecfg.update(kw)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**ecfg),
                 device="cpu")
    eng.start()
    return eng


def _ids(handle):
    evs = list(handle)
    assert evs[-1].kind == "done", evs[-1]
    assert sum(e.kind in ("done", "error") for e in evs) == 1
    return [e.token_id for e in evs if e.kind == "token"]


def _pressured(eng, second: dict):
    """Two requests that each need 9 of the pool's 12 pages: the younger,
    `second`, is preempted when growth collides."""
    ha = eng.submit(GenRequest(prompt_ids=PA, max_new_tokens=100, ignore_eos=True))
    time.sleep(0.05)  # a strictly older than b: b is the victim
    hb = eng.submit(GenRequest(prompt_ids=PB, max_new_tokens=100, ignore_eos=True, **second))
    return _ids(ha), _ids(hb)


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
@pytest.mark.parametrize("policy", ["swap", "auto"])
def test_swap_preemption_matches_unpressured_runs(weights, policy, sampling):
    cfg, tp = weights
    second = SEEDED if sampling == "seeded" else {}
    ample = _engine(tp, cfg, kv_pages=40)
    try:
        want = _pressured(ample, second)
    finally:
        ample.stop()
    eng = _engine(tp, cfg, kv_pages=12, kv_preempt=policy)
    try:
        got = _pressured(eng, second)
        m = eng.metrics()
        assert m["kv_preempt_swaps"] > 0 and m["kv_preempt_recomputes"] == 0
        assert m["kv_preemptions"] == m["kv_preempt_swaps"]
        assert got == want
        # Every image came back; the host tier holds nothing at the end.
        assert m["kv_swap_bytes_in"] == m["kv_swap_bytes_out"] > 0
        assert m["kv_host_tier_bytes"] == 0
        _stop_idle(eng)
        _check_refs(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("kw", [
    dict(kv_preempt="swap", kv_swap_bytes=0),
    # Under four times the smallest span a victim can have (its 3 prompt pages).
    dict(kv_preempt="auto", kv_swap_bytes=4 * 3 * PAGE_BYTES - 1),
    dict(kv_preempt="recompute"),
], ids=["no-budget", "span-over-a-quarter", "recompute"])
def test_preemption_recomputes_when_it_cannot_swap(weights, kw):
    """With no host budget, with a span over a quarter of it under auto, and
    under recompute, the victim recomputes, with the same ids."""
    cfg, tp = weights
    ample = _engine(tp, cfg, kv_pages=40)
    try:
        want = _pressured(ample, {})
    finally:
        ample.stop()
    eng = _engine(tp, cfg, kv_pages=12, **kw)
    try:
        got = _pressured(eng, {})
        m = eng.metrics()
        assert m["kv_preempt_recomputes"] > 0 and m["kv_preempt_swaps"] == 0
        assert m["kv_swap_bytes_out"] == 0
        assert got == want
    finally:
        eng.stop()


WINDOWED = dict(max_seq=1024, kv_page_size=64, attention_sink=64, attention_window=128,
                prefill_chunk=64, kv_l1_span=4)


def test_windowed_spilled_slot_swaps_with_its_images_spliced(weights):
    """A long windowed decode is preempted (its block's growth refused once,
    as a full pool would) while it has spilled cold pages: its swap image
    carries their bytes, spliced from the host images (not restored to
    the pool first), the swap-in restores every page, and the request ends
    with the ids it gets unpreempted."""
    cfg, tp = weights
    kw = dict(WINDOWED, kv_pages=24, kv_spill_bytes=64 << 20, kv_preempt="swap")
    prompt = [(j * 7) % 255 + 1 for j in range(400)]
    ref = _engine(tp, cfg, **kw)
    try:
        want = _ids(ref.submit(GenRequest(prompt_ids=prompt, max_new_tokens=200,
                                          ignore_eos=True)))
    finally:
        ref.stop()
    eng = _engine(tp, cfg, **kw)
    spliced = []
    swap_out, grow = eng._swap_out_slot_span, eng._grow_for_decode

    def spy_swap_out(slot_idx, n_live):
        images = {c: img for c, img in eng._slot_spill[slot_idx].items() if c < n_live}
        hk, hv = swap_out(slot_idx, n_live)
        for c, (ik, iv) in images.items():
            assert bytes(hk[:, c].numpy()) == bytes(ik[:, 0].numpy())
            assert bytes(hv[:, c].numpy()) == bytes(iv[:, 0].numpy())
        spliced.append(len(images))
        return hk, hv

    def refuse_once(steps):
        if not spliced and sum(len(d) for d in eng._slot_spill) >= 2:
            return False  # the loop preempts the youngest slot
        return grow(steps)

    eng._swap_out_slot_span, eng._grow_for_decode = spy_swap_out, refuse_once
    try:
        got = _ids(eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=200,
                                         ignore_eos=True)))
        assert spliced and spliced[0] >= 2
        m = eng.metrics()
        assert m["kv_preempt_swaps"] == 1 and m["kv_swap_bytes_in"] == m["kv_swap_bytes_out"]
        assert got == want
        _stop_idle(eng)
        _check_refs(eng)
        assert eng._spill_bytes == 0
    finally:
        eng.stop()


def test_restore_spilled_before_a_save_gives_the_same_hit(weights):
    """A finished windowed slot with spilled cold pages gets them back into
    fresh pages before its span is saved; a second request that extends the
    conversation hits that span and gives the ids (and hits) of an engine
    that never spilled."""
    cfg, tp = weights
    prompt = [(j * 13) % 255 + 1 for j in range(500)]
    outs, metrics = [], []
    for spill in (0, 64 << 20):
        eng = _engine(tp, cfg, kv_pages=24, kv_spill_bytes=spill, prefix_cache_entries=8,
                      **WINDOWED)
        try:
            a = _ids(eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=40,
                                           ignore_eos=True)))
            b = _ids(eng.submit(GenRequest(prompt_ids=prompt + a + [7, 8, 9],
                                           max_new_tokens=20, ignore_eos=True)))
            outs.append((a, b))
            metrics.append(eng.metrics())
            _stop_idle(eng)
            _check_refs(eng)
        finally:
            eng.stop()
    hot, spilled = metrics
    assert spilled["kv_pages_spilled"] > 0 and spilled["kv_pages_restored"] > 0
    assert hot["kv_pages_restored"] == 0
    assert outs[0] == outs[1]
    assert hot["prefix_hits"] == spilled["prefix_hits"] == 1
    assert hot["prefix_tokens"] == spilled["prefix_tokens"] > 0


def test_cancelled_swap_resume_gives_its_bytes_back(weights):
    """A swap-preempted request cancelled while it waits at the queue head
    ends with one terminal event, and the host tier's bytes return."""
    cfg, tp = weights
    eng = _engine(tp, cfg, kv_pages=12, kv_preempt="swap")
    try:
        ha = eng.submit(GenRequest(prompt_ids=PA, max_new_tokens=100, ignore_eos=True))
        time.sleep(0.05)
        hb = eng.submit(GenRequest(prompt_ids=PB, max_new_tokens=100, ignore_eos=True))
        deadline = time.monotonic() + 60
        while eng.m_kv_preempt_swaps == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        hb.cancel()
        evs = list(hb)
        assert evs[-1].kind == "done" and sum(e.kind == "done" for e in evs) == 1
        _ids(ha)
        _stop_idle(eng)
        assert eng._host_bytes == 0 and eng.m_kv_preempt_swaps > 0
        _check_refs(eng)
    finally:
        eng.stop()


def test_manager_passes_the_swap_knobs(tmp_path, caplog):
    """kv_preempt and kv_swap_bytes in a model's YAML reach its EngineConfig;
    the prefix cache is on with its defaults; prefix_admit_async_compile is
    reported as ignored."""
    doc = {"name": "swap", "model": "tiny", "context_size": 256, "max_slots": 2,
           "kv_pages": 16, "kv_page_size": 16, "kv_preempt": "swap", "kv_swap_bytes": 1 << 20,
           "prefix_admit_async_compile": False}
    (tmp_path / "swap.yaml").write_text(yaml.safe_dump(doc))
    mm = ModelManager(ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path)),
                      device="cpu")
    try:
        with caplog.at_level(logging.WARNING):
            eng = mm.get("swap").engine
        e = eng.ecfg
        assert (e.kv_preempt, e.kv_swap_bytes) == ("swap", 1 << 20)
        assert (e.prefix_cache_entries, e.prefix_cache_min, e.prefix_cache_bytes) == (
            8, 32, 1 << 30)
        assert "prefix_admit_async_compile ignored" in caplog.text
        _, ev = eng.generate(PA, max_new_tokens=4, ignore_eos=True)
        assert ev.kind == "done"
    finally:
        mm.shutdown()
