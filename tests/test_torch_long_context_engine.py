"""The port's long-context engine on the tiny f32 weights: sink + window
decode on the dense cache and on the paged pool, hierarchical page tables
and cold-page spill give the same greedy ids as each other and as the JAX
engine; the knobs' validation; the hierarchical allocator under a seeded
random walk; the table-page pool growing under a block's graph key; and
the YAML knobs reaching the engine through the model manager. Every engine
is stopped."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import yaml

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.server import ModelManager

PAGE = 64
# The reference's windowed engines (tests/test_paged_kv.py), cut to a
# 1024-row context: sink one page, a window of 4 pages, chunks of 2 pages.
WINDOW = dict(attention_sink=64, attention_window=256)
LONG = [(j * 13) % 255 + 1 for j in range(900)]
SHORT = [(j * 7) % 255 + 1 for j in range(200)]


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _windowed(cfg, tp, paged=True, start=True, **kw):
    ecfg = dict(max_slots=2, max_seq=1024, min_prefill_bucket=16, block_sizes=(8,),
                kv_page_size=PAGE, **WINDOW)
    if paged:
        ecfg.update(kv_pages=24, prefill_chunk=128)
    ecfg.update(kw)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**ecfg),
                 device="cpu")
    if start:
        eng.start()
    return eng


def _ids(eng, prompt, n, Req=GenRequest):
    evs = list(eng.submit(Req(prompt_ids=prompt, max_new_tokens=n, ignore_eos=True)))
    assert evs[-1].kind == "done", evs[-1]
    return [e.token_id for e in evs if e.kind == "token"]


def _settle(eng, timeout=30.0):
    """Wait until nothing is pending or active, then stop the engine: the
    join of its loop thread leaves no teardown half done."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with eng._pending_lock:
            idle = not eng._pending
        if idle and not eng.h_active.any() and not eng._chunkings:
            eng.stop()
            return
        time.sleep(0.02)
    raise AssertionError("engine did not quiesce")


def _check_pool_invariants(eng, held_tps=()):
    """Refcounts equal the references held (slot tables, spilled columns
    holding none), free lists are duplicate-free and disjoint from held
    pages, nothing leaks; hierarchical: table-page refcounts equal their
    holders (directories and `held_tps`, the references a test keeps), each
    directory maps exactly its slot's pages (SCRATCH where spilled) and
    points past them at the SCRATCH table page; the spill bytes equal the
    images kept."""
    P = eng.ecfg.kv_pages
    refs = np.zeros(P, np.int64)
    for pages in eng._slot_pages:
        for p in pages:
            assert p != eng._scratch_page
            if p >= 0:  # the spilled sentinel owns no device page
                refs[p] += 1
    assert (refs == eng._page_refs[:P]).all(), (refs.tolist(), eng._page_refs.tolist())
    free = eng._free_pages
    assert len(set(free)) == len(free) and eng._scratch_page not in free
    assert all(refs[p] == 0 for p in free)
    assert set(free) | {p for p in range(P) if refs[p]} == set(range(P)), "leaked pages"
    assert eng._spill_bytes == sum(len(d) for d in eng._slot_spill) * eng._page_bytes()
    for i, pages in enumerate(eng._slot_pages):
        assert set(eng._slot_spill[i]) == {c for c, p in enumerate(pages) if p < 0}
    if not eng._hier:
        for i, pages in enumerate(eng._slot_pages):
            assert set(eng.h_ptable[i].tolist()) <= set(pages) | {eng._scratch_page}
        return
    span = eng._l1_span
    trefs = np.zeros(len(eng._tp_refs), np.int64)
    for tps in list(eng._slot_tps) + [list(held_tps)]:
        for tp in tps:
            trefs[tp] += 1
    assert (trefs[1:] == eng._tp_refs[1:]).all(), (trefs.tolist(), eng._tp_refs.tolist())
    tfree = eng._tp_free
    assert len(set(tfree)) == len(tfree) and eng._scratch_tp not in tfree
    assert all(trefs[tp] == 0 for tp in tfree)
    assert set(tfree) | {tp for tp in range(1, len(trefs)) if trefs[tp]} == set(
        range(1, len(trefs))), "leaked table pages"
    assert (eng.h_l0[eng._scratch_tp] == eng._scratch_page).all()
    chunking = {st["slot"] for st in eng._chunkings}
    for i, tps in enumerate(eng._slot_tps):
        pages = eng._slot_pages[i]
        assert len(tps) == -(-len(pages) // span)
        row = eng.h_l1[i]
        if i not in chunking:  # a chunking slot's directory rides its saved row
            assert row[:len(tps)].tolist() == tps
        assert (row[len(tps):] == eng._scratch_tp).all()
        for c, p in enumerate(pages):
            want = eng._scratch_page if p < 0 else p
            assert eng.h_l0[tps[c // span], c % span] == want, (i, c)
        for c in range(len(pages), len(tps) * span):
            assert eng.h_l0[tps[c // span], c % span] == eng._scratch_page


def test_windowed_dense_hot_and_hier_spilled_engines_agree_with_jax(weights):
    """Greedy decode under attention_sink + attention_window: at a length
    every window covers, the dense, the paged all-hot (flat) and the paged
    hierarchical + spill engines give the same ids; on a long prompt the
    spilled slot gives the all-hot slot's ids, spill engages and stays in
    its budget, and the port's windowed paged engine gives the JAX
    engine's ids on the same weights."""
    cfg, jp, tp = weights
    dense = _windowed(cfg, tp, paged=False)
    hot = _windowed(cfg, tp)
    spl = _windowed(cfg, tp, kv_l1_span=4, kv_spill_bytes=64 << 20)
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), engine_cfg=JaxEngineConfig(
        max_slots=2, max_seq=1024, min_prefill_bucket=16, block_sizes=(8,), kv_page_size=PAGE,
        kv_pages=24, prefill_chunk=128, prefix_cache_entries=0, **WINDOW))
    jeng.start()
    try:
        short = [_ids(e, SHORT, 24) for e in (dense, hot, spl)]
        assert short[0] == short[1] == short[2]
        want = _ids(hot, LONG, 40)
        assert _ids(spl, LONG, 40) == want
        m = spl.metrics()
        assert m["kv_pages_spilled"] > 0, "spill never engaged"
        assert m["kv_spill_bytes_out"] == m["kv_pages_spilled"] * spl._page_bytes()
        assert spl.m_kv_spill_bytes_out <= 64 << 20 and m["kv_spill_skips"] == 0
        assert hot.metrics()["kv_pages_spilled"] == 0  # no budget, no spill
        assert _ids(jeng, LONG, 40, JaxGenRequest) == want
        for e in (hot, spl):
            _settle(e)
            _check_pool_invariants(e)
            assert len(e._free_pages) == 24
        # The finished slot's images went with it.
        assert spl.metrics()["spilled_pages"] == 0 and spl.metrics()["spill_bytes"] == 0
    finally:
        for e in (dense, hot, spl, jeng):
            e.stop()


def test_spill_keeps_images_of_the_pages_it_frees(weights):
    """While a long request decodes, its spilled columns hold host images
    of exactly the rows their pages held, their table entries point at
    SCRATCH, and the freed device pages are back on the free list."""
    cfg, _, tp = weights
    eng = _windowed(cfg, tp, start=False, kv_l1_span=4, kv_spill_bytes=64 << 20)
    seen = {}
    spill = eng._spill_cold_pages

    def spy():
        before = {i: list(p) for i, p in enumerate(eng._slot_pages)}
        rows = {i: {c: (eng.cache.k[:, p].clone(), eng.cache.v[:, p].clone())
                    for c, p in enumerate(pages) if p >= 0} for i, pages in before.items()}
        spill()
        for i, images in enumerate(eng._slot_spill):
            for c, (hk, hv) in images.items():
                if (i, c) not in seen and c in rows[i]:
                    seen[(i, c)] = True
                    assert hk.shape[1] == 1
                    assert bytes(hk[:, 0].numpy()) == bytes(rows[i][c][0].numpy())
                    assert bytes(hv[:, 0].numpy()) == bytes(rows[i][c][1].numpy())
                    assert before[i][c] in eng._free_pages
                    assert eng.h_l0[eng._slot_tps[i][c // 4], c % 4] == eng._scratch_page

    eng._spill_cold_pages = spy
    eng.start()
    try:
        _ids(eng, LONG, 40)
        assert seen, "spill never engaged"
        _settle(eng)
        _check_pool_invariants(eng)
    finally:
        eng.stop()


def test_windowed_preemption_drops_spilled_images(weights):
    """Two long windowed decodes on a pool that cannot hold both, with a
    spill budget of three pages: the youngest is preempted by recompute,
    its spilled images are dropped with its pages, both requests finish
    with the ids each gets alone, and the pool is whole at quiesce."""
    cfg, _, tp = weights
    kw = dict(attention_window=128, prefill_chunk=64, kv_l1_span=4)
    budget = 3 * 2 * 64 * 2 * 16 * 4 * 2  # three pages of tiny's f32 K and V
    prompts = [SHORT[:100], [(j * 5) % 251 + 3 for j in range(120)]]
    alone = _windowed(cfg, tp, kv_spill_bytes=budget, kv_pages=40, **kw)
    try:
        assert alone._page_bytes() * 3 == budget
        want = [_ids(alone, p, 400) for p in prompts]
    finally:
        alone.stop()
    eng = _windowed(cfg, tp, kv_spill_bytes=budget, kv_pages=10, **kw)
    try:
        hs = [eng.submit(GenRequest(prompt_ids=p, max_new_tokens=400, ignore_eos=True))
              for p in prompts]
        got = []
        for h in hs:
            evs = list(h)
            assert evs[-1].kind == "done"
            got.append([e.token_id for e in evs if e.kind == "token"])
        assert got == want
        m = eng.metrics()
        assert m["kv_preemptions"] > 0 and m["kv_pages_spilled"] > 3
        _settle(eng)
        _check_pool_invariants(eng)
        assert eng._spill_bytes == 0 and len(eng._free_pages) == 10
    finally:
        eng.stop()


@pytest.mark.parametrize("kw, match", [
    (dict(max_seq=512, attention_sink=32), "attention_window"),  # sink without window
    (dict(max_seq=512, kv_pages=8, kv_page_size=64, attention_sink=32, attention_window=256),
     "chunked prefill"),  # paged, no chunks
    (dict(max_seq=1024, kv_pages=16, kv_page_size=64, attention_sink=32, attention_window=128,
          prefill_chunk=256), "prefill_chunk"),  # chunk > window
    (dict(max_seq=512, kv_l1_span=4), "kv_l1_span"),  # hierarchical without a pool
    (dict(max_seq=512, kv_pages=8, kv_page_size=64, kv_l1_span=1), "kv_l1_span"),
    (dict(max_seq=512, attention_window=-1), "must be >= 0"),
    (dict(max_seq=512, kv_spill_bytes=-1), "kv_spill_bytes"),
], ids=["sink-without-window", "paged-no-chunks", "chunk-over-window", "hier-no-pool",
        "span-1", "negative-window", "negative-spill"])
def test_windowed_sink_rejects_bad_combos(weights, kw, match):
    cfg, _, tp = weights
    with pytest.raises(ValueError, match=match):
        Engine(cfg, tp, ByteTokenizer(cfg.vocab_size),
               engine_cfg=EngineConfig(max_slots=2, **kw), device="cpu")


def test_window_refuses_a_sliding_window_model(weights):
    cfg, _, tp = weights
    gemma = dataclasses.replace(cfg, sliding_window=32)
    with pytest.raises(ValueError, match="architectural sliding window"):
        Engine(gemma, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
               engine_cfg=EngineConfig(max_slots=2, max_seq=512, attention_window=128))


def test_engine_threads_the_window_to_the_model(weights):
    """The engine's knobs replace the ArchConfig's: the model functions
    read them from there."""
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(max_slots=2, max_seq=512, **WINDOW))
    try:
        assert (eng.cfg.attention_sink, eng.cfg.attention_window) == (64, 256)
        assert (cfg.attention_sink, cfg.attention_window) == (0, 0)
    finally:
        eng.stop()


def test_hier_allocator_invariants_randomized(weights):
    """A seeded random walk over the allocator with hierarchical tables
    (span 2): admit-style allocs (some sharing another slot's leading
    pages), growth, frees, double releases, a test-held reference on a
    table page (so growth writes through a shared table page: the copy on
    write) and its release, and spilling a column by hand; every invariant,
    table-page refcounts included, after each step."""
    cfg, _, tp = weights
    rng = np.random.default_rng(11)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(max_slots=4, max_seq=512, kv_pages=16,
                                         kv_page_size=32, kv_l1_span=2))
    B = eng.ecfg.max_slots
    held: list[int] = []
    cows = 0
    try:
        for _step in range(300):
            op = int(rng.integers(0, 7))
            busy = [i for i in range(B) if eng._slot_pages[i]]
            if op == 0:  # admit-style alloc, sometimes sharing a prefix
                frees = [i for i in range(B) if not eng._slot_pages[i]]
                if frees:
                    shared = None
                    if busy and rng.random() < 0.5:
                        donor = [p for p in eng._slot_pages[int(rng.choice(busy))] if p >= 0]
                        shared = donor[: int(rng.integers(0, len(donor) + 1))]
                    eng._pages_alloc(int(rng.choice(frees)), int(rng.integers(1, 5)),
                                     shared=shared)
            elif op == 1 and busy:  # decode growth
                s = int(rng.choice(busy))
                before = len(eng._tp_free)
                eng._pages_grow_slot(s, len(eng._slot_pages[s]) + int(rng.integers(1, 4)))
                cows += any(eng._tp_refs[t] > 1 for t in eng._slot_tps[s]) and \
                    len(eng._tp_free) < before
            elif op == 2 and busy:  # finish
                eng._pages_free(int(rng.choice(busy)))
            elif op == 3 and eng._free_pages:  # double release: clamped
                eng._pages_release([int(eng._free_pages[0])])
            elif op == 4 and busy:  # another holder takes a table page
                t = int(rng.choice(eng._slot_tps[int(rng.choice(busy))]))
                eng._tp_refs[t] += 1
                held.append(t)
            elif op == 5 and held:  # that holder lets go
                eng._tp_release([held.pop(int(rng.integers(0, len(held))))])
            elif op == 6 and busy:  # a column spills
                s = int(rng.choice(busy))
                c = int(rng.integers(0, len(eng._slot_pages[s])))
                p = eng._slot_pages[s][c]
                if p >= 0 and eng._page_refs[p] == 1:
                    eng._slot_spill[s][c] = (None, None)
                    eng._spill_bytes += eng._page_bytes()
                    eng._pages_release([p])
                    eng._slot_pages[s][c] = -1
                    eng._ptable_set(s, c, eng._scratch_page)
            _check_pool_invariants(eng, held)
        eng._tp_release(held)
        for i in range(B):
            eng._pages_free(i)
        _check_pool_invariants(eng)
        assert sorted(eng._free_pages) == list(range(16))
        assert len(eng._tp_free) == len(eng._tp_refs) - 1 and eng._spill_bytes == 0
    finally:
        eng.stop()


def test_table_page_pool_growth_rekeys_the_block_graphs(weights):
    """If a table-page claim finds the pool empty, h_l0 grows; the next
    block stages into new buffers of the new size under a new graph key,
    the graphs captured on the old buffer are dropped, and serving goes on
    with the same ids."""
    cfg, _, tp = weights
    ref = _windowed(cfg, tp, kv_l1_span=4)
    try:
        want = _ids(ref, LONG, 24)
    finally:
        ref.stop()
    eng = _windowed(cfg, tp, kv_l1_span=4)
    try:
        old_key = eng._block_key(8, "greedy", 0)
        eng._graph_cache[old_key] = ("a graph on the old buffer", {}, ())
        rows = eng.h_l0.shape[0]
        # Another holder takes every free table page: the next claim grows the pool.
        held = [eng._tp_claim() for _ in range(len(eng._tp_free))]
        assert _ids(eng, LONG, 24) == want
        assert eng.h_l0.shape[0] == rows + eng._ml1
        assert eng._b_l0.shape == eng.h_l0.shape and old_key not in eng._graph_cache
        assert eng._block_key(8, "greedy", 0) != old_key
        _settle(eng)
        _check_pool_invariants(eng, held)
    finally:
        eng.stop()


def test_manager_passes_the_long_context_knobs(tmp_path):
    """attention_sink, attention_window, kv_l1_span and kv_spill_bytes in a
    model's YAML reach its EngineConfig (and the window its ArchConfig)."""
    doc = {"name": "long", "model": "tiny", "context_size": 1024, "max_slots": 2,
           "kv_pages": 24, "kv_page_size": 64, "prefill_chunk": 128, "attention_sink": 64,
           "attention_window": 256, "kv_l1_span": 4, "kv_spill_bytes": 1 << 20}
    (tmp_path / "long.yaml").write_text(yaml.safe_dump(doc))
    mm = ModelManager(ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path)),
                      device="cpu")
    try:
        eng = mm.get("long").engine
        e = eng.ecfg
        assert (e.attention_sink, e.attention_window, e.kv_l1_span, e.kv_spill_bytes) == (
            64, 256, 4, 1 << 20)
        assert eng.cfg.attention_window == 256 and eng._hier and eng._spill_on
        _, ev = eng.generate(SHORT[:20], max_new_tokens=4, ignore_eos=True)
        assert ev.kind == "done"
    finally:
        mm.shutdown()
