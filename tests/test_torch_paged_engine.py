"""The PyTorch port's paged KV pool against the JAX package and against
itself: the chunked prefill and the paged decode step of the model on the
tiny f32 weights, then the paged + chunked engine (greedy ids equal to the
JAX engine's and to the port's dense engine), its scheduling (a short
request finishing during a long chunked prefill, backpressure, the submit
gate, config validation), recompute preemption, and the page allocator's
invariants. Every engine is stopped."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl

# f32 both sides, summation order only.
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _table(B, MP, P, seed):
    return np.random.default_rng(seed).permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)


def _ids(n, mult=7):
    return [(j * mult) % 250 + 1 for j in range(n)]


def _chunks(cfg, params, ids, chunk, pool, table, lib, **kw):
    """Run a prompt through prefill_chunk_paged chunk by chunk (ragged tail
    bucketed to 32); returns the last chunk's logits."""
    logits = None
    for lo in range(0, len(ids), chunk):
        seg = ids[lo: lo + chunk]
        toks = np.zeros((1, chunk if len(seg) == chunk else 32), np.int32)
        toks[0, : len(seg)] = seg
        if lib is jl:
            logits, pool = jl.prefill_chunk_paged(
                cfg, params, jnp.asarray(toks), jnp.asarray([len(seg)], jnp.int32),
                jnp.asarray([lo], jnp.int32), pool, jnp.asarray(table), paged_impl="xla")
        else:
            logits, _ = tl.prefill_chunk_paged(
                cfg, params, torch.from_numpy(toks).long(), torch.tensor([len(seg)]),
                torch.tensor([lo]), pool, torch.from_numpy(table), **kw)
    return logits, pool


def _live_rows(pool_k, table_row, n, page):
    live = np.arange(n)
    return np.asarray(pool_k)[:, table_row[live // page], live % page]


@pytest.mark.parametrize("plen", [40, 50, 64])  # ragged tails of 8 and 18, none
def test_prefill_chunk_paged_matches_jax(weights, plen):
    cfg, jp, tp = weights
    page, MP, P, chunk = 16, 4, 12, 32
    ids = _ids(plen)
    table = _table(1, MP, P, seed=7)
    jlog, jpool = _chunks(cfg, jp, ids, chunk, jl.paged_cache_zeros(cfg, P, page), table, jl)
    tpool = tl.paged_cache_zeros(cfg, P, page, device="cpu")
    tlog, _ = _chunks(cfg, tp, ids, chunk, tpool, table, tl)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    for t, j in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
        np.testing.assert_allclose(_live_rows(t.numpy(), table[0], plen, page),
                                   _live_rows(j, table[0], plen, page), atol=KV_ATOL, rtol=0)


def test_prefill_chunk_paged_matches_single_shot(weights):
    """Chunked direct-to-page prefill == one bucketed prefill scattered into
    the same pages: the same last logits and the same live rows."""
    cfg, _, tp = weights
    page, MP, P, plen, chunk = 16, 4, 12, 50, 32
    ids = _ids(plen)
    table = _table(1, MP, P, seed=8)
    toks = torch.zeros((1, 64), dtype=torch.long)
    toks[0, :plen] = torch.tensor(ids)
    ref_logits, ks, vs = tl.prefill(cfg, tp, toks, torch.tensor([plen]))
    ref = tl.paged_cache_zeros(cfg, P, page, device="cpu")
    tl.write_prefill_to_pool(ref, torch.from_numpy(table[0]), ks, vs, 0)
    pool = tl.paged_cache_zeros(cfg, P, page, device="cpu")
    logits, _ = _chunks(cfg, tp, ids, chunk, pool, table, tl)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), atol=LOGIT_ATOL, rtol=0)
    for a, b in ((pool.k, ref.k), (pool.v, ref.v)):
        np.testing.assert_allclose(_live_rows(a.numpy(), table[0], plen, page),
                                   _live_rows(b.numpy(), table[0], plen, page),
                                   atol=KV_ATOL, rtol=0)


def test_paged_decode_blocks_match_jax_and_dense(weights):
    """Prefill two prompts into pages, then 16 greedy steps in two 8-step
    blocks of paged decode_step_windowed + write_block_to_pool: logits match
    the JAX package's paged step and the port's dense step."""
    cfg, jp, tp = weights
    B, S, n, page, MP, P = 2, 16, 8, 16, 4, 10
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([5, 16], np.int32)
    table = _table(B, MP, P, seed=2)
    jlog, jks, jvs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    tlog, tks, tvs = tl.prefill(cfg, tp, torch.from_numpy(toks).long(), torch.from_numpy(lens))
    jpool = jl.paged_cache_zeros(cfg, P, page)
    tpool = tl.paged_cache_zeros(cfg, P, page, device="cpu")
    dense = tl.KVCache.zeros(cfg, B, MP * page, device="cpu")
    ttable = torch.from_numpy(table)
    for b in range(B):
        jpool = jl.write_prefill_to_pool(jpool, jnp.asarray(table[b]), jks, jvs, b)
        tl.write_prefill_to_pool(tpool, ttable[b], tks, tvs, b)
        tl.write_prefill_to_cache(dense, tks[:, b:b + 1], tvs[:, b:b + 1], b)
    jstep = jax.jit(lambda *a: jl.decode_step_windowed(cfg, *a, ptable=jnp.asarray(table),
                                                       paged_impl="xla"))
    jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), torch.argmax(tlog, -1)
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens).long()
    for _blk in range(2):
        jlk = jnp.zeros((L, B, n, K, Hd), jnp.float32)
        jlv = jnp.zeros_like(jlk)
        tlk, tlv = torch.zeros((L, B, n, K, Hd)), torch.zeros((L, B, n, K, Hd))
        dlk, dlv = torch.zeros_like(tlk), torch.zeros_like(tlv)
        jstart, tstart = jpos, tpos
        for step in range(n):
            jlogits, jlk, jlv = jstep(jp, jtok, jpos, jpool, jlk, jlv, jnp.int32(step))
            tlogits, tlk, tlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, tpool, tlk, tlv,
                                                        step, ptable=ttable)
            dlogits, dlk, dlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, dense, dlk, dlv,
                                                        step)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=LOGIT_ATOL, rtol=0)
            np.testing.assert_allclose(tlogits.numpy(), dlogits.numpy(), atol=LOGIT_ATOL, rtol=0)
            jtok, ttok = jnp.argmax(jlogits, -1).astype(jnp.int32), torch.argmax(tlogits, -1)
            assert np.array_equal(np.asarray(jtok), ttok.numpy())
            jpos, tpos = jpos + 1, tpos + 1
        jpool = jl.write_block_to_pool(jpool, jnp.asarray(table), jlk, jlv, jstart)
        tl.write_block_to_pool(tpool, ttable, tlk, tlv, tstart)
        tl.write_block_to_cache(dense, dlk, dlv, tstart)


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #

def _engine(tp, cfg, start=True, **kw):
    # Without the prefix cache and with recompute preemption, as the JAX
    # engines here run: both have their own tests (test_torch_prefix_cache.py,
    # test_torch_swap.py).
    defaults = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,),
                    kv_page_size=64, prefix_cache_entries=0, kv_preempt="recompute")
    defaults.update(kw)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**defaults),
                 device="cpu")
    if start:
        eng.start()
    return eng


def _token_ids(handle):
    evs = list(handle)
    assert evs[-1].kind == "done", evs[-1]
    assert sum(e.kind in ("done", "error") for e in evs) == 1
    return [e.token_id for e in evs if e.kind == "token"], evs[-1]


PROMPTS = [_ids(150), [3, 1, 4], _ids(70, 3), list(range(40, 60)), _ids(200, 11)]


def test_paged_chunked_engine_matches_jax_and_dense_engines(weights):
    cfg, jp, tp = weights
    kw = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
    paged = dict(kv_pages=12, kv_page_size=64, prefill_chunk=64)
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, **kw, **paged))
    teng = _engine(tp, cfg, **kw, **paged)
    deng = _engine(tp, cfg, **kw, kv_pages=0)
    try:
        outs = {}
        for name, eng, Req in (("jax", jeng, None), ("paged", teng, GenRequest),
                               ("dense", deng, GenRequest)):
            if Req is None:
                from localai_tpu.engine import GenRequest as Req
            hs = [eng.submit(Req(prompt_ids=p, max_new_tokens=12, ignore_eos=True))
                  for p in PROMPTS]
            outs[name] = [_token_ids(h)[0] for h in hs]
        assert outs["paged"] == outs["jax"]
        assert outs["paged"] == outs["dense"]
        m = teng.metrics()
        assert m["chunked_admits"] == 3 and m["prefill_chunks"] == 3 + 2 + 4
        assert m["kv_pages_free"] == 12
    finally:
        jeng.stop()
        teng.stop()
        deng.stop()


def test_short_request_completes_during_chunked_prefill(weights):
    cfg, _, tp = weights
    eng = _engine(tp, cfg, kv_pages=20, kv_page_size=16, prefill_chunk=16)
    try:
        done = {}

        def run(name, ids, n):
            _token_ids(eng.submit(GenRequest(prompt_ids=ids, max_new_tokens=n,
                                             ignore_eos=True)))
            done[name] = time.monotonic()

        tl_ = threading.Thread(target=run, args=("long", _ids(200), 24))
        ts = threading.Thread(target=run, args=("short", [5, 6, 7], 30))
        tl_.start()
        ts.start()
        tl_.join(timeout=TIMEOUT)
        ts.join(timeout=TIMEOUT)
        assert done["short"] < done["long"], done
        m = eng.metrics()
        assert m["prefill_chunks"] == 13 and m["prefill_chunks_interleaved"] >= 1
    finally:
        eng.stop()


def test_paged_backpressure_serializes_when_pool_small(weights):
    """Two requests whose admissions need most of the pool run one after
    the other: the second waits in the queue until the first's pages free."""
    cfg, _, tp = weights
    eng = _engine(tp, cfg, kv_pages=6, max_seq=512)
    try:
        # bucket(200) = 256 rows = 4 pages, + headroom 1: 5 of 6 pages each.
        h1 = eng.submit(GenRequest(prompt_ids=_ids(200), max_new_tokens=20, ignore_eos=True))
        h2 = eng.submit(GenRequest(prompt_ids=_ids(200, 3), max_new_tokens=20, ignore_eos=True))
        _, e1 = _token_ids(h1)
        _, e2 = _token_ids(h2)
        assert e1.completion_tokens == e2.completion_tokens == 20
        h1_end = h1.t_admit + e1.timing_prompt_processing + e1.timing_token_generation
        assert h2.t_admit >= h1_end - 1e-3
        m = eng.metrics()
        assert m["kv_pages_peak"] <= 6 and m["kv_preemptions"] == 0
        _quiesce(eng)
        _check_pool_invariants(eng)
        assert sorted(eng._free_pages) == list(range(6))
    finally:
        eng.stop()


def test_paged_rejects_request_larger_than_pool(weights):
    cfg, _, tp = weights
    eng = _engine(tp, cfg, start=False, kv_pages=4, max_seq=512)
    try:
        with pytest.raises(ValueError, match="KV pages"):
            eng.submit(GenRequest(prompt_ids=_ids(40), max_new_tokens=400))
        assert eng._pages_worst(GenRequest(prompt_ids=_ids(40), max_new_tokens=100)) == 3
    finally:
        eng.stop()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(kv_pages=4, kv_page_size=48), ValueError, "divide"),
    (dict(kv_pages=4, prefill_chunk=48), ValueError, "power of two"),
    (dict(kv_pages=4, prefill_chunk=8), ValueError, "min_prefill_bucket"),
    (dict(kv_pages=0, prefill_chunk=48), ValueError, "power of two"),  # dense chunks too
    (dict(kv_pages=4, kv_page_size=0), ValueError, "divide"),
    (dict(kv_pages=4, kv_page_headroom=-1), ValueError, "headroom"),
    (dict(kv_pages=4, prefill_chunk=-1), ValueError, "power of two"),
    (dict(kv_pages=-1), ValueError, "kv_pages"),
])
def test_bad_paged_configs_raise(weights, kw, exc, match):
    cfg, _, tp = weights
    with pytest.raises(exc, match=match):
        _engine(tp, cfg, start=False, **kw)


def test_recompute_preemption_is_lossless_for_greedy(weights):
    """A pool too small for two growing requests: the younger one is
    preempted (pages freed, prompt + generated requeued under the same
    handle) and both still produce exactly their uncontended tokens, with
    one terminal event each."""
    cfg, _, tp = weights
    kw = dict(max_new_tokens=100, ignore_eos=True)
    pa, pb = _ids(40), _ids(41, 3)
    ample = _engine(tp, cfg, kv_pages=40, kv_page_size=16)
    try:
        want_a = _token_ids(ample.submit(GenRequest(prompt_ids=pa, **kw)))[0]
        want_b = _token_ids(ample.submit(GenRequest(prompt_ids=pb, **kw)))[0]
    finally:
        ample.stop()
    # Worst case 9 pages each; admission takes 4 + 1 each, so both start
    # and growth collides mid-decode.
    eng = _engine(tp, cfg, kv_pages=12, kv_page_size=16)
    try:
        ha = eng.submit(GenRequest(prompt_ids=pa, **kw))
        time.sleep(0.05)  # a strictly older than b: b is the victim
        hb = eng.submit(GenRequest(prompt_ids=pb, **kw))
        got_a, ev_a = _token_ids(ha)
        got_b, ev_b = _token_ids(hb)
        assert eng.metrics()["kv_preemptions"] >= 1, "the pool never collided"
        assert got_a == want_a and got_b == want_b
        assert ev_b.completion_tokens == 100 and ev_b.prompt_tokens == len(pb)
        _quiesce(eng)
        _check_pool_invariants(eng)
    finally:
        eng.stop()


# A seeded top-p / top-k request at T = 0.9 with all three penalties.
SEEDED = dict(max_new_tokens=100, temperature=0.9, top_p=0.9, top_k=40, repeat_penalty=1.1,
              presence_penalty=0.3, frequency_penalty=0.2, seed=1234, ignore_eos=True)


def test_seeded_sampling_gives_the_same_ids_on_every_path(weights):
    """The same seeded request draws the same ids on the dense engine, the
    paged one, the chunked one, a 4-slot one beside three other requests,
    and through a recompute preemption that requeues it mid-decode."""
    cfg, _, tp = weights
    prompt = _ids(40)
    paths = {
        "dense": dict(kv_pages=0),
        "paged": dict(kv_pages=40, kv_page_size=16),
        "chunked": dict(kv_pages=40, kv_page_size=16, prefill_chunk=16),
        "four_slots": dict(max_slots=4, kv_pages=60, kv_page_size=16, prefill_chunk=16),
    }
    got = {}
    for name, kw in paths.items():
        eng = _engine(tp, cfg, **kw)
        try:
            h = eng.submit(GenRequest(prompt_ids=prompt, **SEEDED))
            others = [eng.submit(GenRequest(prompt_ids=_ids(30 + i, 3), max_new_tokens=20,
                                            temperature=0.7, seed=i, ignore_eos=True))
                      for i in range(3 if name == "four_slots" else 0)]
            got[name] = _token_ids(h)[0]
            for o in others:
                _token_ids(o)
            if name == "chunked":
                assert eng.metrics()["chunked_admits"] == 1
        finally:
            eng.stop()
    # As test_recompute_preemption_is_lossless_for_greedy: both requests need
    # 9 pages of 12, so growth collides and the younger, seeded one is requeued.
    eng = _engine(tp, cfg, kv_pages=12, kv_page_size=16)
    try:
        older = eng.submit(GenRequest(prompt_ids=_ids(41, 3), max_new_tokens=100,
                                      ignore_eos=True))
        time.sleep(0.05)
        h = eng.submit(GenRequest(prompt_ids=prompt, **SEEDED))
        got["preempted"] = _token_ids(h)[0]
        _token_ids(older)
        assert eng.metrics()["kv_preemptions"] >= 1, "the pool never collided"
    finally:
        eng.stop()
    assert len(got["dense"]) == 100
    assert all(ids == got["dense"] for ids in got.values()), {
        k: v[:8] for k, v in got.items()}
    greedy = _engine(tp, cfg, kv_pages=0)
    try:  # the draws matter: greedy decoding gives other ids
        assert _token_ids(greedy.submit(GenRequest(
            prompt_ids=prompt, max_new_tokens=100, ignore_eos=True)))[0] != got["dense"]
    finally:
        greedy.stop()


# --------------------------------------------------------------------------- #
# Allocator invariants
# --------------------------------------------------------------------------- #

def _quiesce(eng, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with eng._pending_lock:
            idle = not eng._pending
        if idle and not eng.h_active.any() and not eng._chunkings:
            return
        time.sleep(0.02)
    raise AssertionError("engine did not quiesce")


def _check_pool_invariants(eng):
    """Refcounts equal the references slot tables hold, the free list is
    duplicate-free and disjoint from held pages, every page is free or held,
    SCRATCH is never handed out, and each table row points only at its own
    pages or SCRATCH."""
    P = eng.ecfg.kv_pages
    refs = np.zeros(P, np.int64)
    for pages in eng._slot_pages:
        for p in pages:
            assert p != eng._scratch_page
            refs[p] += 1
    assert (refs == eng._page_refs[:P]).all(), (refs.tolist(), eng._page_refs.tolist())
    free = eng._free_pages
    assert len(set(free)) == len(free), f"duplicate free pages: {free}"
    assert eng._scratch_page not in free
    assert all(refs[p] == 0 for p in free), "a free page is still referenced"
    assert set(free) | {p for p in range(P) if refs[p]} == set(range(P)), "leaked pages"
    for i, pages in enumerate(eng._slot_pages):
        assert set(eng.h_ptable[i].tolist()) <= set(pages) | {eng._scratch_page}


def test_allocator_invariants_randomized_walk(weights):
    """Seeded random walk over the allocator primitives (alloc with and
    without pages shared from another slot, growth, free, double release)
    with every invariant checked after each step."""
    cfg, _, tp = weights
    rng = np.random.default_rng(7)
    eng = _engine(tp, cfg, start=False, max_slots=4, kv_pages=16, kv_page_size=16)
    B = eng.ecfg.max_slots
    try:
        for _step in range(300):
            op = int(rng.integers(0, 5))
            held = [i for i in range(B) if eng._slot_pages[i]]
            if op == 0:  # admit-style alloc, sometimes sharing a prefix
                frees = [i for i in range(B) if not eng._slot_pages[i]]
                if frees:
                    shared = None
                    if held and rng.random() < 0.5:
                        donor = eng._slot_pages[int(rng.choice(held))]
                        shared = donor[: int(rng.integers(1, len(donor) + 1))]
                    eng._pages_alloc(int(rng.choice(frees)), int(rng.integers(1, 5)),
                                     shared=shared)
            elif op == 1 and held:  # decode growth
                s = int(rng.choice(held))
                eng._pages_grow_slot(s, len(eng._slot_pages[s]) + int(rng.integers(1, 4)))
            elif op == 2 and held:  # finish
                eng._pages_free(int(rng.choice(held)))
            elif op == 3 and eng._free_pages:  # double release: clamped, never corrupts
                eng._pages_release([int(eng._free_pages[0])])
            elif op == 4 and held:  # alloc over a held table releases it first
                s = int(rng.choice(held))
                eng._pages_alloc(s, 1)
            _check_pool_invariants(eng)
        for i in range(B):
            eng._pages_free(i)
        _check_pool_invariants(eng)
        assert sorted(eng._free_pages) == list(range(16))
    finally:
        eng.stop()


def test_randomized_workload_leaves_the_pool_whole(weights):
    """Random prompts, lengths and a cancellation on a small pool with
    chunking and preemption: every request ends with one terminal event,
    and at quiesce every page is free."""
    cfg, _, tp = weights
    rng = np.random.default_rng(3)
    eng = _engine(tp, cfg, max_slots=3, kv_pages=14, kv_page_size=16, prefill_chunk=32)
    try:
        for batch in range(2):
            handles = []
            for _r in range(5):
                ids = [int(x) % 250 + 1 for x in rng.integers(0, 250, int(rng.integers(4, 100)))]
                handles.append(eng.submit(GenRequest(
                    prompt_ids=ids, max_new_tokens=int(rng.integers(4, 60)), ignore_eos=True)))
            if batch == 1:
                handles[-1].cancel()
            kinds = [list(h)[-1].kind for h in handles]
            assert set(kinds) == {"done"}
            _quiesce(eng)
            _check_pool_invariants(eng)
            assert len(eng._free_pages) == 14
    finally:
        eng.stop()
