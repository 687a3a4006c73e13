"""The PyTorch port's prefix cache on the tiny f32 weights, against the JAX
package and against itself: `prefill_tail` (logits and tail K/V against the
JAX one, with sliding layers, softcaps and MoE MLPs, and against a full
prefill), the row movers (`gather_pages`, `write_rows_to_pool`,
`write_rows_to_cache`) bit for bit on f32 and fp8 stores, the engine with
the cache against the JAX engine with it (a shared system prompt and a chat
whose turns carry the answers, on dense, flat, hierarchical and fp8 pools:
the same greedy ids and the same hits), hit against miss (greedy and
seeded, every layout, a sink + window engine), the LRU bounds, eviction
before preemption, the host tier (spill, promotion, a promotion that meets
pool pressure), adapter requests, the pages an entry shares staying
unchanged, every refcount returning to zero, and the server's two chat
turns against the JAX server's bytes. Every engine is stopped."""

import dataclasses
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest, RequestHandle
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl

# f32 both sides: summation order only.
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5

SYS = [(j * 7) % 250 + 1 for j in range(70)]  # a shared system prompt
SEEDED = dict(temperature=0.8, top_p=0.9, seed=7)


def _cfg(base="tiny", **kw):
    return dataclasses.replace(get_arch(base), dtype="float32", **kw)


def _trees(cfg):
    jp = jl.init_params(cfg, jax.random.key(0))
    return jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def weights():
    cfg = _cfg()
    jp, tp = _trees(cfg)
    return cfg, jp, tp


# --------------------------------------------------------------------------- #
# prefill_tail and the row movers
# --------------------------------------------------------------------------- #

VARIANTS = {
    "plain": {},
    "sliding": dict(sliding_window=8, sliding_pattern=2),
    "softcap": dict(attn_softcap=20.0, final_softcap=30.0),
    "moe": "tiny-moe",
}


@pytest.mark.parametrize("offsets", [(5, 20), (16, 31)], ids=["5-20", "16-31"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_tail_matches_jax(variant, offsets):
    """The port's prefill_tail against the JAX package's on the same random
    prefix K/V and tail tokens: two rows with their own offsets and tail
    lengths (rows past each offset are ignored)."""
    v = VARIANTS[variant]
    cfg = _cfg(v) if isinstance(v, str) else _cfg(**v)
    jp, tp = _trees(cfg)
    rng = np.random.default_rng(3)
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    P, T = 32, 16
    pk = rng.standard_normal((L, 2, P, K, Hd)).astype(np.float32)
    pv = rng.standard_normal((L, 2, P, K, Hd)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (2, T)).astype(np.int32)
    lens = np.asarray([11, T], np.int32)
    offs = np.asarray(offsets, np.int32)
    jlog, jk, jv = jl.prefill_tail(cfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                                   jnp.asarray(offs), jnp.asarray(pk), jnp.asarray(pv))
    tlog, tk, tv = tl.prefill_tail(cfg, tp, torch.from_numpy(toks).long(),
                                   torch.from_numpy(lens), torch.from_numpy(offs),
                                   torch.from_numpy(pk), torch.from_numpy(pv))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tk[:, b, :n].numpy(), np.asarray(jk)[:, b, :n],
                                   atol=KV_ATOL, rtol=0)
        np.testing.assert_allclose(tv[:, b, :n].numpy(), np.asarray(jv)[:, b, :n],
                                   atol=KV_ATOL, rtol=0)


def test_prefill_tail_matches_full_prefill(weights):
    """A tail prefilled against a prompt prefix's K/V gives the whole
    prompt's last logits and the prompt's rows past the prefix."""
    cfg, _, tp = weights
    seq = [(j * 11) % 250 + 1 for j in range(45)]
    full = torch.zeros((1, 64), dtype=torch.long)
    full[0, : len(seq)] = torch.tensor(seq)
    ref_logits, ref_k, ref_v = tl.prefill(cfg, tp, full, torch.tensor([len(seq)]))
    plen = 29
    head = torch.zeros((1, 32), dtype=torch.long)
    head[0, :plen] = torch.tensor(seq[:plen])
    _, pk, pv = tl.prefill(cfg, tp, head, torch.tensor([plen]))
    tail = torch.zeros((1, 16), dtype=torch.long)
    tail[0, : len(seq) - plen] = torch.tensor(seq[plen:])
    logits, tk, tv = tl.prefill_tail(cfg, tp, tail, torch.tensor([len(seq) - plen]),
                                     torch.tensor([plen]), pk, pv)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), atol=LOGIT_ATOL, rtol=0)
    n = len(seq) - plen
    np.testing.assert_allclose(tk[:, :, :n].numpy(), ref_k[:, :, plen:plen + n].numpy(),
                               atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(tv[:, :, :n].numpy(), ref_v[:, :, plen:plen + n].numpy(),
                               atol=KV_ATOL, rtol=0)


STORES = {
    "f32": (np.float32, torch.float32, None),
    "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, None),
    "fp8-scale2": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, 2.0),
}


def _to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array (ml_dtypes fp8 included) as a torch tensor, bit for bit."""
    if a.dtype == np.float32:
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a).view(np.uint8)).view(dtype)


def _bits(t) -> bytes:
    return bytes(np.asarray(t).view(np.uint8)) if isinstance(t, np.ndarray) else bytes(
        t.contiguous().view(torch.uint8).numpy())


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("store", list(STORES))
def test_row_movers_match_jax_bit_for_bit(weights, store, hier):
    """gather_pages, write_rows_to_pool (a tail starting mid-page, through a
    flat or a hierarchical table) and write_rows_to_cache give the JAX
    package's bytes on f32 pools and on fp8 pools with and without a
    kv_scale."""
    cfg, _, _ = weights
    np_dt, t_dt, scale = STORES[store]
    rng = np.random.default_rng(5)
    L, K, Hd, P, page = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_, 9, 8
    pool_np = [(rng.standard_normal((L, P, page, K, Hd)) * 3).astype(np_dt) for _ in range(2)]
    rows = [(rng.standard_normal((L, 1, 13, K, Hd)) * 3).astype(np.float32) for _ in range(2)]
    kv_scale = None if scale is None else np.full((2, K), scale, np.float32)
    flat = np.asarray([4, 1, 7, 2], np.int32)
    if hier:
        l0 = np.full((3, 2), P - 1, np.int32)
        l0[1], l0[2] = flat[:2], flat[2:]
        jrow, trow = (jnp.asarray([1, 2]), jnp.asarray(l0)), (torch.tensor([1, 2]),
                                                            torch.from_numpy(l0))
    else:
        jrow, trow = jnp.asarray(flat), torch.from_numpy(flat)
    jscale = None if kv_scale is None else jnp.asarray(kv_scale)
    tscale = None if kv_scale is None else torch.from_numpy(kv_scale)
    jpool = jl.KVCache(k=jnp.asarray(pool_np[0]), v=jnp.asarray(pool_np[1]))
    tpool = tl.KVCache(k=_to_torch(pool_np[0], t_dt), v=_to_torch(pool_np[1], t_dt))
    # gather_pages: the span's pages as contiguous rows.
    pages = np.asarray([2, 7, 8], np.int32)
    jg = jl.gather_pages(jpool, jnp.asarray(pages), kv_scale=jscale)
    tg = tl.gather_pages(tpool, torch.from_numpy(pages), kv_scale=tscale)
    for j, t in zip(jg, tg):
        assert _bits(np.asarray(j)) == _bits(t)
    # write_rows_to_pool: 13 rows from row 11 (mid-page) through the table.
    jpool = jl.write_rows_to_pool(jpool, jrow, jnp.asarray(rows[0]), jnp.asarray(rows[1]),
                                  jnp.int32(11), kv_scale=jscale)
    tl.write_rows_to_pool(tpool, trow, torch.from_numpy(rows[0]), torch.from_numpy(rows[1]),
                          11, kv_scale=tscale)
    assert _bits(np.asarray(jpool.k)) == _bits(tpool.k)
    assert _bits(np.asarray(jpool.v)) == _bits(tpool.v)
    # write_rows_to_cache: a dense cache (no scale there), rows from row 5.
    cache_np = [rng.standard_normal((L, 3, 32, K, Hd)).astype(np_dt) for _ in range(2)]
    jc = jl.KVCache(k=jnp.asarray(cache_np[0]), v=jnp.asarray(cache_np[1]))
    tc = tl.KVCache(k=_to_torch(cache_np[0], t_dt), v=_to_torch(cache_np[1], t_dt))
    jc = jl.write_rows_to_cache(jc, jnp.int32(1), jnp.asarray(rows[0]), jnp.asarray(rows[1]),
                                jnp.int32(5))
    tl.write_rows_to_cache(tc, 1, torch.from_numpy(rows[0]), torch.from_numpy(rows[1]), 5)
    assert _bits(np.asarray(jc.k)) == _bits(tc.k)
    assert _bits(np.asarray(jc.v)) == _bits(tc.v)


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #

BASE = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
LAYOUTS = {
    "dense": {},
    "paged": dict(kv_pages=40, kv_page_size=16),
    "chunked": dict(kv_pages=40, kv_page_size=16, prefill_chunk=32),
    "hier": dict(kv_pages=40, kv_page_size=16, prefill_chunk=32, kv_l1_span=2),
    "fp8": dict(kv_pages=40, kv_page_size=16, prefill_chunk=32, kv_cache_dtype="fp8",
                kv_scale=2.0),
}


def _engine(tp, cfg, **kw):
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**{**BASE, **kw}))
    eng.start()
    return eng


def _run(eng, Req, prompt, n=10, **kw):
    evs = list(eng.submit(Req(prompt_ids=prompt, max_new_tokens=n, ignore_eos=True, **kw)))
    assert evs[-1].kind == "done", evs[-1]
    assert sum(e.kind in ("done", "error") for e in evs) == 1
    return [e.token_id for e in evs if e.kind == "token"]


def _conversation(eng, Req=GenRequest, **kw):
    """Two users share SYS; the first then has two more turns, each prompt
    the previous one, its answer and a new message."""
    a = SYS + [3, 5, 8, 13]
    ans = _run(eng, Req, a, **kw)
    out = [ans, _run(eng, Req, SYS + [21, 34, 55], **kw)]
    for msg in ([89, 144, 7], [9, 10, 11, 12, 13]):
        a = a + ans + msg
        ans = _run(eng, Req, a, **kw)
        out.append(ans)
    return out


def _check_refs(eng):
    """Page and table-page refcounts equal the references slots and prefix
    entries hold; the free lists hold exactly the unreferenced ones."""
    P = eng.ecfg.kv_pages
    refs = np.zeros(P, np.int64)
    for pages in list(eng._slot_pages) + [e["pages"] for e in eng._prefix_entries]:
        for p in pages:
            if p >= 0:
                refs[p] += 1
    assert (refs == eng._page_refs[:P]).all(), (refs.tolist(), eng._page_refs.tolist())
    assert sorted(eng._free_pages) == [p for p in range(P) if refs[p] == 0]
    if eng._hier:
        trefs = np.zeros(len(eng._tp_refs), np.int64)
        for tps in list(eng._slot_tps) + [e.get("tps", []) for e in eng._prefix_entries]:
            for tp in tps:
                trefs[tp] += 1
        assert (trefs[1:] == eng._tp_refs[1:]).all()
        assert sorted(eng._tp_free) == [t for t in range(1, len(trefs)) if trefs[t] == 0]


def _stop_idle(eng, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with eng._pending_lock:
            idle = not eng._pending
        if idle and not eng.h_active.any() and not eng._chunkings:
            eng.stop()
            return
        time.sleep(0.02)
    raise AssertionError("engine did not quiesce")


@pytest.mark.parametrize("layout", ["dense", "chunked", "hier", "fp8"])
def test_engine_matches_jax_engine_with_the_prefix_cache(weights, layout):
    """The port's engine and the JAX engine, both with the prefix cache, on
    the same conversation: the same greedy ids, hits and matched tokens.
    The JAX engine takes its single-shot cached path (gather_pages +
    prefill_tail) for tails of one chunk, the port its chunk path."""
    cfg, jp, tp = weights
    kw = {**BASE, **LAYOUTS[layout]}
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), engine_cfg=JaxEngineConfig(
        prefix_admit_async_compile=False, loop_prepare_ahead=False, **kw))
    teng = _engine(tp, cfg, **LAYOUTS[layout])
    try:
        want = _conversation(jeng, JaxGenRequest)
        got = _conversation(teng)
        assert got == want
        jm, tm = jeng.metrics(), teng.metrics()
        assert tm["prefix_hits"] == jm["prefix_cache_hits"] == 3
        assert tm["prefix_tokens"] == jm["prefix_tokens_reused"]
        _stop_idle(teng)
        if teng._paged:
            _check_refs(teng)
    finally:
        jeng.stop()
        teng.stop()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("layout", ["dense", "paged", "chunked", "hier"])
def test_hit_equals_miss(weights, layout, seeded):
    """The conversation with the cache gives the ids it gives with
    prefix_cache_entries=0, greedy and seeded top-p."""
    cfg, _, tp = weights
    kw = SEEDED if seeded else {}
    outs, hits = [], []
    for entries in (8, 0):
        eng = _engine(tp, cfg, prefix_cache_entries=entries, **LAYOUTS[layout])
        try:
            outs.append(_conversation(eng, **kw))
            hits.append(eng.metrics()["prefix_hits"])
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert hits == [3, 0]


def test_windowed_hit_takes_the_masked_walk(weights):
    """Under attention_sink + attention_window a hit's chunks take the same
    masked prefix walk as a miss's: the same ids with and without the
    cache, past the window."""
    cfg, _, tp = weights
    kw = dict(max_seq=512, kv_pages=40, kv_page_size=16, prefill_chunk=32, attention_sink=16,
              attention_window=64)
    sys_long = [(j * 13) % 250 + 1 for j in range(150)]
    outs, hits = [], []
    for entries in (8, 0):
        eng = _engine(tp, cfg, prefix_cache_entries=entries, **kw)
        try:
            a = _run(eng, GenRequest, sys_long + [1, 2], n=12)
            b = _run(eng, GenRequest, sys_long + [1, 2] + a + [3, 4, 5], n=12)
            c = _run(eng, GenRequest, sys_long + [9], n=12)
            outs.append((a, b, c))
            hits.append(eng.metrics()["prefix_hits"])
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert hits == [2, 0]


def test_lru_bounds_on_entries_and_bytes(weights):
    """At most prefix_cache_entries spans, the most recent first; a byte
    budget of one and a half spans keeps one."""
    cfg, _, tp = weights
    prompts = [[(j * m) % 250 + 1 for j in range(40)] for m in (3, 5, 7)]
    eng = _engine(tp, cfg, prefix_cache_entries=2)
    try:
        for p in prompts:
            _run(eng, GenRequest, p, n=2)
        keys = [list(e["key"][:40]) for e in eng._prefix_entries]
        assert keys == [prompts[2], prompts[1]]
        span = eng._prefix_span_bytes(eng._prefix_entries[0]["pb"])
    finally:
        eng.stop()
    eng = _engine(tp, cfg, prefix_cache_bytes=span * 3 // 2)
    try:
        for p in prompts:
            _run(eng, GenRequest, p, n=2)
        assert [list(e["key"][:40]) for e in eng._prefix_entries] == [prompts[2]]
        assert eng.metrics()["prefix_entries"] == 1
    finally:
        eng.stop()


def _pool_engine(tp, cfg, **kw):
    return _engine(tp, cfg, max_seq=256, kv_pages=10, kv_page_size=16, **kw)


X = [(j * 7) % 250 + 1 for j in range(100)]
Y = [(j * 3) % 250 + 2 for j in range(100)]


def test_eviction_spills_before_preemption_and_the_host_tier_rehits(weights):
    """A span's pages go back to the pool (spilled to the host tier) before
    any live request is preempted; a later prompt that shares it swaps it
    back in (prefix_host_hits) and gives the ids of an engine without the
    cache."""
    cfg, _, tp = weights
    z = X + [17, 19, 23]
    ref = _pool_engine(tp, cfg, prefix_cache_entries=0)
    try:
        want = [_run(ref, GenRequest, p, n=4) for p in (X, Y, z)]
    finally:
        ref.stop()
    eng = _pool_engine(tp, cfg)
    try:
        got = [_run(eng, GenRequest, X, n=4)]
        assert len(eng._prefix_entries) == 1 and len(eng._free_pages) == 4
        got.append(_run(eng, GenRequest, Y, n=4))
        m = eng.metrics()
        assert m["kv_preemptions"] == 0 and m["prefix_host_entries"] == 1
        assert m["kv_swap_bytes_out"] == 6 * eng._page_bytes()
        got.append(_run(eng, GenRequest, z, n=4))
        m = eng.metrics()
        assert m["prefix_host_hits"] == 1 and m["prefix_hits"] == 1
        assert m["kv_swap_bytes_in"] == 6 * eng._page_bytes()
        assert got == want
        _stop_idle(eng)
        _check_refs(eng)
    finally:
        eng.stop()


def test_promotion_under_pool_pressure_degrades_to_a_miss(weights):
    """A host-tier span longer than the free pool: the admission does not
    wait for it or requeue on it, it runs as a miss (offset 0), the span
    stays in the host tier, and the request ends with the ids of an engine
    without the cache. Driven on the test thread with the loop stopped."""
    cfg, _, tp = weights
    w = X[:32] + [200, 201]
    ref = _pool_engine(tp, cfg, prefix_cache_entries=0)
    try:
        want = _run(ref, GenRequest, w, n=4)
    finally:
        ref.stop()
    eng = _pool_engine(tp, cfg)
    try:
        _run(eng, GenRequest, X, n=4)
        _run(eng, GenRequest, Y, n=4)  # X's span goes to the host tier
        _stop_idle(eng)
        for e in eng._prefix_entries:  # only the host tier may serve the hit
            eng._prefix_drop(e)
        eng._prefix_entries = []
        hentry, match = eng._prefix_find(w)
        assert "hk" in hentry and match == 32
        held = eng._pages_claim(len(eng._free_pages) - 4)  # 4 free: the miss fits
        handle = RequestHandle()
        req = GenRequest(prompt_ids=w, max_new_tokens=4, ignore_eos=True)
        assert eng._chunk_start(req, handle, (hentry, match))
        assert eng._chunkings[0]["offset"] == 0 and eng.m_prefix_host_hits == 0
        assert any(e is hentry for e in eng._prefix_host) and eng.m_prefix_hits == 0
        while eng._chunkings or eng.h_active.any():
            if eng._chunkings:
                eng._advance_chunked()
            else:
                assert eng._run_block()
        evs = list(handle)
        assert evs[-1].kind == "done"
        assert [e.token_id for e in evs if e.kind == "token"] == want
        eng._pages_release(held)
        _check_refs(eng)
    finally:
        eng.stop()


def test_adapter_requests_neither_hit_nor_save(weights, tmp_path):
    from test_torch_lora_engine import make_adapter

    cfg, _, tp = weights
    make_adapter(tmp_path / "t0", cfg, seed=1)
    eng = _engine(tp, cfg)
    try:
        eng.register_adapter("t0", str(tmp_path / "t0"))
        _run(eng, GenRequest, SYS + [1, 2], n=4)
        keys = [bytes(e["key"]) for e in eng._prefix_entries]
        _run(eng, GenRequest, SYS + [3, 4], n=4, adapter="t0")
        _run(eng, GenRequest, SYS + [3, 4, 5, 6], n=4, adapter="t0")
        assert eng.metrics()["prefix_hits"] == 0
        assert [bytes(e["key"]) for e in eng._prefix_entries] == keys
        _run(eng, GenRequest, SYS + [3, 4], n=4)
        assert eng.metrics()["prefix_hits"] == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("layout", ["chunked", "hier"])
def test_shared_pages_are_unchanged_and_every_reference_returns(weights, layout):
    """An entry's pages read the same bytes before and after two slots map
    them and decode on top of them; the hits add no block-graph key; once
    every request ends and the cache is cleared, every page and table page
    is back on its free list with refcount 0."""
    cfg, _, tp = weights
    eng = _engine(tp, cfg, **LAYOUTS[layout])
    try:
        _run(eng, GenRequest, SYS + [1, 2, 3], n=4)
        (entry,) = eng._prefix_entries
        pages = list(entry["pages"])
        before = [_bits(t[:, pages]) for t in (eng.cache.k, eng.cache.v)]
        key = eng._block_key(8, "greedy", 0)
        hs = [eng.submit(GenRequest(prompt_ids=SYS + [40 + i] * (5 + 9 * i), max_new_tokens=30,
                                    ignore_eos=True)) for i in range(3)]
        for h in hs:
            assert list(h)[-1].kind == "done"
        assert eng.metrics()["prefix_hits"] == 3
        assert [_bits(t[:, pages]) for t in (eng.cache.k, eng.cache.v)] == before
        assert eng._block_key(8, "greedy", 0) == key
        _stop_idle(eng)
        _check_refs(eng)
        eng.clear_prefix_cache()
        assert (eng._page_refs == 0).all()
        assert sorted(eng._free_pages) == list(range(eng.ecfg.kv_pages))
        if eng._hier:
            assert (eng._tp_refs == 0).all()
            assert sorted(eng._tp_free) == list(range(1, len(eng._tp_refs)))
    finally:
        eng.stop()


def test_kv_preempt_is_validated(weights):
    cfg, _, tp = weights
    with pytest.raises(ValueError, match="swap|recompute|auto"):
        Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
               engine_cfg=EngineConfig(kv_preempt="spill"))
    e = EngineConfig()
    assert (e.prefix_cache_entries, e.prefix_cache_min, e.prefix_cache_bytes, e.kv_preempt,
            e.kv_swap_bytes) == (8, 32, 1 << 30, "auto", 256 << 20)


# --------------------------------------------------------------------------- #
# Server
# --------------------------------------------------------------------------- #

def test_two_chat_turns_match_the_jax_server_with_a_hit(tmp_path, monkeypatch):
    """Two chat turns, the second carrying the first's answer, through both
    servers on the same checkpoint (served in bf16): the same content
    bytes, and the second turn is a prefix hit on both. The JAX server
    compiles its cached admission on the loop thread here, so its hit is
    served as a hit, as the port's is (a bf16 hit and a bf16 miss may part
    at a near tie)."""
    import functools

    import localai_tpu.server.manager as jax_manager
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.engine.weights import save_hf_checkpoint
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

    cfg = _cfg()
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(tmp_path / "ckpt"))
    # One device for the JAX server too (the test session's CPU mesh has
    # eight): a tp=2 bf16 engine sums in another order.
    doc = {"name": "chat", "model": "ckpt", "context_size": 512, "max_slots": 2,
           "temperature": 0.0, "tensor_parallel": 1}
    (tmp_path / "chat.yaml").write_text(yaml.safe_dump(doc))
    d = str(tmp_path)
    monkeypatch.setattr(jax_manager, "EngineConfig", functools.partial(
        JaxEngineConfig, prefix_admit_async_compile=False))
    jm = JaxModelManager(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d))
    jr = JaxRouter()
    JaxOpenAIApi(jm).register(jr)
    js = jax_create_server(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d), jr)
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=d)
    tm = ModelManager(app, device="cpu")
    tr = Router()
    OpenAIApi(tm).register(tr)
    ts = create_server(app, tr)
    bases = {}
    for name, s in (("jax", js), ("port", ts)):
        threading.Thread(target=s.serve_forever, daemon=True).start()
        bases[name] = f"http://127.0.0.1:{s.server_address[1]}"

    def chat(base, messages):
        body = json.dumps({"model": "chat", "messages": messages, "max_tokens": 12,
                           "ignore_eos": True}).encode()
        req = urllib.request.Request(base + "/v1/chat/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read().decode())["choices"][0]["message"]["content"]

    try:
        msgs = [{"role": "system", "content": "You are a terse assistant. " * 3},
                {"role": "user", "content": "name three primes"}]
        turns = {}
        for name, base in bases.items():
            first = chat(base, msgs)
            second = chat(base, msgs + [{"role": "assistant", "content": first},
                                        {"role": "user", "content": "and two more"}])
            turns[name] = (first, second)
        assert turns["port"] == turns["jax"]
        assert tm.get("chat").engine.metrics()["prefix_hits"] >= 1
        assert jm.get("chat").engine.metrics()["prefix_cache_hits"] >= 1
    finally:
        for s in (js, ts):
            s.shutdown()
        jm.shutdown()
        tm.shutdown()
