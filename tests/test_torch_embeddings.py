"""Embeddings and rerank on the llama engine: the port against the JAX
package on the CPU, on the same seeded weights in f32.

- `llama.encode` and `llama.sequence_logprob` on the tiny fixtures (GQA
  with an untied head, a tied head, an int8 head, tiny-moe, tiny-mla),
  within 1e-4; the chunked logprob equals a one-chunk run.
- `Engine.embed` / `Engine.rerank` on dense and paged engines against the
  JAX Engine, truncation at max_seq included; the same call during
  streaming gives the same values as alone, also from more threads than
  cores at once; a dead loop, or one that dies while the call waits,
  raises its death error.
- HTTP: `/v1/embeddings`, `/embeddings`, `/v1/rerank` and `/rerank` on both
  servers give the same statuses and bodies (floats within 1e-4),
  including the 400s and the usecase guard.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.models import llama as jl
from localai_tpu.models import quant as jq
from localai_tpu_torch.engine import engine as eng_mod
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl

# f32 both sides; the two differ in summation order only.
ATOL = 1e-4
TIMEOUT = 120.0


def _variant(name):
    """(cfg, JAX tree, port tree) of one tiny f32 fixture."""
    base = {"gqa": "tiny", "tied": "tiny", "int8_head": "tiny", "moe": "tiny-moe",
            "mla": "tiny-mla"}[name]
    cfg = dataclasses.replace(get_arch(base), dtype="float32",
                              **({"tie_embeddings": True} if name == "tied" else {}))
    jp = jl.init_params(cfg, jax.random.key(0), scale=0.06)
    if name == "int8_head":
        jp = jq.quantize_params(cfg, jp, "int8")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _batch(cfg, S=32, seed=0):
    """Three right-padded rows: full, ragged, one token; rerank conditions."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    lens = np.asarray([S, 9, 1], np.int32)
    conds = np.asarray([5, 3, 0], np.int32)
    return toks, lens, conds


@pytest.mark.parametrize("name", ["gqa", "tied", "int8_head", "moe", "mla"])
def test_encode_and_sequence_logprob_match_jax(name):
    cfg, jp, tp = _variant(name)
    toks, lens, conds = _batch(cfg)
    want_e = np.asarray(jl.encode(cfg, jp, jnp.asarray(toks), jnp.asarray(lens)))
    want_s = np.asarray(jl.sequence_logprob(cfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                                            jnp.asarray(conds)))
    t = [torch.from_numpy(a).long() for a in (toks, lens, conds)]
    got_e = tl.encode(cfg, tp, t[0], t[1]).numpy()
    got_s = tl.sequence_logprob(cfg, tp, *t).numpy()
    assert got_e.dtype == got_s.dtype == np.float32
    np.testing.assert_allclose(got_e, want_e, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got_e, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    assert got_s[2] == 0.0  # a row with nothing to score


def test_chunked_logprob_equals_one_chunk_and_empty_row_pools_to_zero(monkeypatch):
    cfg, _, tp = _variant("gqa")
    toks, lens, conds = _batch(cfg, seed=1)
    t = [torch.from_numpy(a).long() for a in (toks, lens, conds)]
    monkeypatch.setattr(tl, "LOGPROB_CHUNK_ROWS", 10**6)
    one = tl.sequence_logprob(cfg, tp, *t)
    for rows in (1, 7, 256):
        monkeypatch.setattr(tl, "LOGPROB_CHUNK_ROWS", rows)
        np.testing.assert_allclose(tl.sequence_logprob(cfg, tp, *t).numpy(),
                                   one.numpy(), atol=1e-6, rtol=0)
    e = tl.encode(cfg, tp, t[0], torch.tensor([32, 0, 1]))
    assert torch.equal(e[1], torch.zeros_like(e[1]))
    jax_e = jl.encode(cfg, jl.init_params(cfg, jax.random.key(0), scale=0.06),
                      jnp.asarray(toks), jnp.asarray([32, 0, 1]))
    assert float(jnp.abs(jax_e[1]).max()) == 0.0


# --------------------------------------------------------------------------- #
# Engine.embed / Engine.rerank
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


KW = dict(max_slots=2, max_seq=128, min_prefill_bucket=16, block_sizes=(8,))
PAGED = dict(kv_pages=12, kv_page_size=32)
# A row past max_seq (cut to it) and an empty-document rerank.
EMBED_ROWS = [[3, 1, 4, 1, 5], list(range(40, 200)), [9] * 17, [7]]
QUERY = list(range(10, 90))  # longer than (max_seq - 1) // 2: cut to 63
DOCS = [list(range(100, 140)), [], list(range(1, 120)), [5, 6, 7]]


def _engine(tp, cfg, **kw):
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(prefix_cache_entries=0, **{**KW, **kw}))
    eng.start()
    return eng


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_embed_and_rerank_match_jax_engine(weights, paged):
    cfg, jp, tp = weights
    extra = PAGED if paged else {}
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, **KW, **extra))
    teng = _engine(tp, cfg, **extra)
    try:
        want_e, got_e = jeng.embed(EMBED_ROWS), teng.embed(EMBED_ROWS)
        want_r, got_r = jeng.rerank(QUERY, DOCS), teng.rerank(QUERY, DOCS)
    finally:
        teng.stop()
        jeng.stop()
    assert isinstance(got_e, np.ndarray) and got_e.shape == (4, cfg.hidden_size)
    np.testing.assert_allclose(got_e, want_e, atol=ATOL, rtol=0)
    assert got_r.shape == (4,)
    np.testing.assert_allclose(got_r, want_r, atol=ATOL, rtol=0)


def test_embed_and_rerank_during_streaming_equal_alone(weights):
    cfg, _, tp = weights
    eng = _engine(tp, cfg)
    try:
        alone = eng.embed(EMBED_ROWS), eng.rerank(QUERY, DOCS)
        handles = [eng.submit(GenRequest(prompt_ids=[1, 2, 3 + i], max_new_tokens=100,
                                         ignore_eos=True)) for i in range(2)]
        busy = [eng.embed(EMBED_ROWS) for _ in range(3)], eng.rerank(QUERY, DOCS)
        assert any(s is not None for s in eng.slots)  # the streams were still live
        finals = [h.result()[1] for h in handles]
    finally:
        eng.stop()
    assert all(np.array_equal(e, alone[0]) for e in busy[0])
    assert np.array_equal(busy[1], alone[1])
    assert [f.completion_tokens for f in finals] == [100, 100]


def test_many_threads_embed_and_rerank_at_once(weights):
    """More callers than cores, a short switch interval, streams decoding:
    every call gets its own answer (the serial one, exactly) and none
    hangs."""
    cfg, _, tp = weights
    eng = _engine(tp, cfg)
    n = 2 * (os.cpu_count() or 4)
    rows = [[[3 + i, 1, 4 + i % 5] * (1 + i % 4)] for i in range(n)]
    try:
        want = [eng.embed(r) for r in rows]
        want_r = eng.rerank(QUERY, DOCS)
        h = eng.submit(GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=60, ignore_eos=True))
        got: list = [None] * n
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def call(i):
                got[i] = eng.embed(rows[i]) if i % 3 else eng.rerank(QUERY, DOCS)
            threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=TIMEOUT)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        assert h.result()[1].completion_tokens == 60
    finally:
        eng.stop()
    for i in range(n):
        assert np.array_equal(got[i], want[i] if i % 3 else want_r), i


def test_dead_loop_raises_and_a_waiting_call_does_not_hang(weights, monkeypatch):
    cfg, _, tp = weights
    eng = _engine(tp, cfg)
    staged = threading.Event()
    real = eng._service_forks

    def die_once_staged():
        real()
        if eng._jobs:  # an embed waits on this loop: die under it
            staged.set()
            raise RuntimeError("injected")

    monkeypatch.setattr(eng, "_service_forks", die_once_staged)
    try:
        with pytest.raises(RuntimeError, match="engine loop died: RuntimeError: injected"):
            eng.embed(EMBED_ROWS)
        assert staged.is_set() and eng.is_dead
        with pytest.raises(RuntimeError, match="engine loop died"):
            eng.rerank(QUERY, DOCS)
    finally:
        eng.stop()
    with pytest.raises(RuntimeError, match="engine loop died"):
        eng.embed(EMBED_ROWS)  # stopped after its death: still its error


def test_stopped_engine_raises_and_a_failed_call_leaves_the_loop_up(weights, monkeypatch):
    cfg, _, tp = weights
    eng = _engine(tp, cfg)
    try:
        with monkeypatch.context() as m:
            m.setattr(tl, "encode", lambda *a: (_ for _ in ()).throw(ValueError("bad")))
            with pytest.raises(ValueError, match="bad"):
                eng.embed(EMBED_ROWS)
        assert not eng.is_dead
        assert eng.embed([[1, 2]]).shape == (1, cfg.hidden_size)
    finally:
        eng.stop()
    eng.drop_device_state()
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.embed([[1, 2]])


# --------------------------------------------------------------------------- #
# HTTP: the port's server against the JAX server
# --------------------------------------------------------------------------- #

def test_loop_serves_one_call_an_iteration_outside_its_phases(weights):
    cfg, _, tp = weights
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(prefix_cache_entries=0, **KW))
    jobs = [eng_mod._LoopJob(lambda i=i: i) for i in range(2)]
    eng._jobs.extend(jobs)
    assert eng._service_job() and jobs[0].done.is_set() and not jobs[1].done.is_set()
    assert eng._wake.is_set()  # the loop does not sleep on the second call
    assert eng._service_job() and jobs[1].result == 1 and not eng._service_job()
    eng = _engine(tp, cfg)
    try:
        eng._on_loop(lambda: time.sleep(0.3))  # a forward's worth of loop time
        m = eng.metrics()
    finally:
        eng.stop()
    assert m["loop_jobs"] == 1 and m["loop_jobs_ms_total"] >= 300.0
    assert m["loop_host_ms_total"] < 100.0  # not counted as housekeeping


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers on one models dir: `tiny` in f32 written by the JAX
    package, served as an embedder (`embeddings: true`) and as a ranker
    (backend `rerank`); both loaders read it in f32."""
    import localai_tpu.engine.weights as jw
    import localai_tpu_torch.engine.weights as tw
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.engine.weights import save_hf_checkpoint
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu.server.rerank_api import RerankApi as JaxRerankApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.rerank_api import RerankApi

    root = tmp_path_factory.mktemp("emb_models")
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(root / "ckpt"))
    common = {"model": "ckpt", "context_size": 128, "max_slots": 2}
    for doc in ({"name": "embedder", "embeddings": True, **common},
                {"name": "ranker", "backend": "rerank", **common}):
        (root / f"{doc['name']}.yaml").write_text(yaml.safe_dump(doc))
    app = dict(address="127.0.0.1", port=0, models_dir=str(root))
    jm, tm = JaxModelManager(JaxAppConfig(**app)), ModelManager(ApplicationConfig(**app),
                                                                 device="cpu")
    saved = jw.arch_from_hf_config, tw.arch_from_hf_config
    jw.arch_from_hf_config = lambda d: dataclasses.replace(saved[0](d), dtype="float32")
    tw.arch_from_hf_config = lambda d: dataclasses.replace(saved[1](d), dtype="float32")
    try:
        for m in (jm, tm):
            for name in ("embedder", "ranker"):
                assert "float32" in str(m.get(name).engine.params["embed"].dtype)
    finally:
        jw.arch_from_hf_config, tw.arch_from_hf_config = saved
    out = {}
    for side, m, router, api, rr, mk in (
            ("jax", jm, JaxRouter(), JaxOpenAIApi, JaxRerankApi, jax_create_server),
            ("port", tm, Router(), OpenAIApi, RerankApi, create_server)):
        oai = api(m)
        oai.register(router)
        rr(m, oai).register(router)
        srv = mk((JaxAppConfig if side == "jax" else ApplicationConfig)(**app), router)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out[side] = (srv, f"http://127.0.0.1:{srv.server_address[1]}")
    yield {k: v[1] for k, v in out.items()}
    for srv, _ in out.values():
        srv.shutdown()
    jm.shutdown()
    tm.shutdown()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _close(a, b, path="body"):
    """a == b, floats within ATOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= ATOL, (path, a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


CASES = [
    ("/v1/embeddings", {"model": "embedder", "input": "hello world"}),
    ("/embeddings", {"model": "embedder", "input": ["a cat", [1, 2, 3], "", []]}),
    ("/v1/embeddings", {"model": "embedder", "input": "x" * 300}),  # past max_seq: cut
    ("/v1/embeddings", {"model": "embedder", "input": []}),
    ("/v1/embeddings", {"model": "embedder", "input": [3.5]}),
    ("/v1/embeddings", {"model": "ranker", "input": "no embeddings here"}),
    ("/v1/rerank", {"model": "ranker", "query": "what is a cat",
                    "documents": ["cats are small felines", "quantum chromodynamics",
                                  {"text": "dogs bark"}, ""], "top_n": 2}),
    ("/rerank", {"model": "ranker", "query": "q" * 100, "documents": ["d" * 90, "e"]}),
    ("/v1/rerank", {"model": "ranker", "query": "", "documents": ["d"]}),
    ("/v1/rerank", {"model": "ranker", "query": "q", "documents": []}),
    ("/v1/rerank", {"model": "embedder", "query": "q", "documents": ["d"]}),  # usecase guard
    ("/v1/rerank", {"model": "nope", "query": "q", "documents": ["d"]}),
]


@pytest.mark.parametrize("path, payload", CASES, ids=[f"{i}{p}" for i, (p, _) in enumerate(CASES)])
def test_routes_give_the_jax_servers_status_and_body(servers, path, payload):
    js, jb = _post(servers["jax"], path, payload)
    ts, tb = _post(servers["port"], path, payload)
    assert ts == js, (tb, jb)
    if js == 200:
        _close(tb, jb)
        if "results" in tb:
            assert [r["index"] for r in tb["results"]] == [r["index"] for r in jb["results"]]
    else:
        assert tb["error"]["message"] == jb["error"]["message"]


@pytest.mark.parametrize("ids", [[-1], [5, 512], [10**12]])
def test_out_of_range_token_ids_are_refused(servers, ids):
    """A token id past the embedding table answers 400 on the port (it
    would fault the card); the JAX server clamps the gather and answers."""
    status, body = _post(servers["port"], "/v1/embeddings", {"model": "embedder", "input": [ids]})
    assert status == 400 and "[0, 512)" in body["error"]["message"]

