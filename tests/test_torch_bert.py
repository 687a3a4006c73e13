"""The `bert` backend: the port's BERT encoder, engine and server routes
against the JAX package's on the CPU, on the same seeded f32 weights.

- `embed` (cls and mean pooling) and `score_pairs` on the `bert-test` /
  `bert-rerank-test` presets, within 1e-5;
- a checkpoint written by the JAX package's `save_hf_bert` loads in the
  port (config and tensors) and gives the same outputs; the port's writer
  round-trips through the JAX loader; the `bert.`-prefixed layout loads;
- `BertEngine.embed` / `rerank` against the JAX BertEngine, with and
  without the tokenizer's cls / sep ids, truncation at max_position;
- over HTTP: a bert embedder and a cross-encoder give the JAX server's
  statuses and bodies on `/v1/embeddings` and `/v1/rerank` (floats within
  1e-4, the usecase guard and a head-less model's error included); the
  manager's supervision surfaces (/system, /backend/monitor, the
  watchdog, eviction) work on a bert model; a preset loads.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from localai_tpu.engine.bert_engine import BertEngine as JaxBertEngine
from localai_tpu.models import bert as jb
from localai_tpu_torch.engine.bert_engine import BertEngine
from localai_tpu_torch.engine.weights import write_safetensors_f32
from localai_tpu_torch.models import bert as tb

ATOL = 1e-5  # f32 both sides, summation order only
HTTP_ATOL = 1e-4


def _trees(name, seed=0, **kw):
    cfg = dataclasses.replace(jb.BERT_PRESETS[name], **kw)
    jp = jb.init_params(cfg, jax.random.key(seed), scale=0.2)
    return cfg, jp, tb.bert_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _rows(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.asarray([16, 5, 1], np.int32)
    types = (np.arange(16)[None, :] >= np.asarray([[8], [2], [0]])).astype(np.int32)
    return toks, lens, types


def _port_cfg(cfg):
    return tb.BertConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name, pooling", [("bert-test", "cls"), ("bert-test", "mean"),
                                           ("bert-rerank-test", "cls")])
def test_embed_and_score_pairs_match_jax(name, pooling):
    cfg, jp, tp = _trees(name, pooling=pooling)
    toks, lens, types = _rows(cfg)
    pc = _port_cfg(cfg)
    t = [torch.from_numpy(a).long() for a in (toks, lens, types)]
    want = np.asarray(jb.embed(cfg, jp, jnp.asarray(toks), jnp.asarray(lens)))
    got = tb.embed(pc, tp, t[0], t[1]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    if cfg.num_labels:
        want_s = np.asarray(jb.score_pairs(cfg, jp, *(jnp.asarray(a) for a in (toks, lens, types))))
        np.testing.assert_allclose(tb.score_pairs(pc, tp, *t).numpy(), want_s, atol=ATOL, rtol=0)
    else:
        with pytest.raises(ValueError, match="classification head"):
            tb.score_pairs(pc, tp, *t)


def test_init_params_builds_the_jax_tree():
    for name in ("bert-test", "bert-rerank-test"):
        cfg = jb.BERT_PRESETS[name]
        want = jax.tree_util.tree_flatten_with_path(jb.init_params(cfg, jax.random.key(0)))[0]
        got = jax.tree_util.tree_flatten_with_path(
            tb.init_params(tb.BERT_PRESETS[name], seed=0, device="cpu"))[0]
        assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p)
                                                              for p, _ in want]
        assert all(tuple(g.shape) == w.shape and g.dtype == torch.float32
                   for (_, g), (_, w) in zip(got, want))
    assert tb.BERT_PRESETS == {k: _port_cfg(v) for k, v in jb.BERT_PRESETS.items()}


def test_checkpoints_cross_between_the_packages(tmp_path):
    cfg, jp, tp = _trees("bert-rerank-test", seed=1)
    toks, lens, types = _rows(cfg, seed=2)
    want = np.asarray(jb.score_pairs(cfg, jp, *(jnp.asarray(a) for a in (toks, lens, types))))
    t = [torch.from_numpy(a).long() for a in (toks, lens, types)]
    # JAX writer → port loader
    jb.save_hf_bert(cfg, jp, str(tmp_path / "j"))
    pc = tb.bert_config_from_hf(str(tmp_path / "j"))
    assert pc == dataclasses.replace(_port_cfg(cfg), name="bert")
    lp = tb.load_hf_bert(pc, str(tmp_path / "j"), device="cpu")
    np.testing.assert_allclose(tb.score_pairs(pc, lp, *t).numpy(), want, atol=ATOL, rtol=0)
    # port writer → JAX loader
    tb.save_hf_bert(pc, tp, str(tmp_path / "t"))
    jc = jb.bert_config_from_hf(str(tmp_path / "t"))
    assert jc == dataclasses.replace(cfg, name="bert")
    back = jb.load_hf_bert(jc, str(tmp_path / "t"))
    got = jb.score_pairs(jc, back, *(jnp.asarray(a) for a in (toks, lens, types)))
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL, rtol=0)
    # the `bert.`-prefixed layout (BertForSequenceClassification), no pooler
    from localai_tpu_torch.engine.weights import _ShardReader

    r = _ShardReader(str(tmp_path / "t"))
    tensors = {(n if n.startswith("classifier") else "bert." + n): r.get(n).numpy()
               for n in r.weight_map if not n.startswith("pooler")}
    os.makedirs(tmp_path / "p")
    write_safetensors_f32(str(tmp_path / "p" / "model.safetensors"), tensors)
    with open(tmp_path / "p" / "config.json", "w") as f:
        hf = json.load(open(tmp_path / "t" / "config.json"))
        hf.pop("num_labels")
        json.dump({**hf, "architectures": ["BertForSequenceClassification"],
                   "id2label": {"0": "LABEL_0"}}, f)
    pp = tb.load_hf_bert(tb.bert_config_from_hf(str(tmp_path / "p")), str(tmp_path / "p"),
                         device="cpu")
    assert torch.equal(pp["pooler_w"], torch.eye(cfg.hidden_size))
    assert torch.equal(pp["cls_w"], lp["cls_w"]) and torch.equal(pp["layers"]["q_w"],
                                                                   lp["layers"]["q_w"])


class _SpecialTok:
    """A tokenizer with the cls / sep ids BertEngine.rerank reads."""
    cls_id, sep_id = 101, 102


@pytest.mark.parametrize("tok", [None, _SpecialTok()], ids=["bytes", "cls_sep"])
def test_bert_engine_matches_jax_engine(tok):
    cfg, jp, tp = _trees("bert-rerank-test", seed=3)
    jeng, teng = JaxBertEngine(cfg, jp, tok), BertEngine(_port_cfg(cfg), tp, tok)
    rows = [[5, 6, 7], list(range(200)), [9] * 20]  # 200 > max_position: cut to 128
    np.testing.assert_allclose(teng.embed(rows), jeng.embed(rows), atol=ATOL, rtol=0)
    query, docs = list(range(1, 90)), [list(range(10, 60)), [], [3] * 130]
    np.testing.assert_allclose(teng.rerank(query, docs), jeng.rerank(query, docs),
                               atol=ATOL, rtol=0)
    assert teng.metrics()["requests"] == 2.0
    teng.drop_device_state()
    with pytest.raises(RuntimeError, match="unloaded"):
        teng.embed(rows)


# --------------------------------------------------------------------------- #
# HTTP and the manager
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers on one models dir: a bert embedder and a cross-encoder
    written by the JAX package, a head-less model named as a reranker, and
    a preset the port draws itself."""
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu.server.rerank_api import RerankApi as JaxRerankApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.rerank_api import RerankApi

    root = tmp_path_factory.mktemp("bert_models")
    for name, seed, ckpt in (("bert-test", 4, "embedder"), ("bert-rerank-test", 5, "ranker")):
        cfg, jp, _ = _trees(name, seed=seed)
        jb.save_hf_bert(cfg, jp, str(root / ckpt))
    for doc in ({"name": "bge", "backend": "bert", "model": "embedder"},
                {"name": "bge-reranker", "backend": "bert", "model": "ranker"},
                {"name": "plain-reranker", "backend": "bert", "model": "embedder"},
                {"name": "preset-bert", "backend": "bert", "model": "bge-small"}):
        (root / f"{doc['name']}.yaml").write_text(yaml.safe_dump(doc))
    app = dict(address="127.0.0.1", port=0, models_dir=str(root))
    jm, tm = JaxModelManager(JaxAppConfig(**app)), ModelManager(ApplicationConfig(**app),
                                                                 device="cpu")
    out = {}
    for side, m, router, api, rr, mk, acfg in (
            ("jax", jm, JaxRouter(), JaxOpenAIApi, JaxRerankApi, jax_create_server,
             JaxAppConfig),
            ("port", tm, Router(), OpenAIApi, RerankApi, create_server, ApplicationConfig)):
        oai = api(m)
        oai.register(router)
        rr(m, oai).register(router)
        srv = mk(acfg(**app), router)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out[side] = (srv, f"http://127.0.0.1:{srv.server_address[1]}")
    yield {**{k: v[1] for k, v in out.items()}, "port_manager": tm}
    for srv, _ in out.values():
        srv.shutdown()
    jm.shutdown()
    tm.shutdown()


def _call(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _close(a, b, path="body"):
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= HTTP_ATOL, (path, a, b)
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
    ("/v1/embeddings", {"model": "bge", "input": ["a cat", [1, 2, 3], "x" * 300]}),
    ("/embeddings", {"model": "bge-reranker", "input": "embeds through the same stack"}),
    ("/v1/rerank", {"model": "bge-reranker", "query": "what is a cat",
                    "documents": ["cats are small felines", "quantum chromodynamics",
                                  {"text": "dogs bark"}], "top_n": 2}),
    ("/rerank", {"model": "bge-reranker", "query": "q" * 100, "documents": ["d" * 90, ""]}),
    ("/v1/rerank", {"model": "bge", "query": "q", "documents": ["d"]}),  # usecase guard
    ("/v1/rerank", {"model": "plain-reranker", "query": "q", "documents": ["d"]}),  # no head
    ("/v1/chat/completions", {"model": "bge", "messages": [{"role": "user", "content": "hi"}]}),
]


@pytest.mark.parametrize("path, payload", CASES, ids=[f"{i}{p}" for i, (p, _) in enumerate(CASES)])
def test_bert_routes_give_the_jax_servers_status_and_body(servers, path, payload):
    js, jbody = _call(servers["jax"], path, payload)
    ts, tbody = _call(servers["port"], path, payload)
    assert ts == js, (tbody, jbody)
    if js == 200:
        _close(tbody, jbody)
    else:
        assert tbody["error"]["message"] == jbody["error"]["message"]


def test_supervision_surfaces_serve_a_bert_model(servers):
    base, tm = servers["port"], servers["port_manager"]
    st, body = _call(base, "/v1/embeddings", {"model": "preset-bert", "input": "hello"})
    assert st == 200 and len(body["data"][0]["embedding"]) == tb.BERT_PRESETS["bge-small"].hidden_size
    assert abs(np.linalg.norm(body["data"][0]["embedding"]) - 1.0) < 1e-5
    st, sysinfo = _call(base, "/system")
    assert st == 200 and sysinfo["backends"]["preset-bert"]["requests"] == 1.0
    st, mon = _call(base, "/backend/monitor", {"model": "preset-bert"})
    assert st == 200 and mon["metrics"]["requests"] == 1.0
    assert mon["supervision"]["restarts_total"] == 0
    eng = tm.peek("preset-bert").engine
    tm._watchdog_tick()  # no idle / busy limits set: nothing happens
    assert tm.peek("preset-bert") is not None
    st, _ = _call(base, "/backend/shutdown", {"model": "preset-bert"})
    assert st == 200
    for _ in range(100):  # eviction tears the engine down on a thread
        if eng.params is None:
            break
        threading.Event().wait(0.05)
    assert eng.params is None and tm.peek("preset-bert") is None
