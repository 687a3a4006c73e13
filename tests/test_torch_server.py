"""The port's HTTP server against the JAX package's on the CPU: one models
dir (a `tiny` f32 checkpoint written by the JAX package, a plain model, a
chatml-template model, a virtual model with a LoRA adapter, and a virtual
model on a base that merges adapters), both servers on ephemeral ports,
the same request JSON to each. Greedy content bytes, finish reasons and
usage counts match; so do the model list and the status codes of errors.
Tools, legacy functions, tool_choice, JSON response formats and GBNF
grammars give the JAX server's statuses, content bytes, finish reasons and
tool calls, whole and streamed. Chat and completions logprobs (whole and
streamed), best_of ranking and its errors, `deadline_s` on a saturated
model, /v1/tokenize and /v1/edits give the JAX server's JSON (logprobs
within 1e-4). Image content on a model without a tower is ignored, as the
JAX server ignores it. Every server knob group the port has not ported fails
the server's startup naming its ROADMAP item, or warns; the
bounded-admission, fork and observability knobs reach the engine. Last, `python -m
localai_tpu_torch run --device cpu` starts and answers /readyz."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest
import yaml

from localai_tpu.config import ApplicationConfig as JaxAppConfig
from localai_tpu.engine.weights import save_hf_checkpoint
from localai_tpu.models import llama as jl
from localai_tpu.server import ModelManager as JaxModelManager
from localai_tpu.server import Router as JaxRouter
from localai_tpu.server import create_server as jax_create_server
from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.functions.jsonschema import tool_call_schema
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

from test_torch_lora_engine import make_adapter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models_dir(root):
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(root / "ckpt"))
    make_adapter(root / "adapters" / "t0", cfg, seed=1, mods=("q", "v", "o", "down"))
    make_adapter(root / "adapters" / "t1", cfg, seed=2)
    common = {"context_size": 128, "max_slots": 4, "max_tokens": 12, "temperature": 0.0}
    docs = [
        {"name": "tiny-plain", "model": "ckpt", **common},
        {"name": "tiny-chatml", "model": "ckpt", "template": {"family": "chatml"}, **common},
        {"name": "tenant", "base_model": "tiny-plain", "adapter": "adapters/t0", **common},
        {"name": "merged-base", "model": "ckpt", "lora_adapters": ["adapters/t1"], **common},
        {"name": "tenant-on-merged", "base_model": "merged-base", "adapter": "adapters/t0",
         **common},
        # Room for a tools prompt (a byte a token) and a whole call.
        {"name": "tiny-long", "model": "ckpt", **common, "context_size": 1024},
    ]
    for d in docs:
        (root / f"{d['name']}.yaml").write_text(yaml.safe_dump(d))
    return str(root)


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = _models_dir(tmp_path_factory.mktemp("models"))
    jm = JaxModelManager(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d))
    jr = JaxRouter()
    JaxOpenAIApi(jm).register(jr)
    js = jax_create_server(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d), jr)
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=d)
    tm = ModelManager(app, device="cpu")
    tr = Router()
    OpenAIApi(tm).register(tr)
    ts = create_server(app, tr)
    yield {"jax": _serve(js), "port": _serve(ts), "dir": d, "port_manager": tm,
           "jax_manager": jm}
    for s in (js, ts):
        s.shutdown()
    jm.shutdown()
    tm.shutdown()


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """Both servers on one f32 model (`tiny` as saved, loaded in f32 on
    both sides: the loaders' arch is widened while the engines load), so
    logprobs agree within 1e-4."""
    import localai_tpu.engine.weights as jw
    import localai_tpu_torch.engine.weights as tw

    root = tmp_path_factory.mktemp("models_f32")
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(root / "ckpt"))
    (root / "tiny-f32.yaml").write_text(yaml.safe_dump(
        {"name": "tiny-f32", "model": "ckpt", "context_size": 2048, "max_slots": 4,
         "max_tokens": 12, "temperature": 0.0}))
    app = dict(address="127.0.0.1", port=0, models_dir=str(root))
    jm, tm = JaxModelManager(JaxAppConfig(**app)), ModelManager(ApplicationConfig(**app),
                                                                 device="cpu")
    saved = jw.arch_from_hf_config, tw.arch_from_hf_config
    jw.arch_from_hf_config = lambda d: dataclasses.replace(saved[0](d), dtype="float32")
    tw.arch_from_hf_config = lambda d: dataclasses.replace(saved[1](d), dtype="float32")
    try:
        for m in (jm, tm):
            assert "float32" in str(m.get("tiny-f32").engine.params["embed"].dtype)
    finally:
        jw.arch_from_hf_config, tw.arch_from_hf_config = saved
    jr, tr = JaxRouter(), Router()
    JaxOpenAIApi(jm).register(jr)
    OpenAIApi(tm).register(tr)
    js = jax_create_server(JaxAppConfig(**app), jr)
    ts = create_server(ApplicationConfig(**app), tr)
    yield {"jax": _serve(js), "port": _serve(ts), "jax_manager": jm, "port_manager": tm}
    for srv in (js, ts):
        srv.shutdown()
    jm.shutdown()
    tm.shutdown()


def _call(base, path, payload=None):
    """(status, parsed JSON or raw SSE text)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            raw = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read().decode(), e.code
    if raw.startswith("data: "):
        return status, raw
    return status, json.loads(raw)


def _sse(raw):
    frames = [f[len("data: "):] for f in raw.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


CHAT = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 12,
        "ignore_eos": True}


@pytest.mark.parametrize("path, payload", [
    ("/v1/chat/completions", {"model": "tiny-plain", **CHAT}),
    ("/v1/chat/completions", {"model": "tiny-chatml", **CHAT}),
    ("/v1/chat/completions", {"model": "tenant", **CHAT}),
    ("/v1/completions", {"model": "tiny-plain", "prompt": "once upon", "max_tokens": 10,
                         "ignore_eos": True}),
    ("/v1/completions", {"model": "tenant", "prompt": ["a b", "c d e"], "max_tokens": 6,
                         "stop": ["zz"]}),
], ids=["chat", "chat-chatml", "chat-virtual", "completion", "completion-virtual-2"])
def test_greedy_responses_match_jax_server(servers, path, payload):
    js, jbody = _call(servers["jax"], path, payload)
    ts, tbody = _call(servers["port"], path, payload)
    assert js == ts == 200, (jbody, tbody)
    key = "message" if "chat" in path else "text"
    want = [(c[key]["content"] if key == "message" else c[key], c["finish_reason"])
            for c in jbody["choices"]]
    got = [(c[key]["content"] if key == "message" else c[key], c["finish_reason"])
           for c in tbody["choices"]]
    assert got == want
    assert tbody["usage"] == jbody["usage"]
    assert tbody["model"] == jbody["model"] == payload["model"]


def test_streamed_chat_matches_jax_server(servers):
    payload = {"model": "tenant", "stream": True, **CHAT}
    out = {}
    for side in ("jax", "port"):
        status, raw = _call(servers[side], "/v1/chat/completions", payload)
        assert status == 200
        chunks = _sse(raw)
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        out[side] = (text, chunks[-1]["choices"][0]["finish_reason"], chunks[-1]["usage"])
    assert out["port"] == out["jax"]


def test_virtual_model_is_not_the_base(servers):
    base = _call(servers["port"], "/v1/chat/completions", {"model": "tiny-plain", **CHAT})[1]
    tenant = _call(servers["port"], "/v1/chat/completions", {"model": "tenant", **CHAT})[1]
    assert base["choices"][0]["message"] != tenant["choices"][0]["message"]
    tm = servers["port_manager"]
    eng = tm.peek("tiny-plain").engine
    assert eng.adapter_names() == ["tenant"]
    assert not eng._adapter_refs.any()  # every pin released after the requests


def test_model_list_and_error_statuses_match(servers):
    ids = {}
    for side in ("jax", "port"):
        status, body = _call(servers[side], "/v1/models")
        assert status == 200
        ids[side] = sorted(m["id"] for m in body["data"])
    assert ids["port"] == ids["jax"]
    for payload in ({"model": "nope", **CHAT}, {"model": "tenant-on-merged", **CHAT}):
        statuses = {side: _call(servers[side], "/v1/chat/completions", payload)[0]
                    for side in ("jax", "port")}
        assert statuses["port"] == statuses["jax"] in (400, 404), payload["model"]
    assert _call(servers["port"], "/v1/models/tenant")[0] == 200
    assert _call(servers["port"], "/v1/models/nope")[0] == 404


TOOLS = [{"type": "function", "function": {"name": "f"}},
         {"type": "function", "function": {"name": "get_weather", "parameters": {
             "type": "object", "properties": {"unit": {"enum": ["c", "f"]}},
             "required": ["unit"]}}}]
# Whitespace tokens held back, so a constrained reply reaches its end.
NO_WS = {"logit_bias": {str(t): -100 for t in (9, 10, 13, 32)}}


def _schema(payload):
    """The schema the servers constrain a chat payload to, or None."""
    if payload.get("grammar"):
        return {"__gbnf__": payload["grammar"]}
    choice = payload.get("tool_choice")
    if choice == "required":
        return tool_call_schema(payload["tools"])
    if isinstance(choice, dict):
        return tool_call_schema([t for t in payload["tools"]
                                 if t["function"]["name"] == choice["function"]["name"]])
    rf = payload.get("response_format") or {}
    if rf.get("type") == "json_object":
        return {"type": "object"}
    return None


def _reply(status, body, stream):
    """(content, finish_reason, [(tool name, arguments)], usage) of a reply."""
    if status != 200:
        return status
    if not stream:
        c = body["choices"][0]
        key = "message" if "message" in c else None
        text = c["message"]["content"] if key else c["text"]
        calls = [(t["function"]["name"], json.loads(t["function"]["arguments"]))
                 for t in (c["message"].get("tool_calls") or [])] if key else []
        return text, c["finish_reason"], calls, body["usage"]
    chunks = _sse(body)
    text, calls = "", []
    for ch in chunks:
        d = ch["choices"][0].get("delta", ch["choices"][0])
        text += d.get("content") or d.get("text") or ""
        calls += [(t["function"]["name"], json.loads(t["function"]["arguments"]))
                  for t in d.get("tool_calls") or []]
    return text, chunks[-1]["choices"][0]["finish_reason"], calls, chunks[-1]["usage"]


@pytest.mark.parametrize("path, extra", [
    ("/v1/chat/completions", {"tools": TOOLS[:1]}),
    ("/v1/chat/completions", {"functions": [{"name": "f"}]}),
    ("/v1/chat/completions", {"grammar": 'root ::= "a" [a-z]*'}),
    ("/v1/chat/completions", {"response_format": {"type": "json_object"}, **NO_WS}),
    ("/v1/chat/completions", {"tools": TOOLS[1:], "tool_choice": "required", "stream": True,
                              **NO_WS}),
    ("/v1/chat/completions", {"tools": TOOLS, "tool_choice": {
        "type": "function", "function": {"name": "get_weather"}}, **NO_WS}),
    ("/v1/chat/completions", {"tools": TOOLS, "tool_choice": {
        "type": "function", "function": {"name": "nope"}}}),
    ("/v1/chat/completions", {"grammar": 'root ::= "a'}),
    ("/v1/completions", {"grammar": 'root ::= [0-9]+ "." [0-9]'}),
], ids=["tools", "functions", "grammar", "response_format", "tools-required-stream",
        "tool-choice-named", "tool-choice-unknown", "grammar-malformed", "completion-grammar"])
def test_tools_and_grammar_match_jax_server(servers, path, extra):
    model = "tiny-long" if extra.get("tool_choice") else "tiny-plain"
    payload = {"model": model, **(CHAT if "chat" in path else {"prompt": "x"}),
               "max_tokens": 96 if model == "tiny-long" else 48, **extra}
    schema = _schema(payload)
    if schema is not None:
        # Both engines serve the schema the same way: from its compiled DFA
        # (an uncached one would host-walk on whichever side had not built
        # it yet), or, a schema with no DFA ({"type": "object"}), by the
        # host walk on both.
        dfa = set()
        for side in ("jax", "port"):
            _call(servers[side], path, {"model": model, "prompt": "x", "max_tokens": 1,
                                        "messages": CHAT["messages"]})
            dfa.add(servers[f"{side}_manager"].peek(model).engine.prewarm_grammar(schema))
        assert len(dfa) == 1
    out = {side: _reply(*_call(servers[side], path, payload), payload.get("stream"))
           for side in ("jax", "port")}
    assert out["port"] == out["jax"], out
    if "nope" in json.dumps(extra) or extra.get("grammar") == 'root ::= "a':
        assert out["port"] == 400
    else:
        assert out["port"][1] in ("stop", "length", "tool_calls")
    if model == "tiny-long" and "nope" not in json.dumps(extra):
        # A call's schema is short and closed: the reply is a whole call.
        assert out["port"][1] == "tool_calls" and out["port"][2]
        assert all(n == "get_weather" and a in ({"unit": "c"}, {"unit": "f"})
                   for n, a in out["port"][2]), out["port"][2]


@pytest.mark.parametrize("path, extra, field", [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}]}]},
     "image content"),
])
def test_unported_fields_are_rejected(servers, path, extra, field):
    """No field is refused any longer: image content, the last, is served
    since vision chat was ported, as the JAX server serves it on a model
    without a tower (the image ignored; one that does not decode,
    skipped): the same status, choices and usage."""
    payload = {"model": "tiny-plain", **(CHAT if "chat" in path else {"prompt": "x"}), **extra}
    status, body = _call(servers["port"], path, payload)
    jstatus, jbody = _call(servers["jax"], path, payload)
    assert status == jstatus == 200, (field, body, jbody)
    assert (body["choices"], body["usage"]) == (jbody["choices"], jbody["usage"])


def _close(a, b, path="$"):
    """Equal JSON, floats within 1e-4."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-4, (path, a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _choices(body, stream):
    """The choices of a reply (a stream's chunks' choices, in order), with
    what differs between the servers by design dropped: ids, times."""
    if not stream:
        return body["choices"], body["usage"]
    chunks = _sse(body)
    return [c for ch in chunks for c in ch["choices"]], chunks[-1]["usage"]


@pytest.mark.parametrize("path, extra", [
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 5}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 5, "stream": True}),
    ("/v1/chat/completions", {"logprobs": True}),
    ("/v1/completions", {"logprobs": 3}),
    ("/v1/completions", {"logprobs": 3, "stream": True, "echo": True}),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 21}),
    ("/v1/completions", {"logprobs": 21}),
], ids=["chat", "chat-stream", "chat-top-default", "completion", "completion-stream",
        "chat-top-21", "completion-21"])
def test_logprobs_match_jax_server(f32, path, extra):
    servers = f32
    payload = {"model": "tiny-f32", **(CHAT if "chat" in path else {
        "prompt": "once upon", "max_tokens": 8, "ignore_eos": True}), **extra}
    out = {}
    for side in ("jax", "port"):
        status, body = _call(servers[side], path, payload)
        out[side] = status if status != 200 else _choices(body, extra.get("stream"))
    if isinstance(out["jax"], int):
        assert out["port"] == out["jax"] == 400
        return
    _close(out["port"], out["jax"])
    choices = out["port"][0]
    lps = [c["logprobs"] for c in choices if c.get("logprobs")]
    assert lps, choices
    if "chat" in path:
        tops = [e["top_logprobs"] for lp in lps for e in lp["content"]]
        assert tops and all(len(t) == extra.get("top_logprobs", 1) for t in tops)
    else:
        # A map by token text: ids with one text (bytes of no character) merge.
        assert all(1 <= len(t) <= 3 for lp in lps for t in lp["top_logprobs"])


@pytest.mark.parametrize("path, payload", [
    ("/v1/chat/completions", {"n": 2, "best_of": 3, "logprobs": True, "top_logprobs": 2}),
    ("/v1/completions", {"n": 1, "best_of": 3, "prompt": ["a b", "c d"], "logprobs": 1}),
], ids=["chat", "completion-2-prompts"])
def test_greedy_best_of_matches_jax_server(f32, path, payload):
    """Greedy best_of: every branch ties, so the first n in submission
    order; choices, logprobs and usage (over every branch) as the JAX
    server's."""
    body = {"model": "tiny-f32", **(CHAT if "chat" in path else {"max_tokens": 8,
                                                                  "ignore_eos": True}),
            **payload}
    out = {}
    for side in ("jax", "port"):
        status, reply = _call(f32[side], path, body)
        assert status == 200, reply
        out[side] = (reply["choices"], reply["usage"])
    _close(out["port"], out["jax"])
    groups = len(payload.get("prompt", [0]))
    assert len(out["port"][0]) == payload["n"] * groups
    assert out["port"][1]["completion_tokens"] == payload["best_of"] * groups * body["max_tokens"]


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/completions"])
def test_seeded_best_of_returns_the_top_ranked_branches(f32, path):
    """best_of 4, n 2 (seeds 5..8, one per branch) returns the two branches
    of n 4 (the same seeds) with the highest cumulative logprob, in rank
    order. (The port's sampling noise is not the JAX package's threefry
    stream, so seeded bytes are held to the port's own branches.)"""
    body = {"model": "tiny-f32", **(CHAT if "chat" in path else {
        "prompt": "once upon", "max_tokens": 8, "ignore_eos": True}),
        "temperature": 0.9, "seed": 5}
    key = "message" if "chat" in path else "text"

    def text(c):
        return c["message"]["content"] if key == "message" else c["text"]

    status, best = _call(f32["port"], path, {**body, "n": 2, "best_of": 4})
    assert status == 200, best
    status, every = _call(f32["port"], path, {**body, "n": 4, "logprobs": True}
                          if "chat" in path else {**body, "n": 4, "logprobs": 1})
    assert status == 200, every

    def score(c):
        lp = c["logprobs"]
        return sum(e["logprob"] for e in lp["content"]) if "content" in lp \
            else sum(lp["token_logprobs"])

    ranked = sorted(range(4), key=lambda i: (-score(every["choices"][i]), i))
    assert [text(c) for c in best["choices"]] == [text(every["choices"][i])
                                                  for i in ranked[:2]]
    assert len({text(c) for c in every["choices"]}) > 1  # the seeds gave different branches
    assert best["usage"] == every["usage"]


@pytest.mark.parametrize("payload", [
    {"best_of": 3, "n": 2, "stream": True},
    {"best_of": 1, "n": 2},
    {"best_of": 65},
    {"best_of": "x"},
], ids=["stream", "below-n", "above-64", "not-int"])
def test_best_of_errors_match_jax_server(servers, payload):
    body = {"model": "tiny-plain", **CHAT, **payload}
    out = {side: _call(servers[side], "/v1/chat/completions", body)
           for side in ("jax", "port")}
    assert out["port"][0] == out["jax"][0] == 400
    assert out["port"][1]["error"]["message"] == out["jax"][1]["error"]["message"]


def test_tokenize_and_edits_match_jax_server(servers):
    for path, payload in (("/v1/tokenize", {"content": "hello there, world"}),
                          ("/tokenize", {"content": "abc"}),
                          ("/v1/edits", {"instruction": "fix it", "input": "helo",
                                         "max_tokens": 6, "ignore_eos": True}),
                          ("/edits", {"instruction": "", "input": "x"})):
        out = {}
        for side in ("jax", "port"):
            status, body = _call(servers[side], path, {"model": "tiny-plain", **payload})
            body.pop("created", None)
            out[side] = (status, body)
        assert out["port"] == out["jax"], path
        assert out["port"][0] == (400 if not payload.get("instruction", "x") else 200)


def test_deadline_on_a_saturated_model_matches_jax_server(f32):
    """Every slot busy: a request whose body carries deadline_s is shed from
    the queue with the engine's error, which names deadline_s."""
    from localai_tpu.engine.engine import GenRequest as JaxGenRequest
    from localai_tpu_torch.engine.engine import GenRequest

    servers, out = f32, {}
    for side, gen in (("jax", JaxGenRequest), ("port", GenRequest)):
        eng = servers[f"{side}_manager"].get("tiny-f32").engine
        busy = [eng.submit(gen(prompt_ids=[1, 2, 3], max_new_tokens=100_000, ignore_eos=True))
                for _ in range(4)]
        try:
            status, body = _call(servers[side], "/v1/chat/completions",
                                 {"model": "tiny-f32", **CHAT, "deadline_s": 0.3})
        finally:
            eng.cancel_all()
            for h in busy:
                list(h)
        out[side] = (status, body["error"]["message"].split(" after ")[0],
                     "(deadline_s)" in body["error"]["message"])
    assert out["port"] == out["jax"] == (500, "deadline exceeded", True)


def _knob_manager(root, doc, **app):
    (root / "m.yaml").write_text(yaml.safe_dump({
        "name": "m", "model": "tiny", "context_size": 128, "max_slots": 2, **doc}))
    return ModelManager(ApplicationConfig(models_dir=str(root), **app), device="cpu")


@pytest.mark.parametrize("doc, app, expect", [
    ({"queue_timeout_s": 2.5, "deadline_s": 5.0, "fork_sampling": False, "kv_pages": 8,
      "kv_page_size": 16}, {}, "wired"),
    ({"draft_model": "tiny"}, {}, "spec"),
    ({"spec_mode": "prompt_lookup"}, {}, "spec"),
    ({"n_draft": 3}, {}, "spec"),
    ({"trace_journal_events": 128}, {}, "reaches"),
    ({}, {"postmortem_dir": "/tmp/pm"}, "reaches"),
    ({}, {"cluster_replicas": 2}, "item 12, cluster"),
    ({}, {"cluster_peers": ["http://h:1"]}, "item 12, cluster"),
    ({"tensor_parallel": 2}, {}, "warn tensor_parallel=2"),
    ({"sp_prefill": False}, {}, "warn sp_prefill=False"),
], ids=["wired", "draft_model", "spec_mode", "n_draft", "trace_journal", "postmortem_dir",
        "cluster_replicas", "cluster_peers", "tensor_parallel", "sp_prefill"])
def test_no_yaml_knob_is_dropped_in_silence(tmp_path, caplog, doc, app, expect):
    from localai_tpu_torch.server.manager import UnsupportedBackendError

    if app and expect.startswith("item"):
        with pytest.raises(UnsupportedBackendError, match=expect):
            _knob_manager(tmp_path, doc, **app)
        return
    tm = _knob_manager(tmp_path, doc, **app)
    try:
        if expect.startswith("item"):
            with pytest.raises(UnsupportedBackendError, match=expect):
                tm.get("m")
            return
        with caplog.at_level("WARNING", logger="localai_tpu_torch.manager"):
            eng = tm.get("m").engine
            ecfg = eng.ecfg
        if expect == "spec":
            # The speculative knobs reach the engine: the mode, n_draft and
            # (from a preset) the draft model.
            mode = doc.get("spec_mode", "draft_model" if "draft_model" in doc else "off")
            assert (ecfg.spec_mode, eng._spec_mode) == (doc.get("spec_mode", "auto"), mode)
            assert eng.n_draft == doc.get("n_draft", 5)
            assert eng._spec_buckets == tuple(sorted({0, eng.n_draft // 2, eng.n_draft}))
            assert (eng.draft_cfg.name if eng.draft_cfg else None) == doc.get("draft_model")
            assert not [r for r in caplog.records if r.levelname == "WARNING"]
            return
        if expect == "reaches":
            # The observability knobs reach the engine: the model's journal
            # capacity, the server's postmortem directory.
            assert ecfg.trace_journal_events == doc.get("trace_journal_events", 4096)
            assert eng.journal.capacity == ecfg.trace_journal_events
            assert ecfg.postmortem_dir == app.get("postmortem_dir", "")
            assert not [r for r in caplog.records if r.levelname == "WARNING"]
        elif expect == "wired":
            assert (ecfg.queue_timeout_s, ecfg.deadline_s, ecfg.fork_sampling) == (2.5, 5.0,
                                                                                  False)
            assert not [r for r in caplog.records if r.levelname == "WARNING"]
        else:
            knob = expect.split(" ", 1)[1]
            msgs = [r.getMessage() for r in caplog.records if knob in r.getMessage()]
            assert len(msgs) == 1 and "item 14, multi-GPU" in msgs[0], msgs
    finally:
        tm.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_run_starts_and_answers_readyz(servers):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("LOCALAI_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "localai_tpu_torch", "run", "--device", "cpu",
         "--address", "127.0.0.1", "--port", str(port), "--models-path", servers["dir"]],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "server did not come up in 120 s"
                time.sleep(0.2)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=5) as r:
            assert "tenant" in {m["id"] for m in json.loads(r.read())["data"]}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
