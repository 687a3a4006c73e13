"""The port's HTTP server against the JAX package's on the CPU: one models
dir (a `tiny` f32 checkpoint written by the JAX package, a plain model, a
chatml-template model, a virtual model with a LoRA adapter, and a virtual
model on a base that merges adapters), both servers on ephemeral ports,
the same request JSON to each. Greedy content bytes, finish reasons and
usage counts match; so do the model list and the status codes of errors.
Tools, legacy functions, tool_choice, JSON response formats and GBNF
grammars give the JAX server's statuses, content bytes, finish reasons and
tool calls, whole and streamed. Fields the port does not honour yet get a
400 naming them. Last, `python -m localai_tpu_torch run --device cpu`
starts and answers /readyz."""

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
    ("/v1/chat/completions", {"logprobs": True}, "logprobs"),
    ("/v1/completions", {"logprobs": 2}, "logprobs"),
    ("/v1/completions", {"best_of": 3}, "best_of"),
    ("/v1/chat/completions", {"deadline_s": 5}, "deadline_s"),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}]}]},
     "image content"),
])
def test_unported_fields_are_rejected(servers, path, extra, field):
    payload = {"model": "tiny-plain", **(CHAT if "chat" in path else {"prompt": "x"}), **extra}
    status, body = _call(servers["port"], path, payload)
    assert status == 400 and field in body["error"]["message"], body


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
