"""The port's service surfaces on the CPU: model import / edit / reload
(`/models/*`), settings (`/settings`), the OpenAPI document and the web UI,
MCP chat with the agent loop over a stub MCP server on loopback, and the
agent jobs (cron matcher, persistence, scheduler, `/agent-jobs/*`). Pure
functions go through the JAX package's function and the port's copy on
the same inputs: the cron matcher (Sunday is 0 and 7) and `build_openapi`
over the same route list. The CLI's app registers every layer the JAX CLI
registers but audio, image, realtime and p2p, and its OpenAPI document
lists every route its router declares and none other. The port's HF
checkpoint writer round-trips through the port's loader and the JAX
package's."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

import localai_tpu.server.openapi as jopenapi
import localai_tpu.services.agent_jobs as jjobs
import localai_tpu_torch.server.openapi as topenapi
import localai_tpu_torch.services.agent_jobs as tjobs
from localai_tpu.server.app import Router as JaxRouter
from localai_tpu_torch.__main__ import build_app
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.mcp import MCPClient, agent_loop, collect_tools
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
from localai_tpu_torch.server.mcp_api import McpApi, make_job_runner
from localai_tpu_torch.server.models_api import ModelsApi
from localai_tpu_torch.server.openapi import build_openapi, register_openapi
from localai_tpu_torch.server.settings_api import SettingsApi
from localai_tpu_torch.server.webui import register_webui
from localai_tpu_torch.services import AgentJobService

from test_torch_gallery import FakeHub

TINY = {"model": "tiny", "context_size": 128, "max_tokens": 6, "temperature": 0.0}


class FakeMCPServer:
    """JSON-RPC MCP server with one `add` tool; records its calls."""

    def __init__(self):
        self.calls = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                result = {}
                if req.get("method") == "initialize":
                    result = {"protocolVersion": "2024-11-05", "serverInfo": {"name": "fake"}}
                elif req.get("method") == "tools/list":
                    result = {"tools": [{"name": "add", "description": "Add two integers",
                                         "inputSchema": {"type": "object", "properties": {
                                             "a": {"type": "integer"},
                                             "b": {"type": "integer"}}}}]}
                elif req.get("method") == "tools/call":
                    p = req.get("params", {})
                    outer.calls.append(p)
                    result = {"content": [{"type": "text",
                                           "text": str(p["arguments"]["a"] + p["arguments"]["b"])}]}
                body = json.dumps({"jsonrpc": "2.0", "id": req.get("id"),
                                   "result": result}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/mcp"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


@pytest.fixture(scope="module")
def mcp_server():
    s = FakeMCPServer()
    yield s
    s.server.shutdown()


@pytest.fixture(scope="module")
def hub():
    h = FakeHub()
    yield h
    h.server.shutdown()


@pytest.fixture(scope="module")
def api(tmp_path_factory, mcp_server, hub):
    """The port's server with the models, settings, MCP + jobs, OpenAPI and
    web UI layers over one tiny model whose config names the stub MCP
    server; Hugging Face imports fetch from the local hub."""
    d = tmp_path_factory.mktemp("service-models")
    (d / "m.yaml").write_text(yaml.safe_dump({
        "name": "m", **TINY, "template": {"family": "chatml"},
        "options": {"mcp": {"remote": [{"name": "fake", "url": mcp_server.url}]}}}))
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(d),
                            hf_endpoint=hub.url,
                            runtime_settings_path=str(d / "runtime_settings.json"))
    manager = ModelManager(app, device="cpu")
    router = Router()
    oai = OpenAIApi(manager)
    oai.register(router)
    jobs = AgentJobService(str(d / "agent_jobs.json"), make_job_runner(manager))
    McpApi(manager, oai, jobs=jobs).register(router)
    SettingsApi(app, manager).register(router)
    ModelsApi(manager).register(router)
    register_openapi(router)
    register_webui(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield {"base": f"http://127.0.0.1:{server.server_address[1]}", "manager": manager,
           "dir": d, "router": router, "app": app}
    server.shutdown()
    manager.shutdown()


def _req(base, path, payload=None, method=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read()
        return r.status, (json.loads(raw) if "json" in r.headers["Content-Type"] else raw.decode())


# --------------------------------------------------------------------------- #
# /models: import, import-uri, import jobs, config, edit, reload
# --------------------------------------------------------------------------- #


def test_import_model_and_serve(api):
    base, d = api["base"], api["dir"]
    st, out = _req(base, "/models/import", {"name": "imported", **TINY})
    assert st == 201 and (d / "imported.yaml").exists()
    st, out = _req(base, "/v1/chat/completions", {
        "model": "imported", "messages": [{"role": "user", "content": "x"}]})
    assert st == 200 and out["model"] == "imported"
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/models/import", {"model": "tiny"})  # no name
    assert e.value.code == 400


def test_import_uri_preset_and_file_checkpoint(api, tmp_path):
    import dataclasses

    import jax

    from localai_tpu.engine.weights import save_hf_checkpoint
    from localai_tpu.models import llama as jl
    from localai_tpu_torch.models import get_arch

    base, manager = api["base"], api["manager"]
    st, out = _req(base, "/models/import-uri", {"uri": "tiny", "name": "quick"})
    assert st == 201 and out["status"] == "installed" and manager.configs.get("quick")
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(tmp_path / "ckpt"))
    st, out = _req(base, "/models/import-uri", {
        "uri": f"file://{tmp_path / 'ckpt'}", "name": "fromdisk",
        "preferences": {"context_size": 64, "max_tokens": 4}})
    assert st == 201
    st, out = _req(base, "/v1/chat/completions", {
        "model": "fromdisk", "messages": [{"role": "user", "content": "x"}]})
    assert st == 200 and out["model"] == "fromdisk"
    for bad in ({"uri": "weird://x"}, {"uri": "huggingface://justowner"}, {}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/models/import-uri", bad)
        assert e.value.code == 400


def test_import_uri_from_the_configured_hub_is_a_job(api):
    base, manager, d = api["base"], api["manager"], api["dir"]
    st, out = _req(base, "/models/import-uri", {"uri": "huggingface://acme/tiny-llm",
                                                "name": "hf-model"})
    assert st == 202
    deadline = time.time() + 30
    while time.time() < deadline:
        _st, job = _req(base, f"/models/import-jobs/{out['uuid']}")
        if job["processed"]:
            break
        time.sleep(0.05)
    assert job["processed"] and job["error"] is None, job
    assert manager.configs.get("hf-model") is not None
    assert (d / "hf-model" / "model.safetensors").exists()
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/models/import-jobs/nope")
    assert e.value.code == 404


def test_edit_evicts_and_persists_then_reload(api):
    base, manager, d = api["base"], api["manager"], api["dir"]
    (d / "e.yaml").write_text(yaml.safe_dump({"name": "e", **TINY}))
    manager.reload_configs()
    manager.get("e")
    st, cfg = _req(base, "/models/config/e")
    assert cfg["name"] == "e" and cfg["model"] == "tiny"
    st, out = _req(base, "/models/edit/e", {"max_tokens": 9}, method="PUT")
    assert out["max_tokens"] == 9 and manager.configs.get("e").max_tokens == 9
    deadline = time.time() + 15
    while manager.peek("e") is not None and time.time() < deadline:
        time.sleep(0.05)
    assert manager.peek("e") is None, "the stale engine must be evicted"
    assert yaml.safe_load((d / "e.yaml").read_text())["max_tokens"] == 9
    for path, payload in (("/models/edit/nope", {"max_tokens": 2}), ("/models/config/nope", None)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, path, payload)
        assert e.value.code == 404
    (d / "extra.yaml").write_text(yaml.safe_dump({"name": "extra", **TINY}))
    st, out = _req(base, "/models/reload", {})
    assert out["status"] == "reloaded" and "extra" in out["models"]


# --------------------------------------------------------------------------- #
# /settings
# --------------------------------------------------------------------------- #


def test_settings_get_put_persist_and_start_the_watchdog(api):
    base, app, manager = api["base"], api["app"], api["manager"]
    st, cur = _req(base, "/settings")
    assert set(cur) == set(ApplicationConfig.RUNTIME_MUTABLE)
    assert manager._wd_thread is None
    st, out = _req(base, "/settings", {"machine_tag": "gpu-0", "watchdog_idle_timeout_s": 600},
                   method="PUT")
    assert out["machine_tag"] == "gpu-0" and app.watchdog_idle_timeout_s == 600.0
    assert manager._wd_thread is not None and manager._wd_thread.is_alive()
    saved = json.loads(open(app.runtime_settings_path).read())
    assert saved["machine_tag"] == "gpu-0"
    fresh = ApplicationConfig(runtime_settings_path=app.runtime_settings_path)
    assert fresh.apply_runtime_settings()["machine_tag"] == "gpu-0"
    for bad in ({"port": 1}, {"max_active_models": "many"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/settings", bad, method="POST")
        assert e.value.code == 400
    _req(base, "/settings", {"machine_tag": "", "watchdog_idle_timeout_s": 0}, method="PUT")


# --------------------------------------------------------------------------- #
# OpenAPI and the web UI
# --------------------------------------------------------------------------- #


def _templated(pattern):
    return "/".join("{" + s[1:] + "}" if s.startswith(":") else s for s in pattern.split("/"))


def test_openapi_lists_exactly_the_declared_routes(api):
    base, router = api["base"], api["router"]
    st, doc = _req(base, "/swagger.json")
    assert doc["openapi"].startswith("3.") and doc["info"]["title"] == "localai-tpu-torch"
    declared = {(_templated(p), m.lower()) for m, p, _h in router.declared}
    listed = {(p, m) for p, ops in doc["paths"].items() for m in ops}
    assert listed == declared
    post = doc["paths"]["/v1/chat/completions"]["post"]
    assert "messages" in post["requestBody"]["content"]["application/json"]["schema"]["properties"]
    assert doc["paths"]["/v1/models/{name}"]["get"]["parameters"][0]["name"] == "name"
    st, html = _req(base, "/swagger")
    assert "/swagger.json" in html


@pytest.mark.parametrize("routes", [
    [("GET", "/x/:id", "Test summary line.")],
    [("POST", "/v1/chat/completions", "Chat."), ("POST", "/v1/embeddings", None),
     ("GET", "/v1/models/:name", "One model.\nMore text."), ("DELETE", "/models/galleries", "")],
    [("POST", "/v1/images/generations", "Images."), ("GET", "/v1/images/generations", "x"),
     ("POST", "/agent-jobs/:id/run", "Run a job.")],
])
def test_build_openapi_matches_the_jax_package(routes):
    def doc(router_cls, build):
        r = router_cls()
        for method, pattern, summary in routes:
            def handler(req):
                return None

            handler.__doc__ = summary
            r.add(method, pattern, handler)
        out = build(r)
        del out["info"]
        return out

    assert doc(Router, topenapi.build_openapi) == doc(JaxRouter, jopenapi.build_openapi)


def test_webui_served_at_root_drives_the_real_apis(api):
    base = api["base"]
    for path in ("/", "/index.html"):
        st, body = _req(base, path)
        assert st == 200 and "localai-tpu" in body
    for needle in ("/v1/chat/completions", "/models/config/", "/models/edit/", "/models/import",
                   "/models/reload", "/models/delete/", "/models/available", "/models/apply",
                   "/agent-jobs", "/run", "/history"):
        assert needle in body, needle
    import localai_tpu.server.webui as jw
    import localai_tpu_torch.server.webui as tw

    assert tw._HTML == jw._HTML  # the same page


# --------------------------------------------------------------------------- #
# MCP: the client, the agent loop, the endpoint
# --------------------------------------------------------------------------- #


def test_mcp_client_tools_and_agent_loop(mcp_server):
    c = MCPClient(mcp_server.url, name="fake")
    assert c.list_tools()[0]["name"] == "add" and c.call_tool("add", {"a": 2, "b": 40}) == "42"
    specs, owners = collect_tools([c])
    assert specs[0]["function"]["name"] == "add" and "add" in owners
    state = {"round": 0}

    def chat_fn(messages, tools):
        state["round"] += 1
        if state["round"] == 1:
            return {"role": "assistant", "content": None, "tool_calls": [{
                "id": "call_1", "type": "function",
                "function": {"name": "add", "arguments": json.dumps({"a": 3, "b": 4})}}]}
        assert [m for m in messages if m.get("role") == "tool"][-1]["content"] == "7"
        return {"role": "assistant", "content": "the answer is 7"}

    result = agent_loop(chat_fn, [{"role": "user", "content": "3+4?"}], [MCPClient(mcp_server.url)])
    assert result["message"]["content"] == "the answer is 7" and result["iterations"] == 2
    assert result["tool_calls"][0]["result"] == "7"

    def unknown(messages, tools):
        return {"role": "assistant", "content": None, "tool_calls": [{
            "id": "x", "type": "function", "function": {"name": "nope", "arguments": "{}"}}]}

    result = agent_loop(unknown, [{"role": "user", "content": "q"}], [c], max_iterations=2)
    assert result["iterations"] == 2 and all("error" in t for t in result["tool_calls"])


def test_mcp_chat_endpoint_runs_the_engine(api):
    st, out = _req(api["base"], "/mcp/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6})
    assert st == 200 and out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert out["agent"]["iterations"] >= 1
    st, alias = _req(api["base"], "/mcp/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6})
    assert alias["choices"][0]["message"] == out["choices"][0]["message"]


# --------------------------------------------------------------------------- #
# Agent jobs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("expr", ["30 14 * * *", "*/15 * * * *", "* * * * 3", "* * * * 2",
                                  "31 14 * * *", "25-35 14 30 7 *", "0 9 * * 0", "0 9 * * 7",
                                  "0 9 * * 1", "0 9 * * 1-5", "0,30 9,14 * * 0,6", "* * *"])
@pytest.mark.parametrize("when", [(2026, 7, 30, 14, 30, 0, 2, 211, -1),   # a Wednesday
                                  (2026, 8, 2, 9, 0, 0, 6, 214, -1),      # a Sunday
                                  (2026, 8, 3, 9, 0, 0, 0, 215, -1)])     # a Monday
def test_cron_matcher_matches_the_jax_package(expr, when):
    t = time.struct_time(when)

    def run(fn):
        try:
            return fn(expr, t)
        except ValueError:
            return "ValueError"

    assert run(tjobs.cron_matches) == run(jjobs.cron_matches)


def test_cron_sunday_is_zero_and_seven():
    sun = time.struct_time((2026, 8, 2, 9, 0, 0, 6, 214, -1))
    mon = time.struct_time((2026, 8, 3, 9, 0, 0, 0, 215, -1))
    assert tjobs.cron_matches("0 9 * * 0", sun) and tjobs.cron_matches("0 9 * * 7", sun)
    assert not tjobs.cron_matches("0 9 * * 1", sun) and not tjobs.cron_matches("0 9 * * 0", mon)


def test_jobs_crud_persistence_and_schedule(tmp_path):
    store, runs = str(tmp_path / "jobs.json"), []

    def runner(job):
        runs.append(job.id)
        return f"ran {job.name}"

    svc = AgentJobService(store, runner, tick_s=0.05)
    job = svc.create(name="j1", model="m", prompt="do it", schedule="@every 0.2s")
    svc.start()
    deadline = time.time() + 10
    while len(runs) < 2 and time.time() < deadline:
        time.sleep(0.05)
    svc.stop()
    assert len(runs) >= 2
    hist = svc.get(job.id).history
    assert hist[0]["ok"] and hist[0]["result"] == "ran j1"

    def bad(job):
        raise RuntimeError("boom")

    svc2 = AgentJobService(store, bad)
    assert svc2.get(job.id) is not None, "jobs persist across restarts"
    entry = svc2.run_now(job.id)
    assert entry["ok"] is False and "boom" in entry["error"]
    svc2.update(job.id, enabled=False, name="j2")
    assert svc2.get(job.id).name == "j2" and svc2.delete(job.id) and svc2.get(job.id) is None
    with pytest.raises(ValueError):
        svc2.create(name="bad", model="m", prompt="p", schedule="not a schedule")


def test_agent_jobs_endpoints_run_the_engine(api):
    base = api["base"]
    st, job = _req(base, "/agent-jobs", {"name": "daily", "model": "m", "prompt": "say hi"})
    assert st == 201 and job["name"] == "daily"
    jid = job["id"]
    assert any(j["id"] == jid for j in _req(base, "/agent-jobs")[1]["jobs"])
    st, entry = _req(base, f"/agent-jobs/{jid}/run", {})
    assert entry["ok"] is True, entry
    assert len(_req(base, f"/agent-jobs/{jid}/history")[1]["history"]) == 1
    assert _req(base, f"/agent-jobs/{jid}")[1]["history"][0]["ok"]
    assert _req(base, f"/agent-jobs/{jid}", {"enabled": False}, method="PUT")[1]["enabled"] is False
    assert _req(base, f"/agent-jobs/{jid}", method="DELETE")[1]["status"] == "deleted"
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, f"/agent-jobs/{jid}")
    assert e.value.code == 404


# --------------------------------------------------------------------------- #
# The CLI's app
# --------------------------------------------------------------------------- #


def test_cli_app_registers_every_ported_layer(tmp_path):
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path))
    manager, router, jobs = build_app(app, device="cpu")
    try:
        declared = {(m, p) for m, p, _h in router.declared}
        for route in (("POST", "/v1/chat/completions"), ("POST", "/v1/rerank"),
                      ("POST", "/stores/set"), ("GET", "/models/available"),
                      ("POST", "/models/apply"), ("GET", "/models/jobs/:uuid"),
                      ("GET", "/models/galleries"), ("POST", "/models/galleries"),
                      ("DELETE", "/models/galleries"), ("POST", "/models/delete/:name"),
                      ("POST", "/mcp/v1/chat/completions"), ("GET", "/agent-jobs"),
                      ("POST", "/agent-jobs/:id/run"), ("GET", "/settings"),
                      ("PUT", "/settings"), ("POST", "/models/import"),
                      ("POST", "/models/import-uri"), ("GET", "/models/import-jobs/:uuid"),
                      ("GET", "/models/config/:name"), ("POST", "/models/edit/:name"),
                      ("POST", "/models/reload"), ("GET", "/swagger.json"), ("GET", "/swagger"),
                      ("GET", "/"), ("GET", "/index.html"),
                      ("POST", "/v1/audio/transcriptions"), ("POST", "/v1/audio/speech"),
                      ("POST", "/v1/vad"), ("GET", "/v1/realtime"),
                      ("POST", "/v1/realtime/sessions"), ("POST", "/v1/images/generations"),
                      ("POST", "/images/generations"), ("POST", "/v1/images/inpainting"),
                      ("POST", "/v1/videos"), ("GET", "/generated-images/:name"),
                      ("GET", "/generated-videos/:name")):
            assert route in declared, route
        # Not ported yet: p2p (ROADMAP A12).
        assert not any(p == "/p2p/status" for _m, p in declared)
        doc = build_openapi(router)
        assert {(p, m) for p, ops in doc["paths"].items() for m in ops} == \
            {(_templated(p), m.lower()) for m, p in declared}
        assert len(doc["paths"]) >= 50
    finally:
        jobs.stop()
        manager.shutdown()


# --------------------------------------------------------------------------- #
# The checkpoint writer the import paths and the service phase use
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_hf_checkpoint_round_trips_through_both_loaders(tmp_path, dtype):
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from localai_tpu.engine import weights as jw
    from localai_tpu.models import get_arch as jax_arch
    from localai_tpu_torch.engine import weights as tw
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch("tiny"), dtype=dtype)
    params = llama.init_params(cfg, seed=3, device="cpu")
    tw.save_hf_checkpoint(cfg, params, str(tmp_path))
    back = tw.load_hf_checkpoint(cfg, str(tmp_path), device="cpu")
    jax_back = jw.load_hf_checkpoint(dataclasses.replace(jax_arch("tiny"), dtype=dtype),
                                     str(tmp_path))
    for key in params["layers"]:
        assert torch.equal(back["layers"][key], params["layers"][key]), key
        np.testing.assert_array_equal(
            np.asarray(jax_back["layers"][key].astype(jnp.float32)),
            params["layers"][key].float().numpy(), err_msg=key)
    assert torch.equal(back["embed"], params["embed"])
    arch = tw.arch_from_hf_config(str(tmp_path))
    assert (arch.num_layers, arch.hidden_size, arch.vocab_size, arch.tie_embeddings) == \
        (cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.tie_embeddings)
    with pytest.raises(ValueError, match="plain llama-family"):
        tw.save_hf_checkpoint(get_arch("tiny-moe"), {"layers": {}}, str(tmp_path / "moe"))
