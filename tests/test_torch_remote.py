"""The port's out-of-process backends on the CPU (engine/remote.py): the
`remote` backend relays chat, completions, streams, embeddings and tokenize
to another server, and the greedy text through each relay equals the
direct answer: the port's server relaying to the port's, the JAX package's
relaying to the port's, and the port's relaying to the JAX package's. A
stub peer shows that a stream is relayed frame by frame (the relay hands
on frame 1 while the peer still holds frame 2) and that a peer dying
mid-stream ends the stream with an error frame. A dead peer answers 502
and the server goes on serving its in-process model. The manager never
reaps an out-of-process engine. Last, the one test here that spawns a
child: a `subprocess` model's child (`python -m localai_tpu_torch run
--device cpu`) answers, is killed with SIGKILL, and the next request
respawns it with the same greedy text; unloading the model ends the
child."""

import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

from localai_tpu.config import ApplicationConfig as JaxAppConfig
from localai_tpu.server import ModelManager as JaxModelManager
from localai_tpu.server import Router as JaxRouter
from localai_tpu.server import create_server as jax_create_server
from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.remote import RemoteEngine, SubprocessEngine
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

TINY = {"model": "tiny", "context_size": 64, "max_slots": 2, "max_tokens": 6,
        "temperature": 0.0, "embeddings": True}
CHAT = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}


def _write(d, name, **doc):
    (d / f"{name}.yaml").write_text(yaml.safe_dump({"name": name, **doc}))


def _port_server(d):
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(d))
    manager = ModelManager(app, device="cpu")
    router = Router()
    OpenAIApi(manager).register(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, manager, f"http://127.0.0.1:{server.server_address[1]}"


def _jax_server(d):
    app = JaxAppConfig(address="127.0.0.1", port=0, models_dir=str(d))
    manager = JaxModelManager(app)
    router = JaxRouter()
    JaxOpenAIApi(manager).register(router)
    server = jax_create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, manager, f"http://127.0.0.1:{server.server_address[1]}"


def _call(base, path, payload, timeout=120):
    """(status, JSON body)."""
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _frames(base, payload, timeout=120):
    """The data payloads of a streamed chat, [DONE] included."""
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps({**payload, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                out.append(line[6:])
    return out


def _streamed_text(frames):
    assert frames[-1] == "[DONE]"
    return "".join(json.loads(f)["choices"][0]["delta"].get("content") or ""
                   for f in frames[:-1] if json.loads(f).get("choices"))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port worker and a JAX worker, each serving `real` (the tiny preset,
    each package's own random draw); a port front with remotes to both, a
    dead remote and an in-process model; a JAX front relaying to the port
    worker."""
    wd = tmp_path_factory.mktemp("port-worker")
    _write(wd, "real", **TINY)
    ws, wm, wurl = _port_server(wd)
    jd = tmp_path_factory.mktemp("jax-worker")
    _write(jd, "real", **TINY)
    js, jm, jurl = _jax_server(jd)
    fd = tmp_path_factory.mktemp("port-front")
    _write(fd, "proxied", model="remote", backend="remote", embeddings=True,
           options={"url": wurl, "remote_model": "real"})
    _write(fd, "to-jax", model="remote", backend="remote",
           options={"url": jurl, "remote_model": "real"})
    _write(fd, "dead", model="remote", backend="remote", options={"url": "http://127.0.0.1:1"})
    _write(fd, "local", **TINY)
    fs, fm, furl = _port_server(fd)
    xd = tmp_path_factory.mktemp("jax-front")
    _write(xd, "to-port", model="remote", backend="remote",
           options={"url": wurl, "remote_model": "real"})
    xs, xm, xurl = _jax_server(xd)
    yield {"worker": wurl, "jax_worker": jurl, "front": furl, "jax_front": xurl,
           "front_manager": fm}
    for s in (xs, fs, js, ws):
        s.shutdown()
    for m in (xm, fm, jm, wm):
        m.shutdown()


def test_port_relays_chat_and_completion_to_port(servers):
    st, direct = _call(servers["worker"], "/v1/chat/completions", {"model": "real", **CHAT})
    st2, relayed = _call(servers["front"], "/v1/chat/completions", {"model": "proxied", **CHAT})
    assert st == st2 == 200
    assert relayed["model"] == "real"  # the worker answered
    assert relayed["choices"][0]["message"] == direct["choices"][0]["message"]
    body = {"prompt": "abc", "max_tokens": 5}
    _, direct = _call(servers["worker"], "/v1/completions", {"model": "real", **body})
    _, relayed = _call(servers["front"], "/v1/completions", {"model": "proxied", **body})
    assert relayed["choices"][0]["text"] == direct["choices"][0]["text"]


def test_port_relays_a_stream(servers):
    direct = _frames(servers["worker"], {"model": "real", **CHAT})
    relayed = _frames(servers["front"], {"model": "proxied", **CHAT})
    assert len(relayed) == len(direct)
    assert _streamed_text(relayed) == _streamed_text(direct)
    assert json.loads(relayed[-2])["choices"][0]["finish_reason"] in ("stop", "length")


def test_port_relays_embeddings_and_tokenize(servers):
    for path, body in (("/v1/embeddings", {"input": ["abc", [1, 2, 3]]}),
                       ("/v1/tokenize", {"content": "abc"})):
        st, direct = _call(servers["worker"], path, {"model": "real", **body})
        st2, relayed = _call(servers["front"], path, {"model": "proxied", **body})
        assert st == st2 == 200
        if path == "/v1/tokenize":
            assert relayed == direct and relayed["tokens"]
        else:
            assert [d["embedding"] for d in relayed["data"]] == \
                [d["embedding"] for d in direct["data"]]


def test_jax_server_relays_to_port_server(servers):
    _, direct = _call(servers["worker"], "/v1/chat/completions", {"model": "real", **CHAT})
    st, relayed = _call(servers["jax_front"], "/v1/chat/completions",
                        {"model": "to-port", **CHAT})
    assert st == 200 and relayed["model"] == "real"
    assert relayed["choices"][0]["message"] == direct["choices"][0]["message"]
    assert _streamed_text(_frames(servers["jax_front"], {"model": "to-port", **CHAT})) == \
        direct["choices"][0]["message"]["content"]


def test_port_server_relays_to_jax_server(servers):
    _, direct = _call(servers["jax_worker"], "/v1/chat/completions", {"model": "real", **CHAT})
    st, relayed = _call(servers["front"], "/v1/chat/completions", {"model": "to-jax", **CHAT})
    assert st == 200 and relayed["model"] == "real"
    assert relayed["choices"][0]["message"] == direct["choices"][0]["message"]


def test_dead_remote_is_502_and_the_server_survives(servers):
    st, body = _call(servers["front"], "/v1/chat/completions", {"model": "dead", **CHAT})
    assert st == 502 and "remote backend failed" in body["error"]["message"]
    st, body = _call(servers["front"], "/v1/chat/completions", {"model": "local", **CHAT})
    assert st == 200 and body["object"] == "chat.completion"


def test_manager_never_reaps_a_remote_engine(servers):
    fm = servers["front_manager"]
    _call(servers["front"], "/v1/tokenize", {"model": "proxied", "content": "x"})
    lm = fm.peek("proxied")
    assert isinstance(lm.engine, RemoteEngine) and not fm._engine_dead(lm)
    assert fm._reap_dead("proxied") is None
    fm._watchdog_tick()
    assert fm.peek("proxied") is lm and fm.restart_stats("proxied")["restarts_total"] == 0

    class NoLoop:  # an engine object without the loop's attributes
        pass

    assert fm._engine_dead(type("LM", (), {"engine": NoLoop()})()) is False


class _StubPeer:
    """An OpenAI-style peer whose stream writes frame 1, waits until the
    test says go, writes frame 2, then ends (mode "ok") or drops the
    connection mid-stream (mode "die")."""

    def __init__(self):
        self.go = threading.Event()
        self.mode = "ok"
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(b):
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")
                    self.wfile.flush()

                for i in range(2):
                    if i == 1:
                        outer.go.wait(30)
                    frame = {"choices": [{"index": 0, "delta": {"content": f"f{i}"}}]}
                    chunk(f"data: {json.dumps(frame)}\n\n".encode())
                if outer.mode == "die":
                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.close_connection = True
                    return
                chunk(b"data: [DONE]\n\n")
                chunk(b"")

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


@pytest.mark.parametrize("mode", ["ok", "die"])
def test_stream_relays_frame_by_frame_and_a_dead_peer_ends_it(tmp_path, mode):
    peer = _StubPeer()
    peer.mode = mode
    _write(tmp_path, "stub", model="remote", backend="remote", options={"url": peer.url})
    _write(tmp_path, "local", **TINY)
    server, manager, base = _port_server(tmp_path)
    try:
        req = urllib.request.Request(base + "/v1/chat/completions",
                                     data=json.dumps({"model": "stub", "stream": True,
                                                      **CHAT}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            first = r.readline()
            while not first.strip():
                first = r.readline()
            # Frame 1 came through while the peer still holds frame 2.
            assert not peer.go.is_set()
            assert json.loads(first.decode()[6:])["choices"][0]["delta"]["content"] == "f0"
            peer.go.set()
            rest = [ln.decode().strip()[6:] for ln in r if ln.startswith(b"data: ")]
        assert rest[-1] == "[DONE]"
        if mode == "ok":
            assert [json.loads(f)["choices"][0]["delta"]["content"] for f in rest[:-1]] == ["f1"]
        else:
            err = json.loads(rest[-2])["error"]
            assert err["code"] == 502 and "mid-stream" in err["message"]
        st, body = _call(base, "/v1/chat/completions", {"model": "local", **CHAT})
        assert st == 200 and body["object"] == "chat.completion"
    finally:
        server.shutdown()
        manager.shutdown()
        peer.server.shutdown()


def test_subprocess_child_is_respawned_after_kill_9(tmp_path):
    """The only test here that spawns a child; its own limit is the
    engine's startup timeout (90 s a spawn) and each request's 90 s."""
    _write(tmp_path, "boxed", model="subprocess", backend="subprocess",
           options={"child": {**TINY, "name": "boxed"}})
    server, manager, base = _port_server(tmp_path)
    try:
        lm = manager.get("boxed")
        eng = lm.engine
        assert isinstance(eng, SubprocessEngine) and eng.pid is None  # spawned on first use
        eng.STARTUP_TIMEOUT_S = 90.0
        cmd = eng.command(1234)
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert eng.workdir == str(tmp_path / ".subprocess-boxed")
        st, first = _call(base, "/v1/chat/completions", {"model": "boxed", **CHAT}, timeout=90)
        assert st == 200 and first["model"] == "boxed"
        assert eng.metrics()["subprocess_alive"] == 1.0 and eng.metrics()["spawn_s"] > 0
        pid = eng.pid
        os.kill(pid, signal.SIGKILL)
        eng._proc.wait(timeout=30)
        st, again = _call(base, "/v1/chat/completions", {"model": "boxed", **CHAT}, timeout=90)
        assert st == 200 and eng.m_respawns == 1 and eng.pid != pid
        assert again["choices"][0]["message"] == first["choices"][0]["message"]
        assert manager.restart_stats("boxed")["restarts_total"] == 0
        child = eng._proc
        assert manager.unload("boxed", drain_s=0.0)
        child.wait(timeout=30)  # the unload stopped the child
        deadline = time.monotonic() + 30
        while eng._proc is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng._proc is None
    finally:
        server.shutdown()
        manager.shutdown()


def test_an_unported_backend_names_the_served_ones(tmp_path):
    from localai_tpu_torch.server.manager import UnsupportedBackendError

    _write(tmp_path, "img", model="detr-test", backend="detection")
    _write(tmp_path, "no-url", model="remote", backend="remote")
    manager = ModelManager(ApplicationConfig(models_dir=str(tmp_path)), device="cpu")
    try:
        with pytest.raises(UnsupportedBackendError,
                           match="item 13.*whisper, tts, vad, diffusion \\(diffusers / "
                                 "stablediffusion\\), remote and subprocess"):
            manager.get("img")
        with pytest.raises(RuntimeError, match="needs options.url"):
            manager.get("no-url")
    finally:
        manager.shutdown()
