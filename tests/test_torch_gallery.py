"""The port's downloader and model gallery on the CPU, against local
servers (no network): URI schemes through the JAX function and the port's
copy, sha256 checks, HTTP resume and 416, Hugging Face listing and whole-
repo fetch from a local hub given as the endpoint (the port reads no
HF_ENDPOINT), ollama / OCI pulls with token auth from a local registry
given as the registry; gallery indexes (`load_index`, `find_entry` through
both packages), install jobs with progress, the path-traversal guard, the
starter index as the default gallery, and a gallery install that the
port's server then serves, whose greedy text equals the checkpoint's own
model's."""

import hashlib
import http.server
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

import localai_tpu.downloader as jdl
import localai_tpu.gallery as jgal
import localai_tpu_torch.downloader as tdl
import localai_tpu_torch.gallery as tgal
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.downloader import DownloadError, download
from localai_tpu_torch.downloader.hf_api import checkpoint_files, fetch_hf_model, list_repo_files
from localai_tpu_torch.downloader.oci import pull_oci_blob, pull_ollama, resolve_model_uri
from localai_tpu_torch.gallery import Gallery, GalleryService, load_index
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
from localai_tpu_torch.server.gallery_api import GalleryApi


@pytest.mark.parametrize("uri", [
    "https://x/y", "file:///tmp/a",
    "huggingface://meta-llama/Llama-3.2-1B/model.safetensors",
    "huggingface://o/r@dev/f.bin", "huggingface://o/r/sub/dir/f.bin",
    "github:owner/repo/gallery/index.yaml", "github:owner/repo/a/b.yaml@v2",
    "huggingface://justowner", "github:owner/x",
])
def test_resolve_uri_matches_the_jax_package(uri):
    def run(fn, err):
        try:
            return fn(uri)
        except err as e:
            return ("error", type(e).__name__)

    assert run(tdl.resolve_uri, tdl.DownloadError) == run(jdl.resolve_uri, jdl.DownloadError)


def test_file_scheme_with_sha_and_mismatch(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"payload" * 100)
    sha = hashlib.sha256(src.read_bytes()).hexdigest()
    dest = tmp_path / "out" / "dst.bin"
    assert download(f"file://{src}", str(dest), sha256=sha) == str(dest)
    assert dest.read_bytes() == src.read_bytes()
    download(f"file://{src}", str(dest), sha256=sha)  # a matching dest short-circuits
    assert not os.path.exists(str(dest) + ".partial")
    bad = tmp_path / "bad.bin"
    with pytest.raises(DownloadError, match="sha256 mismatch"):
        download(f"file://{src}", str(bad), sha256="0" * 64)
    assert not bad.exists() and not os.path.exists(str(bad) + ".partial")


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    payload = b"0123456789abcdef" * 4096  # 64 KiB
    support_range = True
    seen: list = []

    def do_GET(self):  # noqa: N802
        type(self).seen.append(self.headers.get("Range") or "")
        start, rng = 0, self.headers.get("Range")
        if rng and self.support_range:
            start = int(rng.split("=")[1].split("-")[0])
            if start >= len(self.payload):
                self.send_response(416)
                self.end_headers()
                return
            self.send_response(206)
        else:
            self.send_response(200)
        body = self.payload[start:]
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("case", ["fresh", "resume", "ignores_range", "416"])
def test_http_download(tmp_path, case):
    server = http.server.HTTPServer(("127.0.0.1", 0), _RangeHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _RangeHandler.seen, _RangeHandler.support_range = [], case != "ignores_range"
    url = f"http://127.0.0.1:{server.server_address[1]}/f.bin"
    payload, dest = _RangeHandler.payload, tmp_path / "f.bin"
    half = len(payload) // 2
    partial = {"fresh": None, "resume": payload[:half], "ignores_range": b"junkjunk",
               "416": payload}[case]
    if partial is not None:
        (tmp_path / "f.bin.partial").write_bytes(partial)
    seen = []
    try:
        download(url, str(dest), sha256=hashlib.sha256(payload).hexdigest(),
                 progress=lambda d, t: seen.append((d, t)))
    finally:
        server.shutdown()
    assert dest.read_bytes() == payload
    if case == "fresh":
        assert seen[-1] == (len(payload), len(payload))
    if case == "resume":
        assert f"bytes={half}-" in _RangeHandler.seen


class FakeHub:
    """Hugging Face hub subset: the tree API and resolve URLs."""

    FILES = {"config.json": b'{"model_type": "llama"}', "model.safetensors": b"W" * 700,
             "tokenizer.json": b'{"version": "1.0"}', "README.md": b"# skipped",
             "tf_model.safetensors": b"skipped"}

    def __init__(self):
        files = self.FILES

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/api/models/"):
                    body = json.dumps([{"type": "file", "path": k, "size": len(v)}
                                       for k, v in files.items()]).encode()
                else:
                    body = files.get(self.path.rsplit("/", 1)[-1], b"")
                    if not body:
                        self.send_response(404)
                        self.end_headers()
                        return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


@pytest.fixture(scope="module")
def hub():
    h = FakeHub()
    yield h
    h.server.shutdown()


def test_hf_listing_and_fetch_from_the_given_endpoint(hub, tmp_path):
    files = list_repo_files("acme/tiny-llm", endpoint=hub.url)
    assert {f["path"] for f in files} == set(FakeHub.FILES)
    assert set(checkpoint_files(files)) == {"config.json", "model.safetensors", "tokenizer.json"}
    assert checkpoint_files(files) == jdl.hf_api.checkpoint_files(files)
    seen = []
    out = fetch_hf_model("acme/tiny-llm", str(tmp_path / "ckpt"), endpoint=hub.url,
                         progress=lambda p, d, t: seen.append(p))
    assert len(out) == 3 and seen
    assert (tmp_path / "ckpt" / "model.safetensors").read_bytes() == FakeHub.FILES[
        "model.safetensors"]


class FakeRegistry:
    """OCI distribution subset: anonymous token auth, manifest, blobs."""

    def __init__(self, require_auth=True):
        blob = b"GGUFMODELDATA" * 64
        self.blob, self.digest = blob, "sha256:" + hashlib.sha256(blob).hexdigest()
        self.token_requests = 0
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                authed = self.headers.get("Authorization") == "Bearer testtoken"
                if self.path.startswith("/token"):
                    outer.token_requests += 1
                    self._json(200, {"token": "testtoken"})
                elif "/manifests/" in self.path:
                    if require_auth and not authed:
                        self._json(401, {}, {"WWW-Authenticate": f'Bearer realm="{outer.url}'
                                                                 f'/token",service="reg"'})
                        return
                    self._json(200, {"schemaVersion": 2, "layers": [
                        {"mediaType": "application/vnd.ollama.image.template",
                         "digest": "sha256:dead", "size": 10},
                        {"mediaType": "application/vnd.ollama.image.model",
                         "digest": outer.digest, "size": len(outer.blob)}]})
                elif "/blobs/" in self.path and (authed or not require_auth):
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(outer.blob)))
                    self.end_headers()
                    self.wfile.write(outer.blob)
                else:
                    self.send_response(404 if "/blobs/" not in self.path else 401)
                    self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


def test_ollama_and_oci_pulls_from_local_registries(tmp_path):
    reg = FakeRegistry(require_auth=True)
    try:
        path = pull_ollama("tinymodel:latest", str(tmp_path / "a"), registry=reg.url)
        assert open(path, "rb").read() == reg.blob and path.endswith("tinymodel-latest.bin")
        assert reg.token_requests >= 1
        path = resolve_model_uri("ollama://tinymodel", str(tmp_path / "b"), registry=reg.url)
        assert open(path, "rb").read() == reg.blob
    finally:
        reg.server.shutdown()
    reg = FakeRegistry(require_auth=False)
    try:
        path = pull_oci_blob(reg.url, "acme/model", "v1", str(tmp_path / "c"))
        assert open(path, "rb").read() == reg.blob
    finally:
        reg.server.shutdown()


def test_oci_uri_parsing_and_bad_uris(tmp_path, monkeypatch):
    import localai_tpu_torch.downloader.oci as oci

    calls = []
    monkeypatch.setattr(oci, "pull_oci_blob",
                        lambda base, repo, tag, dest, progress=None: calls.append(
                            (base, repo, tag)) or "ok")
    resolve_model_uri("oci://localhost:5000/team/model:v2", str(tmp_path))
    resolve_model_uri("oci://localhost:5000/team/model", str(tmp_path))
    assert calls == [("https://localhost:5000", "team/model", "v2"),
                     ("https://localhost:5000", "team/model", "latest")]
    for bad in ("oci://no-slash", "weird://x"):
        with pytest.raises(DownloadError):
            resolve_model_uri(bad, str(tmp_path))


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """A local gallery: a tiny f32 checkpoint (written by the JAX package's
    writer), and an index listing it with file:// URIs and sha256s, a
    second entry and a nameless one; a second index shares a name."""
    import dataclasses

    import jax

    from localai_tpu.engine.weights import save_hf_checkpoint
    from localai_tpu.models import llama as jl
    from localai_tpu_torch.models import get_arch

    root = tmp_path_factory.mktemp("gallery")
    art = root / "artifacts" / "tiny-hf"
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(7)), str(art))
    files = [{"filename": f, "uri": f"file://{art / f}", "sha256": _sha(art / f)}
             for f in sorted(os.listdir(art))]
    index = [{"name": "tiny-gallery-model", "description": "test checkpoint", "license": "mit",
              "tags": ["llm", "tiny"], "files": files,
              "overrides": {"context_size": 128, "max_slots": 2, "max_tokens": 8,
                            "temperature": 0.0}},
             {"name": "other", "overrides": {"model": "tiny"}},
             {"description": "no name: skipped"}]
    (root / "index.yaml").write_text(yaml.safe_dump(index))
    (root / "second.yaml").write_text(yaml.safe_dump([{"name": "other", "description": "2nd"}]))
    return root


def _galleries(root):
    return [("local", f"file://{root}/index.yaml"), ("second", f"file://{root}/second.yaml"),
            ("broken", f"file://{root}/missing.yaml")]


@pytest.mark.parametrize("entry_id", ["local@tiny-gallery-model", "tiny-gallery-model", "other",
                                      "second@other", "broken@other", "nope", "local@nope"])
def test_find_entry_and_load_index_match_the_jax_package(gallery, entry_id):
    def found(mod):
        gs = [mod.gallery.Gallery(name=n, url=u) for n, u in _galleries(gallery)]
        e = mod.gallery.find_entry(gs, entry_id)
        return None if e is None else (e.id, e.description, e.files, e.overrides)

    assert found(tgal) == found(jgal)
    for name, url in _galleries(gallery)[:2]:
        t = [(e.id, e.files, e.overrides, e.tags) for e in load_index(Gallery(name, url))]
        j = [(e.id, e.files, e.overrides, e.tags)
             for e in jgal.load_index(jgal.Gallery(name, url))]
        assert t == j


def _wait_job(service, uuid, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        j = service.job(uuid)
        if j and j["processed"]:
            return j
        time.sleep(0.05)
    raise TimeoutError(service.job(uuid))


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_install_from_gallery_serves_and_deletes(gallery, tmp_path):
    """/models/available → /models/apply → the job polls done → the model
    serves, with the greedy text of the checkpoint's own model → delete."""
    models = tmp_path / "models"
    models.mkdir()
    (models / "direct.yaml").write_text(yaml.safe_dump({
        "name": "direct", "model": str(gallery / "artifacts" / "tiny-hf"), "context_size": 128,
        "max_slots": 2, "max_tokens": 8, "temperature": 0.0}))
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(models))
    manager = ModelManager(app, device="cpu")
    service = GalleryService(str(models), config_loader=manager.configs,
                             galleries=[Gallery("local", f"file://{gallery}/index.yaml")])
    router = Router()
    OpenAIApi(manager).register(router)
    GalleryApi(service, manager=manager).register(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}
    try:
        with urllib.request.urlopen(base + "/models/available", timeout=30) as r:
            avail = json.loads(r.read())
        assert avail[0]["id"] == "local@tiny-gallery-model" and avail[0]["installed"] is False
        out = _post(base, "/models/apply", {"id": "local@tiny-gallery-model"})
        job = _wait_job(service, out["uuid"])
        assert job["status"] == "done" and job["progress"] == 100.0, job
        with urllib.request.urlopen(base + out["status"], timeout=30) as r:
            assert json.loads(r.read())["status"] == "done"
        with urllib.request.urlopen(base + "/models/available", timeout=30) as r:
            assert json.loads(r.read())[0]["installed"] is True
        got = _post(base, "/v1/chat/completions", {"model": "tiny-gallery-model", **chat})
        want = _post(base, "/v1/chat/completions", {"model": "direct", **chat})
        assert got["choices"][0]["message"] == want["choices"][0]["message"]
        _post(base, "/models/delete/tiny-gallery-model", {})
        assert not (models / "tiny-gallery-model.yaml").exists()
        assert not (models / "tiny-gallery-model").exists()
        with pytest.raises(urllib.error.HTTPError):
            _post(base, "/v1/chat/completions", {"model": "tiny-gallery-model", **chat})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/models/delete/nope", {})  # nothing installed under that name
        assert e.value.code == 404
    finally:
        server.shutdown()
        manager.shutdown()


def test_inline_install_bad_sha_and_management(gallery, tmp_path):
    service = GalleryService(str(tmp_path))
    src = gallery / "artifacts" / "tiny-hf" / "config.json"
    uuid = service.apply(name="inline-model", overrides={"context_size": 64},
                         files=[{"filename": "config.json", "uri": f"file://{src}",
                                 "sha256": _sha(src)}])
    assert _wait_job(service, uuid)["status"] == "done"
    cfg = yaml.safe_load((tmp_path / "inline-model.yaml").read_text())
    assert cfg["name"] == "inline-model" and cfg["context_size"] == 64
    assert cfg["model"].endswith("inline-model")
    uuid = service.apply(name="bad-sha", files=[{"filename": "x", "uri": f"file://{src}",
                                                 "sha256": "0" * 64}])
    job = _wait_job(service, uuid)
    assert job["status"] == "error" and "sha256 mismatch" in job["error"]
    service.add_gallery("a", "file:///nonexistent/index.yaml")
    with pytest.raises(ValueError):
        service.add_gallery("a", "file:///other")
    assert service.list_available() == []  # a broken gallery is logged, not fatal
    assert service.remove_gallery("a") is True and service.remove_gallery("a") is False


def test_path_traversal_rejected(tmp_path):
    root = tmp_path / "models"
    root.mkdir()
    service = GalleryService(str(root))
    for name in ("../evil", "a/b"):
        with pytest.raises(ValueError):
            service.apply(name=name, files=[{"uri": "file:///x"}])
    for name in ("..", "a/../../b"):
        with pytest.raises(ValueError):
            service.delete_model(name)
    src = tmp_path / "payload"
    src.write_bytes(b"x")
    job = _wait_job(service, service.apply(
        name="esc", files=[{"filename": "../../outside", "uri": f"file://{src}"}]))
    assert job["status"] == "error" and "escapes" in job["error"]
    assert not (tmp_path / "outside").exists()


def test_starter_gallery_is_the_default_and_parses():
    from localai_tpu.config.model_config import ModelConfig as JaxModelConfig
    from localai_tpu_torch.config.model_config import ModelConfig

    cfg = ApplicationConfig.from_env()
    assert [g["name"] for g in cfg.galleries] == ["localai-tpu"]
    assert cfg.galleries[0]["url"] == tgal.builtin_gallery_url()
    assert cfg.galleries[0]["url"].startswith("file://")
    entries = load_index(Gallery("localai-tpu", tgal.builtin_gallery_url()), ttl=0)
    jax_entries = jgal.load_index(jgal.Gallery("localai-tpu", jgal.builtin_gallery_url()), ttl=0)
    assert len(entries) >= 25
    assert [(e.name, e.files, e.overrides) for e in entries] == \
        [(e.name, e.files, e.overrides) for e in jax_entries]
    for e in entries:
        c = ModelConfig.from_dict({"name": e.name, **e.overrides})
        assert c.to_dict() == JaxModelConfig.from_dict({"name": e.name, **e.overrides}).to_dict()
        assert e.files or c.model, e.name


def test_hf_whole_repo_install_fetches_from_the_configured_hub(hub, tmp_path):
    service = GalleryService(str(tmp_path), hf_endpoint=hub.url)
    uid = service.apply(name="hfmodel", overrides={"backend": "llama",
                                                   "model": "hf://acme/some-repo"})
    job = _wait_job(service, uid)
    assert job["status"] == "done", job
    cfg = yaml.safe_load((tmp_path / "hfmodel.yaml").read_text())
    assert cfg["model"] == str(tmp_path / "hfmodel")
    assert (tmp_path / "hfmodel" / "model.safetensors").read_bytes() == FakeHub.FILES[
        "model.safetensors"]
