"""The DiT presets (models/diffusion.py), the image engines and the image
routes of the port against the JAX package on the CPU, and the port's own
PNG / GIF encoders against PIL.

The DiT runs from the JAX package's random tree (carried by
params_from_numpy) on the JAX draws. The HTTP tests start both servers on
one models dir (an own-format DiT checkpoint the JAX package saved and a
tiny diffusers checkpoint the port wrote) and hand the port's engine the
JAX engine's noise for the request's seed (image_engine._randn patched), so
the decoded pixels agree within one uint8 level; every bad input gets the
JAX server's status and message.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

PIL = pytest.importorskip("PIL.Image")

from localai_tpu.models import diffusion as jdit  # noqa: E402
from localai_tpu_torch.engine import image_engine  # noqa: E402
from localai_tpu_torch.models import diffusion as dit  # noqa: E402
from localai_tpu_torch.models import latent_diffusion as ld  # noqa: E402
from localai_tpu_torch.server.images import encode_png, to_gray  # noqa: E402
from localai_tpu_torch.utils.video_io import encode_gif, write_video  # noqa: E402
from tests.test_torch_latent_diffusion import TINY, close  # noqa: E402

CFG = dit.DIFFUSION_PRESETS["dit-test"]


@pytest.fixture(scope="module")
def dparams():
    jp = jdit.init_params(jdit.DIFFUSION_PRESETS["dit-test"], jax.random.key(0))
    # adaLN and the output head start at zero there: give them weight so
    # every path of the block is exercised
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for k in ("mod_w", "mod_b"):
        jp["blocks"][k] = rng.standard_normal(jp["blocks"][k].shape).astype(np.float32) * 0.05
    jp["out_w"] = rng.standard_normal(jp["out_w"].shape).astype(np.float32) * 0.05
    return jp, dit.params_from_numpy(jp, device="cpu")


def _ids(text, n=2):
    data = text.encode()[: CFG.text_ctx]
    ids = np.zeros((n, CFG.text_ctx), np.int32)
    ids[:, : len(data)] = np.frombuffer(data, np.uint8)
    return ids


# --------------------------------------------------------------------------- #
# DiT
# --------------------------------------------------------------------------- #


def test_dit_denoise_and_text_encoder_match_jax(dparams):
    jp, pp = dparams
    ids = _ids("a red cube")
    close(jdit.encode_text(CFG, jp, jnp.asarray(ids)),
          dit.encode_text(CFG, pp, torch.from_numpy(ids)))
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([900.0, 12.0], np.float32)
    ctx = rng.standard_normal((2, CFG.text_ctx, CFG.d_model)).astype(np.float32)
    close(jdit.denoise(CFG, jp, jnp.asarray(img), jnp.asarray(t), jnp.asarray(ctx)),
          dit.denoise(CFG, pp, torch.from_numpy(img), torch.from_numpy(t), torch.from_numpy(ctx)))


@pytest.mark.parametrize("mode", ["generate", "inpaint"])
def test_dit_sampling_matches_jax_on_its_draws(dparams, mode):
    jp, pp = dparams
    key, ids = jax.random.key(5), _ids("a blue sphere", 1)
    steps = 3
    if mode == "generate":
        a = jdit.generate(CFG, jp, jnp.asarray(ids), key, steps=steps, guidance=4.0)
        b = dit.generate(CFG, pp, torch.from_numpy(ids), steps=steps, guidance=4.0,
                         noise=torch.from_numpy(np.array(jax.random.normal(key, (1, 16, 16, 3)))))
    else:
        rng = np.random.default_rng(2)
        image = rng.random((1, 16, 16, 3)).astype(np.float32)
        mask = np.zeros((1, 16, 16), np.float32)
        mask[:, 4:12, 2:9] = 1.0
        a = jdit.inpaint(CFG, jp, jnp.asarray(ids), jnp.asarray(image), jnp.asarray(mask), key,
                         steps=steps, guidance=4.0)
        k, nk = jax.random.split(key)
        x = np.array(jax.random.normal(nk, (1, 16, 16, 3)))
        z = np.stack([np.array(jax.random.normal(kk, (1, 16, 16, 3)))
                      for kk in jax.random.split(k, steps)])
        b = dit.inpaint(CFG, pp, torch.from_numpy(ids), torch.from_numpy(image),
                        torch.from_numpy(mask), steps=steps, guidance=4.0,
                        noise=torch.from_numpy(x), noise_steps=torch.from_numpy(z))
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-3


def test_dit_checkpoints_cross_between_the_packages(dparams, tmp_path):
    jp, pp = dparams
    jdit.save_diffusion(CFG, jp, str(tmp_path / "jax"))
    cfg, loaded = dit.load_diffusion(str(tmp_path / "jax"), device="cpu")
    assert cfg == CFG
    for k, v in pp.items():
        for sub, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            got = loaded[k][sub] if sub else loaded[k]
            assert torch.equal(got, t), (k, sub)
    dit.save_diffusion(CFG, pp, str(tmp_path / "port"))
    jcfg, jl = jdit.load_diffusion(str(tmp_path / "port"))
    assert jcfg.name == "dit-test"
    assert np.array_equal(np.asarray(jl["blocks"]["q_w"]), jp["blocks"]["q_w"])
    own = dit.init_params(CFG, seed=0, device="cpu")  # the port's preset draw
    assert jax.tree_util.tree_structure({k: v for k, v in own.items()}) == \
        jax.tree_util.tree_structure({k: v for k, v in pp.items()})


# --------------------------------------------------------------------------- #
# Encoders
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 30)], ids=["rgb", "gray"])
def test_png_encoder_round_trips_through_pil(shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    back = np.asarray(PIL.open(io.BytesIO(encode_png(img))))
    assert back.shape == img.shape and np.array_equal(back, img)
    rgb = np.random.default_rng(4).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    assert np.array_equal(to_gray(rgb), np.asarray(PIL.fromarray(rgb).convert("L")))


def _gif_frames(data: bytes) -> tuple[list, dict]:
    im = PIL.open(io.BytesIO(data))
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB")))
    return out, im.info


@pytest.mark.parametrize("colors", [200, None], ids=["palette_exact", "colour_cube"])
def test_gif_encoder_decodes_in_pil(colors, tmp_path):
    rng = np.random.default_rng(5)
    if colors:
        pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
        frames = [pal[rng.integers(0, colors, (40, 24))] for _ in range(4)]
    else:
        frames = [rng.integers(0, 256, (40, 24, 3), dtype=np.uint8) for _ in range(4)]
    got, info = _gif_frames(encode_gif(frames, frame_ms=125))
    assert len(got) == 4 and info["loop"] == 0 and info["duration"] == 120
    err = max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(got, frames))
    assert err == 0 if colors else err <= 43  # half a 3-3-2 cube step
    name, ctype = write_video(str(tmp_path), frames, fmt="gif")
    assert ctype == "image/gif" and name.endswith(".gif")


# --------------------------------------------------------------------------- #
# The HTTP routes, both servers
# --------------------------------------------------------------------------- #


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def image_servers(tmp_path_factory, dparams):
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.image_api import ImageApi as JaxImageApi
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.image_api import ImageApi

    root = tmp_path_factory.mktemp("image-models")
    jdit.save_diffusion(CFG, dparams[0], str(root / "dit"))
    ld.save_diffusers(TINY, str(root / "sd"), seed=3, device="cpu")
    for doc in ({"name": "dit", "backend": "diffusion", "model": "dit"},
                {"name": "sd", "backend": "diffusers", "model": "sd"},
                {"name": "sd-bad", "backend": "diffusers", "model": "sd",
                 "options": {"scheduler": "warp"}},
                {"name": "preset-lora", "backend": "diffusion", "model": "dit-test",
                 "lora_adapters": ["x.safetensors"]},
                {"name": "sd-bf16", "backend": "diffusers", "model": "sd",
                 "options": {"dtype": "bf16"}},
                {"name": "sd-fp8", "backend": "diffusers", "model": "sd",
                 "options": {"dtype": "fp8"}}):
        (root / f"{doc['name']}.yaml").write_text(yaml.safe_dump(doc))
    d = str(root)
    jm = JaxModelManager(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d))
    jr = JaxRouter()
    joai = JaxOpenAIApi(jm)
    joai.register(jr)
    JaxImageApi(jm, joai, str(root / "jax-out")).register(jr)
    js = jax_create_server(JaxAppConfig(address="127.0.0.1", port=0, models_dir=d), jr)
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=d)
    tm = ModelManager(app, device="cpu")
    tr = Router()
    oai = OpenAIApi(tm)
    oai.register(tr)
    ImageApi(tm, oai, str(root / "port-out")).register(tr)
    ts = create_server(app, tr)
    yield {"jax": _serve(js), "port": _serve(ts), "port_manager": tm}
    for s in (js, ts):
        s.shutdown()
    jm.shutdown()
    tm.shutdown()


def _req(base, path, payload=None, raw=None, headers=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
            ctype = r.headers.get("Content-Type", "")
            return r.status, (json.loads(body) if "json" in ctype else body), ctype
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), ""


def _jax_draws(model: str, seed: int, n: int) -> list[torch.Tensor]:
    """The JAX engine's noise for a request: the DiT's normal(key(seed)); the
    latent pipeline's normal of the key's second half (NCHW for the port)."""
    key = jax.random.key(seed)
    if model == "dit":
        return [torch.from_numpy(np.array(jax.random.normal(key, (n, 16, 16, 3))))]
    _, nk = jax.random.split(key)
    x = np.array(jax.random.normal(nk, (n, 8, 8, 4)))
    return [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()]


def _pixels(entry) -> np.ndarray:
    return np.asarray(PIL.open(io.BytesIO(base64.b64decode(entry["b64_json"]))).convert("RGB"))


@pytest.mark.parametrize("model, n", [("dit", 2), ("sd", 1)])
def test_generations_match_the_jax_server_on_its_noise(image_servers, monkeypatch, model, n):
    body = {"model": model, "prompt": "a photo of a cat", "n": n, "steps": 3, "seed": 9,
            "response_format": "b64_json", "size": "16x16"}
    sj, bj, _ = _req(image_servers["jax"], "/v1/images/generations", body)
    draws = iter(_jax_draws(model, 9, n))
    monkeypatch.setattr(image_engine, "_randn", lambda gen, shape, device: next(draws))
    sp, bp, _ = _req(image_servers["port"], "/v1/images/generations", body)
    assert sj == sp == 200 and len(bp["data"]) == n
    for a, b in zip(bj["data"], bp["data"]):
        pa, pb = _pixels(a), _pixels(b)
        assert pa.shape == pb.shape == (16, 16, 3)
        assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1


def test_urls_seeds_and_the_generated_files(image_servers):
    base = image_servers["port"]
    body = {"model": "sd", "prompt": "a red sofa", "steps": 2, "seed": 3}
    s1, b1, _ = _req(base, "/v1/images/generations", body)
    s2, b2, _ = _req(base, "/images/generations", {**body, "response_format": "b64_json"})
    assert s1 == s2 == 200
    status, png, ctype = _req(base, b1["data"][0]["url"])
    assert status == 200 and ctype == "image/png"
    assert png == base64.b64decode(b2["data"][0]["b64_json"])  # a seed repeats its bytes
    assert _req(base, "/generated-images/nope.png")[0] == 404
    assert _req(base, "/generated-images/..%2Fx")[0] in (400, 404)


def _multipart(fields: dict) -> tuple[bytes, str]:
    bnd = "----localai-test"
    parts = []
    for k, v in fields.items():
        if isinstance(v, bytes):
            parts.append(f'--{bnd}\r\nContent-Disposition: form-data; name="{k}"; '
                         f'filename="{k}.png"\r\nContent-Type: image/png\r\n\r\n'.encode()
                         + v + b"\r\n")
        else:
            parts.append(f'--{bnd}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                         f"{v}\r\n".encode())
    return b"".join(parts) + f"--{bnd}--\r\n".encode(), f"multipart/form-data; boundary={bnd}"


def _png(img) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_inpainting_and_videos_answer(image_servers):
    base = image_servers["port"]
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 2:6] = 255
    for model in ("dit", "sd"):
        raw, ctype = _multipart({"model": model, "prompt": "a cat", "steps": "2", "seed": "4",
                                 "image": _png(img), "mask": _png(mask),
                                 "response_format": "b64_json"})
        status, body, _ = _req(base, "/v1/images/inpainting", raw=raw,
                               headers={"Content-Type": ctype})
        assert status == 200, body
        assert _pixels(body["data"][0]).shape == (16, 16, 3)
    status, body, _ = _req(base, "/v1/videos", {"model": "dit", "prompt": "a wave",
                                                "n_frames": 3, "steps": 2, "format": "gif"})
    assert status == 200
    status, gif, ctype = _req(base, body["data"][0]["url"])
    assert status == 200 and ctype == "image/gif"
    assert len(_gif_frames(gif)[0]) == 3


def test_the_web_ui_image_tab_reaches_a_route(tmp_path):
    from localai_tpu_torch.__main__ import build_app
    from localai_tpu_torch.config import ApplicationConfig

    manager, router, jobs = build_app(ApplicationConfig(models_dir=str(tmp_path)), device="cpu")
    try:
        declared = [(m, p) for m, p, _h in router.declared]
        routes = [("POST", "/v1/images/generations"), ("POST", "/images/generations"),
                  ("POST", "/v1/images/inpainting"), ("POST", "/v1/videos"),
                  ("GET", "/generated-images/:name"), ("GET", "/generated-videos/:name")]
        assert all(r in declared for r in routes)
        # the JAX CLI's order: after audio, before rerank
        order = [p for _m, p in declared]
        assert order.index("/v1/vad") < order.index("/v1/images/generations") < \
            order.index("/v1/rerank")
    finally:
        jobs.stop()
        manager.shutdown()


SRC = base64.b64encode(encode_png(np.zeros((16, 16, 3), np.uint8))).decode()
BAD = [
    ("/v1/images/generations", {"model": "dit"}),
    ("/v1/images/generations", {"model": "dit", "prompt": "x", "n": 9}),
    ("/v1/images/generations", {"model": "dit", "prompt": "x", "size": "big"}),
    ("/v1/images/generations", {"model": "dit", "prompt": "x", "size": "4x4"}),
    ("/v1/images/generations", {"model": "sd", "prompt": "x", "image": "AAAA"}),
    ("/v1/images/generations", {"model": "sd", "prompt": "x", "strength": "lots",
                                "image": SRC}),
    ("/v1/images/generations", {"model": "sd", "prompt": "x", "steps": 1,
                                "control_image": base64.b64encode(b"\x89PNG?").decode()}),
    ("/v1/images/generations", {"model": "dit", "prompt": "x", "image": SRC}),
    ("/v1/videos", {"model": "dit", "prompt": "x", "n_frames": 1}),
    ("/v1/videos", {"model": "dit", "prompt": "x", "format": "avi"}),
    ("/v1/videos", {"model": "dit", "prompt": "x", "frame_ms": "slow"}),
]


@pytest.mark.parametrize("path, body", BAD, ids=[f"{p.split('/')[-1]}-{i}"
                                                 for i, (p, _b) in enumerate(BAD)])
def test_bad_inputs_get_the_jax_servers_400(image_servers, path, body):
    sj, bj, _ = _req(image_servers["jax"], path, body)
    sp, bp, _ = _req(image_servers["port"], path, body)
    assert sj == sp == 400, (bj, bp)
    # a decoder's own words after the colon may differ (and carry addresses)
    assert bp["error"]["message"].split(":")[0] == bj["error"]["message"].split(":")[0]


def test_control_image_without_controlnet_and_load_refusals(image_servers):
    src = base64.b64encode(_png(np.zeros((16, 16, 3), np.uint8))).decode()
    body = {"model": "sd", "prompt": "x", "steps": 1, "control_image": src}
    for side in ("jax", "port"):
        status, out, _ = _req(image_servers[side], "/v1/images/generations", body)
        assert status == 400 and "no controlnet/ weights" in out["error"]["message"]
    manager = image_servers["port_manager"]
    with pytest.raises(RuntimeError, match="unknown scheduler 'warp'"):
        manager.get("sd-bad")
    with pytest.raises(RuntimeError, match="not a synthetic preset"):
        manager.get("preset-lora")
    # options.dtype: the checkpoint's stored f32 unless set
    stored = manager.get("sd").engine.params["unet"]
    cast = manager.get("sd-bf16").engine.params["unet"]
    assert {t.dtype for t in stored.values()} == {torch.float32}
    assert {t.dtype for t in cast.values()} == {torch.bfloat16}
    with pytest.raises(RuntimeError, match=r"options.dtype 'fp8' — use bfloat16 or float32"):
        manager.get("sd-fp8")
