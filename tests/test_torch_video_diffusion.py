"""The port's AnimateDiff path (models/video_diffusion.py, the engine's
motion video, /v1/videos) against the JAX package on the CPU: a tiny
MotionAdapter written by the port's save_motion_adapter beside the tiny SD
checkpoint of test_torch_latent_diffusion, loaded by both packages. The
motion UNet holds to 1e-4 of the largest |value|; 2-step videos (text and
image anchored) to 1e-3 and one uint8 level on the JAX draws.
"""

import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from localai_tpu.models import latent_diffusion as jld  # noqa: E402
from localai_tpu.models import video_diffusion as jvd  # noqa: E402
from localai_tpu_torch.models import latent_diffusion as ld  # noqa: E402
from localai_tpu_torch.models import video_diffusion as vd  # noqa: E402
from tests.test_torch_latent_diffusion import (  # noqa: E402
    LAT,
    SIZE,
    TINY,
    close,
    image_close,
    nchw,
    nhwc,
)

MOTION = vd.MotionConfig(block_out_channels=(32, 64), layers_per_block=1, num_heads=4,
                         max_seq_length=16, norm_num_groups=8)
FRAMES = 3


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    ld.save_diffusers(TINY, str(root / "sd"), seed=3, device="cpu")
    vd.save_motion_adapter(MOTION, str(root / "sd" / "motion_adapter"), seed=8, device="cpu")
    jcfg, jp, _ = jld.load_pipeline(str(root / "sd"))
    jm = jvd.load_motion_adapter(str(root / "sd" / "motion_adapter"))
    pcfg, pp, tok = ld.load_pipeline(str(root / "sd"), device="cpu")
    pm = vd.load_motion_adapter(str(root / "sd" / "motion_adapter"), device="cpu")

    def ids(text):
        return np.asarray([tok(text, padding="max_length", max_length=77,
                               truncation=True)["input_ids"]], np.int32)

    return dict(root=root, jcfg=jcfg, jp=jp, jm=jm, pcfg=pcfg, pp=pp, pm=pm,
                cond=ids("a wave breaking"), uncond=ids(""))


def test_motion_adapter_loads_in_both_packages(video):
    assert vd.is_motion_adapter_dir(str(video["root"] / "sd" / "motion_adapter"))
    (jcfg, jparams), (pcfg, pparams) = video["jm"], video["pm"]
    assert (pcfg.num_heads, pcfg.max_seq_length, pcfg.norm_num_groups) == \
        (jcfg.num_heads, jcfg.max_seq_length, jcfg.norm_num_groups) == (4, 16, 8)
    carried = ld.params_from_jax({n: np.asarray(v) for n, v in jparams.items()}, device="cpu")
    assert set(carried) == set(pparams)
    assert all(torch.equal(carried[n], t) for n, t in pparams.items())


def test_motion_unet_forward_matches_jax(video):
    rng = np.random.default_rng(0)
    B = 2
    x = rng.standard_normal((B * FRAMES, LAT, LAT, 4)).astype(np.float32)
    t = np.full((B * FRAMES,), 400.0, np.float32)
    ctx = rng.standard_normal((B * FRAMES, 77, 32)).astype(np.float32)
    fwd = jax.jit(lambda p, mp, x, t, c: jvd.motion_unet_forward(
        video["jcfg"].unet, video["jm"][0], p, mp, x, t, c, FRAMES))
    a = fwd(video["jp"]["unet"], video["jm"][1], jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx))
    b = vd.motion_unet_forward(video["pcfg"].unet, video["pm"][0], video["pp"]["unet"],
                               video["pm"][1], nchw(x), torch.from_numpy(t),
                               torch.from_numpy(ctx), FRAMES)
    close(a, nhwc(b))


@pytest.mark.parametrize("anchored", [False, True], ids=["text", "image_anchored"])
def test_generate_video_matches_jax_on_its_draws(video, anchored):
    key = jax.random.key(6)
    src = np.random.default_rng(1).random((1, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(init_image=src, strength=0.5) if anchored else {}
    a = jvd.generate_video(video["jcfg"], video["jp"], *video["jm"],
                           jnp.asarray(video["cond"]), jnp.asarray(video["uncond"]), key,
                           frames=FRAMES, steps=2, guidance=5.0, height=SIZE, width=SIZE,
                           **{k: (jnp.asarray(v) if k == "init_image" else v)
                              for k, v in kw.items()})
    _, nk = jax.random.split(key)
    noise = nchw(jax.random.normal(nk, (FRAMES, LAT, LAT, 4), jnp.float32))
    b = vd.generate_video(video["pcfg"], video["pp"], *video["pm"],
                          torch.from_numpy(video["cond"]), torch.from_numpy(video["uncond"]),
                          frames=FRAMES, steps=2, guidance=5.0, height=SIZE, width=SIZE,
                          init_noise=noise, **{k: (nchw(v) if k == "init_image" else v)
                                               for k, v in kw.items()})
    image_close(a, nhwc(b))
    with pytest.raises(ValueError, match="exceeds the motion adapter's max sequence length"):
        vd.generate_video(video["pcfg"], video["pp"], *video["pm"],
                          torch.from_numpy(video["cond"]), torch.from_numpy(video["uncond"]),
                          frames=17)


def test_videos_route_runs_the_motion_unet(video, tmp_path):
    """/v1/videos through the port's server on the checkpoint with its
    bundled motion_adapter/ (a GIF without OpenCV); past the adapter's
    window the JAX engine's 400."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.engine.image_engine import LatentDiffusionEngine
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.image_api import ImageApi

    root = tmp_path / "models"
    root.mkdir()
    os.symlink(video["root"] / "sd", root / "sd")
    (root / "anim.yaml").write_text(yaml.safe_dump(
        {"name": "anim", "backend": "diffusers", "model": "sd"}))
    (root / "anim-bad.yaml").write_text(yaml.safe_dump(
        {"name": "anim-bad", "backend": "diffusers", "model": "sd",
         "options": {"motion_adapter": "sd/vae"}}))
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(root))
    manager = ModelManager(app, device="cpu")
    router = Router()
    oai = OpenAIApi(manager)
    oai.register(router)
    ImageApi(manager, oai, str(tmp_path / "out")).register(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body):
        req = urllib.request.Request(base + "/v1/videos", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, body = post({"model": "anim", "prompt": "a wave", "n_frames": FRAMES,
                             "steps": 2, "seed": 1})
        assert status == 200 and body["data"][0]["url"].startswith("/generated-videos/")
        eng = manager.get("anim").engine
        assert isinstance(eng, LatentDiffusionEngine) and eng.motion is not None
        a = eng.generate_video("a wave", n_frames=FRAMES, steps=2, seed=1)
        b = eng.generate_video("a wave", n_frames=FRAMES, steps=2, seed=1)
        assert len(a) == FRAMES and all(np.array_equal(x, y) for x, y in zip(a, b))
        status, body = post({"model": "anim", "prompt": "a wave", "n_frames": 17})
        assert status == 400 and "exceeds the motion adapter's trained window" in \
            body["error"]["message"]
        with pytest.raises(RuntimeError, match="is not a diffusers MotionAdapter dir"):
            manager.get("anim-bad")
    finally:
        server.shutdown()
        manager.shutdown()
