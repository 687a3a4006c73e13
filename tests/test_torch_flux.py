"""The port's Flux pipeline (models/flux.py, engine FluxEngine) against the
JAX package on the CPU: a tiny FluxPipeline-layout checkpoint written by
the port's save_flux (f32) is loaded by both, then T5, the MMDiT forward,
the packing, the flow sigmas and 2-step generates (text → image and
img2img) are compared on the same seeded inputs and noise (the JAX
generate's noise is jax.random.normal of its key, handed to the port).
Forwards hold to 1e-4 of the largest |value|, images to 1e-3 and one uint8
level. Then the checkpoint is served through the port's manager.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from localai_tpu.models import flux as jfx  # noqa: E402
from localai_tpu_torch.models import flux as fx  # noqa: E402
from localai_tpu_torch.models import latent_diffusion as ld  # noqa: E402
from tests.test_torch_latent_diffusion import close, image_close, nchw, nhwc  # noqa: E402

# The JAX tests' tiny geometry (tests/test_flux.py).
TINY = fx.FluxPipelineConfig(
    clip=ld.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4),
    t5=fx.T5EncoderConfig(vocab_size=1000, d_model=24, d_kv=6, d_ff=48, num_layers=2,
                          num_heads=4, rel_buckets=8, rel_max_distance=16),
    transformer=fx.FluxTransformerConfig(in_channels=16, num_layers=2, num_single_layers=2,
                                         attention_head_dim=8, num_attention_heads=2,
                                         joint_attention_dim=24, pooled_projection_dim=32,
                                         axes_dims_rope=(4, 2, 2)),
    vae=ld.VAEConfig(latent_channels=4, block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, scaling_factor=0.3611, shift_factor=0.1159),
    t5_max_length=16,
)
SIZE = 16  # latent 8 (the VAE scales by 2), 16 packed tokens


@pytest.fixture(scope="module")
def flux(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-flux") / "flux")
    fx.save_flux(TINY, d, seed=4, device="cpu")
    jcfg, jp, _ = jfx.load_flux_pipeline(d, dtype=jnp.float32)
    pcfg, pp, (tok, tok2) = fx.load_flux_pipeline(d, dtype=torch.float32, device="cpu")
    prompt = "a photo of a cat"
    cids = np.asarray([tok(prompt, padding="max_length", max_length=77,
                           truncation=True)["input_ids"]] * 2, np.int32)
    tids = np.asarray([tok2(prompt, padding="max_length", max_length=pcfg.t5_max_length,
                            truncation=True)["input_ids"]] * 2, np.int32)
    return dict(dir=d, jcfg=jcfg, jp=jp, pcfg=pcfg, pp=pp, cids=cids, tids=tids)


def test_checkpoint_config_and_tensors_match_jax(flux):
    assert fx.is_flux_dir(flux["dir"]) and flux["pcfg"].t5_max_length == 16
    carried = ld.params_from_jax({k: {n: np.asarray(v) for n, v in part.items()}
                                  for k, part in flux["jp"].items()}, device="cpu")
    for part, tensors in flux["pp"].items():
        assert set(carried[part]) == set(tensors)
        assert all(torch.equal(carried[part][n], t) for n, t in tensors.items()), part
    assert flux["tids"][0, -1] == 0  # the T5 tokenizer pads with id 0


def test_t5_and_pooled_conditioning_match_jax(flux):
    mask = (flux["tids"] != 0).astype(np.int32)
    for m in (None, mask):
        a = jax.jit(lambda p, i, m: jfx.t5_encode(flux["jcfg"].t5, p, i, m))(
            flux["jp"]["t5"], jnp.asarray(flux["tids"]), None if m is None else jnp.asarray(m))
        b = fx.t5_encode(flux["pcfg"].t5, flux["pp"]["t5"], torch.from_numpy(flux["tids"]),
                         None if m is None else torch.from_numpy(m))
        close(a, b)
    rel = np.arange(-40, 41)[None]
    assert np.array_equal(np.asarray(jfx._t5_bucket(jnp.asarray(rel), 32, 128)),
                          fx._t5_bucket(torch.from_numpy(rel), 32, 128).numpy())
    with jax.disable_jit():
        _, fin = jfx.clip_hidden_states(flux["jcfg"].clip, flux["jp"]["clip"],
                                        jnp.asarray(flux["cids"]))
        jpool = jfx.clip_pooled_projection(flux["jcfg"].clip, flux["jp"]["clip"],
                                           jnp.asarray(flux["cids"]), fin)
    _t, ppool = fx.encode_prompt(flux["pcfg"], flux["pp"], torch.from_numpy(flux["cids"]),
                                 torch.from_numpy(flux["tids"]))
    close(jpool, ppool)


def test_mmdit_forward_matches_jax(flux):
    rng = np.random.default_rng(0)
    L, T = 16, 16
    img = rng.standard_normal((2, L, 16)).astype(np.float32)
    txt = rng.standard_normal((2, T, 24)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    t = np.array([0.9, 0.2], np.float32)
    ids = jfx.image_ids(8, 8)
    assert np.array_equal(ids, fx.image_ids(8, 8))
    a = jax.jit(lambda p, *a: jfx.flux_forward(flux["jcfg"].transformer, p, *a))(
        flux["jp"]["transformer"], jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pooled),
        jnp.asarray(t), jnp.asarray(ids), None, jnp.asarray([3.5, 1.0]))
    b = fx.flux_forward(flux["pcfg"].transformer, flux["pp"]["transformer"],
                        torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(pooled),
                        torch.from_numpy(t), torch.from_numpy(ids),
                        guidance=torch.tensor([3.5, 1.0]))
    close(a, b)


def test_packing_and_flow_sigmas_match_jax():
    lat = np.random.default_rng(1).standard_normal((2, 6, 4, 3)).astype(np.float32)
    packed = jfx.pack_latents(jnp.asarray(lat))
    assert np.array_equal(np.asarray(packed), fx.pack_latents(nchw(lat)).numpy())
    assert np.array_equal(lat, nhwc(fx.unpack_latents(torch.from_numpy(np.array(packed)), 6, 4)))
    for dyn in (True, False):
        js = jfx.FluxSchedulerConfig(use_dynamic_shifting=dyn)
        ps = fx.FluxSchedulerConfig(use_dynamic_shifting=dyn)
        for steps, L in ((4, 4096), (20, 1024)):
            assert np.array_equal(jfx.flow_sigmas(js, steps, L), fx.flow_sigmas(ps, steps, L))


@pytest.mark.parametrize("img2img", [False, True], ids=["text", "img2img"])
def test_generate_matches_jax_on_its_noise(flux, img2img):
    key = jax.random.key(3)
    noise = jax.random.normal(key, (2, 8, 8, 4), jnp.float32)
    src = np.random.default_rng(2).random((2, SIZE, SIZE, 3)).astype(np.float32)
    a = jax.jit(lambda p, c, t, k, s: jfx.generate(
        flux["jcfg"], p, c, t, k, steps=2, guidance=3.5, height=SIZE, width=SIZE,
        init_image=s, strength=0.5 if img2img else 0.8))(
            flux["jp"], jnp.asarray(flux["cids"]), jnp.asarray(flux["tids"]), key,
            jnp.asarray(src) if img2img else None)
    b = fx.generate(flux["pcfg"], flux["pp"], torch.from_numpy(flux["cids"]),
                    torch.from_numpy(flux["tids"]), steps=2, guidance=3.5, height=SIZE,
                    width=SIZE, init_image=nchw(src) if img2img else None,
                    strength=0.5 if img2img else 0.8, init_noise=nchw(noise))
    image_close(a, nhwc(b))


def test_flux_checkpoint_serves_through_the_manager(flux, tmp_path):
    """backend: diffusers on a Flux dir loads FluxEngine (options.dtype, bf16
    by default); its refusals are the JAX engine's; a seed repeats its bytes."""
    import os

    import yaml

    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.engine.image_engine import FluxEngine
    from localai_tpu_torch.server.manager import ModelManager

    root = tmp_path / "models"
    root.mkdir()
    os.symlink(flux["dir"], root / "flux")
    for name, opts in (("f16", {}), ("f32", {"dtype": "float32"}), ("bad", {"dtype": "fp8"}),
                       ("lora", {})):
        doc = {"name": name, "backend": "diffusers", "model": "flux", "options": opts}
        if name == "lora":
            doc["lora_adapters"] = ["x.safetensors"]
        (root / f"{name}.yaml").write_text(yaml.safe_dump(doc))
    manager = ModelManager(ApplicationConfig(models_dir=str(root)), device="cpu")
    try:
        eng = manager.get("f16").engine
        assert isinstance(eng, FluxEngine)
        assert next(iter(eng.params["transformer"].values())).dtype == torch.bfloat16
        f32 = manager.get("f32").engine
        imgs = f32.generate("a cat", n=2, steps=2, seed=5, size=(SIZE, SIZE))
        again = f32.generate("a cat", n=2, steps=2, seed=5, size=(SIZE, SIZE))
        assert imgs[0].shape == (SIZE, SIZE, 3) and imgs[0].dtype == np.uint8
        assert all(np.array_equal(x, y) for x, y in zip(imgs, again))
        with pytest.raises(ValueError, match="do not serve inpainting"):
            f32.inpaint("a", imgs[0], imgs[0][..., 0])
        with pytest.raises(ValueError, match="flow-matching euler schedule only"):
            f32.generate("a", scheduler="ddim", size=(SIZE, SIZE))
        # the manager answers a failed load with RuntimeError naming the cause
        with pytest.raises(RuntimeError, match=r"options.dtype 'fp8' — use bfloat16 or float32"):
            manager.get("bad")
        with pytest.raises(RuntimeError, match="Flux LoRA is unsupported"):
            manager.get("lora")
    finally:
        manager.shutdown()
