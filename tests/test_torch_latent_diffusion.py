"""The port's latent diffusion (models/latent_diffusion.py) against the JAX
package on the CPU: one tiny diffusers-layout checkpoint written by the
port's save_diffusers (f32, with a ControlNet) is loaded by both packages,
then the CLIP encoder, the UNet, the ControlNet, the VAE, the sampler steps
and whole generates are compared on the same seeded inputs and noise.
Single forwards hold to 1e-4 of the largest |value|; images after 2-3
steps to 1e-3, and to one uint8 level.

The JAX side runs op by op (jax.disable_jit): at these shapes that beats
compiling one program a scheduler, and the forwards at the generates'
batch leave them their ops compiled. The ancestral and SDE
samplers get the JAX package's own draws, reproduced here by splitting
its key as its scan does.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from localai_tpu.models import latent_diffusion as jld  # noqa: E402
from localai_tpu_torch.models import latent_diffusion as ld  # noqa: E402

# The JAX tests' tiny geometry (tests/test_latent_diffusion.py).
TEXT = ld.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4)
UNET = ld.UNetConfig(sample_size=8, block_out_channels=(32, 64),
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                     attention_head_dim=4, cross_attention_dim=32, norm_num_groups=8)
VAE = ld.VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8)
TINY = ld.SDPipelineConfig(text=TEXT, unet=UNET, vae=VAE)
SIZE, LAT = 16, 8  # the VAE's two blocks scale by 2


def tiny_xl() -> ld.SDPipelineConfig:
    text2 = dataclasses.replace(TEXT, hidden_size=48, intermediate_size=96, num_attention_heads=4,
                                hidden_act="gelu", projection_dim=24)
    unet = dataclasses.replace(UNET, cross_attention_dim=32 + 48, addition_embed_type="text_time",
                               addition_time_embed_dim=8,
                               projection_class_embeddings_input_dim=24 + 6 * 8,
                               transformer_layers_per_block=(2, 1), attention_head_dim=(2, 4))
    return ld.SDPipelineConfig(text=TEXT, text2=text2, unet=unet, vae=VAE)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(a).max(), 1e-6)
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


def image_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-3, np.abs(a - b).max()
    ua, ub = (a * 255.0 + 0.5).astype(np.uint8), (b * 255.0 + 0.5).astype(np.uint8)
    assert np.abs(ua.astype(int) - ub.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def sd(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-sd") / "sd")
    ld.save_diffusers(TINY, d, seed=3, device="cpu", controlnet=True)
    jcfg, jp, _ = jld.load_pipeline(d)
    pcfg, pp, tok = ld.load_pipeline(d, device="cpu")

    def ids(text, n=2):
        enc = tok(text, padding="max_length", max_length=77, truncation=True)["input_ids"]
        return np.asarray([enc] * n, np.int32)

    return dict(dir=d, jcfg=jcfg, jp=jp, pcfg=pcfg, pp=pp, tok=tok,
                cond=ids("a photo of a cat"), uncond=ids(""))


@pytest.fixture(scope="module")
def xl(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-xl") / "xl")
    ld.save_diffusers(tiny_xl(), d, seed=5, device="cpu")
    jcfg, jp, (jt1, jt2) = jld.load_pipeline(d)
    pcfg, pp, (t1, t2) = ld.load_pipeline(d, device="cpu")

    def ids(tok, text):
        return np.asarray([tok(text, padding="max_length", max_length=77,
                               truncation=True)["input_ids"]] * 2, np.int32)

    return dict(jcfg=jcfg, jp=jp, pcfg=pcfg, pp=pp,
                ids=[ids(t, s) for t in (t1, t2) for s in ("a red sofa", "")])


def rng_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
            np.array([500.0, 20.0, 999.0, 1.0][:B], np.float32),
            rng.standard_normal((B, 77, 32)).astype(np.float32),
            rng.random((B, SIZE, SIZE, 3)).astype(np.float32))


# --------------------------------------------------------------------------- #
# The networks
# --------------------------------------------------------------------------- #


def test_checkpoint_loads_in_both_packages_with_the_same_tensors(sd):
    """The writer's files are the diffusers layout the JAX loader reads:
    every name matches, convs HWIO there are OIHW here, linears transposed,
    and params_from_jax carries the JAX dicts back to the port's tensors."""
    assert ld.is_diffusers_dir(sd["dir"])
    carried = ld.params_from_jax({k: {n: np.asarray(v) for n, v in part.items()}
                                  for k, part in sd["jp"].items()}, device="cpu")
    assert set(carried) == set(sd["pp"]) == {"text", "unet", "vae", "controlnet"}
    for part in carried:
        assert set(carried[part]) == set(sd["pp"][part])
        for name, t in sd["pp"][part].items():
            assert torch.equal(carried[part][name], t), (part, name)
    for part in ("unet", "vae"):
        assert dataclasses.asdict(getattr(sd["pcfg"], part)) == \
            dataclasses.asdict(getattr(sd["jcfg"], part))


def test_published_geometries_have_their_parameter_counts():
    """SD-1.5 at the loader's defaults: 123.1 M (CLIP-L text), 859.5 M
    (UNet), 83.7 M (VAE), 1.066 B in all; SDXL base's UNet 2.567 B."""
    cfg = ld.sd15_config()

    def count(shapes):
        return sum(int(np.prod(s)) for s in shapes.values())

    text, unet, vae = (count(ld.clip_shapes(cfg.text)), count(ld.unet_shapes(cfg.unet)),
                       count(ld.vae_shapes(cfg.vae)))
    assert (text, unet, vae) == (123060480, 859520964, 83653863)
    assert count(ld.unet_shapes(ld.sdxl_config().unet, linear=True)) == 2567463684


def test_clip_hidden_states_and_pooled_match_jax(sd):
    ids = sd["cond"]
    jpen, jfin = jld.clip_hidden_states(sd["jcfg"].text, sd["jp"]["text"], jnp.asarray(ids))
    ppen, pfin = ld.clip_hidden_states(sd["pcfg"].text, sd["pp"]["text"], torch.from_numpy(ids))
    close(jpen, ppen)
    close(jfin, pfin)
    close(jld.clip_pooled_projection(sd["jcfg"].text, sd["jp"]["text"], jnp.asarray(ids), jfin),
          ld.clip_pooled_projection(sd["pcfg"].text, sd["pp"]["text"], torch.from_numpy(ids),
                                    pfin))


@pytest.mark.parametrize("ctrl", [False, True], ids=["plain", "with_controlnet_residuals"])
def test_unet_forward_matches_jax(sd, ctrl):
    # the CFG batch of a 2-image generate, op by op: the generates below
    # find these ops compiled
    x, t, ctx, img = rng_inputs(B=4)
    jres = pres = None
    if ctrl:
        with jax.disable_jit():
            jres = jld.controlnet_forward(sd["jcfg"].unet, sd["jp"]["controlnet"],
                                          jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                          jnp.asarray(img), 0.7)
        pres = ld.controlnet_forward(sd["pcfg"].unet, sd["pp"]["controlnet"], nchw(x),
                                     torch.from_numpy(t), torch.from_numpy(ctx), nchw(img), 0.7)
        for a, b in zip(jres[0], pres[0]):
            close(a, nhwc(b))
        close(jres[1], nhwc(pres[1]))
    with jax.disable_jit():
        a = jld.unet_forward(sd["jcfg"].unet, sd["jp"]["unet"], jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx), ctrl_residuals=jres)
    b = ld.unet_forward(sd["pcfg"].unet, sd["pp"]["unet"], nchw(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), ctrl_residuals=pres)
    close(a, nhwc(b))


@pytest.mark.parametrize("part", ["decode", "encode_mode", "encode_sample"])
def test_vae_matches_jax(sd, part):
    x, _t, _ctx, img = rng_inputs(1)
    jc, pc, jp, pp = sd["jcfg"].vae, sd["pcfg"].vae, sd["jp"]["vae"], sd["pp"]["vae"]
    if part == "decode":
        close(jld.vae_decode(jc, jp, jnp.asarray(x)), nhwc(ld.vae_decode(pc, pp, nchw(x))))
        return
    key = jax.random.key(4) if part == "encode_sample" else None
    a = jld.vae_encode(jc, jp, jnp.asarray(img), key)
    z = None if key is None else nchw(jax.random.normal(key, a.shape, jnp.float32))
    close(a, nhwc(ld.vae_encode(pc, pp, nchw(img), noise=z)))


def test_attention_in_query_blocks_is_the_whole_softmax(monkeypatch):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 37, 8, generator=g) for _ in range(3))
    whole = ld.attention(q, k, v)
    monkeypatch.setattr(ld, "ATTN_BLOCK_BYTES", 2 * 3 * 37 * 4 * 5)  # 5 rows a block
    assert torch.allclose(ld.attention(q, k, v), whole, atol=1e-6)


# --------------------------------------------------------------------------- #
# Sampler steps and schedules
# --------------------------------------------------------------------------- #


def test_sampler_steps_and_schedules_match_jax():
    cfg = ld.SDPipelineConfig()
    jcfg = jld.SDPipelineConfig()
    assert np.array_equal(ld.alphas_cumprod(cfg), jld.alphas_cumprod(jcfg))
    for steps in (3, 20):
        assert np.array_equal(ld.ddim_timesteps(cfg, steps), jld.ddim_timesteps(jcfg, steps))
        for karras in (False, True):
            for a, b in zip(ld.k_schedule(cfg, steps, karras), jld.k_schedule(jcfg, steps, karras)):
                assert np.array_equal(a, b)
        sig = jld.euler_a_sigmas(jcfg, steps)
        assert np.array_equal(ld.k_schedule(cfg, steps, False)[0], sig)
        assert np.allclose(ld.lms_coefficients(sig, 4), jld.lms_coefficients(sig, 4))
    rng = np.random.default_rng(2)
    mo, x, z = (rng.standard_normal((1, 4, 5, 5)).astype(np.float32) for _ in range(3))
    acp = ld.alphas_cumprod(cfg)
    for t, tp in ((951, 901), (1, -49)):
        a = jld.ddim_step(jcfg, jnp.asarray(acp), jnp.asarray(mo), jnp.int32(t), jnp.int32(tp),
                          jnp.asarray(x))
        close(a, ld.ddim_step(cfg, acp, torch.from_numpy(mo), t, tp, torch.from_numpy(x)), 1e-6)
    for s, sn in ((14.6, 9.2), (0.3, 0.0)):
        jd, ju = jld.ancestral_sigmas(jnp.float32(s), jnp.float32(sn))
        assert np.allclose(ld.ancestral_sigmas(s, sn), (float(jd), float(ju)), rtol=1e-6)
        a = jld.euler_a_step(jnp.asarray(mo), jnp.asarray(x), jnp.float32(s), jnp.float32(sn),
                             jnp.asarray(z))
        close(a, ld.euler_a_step(torch.from_numpy(mo), torch.from_numpy(x), s, sn,
                                 torch.from_numpy(z)), 1e-6)


def test_unknown_scheduler_is_refused_with_the_jax_message():
    for name, base in (("ddim_karras", "ddim"), ("nope", "nope"), ("k_pndm", "pndm")):
        with pytest.raises(ValueError) as pe:
            ld.parse_scheduler(name)
        assert str(pe.value) == (
            f"unknown scheduler {base!r} (supported: ddim, pndm, unipc, euler, euler_a, "
            "dpmpp_2m, heun, lms, dpm_2, dpm_2_a, dpmpp_sde, dpmpp_2m_sde, plus _karras/k_ "
            "variants of euler, euler_a, dpmpp_2m, heun, lms, dpm_2, dpm_2_a, dpmpp_sde, "
            "dpmpp_2m_sde)")
    for name in sorted(ld.SUPPORTED_SCHEDULERS):
        ld.parse_scheduler(name)
    assert ld.SUPPORTED_SCHEDULERS == jld.SUPPORTED_SCHEDULERS


# --------------------------------------------------------------------------- #
# Whole generates
# --------------------------------------------------------------------------- #


def _jax_generate(sd, key=None, **kw):
    with jax.disable_jit():
        return np.asarray(jld.generate(sd["jcfg"], sd["jp"], jnp.asarray(sd["cond"]),
                                       jnp.asarray(sd["uncond"]),
                                       jax.random.key(1) if key is None else key,
                                       guidance=5.0, height=SIZE, width=SIZE, **kw))


def _port_generate(sd, noise=None, **kw):
    return nhwc(ld.generate(sd["pcfg"], sd["pp"], torch.from_numpy(sd["cond"]),
                            torch.from_numpy(sd["uncond"]), guidance=5.0, height=SIZE, width=SIZE,
                            noise=noise, **kw))


def _init_noise(seed=7):
    return np.random.default_rng(seed).standard_normal((2, LAT, LAT, 4)).astype(np.float32)


@pytest.mark.parametrize("scheduler", ["ddim", "pndm", "unipc", "dpmpp_2m", "heun", "lms",
                                       "euler_karras", "dpm_2"])
def test_deterministic_schedulers_match_jax(sd, scheduler):
    x = _init_noise()
    a = _jax_generate(sd, steps=3, scheduler=scheduler, init_noise=jnp.asarray(x))
    image_close(a, _port_generate(sd, steps=3, scheduler=scheduler, init_noise=nchw(x)))


def _jax_draws(key, steps: int, per_step: int, shape):
    """The JAX scan's draws: split the key once a step (into 1 + per_step
    keys when a step draws twice), a unit normal from each new key."""
    k, _ = jax.random.split(key)  # the first half carries; the second drew the latent
    out = []
    for _ in range(steps):
        if per_step == 1:
            k, nk = jax.random.split(k)
            out.append(nk)
        else:
            k, k1, k2 = jax.random.split(k, 3)
            out += [k1, k2]
    return [nchw(jax.random.normal(kk, shape, jnp.float32)) for kk in out]


@pytest.mark.parametrize("scheduler, per_step", [("euler_a", 1), ("dpm_2_a", 1),
                                                 ("dpmpp_sde", 2), ("dpmpp_2m_sde_karras", 1)])
def test_ancestral_and_sde_schedulers_match_jax_on_its_draws(sd, scheduler, per_step):
    x, key = _init_noise(8), jax.random.key(11)
    a = _jax_generate(sd, steps=3, scheduler=scheduler, init_noise=jnp.asarray(x), key=key)
    draws = iter(_jax_draws(key, 3, per_step, x.shape))
    b = _port_generate(sd, steps=3, scheduler=scheduler, init_noise=nchw(x),
                       noise=lambda shape: next(draws))
    assert next(draws, None) is None  # every draw used, in order
    image_close(a, b)


@pytest.mark.parametrize("scheduler", ["ddim", "euler"])
def test_img2img_matches_jax(sd, scheduler):
    x, src = _init_noise(9), rng_inputs(3)[3]
    a = _jax_generate(sd, steps=4, scheduler=scheduler, init_noise=jnp.asarray(x),
                      init_image=jnp.asarray(src), strength=0.5)
    image_close(a, _port_generate(sd, steps=4, scheduler=scheduler, init_noise=nchw(x),
                                  init_image=nchw(src), strength=0.5))


def test_inpainting_matches_jax_on_its_draws(sd):
    x, key = _init_noise(10), jax.random.key(12)
    src = rng_inputs(4)[3]
    known = jld.vae_encode(sd["jcfg"].vae, sd["jp"]["vae"], jnp.asarray(src))
    mask = np.zeros((2, LAT, LAT, 1), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    a = _jax_generate(sd, steps=3, scheduler="ddim", init_noise=jnp.asarray(x), key=key,
                      known_latent=known, known_mask=jnp.asarray(mask))
    draws = iter(_jax_draws(key, 3, 1, x.shape))
    pknown = ld.vae_encode(sd["pcfg"].vae, sd["pp"]["vae"], nchw(src))
    close(known, nhwc(pknown))
    b = _port_generate(sd, steps=3, scheduler="ddim", init_noise=nchw(x),
                       known_latent=pknown, known_mask=nchw(mask),
                       noise=lambda shape: next(draws))
    image_close(a, b)
    with pytest.raises(ValueError, match="inpainting requires the ddim scheduler"):
        _port_generate(sd, steps=2, scheduler="euler", init_noise=nchw(x),
                       known_latent=pknown, known_mask=nchw(mask))


def test_controlnet_generate_matches_jax(sd):
    x, cond = _init_noise(13), rng_inputs(5)[3]
    a = _jax_generate(sd, steps=2, init_noise=jnp.asarray(x), control_image=jnp.asarray(cond),
                      control_scale=0.8)
    image_close(a, _port_generate(sd, steps=2, init_noise=nchw(x), control_image=nchw(cond),
                                  control_scale=0.8))


def test_sdxl_unet_and_generate_match_jax(xl):
    c1, u1, c2, u2 = xl["ids"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, LAT, LAT, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 80)).astype(np.float32)
    text = rng.standard_normal((2, 24)).astype(np.float32)
    tids = np.array([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * 2, np.float32)
    t = np.array([700.0, 3.0], np.float32)
    a = jax.jit(lambda *a: jld.unet_forward(xl["jcfg"].unet, *a))(
        xl["jp"]["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(text),
        jnp.asarray(tids))
    b = ld.unet_forward(xl["pcfg"].unet, xl["pp"]["unet"], nchw(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), torch.from_numpy(text), torch.from_numpy(tids))
    close(a, nhwc(b))
    a = jax.jit(lambda p, c1, u1, x, c2, u2: jld.generate(
        xl["jcfg"], p, c1, u1, jax.random.key(0), steps=2, guidance=5.0, height=SIZE,
        width=SIZE, init_noise=x, cond_ids2=c2, uncond_ids2=u2))(
            xl["jp"], jnp.asarray(c1), jnp.asarray(u1), jnp.asarray(x), jnp.asarray(c2),
            jnp.asarray(u2))
    b = ld.generate(xl["pcfg"], xl["pp"], torch.from_numpy(c1), torch.from_numpy(u1), steps=2,
                    guidance=5.0, height=SIZE, width=SIZE, init_noise=nchw(x),
                    cond_ids2=torch.from_numpy(c2), uncond_ids2=torch.from_numpy(u2))
    image_close(np.asarray(a), nhwc(b))


def _write_kohya(path) -> None:
    """A kohya LoRA over one UNet linear, one 1x1 conv, one 3x3 conv and one
    text-encoder projection (with and without alpha), plus a stray tensor."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(21)
    t = {}
    for layer, out_c, in_c, k in (
            ("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q", 32, 32, 0),
            ("lora_unet_down_blocks_0_attentions_0_proj_in", 32, 32, 1),
            ("lora_unet_conv_in", 32, 4, 3),
            ("lora_te_text_model_encoder_layers_1_mlp_fc1", 64, 32, 0)):
        r = 4
        down = rng.standard_normal((r, in_c, k, k) if k else (r, in_c)).astype(np.float32)
        up = rng.standard_normal((out_c, r, 1, 1) if k else (out_c, r)).astype(np.float32)
        t[f"{layer}.lora_down.weight"], t[f"{layer}.lora_up.weight"] = down * 0.1, up * 0.1
        if k != 1:
            t[f"{layer}.alpha"] = np.array(2.0, np.float32)
    t["stray_embedding"] = np.zeros(3, np.float32)
    save_file(t, path)


def test_lora_merge_matches_jax(sd, tmp_path):
    path = str(tmp_path / "lora.safetensors")
    _write_kohya(path)
    jp = {k: dict(v) for k, v in sd["jp"].items()}
    pp = {k: dict(v) for k, v in sd["pp"].items()}
    assert jld.load_diffusion_lora(path, jp, 0.8) == ld.load_diffusion_lora(path, pp, 0.8) == 4
    carried = ld.params_from_jax({k: {n: np.asarray(a) for n, a in v.items()}
                                  for k, v in jp.items()}, device="cpu")
    changed = 0
    for part in pp:
        for name, t in pp[part].items():
            close(carried[part][name], t, 1e-6)
            changed += not torch.equal(t, sd["pp"][part][name])
    assert changed == 4
