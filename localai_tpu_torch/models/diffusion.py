"""The DiT presets (`dit-test`, `dit-base`, `dit-512`) on tensors
(localai_tpu/models/diffusion.py): a pixel-space diffusion transformer with
adaLN timestep modulation and cross-attention over a byte-level text
encoder, sampled by DDIM with classifier-free guidance on the cosine
schedule.

The parameter tree, names and layouts are the JAX package's (matmul weights
[in, out], per-layer stacks [L, ...]) and so is the checkpoint
(`save_diffusion` / `load_diffusion`: model.safetensors of dotted names +
config.json), so either package reads the other's files. The sampler is an
eager loop; its noise comes in as tensors (`noise`, and `noise_steps` for
inpainting's per-step draws) or from a torch generator.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.latent_diffusion import attention

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    name: str = "dit"
    image_size: int = 64
    channels: int = 3
    patch: int = 8
    d_model: int = 256
    n_heads: int = 4
    layers: int = 6
    ffn_mult: int = 4
    text_vocab: int = 256  # utf-8 bytes
    text_ctx: int = 64
    text_layers: int = 2
    n_steps_train: int = 1000

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn(self) -> int:
        return self.d_model * self.ffn_mult

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels


DIFFUSION_PRESETS: dict[str, DiffusionConfig] = {
    "dit-test": DiffusionConfig(
        name="dit-test", image_size=16, patch=4, d_model=32, n_heads=2,
        layers=2, text_ctx=16, text_layers=1,
    ),
    "dit-base": DiffusionConfig(name="dit-base"),
    "dit-512": DiffusionConfig(name="dit-512", image_size=512, patch=16,
                               d_model=1024, n_heads=16, layers=24),
}


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_ts = np.log(10000.0) / max(channels // 2 - 1, 1)
    inv = np.exp(-log_ts * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t [B] float → [B, dim] sinusoidal features."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device)
                      / max(half - 1, 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def init_params(cfg: DiffusionConfig, seed: int = 0, device=None, scale: float = 0.02) -> Params:
    """Random weights in the JAX package's tree (normal · scale for the
    matmuls and tables, adaLN modulation and the output head at zero, ones
    / zeros for the norms, sinusoidal text positions), drawn from a torch
    generator seeded `seed` on `device`, f32."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, L, Lt, ff = cfg.d_model, cfg.layers, cfg.text_layers, cfg.ffn

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device) * scale

    def z(*shape):
        return torch.zeros(shape, device=device)

    def o(*shape):
        return torch.ones(shape, device=device)

    blocks = {
        "mod_w": z(L, d, 6 * d), "mod_b": z(L, 6 * d),  # adaLN-zero
        "q_w": rnd(L, d, d), "k_w": rnd(L, d, d), "v_w": rnd(L, d, d), "o_w": rnd(L, d, d),
        "xq_w": rnd(L, d, d), "xk_w": rnd(L, d, d), "xv_w": rnd(L, d, d), "xo_w": rnd(L, d, d),
        "lnx_w": o(L, d), "lnx_b": z(L, d),
        "fc1_w": rnd(L, d, ff), "fc1_b": z(L, ff), "fc2_w": rnd(L, ff, d), "fc2_b": z(L, d),
    }
    text_blocks = {
        "ln1_w": o(Lt, d), "ln1_b": z(Lt, d),
        "q_w": rnd(Lt, d, d), "k_w": rnd(Lt, d, d), "v_w": rnd(Lt, d, d), "o_w": rnd(Lt, d, d),
        "ln2_w": o(Lt, d), "ln2_b": z(Lt, d),
        "fc1_w": rnd(Lt, d, ff), "fc1_b": z(Lt, ff), "fc2_w": rnd(Lt, ff, d), "fc2_b": z(Lt, d),
    }
    return {
        "patch_w": rnd(cfg.patch_dim, d), "patch_b": z(d),
        "pos": rnd(cfg.n_patches, d),
        "t_w1": rnd(d, d), "t_b1": z(d), "t_w2": rnd(d, d), "t_b2": z(d),
        "text_embed": rnd(cfg.text_vocab, d),
        "text_pos": torch.from_numpy(_sinusoids(cfg.text_ctx, d)).to(device),
        "text": text_blocks,
        "null_text": rnd(cfg.text_ctx, d),  # CFG's unconditional context
        "blocks": blocks,
        "ln_f_w": o(d), "ln_f_b": z(d),
        "out_w": z(d, cfg.patch_dim), "out_b": z(cfg.patch_dim),
    }


def params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's DiT tree (numpy or anything np.asarray takes) →
    f32 tensors on `device`, the same names and layout."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return conv(tree)


def _ln(x, w, b, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * w + b


def _ln_nomod(x, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


def _attn(cfg: DiffusionConfig, q, k, v) -> torch.Tensor:
    B, Tq = q.shape[:2]
    H, Dh = cfg.n_heads, cfg.head_dim

    def heads(x):
        return x.reshape(B, x.shape[1], H, Dh).transpose(1, 2)

    out = attention(heads(q), heads(k), heads(v), scale=Dh ** -0.5, f32_scores=False)
    return out.transpose(1, 2).reshape(B, Tq, cfg.d_model)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def encode_text(cfg: DiffusionConfig, params: Params, text_ids: torch.Tensor) -> torch.Tensor:
    """text_ids [B, text_ctx] (zero-padded) → context [B, text_ctx, d]."""
    h = params["text_embed"][text_ids.long()] + params["text_pos"][None]
    for i in range(cfg.text_layers):
        lp = _layer(params["text"], i)
        x = _ln(h, lp["ln1_w"], lp["ln1_b"])
        h = h + _attn(cfg, x @ lp["q_w"], x @ lp["k_w"], x @ lp["v_w"]) @ lp["o_w"]
        x = _ln(h, lp["ln2_w"], lp["ln2_b"])
        h = h + _gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
    return h


def patchify(cfg: DiffusionConfig, img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, n_patches, patch_dim] (the JAX package's HWC images)."""
    B = img.shape[0]
    p, n = cfg.patch, cfg.image_size // cfg.patch
    x = img.reshape(B, n, p, n, p, cfg.channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, cfg.patch_dim)


def unpatchify(cfg: DiffusionConfig, x: torch.Tensor) -> torch.Tensor:
    B = x.shape[0]
    p, n = cfg.patch, cfg.image_size // cfg.patch
    x = x.reshape(B, n, n, p, p, cfg.channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, cfg.image_size, cfg.image_size, cfg.channels)


def denoise(cfg: DiffusionConfig, params: Params, img: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor) -> torch.Tensor:
    """The noise ε predicted for img [B, H, W, C] at timesteps t [B]."""
    h = patchify(cfg, img) @ params["patch_w"] + params["patch_b"]
    h = h + params["pos"][None]
    temb = F.silu(timestep_embedding(t, cfg.d_model) @ params["t_w1"] + params["t_b1"])
    temb = temb @ params["t_w2"] + params["t_b2"]
    for i in range(cfg.layers):
        lp = _layer(params["blocks"], i)
        s1, sh1, g1, s2, sh2, g2 = (F.silu(temb) @ lp["mod_w"] + lp["mod_b"]).chunk(6, -1)
        x = _ln_nomod(h) * (1 + s1[:, None]) + sh1[:, None]
        h = h + g1[:, None] * (_attn(cfg, x @ lp["q_w"], x @ lp["k_w"], x @ lp["v_w"])
                               @ lp["o_w"])
        x = _ln(h, lp["lnx_w"], lp["lnx_b"])  # cross-attention, un-modulated pre-LN
        h = h + _attn(cfg, x @ lp["xq_w"], ctx @ lp["xk_w"], ctx @ lp["xv_w"]) @ lp["xo_w"]
        x = _ln_nomod(h) * (1 + s2[:, None]) + sh2[:, None]
        h = h + g2[:, None] * (_gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"]
                               + lp["fc2_b"])
    h = _ln(h, params["ln_f_w"], params["ln_f_b"])
    return unpatchify(cfg, h @ params["out_w"] + params["out_b"])


def _ddim_schedule(n_train: int, n_steps: int) -> np.ndarray:
    """Evenly spaced DDIM timesteps (descending)."""
    ts = np.linspace(0, n_train - 1, n_steps).round().astype(np.int64)
    return ts[::-1].copy()


def _alpha_bar(t: float, n_train: int) -> float:
    """Cosine noise schedule (Nichol & Dhariwal), in f32 as the JAX package."""
    f = np.cos(np.float32((np.float32(t) / n_train + 0.008) / 1.008 * (np.pi / 2))) ** 2
    f0 = np.cos((0.008 / 1.008) * (np.pi / 2)) ** 2
    return float(np.clip(np.float32(f) / np.float32(f0), 1e-5, 1.0))


def _context(cfg: DiffusionConfig, params: Params, text_ids: torch.Tensor) -> torch.Tensor:
    ctx_c = encode_text(cfg, params, text_ids)
    return torch.cat([ctx_c, params["null_text"][None].expand_as(ctx_c)], dim=0)


def ddim_steps(cfg: DiffusionConfig, params: Params, ctx: torch.Tensor, x: torch.Tensor,
               steps: int, guidance: float, known=None) -> torch.Tensor:
    """The CFG DDIM loop (x0 clipped to ±3) from x [B, H, W, C]; `known`
    (x0_known, mask [B, H, W, 1], noise [steps, B, H, W, C]) replays the
    kept region at every step (inpainting)."""
    B = x.shape[0]
    ts = [float(t) for t in _ddim_schedule(cfg.n_steps_train, steps)]
    for i in range(steps):
        t = ts[i]
        t_prev = ts[i + 1] if i + 1 < steps else -1.0
        tb = torch.full((2 * B,), t, device=x.device)
        eps = denoise(cfg, params, torch.cat([x, x]), tb, ctx)
        eps_g = eps[B:] + guidance * (eps[:B] - eps[B:])
        ab_t = _alpha_bar(t, cfg.n_steps_train)
        ab_prev = _alpha_bar(t_prev, cfg.n_steps_train) if t_prev >= 0 else 1.0
        x0 = torch.clamp((x - math.sqrt(1 - ab_t) * eps_g) / math.sqrt(ab_t), -3.0, 3.0)
        x = math.sqrt(ab_prev) * x0 + math.sqrt(1 - ab_prev) * eps_g
        if known is not None:
            x0_known, m, noise = known
            known_prev = math.sqrt(ab_prev) * x0_known + math.sqrt(1 - ab_prev) * noise[i]
            x = m * x + (1 - m) * known_prev
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


def generate(cfg: DiffusionConfig, params: Params, text_ids: torch.Tensor, steps: int = 20,
             guidance: float = 4.0, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDIM with CFG from noise [B, H, W, C] (else drawn from generator);
    returns [B, H, W, C] in [0, 1]."""
    B = text_ids.shape[0]
    if noise is None:
        noise = torch.randn((B, cfg.image_size, cfg.image_size, cfg.channels),
                            generator=generator, device=text_ids.device)
    return ddim_steps(cfg, params, _context(cfg, params, text_ids), noise.float(), steps,
                      guidance)


def inpaint(cfg: DiffusionConfig, params: Params, text_ids: torch.Tensor, image: torch.Tensor,
            mask: torch.Tensor, steps: int = 20, guidance: float = 4.0,
            noise: Optional[torch.Tensor] = None, noise_steps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """RePaint-style inpainting: image [B, H, W, C] in [0, 1], mask [B, H, W]
    (1 = repaint). noise is the start, noise_steps [steps, B, H, W, C] the
    kept region's per-step draws (else both from generator)."""
    x0_known = image.float() * 2.0 - 1.0
    if noise is None:
        noise = torch.randn(x0_known.shape, generator=generator, device=x0_known.device)
    if noise_steps is None:
        noise_steps = torch.randn((steps, *x0_known.shape), generator=generator,
                                  device=x0_known.device)
    return ddim_steps(cfg, params, _context(cfg, params, text_ids), noise.float(), steps,
                      guidance, known=(x0_known, mask.float()[..., None], noise_steps.float()))


# --------------------------------------------------------------------------- #
# Checkpoint I/O (the JAX package's own safetensors layout)
# --------------------------------------------------------------------------- #


def save_diffusion(cfg: DiffusionConfig, params: Params, ckpt_dir: str) -> None:
    from localai_tpu_torch.engine.weights import write_safetensors

    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{k2}": v2 for k2, v2 in v.items()})
        else:
            flat[k] = v
    write_safetensors(os.path.join(ckpt_dir, "model.safetensors"),
                      {k: tuple(v.shape) for k, v in flat.items()}, torch.float32,
                      lambda k: flat[k])
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({"model_type": "localai-dit", **dataclasses.asdict(cfg)}, f, indent=1)


def load_diffusion(ckpt_dir: str, device=None) -> tuple[DiffusionConfig, Params]:
    from localai_tpu_torch.engine.weights import SafetensorsFile

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    hf.pop("model_type", None)
    cfg = DiffusionConfig(**hf)
    params: Params = {}
    st = SafetensorsFile(os.path.join(ckpt_dir, "model.safetensors"))
    for name in st.keys():
        t = st.get(name).float().to(device)
        if "." in name:
            grp, sub = name.split(".", 1)
            params.setdefault(grp, {})[sub] = t
        else:
            params[name] = t
    return cfg, params
