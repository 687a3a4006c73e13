"""Text → video: AnimateDiff-class motion modules over the SD UNet on
tensors (localai_tpu/models/video_diffusion.py).

A MotionAdapter checkpoint (the diffusers layout of e.g.
guoyww/animatediff-motion-adapter-v1-5-2) adds a temporal transformer after
every spatial block of the UNet, attending across frames at each spatial
location. Frames ride the batch axis ([B·F, C, H, W]); a motion module
group-norms the whole (F, H, W) volume of each sample, attends over the
frame axis of every pixel ([B·H·W, F, C]) and adds back. The base image
checkpoint is models/latent_diffusion.py's, unchanged; the UNet walk is
its down / mid / up blocks with the module as their `motion` hook.

The DDIM loop is eager; its per-frame initial noise comes in as a tensor
or from a torch generator. `save_motion_adapter` writes a random adapter at
any geometry (v1-5-2's published widths included).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.latent_diffusion import (
    Params,
    SDPipelineConfig,
    UNetConfig,
    _conv,
    _dtype,
    _group_norm,
    _layer_norm,
    _linear,
    _Shapes,
    _write_json,
    alphas_cumprod,
    attention,
    clip_encode,
    ddim_step,
    ddim_timesteps,
    down_blocks,
    load_safetensors_dir,
    mid_block,
    time_embedding,
    up_blocks,
    vae_decode,
    vae_encode,
    write_random,
)


@dataclass
class MotionConfig:
    """diffusers MotionAdapter config subset."""

    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    mid_layers: int = 1
    num_heads: int = 8
    max_seq_length: int = 32
    norm_num_groups: int = 32
    use_mid: bool = True


def is_motion_adapter_dir(path: str) -> bool:
    cfg = os.path.join(path, "config.json")
    if not os.path.isfile(cfg):
        return False
    try:
        with open(cfg) as f:
            return json.load(f).get("_class_name") == "MotionAdapter"
    except (OSError, ValueError):
        return False


def load_motion_adapter(path: str, dtype: torch.dtype = torch.float32, device=None):
    """(MotionConfig, params) from a diffusers MotionAdapter dir."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    cfg = MotionConfig(
        block_out_channels=tuple(c.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=int(c.get("motion_layers_per_block", 2)),
        mid_layers=int(c.get("motion_mid_block_layers_per_block", 1)),
        num_heads=int(c.get("motion_num_attention_heads", 8)),
        max_seq_length=int(c.get("motion_max_seq_length", 32)),
        norm_num_groups=int(c.get("motion_norm_num_groups", 32)),
        use_mid=bool(c.get("use_motion_mid_block", True)),
    )
    return cfg, load_safetensors_dir(path, dtype, device)


def _sin_pos_embed(n: int, dim: int) -> np.ndarray:
    """diffusers SinusoidalPositionalEmbedding: interleaved sin / cos [n, dim]."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _temporal_attention(p: Params, pre: str, n: torch.Tensor, heads: int) -> torch.Tensor:
    """Self-attention over the frame axis; n [N, F, C] (normed, positioned)."""
    N, Fr, C = n.shape
    hd = C // heads
    q, k, v = (_linear(n, p, f"{pre}.to_{c}").reshape(N, Fr, heads, hd).transpose(1, 2)
               for c in "qkv")
    return _linear(attention(q, k, v).transpose(1, 2).reshape(N, Fr, C), p, f"{pre}.to_out.0")


def _temporal_block(p: Params, pre: str, h: torch.Tensor, heads: int,
                    pe: torch.Tensor) -> torch.Tensor:
    """The AnimateDiff temporal block: two frame self-attentions with the
    sinusoidal frame positions, then a GEGLU feed-forward. h [N, F, C]."""
    pef = pe[None, :h.shape[1]].to(h.dtype)
    n = _layer_norm(h, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"]) + pef
    h = h + _temporal_attention(p, f"{pre}.attn1", n, heads)
    if f"{pre}.attn2.to_q.weight" in p:
        n = _layer_norm(h, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"]) + pef
        h = h + _temporal_attention(p, f"{pre}.attn2", n, heads)
    n = _layer_norm(h, p[f"{pre}.norm3.weight"], p[f"{pre}.norm3.bias"])
    a, gate = _linear(n, p, f"{pre}.ff.net.0.proj").chunk(2, dim=-1)
    return h + _linear(a * F.gelu(gate, approximate="tanh"), p, f"{pre}.ff.net.2")


def _motion_module(mcfg: MotionConfig, mp: Params, pre: str, x: torch.Tensor,
                   frames: int) -> torch.Tensor:
    """One AnimateDiffTransformer3D over x [B·F, C, H, W]."""
    BF, C, H, W = x.shape
    B = BF // frames
    x5 = x.reshape(B, frames, C, H, W).transpose(1, 2)  # [B, C, F, H, W]
    hn = _group_norm(x5, mp[f"{pre}.norm.weight"], mp[f"{pre}.norm.bias"],
                     mcfg.norm_num_groups, eps=1e-5)
    h = hn.permute(0, 3, 4, 2, 1).reshape(B * H * W, frames, C)
    h = _linear(h, mp, f"{pre}.proj_in")
    pe_name = f"{pre}.transformer_blocks.0.pos_embed.pe"
    if pe_name in mp:  # a stored buffer (some exports keep it)
        pe = mp[pe_name].reshape(-1, C)
    else:
        pe = torch.from_numpy(_sin_pos_embed(mcfg.max_seq_length, C)).to(x.device)
    bi = 0
    while f"{pre}.transformer_blocks.{bi}.norm1.weight" in mp:
        h = _temporal_block(mp, f"{pre}.transformer_blocks.{bi}", h, mcfg.num_heads, pe)
        bi += 1
    h = _linear(h, mp, f"{pre}.proj_out")
    h = h.reshape(B, H, W, frames, C).permute(0, 3, 4, 1, 2).reshape(BF, C, H, W)
    return h + x


def motion_unet_forward(cfg: UNetConfig, mcfg: MotionConfig, p: Params, mp: Params,
                        sample: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                        frames: int) -> torch.Tensor:
    """UNet2DCondition + motion modules (diffusers UNetMotionModel order:
    resnet → spatial attention → motion module a layer; mid resnet →
    attention → motion → resnet). sample [B·F, C_lat, h, w]."""
    dt = _dtype(p)
    sample, ctx = sample.to(dt), ctx.to(dt)
    temb = time_embedding(cfg, p, t, dt)

    def motion(pre, h):
        if pre.startswith("mid_block") and not (
                mcfg.use_mid and "mid_block.motion_modules.0.proj_in.weight" in mp):
            return h
        return _motion_module(mcfg, mp, pre, h, frames)

    h = _conv(sample, p["conv_in.weight"], p["conv_in.bias"])
    h, skips = down_blocks(cfg, p, h, temb, ctx, motion)
    h = mid_block(cfg, p, h, temb, ctx, motion)
    return up_blocks(cfg, p, h, skips, temb, ctx, motion)


def generate_video(cfg: SDPipelineConfig, params: dict, mcfg: MotionConfig, mparams: Params,
                   cond_ids: torch.Tensor, uncond_ids: torch.Tensor, frames: int = 16,
                   steps: int = 20, guidance: float = 7.5, height: int = 512, width: int = 512,
                   init_image: Optional[torch.Tensor] = None, strength: float = 0.8,
                   init_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Text → video by DDIM over the motion UNet with one noise sample a
    frame (init_noise [F, C_lat, h, w], else from generator). init_image
    [1, 3, H, W]: every frame starts from the source re-noised `strength` of
    the way up the schedule. Returns [F, 3, H, W] f32 in [0, 1]."""
    if frames > mcfg.max_seq_length:
        raise ValueError(f"frames={frames} exceeds the motion adapter's max sequence "
                         f"length {mcfg.max_seq_length}")
    device = cond_ids.device
    ctx_c = clip_encode(cfg.text, params["text"], cond_ids)
    ctx_u = clip_encode(cfg.text, params["text"], uncond_ids)
    Fr = frames
    ctx = torch.cat([ctx_u.expand(Fr, *ctx_u.shape[1:]), ctx_c.expand(Fr, *ctx_c.shape[1:])])
    vs = cfg.vae.spatial_scale
    if init_noise is None:
        gen = generator or torch.Generator(device=device).manual_seed(0)
        init_noise = torch.randn((Fr, cfg.unet.in_channels, height // vs, width // vs),
                                 generator=gen, device=device)
    x = init_noise.float()
    acp = alphas_cumprod(cfg)
    ts = [int(t) for t in ddim_timesteps(cfg, steps)]
    ratio = cfg.num_train_timesteps // steps
    i0 = 0
    if init_image is not None:
        strength = min(max(float(strength), 0.0), 1.0)
        i0 = steps - max(1, min(steps, int(round(steps * strength))))
        lat0 = vae_encode(cfg.vae, params["vae"], init_image)
        a0 = float(acp[ts[i0]])
        x = a0 ** 0.5 * lat0 + (1.0 - a0) ** 0.5 * x
    for i in range(i0, steps):
        t = ts[i]
        both = torch.cat([x, x])
        tt = torch.full((2 * Fr,), float(t), device=device)
        out = motion_unet_forward(cfg.unet, mcfg, params["unet"], mparams, both, tt, ctx,
                                  frames=Fr).float()
        eps_u, eps_c = out.chunk(2, dim=0)
        x = ddim_step(cfg, acp, eps_u + guidance * (eps_c - eps_u), t, t - ratio, x)
    return vae_decode(cfg.vae, params["vae"], x / cfg.vae.scaling_factor)


def motion_adapter_shapes(mcfg: MotionConfig) -> dict[str, tuple]:
    """Every tensor of a diffusers MotionAdapter at mcfg: one temporal module
    per down layer, (layers + 1) per up layer, one in the mid block."""
    g = _Shapes()

    def module(pre, c):
        g.norm(f"{pre}.norm", c)
        g.lin(f"{pre}.proj_in", c, c)
        g.transformer_block(f"{pre}.transformer_blocks.0", c)
        g.lin(f"{pre}.proj_out", c, c)

    boc = mcfg.block_out_channels
    for bi, c in enumerate(boc):
        for li in range(mcfg.layers_per_block):
            module(f"down_blocks.{bi}.motion_modules.{li}", c)
    if mcfg.use_mid:
        module("mid_block.motion_modules.0", boc[-1])
    for bi, c in enumerate(reversed(boc)):
        for li in range(mcfg.layers_per_block + 1):
            module(f"up_blocks.{bi}.motion_modules.{li}", c)
    return g.s


def save_motion_adapter(mcfg: MotionConfig, path: str, seed: int = 0,
                        dtype: torch.dtype = torch.float32, device=None) -> None:
    """A MotionAdapter directory of seeded random weights at mcfg."""
    write_random(os.path.join(path, "diffusion_pytorch_model.safetensors"),
                 motion_adapter_shapes(mcfg), seed, dtype, resolve_device(device))
    _write_json(os.path.join(path, "config.json"), {
        "_class_name": "MotionAdapter", "block_out_channels": list(mcfg.block_out_channels),
        "motion_layers_per_block": mcfg.layers_per_block,
        "motion_mid_block_layers_per_block": mcfg.mid_layers,
        "motion_num_attention_heads": mcfg.num_heads,
        "motion_max_seq_length": mcfg.max_seq_length,
        "motion_norm_num_groups": mcfg.norm_num_groups, "use_motion_mid_block": mcfg.use_mid})
