"""Latent diffusion (Stable-Diffusion-1.5 and SDXL class) on tensors
(localai_tpu/models/latent_diffusion.py), loading diffusers-layout
checkpoints.

The three networks (the CLIP text encoder, UNet2DCondition with its
ControlNet copy, the VAE) are functions over NCHW activations with the
weights as the checkpoints store them: convs OIHW, linears [out, in], so
a loaded file needs no transposes (the JAX package transposes to HWIO /
[in, out] at load; `params_from_jax` carries its dicts across).

Compute runs in the weights' dtype (f32, or bf16 on the card): each
network casts its input to it. GroupNorm / LayerNorm statistics and every
softmax stay f32, and the sampler's latent is f32 between steps, as in the
JAX package. Attention is plain PyTorch (`attention`): f32 scores and
softmax computed in blocks of query rows, so the score buffer stays under
`ATTN_BLOCK_BYTES` at any batch and size (the JAX package materializes the
whole [B, H, Nq, Nk] matrix; the rows are independent, so the result is
the same function).

The sampler is an eager Python loop over the steps (the JAX package runs
one `lax.scan`). Noise comes in as tensors: `generate` takes the initial
latent (`init_noise`) and a `noise` callable that returns each later draw
(the ancestral and SDE samplers' per-step noise, inpainting's re-noised
source) in the order the JAX package splits its keys, so the tests hand
the port the JAX draws; without them it draws from a torch generator.

`save_diffusers` writes a random diffusers-layout checkpoint at any
config (SD-1.5 and SDXL at their published widths included) with a small
BPE tokenizer, for the tests and the card.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device

log = logging.getLogger("localai_tpu_torch.latent_diffusion")

Params = dict[str, torch.Tensor]
Noise = Callable[[tuple], torch.Tensor]

# The serving scheduler surface (the JAX package's names). "_karras" suffix
# and "k_" prefix both select Karras sigma spacing for the k-diffusion family.
K_SCHEDULERS = ("euler", "euler_a", "dpmpp_2m", "heun", "lms", "dpm_2",
                "dpm_2_a", "dpmpp_sde", "dpmpp_2m_sde")
T_SCHEDULERS = ("ddim", "pndm", "unipc")
SUPPORTED_SCHEDULERS = frozenset(
    T_SCHEDULERS + K_SCHEDULERS
    + tuple(f"{s}_karras" for s in K_SCHEDULERS)
    + tuple(f"k_{s}" for s in K_SCHEDULERS)
)

# Bytes of f32 scores one attention block may hold (query rows are cut to fit).
ATTN_BLOCK_BYTES = 256 << 20


# --------------------------------------------------------------------------- #
# Configs (the subset of the diffusers configs the networks read)
# --------------------------------------------------------------------------- #


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 0  # >0: CLIPTextModelWithProjection (SDXL encoder 2)
    eos_token_id: int = 49407  # pooling position (HF CLIP semantics)


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: tuple = (320, 640, 1280, 1280)
    down_block_types: tuple = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: tuple = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: Any = 8  # int or per-block list (a head COUNT: diffusers' misnomer)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # SDXL: transformer depth per level and the "text_time" micro-conditioning.
    transformer_layers_per_block: Any = 1  # int or per-block list
    addition_embed_type: str = ""  # "" | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    def heads_for(self, block_idx: int) -> int:
        if isinstance(self.attention_head_dim, (list, tuple)):
            return int(self.attention_head_dim[block_idx])
        return int(self.attention_head_dim)

    def tx_depth_for(self, block_idx: int) -> int:
        if isinstance(self.transformer_layers_per_block, (list, tuple)):
            return int(self.transformer_layers_per_block[block_idx])
        return int(self.transformer_layers_per_block)


@dataclass
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # Flux-class VAEs recenter latents: z_model = (z - shift) * scale.
    shift_factor: float = 0.0

    @property
    def spatial_scale(self) -> int:
        """Pixels per latent: one 2x resampler between each block pair."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass
class SDPipelineConfig:
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    # SDXL second text encoder (OpenCLIP bigG class); None for the SD family.
    text2: Optional[CLIPTextConfig] = None
    # scaled-linear schedule (SD family)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"  # | "v_prediction"

    @property
    def is_xl(self) -> bool:
        return self.text2 is not None


def sd15_config() -> SDPipelineConfig:
    """Stable Diffusion 1.5's published geometry (the loader's defaults):
    CLIP ViT-L/14 text 12 x 768, the 320-640-1280-1280 UNet, the 4-channel VAE."""
    return SDPipelineConfig()


def sdxl_config() -> SDPipelineConfig:
    """SDXL base 1.0's published geometry: the three-level UNet with
    transformer depths 1 / 2 / 10 and linear projections, CLIP-L beside
    OpenCLIP bigG (32 x 1280, projection 1280), the text_time embedding."""
    return SDPipelineConfig(
        text=CLIPTextConfig(),
        text2=CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                             num_attention_heads=20, hidden_act="gelu", projection_dim=1280),
        unet=UNetConfig(
            sample_size=128, block_out_channels=(320, 640, 1280),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            attention_head_dim=(5, 10, 20), cross_attention_dim=2048,
            transformer_layers_per_block=(1, 2, 10), addition_embed_type="text_time",
            projection_class_embeddings_input_dim=1280 + 6 * 256),
        vae=VAEConfig(scaling_factor=0.13025),
    )


# --------------------------------------------------------------------------- #
# Primitive layers (NCHW; convs OIHW, linears [out, in])
# --------------------------------------------------------------------------- #


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int = 1, pad: int = 1) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride=stride, padding=pad)


def _linear(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    b = p.get(f"{name}.bias")
    return F.linear(x, p[f"{name}.weight"].to(x.dtype), None if b is None else b.to(x.dtype))


def _group_norm(x: torch.Tensor, w, b, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """x [B, C, ...]: f32 statistics over each group's channels and every
    position after them; the affine in x's dtype."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return xn * w.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


def _layer_norm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
              f32_scores: bool = True) -> torch.Tensor:
    """q [B, H, Nq, D], k / v [B, H, Nk, D] → [B, H, Nq, D] in v's dtype:
    softmax(q·kᵀ · scale + bias) · v with f32 scores and softmax (the JAX
    package's einsum + f32 softmax), computed over blocks of query rows so
    one block's scores stay under ATTN_BLOCK_BYTES. `bias` broadcasts to
    [B, H, Nq, Nk]. f32_scores=False keeps the scores in q's dtype (the DiT's
    `_attn`, which casts nothing)."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    rows = max(1, ATTN_BLOCK_BYTES // max(1, B * H * Nk * 4))
    kt = k.transpose(-1, -2)
    outs = []
    for s in range(0, Nq, rows):
        sc = q[:, :, s:s + rows] @ kt
        sc = (sc.float() if f32_scores else sc) * scale
        if bias is not None:
            bb = bias if bias.shape[-2] == 1 else bias[..., s:s + rows, :]
            sc = sc + bb
        outs.append(torch.softmax(sc, dim=-1).to(v.dtype) @ v)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """q [B, Nq, C], k / v [B, Nk, C] → [B, Nq, C]."""
    B, Nq, C = q.shape
    hd = C // heads

    def split(x):
        return x.reshape(B, -1, heads, hd).transpose(1, 2)

    out = attention(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(B, Nq, C)


def get_timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                           freq_shift: float = 0.0) -> torch.Tensor:
    """diffusers get_timestep_embedding semantics (t [B] → [B, dim] f32)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _dtype(p: Params) -> torch.dtype:
    return next(iter(p.values())).dtype


def _up2(h: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling (jax.image.resize "nearest" at an integer factor)."""
    return h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# --------------------------------------------------------------------------- #
# CLIP text encoder (causal; quick-gelu)
# --------------------------------------------------------------------------- #


def clip_hidden_states(cfg: CLIPTextConfig, p: Params,
                       ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S] int → (penultimate hidden [B, S, C], final normed [B, S, C]):
    the penultimate state (hidden_states[-2]) is what SDXL conditions on,
    the final normed one SD-1.5's context and the pooled projection's source."""
    B, S = ids.shape
    h = p["text_model.embeddings.token_embedding.weight"][ids.long()]
    h = h + p["text_model.embeddings.position_embedding.weight"][None, :S]
    mask = torch.triu(torch.full((S, S), float("-inf"), device=h.device), diagonal=1)
    hd = cfg.hidden_size // cfg.num_attention_heads

    def act(x):
        if cfg.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)

    def heads(x):
        return x.reshape(B, S, -1, hd).transpose(1, 2)

    penultimate = h
    for i in range(cfg.num_hidden_layers):
        if i == cfg.num_hidden_layers - 1:
            penultimate = h
        pre = f"text_model.encoder.layers.{i}"
        r = h
        h = _layer_norm(h, p[f"{pre}.layer_norm1.weight"], p[f"{pre}.layer_norm1.bias"],
                        cfg.layer_norm_eps)
        q = heads(_linear(h, p, f"{pre}.self_attn.q_proj"))
        k = heads(_linear(h, p, f"{pre}.self_attn.k_proj"))
        v = heads(_linear(h, p, f"{pre}.self_attn.v_proj"))
        a = attention(q, k, v, bias=mask).transpose(1, 2).reshape(B, S, -1)
        h = r + _linear(a, p, f"{pre}.self_attn.out_proj")
        r = h
        h = _layer_norm(h, p[f"{pre}.layer_norm2.weight"], p[f"{pre}.layer_norm2.bias"],
                        cfg.layer_norm_eps)
        h = r + _linear(act(_linear(h, p, f"{pre}.mlp.fc1")), p, f"{pre}.mlp.fc2")
    final = _layer_norm(h, p["text_model.final_layer_norm.weight"],
                        p["text_model.final_layer_norm.bias"], cfg.layer_norm_eps)
    return penultimate, final


def clip_encode(cfg: CLIPTextConfig, p: Params, ids: torch.Tensor) -> torch.Tensor:
    """[B, S] int → last hidden state [B, S, C] (what SD conditions on)."""
    return clip_hidden_states(cfg, p, ids)[1]


def clip_pooled_projection(cfg: CLIPTextConfig, p: Params, ids: torch.Tensor,
                           final: torch.Tensor) -> torch.Tensor:
    """The first EOS position's final state through text_projection (no
    bias). Legacy configs (eos_token_id == 2) take the argmax of the ids."""
    ids = ids.long()
    if cfg.eos_token_id == 2:
        eos_pos = ids.argmax(-1)
    else:
        eos_pos = (ids == cfg.eos_token_id).int().argmax(-1)
    pooled = final[torch.arange(final.shape[0], device=final.device), eos_pos]
    if "text_projection.weight" in p:
        pooled = F.linear(pooled, p["text_projection.weight"].to(pooled.dtype))
    return pooled


# --------------------------------------------------------------------------- #
# UNet2DCondition (and the ControlNet encoder copy)
# --------------------------------------------------------------------------- #

_CROSS_DOWN = ("CrossAttnDownBlock2D", "CrossAttnDownBlockMotion")
_CROSS_UP = ("CrossAttnUpBlock2D", "CrossAttnUpBlockMotion")


def _resnet(p: Params, pre: str, x: torch.Tensor, temb: Optional[torch.Tensor],
            groups: int) -> torch.Tensor:
    h = _group_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], groups)
    h = _conv(F.silu(h), p[f"{pre}.conv1.weight"], p[f"{pre}.conv1.bias"])
    if temb is not None and f"{pre}.time_emb_proj.weight" in p:
        h = h + _linear(F.silu(temb), p, f"{pre}.time_emb_proj")[:, :, None, None]
    h = _group_norm(h, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], groups)
    h = _conv(F.silu(h), p[f"{pre}.conv2.weight"], p[f"{pre}.conv2.bias"])
    if f"{pre}.conv_shortcut.weight" in p:
        x = _conv(x, p[f"{pre}.conv_shortcut.weight"], p[f"{pre}.conv_shortcut.bias"], pad=0)
    return x + h


def _basic_transformer(p: Params, pre: str, h: torch.Tensor, ctx: torch.Tensor,
                       heads: int) -> torch.Tensor:
    # self-attention
    n = _layer_norm(h, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"])
    q, k, v = (_linear(n, p, f"{pre}.attn1.to_{c}") for c in "qkv")
    h = h + _linear(_attention(q, k, v, heads), p, f"{pre}.attn1.to_out.0")
    # cross-attention over the text states
    n = _layer_norm(h, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"])
    q = _linear(n, p, f"{pre}.attn2.to_q")
    k = _linear(ctx, p, f"{pre}.attn2.to_k").to(h.dtype)
    v = _linear(ctx, p, f"{pre}.attn2.to_v").to(h.dtype)
    h = h + _linear(_attention(q, k, v, heads), p, f"{pre}.attn2.to_out.0")
    # GEGLU feed-forward (tanh gelu: jax.nn.gelu's default)
    n = _layer_norm(h, p[f"{pre}.norm3.weight"], p[f"{pre}.norm3.bias"])
    a, gate = _linear(n, p, f"{pre}.ff.net.0.proj").chunk(2, dim=-1)
    return h + _linear(a * F.gelu(gate, approximate="tanh"), p, f"{pre}.ff.net.2")


def _spatial_transformer(p: Params, pre: str, x: torch.Tensor, ctx: torch.Tensor,
                         heads: int, groups: int, depth: int = 1) -> torch.Tensor:
    B, C, H, W = x.shape
    h = _group_norm(x, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"], groups)
    linear = p[f"{pre}.proj_in.weight"].dim() == 2  # SDXL projects by linears
    if linear:
        h = _linear(h.flatten(2).transpose(1, 2), p, f"{pre}.proj_in")
    else:
        h = _conv(h, p[f"{pre}.proj_in.weight"], p[f"{pre}.proj_in.bias"], pad=0)
        h = h.flatten(2).transpose(1, 2)
    for d in range(depth):
        h = _basic_transformer(p, f"{pre}.transformer_blocks.{d}", h, ctx, heads)
    if linear:
        h = _linear(h, p, f"{pre}.proj_out").transpose(1, 2).reshape(B, C, H, W)
    else:
        h = h.transpose(1, 2).reshape(B, C, H, W)
        h = _conv(h, p[f"{pre}.proj_out.weight"], p[f"{pre}.proj_out.bias"], pad=0)
    return h + x


def time_embedding(cfg: UNetConfig, p: Params, t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    temb = get_timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                  cfg.freq_shift).to(dt)
    temb = _linear(temb, p, "time_embedding.linear_1")
    return _linear(F.silu(temb), p, "time_embedding.linear_2")


def down_blocks(cfg: UNetConfig, p: Params, h: torch.Tensor, temb, ctx,
                motion: Optional[Callable] = None) -> tuple[torch.Tensor, list]:
    """The encoder ladder: (h, skips). `motion(prefix, h)` runs after each
    layer's attention (AnimateDiff's modules); with it every spatial
    transformer is one block deep, as the JAX motion UNet runs it."""
    g = cfg.norm_num_groups
    skips = [h]
    for bi, btype in enumerate(cfg.down_block_types):
        pre = f"down_blocks.{bi}"
        for li in range(cfg.layers_per_block):
            h = _resnet(p, f"{pre}.resnets.{li}", h, temb, g)
            if btype in _CROSS_DOWN:
                h = _spatial_transformer(p, f"{pre}.attentions.{li}", h, ctx, cfg.heads_for(bi),
                                         g, 1 if motion else cfg.tx_depth_for(bi))
            if motion is not None:
                h = motion(f"{pre}.motion_modules.{li}", h)
            skips.append(h)
        if f"{pre}.downsamplers.0.conv.weight" in p:
            h = _conv(h, p[f"{pre}.downsamplers.0.conv.weight"],
                      p[f"{pre}.downsamplers.0.conv.bias"], stride=2)
            skips.append(h)
    return h, skips


def mid_block(cfg: UNetConfig, p: Params, h: torch.Tensor, temb, ctx,
              motion: Optional[Callable] = None) -> torch.Tensor:
    g, last = cfg.norm_num_groups, len(cfg.block_out_channels) - 1
    h = _resnet(p, "mid_block.resnets.0", h, temb, g)
    h = _spatial_transformer(p, "mid_block.attentions.0", h, ctx, cfg.heads_for(last), g,
                             1 if motion else cfg.tx_depth_for(last))
    if motion is not None:
        h = motion("mid_block.motion_modules.0", h)
    return _resnet(p, "mid_block.resnets.1", h, temb, g)


def up_blocks(cfg: UNetConfig, p: Params, h: torch.Tensor, skips: list, temb, ctx,
              motion: Optional[Callable] = None) -> torch.Tensor:
    g, last = cfg.norm_num_groups, len(cfg.block_out_channels) - 1
    for bi, btype in enumerate(cfg.up_block_types):
        pre = f"up_blocks.{bi}"
        for li in range(cfg.layers_per_block + 1):
            h = _resnet(p, f"{pre}.resnets.{li}", torch.cat([h, skips.pop()], dim=1), temb, g)
            if btype in _CROSS_UP:
                h = _spatial_transformer(p, f"{pre}.attentions.{li}", h, ctx,
                                         cfg.heads_for(last - bi), g,
                                         1 if motion else cfg.tx_depth_for(last - bi))
            if motion is not None:
                h = motion(f"{pre}.motion_modules.{li}", h)
        if f"{pre}.upsamplers.0.conv.weight" in p:
            h = _conv(_up2(h), p[f"{pre}.upsamplers.0.conv.weight"],
                      p[f"{pre}.upsamplers.0.conv.bias"])
    h = _group_norm(h, p["conv_norm_out.weight"], p["conv_norm_out.bias"], g)
    return _conv(F.silu(h), p["conv_out.weight"], p["conv_out.bias"])


def unet_forward(cfg: UNetConfig, p: Params, sample: torch.Tensor, t: torch.Tensor,
                 ctx: torch.Tensor, added_text: Optional[torch.Tensor] = None,
                 added_time_ids: Optional[torch.Tensor] = None,
                 ctrl_residuals: Optional[tuple] = None) -> torch.Tensor:
    """sample [B, C_lat, h, w], t [B], ctx [B, S, C_txt] → the eps / v
    prediction [B, C_lat, h, w] in the weights' dtype.

    SDXL ("text_time"): added_text [B, 1280] (encoder 2's pooled projection)
    and added_time_ids [B, 6] are fourier-embedded into the time embedding.
    ctrl_residuals: (down residuals, mid residual) from controlnet_forward,
    added to the skips and the mid block's output."""
    dt = _dtype(p)
    sample, ctx = sample.to(dt), ctx.to(dt)
    temb = time_embedding(cfg, p, t, dt)
    if cfg.addition_embed_type == "text_time":
        B = sample.shape[0]
        tids = get_timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                      cfg.flip_sin_to_cos, cfg.freq_shift).reshape(B, -1).to(dt)
        aug = _linear(torch.cat([added_text.to(dt), tids], dim=-1), p, "add_embedding.linear_1")
        temb = temb + _linear(F.silu(aug), p, "add_embedding.linear_2")
    h = _conv(sample, p["conv_in.weight"], p["conv_in.bias"])
    h, skips = down_blocks(cfg, p, h, temb, ctx)
    if ctrl_residuals is not None:
        down_res, mid_res = ctrl_residuals
        skips = [s + r.to(dt) for s, r in zip(skips, down_res)]
    h = mid_block(cfg, p, h, temb, ctx)
    if ctrl_residuals is not None:
        h = h + mid_res.to(dt)
    return up_blocks(cfg, p, h, skips, temb, ctx)


def controlnet_forward(cfg: UNetConfig, p: Params, sample: torch.Tensor, t: torch.Tensor,
                       ctx: torch.Tensor, cond: torch.Tensor, scale: float = 1.0) -> tuple:
    """diffusers ControlNetModel: the UNet's encoder whose skips pass through
    1x1 convs, plus a conv tower embedding the pixel-space condition image
    cond [B, 3, H, W] in [0, 1] to latent resolution. → (down residuals, mid)."""
    dt = _dtype(p)
    sample, ctx = sample.to(dt), ctx.to(dt)
    temb = time_embedding(cfg, p, t, dt)
    pre = "controlnet_cond_embedding"
    c = F.silu(_conv(cond.to(dt), p[f"{pre}.conv_in.weight"], p[f"{pre}.conv_in.bias"]))
    i = 0
    while f"{pre}.blocks.{i}.weight" in p:  # diffusers alternates channel-up, stride-2
        c = F.silu(_conv(c, p[f"{pre}.blocks.{i}.weight"], p[f"{pre}.blocks.{i}.bias"],
                         stride=2 if i % 2 == 1 else 1))
        i += 1
    c = _conv(c, p[f"{pre}.conv_out.weight"], p[f"{pre}.conv_out.bias"])
    h = _conv(sample, p["conv_in.weight"], p["conv_in.bias"]) + c
    h, skips = down_blocks(cfg, p, h, temb, ctx)
    h = mid_block(cfg, p, h, temb, ctx)
    down = [scale * _conv(s, p[f"controlnet_down_blocks.{j}.weight"],
                          p[f"controlnet_down_blocks.{j}.bias"], pad=0)
            for j, s in enumerate(skips)]
    mid = scale * _conv(h, p["controlnet_mid_block.weight"], p["controlnet_mid_block.bias"],
                        pad=0)
    return down, mid


# --------------------------------------------------------------------------- #
# VAE
# --------------------------------------------------------------------------- #


def _vae_attn(p: Params, pre: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head self-attention over every pixel."""
    B, C, H, W = x.shape
    h = _group_norm(x, p[f"{pre}.group_norm.weight"], p[f"{pre}.group_norm.bias"], groups)
    h = h.flatten(2).transpose(1, 2)
    q, k, v = (_linear(h, p, f"{pre}.to_{c}") for c in "qkv")
    h = _linear(_attention(q, k, v, heads=1), p, f"{pre}.to_out.0")
    return x + h.transpose(1, 2).reshape(B, C, H, W)


def vae_decode(cfg: VAEConfig, p: Params, latents: torch.Tensor) -> torch.Tensor:
    """[B, C_lat, h, w] (already unscaled) → images [B, 3, s·h, s·w] f32 in [0, 1]."""
    g = cfg.norm_num_groups
    h = latents.to(_dtype(p))
    if "post_quant_conv.weight" in p:  # Flux-class VAEs omit the quant convs
        h = _conv(h, p["post_quant_conv.weight"], p["post_quant_conv.bias"], pad=0)
    h = _conv(h, p["decoder.conv_in.weight"], p["decoder.conv_in.bias"])
    h = _resnet(p, "decoder.mid_block.resnets.0", h, None, g)
    h = _vae_attn(p, "decoder.mid_block.attentions.0", h, g)
    h = _resnet(p, "decoder.mid_block.resnets.1", h, None, g)
    for bi in range(len(cfg.block_out_channels)):
        pre = f"decoder.up_blocks.{bi}"
        for li in range(cfg.layers_per_block + 1):
            h = _resnet(p, f"{pre}.resnets.{li}", h, None, g)
        if f"{pre}.upsamplers.0.conv.weight" in p:
            h = _conv(_up2(h), p[f"{pre}.upsamplers.0.conv.weight"],
                      p[f"{pre}.upsamplers.0.conv.bias"])
    h = _group_norm(h, p["decoder.conv_norm_out.weight"], p["decoder.conv_norm_out.bias"], g)
    img = _conv(F.silu(h), p["decoder.conv_out.weight"], p["decoder.conv_out.bias"])
    return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)


def vae_encode(cfg: VAEConfig, p: Params, img: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """images [B, 3, H, W] in [0, 1] → scaled latents [B, C_lat, H/s, W/s]
    (f32). The distribution's mode, or with `noise` (unit normal, the
    latent's shape) a sample from it."""
    g = cfg.norm_num_groups
    x = (img.float() * 2.0 - 1.0).to(_dtype(p))
    h = _conv(x, p["encoder.conv_in.weight"], p["encoder.conv_in.bias"])
    for bi in range(len(cfg.block_out_channels)):
        pre = f"encoder.down_blocks.{bi}"
        for li in range(cfg.layers_per_block):
            h = _resnet(p, f"{pre}.resnets.{li}", h, None, g)
        if f"{pre}.downsamplers.0.conv.weight" in p:
            # diffusers pads stride-2 convs asymmetrically: (0, 1) on each axis
            h = _conv(F.pad(h, (0, 1, 0, 1)), p[f"{pre}.downsamplers.0.conv.weight"],
                      p[f"{pre}.downsamplers.0.conv.bias"], stride=2, pad=0)
    h = _resnet(p, "encoder.mid_block.resnets.0", h, None, g)
    h = _vae_attn(p, "encoder.mid_block.attentions.0", h, g)
    h = _resnet(p, "encoder.mid_block.resnets.1", h, None, g)
    h = _group_norm(h, p["encoder.conv_norm_out.weight"], p["encoder.conv_norm_out.bias"], g)
    moments = _conv(F.silu(h), p["encoder.conv_out.weight"], p["encoder.conv_out.bias"])
    if "quant_conv.weight" in p:
        moments = _conv(moments, p["quant_conv.weight"], p["quant_conv.bias"], pad=0)
    mean, logvar = moments.float().chunk(2, dim=1)
    if noise is not None:
        mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise.to(mean)
    return mean * cfg.scaling_factor


# --------------------------------------------------------------------------- #
# Schedules and sampler steps (host-side tables in numpy, steps on tensors)
# --------------------------------------------------------------------------- #


def alphas_cumprod(cfg: SDPipelineConfig) -> np.ndarray:
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps,
                        dtype=np.float64) ** 2  # "scaled_linear"
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(cfg: SDPipelineConfig, steps: int) -> np.ndarray:
    ratio = cfg.num_train_timesteps // steps
    return (np.arange(steps) * ratio).round()[::-1].astype(np.int32)  # "leading"


def _pred_x0_eps(cfg: SDPipelineConfig, model_out, x, acp_t):
    """(x0, eps) from the model output under the configured prediction type."""
    sq_a, sq_1ma = math.sqrt(acp_t), math.sqrt(1.0 - acp_t)
    if cfg.prediction_type == "v_prediction":
        return sq_a * x - sq_1ma * model_out, sq_a * model_out + sq_1ma * x
    return (x - sq_1ma * model_out) / sq_a, model_out


def _acp_at(acp: np.ndarray, t: int) -> float:
    return float(acp[t]) if t >= 0 else 1.0


def ddim_step(cfg: SDPipelineConfig, acp: np.ndarray, model_out: torch.Tensor, t: int,
              t_prev: int, x: torch.Tensor) -> torch.Tensor:
    """One eta-0 DDIM step in f32 (acp: alphas_cumprod's table)."""
    acp_prev = _acp_at(acp, t_prev)
    x0, eps = _pred_x0_eps(cfg, model_out.float(), x.float(), float(acp[t]))
    return (math.sqrt(acp_prev) * x0 + math.sqrt(1.0 - acp_prev) * eps).to(x.dtype)


def k_schedule(cfg: SDPipelineConfig, steps: int, karras: bool):
    """(sigmas [steps+1], timesteps [steps]) for the k-diffusion samplers;
    karras=True takes the rho-7 spacing over the trained sigma range and
    inverts the training sigma table for the timesteps."""
    acp = alphas_cumprod(cfg)
    sig = np.sqrt((1 - acp) / acp)
    if not karras:
        ts = ddim_timesteps(cfg, steps).astype(np.float64)
        sigmas = np.interp(ts, np.arange(len(sig)), sig)
        return np.append(sigmas, 0.0).astype(np.float32), ts.astype(np.float32)
    rho = 7.0
    smin, smax = float(sig[0]), float(sig[-1])
    ramp = np.linspace(0.0, 1.0, steps)
    sigmas = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
    ts = np.interp(np.log(sigmas), np.log(sig), np.arange(len(sig)))
    return np.append(sigmas, 0.0).astype(np.float32), ts.astype(np.float32)


def ancestral_sigmas(sigma: float, sigma_next: float) -> tuple[float, float]:
    """(sigma_down, sigma_up) of an eta-1 ancestral step, in f32 as the JAX
    package computes them."""
    s = np.float32(sigma)
    sn = np.float32(sigma_next)
    s2, sn2 = s * s, sn * sn
    up = np.sqrt(np.maximum(sn2 * (s2 - sn2) / np.maximum(s2, np.float32(1e-12)),
                            np.float32(0)))
    down = np.sqrt(np.maximum(sn2 - up * up, np.float32(0)))
    return float(down), float(up)


def euler_a_step(model_out: torch.Tensor, x: torch.Tensor, sigma: float, sigma_next: float,
                 noise: torch.Tensor) -> torch.Tensor:
    """k-diffusion Euler-ancestral over eps-prediction in sigma space."""
    mo, xf = model_out.float(), x.float()
    x0 = xf - sigma * mo
    down, up = ancestral_sigmas(sigma, sigma_next)
    d = (xf - x0) / max(sigma, 1e-12)
    return (xf + d * (down - sigma) + noise.float() * up).to(x.dtype)


def _denoised_sigma(cfg: SDPipelineConfig, model_out, x, sigma: float) -> torch.Tensor:
    """The k-diffusion denoiser D(x, σ) for the prediction type."""
    mo, xf = model_out.float(), x.float()
    if cfg.prediction_type == "v_prediction":
        return xf / (sigma ** 2 + 1.0) - sigma / math.sqrt(sigma ** 2 + 1.0) * mo
    return xf - sigma * mo


def lms_coefficients(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Adams-Bashforth coefficients over the sigma trajectory: the integral
    over [σ_i, σ_{i+1}] of each Lagrange basis through the last `order`
    sigmas (k-diffusion sample_lms)."""
    from scipy.integrate import quad

    steps = len(sigmas) - 1
    co = np.zeros((steps, order), np.float64)
    for i in range(steps):
        cur = min(i + 1, order)
        for j in range(cur):
            def basis(tau, j=j, cur=cur, i=i):
                prod = 1.0
                for k in range(cur):
                    if k != j:
                        prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            co[i, j] = quad(basis, sigmas[i], sigmas[i + 1], epsrel=1e-5)[0]
    return co.astype(np.float32)


def parse_scheduler(scheduler: str) -> tuple[str, bool]:
    """(base name, karras) of a scheduler name, or ValueError (the JAX
    package's message)."""
    karras = False
    if scheduler.startswith("k_"):
        karras, scheduler = True, scheduler[2:]
    if scheduler.endswith("_karras"):
        karras, scheduler = True, scheduler[: -len("_karras")]
    if scheduler not in K_SCHEDULERS + T_SCHEDULERS or (karras and scheduler in T_SCHEDULERS):
        raise ValueError(
            f"unknown scheduler {scheduler!r} (supported: "
            + ", ".join(T_SCHEDULERS + K_SCHEDULERS)
            + ", plus _karras/k_ variants of " + ", ".join(K_SCHEDULERS) + ")")
    return scheduler, karras


def torch_noise(generator: torch.Generator, device) -> Noise:
    """A draw function: unit normal f32 of a shape, from `generator`."""
    return lambda shape: torch.randn(shape, generator=generator, device=device)


# --------------------------------------------------------------------------- #
# Generation
# --------------------------------------------------------------------------- #


def _text_context(cfg: SDPipelineConfig, params, cond_ids, uncond_ids, cond_ids2, uncond_ids2,
                  height: int, width: int):
    """(ctx [2B, S, C] uncond then cond, SDXL (pooled, time ids) or None)."""
    if not cfg.is_xl:
        ctx_c = clip_encode(cfg.text, params["text"], cond_ids)
        ctx_u = clip_encode(cfg.text, params["text"], uncond_ids)
        return torch.cat([ctx_u, ctx_c], dim=0), None
    ids2_c = cond_ids if cond_ids2 is None else cond_ids2
    ids2_u = uncond_ids if uncond_ids2 is None else uncond_ids2
    pen1_c, _ = clip_hidden_states(cfg.text, params["text"], cond_ids)
    pen1_u, _ = clip_hidden_states(cfg.text, params["text"], uncond_ids)
    pen2_c, fin2_c = clip_hidden_states(cfg.text2, params["text2"], ids2_c)
    pen2_u, fin2_u = clip_hidden_states(cfg.text2, params["text2"], ids2_u)
    ctx = torch.cat([torch.cat([pen1_u, pen2_u.to(pen1_u.dtype)], dim=-1),
                     torch.cat([pen1_c, pen2_c.to(pen1_c.dtype)], dim=-1)], dim=0)
    pooled = torch.cat([clip_pooled_projection(cfg.text2, params["text2"], ids2_u, fin2_u),
                        clip_pooled_projection(cfg.text2, params["text2"], ids2_c, fin2_c)])
    B = cond_ids.shape[0]
    time_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                            device=ctx.device).expand(2 * B, 6)
    return ctx, (pooled, time_ids)


def generate(
    cfg: SDPipelineConfig,
    params: dict[str, Params],  # {"text", "unet", "vae"[, "text2", "controlnet"]}
    cond_ids: torch.Tensor,  # [B, S]
    uncond_ids: torch.Tensor,
    steps: int = 20,
    guidance: float = 7.5,
    height: int = 512,
    width: int = 512,
    scheduler: str = "ddim",
    init_noise: Optional[torch.Tensor] = None,  # [B, C, h, w] unit normal
    known_latent: Optional[torch.Tensor] = None,  # scaled latents to keep
    known_mask: Optional[torch.Tensor] = None,  # [B, 1, h, w]; 1 = repaint
    cond_ids2: Optional[torch.Tensor] = None,  # SDXL: tokenizer_2 ids
    uncond_ids2: Optional[torch.Tensor] = None,
    control_image: Optional[torch.Tensor] = None,  # [B, 3, H, W] in [0, 1]
    control_scale: float = 1.0,
    init_image: Optional[torch.Tensor] = None,  # img2img source [B, 3, H, W]
    strength: float = 0.8,
    noise: Optional[Noise] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Text → image; returns [B, 3, H, W] f32 in [0, 1] (the JAX generate).

    SDXL checkpoints condition on both encoders' concatenated penultimate
    states plus encoder 2's pooled projection and the size / crop ids. With
    known_latent / known_mask, the DDIM sampler inpaints: after every step
    the kept region is replaced by the source latent re-noised to the
    step's level. `noise(shape)` returns each draw after the initial latent
    (default: unit normals from `generator`, or a fresh CPU generator seeded 0)."""
    device = cond_ids.device
    if noise is None:
        gen = generator or torch.Generator(device=device).manual_seed(0)
        noise = torch_noise(gen, device)
    B = cond_ids.shape[0]
    ctx, added = _text_context(cfg, params, cond_ids, uncond_ids, cond_ids2, uncond_ids2,
                               height, width)
    vs = cfg.vae.spatial_scale
    lat_shape = (B, cfg.unet.in_channels, height // vs, width // vs)
    x = (init_noise if init_noise is not None else noise(lat_shape)).float()
    acp = alphas_cumprod(cfg)
    i0, init_lat = 0, None
    if init_image is not None:
        i0 = steps - max(1, min(steps, int(round(steps * strength))))
        init_lat = vae_encode(cfg.vae, params["vae"], init_image)
    use_ctrl = control_image is not None and "controlnet" in params
    ctrl_cond2 = torch.cat([control_image, control_image]) if use_ctrl else None

    def cfg_eps(x_in: torch.Tensor, t: float) -> torch.Tensor:
        both = torch.cat([x_in, x_in], dim=0)
        tt = torch.full((2 * B,), float(t), dtype=torch.float32, device=device)
        ctrl = None
        if use_ctrl:
            ctrl = controlnet_forward(cfg.unet, params["controlnet"], both, tt, ctx, ctrl_cond2,
                                      scale=control_scale)
        out = unet_forward(cfg.unet, params["unet"], both, tt, ctx,
                           added_text=added[0] if added else None,
                           added_time_ids=added[1] if added else None,
                           ctrl_residuals=ctrl).float()
        eps_u, eps_c = out.chunk(2, dim=0)
        return eps_u + guidance * (eps_c - eps_u)

    inpainting = known_latent is not None and known_mask is not None
    if inpainting and scheduler != "ddim":
        raise ValueError("inpainting requires the ddim scheduler")
    base, karras = parse_scheduler(scheduler)
    if base in K_SCHEDULERS:
        x = _k_sample(cfg, base, karras, cfg_eps, x, init_lat, steps, i0, acp, noise)
    else:
        x = _t_sample(cfg, base, cfg_eps, x, init_lat, steps, i0, acp, noise,
                      (known_latent, known_mask) if inpainting else None)
    return vae_decode(cfg.vae, params["vae"], x / cfg.vae.scaling_factor)


def _k_sample(cfg, scheduler: str, karras: bool, cfg_eps, x, init_lat, steps: int, i0: int,
              acp: np.ndarray, noise: Noise) -> torch.Tensor:
    """The k-diffusion family in sigma space (k-diffusion's sample_* loops)."""
    sigmas_np, ts_np = k_schedule(cfg, steps, karras)
    sigmas = [float(s) for s in sigmas_np]
    x = init_lat + x * sigmas[i0] if init_lat is not None else x * sigmas[0]
    sig_train = np.sqrt((1.0 - acp) / acp)
    log_sig_train = np.log(sig_train)
    t_grid = np.arange(sig_train.shape[0], dtype=np.float32)

    def denoised_at(xc, i):
        sig = sigmas[i]
        return _denoised_sigma(cfg, cfg_eps(xc.float() / math.sqrt(sig ** 2 + 1.0),
                                            float(ts_np[i])), xc, sig)

    def denoised_at_sigma(xc, sig):
        # off-grid sigmas (dpm_2 midpoints, dpmpp_sde half-steps): invert
        # the training sigma table to a fractional timestep
        t = float(np.interp(np.log(np.float32(max(sig, 1e-10))), log_sig_train, t_grid))
        return _denoised_sigma(cfg, cfg_eps(xc.float() / math.sqrt(sig ** 2 + 1.0), t), xc, sig)

    def lg(s):
        return math.log(max(s, 1e-10))

    if scheduler == "lms":
        order = min(4, steps - i0)
        co = lms_coefficients(sigmas_np[i0:], order)
        hist = [torch.zeros_like(x) for _ in range(order)]
    old = None
    for i in range(i0, steps):
        sig, sig_n = sigmas[i], sigmas[i + 1]
        xf = x.float()
        if scheduler == "euler":
            d = (xf - denoised_at(x, i)) / sig
            x = xf + d * (sig_n - sig)
        elif scheduler in ("dpm_2", "dpm_2_a"):
            anc = scheduler == "dpm_2_a"
            z = noise(tuple(x.shape)) if anc else None
            den = denoised_at(x, i)
            d = (xf - den) / sig
            if sig_n == 0.0:
                x = xf + d * (sig_n - sig)
                continue
            tgt, su = ancestral_sigmas(sig, sig_n) if anc else (sig_n, 0.0)
            sig_mid = math.exp(0.5 * (math.log(sig) + lg(tgt)))
            x_2 = xf + d * (sig_mid - sig)
            d2 = (x_2 - denoised_at_sigma(x_2, sig_mid)) / sig_mid
            x = xf + d2 * (tgt - sig)
            if anc:
                x = x + z.float() * su
        elif scheduler == "dpmpp_sde":
            z1, z2 = noise(tuple(x.shape)), noise(tuple(x.shape))
            den = denoised_at(x, i)
            if sig_n == 0.0:
                x = den
                continue
            t_c = -math.log(sig)
            s_mid = math.exp(-(t_c + 0.5 * (-lg(sig_n) - t_c)))
            sd1, su1 = ancestral_sigmas(sig, s_mid)
            x_2 = (sd1 / sig) * xf - math.expm1(t_c + lg(sd1)) * den + z1.float() * su1
            den2 = denoised_at_sigma(x_2, s_mid)
            sd2, su2 = ancestral_sigmas(sig, sig_n)
            x = (sd2 / sig) * xf - math.expm1(t_c + lg(sd2)) * den2 + z2.float() * su2
        elif scheduler == "dpmpp_2m_sde":
            z = noise(tuple(x.shape))
            den = denoised_at(x, i)
            if sig_n == 0.0:
                x, old = den, den
                continue
            t_c, t_n = -math.log(sig), -lg(sig_n)
            h = t_n - t_c
            xn = (sig_n / sig) * math.exp(-h) * xf - math.expm1(-2.0 * h) * den
            if i != i0:
                r = (t_c + math.log(sigmas[max(i - 1, 0)])) / h
                xn = xn - 0.5 * math.expm1(-2.0 * h) * (1.0 / r) * (den - old)
            x = xn + z.float() * sig_n * math.sqrt(max(-math.expm1(-2.0 * h), 0.0))
            old = den
        elif scheduler == "euler_a":
            z = noise(tuple(x.shape))
            eps = cfg_eps(x / math.sqrt(sig ** 2 + 1.0), float(ts_np[i]))
            x = euler_a_step(eps, x, sig, sig_n, z)
        elif scheduler == "dpmpp_2m":
            den = denoised_at(x, i)
            t_c, t_n = -math.log(sig), -lg(sig_n)
            h = t_n - t_c
            if i == i0 or sig_n == 0.0:
                den_use = den
            else:
                r = (t_c + math.log(sigmas[max(i - 1, 0)])) / h
                den_use = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old
            x = (sig_n / sig) * xf - math.expm1(-h) * den_use
            old = den
        elif scheduler == "heun":
            d = (xf - denoised_at(x, i)) / sig
            dt = sig_n - sig
            x_eul = xf + d * dt
            if sig_n == 0.0:
                x = x_eul
                continue
            d2 = (x_eul - denoised_at(x_eul, min(i + 1, steps - 1))) / max(sig_n, 1e-10)
            x = xf + (d + d2) / 2 * dt
        else:  # lms
            d = (xf - denoised_at(x, i)) / sig
            hist = [d] + hist[:-1]
            c = co[i - i0]
            x = xf + sum(float(c[j]) * hist[j] for j in range(order))
    return x


def _t_sample(cfg, scheduler: str, cfg_eps, x, init_lat, steps: int, i0: int,
              acp: np.ndarray, noise: Noise, known) -> torch.Tensor:
    """The timestep-space samplers: DDIM (with inpainting's blend), PNDM
    (PLMS) and UniPC (bh2, order 2)."""
    ts = [int(t) for t in ddim_timesteps(cfg, steps)]
    ratio = cfg.num_train_timesteps // steps
    if init_lat is not None:
        a0 = float(acp[ts[i0]])
        x = math.sqrt(a0) * init_lat + math.sqrt(1.0 - a0) * x
    if scheduler == "pndm":
        # PLMS: Adams-Bashforth eps history (orders 1 → 4) through the
        # pseudo-linear transfer (one order-1 first step: the JAX package's
        # deliberate difference from diffusers' skip_prk warmup).
        hist: list[torch.Tensor] = []
        for idx in range(i0, steps):
            t = ts[idx]
            eps = cfg_eps(x, float(t))
            a_t = float(acp[t])
            if cfg.prediction_type == "v_prediction":
                eps = math.sqrt(a_t) * eps + math.sqrt(1.0 - a_t) * x.float()
            n = len(hist)
            if n == 0:
                ep = eps
            elif n == 1:
                ep = (3.0 * eps - hist[0]) / 2.0
            elif n == 2:
                ep = (23.0 * eps - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
            else:
                ep = (55.0 * eps - 59.0 * hist[0] + 37.0 * hist[1] - 9.0 * hist[2]) / 24.0
            a_p = _acp_at(acp, t - ratio)
            coeff = math.sqrt(a_p / a_t)
            denom = a_t * math.sqrt(1.0 - a_p) + math.sqrt(a_t * (1.0 - a_t) * a_p)
            x = coeff * x.float() - (a_p - a_t) * ep / denom
            hist = [eps] + hist[:2]
        return x
    if scheduler == "unipc":
        def at(t):
            a = math.sqrt(float(acp[t])) if t >= 0 else 1.0
            s = math.sqrt(1.0 - float(acp[t])) if t >= 0 else 0.0
            s = max(s, 1e-10)
            return a, s, math.log(a) - math.log(s)

        x_prev, m_prev, t_prev = x, torch.zeros_like(x), ts[i0]
        for cnt, idx in enumerate(range(i0, steps)):
            t = ts[idx]
            a_t, s_t, lam_t = at(t)
            eps = cfg_eps(x, float(t))
            if cfg.prediction_type == "v_prediction":
                m_t = a_t * x.float() - s_t * eps
            else:
                m_t = (x.float() - s_t * eps) / a_t
            _, s_p, lam_p = at(t_prev)
            if cnt > 0:  # UniC: correct this sample with the fresh model output
                phi_c = math.expm1(-(lam_t - lam_p))
                xcf = (s_t / s_p) * x_prev.float() - a_t * phi_c * m_prev \
                    - a_t * phi_c * 0.5 * (m_t - m_prev)
            else:
                xcf = x.float()
            t_n = t - ratio  # UniP: p = 1 first, 2 after; order 1 when t_n leaves the schedule
            a_n, s_n, lam_n = at(t_n)
            h = lam_n - lam_t
            phi = math.expm1(-h)
            x1 = (s_n / s_t) * xcf - a_n * phi * m_t
            if cnt > 0 and t_n >= 0:
                d1 = (m_prev - m_t) / ((lam_p - lam_t) / h)
                x = x1 - a_n * phi * 0.5 * d1
            else:
                x = x1
            x_prev, m_prev, t_prev = xcf, m_t, t
        return x
    for i in range(i0, steps):  # ddim
        z = noise(tuple(x.shape)) if known is not None else None
        t = ts[i]
        x = ddim_step(cfg, acp, cfg_eps(x, float(t)), t, t - ratio, x)
        if known is not None:
            kl, km = known
            a_p = _acp_at(acp, t - ratio)
            noised = math.sqrt(a_p) * kl.float() + math.sqrt(1.0 - a_p) * z.float()
            x = km * x + (1.0 - km) * noised
    return x


# --------------------------------------------------------------------------- #
# Checkpoint loading (diffusers layout)
# --------------------------------------------------------------------------- #


def is_diffusers_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "model_index.json"))


def _st_files(subdir: str) -> list[str]:
    files = sorted(f for f in os.listdir(subdir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {subdir}")
    return [os.path.join(subdir, f) for f in files]


def stored_dtype(subdir: str) -> torch.dtype:
    """bf16 when a directory's first tensor is stored BF16 / F16, else f32."""
    from localai_tpu_torch.engine.weights import SafetensorsFile

    st = SafetensorsFile(_st_files(subdir)[0])
    first = next(iter(st.header.values()))["dtype"]
    return torch.bfloat16 if first in ("BF16", "F16") else torch.float32


def load_safetensors_dir(subdir: str, dtype: torch.dtype, device) -> Params:
    """Every tensor of a directory's .safetensors files, by its published
    name, in the checkpoint's own layout, as `dtype` on `device`."""
    from localai_tpu_torch.engine.weights import SafetensorsFile

    out: Params = {}
    for path in _st_files(subdir):
        st = SafetensorsFile(path)
        for name in st.keys():
            out[name] = st.get(name).to(device=device, dtype=dtype)
    return out


def _cfg_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_tokenizer_dir(tok_dir: str):
    """The checkpoint's CLIPTokenizer(Fast) through transformers."""
    from transformers import AutoTokenizer, CLIPTokenizer

    try:
        return AutoTokenizer.from_pretrained(tok_dir, local_files_only=True)
    except Exception:  # noqa: BLE001 — vocab.json / merges.txt direct load
        return CLIPTokenizer.from_pretrained(tok_dir, local_files_only=True)


def config_from_dir(ckpt_dir: str) -> SDPipelineConfig:
    tc = _cfg_json(os.path.join(ckpt_dir, "text_encoder", "config.json"))
    uc = _cfg_json(os.path.join(ckpt_dir, "unet", "config.json"))
    vc = _cfg_json(os.path.join(ckpt_dir, "vae", "config.json"))
    sched_path = os.path.join(ckpt_dir, "scheduler", "scheduler_config.json")
    sc = _cfg_json(sched_path) if os.path.isfile(sched_path) else {}
    cfg = SDPipelineConfig(
        text=CLIPTextConfig(
            vocab_size=tc.get("vocab_size", 49408),
            hidden_size=tc.get("hidden_size", 768),
            intermediate_size=tc.get("intermediate_size", 3072),
            num_hidden_layers=tc.get("num_hidden_layers", 12),
            num_attention_heads=tc.get("num_attention_heads", 12),
            max_position_embeddings=tc.get("max_position_embeddings", 77),
            hidden_act=tc.get("hidden_act", "quick_gelu"),
        ),
        unet=UNetConfig(
            in_channels=uc.get("in_channels", 4),
            out_channels=uc.get("out_channels", 4),
            sample_size=uc.get("sample_size", 64),
            block_out_channels=tuple(uc.get("block_out_channels", (320, 640, 1280, 1280))),
            down_block_types=tuple(uc.get("down_block_types", ())),
            up_block_types=tuple(uc.get("up_block_types", ())),
            layers_per_block=uc.get("layers_per_block", 2),
            attention_head_dim=uc.get("attention_head_dim", 8),
            cross_attention_dim=uc.get("cross_attention_dim", 768),
            norm_num_groups=uc.get("norm_num_groups", 32),
            flip_sin_to_cos=uc.get("flip_sin_to_cos", True),
            freq_shift=uc.get("freq_shift", 0),
            transformer_layers_per_block=uc.get("transformer_layers_per_block", 1),
            addition_embed_type=uc.get("addition_embed_type") or "",
            addition_time_embed_dim=uc.get("addition_time_embed_dim", 256),
            projection_class_embeddings_input_dim=uc.get(
                "projection_class_embeddings_input_dim", 0),
        ),
        vae=VAEConfig(
            in_channels=vc.get("in_channels", 3),
            out_channels=vc.get("out_channels", 3),
            latent_channels=vc.get("latent_channels", 4),
            block_out_channels=tuple(vc.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=vc.get("layers_per_block", 2),
            norm_num_groups=vc.get("norm_num_groups", 32),
            scaling_factor=vc.get("scaling_factor", 0.18215),
        ),
        num_train_timesteps=sc.get("num_train_timesteps", 1000),
        beta_start=sc.get("beta_start", 0.00085),
        beta_end=sc.get("beta_end", 0.012),
        prediction_type=sc.get("prediction_type", "epsilon"),
    )
    te2 = os.path.join(ckpt_dir, "text_encoder_2")
    if os.path.isdir(te2):
        t2 = _cfg_json(os.path.join(te2, "config.json"))
        cfg.text2 = CLIPTextConfig(
            vocab_size=t2.get("vocab_size", 49408),
            hidden_size=t2.get("hidden_size", 1280),
            intermediate_size=t2.get("intermediate_size", 5120),
            num_hidden_layers=t2.get("num_hidden_layers", 32),
            num_attention_heads=t2.get("num_attention_heads", 20),
            max_position_embeddings=t2.get("max_position_embeddings", 77),
            hidden_act=t2.get("hidden_act", "gelu"),
            projection_dim=t2.get("projection_dim", 1280),
            eos_token_id=t2.get("eos_token_id", 49407),
        )
    return cfg


def load_pipeline(ckpt_dir: str, dtype: Optional[torch.dtype] = None, device=None):
    """(SDPipelineConfig, params, tokenizer) from a diffusers checkpoint dir
    (the JAX load_pipeline). dtype None keeps the UNet's stored precision
    (bf16 for a BF16 / F16 file, else f32). A `controlnet/` subdir loads as
    params["controlnet"]; an SDXL layout (`text_encoder_2/`) adds
    params["text2"] and returns (tokenizer, tokenizer_2)."""
    device = resolve_device(device)
    cfg = config_from_dir(ckpt_dir)
    if dtype is None:
        dtype = stored_dtype(os.path.join(ckpt_dir, "unet"))
    params = {part: load_safetensors_dir(os.path.join(ckpt_dir, sub), dtype, device)
              for part, sub in (("text", "text_encoder"), ("unet", "unet"), ("vae", "vae"))}
    tokenizer = load_tokenizer_dir(os.path.join(ckpt_dir, "tokenizer"))
    ctrl_dir = os.path.join(ckpt_dir, "controlnet")
    if os.path.isdir(ctrl_dir):
        params["controlnet"] = load_safetensors_dir(ctrl_dir, dtype, device)
    if cfg.text2 is not None:
        params["text2"] = load_safetensors_dir(os.path.join(ckpt_dir, "text_encoder_2"), dtype,
                                               device)
        tok2_dir = os.path.join(ckpt_dir, "tokenizer_2")
        tok2 = load_tokenizer_dir(tok2_dir) if os.path.isdir(tok2_dir) else tokenizer
        return cfg, params, (tokenizer, tok2)
    return cfg, params, tokenizer


def load_diffusion_lora(path: str, params: dict[str, Params], multiplier: float = 1.0) -> int:
    """Merge a kohya-format LoRA file (`lora_unet_*` / `lora_te*_*` layers
    with lora_down / lora_up / alpha) into loaded params in place, scaled by
    multiplier · alpha / rank. Returns the number of base tensors patched."""
    from localai_tpu_torch.engine.weights import SafetensorsFile

    st = SafetensorsFile(path)
    groups: dict[str, dict[str, torch.Tensor]] = {}
    for name in st.keys():
        if "." not in name:
            log.warning("lora: ignoring non-LoRA tensor %r", name)
            continue
        layer, elem = name.split(".", 1)
        groups.setdefault(layer, {})[elem] = st.get(name)
    lookups: dict[str, dict[str, str]] = {}

    def lookup_for(part: str) -> dict[str, str]:
        if part not in lookups:  # kohya flattens module paths with "_"
            lookups[part] = {k[: -len(".weight")].replace(".", "_"): k
                             for k in params.get(part, {}) if k.endswith(".weight")}
        return lookups[part]

    prefixes = (("lora_unet_", "unet"), ("lora_te1_", "text"),
                ("lora_te2_", "text2"), ("lora_te_", "text"))
    merged = 0
    for layer, elems in groups.items():
        target = rest = None
        for pref, part in prefixes:
            if layer.startswith(pref):
                target, rest = part, layer[len(pref):]
                break
        if target is None or target not in params:
            continue
        key = lookup_for(target).get(rest)
        down, up = elems.get("lora_down.weight"), elems.get("lora_up.weight")
        if key is None or down is None or up is None:
            if key is None:
                log.warning("lora: no target for %s (skipped)", layer)
            continue
        rank = down.shape[0]
        alpha = float(elems["alpha"].float()) if "alpha" in elems else float(rank)
        scale = multiplier * alpha / rank
        base = params[target][key]
        if down.dim() == 4:  # conv: up [O, r, 1, 1] @ down [r, I, kh, kw]
            delta = torch.einsum("or,rikl->oikl", up.float().reshape(up.shape[0], rank),
                                 down.float()) * scale
        else:  # linear: [out, r] @ [r, in]
            delta = (up.float() @ down.float()) * scale
        if tuple(delta.shape) != tuple(base.shape):
            log.warning("lora: %s shape %s != base %s (skipped)", layer, tuple(delta.shape),
                        tuple(base.shape))
            continue
        params[target][key] = (base.float() + delta.to(base.device)).to(base.dtype)
        merged += 1
    return merged


# --------------------------------------------------------------------------- #
# The JAX package's dicts, and random diffusers-layout checkpoints
# --------------------------------------------------------------------------- #

_LOOKUP_TABLES = ("token_embedding", "position_embedding", "shared.weight",
                  "relative_attention_bias")


def params_from_jax(tree: dict, dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The JAX package's flat name → array dicts (convs HWIO, linears
    [in, out]; numpy or anything np.asarray takes), nested one level by
    part or not, → the port's (OIHW, [out, in]) on `device`, for every
    family here (SD / SDXL / ControlNet, Flux's transformer and T5, the
    motion adapter). Embedding tables keep their lookup orientation."""
    device = resolve_device(device)

    def conv(name: str, x) -> torch.Tensor:
        a = np.asarray(x, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and name.endswith(".weight") and not any(
                t in name for t in _LOOKUP_TABLES):
            a = a.T
        return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)

    return {k: (params_from_jax(v, dtype, device) if isinstance(v, dict) else conv(k, v))
            for k, v in tree.items()}


class _Shapes:
    """Published tensor names → shapes (torch layouts), in write order."""

    def __init__(self) -> None:
        self.s: dict[str, tuple] = {}

    def conv(self, name, ci, co, k=3):
        self.s[f"{name}.weight"], self.s[f"{name}.bias"] = (co, ci, k, k), (co,)

    def lin(self, name, ci, co, bias=True):
        self.s[f"{name}.weight"] = (co, ci)
        if bias:
            self.s[f"{name}.bias"] = (co,)

    def norm(self, name, c):
        self.s[f"{name}.weight"] = self.s[f"{name}.bias"] = (c,)

    def resnet(self, pre, ci, co, temb=0):
        self.norm(f"{pre}.norm1", ci)
        self.conv(f"{pre}.conv1", ci, co)
        if temb:
            self.lin(f"{pre}.time_emb_proj", temb, co)
        self.norm(f"{pre}.norm2", co)
        self.conv(f"{pre}.conv2", co, co)
        if ci != co:
            self.conv(f"{pre}.conv_shortcut", ci, co, k=1)

    def transformer_block(self, tb, c, ctx=None):
        """A BasicTransformerBlock: self-attention, cross-attention over ctx
        (or a second self-attention when ctx is None: AnimateDiff's), GEGLU."""
        self.norm(f"{tb}.norm1", c)
        for nm in ("to_q", "to_k", "to_v"):
            self.lin(f"{tb}.attn1.{nm}", c, c, bias=False)
        self.lin(f"{tb}.attn1.to_out.0", c, c)
        self.norm(f"{tb}.norm2", c)
        self.lin(f"{tb}.attn2.to_q", c, c, bias=False)
        self.lin(f"{tb}.attn2.to_k", ctx or c, c, bias=False)
        self.lin(f"{tb}.attn2.to_v", ctx or c, c, bias=False)
        self.lin(f"{tb}.attn2.to_out.0", c, c)
        self.norm(f"{tb}.norm3", c)
        self.lin(f"{tb}.ff.net.0.proj", c, 8 * c)
        self.lin(f"{tb}.ff.net.2", 4 * c, c)

    def spatial(self, pre, c, ctx, depth, linear):
        self.norm(f"{pre}.norm", c)
        (self.lin if linear else lambda n, a, b: self.conv(n, a, b, k=1))(f"{pre}.proj_in", c, c)
        for d in range(depth):
            self.transformer_block(f"{pre}.transformer_blocks.{d}", c, ctx)
        (self.lin if linear else lambda n, a, b: self.conv(n, a, b, k=1))(f"{pre}.proj_out", c, c)

    def vae_attn(self, pre, c):
        self.norm(f"{pre}.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            self.lin(f"{pre}.{nm}", c, c)


def _unet_encoder(g: _Shapes, cfg: UNetConfig, linear: bool) -> list[int]:
    """The time embedding, conv_in, down blocks and mid block (the UNet's and
    the ControlNet's); returns the skip channels."""
    boc = cfg.block_out_channels
    temb = 4 * boc[0]
    g.lin("time_embedding.linear_1", boc[0], temb)
    g.lin("time_embedding.linear_2", temb, temb)
    g.conv("conv_in", cfg.in_channels, boc[0])
    skips, h = [boc[0]], boc[0]
    for bi, btype in enumerate(cfg.down_block_types):
        out = boc[bi]
        for li in range(cfg.layers_per_block):
            g.resnet(f"down_blocks.{bi}.resnets.{li}", h, out, temb)
            h = out
            if btype in _CROSS_DOWN:
                g.spatial(f"down_blocks.{bi}.attentions.{li}", out, cfg.cross_attention_dim,
                          cfg.tx_depth_for(bi), linear)
            skips.append(out)
        if bi < len(boc) - 1:
            g.conv(f"down_blocks.{bi}.downsamplers.0.conv", out, out)
            skips.append(out)
    last = len(boc) - 1
    g.resnet("mid_block.resnets.0", h, h, temb)
    g.spatial("mid_block.attentions.0", h, cfg.cross_attention_dim, cfg.tx_depth_for(last),
              linear)
    g.resnet("mid_block.resnets.1", h, h, temb)
    return skips


def unet_shapes(cfg: UNetConfig, linear: bool = False) -> dict[str, tuple]:
    """Every tensor of a diffusers UNet2DConditionModel at cfg."""
    g = _Shapes()
    boc = cfg.block_out_channels
    temb = 4 * boc[0]
    if cfg.addition_embed_type == "text_time":
        g.lin("add_embedding.linear_1", cfg.projection_class_embeddings_input_dim, temb)
        g.lin("add_embedding.linear_2", temb, temb)
    skips = _unet_encoder(g, cfg, linear)
    h, rev = boc[-1], list(reversed(boc))
    last = len(boc) - 1
    for bi, btype in enumerate(cfg.up_block_types):
        out = rev[bi]
        for li in range(cfg.layers_per_block + 1):
            g.resnet(f"up_blocks.{bi}.resnets.{li}", h + skips.pop(), out, temb)
            h = out
            if btype in _CROSS_UP:
                g.spatial(f"up_blocks.{bi}.attentions.{li}", out, cfg.cross_attention_dim,
                          cfg.tx_depth_for(last - bi), linear)
        if bi < last:
            g.conv(f"up_blocks.{bi}.upsamplers.0.conv", out, out)
    g.norm("conv_norm_out", boc[0])
    g.conv("conv_out", boc[0], cfg.out_channels)
    return g.s


def controlnet_shapes(cfg: UNetConfig, linear: bool = False,
                      embed_channels: tuple = (16, 32, 96, 256)) -> dict[str, tuple]:
    """A diffusers ControlNetModel at the UNet's geometry: the condition
    tower (conv_in, channel-up / stride-2 pairs, conv_out to the first
    block's width), the encoder copy and one 1x1 conv a skip and the mid."""
    g = _Shapes()
    pre = "controlnet_cond_embedding"
    g.conv(f"{pre}.conv_in", 3, embed_channels[0])
    j = 0
    for a, b in zip(embed_channels[:-1], embed_channels[1:]):
        g.conv(f"{pre}.blocks.{j}", a, a)
        g.conv(f"{pre}.blocks.{j + 1}", a, b)
        j += 2
    g.conv(f"{pre}.conv_out", embed_channels[-1], cfg.block_out_channels[0])
    skips = _unet_encoder(g, cfg, linear)
    for i, c in enumerate(skips):
        g.conv(f"controlnet_down_blocks.{i}", c, c, k=1)
    c = cfg.block_out_channels[-1]
    g.conv("controlnet_mid_block", c, c, k=1)
    return g.s


def vae_shapes(cfg: VAEConfig, quant_convs: bool = True) -> dict[str, tuple]:
    """Every tensor of a diffusers AutoencoderKL at cfg (Flux's has no quant convs)."""
    g = _Shapes()
    boc, lat = cfg.block_out_channels, cfg.latent_channels
    g.conv("encoder.conv_in", cfg.in_channels, boc[0])
    h = boc[0]
    for bi, out in enumerate(boc):
        for li in range(cfg.layers_per_block):
            g.resnet(f"encoder.down_blocks.{bi}.resnets.{li}", h, out)
            h = out
        if bi < len(boc) - 1:
            g.conv(f"encoder.down_blocks.{bi}.downsamplers.0.conv", out, out)
    g.resnet("encoder.mid_block.resnets.0", h, h)
    g.vae_attn("encoder.mid_block.attentions.0", h)
    g.resnet("encoder.mid_block.resnets.1", h, h)
    g.norm("encoder.conv_norm_out", h)
    g.conv("encoder.conv_out", h, 2 * lat)
    if quant_convs:
        g.conv("quant_conv", 2 * lat, 2 * lat, k=1)
        g.conv("post_quant_conv", lat, lat, k=1)
    rev = list(reversed(boc))
    g.conv("decoder.conv_in", lat, rev[0])
    h = rev[0]
    g.resnet("decoder.mid_block.resnets.0", h, h)
    g.vae_attn("decoder.mid_block.attentions.0", h)
    g.resnet("decoder.mid_block.resnets.1", h, h)
    for bi, out in enumerate(rev):
        for li in range(cfg.layers_per_block + 1):
            g.resnet(f"decoder.up_blocks.{bi}.resnets.{li}", h, out)
            h = out
        if bi < len(rev) - 1:
            g.conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", out, out)
    g.norm("decoder.conv_norm_out", h)
    g.conv("decoder.conv_out", h, cfg.out_channels)
    return g.s


def clip_shapes(cfg: CLIPTextConfig) -> dict[str, tuple]:
    """Every tensor of an HF CLIPTextModel(WithProjection) at cfg."""
    g = _Shapes()
    C = cfg.hidden_size
    g.s["text_model.embeddings.token_embedding.weight"] = (cfg.vocab_size, C)
    g.s["text_model.embeddings.position_embedding.weight"] = (cfg.max_position_embeddings, C)
    for i in range(cfg.num_hidden_layers):
        pre = f"text_model.encoder.layers.{i}"
        g.norm(f"{pre}.layer_norm1", C)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            g.lin(f"{pre}.self_attn.{nm}", C, C)
        g.norm(f"{pre}.layer_norm2", C)
        g.lin(f"{pre}.mlp.fc1", C, cfg.intermediate_size)
        g.lin(f"{pre}.mlp.fc2", cfg.intermediate_size, C)
    g.norm("text_model.final_layer_norm", C)
    if cfg.projection_dim:
        g.lin("text_projection", C, cfg.projection_dim, bias=False)
    return g.s


def random_tensor(name: str, shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    """One seeded random tensor of a published name: norms (and RMS scales)
    at one / zero, other weights normal with std 1/√fan_in (fan_in: the
    elements of one output row), biases and embedding tables normal · 0.02:
    activations stay near unit scale at any width and depth."""
    if "norm" in name and len(shape) == 1:
        return torch.full(shape, 1.0 if name.endswith(".weight") else 0.0, device=device)
    if name.endswith(".bias") or len(shape) == 1 or any(t in name for t in _LOOKUP_TABLES):
        return torch.randn(shape, generator=gen, device=device) * 0.02
    fan_in = math.prod(shape[1:])
    return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)


def write_random(path: str, shapes: dict[str, tuple], seed: int, dtype: torch.dtype,
                 device) -> None:
    """One safetensors file of seeded random tensors (random_tensor), drawn
    one at a time on `device` from a generator seeded `seed`."""
    from localai_tpu_torch.engine.weights import write_safetensors

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_safetensors(path, shapes, dtype, lambda n: random_tensor(n, shapes[n], gen, device))


def write_bpe_tokenizer(tok_dir: str, vocab: int = 1000, max_len: int = 77,
                        specials=("<|startoftext|>", "<|endoftext|>"),
                        pad: str = "<|endoftext|>", wrap: bool = True) -> dict[str, int]:
    """A byte-level BPE tokenizer trained on a fixed text (`tokenizers`,
    deterministic): tokenizer.json + tokenizer_config.json that
    AutoTokenizer reads. Its ids are a subset of a published vocabulary's
    rows. wrap: begin / end every encoding with the first two specials (as
    CLIP's does). Returns the specials' ids."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = BpeTrainer(vocab_size=vocab, special_tokens=list(specials), show_progress=False,
                         initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    text = ("a photo of a cat on a red sofa, an astronaut riding a horse on the moon, "
            "a watercolor painting of a lighthouse at dawn, highly detailed, 4k")
    tok.train_from_iterator([text] * 20, trainer)
    ids = {s: tok.token_to_id(s) for s in specials}
    if wrap:
        bos, eos = specials[0], specials[1]
        tok.post_processor = processors.TemplateProcessing(
            single=f"{bos} $A {eos}", special_tokens=[(bos, ids[bos]), (eos, ids[eos])])
    os.makedirs(tok_dir, exist_ok=True)
    tok.save(os.path.join(tok_dir, "tokenizer.json"))
    doc = {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": pad,
           "model_max_length": max_len}
    if wrap:
        doc.update(bos_token=specials[0], eos_token=specials[1])
    else:
        doc.update(eos_token=specials[1], unk_token=specials[-1])
    with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
        json.dump(doc, f)
    return ids


def _write_json(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def clip_config_doc(cfg: CLIPTextConfig) -> dict:
    return {"architectures": ["CLIPTextModelWithProjection" if cfg.projection_dim
                              else "CLIPTextModel"],
            "model_type": "clip_text_model", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "hidden_act": cfg.hidden_act, "layer_norm_eps": cfg.layer_norm_eps,
            "projection_dim": cfg.projection_dim, "eos_token_id": cfg.eos_token_id}


def save_diffusers(cfg: SDPipelineConfig, ckpt_dir: str, seed: int = 0,
                   dtype: torch.dtype = torch.float32, device=None,
                   controlnet: bool = False) -> SDPipelineConfig:
    """A diffusers-layout SD / SDXL checkpoint of seeded random weights at
    cfg (the published SD-1.5 / SDXL geometries included): model_index.json,
    text_encoder(_2)/, unet/, vae/, scheduler/, tokenizer(_2)/ and, with
    controlnet, controlnet/. The tokenizer is write_bpe_tokenizer's (1000
    ids, a subset of the 49408 rows); the configs' eos_token_id is its end
    token. SDXL (cfg.text2 set) projects by linears, SD-1.5 by 1x1 convs,
    as the published UNets do. Returns cfg with the eos ids written."""
    import dataclasses

    device = resolve_device(device)
    ids = write_bpe_tokenizer(os.path.join(ckpt_dir, "tokenizer"),
                              vocab=min(1000, cfg.text.vocab_size))
    eos = ids["<|endoftext|>"]
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=eos))
    linear = cfg.is_xl
    parts = [("text_encoder", clip_shapes(cfg.text), clip_config_doc(cfg.text)),
             ("unet", unet_shapes(cfg.unet, linear), _unet_doc(cfg.unet, linear)),
             ("vae", vae_shapes(cfg.vae), _vae_doc(cfg.vae))]
    if cfg.is_xl:
        cfg.text2 = dataclasses.replace(cfg.text2, eos_token_id=eos)
        write_bpe_tokenizer(os.path.join(ckpt_dir, "tokenizer_2"),
                            vocab=min(1000, cfg.text2.vocab_size), pad="!")
        parts.append(("text_encoder_2", clip_shapes(cfg.text2), clip_config_doc(cfg.text2)))
    if controlnet:  # the condition tower halves the pixels once a VAE resampler
        steps = len(cfg.vae.block_out_channels) - 1
        parts.append(("controlnet", controlnet_shapes(cfg.unet, linear,
                                                      (16, 32, 96, 256)[: steps + 1]),
                      dict(_unet_doc(cfg.unet, linear), _class_name="ControlNetModel")))
    for i, (sub, shapes, doc) in enumerate(parts):
        fname = "model.safetensors" if sub.startswith("text") else \
            "diffusion_pytorch_model.safetensors"
        write_random(os.path.join(ckpt_dir, sub, fname), shapes, seed + i, dtype, device)
        _write_json(os.path.join(ckpt_dir, sub, "config.json"), doc)
    _write_json(os.path.join(ckpt_dir, "scheduler", "scheduler_config.json"), {
        "_class_name": "DDIMScheduler", "num_train_timesteps": cfg.num_train_timesteps,
        "beta_start": cfg.beta_start, "beta_end": cfg.beta_end,
        "beta_schedule": "scaled_linear", "prediction_type": cfg.prediction_type})
    _write_json(os.path.join(ckpt_dir, "model_index.json"), {
        "_class_name": "StableDiffusionXLPipeline" if cfg.is_xl else "StableDiffusionPipeline"})
    return cfg


def _unet_doc(cfg: UNetConfig, linear: bool) -> dict:
    doc = {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
           "out_channels": cfg.out_channels, "sample_size": cfg.sample_size,
           "block_out_channels": list(cfg.block_out_channels),
           "down_block_types": list(cfg.down_block_types),
           "up_block_types": list(cfg.up_block_types),
           "layers_per_block": cfg.layers_per_block,
           "attention_head_dim": (list(cfg.attention_head_dim)
                                  if isinstance(cfg.attention_head_dim, (list, tuple))
                                  else cfg.attention_head_dim),
           "cross_attention_dim": cfg.cross_attention_dim,
           "norm_num_groups": cfg.norm_num_groups, "flip_sin_to_cos": cfg.flip_sin_to_cos,
           "freq_shift": cfg.freq_shift, "use_linear_projection": linear,
           "transformer_layers_per_block": (list(cfg.transformer_layers_per_block)
                                            if isinstance(cfg.transformer_layers_per_block,
                                                          (list, tuple))
                                            else cfg.transformer_layers_per_block)}
    if cfg.addition_embed_type:
        doc.update(addition_embed_type=cfg.addition_embed_type,
                   addition_time_embed_dim=cfg.addition_time_embed_dim,
                   projection_class_embeddings_input_dim=(
                       cfg.projection_class_embeddings_input_dim))
    return doc


def _vae_doc(cfg: VAEConfig) -> dict:
    return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "latent_channels": cfg.latent_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block, "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor, "shift_factor": cfg.shift_factor}
