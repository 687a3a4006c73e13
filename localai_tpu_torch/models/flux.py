"""Flux.1-class rectified-flow MMDiT text → image on tensors
(localai_tpu/models/flux.py).

The T5 encoder (relative-position buckets, RMS pre-norms, gated gelu), the
CLIP pooled conditioning, the double / single-stream FluxTransformer2DModel
with its 3-axis rope, the 2x2 latent packing, the dynamically shifted
flow-matching sigmas and the Euler sampler. No CFG pass: Flux is
guidance-distilled, the guidance enters as an embedding. Weights keep the
checkpoint's layout (linears [out, in], convs OIHW), as in
models/latent_diffusion.py, and compute runs in their dtype (bf16 by
default, as the JAX loader stores them) with f32 norms, softmax and latent.

The sampler is an eager loop; the initial latent comes in as a tensor
(`init_noise`, or drawn from a torch generator). `save_flux` writes a
random FluxPipeline-layout checkpoint at any geometry (Flux.1-dev's
published widths included) and `init_transformer` draws one transformer on
the device, for the tests and the card.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.latent_diffusion import (
    CLIPTextConfig,
    Params,
    VAEConfig,
    _dtype,
    _linear,
    _Shapes,
    _write_json,
    attention,
    clip_config_doc,
    clip_hidden_states,
    clip_pooled_projection,
    clip_shapes,
    get_timestep_embedding,
    load_safetensors_dir,
    random_tensor,
    vae_decode,
    vae_encode,
    vae_shapes,
    write_bpe_tokenizer,
    write_random,
)


@dataclass
class T5EncoderConfig:
    """The HF T5 config subset the encoder reads (T5-XXL for Flux)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    gated_ff: bool = True
    gelu_tanh: bool = True  # "gated-gelu" is HF's NewGELU (tanh)
    eps: float = 1e-6


@dataclass
class FluxTransformerConfig:
    """FluxTransformer2DModel geometry (transformer/config.json)."""

    in_channels: int = 64  # packed: VAE latent channels x 2x2 patch
    num_layers: int = 19  # double-stream blocks
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5 d_model
    pooled_projection_dim: int = 768  # CLIP hidden size
    guidance_embeds: bool = True  # dev: distilled guidance; schnell: False
    axes_dims_rope: tuple = (16, 56, 56)
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclass
class FluxSchedulerConfig:
    """FlowMatchEulerDiscreteScheduler knobs (scheduler_config.json)."""

    shift: float = 3.0
    use_dynamic_shifting: bool = True
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


@dataclass
class FluxPipelineConfig:
    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    t5: T5EncoderConfig = field(default_factory=T5EncoderConfig)
    transformer: FluxTransformerConfig = field(default_factory=FluxTransformerConfig)
    vae: VAEConfig = field(default_factory=lambda: VAEConfig(
        latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159))
    sched: FluxSchedulerConfig = field(default_factory=FluxSchedulerConfig)
    t5_max_length: int = 512  # dev; schnell ships 256


# --------------------------------------------------------------------------- #
# T5 encoder
# --------------------------------------------------------------------------- #


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _t5_bucket(rel_pos: torch.Tensor, num_buckets: int, max_dist: int) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing (HF semantics)."""
    nb = num_buckets // 2
    buckets = (rel_pos > 0).long() * nb
    n = rel_pos.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                         / math.log(max_dist / max_exact) * (nb - max_exact)).long()
    large = large.clamp(max=nb - 1)
    return buckets + torch.where(n < max_exact, n, large)


def t5_encode(cfg: T5EncoderConfig, p: Params, ids: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [B, T] (pad 0) → hidden [B, T, d_model]: RMS pre-norms, unscaled
    logits, one relative-position bias table (block 0) shared by every layer."""
    h = p["shared.weight"][ids.long()]
    B, T, _ = h.shape
    H, Dk = cfg.num_heads, cfg.d_kv
    pos = torch.arange(T, device=h.device)
    bucket = _t5_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets, cfg.rel_max_distance)
    table = p["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    bias = table[bucket].permute(2, 0, 1)[None].float()  # [1, H, T, T]
    if mask is not None:
        bias = bias + (1.0 - mask[:, None, None, :].float()) * -1e9

    def heads(x):
        return x.reshape(B, T, H, Dk).transpose(1, 2)

    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        x = _rms_norm(h, p[f"{pre}.0.layer_norm.weight"], cfg.eps)
        q, k, v = (heads(_linear(x, p, f"{pre}.0.SelfAttention.{c}")) for c in "qkv")
        a = attention(q, k, v, bias=bias, scale=1.0).transpose(1, 2).reshape(B, T, H * Dk)
        h = h + _linear(a, p, f"{pre}.0.SelfAttention.o")
        x = _rms_norm(h, p[f"{pre}.1.layer_norm.weight"], cfg.eps)
        if cfg.gated_ff:
            y = F.gelu(_linear(x, p, f"{pre}.1.DenseReluDense.wi_0"),
                       approximate="tanh" if cfg.gelu_tanh else "none")
            y = y * _linear(x, p, f"{pre}.1.DenseReluDense.wi_1")
        else:
            y = F.relu(_linear(x, p, f"{pre}.1.DenseReluDense.wi"))
        h = h + _linear(y, p, f"{pre}.1.DenseReluDense.wo")
    return _rms_norm(h, p["encoder.final_layer_norm.weight"], cfg.eps)


# --------------------------------------------------------------------------- #
# Rotary embedding over (frame, row, col) ids
# --------------------------------------------------------------------------- #


def rope_cos_sin(ids: torch.Tensor, axes_dims: tuple, theta: float):
    """ids [N, 3] → (cos, sin) [N, D/2], D = sum(axes_dims): per-axis
    frequency ladders concatenated (diffusers FluxPosEmbed)."""
    cs, ss = [], []
    for a, d in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=ids.device)
                                 / d))
        ang = ids[:, a].float()[:, None] * freqs[None, :]
        cs.append(torch.cos(ang))
        ss.append(torch.sin(ang))
    return torch.cat(cs, dim=-1), torch.cat(ss, dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D] with interleaved pairs: the complex rotation of
    diffusers apply_rotary_emb (computed in f32 tables, cast back)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------- #
# MMDiT transformer
# --------------------------------------------------------------------------- #


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, f32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _qkv_heads(x: torch.Tensor, p: Params, pre: str, names: tuple, heads: int,
               norm_names: tuple, eps: float = 1e-6) -> list:
    """Per-head q / k / v with Flux's RMS q / k norms."""
    B, N, _ = x.shape
    out = []
    for name, nname in zip(names, norm_names):
        y = _linear(x, p, f"{pre}.{name}").reshape(B, N, heads, -1).transpose(1, 2)
        if nname is not None:
            y = _rms_norm(y, p[f"{pre}.{nname}.weight"], eps)
        out.append(y)
    return out


def _joint_attention(q, k, v) -> torch.Tensor:
    """[B, H, N, D] x 3 → [B, N, H·D]; f32 softmax."""
    B, H, N, D = q.shape
    return attention(q, k, v).transpose(1, 2).reshape(B, N, H * D)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def flux_forward(cfg: FluxTransformerConfig, p: Params, img_tokens: torch.Tensor,
                 txt_hidden: torch.Tensor, pooled: torch.Tensor, timestep: torch.Tensor,
                 img_ids: torch.Tensor, txt_ids: Optional[torch.Tensor] = None,
                 guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FluxTransformer2DModel: img_tokens [B, L, in_ch] (packed latents),
    txt_hidden [B, T, 4096], pooled [B, 768], timestep [B] in [0, 1],
    img_ids [L, 3] → velocity [B, L, in_ch] in the weights' dtype."""
    H = cfg.num_attention_heads
    dt = _dtype(p)
    T = txt_hidden.shape[1]
    h = _linear(img_tokens.to(dt), p, "x_embedder")
    ctx = _linear(txt_hidden.to(dt), p, "context_embedder")
    pre = "time_text_embed"
    temb = get_timestep_embedding(timestep.float() * 1000.0, 256).to(dt)
    temb = _linear(F.silu(_linear(temb, p, f"{pre}.timestep_embedder.linear_1")), p,
                   f"{pre}.timestep_embedder.linear_2")
    if cfg.guidance_embeds:
        g = get_timestep_embedding(guidance.float() * 1000.0, 256).to(dt)
        temb = temb + _linear(F.silu(_linear(g, p, f"{pre}.guidance_embedder.linear_1")), p,
                              f"{pre}.guidance_embedder.linear_2")
    pe = _linear(F.silu(_linear(pooled.to(dt), p, f"{pre}.text_embedder.linear_1")), p,
                 f"{pre}.text_embedder.linear_2")
    semb = F.silu(temb + pe)
    if txt_ids is None:
        txt_ids = torch.zeros((T, 3), dtype=torch.float32, device=h.device)
    cos, sin = rope_cos_sin(torch.cat([txt_ids.float(), img_ids.float()]), cfg.axes_dims_rope,
                            cfg.rope_theta)
    cos, sin = cos[None, None], sin[None, None]

    def mod(x, shift, scale):
        return _ln(x) * (1 + scale[:, None]) + shift[:, None]

    for i in range(cfg.num_layers):  # double-stream blocks
        pre = f"transformer_blocks.{i}"
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = _linear(semb, p, f"{pre}.norm1.linear").chunk(6, -1)
        csh_a, csc_a, cg_a, csh_m, csc_m, cg_m = _linear(
            semb, p, f"{pre}.norm1_context.linear").chunk(6, -1)
        q, k, v = _qkv_heads(mod(h, sh_a, sc_a), p, f"{pre}.attn", ("to_q", "to_k", "to_v"),
                             H, ("norm_q", "norm_k", None))
        cq, ck, cv = _qkv_heads(mod(ctx, csh_a, csc_a), p, f"{pre}.attn",
                                ("add_q_proj", "add_k_proj", "add_v_proj"), H,
                                ("norm_added_q", "norm_added_k", None))
        # text first, then image (diffusers FluxAttnProcessor order)
        attn = _joint_attention(_apply_rope(torch.cat([cq, q], 2), cos, sin),
                                _apply_rope(torch.cat([ck, k], 2), cos, sin),
                                torch.cat([cv, v], 2))
        a_ctx, a_img = attn[:, :T], attn[:, T:]
        h = h + g_a[:, None] * _linear(a_img, p, f"{pre}.attn.to_out.0")
        ff = _linear(_gelu_tanh(_linear(mod(h, sh_m, sc_m), p, f"{pre}.ff.net.0.proj")), p,
                     f"{pre}.ff.net.2")
        h = h + g_m[:, None] * ff
        ctx = ctx + cg_a[:, None] * _linear(a_ctx, p, f"{pre}.attn.to_add_out")
        cff = _linear(_gelu_tanh(_linear(mod(ctx, csh_m, csc_m), p,
                                          f"{pre}.ff_context.net.0.proj")),
                      p, f"{pre}.ff_context.net.2")
        ctx = ctx + cg_m[:, None] * cff
    x = torch.cat([ctx, h], dim=1)
    for i in range(cfg.num_single_layers):  # single-stream: parallel attention + MLP
        pre = f"single_transformer_blocks.{i}"
        sh, sc, gate = _linear(semb, p, f"{pre}.norm.linear").chunk(3, -1)
        nx = mod(x, sh, sc)
        q, k, v = _qkv_heads(nx, p, f"{pre}.attn", ("to_q", "to_k", "to_v"), H,
                             ("norm_q", "norm_k", None))
        attn = _joint_attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v)
        mlp = _gelu_tanh(_linear(nx, p, f"{pre}.proj_mlp"))
        x = x + gate[:, None] * _linear(torch.cat([attn, mlp], dim=-1), p, f"{pre}.proj_out")
    sc, sh = _linear(semb, p, "norm_out.linear").chunk(2, -1)  # (scale, shift) order
    return _linear(mod(x[:, T:], sh, sc), p, "proj_out")


# --------------------------------------------------------------------------- #
# Latent packing + flow-matching schedule
# --------------------------------------------------------------------------- #


def pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] → [B, (h/2)(w/2), 4C], features (c, dh, dw)
    (FluxPipeline._pack_latents)."""
    B, C, Hh, Ww = lat.shape
    x = lat.reshape(B, C, Hh // 2, 2, Ww // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (Hh // 2) * (Ww // 2), C * 4)


def unpack_latents(tokens: torch.Tensor, lat_h: int, lat_w: int) -> torch.Tensor:
    """[B, L, 4C] → [B, C, lat_h, lat_w]."""
    B, L, Fd = tokens.shape
    C = Fd // 4
    x = tokens.reshape(B, lat_h // 2, lat_w // 2, C, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, C, lat_h, lat_w)


def image_ids(lat_h: int, lat_w: int) -> np.ndarray:
    """[L, 3] (0, row, col) position ids of the packed latent grid."""
    ids = np.zeros((lat_h // 2, lat_w // 2, 3), np.float32)
    ids[..., 1] = np.arange(lat_h // 2)[:, None]
    ids[..., 2] = np.arange(lat_w // 2)[None, :]
    return ids.reshape(-1, 3)


def flow_sigmas(sched: FluxSchedulerConfig, steps: int, image_seq_len: int) -> np.ndarray:
    """[steps + 1] descending sigmas (terminal 0): the dynamic time shift by
    image sequence length (dev) or the static `shift` (schnell)."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    if sched.use_dynamic_shifting:
        m = (sched.max_shift - sched.base_shift) / (
            sched.max_image_seq_len - sched.base_image_seq_len)
        b = sched.base_shift - m * sched.base_image_seq_len
        mu = image_seq_len * m + b
        sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = sched.shift * sigmas / (1.0 + (sched.shift - 1.0) * sigmas)
    return np.append(sigmas, 0.0).astype(np.float32)


def encode_prompt(cfg: FluxPipelineConfig, params: dict, clip_ids: torch.Tensor,
                  t5_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T5 states [B, T, 4096], CLIP pooled [B, 768])."""
    _, fin = clip_hidden_states(cfg.clip, params["clip"], clip_ids)
    pooled = clip_pooled_projection(cfg.clip, params["clip"], clip_ids, fin)
    return t5_encode(cfg.t5, params["t5"], t5_ids), pooled


def generate(cfg: FluxPipelineConfig, params: dict, clip_ids: torch.Tensor,
             t5_ids: torch.Tensor, steps: int = 20, guidance: float = 3.5,
             height: int = 1024, width: int = 1024,
             init_image: Optional[torch.Tensor] = None, strength: float = 0.8,
             init_noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flux text → image; returns [B, 3, H, W] f32 in [0, 1]. init_noise
    [B, C_lat, h, w] is the unit-normal start (else drawn from generator);
    init_image [B, 3, H, W] makes it img2img (the re-noised source at the
    schedule's `strength` entry)."""
    B = clip_ids.shape[0]
    device = clip_ids.device
    vs = cfg.vae.spatial_scale
    lat_h, lat_w = height // vs, width // vs
    L = (lat_h // 2) * (lat_w // 2)
    txt, pooled = encode_prompt(cfg, params, clip_ids, t5_ids)
    img_ids = torch.from_numpy(image_ids(lat_h, lat_w)).to(device)
    txt_ids = torch.zeros((t5_ids.shape[1], 3), dtype=torch.float32, device=device)
    sigmas = [float(s) for s in flow_sigmas(cfg.sched, steps, L)]
    if init_noise is None:
        gen = generator or torch.Generator(device=device).manual_seed(0)
        init_noise = torch.randn((B, cfg.vae.latent_channels, lat_h, lat_w), generator=gen,
                                 device=device)
    x = pack_latents(init_noise.float())
    i0 = 0
    if init_image is not None:
        i0 = steps - max(1, min(steps, int(round(steps * strength))))
        lat0 = vae_encode(cfg.vae, params["vae"], init_image)
        lat0 = lat0 - cfg.vae.shift_factor * cfg.vae.scaling_factor  # (mean - shift) * scale
        x = (1.0 - sigmas[i0]) * pack_latents(lat0) + sigmas[i0] * x
    gvec = (torch.full((B,), float(guidance), device=device)
            if cfg.transformer.guidance_embeds else None)
    for i in range(i0, steps):
        t = torch.full((B,), sigmas[i], dtype=torch.float32, device=device)
        v = flux_forward(cfg.transformer, params["transformer"], x, txt, pooled, t, img_ids,
                         txt_ids, gvec)
        x = x + (sigmas[i + 1] - sigmas[i]) * v.float()
    lat = unpack_latents(x, lat_h, lat_w) / cfg.vae.scaling_factor + cfg.vae.shift_factor
    return vae_decode(cfg.vae, params["vae"], lat)


# --------------------------------------------------------------------------- #
# Checkpoint loading and writing (diffusers FluxPipeline layout)
# --------------------------------------------------------------------------- #


def is_flux_dir(path: str) -> bool:
    idx = os.path.join(path, "model_index.json")
    if not os.path.isfile(idx):
        return False
    try:
        with open(idx) as f:
            return "flux" in str(json.load(f).get("_class_name", "")).lower()
    except (OSError, ValueError):
        return False


def _cfg_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config_from_dir(ckpt_dir: str) -> FluxPipelineConfig:
    tc = _cfg_json(os.path.join(ckpt_dir, "text_encoder", "config.json"))
    t5c = _cfg_json(os.path.join(ckpt_dir, "text_encoder_2", "config.json"))
    xc = _cfg_json(os.path.join(ckpt_dir, "transformer", "config.json"))
    vc = _cfg_json(os.path.join(ckpt_dir, "vae", "config.json"))
    sp = os.path.join(ckpt_dir, "scheduler", "scheduler_config.json")
    sc = _cfg_json(sp) if os.path.isfile(sp) else {}
    ff_proj = t5c.get("feed_forward_proj", "gated-gelu")
    cfg = FluxPipelineConfig(
        clip=CLIPTextConfig(
            vocab_size=tc.get("vocab_size", 49408), hidden_size=tc.get("hidden_size", 768),
            intermediate_size=tc.get("intermediate_size", 3072),
            num_hidden_layers=tc.get("num_hidden_layers", 12),
            num_attention_heads=tc.get("num_attention_heads", 12),
            max_position_embeddings=tc.get("max_position_embeddings", 77),
            hidden_act=tc.get("hidden_act", "quick_gelu"),
            eos_token_id=tc.get("eos_token_id", 49407)),
        t5=T5EncoderConfig(
            vocab_size=t5c.get("vocab_size", 32128), d_model=t5c.get("d_model", 4096),
            d_kv=t5c.get("d_kv", 64), d_ff=t5c.get("d_ff", 10240),
            num_layers=t5c.get("num_layers", 24), num_heads=t5c.get("num_heads", 64),
            rel_buckets=t5c.get("relative_attention_num_buckets", 32),
            rel_max_distance=t5c.get("relative_attention_max_distance", 128),
            gated_ff="gated" in ff_proj, gelu_tanh="gelu" in ff_proj,
            eps=t5c.get("layer_norm_epsilon", 1e-6)),
        transformer=FluxTransformerConfig(
            in_channels=xc.get("in_channels", 64), num_layers=xc.get("num_layers", 19),
            num_single_layers=xc.get("num_single_layers", 38),
            attention_head_dim=xc.get("attention_head_dim", 128),
            num_attention_heads=xc.get("num_attention_heads", 24),
            joint_attention_dim=xc.get("joint_attention_dim", 4096),
            pooled_projection_dim=xc.get("pooled_projection_dim", 768),
            guidance_embeds=xc.get("guidance_embeds", True),
            axes_dims_rope=tuple(xc.get("axes_dims_rope", (16, 56, 56)))),
        vae=VAEConfig(
            in_channels=vc.get("in_channels", 3), out_channels=vc.get("out_channels", 3),
            latent_channels=vc.get("latent_channels", 16),
            block_out_channels=tuple(vc.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=vc.get("layers_per_block", 2),
            norm_num_groups=vc.get("norm_num_groups", 32),
            scaling_factor=vc.get("scaling_factor", 0.3611),
            shift_factor=vc.get("shift_factor", 0.1159) or 0.0),
        sched=FluxSchedulerConfig(
            shift=sc.get("shift", 3.0),
            use_dynamic_shifting=sc.get("use_dynamic_shifting", True),
            base_shift=sc.get("base_shift", 0.5), max_shift=sc.get("max_shift", 1.15),
            base_image_seq_len=sc.get("base_image_seq_len", 256),
            max_image_seq_len=sc.get("max_image_seq_len", 4096)),
    )
    t5_max = 512
    tk2 = os.path.join(ckpt_dir, "tokenizer_2", "tokenizer_config.json")
    if os.path.isfile(tk2):
        t5_max = int(_cfg_json(tk2).get("model_max_length", 512) or 512)
    cfg.t5_max_length = min(t5_max, 512)
    return cfg


def load_flux_pipeline(ckpt_dir: str, dtype: torch.dtype = torch.bfloat16, device=None):
    """(FluxPipelineConfig, params, (clip_tokenizer, t5_tokenizer)); bf16 by
    default, as the JAX loader (Flux.1-dev in f32 is ~68 GB)."""
    from transformers import AutoTokenizer

    device = resolve_device(device)
    cfg = config_from_dir(ckpt_dir)
    params = {part: load_safetensors_dir(os.path.join(ckpt_dir, sub), dtype, device)
              for part, sub in (("clip", "text_encoder"), ("t5", "text_encoder_2"),
                                ("transformer", "transformer"), ("vae", "vae"))}
    tok = AutoTokenizer.from_pretrained(os.path.join(ckpt_dir, "tokenizer"),
                                        local_files_only=True)
    tok2 = AutoTokenizer.from_pretrained(os.path.join(ckpt_dir, "tokenizer_2"),
                                         local_files_only=True)
    return cfg, params, (tok, tok2)


def transformer_shapes(cfg: FluxTransformerConfig) -> dict[str, tuple]:
    """Every tensor of a FluxTransformer2DModel at cfg."""
    g = _Shapes()
    D, hd = cfg.inner_dim, cfg.attention_head_dim
    g.lin("x_embedder", cfg.in_channels, D)
    g.lin("context_embedder", cfg.joint_attention_dim, D)
    pre = "time_text_embed"
    embedders = [("timestep_embedder", 256)]
    if cfg.guidance_embeds:
        embedders.append(("guidance_embedder", 256))
    embedders.append(("text_embedder", cfg.pooled_projection_dim))
    for name, n_in in embedders:
        g.lin(f"{pre}.{name}.linear_1", n_in, D)
        g.lin(f"{pre}.{name}.linear_2", D, D)
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}"
        g.lin(f"{pre}.norm1.linear", D, 6 * D)
        g.lin(f"{pre}.norm1_context.linear", D, 6 * D)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            g.lin(f"{pre}.attn.{nm}", D, D)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            g.s[f"{pre}.attn.{nm}.weight"] = (hd,)
        g.lin(f"{pre}.attn.to_out.0", D, D)
        g.lin(f"{pre}.attn.to_add_out", D, D)
        for ff in ("ff", "ff_context"):
            g.lin(f"{pre}.{ff}.net.0.proj", D, 4 * D)
            g.lin(f"{pre}.{ff}.net.2", 4 * D, D)
    for i in range(cfg.num_single_layers):
        pre = f"single_transformer_blocks.{i}"
        g.lin(f"{pre}.norm.linear", D, 3 * D)
        for nm in ("to_q", "to_k", "to_v"):
            g.lin(f"{pre}.attn.{nm}", D, D)
        g.s[f"{pre}.attn.norm_q.weight"] = g.s[f"{pre}.attn.norm_k.weight"] = (hd,)
        g.lin(f"{pre}.proj_mlp", D, 4 * D)
        g.lin(f"{pre}.proj_out", 5 * D, D)
    g.lin("norm_out.linear", D, 2 * D)
    g.lin("proj_out", D, cfg.in_channels)
    return g.s


def t5_shapes(cfg: T5EncoderConfig) -> dict[str, tuple]:
    """Every tensor of an HF T5EncoderModel at cfg."""
    g = _Shapes()
    D, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
    g.s["shared.weight"] = (cfg.vocab_size, D)
    g.s["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        cfg.rel_buckets, cfg.num_heads)
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        g.s[f"{pre}.0.layer_norm.weight"] = (D,)
        for c in "qkv":
            g.lin(f"{pre}.0.SelfAttention.{c}", D, inner, bias=False)
        g.lin(f"{pre}.0.SelfAttention.o", inner, D, bias=False)
        g.s[f"{pre}.1.layer_norm.weight"] = (D,)
        for wi in (("wi_0", "wi_1") if cfg.gated_ff else ("wi",)):
            g.lin(f"{pre}.1.DenseReluDense.{wi}", D, cfg.d_ff, bias=False)
        g.lin(f"{pre}.1.DenseReluDense.wo", cfg.d_ff, D, bias=False)
    g.s["encoder.final_layer_norm.weight"] = (D,)
    return g.s


def init_transformer(cfg: FluxTransformerConfig, seed: int = 0,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> Params:
    """A seeded random transformer drawn on the device (random_tensor's
    scales), the checkpoint writer's tensors without a file."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {n: random_tensor(n, s, gen, device).to(dtype)
            for n, s in transformer_shapes(cfg).items()}


def init_params(cfg: FluxPipelineConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device=None) -> dict:
    """Every part of a pipeline drawn on the device (no file)."""
    device = resolve_device(device)
    out = {"transformer": init_transformer(cfg.transformer, seed, dtype, device)}
    for i, (part, shapes) in enumerate((("clip", clip_shapes(cfg.clip)),
                                        ("t5", t5_shapes(cfg.t5)),
                                        ("vae", vae_shapes(cfg.vae, quant_convs=False)))):
        gen = torch.Generator(device=device).manual_seed(seed + 1 + i)
        out[part] = {n: random_tensor(n, s, gen, device).to(dtype) for n, s in shapes.items()}
    return out


def save_flux(cfg: FluxPipelineConfig, ckpt_dir: str, seed: int = 0,
              dtype: torch.dtype = torch.float32, device=None) -> FluxPipelineConfig:
    """A FluxPipeline-layout checkpoint of seeded random weights at cfg:
    model_index.json (FluxPipeline), text_encoder/ (CLIP), text_encoder_2/
    (T5), transformer/, vae/ (no quant convs), scheduler/ and both
    tokenizers (write_bpe_tokenizer's; the T5 one pads with id 0). Returns
    cfg with the CLIP eos id written."""
    import dataclasses

    device = resolve_device(device)
    ids = write_bpe_tokenizer(os.path.join(ckpt_dir, "tokenizer"),
                              vocab=min(1000, cfg.clip.vocab_size))
    cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, eos_token_id=ids["<|endoftext|>"]))
    write_bpe_tokenizer(os.path.join(ckpt_dir, "tokenizer_2"),
                        vocab=min(1000, cfg.t5.vocab_size), max_len=cfg.t5_max_length,
                        specials=("<pad>", "</s>", "<unk>"), pad="<pad>", wrap=False)
    t5 = cfg.t5
    parts = [
        ("text_encoder", "model.safetensors", clip_shapes(cfg.clip), clip_config_doc(cfg.clip)),
        ("text_encoder_2", "model.safetensors", t5_shapes(t5), {
            "architectures": ["T5EncoderModel"], "model_type": "t5",
            "vocab_size": t5.vocab_size, "d_model": t5.d_model, "d_kv": t5.d_kv,
            "d_ff": t5.d_ff, "num_layers": t5.num_layers, "num_heads": t5.num_heads,
            "relative_attention_num_buckets": t5.rel_buckets,
            "relative_attention_max_distance": t5.rel_max_distance,
            "feed_forward_proj": ("gated-" if t5.gated_ff else "")
            + ("gelu" if t5.gelu_tanh else "relu"),
            "layer_norm_epsilon": t5.eps}),
        ("transformer", "diffusion_pytorch_model.safetensors",
         transformer_shapes(cfg.transformer), {
             "_class_name": "FluxTransformer2DModel", **{
                 k: getattr(cfg.transformer, k) for k in (
                     "in_channels", "num_layers", "num_single_layers", "attention_head_dim",
                     "num_attention_heads", "joint_attention_dim", "pooled_projection_dim",
                     "guidance_embeds")},
             "axes_dims_rope": list(cfg.transformer.axes_dims_rope)}),
        ("vae", "diffusion_pytorch_model.safetensors", vae_shapes(cfg.vae, quant_convs=False), {
            "_class_name": "AutoencoderKL", "latent_channels": cfg.vae.latent_channels,
            "block_out_channels": list(cfg.vae.block_out_channels),
            "layers_per_block": cfg.vae.layers_per_block,
            "norm_num_groups": cfg.vae.norm_num_groups,
            "scaling_factor": cfg.vae.scaling_factor, "shift_factor": cfg.vae.shift_factor}),
    ]
    for i, (sub, fname, shapes, doc) in enumerate(parts):
        write_random(os.path.join(ckpt_dir, sub, fname), shapes, seed + i, dtype, device)
        _write_json(os.path.join(ckpt_dir, sub, "config.json"), doc)
    s = cfg.sched
    _write_json(os.path.join(ckpt_dir, "scheduler", "scheduler_config.json"), {
        "_class_name": "FlowMatchEulerDiscreteScheduler", "shift": s.shift,
        "use_dynamic_shifting": s.use_dynamic_shifting, "base_shift": s.base_shift,
        "max_shift": s.max_shift, "base_image_seq_len": s.base_image_seq_len,
        "max_image_seq_len": s.max_image_seq_len})
    _write_json(os.path.join(ckpt_dir, "model_index.json"), {"_class_name": "FluxPipeline"})
    return cfg
