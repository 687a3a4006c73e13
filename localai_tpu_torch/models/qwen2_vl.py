"""Qwen2-VL in PyTorch (localai_tpu/models/qwen2_vl.py): the native-
resolution vision tower and the m-rope position streams of its decoder.

- `preprocess`: the HF processor's `smart_resize` into the pixel budget
  at multiples of patch · merge (28), a bicubic resize by `F.interpolate`
  with antialias on the CPU rounded to uint8 as PIL's (the JAX package
  resizes in PIL), CLIP normalisation, the temporal duplicate of a still
  image, and the processor's flatten order: the 2x2 merge groups are
  contiguous in the patch sequence, features ordered (C, tps, ph, pw).
- `vision_forward`: the patch embed (conv3d as a matmul over the
  flattened patch), pre-LN blocks with 2-axis rotary positions
  (`_vision_rope_angles`), QuickGELU MLPs, and the 2x2 patch merger into
  the LLM's width. The trunk runs in the weights' dtype; every
  promotion the JAX package leaves implicit is written out here: the patch
  embed's product in f32, then cast; LayerNorm in f32 times its weights in
  f32, then cast; scores in f32, probabilities cast to v's dtype.
  Attention is plain PyTorch (matmul, softmax over f32 scores): non-causal
  at head dim 80, which B1 does not take.
- `mrope_positions_for_span`: HF get_rope_index's (t, h, w) streams for a
  prompt with one image span, and the rope delta that makes decode
  positions row + delta.
- `load_hf_qwen2_vl_vision` (the stored dtype kept), its carry-over of the
  JAX package's tree `qwen2_vl_vision_params_from_numpy`, and
  `Qwen2VLVisionEncoder`, which preprocesses on the CPU and runs the tower
  on its params' device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.vision import resize_uint8
from localai_tpu_torch.ops.rope import rope_rotate

Params = dict[str, Any]

# CLIP normalisation constants (Qwen2VLImageProcessor defaults)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: int = 4
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    hidden_size: int = 3584  # LLM dim (merger output)
    # processor pixel budget (Qwen2VLImageProcessor defaults)
    min_pixels: int = 56 * 56
    max_pixels: int = 28 * 28 * 1280

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size ** 2


def vision_config_from_hf(ckpt_dir: str) -> Qwen2VLVisionConfig:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    vc = hf.get("vision_config") or {}
    return Qwen2VLVisionConfig(
        depth=vc.get("depth", 32),
        embed_dim=vc.get("embed_dim", 1280),
        num_heads=vc.get("num_heads", 16),
        mlp_ratio=vc.get("mlp_ratio", 4),
        in_channels=vc.get("in_channels", 3),
        patch_size=vc.get("patch_size", 14),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        temporal_patch_size=vc.get("temporal_patch_size", 2),
        hidden_size=vc.get("hidden_size", hf.get("hidden_size", 3584)),
    )


def is_qwen2_vl_dir(ckpt_dir: str) -> bool:
    cfg = os.path.join(ckpt_dir, "config.json")
    if not os.path.isfile(cfg):
        return False
    try:
        with open(cfg) as f:
            return json.load(f).get("model_type") == "qwen2_vl"
    except (OSError, ValueError):
        return False


# --------------------------------------------------------------------------- #
# Image preprocessing (Qwen2VLImageProcessor semantics)
# --------------------------------------------------------------------------- #


def smart_resize(h: int, w: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 28 * 28 * 1280) -> tuple[int, int]:
    """Round to multiples of `factor` keeping the pixel count inside the
    budget (HF qwen2_vl image_processing smart_resize)."""
    if max(h, w) / max(min(h, w), 1) > 200:
        raise ValueError("absurd aspect ratio")
    hbar = max(factor, round(h / factor) * factor)
    wbar = max(factor, round(w / factor) * factor)
    if hbar * wbar > max_pixels:
        beta = math.sqrt((h * w) / max_pixels)
        hbar = max(factor, math.floor(h / beta / factor) * factor)
        wbar = max(factor, math.floor(w / beta / factor) * factor)
    elif hbar * wbar < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        hbar = math.ceil(h * beta / factor) * factor
        wbar = math.ceil(w * beta / factor) * factor
    return hbar, wbar


def preprocess(cfg: Qwen2VLVisionConfig, image: np.ndarray) -> tuple[np.ndarray, tuple]:
    """uint8 [H, W, 3] → (patches [n, patch_dim] f32, grid (t, gh, gw)), in
    the processor's flatten order."""
    p, m, tps = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    image = np.asarray(image, np.uint8)
    rh, rw = smart_resize(*image.shape[:2], p * m, cfg.min_pixels, cfg.max_pixels)
    img = resize_uint8(image, rh, rw, "bicubic").astype(np.float32) / 255.0
    img = (img - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(IMAGE_STD, np.float32)
    arr = img.transpose(2, 0, 1)[None]  # [1, C, H, W]
    arr = np.tile(arr, (tps, 1, 1, 1))  # temporal duplicate for still images
    gt, gh, gw = 1, rh // p, rw // p
    patches = arr.reshape(gt, tps, cfg.in_channels, gh // m, m, p, gw // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (patches.reshape(gt * gh * gw, cfg.patch_dim).astype(np.float32),
            (gt, gh, gw))


# --------------------------------------------------------------------------- #
# Vision tower forward
# --------------------------------------------------------------------------- #


def _vision_rope_angles(cfg: Qwen2VLVisionConfig, grid: tuple,
                        theta: float = 10000.0) -> np.ndarray:
    """[n_patches, head_dim/2] rotation angles: per-patch (row, col) ids in
    the merge-group order, each driving half the frequency ladder
    (Qwen2VisionTransformer rot_pos_emb + VisionRotaryEmbedding)."""
    t, gh, gw = grid
    m = cfg.spatial_merge_size
    hpos = np.broadcast_to(np.arange(gh)[:, None], (gh, gw))
    wpos = np.broadcast_to(np.arange(gw)[None, :], (gh, gw))

    def reorder(x):
        return x.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = reorder(hpos), reorder(wpos)
    dim = cfg.head_dim // 2  # rope dim per spatial axis pair
    inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    ang = np.concatenate([hpos[:, None] * inv[None, :], wpos[:, None] * inv[None, :]], axis=-1)
    return np.tile(ang, (t, 1)).astype(np.float32)


def vision_forward(cfg: Qwen2VLVisionConfig, p: Params, patches: torch.Tensor,
                   angles: torch.Tensor) -> torch.Tensor:
    """patches [N, patch_dim] f32, angles [N, head_dim/2] f32 → merged
    tokens [N / merge², hidden_size] in the weights' dtype."""
    N = patches.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    w0 = p["patch_embed.weight"]
    dt = w0.dtype
    # conv3d == a matmul over the flattened patch, in f32, cast to the
    # weights' dtype: the trunk's matmuls run in it (norms, softmax in f32).
    h = (patches.float() @ w0.float()).to(dt)

    def ln(x: torch.Tensor, pre: str) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        return (y * p[f"{pre}.weight"].float() + p[f"{pre}.bias"].float()).to(dt)

    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        x = ln(h, f"{pre}.norm1")
        qkv = (x @ p[f"{pre}.attn.qkv.weight"] + p[f"{pre}.attn.qkv.bias"]).reshape(N, 3, H, Dh)
        q = rope_rotate(qkv[:, 0], angles)  # [N, H, Dh]
        k = rope_rotate(qkv[:, 1], angles)
        v = qkv[:, 2]
        scores = torch.einsum("qhd,khd->hqk", q, k).float() / math.sqrt(Dh)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        attn = torch.einsum("hqk,khd->qhd", probs, v).reshape(N, -1)
        del probs
        h = h + attn @ p[f"{pre}.attn.proj.weight"] + p[f"{pre}.attn.proj.bias"]
        x = ln(h, f"{pre}.norm2")
        y = x @ p[f"{pre}.mlp.fc1.weight"] + p[f"{pre}.mlp.fc1.bias"]
        y = y * torch.sigmoid(1.702 * y)  # QuickGELU
        h = h + y @ p[f"{pre}.mlp.fc2.weight"] + p[f"{pre}.mlp.fc2.bias"]

    # PatchMerger: ln_q per token, then 2x2 groups (contiguous in patch
    # order) concatenate and pass through a 2-layer MLP into the LLM width.
    x = ln(h, "merger.ln_q").reshape(-1, cfg.merge_dim)
    x = F.gelu(x @ p["merger.mlp.0.weight"] + p["merger.mlp.0.bias"])
    return x @ p["merger.mlp.2.weight"] + p["merger.mlp.2.bias"]


# --------------------------------------------------------------------------- #
# M-RoPE position ids (HF Qwen2VLForConditionalGeneration.get_rope_index)
# --------------------------------------------------------------------------- #


def mrope_positions_for_span(total_len: int, offset: int, grid: tuple,
                             merge: int = 2) -> tuple[np.ndarray, int]:
    """3D (t, h, w) position streams for a prompt whose [offset,
    offset + span) token range holds one image's merged patches.

    Text tokens advance all three streams together; image tokens freeze t
    at the preceding text position and spread (h, w) over the merged grid;
    text after the image resumes at max_position + 1. Returns (pos3
    [3, total_len] int32, rope_delta) with rope_delta = (max_pos + 1) -
    total_len, the constant that makes decode positions row_index + delta
    (HF's mrope_position_deltas)."""
    t, gh, gw = grid
    mh, mw = gh // merge, gw // merge
    span = t * mh * mw
    pos3 = np.zeros((3, total_len), np.int64)
    pos3[:, :offset] = np.arange(offset)[None, :]  # text before the image
    st = offset
    tt = np.repeat(np.arange(t), mh * mw)
    hh = np.tile(np.repeat(np.arange(mh), mw), t)
    ww = np.tile(np.tile(np.arange(mw), mh), t)
    pos3[0, offset: offset + span] = st + tt
    pos3[1, offset: offset + span] = st + hh
    pos3[2, offset: offset + span] = st + ww
    nxt = st + int(max(t, mh, mw))  # max position inside the span + 1
    n_after = total_len - offset - span
    if n_after > 0:
        pos3[:, offset + span:] = nxt + np.arange(n_after)[None, :]
        max_pos = nxt + n_after - 1
    else:
        max_pos = nxt - 1
    return pos3.astype(np.int32), int(max_pos + 1 - total_len)


# --------------------------------------------------------------------------- #
# Checkpoint loading + encoder wrapper
# --------------------------------------------------------------------------- #


def _vision_names(cfg: Qwen2VLVisionConfig) -> list[str]:
    names = ["merger.ln_q.weight", "merger.ln_q.bias",
             "merger.mlp.0.weight", "merger.mlp.0.bias",
             "merger.mlp.2.weight", "merger.mlp.2.bias"]
    for i in range(cfg.depth):
        for nm in ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                   "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
                   "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"):
            names.append(f"blocks.{i}.{nm}")
    return names


def load_hf_qwen2_vl_vision(cfg: Qwen2VLVisionConfig, ckpt_dir: str, device=None) -> Params:
    """visual.* tensors → a flat dict on `device` in the stored dtype, with
    linears transposed to [in, out] and the conv3d patch embed flattened
    to a [patch_dim, embed_dim] matmul. The shard reader aliases
    model.visual.* to visual.*, so the published and the nested
    transformers layouts both load."""
    from localai_tpu_torch.engine.weights import _ShardReader

    device = resolve_device(device)
    reader = _ShardReader(ckpt_dir)
    prefix = "visual."
    w = reader.get(prefix + "patch_embed.proj.weight")  # [D, C, tps, p, p]
    out: Params = {"patch_embed.weight": w.reshape(w.shape[0], -1).t().contiguous().to(device)}
    for nm in _vision_names(cfg):
        t = reader.get(prefix + nm)
        if t.dim() == 2 and nm.endswith(".weight"):
            t = t.t()
        out[nm] = t.contiguous().to(device)
    return out


def qwen2_vl_vision_params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's flat tower dict (numpy arrays, or anything
    np.asarray accepts; bf16 leaves as ml_dtypes bfloat16) → the port's
    tensors on `device` in the same dtypes."""
    from localai_tpu_torch.engine.weights import _np_to_tensor

    device = resolve_device(device)
    return {k: _np_to_tensor(np.asarray(v)).to(device) for k, v in tree.items()}


def hf_tensor_shapes(hf: dict) -> dict[str, tuple]:
    """Every tensor of a Qwen2VLForConditionalGeneration checkpoint in the
    published layout (decoder under model.*, tower under visual.*) → its
    shape, from the config.json dict `hf`."""
    D, I, L = hf["hidden_size"], hf["intermediate_size"], hf["num_hidden_layers"]
    H, K = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = D // H
    vc = hf["vision_config"]
    E, tps, pp = vc["embed_dim"], vc["temporal_patch_size"], vc["patch_size"]
    Fm, M = E * vc["mlp_ratio"], E * vc["spatial_merge_size"] ** 2
    shapes: dict[str, tuple] = {"model.embed_tokens.weight": (hf["vocab_size"], D)}
    for i in range(L):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (D,),
            pre + "self_attn.q_proj.weight": (H * hd, D), pre + "self_attn.q_proj.bias": (H * hd,),
            pre + "self_attn.k_proj.weight": (K * hd, D), pre + "self_attn.k_proj.bias": (K * hd,),
            pre + "self_attn.v_proj.weight": (K * hd, D), pre + "self_attn.v_proj.bias": (K * hd,),
            pre + "self_attn.o_proj.weight": (D, H * hd),
            pre + "post_attention_layernorm.weight": (D,),
            pre + "mlp.gate_proj.weight": (I, D), pre + "mlp.up_proj.weight": (I, D),
            pre + "mlp.down_proj.weight": (D, I),
        })
    shapes["model.norm.weight"] = (D,)
    if not hf.get("tie_word_embeddings", False):
        shapes["lm_head.weight"] = (hf["vocab_size"], D)
    shapes["visual.patch_embed.proj.weight"] = (E, vc.get("in_channels", 3), tps, pp, pp)
    for i in range(vc["depth"]):
        pre = f"visual.blocks.{i}."
        shapes.update({
            pre + "norm1.weight": (E,), pre + "norm1.bias": (E,),
            pre + "attn.qkv.weight": (3 * E, E), pre + "attn.qkv.bias": (3 * E,),
            pre + "attn.proj.weight": (E, E), pre + "attn.proj.bias": (E,),
            pre + "norm2.weight": (E,), pre + "norm2.bias": (E,),
            pre + "mlp.fc1.weight": (Fm, E), pre + "mlp.fc1.bias": (Fm,),
            pre + "mlp.fc2.weight": (E, Fm), pre + "mlp.fc2.bias": (E,),
        })
    shapes.update({
        "visual.merger.ln_q.weight": (E,), "visual.merger.ln_q.bias": (E,),
        "visual.merger.mlp.0.weight": (M, M), "visual.merger.mlp.0.bias": (M,),
        "visual.merger.mlp.2.weight": (vc["hidden_size"], M),
        "visual.merger.mlp.2.bias": (vc["hidden_size"],),
    })
    return shapes


def random_hf_checkpoint(ckpt_dir: str, hf: dict, seed: int = 0, scale: float = 0.02,
                         dtype: torch.dtype = torch.float32, device=None) -> None:
    """Write `hf` as config.json and a model.safetensors of seeded random
    tensors (normal · scale; norm weights 1 + normal · scale) in the
    published layout, in `dtype` (f32 or bf16), drawn on `device` and
    written one tensor at a time."""
    from localai_tpu_torch.engine.weights import write_safetensors

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    os.makedirs(ckpt_dir, exist_ok=True)
    shapes = hf_tensor_shapes(hf)

    def draw(name: str) -> torch.Tensor:
        t = torch.randn(shapes[name], generator=gen, device=device) * scale
        if name.endswith(("norm.weight", "norm1.weight", "norm2.weight", "ln_q.weight")):
            t += 1.0
        return t.to(dtype)

    write_safetensors(os.path.join(ckpt_dir, "model.safetensors"), shapes, dtype, draw)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({**hf, "torch_dtype": str(dtype).replace("torch.", "")}, f, indent=1)


class Qwen2VLVisionEncoder:
    """uint8 image → (merged tokens [n, llm_dim] on the params' device, grid)."""

    kind = "qwen2_vl"

    def __init__(self, cfg: Qwen2VLVisionConfig, params: Params):
        self.cfg = cfg
        self.params = params

    @property
    def merge(self) -> int:
        return self.cfg.spatial_merge_size

    @torch.inference_mode()
    def encode_patches(self, patches: np.ndarray, grid: tuple) -> torch.Tensor:
        """The tower on preprocessed patches, on the params' device."""
        dev = self.params["patch_embed.weight"].device
        angles = torch.from_numpy(_vision_rope_angles(self.cfg, grid)).to(dev)
        return vision_forward(self.cfg, self.params, torch.from_numpy(patches).to(dev), angles)

    def encode_with_grid(self, image: np.ndarray) -> tuple[torch.Tensor, tuple]:
        patches, grid = preprocess(self.cfg, image)
        return self.encode_patches(patches, grid), grid
