"""CLIP-style vision tower + llava projector in PyTorch (localai_tpu/models/
vision.py): image features for llava-style VLM chat.

- The JAX package's tree: the patch conv `patch_w` [D, 3, p, p] (HF conv
  layout), `cls`, `pos` [n_patches + 1, D], the pre-LN, stacked [L, ...]
  layer tensors (matmul weights W [in, out]) and the two-layer projector
  into the LLM's width. `vision_params_from_numpy` takes the JAX tree as
  numpy arrays; `init_params` draws from a torch.Generator, so a preset
  tower's weights differ from the JAX package's `jax.random` draw.
- `encode_image`: CLIP normalisation, the patch conv, CLS + positions, the
  pre-LN, pre-LN blocks (LayerNorm in f32, exact-erf GELU), the hidden
  state of `select_layer` (llava: the penultimate layer) without CLS, then
  the projector. Attention is plain PyTorch (matmul, softmax): the JAX
  tower reaches no Pallas kernel, and its attention is non-causal at head
  dims B1 does not take.
- `VisionEncoder.encode` resizes a uint8 image to the tower's square with
  `F.interpolate(mode="bilinear", antialias=True)` on the CPU, rounded to
  uint8 as PIL does (the JAX package resizes in PIL), then runs the tower
  on its params' device and returns the features there.
- HF checkpoints in LlavaForConditionalGeneration's names
  (`vision_tower.vision_model.*`, `multi_modal_projector.linear_{1,2}`):
  `load_hf_vision` / `save_hf_vision` / `vision_config_from_hf`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str = "clip-vit"
    image_size: int = 336
    patch: int = 14
    d_model: int = 1024
    layers: int = 24
    n_heads: int = 16
    ffn: int = 4096
    llm_dim: int = 4096  # projector output = LLM hidden size
    select_layer: int = -2  # llava: penultimate encoder layer
    layer_norm_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


VISION_PRESETS: dict[str, VisionConfig] = {
    "vit-test": VisionConfig(
        name="vit-test", image_size=16, patch=8, d_model=32, layers=2,
        n_heads=2, ffn=64, llm_dim=64, select_layer=-1,
    ),
    "clip-vit-l-336": VisionConfig(name="clip-vit-l-336"),
}


def _specs(cfg: VisionConfig) -> dict:
    """Leaves as (shape, "normal" | "ones" | "zeros"), the JAX tree."""
    D, L, Fi = cfg.d_model, cfg.layers, cfg.ffn
    return {
        "patch_w": ((D, 3, cfg.patch, cfg.patch), "normal"),
        "cls": ((D,), "normal"),
        "pos": ((cfg.n_patches + 1, D), "normal"),
        "pre_ln_w": ((D,), "ones"), "pre_ln_b": ((D,), "zeros"),
        "layers": {
            "ln1_w": ((L, D), "ones"), "ln1_b": ((L, D), "zeros"),
            "q_w": ((L, D, D), "normal"), "q_b": ((L, D), "zeros"),
            "k_w": ((L, D, D), "normal"), "k_b": ((L, D), "zeros"),
            "v_w": ((L, D, D), "normal"), "v_b": ((L, D), "zeros"),
            "o_w": ((L, D, D), "normal"), "o_b": ((L, D), "zeros"),
            "ln2_w": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
            "fc1_w": ((L, D, Fi), "normal"), "fc1_b": ((L, Fi), "zeros"),
            "fc2_w": ((L, Fi, D), "normal"), "fc2_b": ((L, D), "zeros"),
        },
        "proj1_w": ((D, cfg.llm_dim), "normal"), "proj1_b": ((cfg.llm_dim,), "zeros"),
        "proj2_w": ((cfg.llm_dim, cfg.llm_dim), "normal"), "proj2_b": ((cfg.llm_dim,), "zeros"),
    }


def init_params(cfg: VisionConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Params:
    """Random f32 init (normal · scale) with the JAX package's tree, drawn
    from a torch.Generator seeded with `seed` on `device`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=device) * scale
        return (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)

    return {name: ({k: leaf(*v) for k, v in spec.items()} if name == "layers" else leaf(*spec))
            for name, spec in _specs(cfg).items()}


def vision_params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's tower tree (numpy arrays, or anything np.asarray
    accepts) → the port's f32 tensors on `device`."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return conv(tree)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * w + b


def encode_image(cfg: VisionConfig, params: Params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] in [0, 1] → projected patch features
    [B, n_patches, llm_dim] (CLS dropped, llava's default)."""
    B = pixels.shape[0]
    x = (pixels.float() - 0.5) / 0.5  # CLIP-style normalisation
    x = x.permute(0, 3, 1, 2)  # NCHW
    patches = F.conv2d(x, params["patch_w"].float(), stride=cfg.patch)  # [B, D, H/p, W/p]
    h = patches.reshape(B, cfg.d_model, -1).transpose(1, 2)  # [B, N, D]
    cls = params["cls"][None, None].expand(B, 1, cfg.d_model)
    h = torch.cat([cls, h], dim=1) + params["pos"][None]
    h = _ln(h, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)

    H, Dh = cfg.n_heads, cfg.head_dim
    T = h.shape[1]
    # Layers past select_layer feed nothing: they are not run.
    for li in range(cfg.select_layer % cfg.layers + 1):
        lp = {k: v[li] for k, v in params["layers"].items()}
        x = _ln(h, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q = (x @ lp["q_w"] + lp["q_b"]).reshape(B, T, H, Dh)
        k = (x @ lp["k_w"] + lp["k_b"]).reshape(B, T, H, Dh)
        v = (x @ lp["v_w"] + lp["v_b"]).reshape(B, T, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh**-0.5
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, cfg.d_model)
        h = h + attn @ lp["o_w"] + lp["o_b"]
        x = _ln(h, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        h = h + F.gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
    feats = h[:, 1:]  # select_layer's hidden state (llava: the penultimate), CLS dropped
    proj = F.gelu(feats @ params["proj1_w"] + params["proj1_b"])
    return proj @ params["proj2_w"] + params["proj2_b"]  # [B, N, llm_dim]


def resize_uint8(image: np.ndarray, h: int, w: int, mode: str) -> np.ndarray:
    """uint8 [H, W, 3] → uint8 [h, w, 3] by F.interpolate with antialias on
    the CPU (`mode` "bilinear" or "bicubic"), in PIL's order: the width
    pass, then the height pass, each result rounded half up and clipped to
    [0, 255], as PIL's 8-bit resample stores its intermediate image."""
    x = torch.from_numpy(np.array(image, np.uint8)).permute(2, 0, 1)[None].float()
    for size in ((x.shape[2], w), (h, w)):
        if tuple(x.shape[2:]) != size:
            x = F.interpolate(x, size=size, mode=mode, align_corners=False, antialias=True)
            x = torch.floor(x + 0.5).clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).contiguous().numpy()


class VisionEncoder:
    """uint8 image → projected features on the params' device."""

    kind = "llava"

    def __init__(self, cfg: VisionConfig, params: Params):
        self.cfg = cfg
        self.params = params

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] (any size) → [1, s, s, 3] f32 in [0, 1] on the
        CPU, resized to the tower's square when it is not that size."""
        s = self.cfg.image_size
        if image.shape[:2] != (s, s):
            image = resize_uint8(image, s, s, "bilinear")
        return torch.from_numpy(np.asarray(image, np.float32)[None] / 255.0)

    @torch.inference_mode()
    def encode(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] → f32 [n_patches, llm_dim] on the params' device."""
        dev = self.params["pos"].device
        return encode_image(self.cfg, self.params, self.preprocess(image).to(dev))[0]


# --------------------------------------------------------------------------- #
# HF checkpoint I/O (LlavaForConditionalGeneration names)
# --------------------------------------------------------------------------- #

_VT = "vision_tower.vision_model"

_LAYER_MAP = {
    "ln1_w": ("layer_norm1.weight", False), "ln1_b": ("layer_norm1.bias", False),
    "q_w": ("self_attn.q_proj.weight", True), "q_b": ("self_attn.q_proj.bias", False),
    "k_w": ("self_attn.k_proj.weight", True), "k_b": ("self_attn.k_proj.bias", False),
    "v_w": ("self_attn.v_proj.weight", True), "v_b": ("self_attn.v_proj.bias", False),
    "o_w": ("self_attn.out_proj.weight", True), "o_b": ("self_attn.out_proj.bias", False),
    "ln2_w": ("layer_norm2.weight", False), "ln2_b": ("layer_norm2.bias", False),
    "fc1_w": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False),
}

_TOP_MAP = {
    "patch_w": (f"{_VT}.embeddings.patch_embedding.weight", False),
    "cls": (f"{_VT}.embeddings.class_embedding", False),
    "pos": (f"{_VT}.embeddings.position_embedding.weight", False),
    "pre_ln_w": (f"{_VT}.pre_layrnorm.weight", False),
    "pre_ln_b": (f"{_VT}.pre_layrnorm.bias", False),
    "proj1_w": ("multi_modal_projector.linear_1.weight", True),
    "proj1_b": ("multi_modal_projector.linear_1.bias", False),
    "proj2_w": ("multi_modal_projector.linear_2.weight", True),
    "proj2_b": ("multi_modal_projector.linear_2.bias", False),
}


def load_hf_vision(cfg: VisionConfig, ckpt_dir: str, device=None) -> Params:
    """A llava checkpoint's tower and projector → the port's f32 tree on
    `device`."""
    from localai_tpu_torch.engine.weights import _ShardReader

    device = resolve_device(device)
    reader = _ShardReader(ckpt_dir)

    def grab(name: str, transpose: bool) -> torch.Tensor:
        t = reader.get(name).float()
        if transpose and t.dim() == 2:
            t = t.t()
        return t.contiguous().to(device)

    params: Params = {our: grab(name, tr) for our, (name, tr) in _TOP_MAP.items()}
    params["cls"] = params["cls"].reshape(-1)
    params["layers"] = {
        our: torch.stack([grab(f"{_VT}.encoder.layers.{i}.{suffix}", tr)
                          for i in range(cfg.layers)])
        for our, (suffix, tr) in _LAYER_MAP.items()
    }
    return params


def save_hf_vision(cfg: VisionConfig, params: Params, ckpt_dir: str) -> None:
    """Inverse of load_hf_vision (F32); merges into an existing
    `model.safetensors` when one is present, and writes the
    `vision_config.json` sidecar."""
    from localai_tpu_torch.engine.weights import SafetensorsFile, write_safetensors_f32

    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "model.safetensors")
    tensors: dict[str, np.ndarray] = {}
    if os.path.exists(path):
        old = SafetensorsFile(path)
        tensors = {name: old.get(name).float().numpy() for name in old.keys()}

    def emit(name: str, t: torch.Tensor, transpose: bool = False) -> None:
        t = t.detach().float()
        tensors[name] = (t.t() if transpose and t.dim() == 2 else t).contiguous().cpu().numpy()

    for our, (name, tr) in _TOP_MAP.items():
        emit(name, params[our], tr)
    for our, (suffix, tr) in _LAYER_MAP.items():
        for i in range(cfg.layers):
            emit(f"{_VT}.encoder.layers.{i}.{suffix}", params["layers"][our][i], tr)
    write_safetensors_f32(path, tensors)
    with open(os.path.join(ckpt_dir, "vision_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def vision_config_from_hf(ckpt_dir: str) -> VisionConfig:
    """From the `vision_config.json` sidecar or an HF llava config.json."""
    side = os.path.join(ckpt_dir, "vision_config.json")
    if os.path.exists(side):
        with open(side) as f:
            return VisionConfig(**json.load(f))
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    vc = hf.get("vision_config") or {}
    return VisionConfig(
        name=vc.get("model_type", "clip-vit"),
        image_size=vc.get("image_size", 336),
        patch=vc.get("patch_size", 14),
        d_model=vc.get("hidden_size", 1024),
        layers=vc.get("num_hidden_layers", 24),
        n_heads=vc.get("num_attention_heads", 16),
        ffn=vc.get("intermediate_size", 4096),
        llm_dim=(hf.get("text_config") or {}).get("hidden_size", 4096),
        select_layer=hf.get("vision_feature_layer", -2),
    )
