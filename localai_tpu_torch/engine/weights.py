"""Weights: the bridge from the JAX package's parameter tree, and HF
safetensors checkpoints → the stacked-layer tensor dict
(localai_tpu/engine/weights.py).

The port keeps the JAX package's layout — stacked [L, ...] layer tensors,
matmul weights W [in, out] — so the bridge only converts arrays, and the
loader transposes HF's [out, in] linears exactly as the JAX loader does.

The safetensors format is parsed here (an 8-byte little-endian header
length, a JSON header of dtype / shape / byte offsets, then raw bytes), so
loading needs neither the `safetensors` package nor a network.

`load_hf_checkpoint(quantize="int8"|"int4")` quantizes the matmul weights
on the host as it reads them (models/quant.py layout, one layer at a time),
so the bf16 tree never exists in device memory.

Not ported yet: GGUF checkpoints (ROADMAP Queue A item 13), LoRA merging
(item 14), MoE and DeepSeek checkpoints (item 16), Phi-3's fused qkv /
gate_up tensors (item 3).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np
import torch

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.llama import check_supported, torch_dtype
from localai_tpu_torch.models.quant import (
    QUANT_LAYER_KEYS,
    is_quantized,
    quantize_tensor_np,
    quantize_tensor_np_g4,
)

Params = dict[str, Any]

# Our layer-param name -> (HF per-layer tensor name, transpose [out,in]->[in,out]).
_LAYER_MAP = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def _np_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy → CPU tensor, including numpy's bfloat16 extension dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(cfg: ArchConfig, tree: Params, device=None) -> Params:
    """The JAX package's parameter tree (numpy arrays, or anything
    np.asarray accepts) → the port's tensor dict on `device`. Same names
    and layout; used to run both packages on the same weights. Float
    leaves go to cfg.dtype; a quantized weight keeps its int8 / uint8
    payload and its f32 scales."""
    check_supported(cfg)
    if "dense_layers" in tree or "router" in tree.get("layers", {}):
        raise NotImplementedError(
            "mixture-of-experts trees are not ported yet (ROADMAP Queue A item 16)")
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def conv(x):
        if is_quantized(x):
            return {k: _np_to_tensor(np.asarray(v)).to(device) for k, v in x.items()}
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _np_to_tensor(np.asarray(x)).to(device=device, dtype=dt)

    return {k: conv(v) for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# safetensors
# --------------------------------------------------------------------------- #

_ST_DTYPES = {
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # raw bits, viewed as torch.bfloat16
}


class SafetensorsFile:
    """One .safetensors file, memory-mapped; tensors are read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        self._base = 8 + n
        header.pop("__metadata__", None)
        self.header: dict[str, dict] = header
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        """The named tensor as a CPU tensor in its stored dtype."""
        meta = self.header[name]
        st_dtype = meta["dtype"]
        if st_dtype not in _ST_DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has unsupported dtype {st_dtype}")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        npdt = np.dtype(_ST_DTYPES[st_dtype]).newbyteorder("<")
        raw = self._mm[self._base + start: self._base + end]
        if raw.nbytes != math.prod(shape) * npdt.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} byte range does not match its shape")
        arr = np.array(raw.view(npdt).reshape(shape), dtype=npdt.newbyteorder("="))
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if st_dtype == "BF16" else t


def _index(ckpt_dir: str) -> dict[str, str]:
    """tensor name -> safetensors shard filename."""
    idx_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            return json.load(f)["weight_map"]
    single = os.path.join(ckpt_dir, "model.safetensors")
    if not os.path.exists(single):
        raise FileNotFoundError(f"no safetensors checkpoint under {ckpt_dir}")
    return {name: "model.safetensors" for name in SafetensorsFile(single).keys()}


class _ShardReader:
    """Lazily-opened safetensors shards with a tensor-name index."""

    def __init__(self, ckpt_dir: str):
        self.dir = ckpt_dir
        self.weight_map = _index(ckpt_dir)
        self._open: dict[str, SafetensorsFile] = {}

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def get(self, name: str) -> torch.Tensor:
        fname = self.weight_map[name]
        if fname not in self._open:
            self._open[fname] = SafetensorsFile(os.path.join(self.dir, fname))
        return self._open[fname].get(name)


def load_hf_checkpoint(cfg: ArchConfig, ckpt_dir: str, device=None,
                       quantize: str = "") -> Params:
    """Load an HF-format Llama-family checkpoint (bf16 / f16 / f32 tensors;
    llama, mistral, qwen2 and gemma layouts)
    into the stacked tensor dict on `device`, in cfg.dtype. Each stacked
    tensor is allocated on the device once and filled layer by layer, so the
    host holds one layer's tensor at a time.

    `quantize="int8"` / `"int4"` quantizes the matmul weights on the host
    as they are read: int8 per-channel or int4 group-32 for the layer
    weights, the lm_head always per-channel int8 over its D axis. Payloads
    stay int8 / uint8 and scales f32."""
    check_supported(cfg)
    if quantize not in ("", "none", None, "int8", "int4"):
        raise ValueError(f"unsupported quantization mode {quantize!r}")
    do_quant = quantize in ("int8", "int4")
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    reader = _ShardReader(ckpt_dir)

    def grab(name: str, transpose: bool) -> torch.Tensor:
        t = reader.get(name)
        if transpose and t.dim() == 2:
            t = t.t()
        if cfg.norm_plus_one and name.endswith("norm.weight"):
            # Gemma stores (1+w) norms as w; fold the +1 here.
            t = (t.float() + 1.0).to(t.dtype)
        return t

    def quant(t: torch.Tensor, axis: int = -2) -> dict[str, np.ndarray]:
        arr = t.float().numpy()
        if quantize == "int4" and axis == -2:
            return quantize_tensor_np_g4(arr)
        return quantize_tensor_np(arr, axis)

    def stack(suffix: str, transpose: bool, can_quant: bool = False):
        quantized = do_quant and can_quant

        def layer(i: int) -> dict[str, torch.Tensor]:
            t = grab(f"model.layers.{i}.{suffix}", transpose)
            if quantized:  # payloads stay int8 / uint8, scales f32
                return {k: _np_to_tensor(v) for k, v in quant(t).items()}
            return {"w": t.to(dt)}

        first = layer(0)
        out = {k: torch.empty((cfg.num_layers, *v.shape), dtype=v.dtype, device=device)
               for k, v in first.items()}
        for i in range(cfg.num_layers):
            for k, v in (first if i == 0 else layer(i)).items():
                out[k][i].copy_(v)
        return out if quantized else out["w"]

    layer_map = dict(_LAYER_MAP)
    if cfg.post_norms:
        layer_map["mlp_norm"] = ("pre_feedforward_layernorm.weight", False)
        layer_map["post_attn_norm"] = ("post_attention_layernorm.weight", False)
        layer_map["post_ffw_norm"] = ("post_feedforward_layernorm.weight", False)
    if cfg.qk_norm:
        layer_map["q_norm"] = ("self_attn.q_norm.weight", False)
        layer_map["k_norm"] = ("self_attn.k_norm.weight", False)
    layers: Params = {}
    for our, (suffix, transpose) in layer_map.items():
        if f"model.layers.0.{suffix}" in reader:  # optional: qkv bias
            layers[our] = stack(suffix, transpose, can_quant=our in QUANT_LAYER_KEYS)

    def put(name: str) -> torch.Tensor:
        return grab(name, False).to(device=device, dtype=dt)

    params: Params = {
        "embed": put("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": put("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in reader and do_quant:  # int8 over D: scales per vocab row
            params["lm_head"] = {k: _np_to_tensor(v).to(device) for k, v in
                                 quant(grab("lm_head.weight", False), axis=-1).items()}
        elif "lm_head.weight" in reader:
            params["lm_head"] = put("lm_head.weight")
        else:  # some checkpoints tie without declaring it
            params["lm_head"] = params["embed"]
    return params


def arch_from_hf_config(ckpt_dir: str) -> ArchConfig:
    """Build an ArchConfig from an HF config.json
    (llama/mistral/qwen2/gemma/gemma-2/gemma-3/phi3, and mixtral shapes),
    with every rope-scaling family: linear, llama3, yarn, longrope."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    if isinstance(hf.get("text_config"), dict):
        hf = {**hf, **hf["text_config"]}  # multimodal wrappers nest the decoder
    model_type = hf.get("model_type", "llama")
    if model_type in ("deepseek_v2", "deepseek_v3"):
        raise NotImplementedError(
            "DeepSeek (MLA) configs are not ported yet (ROADMAP Queue A item 16)")
    rope_scaling = hf.get("rope_scaling") or {}
    scaling_type = rope_scaling.get("rope_type") or rope_scaling.get("type")
    if scaling_type == "su":
        scaling_type = "longrope"  # phi-3's original name for the same math
    if scaling_type == "default":
        scaling_type = None
    mrope_section: tuple = ()
    if scaling_type == "mrope" or rope_scaling.get("mrope_section"):
        mrope_section = tuple(rope_scaling.get("mrope_section") or ())
        scaling_type = None
    max_position = hf.get("max_position_embeddings", 8192)
    if scaling_type not in (None, "linear", "llama3", "yarn", "longrope"):
        raise ValueError(f"rope_scaling type {scaling_type!r} is not supported")
    orig_pos = int(
        rope_scaling.get("original_max_position_embeddings")
        or hf.get("original_max_position_embeddings")
        or max_position
    )
    long_factor = rope_scaling.get("long_factor")
    short_factor = rope_scaling.get("short_factor")
    attn_factor = rope_scaling.get("attention_factor")
    if attn_factor is None:
        attn_factor = rope_scaling.get("mscale")
    gemma3 = model_type in ("gemma3", "gemma3_text")
    gemma = model_type in ("gemma", "gemma2") or gemma3
    gemma2 = model_type == "gemma2"
    sliding_pattern = 2
    if gemma3:
        lt = hf.get("layer_types")
        if isinstance(lt, list) and "full_attention" in lt:
            sliding_pattern = lt.index("full_attention") + 1
        else:
            sliding_pattern = int(
                hf.get("sliding_window_pattern")
                or hf.get("_sliding_window_pattern") or 6
            )
    act = hf.get("hidden_activation") or hf.get("hidden_act") or "silu"
    softcaps = gemma2 or gemma3
    return ArchConfig(
        name=hf.get("_name_or_path", model_type) or model_type,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=scaling_type,
        rope_scaling_factor=rope_scaling.get("factor", 1.0),
        rope_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
        rope_original_max_position=orig_pos,
        rope_beta_fast=float(rope_scaling.get("beta_fast", 32.0)),
        rope_beta_slow=float(rope_scaling.get("beta_slow", 1.0)),
        rope_long_factor=tuple(long_factor) if long_factor else None,
        rope_short_factor=tuple(short_factor) if short_factor else None,
        rope_attn_factor=float(attn_factor) if attn_factor is not None else None,
        rope_local_theta=float(hf.get("rope_local_base_freq") or 0.0) if gemma3 else 0.0,
        max_position=max_position,
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf.get("tie_word_embeddings", gemma),
        attn_qkv_bias=(model_type in ("qwen2", "qwen2_vl", "qwen2_vl_text")),
        mrope_section=mrope_section,
        activation=("gelu_tanh" if "gelu" in act else "silu"),
        embed_scale=gemma,
        norm_plus_one=gemma,
        post_norms=gemma2 or gemma3,
        qk_norm=gemma3,
        attn_softcap=float(hf.get("attn_logit_softcapping") or 0.0) if softcaps else 0.0,
        final_softcap=float(hf.get("final_logit_softcapping") or 0.0) if softcaps else 0.0,
        query_scale=float(hf.get("query_pre_attn_scalar") or 0.0) if softcaps else 0.0,
        sliding_window=int(hf.get("sliding_window") or 0) if softcaps else 0,
        sliding_pattern=sliding_pattern,
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_token=hf.get("num_experts_per_tok", 2),
    )
