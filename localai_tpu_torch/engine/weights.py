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

PEFT LoRA adapters (`adapter_config.json` + `adapter_model.safetensors`, F32
/ F16 / BF16) load two ways: `load_lora_factors` keeps them factorized for
runtime multi-tenant serving (the engine's adapter tier), and
`load_lora_deltas` / `apply_lora` / `load_hf_checkpoint(lora=)` merge them
into the weights (on the host before quantizing, in the loader's case).
The factors and deltas are formed in numpy f32 in the JAX package's order,
so both packages get the same bytes.

Mixtral checkpoints load too: `block_sparse_moe.gate` becomes the router
[L, D, E] and `block_sparse_moe.experts.{e}.w1 / w3 / w2` the expert
stacks w_gate / w_up / w_down [L, E, in, out], quantized on load like the
dense matmul weights.

Phi-3's fused `qkv_proj` / `gate_up_proj` tensors split into the per-head
weights by row blocks as they are read (`_FusedReader`), so a fused
checkpoint loads, quantizes and merges adapters exactly like its unfused
twin. GGUF files load through engine/gguf.py.

DeepSeek-V2/V3 checkpoints (`deepseek_v2` / `deepseek_v3` configs) load
into the two-stack MLA / MoE tree (`_load_deepseek`): the rope columns
de-interleaved (V2 always, V3 per `rope_interleave`), `kv_b_proj` split per
head into w_kb / w_vb, the router's `e_score_correction_bias`, the shared
experts and the dense-layer prefix.

A merged adapter may target Mixtral's expert projections (`w1` / `w3` /
`w2`): each (layer, expert) delta adds into its slice of the stacked
[L, E, in, out] tensor in f32 before the cast or the quantizer, as the JAX
loader merges it. Refused, as the reference's loader refuses it too: LoRA
merged into a DeepSeek tree.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
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

log = logging.getLogger("localai_tpu_torch.weights")

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

# Mixtral's sparse-MoE block: the router and each expert's w1 / w3 / w2
# (gate / up / down), stacked over experts ({e} is the expert index).
_MOE_LAYER_MAP = {
    "router": ("block_sparse_moe.gate.weight", True),
    "w_gate": ("block_sparse_moe.experts.{e}.w1.weight", True),
    "w_up": ("block_sparse_moe.experts.{e}.w3.weight", True),
    "w_down": ("block_sparse_moe.experts.{e}.w2.weight", True),
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
    payload and its f32 scales, and DeepSeek's `router_bias` stays f32. A
    DeepSeek tree's two stacks ("dense_layers" beside "layers") cross as
    they are."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def conv(x, name=""):
        if is_quantized(x):
            return {k: _np_to_tensor(np.asarray(v)).to(device) for k, v in x.items()}
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        t = _np_to_tensor(np.asarray(x)).to(device=device)
        return t.float() if name == "router_bias" else t.to(dt)

    return {k: conv(v, k) for k, v in tree.items()}


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
        # Multimodal wrappers (Qwen2-VL): transformers 4.57 nests the decoder
        # under model.language_model.* and the tower under model.visual.*,
        # where published checkpoints use model.* / visual.*. Both
        # spellings address either layout; real names win on collision.
        self._alias: dict[str, str] = {}
        for name in list(self.weight_map):
            if name.startswith("model.language_model."):
                short = "model." + name[len("model.language_model."):]
            elif name.startswith("model.visual."):
                short = name[len("model."):]
            else:
                continue
            if short not in self.weight_map:
                self._alias[short] = name
                self.weight_map[short] = self.weight_map[name]
        self._open: dict[str, SafetensorsFile] = {}

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def get(self, name: str) -> torch.Tensor:
        fname = self.weight_map[name]
        if fname not in self._open:
            self._open[fname] = SafetensorsFile(os.path.join(self.dir, fname))
        return self._open[fname].get(self._alias.get(name, name))


def _fused_parts(cfg: ArchConfig) -> dict[str, tuple[str, list[int], int]]:
    """Per-layer tensor name -> (the Phi-3 fused tensor holding it, the row
    sizes of the fused tensor's blocks, the block's index)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    qkv, gate_up = [H * hd, K * hd, K * hd], [cfg.intermediate_size] * 2
    return {
        "self_attn.q_proj.weight": ("self_attn.qkv_proj.weight", qkv, 0),
        "self_attn.k_proj.weight": ("self_attn.qkv_proj.weight", qkv, 1),
        "self_attn.v_proj.weight": ("self_attn.qkv_proj.weight", qkv, 2),
        "mlp.gate_proj.weight": ("mlp.gate_up_proj.weight", gate_up, 0),
        "mlp.up_proj.weight": ("mlp.gate_up_proj.weight", gate_up, 1),
    }


class _FusedReader:
    """A shard reader that also serves the per-head names of Phi-3's fused
    tensors, each a row block of its fused [out, in] tensor (the JAX
    loader's split). The loader walks key by key, so a fused tensor's
    other blocks are wanted much later: each fused tensor is read once and
    its siblings' blocks are kept until they are asked for."""

    def __init__(self, reader: _ShardReader, cfg: ArchConfig):
        self.reader = reader
        self.parts = _fused_parts(cfg)
        self._kept: dict[str, torch.Tensor] = {}

    def _source(self, name: str):
        for suffix, (fused_suffix, sizes, idx) in self.parts.items():
            if name.endswith(suffix):
                prefix = name[: -len(suffix)]
                if prefix + fused_suffix in self.reader:
                    return prefix, fused_suffix, sizes, idx
        return None

    def __contains__(self, name: str) -> bool:
        return name in self.reader or self._source(name) is not None

    def get(self, name: str) -> torch.Tensor:
        if name in self.reader:
            return self.reader.get(name)
        kept = self._kept.pop(name, None)
        if kept is not None:
            return kept
        src = self._source(name)
        if src is None:
            raise KeyError(name)
        prefix, fused_suffix, sizes, idx = src
        fused = self.reader.get(prefix + fused_suffix)
        if fused.shape[0] != sum(sizes):
            raise ValueError(f"{prefix + fused_suffix}: {fused.shape[0]} rows, the config's "
                             f"blocks {sizes} need {sum(sizes)}")
        offs = np.cumsum([0, *sizes])
        for suffix, (fsuf, _sizes, i) in self.parts.items():
            if fsuf == fused_suffix and i != idx:
                self._kept[prefix + suffix] = fused[offs[i]: offs[i + 1]]
        return fused[offs[idx]: offs[idx + 1]]


def load_hf_checkpoint(cfg: ArchConfig, ckpt_dir: str, device=None,
                       quantize: str = "",
                       lora: list[tuple[str, float]] | None = None) -> Params:
    """Load an HF-format Llama-family checkpoint (bf16 / f16 / f32 tensors;
    llama, mistral, qwen2, gemma, phi-3 with its fused qkv / gate_up, and
    mixtral layouts) into the stacked tensor dict on `device`, in
    cfg.dtype. Each stacked tensor is allocated on the device once and
    filled layer by layer, so the host holds one layer's tensor at a time.

    `quantize="int8"` / `"int4"` quantizes the matmul weights on the host
    as they are read: int8 per-channel or int4 group-32 for the layer
    weights, the lm_head always per-channel int8 over its D axis. Payloads
    stay int8 / uint8 and scales f32.

    `lora=[(adapter_dir, weight), ...]` merges PEFT adapters into each
    layer's tensor on the host, in f32, before it is cast or quantized."""
    check_supported(cfg)
    if quantize not in ("", "none", None, "int8", "int4"):
        raise ValueError(f"unsupported quantization mode {quantize!r}")
    do_quant = quantize in ("int8", "int4")
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    reader = _FusedReader(_ShardReader(ckpt_dir), cfg)
    lora_deltas: dict[str, dict[Any, np.ndarray]] = {}
    for adir, w in lora or []:
        for our, per_layer in load_lora_deltas(adir, w, cfg).items():
            tgt = lora_deltas.setdefault(our, {})
            for li, d in per_layer.items():
                layer_i = li[0] if isinstance(li, tuple) else li
                if layer_i >= cfg.num_layers:
                    raise ValueError(f"lora delta for {our!r} targets layer {layer_i}, "
                                     f"model has {cfg.num_layers}")
                tgt[li] = tgt[li] + d if li in tgt else d

    def merge_lora(our: str, i: int, t: torch.Tensor) -> torch.Tensor:
        """Layer i's tensor plus its adapters' deltas, each added in f32 to
        its slice (the layer's tensor, or an expert's of an [E, in, out]
        stack) and returned in the tensor's stored dtype (the JAX loader's
        order)."""
        stacked_shape = (cfg.num_layers, *t.shape)
        for li, d in lora_deltas.get(our, {}).items():
            if (li[0] if isinstance(li, tuple) else li) != i:
                continue
            _check_lora_index(our, li, stacked_shape)
            part = li[1:] if isinstance(li, tuple) else ()
            want = tuple(t[part].shape)
            if tuple(d.shape) != want:
                raise ValueError(f"lora delta for {our!r} index {li} has shape {d.shape}, "
                                 f"model expects {want}")
            # torch's f32 add on the host's threads: numpy's sum bit for bit.
            merged = (t[part].float() + torch.from_numpy(d)).to(t.dtype)
            if part:
                t[part] = merged
            else:
                t = merged
        return t

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

    def fill(read, layers, can_quant: bool = False, out_dtype=None):
        """The stack of read(i) over `layers`, allocated on the device
        once and filled layer by layer: quantized (payloads int8 / uint8,
        scales f32) when the load quantizes and the key may be, else in
        out_dtype (cfg.dtype by default)."""
        quantized = do_quant and can_quant

        def layer(i: int) -> dict[str, torch.Tensor]:
            t = read(i)
            if quantized:
                return {k: _np_to_tensor(v) for k, v in quant(t).items()}
            return {"w": t.to(out_dtype or dt)}

        layers = list(layers)
        first = layer(layers[0])
        out = {k: torch.empty((len(layers), *v.shape), dtype=v.dtype, device=device)
               for k, v in first.items()}
        for j, i in enumerate(layers):
            for k, v in (first if j == 0 else layer(i)).items():
                out[k][j].copy_(v)
        return out if quantized else out["w"]

    def stack(our: str, suffix: str, transpose: bool, can_quant: bool = False,
              experts: int = 0):
        def read(i: int) -> torch.Tensor:
            if experts:  # [E, in, out]: one tensor per expert in the checkpoint
                t = torch.stack([grab(f"model.layers.{i}.{suffix.format(e=e)}", transpose)
                                 for e in range(experts)])
            else:
                t = grab(f"model.layers.{i}.{suffix}", transpose)
            return merge_lora(our, i, t)

        return fill(read, range(cfg.num_layers), can_quant)

    def put(name: str) -> torch.Tensor:
        return grab(name, False).to(device=device, dtype=dt)

    def head(params: Params) -> Params:
        if not cfg.tie_embeddings:
            if "lm_head.weight" in reader and do_quant:  # int8 over D: scales per vocab row
                params["lm_head"] = {k: _np_to_tensor(v).to(device) for k, v in
                                     quant(grab("lm_head.weight", False), axis=-1).items()}
            elif "lm_head.weight" in reader:
                params["lm_head"] = put("lm_head.weight")
            else:  # some checkpoints tie without declaring it
                params["lm_head"] = params["embed"]
        return params

    if cfg.is_mla:
        if lora_deltas:
            raise NotImplementedError(
                "LoRA merged into a DeepSeek checkpoint is not supported: the reference "
                "refuses the same merge")
        return head(_load_deepseek(cfg, grab, fill, put))

    layer_map = dict(_LAYER_MAP)
    if cfg.post_norms:
        layer_map["mlp_norm"] = ("pre_feedforward_layernorm.weight", False)
        layer_map["post_attn_norm"] = ("post_attention_layernorm.weight", False)
        layer_map["post_ffw_norm"] = ("post_feedforward_layernorm.weight", False)
    if cfg.qk_norm:
        layer_map["q_norm"] = ("self_attn.q_norm.weight", False)
        layer_map["k_norm"] = ("self_attn.k_norm.weight", False)
    if cfg.is_moe:
        for our in ("w_gate", "w_up", "w_down"):
            layer_map.pop(our)
    layers: Params = {}
    for our, (suffix, transpose) in layer_map.items():
        if f"model.layers.0.{suffix}" in reader:  # optional: qkv bias
            layers[our] = stack(our, suffix, transpose, can_quant=our in QUANT_LAYER_KEYS)
    if cfg.is_moe:
        layers["router"] = stack("router", *_MOE_LAYER_MAP["router"])
        for our in ("w_gate", "w_up", "w_down"):
            layers[our] = stack(our, *_MOE_LAYER_MAP[our], can_quant=True,
                                experts=cfg.num_experts)

    return head({
        "embed": put("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": put("model.norm.weight"),
    })


def _deinterleave(t: torch.Tensor, rot: int, block: int) -> torch.Tensor:
    """The rope columns of an [in, out] weight whose output axis is blocks
    of `block` columns, the last `rot` of each rotary, moved from HF
    deepseek's pair-interleaved order (2i, 2i+1) to the half-split order
    the port's one rope implementation rotates (the JAX loader's
    _deinterleave)."""
    out = t.reshape(t.shape[0], -1, block).clone()
    rope = out[..., block - rot:]
    out[..., block - rot:] = torch.cat([rope[..., 0::2], rope[..., 1::2]], dim=-1)
    return out.reshape(t.shape[0], -1)


def _load_deepseek(cfg: ArchConfig, grab, fill, put) -> Params:
    """A DeepSeek-V2/V3 checkpoint → the two-stack MLA / MoE tree (the JAX
    loader's _load_deepseek). q through the optional lora bottleneck
    (q_a / q_b) or q_proj; kv_a_proj_with_mqa gives the [kv_lora_rank |
    k_pe] latent; kv_b_proj [H·(n+v), r] splits per head into w_kb / w_vb
    (HF's [out, in] orientation, never quantized); mlp.gate (and its
    e_score_correction_bias, kept f32) routes mlp.experts.{e}.*, with the
    always-on mlp.shared_experts.*; the first first_k_dense layers carry a
    plain mlp and go to params["dense_layers"]. Without the lm_head, which
    the caller adds."""
    H = cfg.num_heads
    n, rot, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    kd = cfg.first_k_dense if cfg.is_moe else 0
    L = cfg.num_layers

    def stack(suffix: str, lo: int, hi: int, transpose: bool, can_quant: bool = False,
              rope_block: int = 0, experts: int = 0, out_dtype=None):
        def read(i: int) -> torch.Tensor:
            if experts:
                return torch.stack([grab(f"model.layers.{i}.{suffix.format(e=e)}", transpose)
                                    for e in range(experts)])
            t = grab(f"model.layers.{i}.{suffix}", transpose)
            if rope_block and cfg.rope_interleave:
                t = _deinterleave(t, rot, rope_block)
            return t

        return fill(read, range(lo, hi), can_quant, out_dtype)

    def kv_b(lo: int, hi: int, part: slice) -> torch.Tensor:
        def read(i: int) -> torch.Tensor:
            kb = grab(f"model.layers.{i}.self_attn.kv_b_proj.weight", False)
            return kb.reshape(H, n + vd, r)[:, part]

        return fill(read, range(lo, hi))

    def attn_stack(lo: int, hi: int) -> Params:
        out: Params = {
            "attn_norm": stack("input_layernorm.weight", lo, hi, False),
            "mlp_norm": stack("post_attention_layernorm.weight", lo, hi, False),
        }
        if cfg.q_lora_rank:
            out["wq_a"] = stack("self_attn.q_a_proj.weight", lo, hi, True, True)
            out["q_norm_a"] = stack("self_attn.q_a_layernorm.weight", lo, hi, False)
            out["wq_b"] = stack("self_attn.q_b_proj.weight", lo, hi, True, True,
                                rope_block=n + rot)
        else:
            out["wq"] = stack("self_attn.q_proj.weight", lo, hi, True, True, rope_block=n + rot)
        # wkv_a's output is one pseudo-head of r + rot columns, the last rot rotary.
        out["wkv_a"] = stack("self_attn.kv_a_proj_with_mqa.weight", lo, hi, True, True,
                             rope_block=r + rot)
        out["kv_norm"] = stack("self_attn.kv_a_layernorm.weight", lo, hi, False)
        out["w_kb"] = kv_b(lo, hi, slice(0, n))
        out["w_vb"] = kv_b(lo, hi, slice(n, n + vd))
        out["wo"] = stack("self_attn.o_proj.weight", lo, hi, True, True)
        return out

    mlp = (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))
    layers = attn_stack(kd, L)
    if cfg.is_moe:
        layers["router"] = stack("mlp.gate.weight", kd, L, True)
        if cfg.router_bias:
            layers["router_bias"] = stack("mlp.gate.e_score_correction_bias", kd, L, False,
                                          out_dtype=torch.float32)
        for our, suffix in mlp:
            layers[our] = stack(f"mlp.experts.{{e}}.{suffix}.weight", kd, L, True, True,
                                experts=cfg.num_experts)
        if cfg.n_shared_experts:
            for our, suffix in mlp:
                layers[f"shared_{our[2:]}"] = stack(f"mlp.shared_experts.{suffix}.weight",
                                                    kd, L, True, True)
    else:
        for our, suffix in mlp:
            layers[our] = stack(f"mlp.{suffix}.weight", 0, L, True, True)
    params: Params = {
        "embed": put("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": put("model.norm.weight"),
    }
    if kd:
        dense = attn_stack(0, kd)
        for our, suffix in mlp:
            dense[our] = stack(f"mlp.{suffix}.weight", 0, kd, True, True)
        params["dense_layers"] = dense
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
    if model_type in ("deepseek_v2", "deepseek_v3"):
        return _deepseek_arch(hf, model_type, rope_scaling, scaling_type, orig_pos, max_position,
                              attn_factor)
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


def _deepseek_arch(hf: dict, model_type: str, rope_scaling: dict, scaling_type, orig_pos: int,
                   max_position: int, attn_factor) -> ArchConfig:
    """The deepseek_v2 / deepseek_v3 branch of `arch_from_hf_config` (the
    JAX package's). Under yarn the cos / sin attention factor (mscale over
    mscale_all_dim) and DeepseekV3Attention's extra softmax-scale term
    yarn_get_mscale(factor, mscale_all_dim)² collapse to
    yarn_get_mscale(factor, mscale), which rope_query_amp squares."""
    v3 = model_type == "deepseek_v3"
    if scaling_type == "yarn":
        factor = float(rope_scaling.get("factor", 1.0))

        def _gm(m):
            return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0

        af = rope_scaling.get("attention_factor")
        msad = rope_scaling.get("mscale_all_dim")
        if af is not None:
            attn_factor = float(af) * (_gm(float(msad)) if msad else 1.0)
        elif rope_scaling.get("mscale") is not None and msad:
            attn_factor = _gm(float(rope_scaling["mscale"]))
        else:
            attn_factor = None  # rope_query_amp's default 0.1·ln(factor) + 1
    return ArchConfig(
        name=hf.get("_name_or_path", model_type) or model_type,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("qk_rope_head_dim", 64),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=scaling_type,
        rope_scaling_factor=rope_scaling.get("factor", 1.0),
        rope_original_max_position=orig_pos,
        rope_beta_fast=float(rope_scaling.get("beta_fast", 32.0)),
        rope_beta_slow=float(rope_scaling.get("beta_slow", 1.0)),
        rope_attn_factor=float(attn_factor) if attn_factor is not None else None,
        max_position=max_position,
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        num_experts=hf.get("n_routed_experts") or 0,
        num_experts_per_token=hf.get("num_experts_per_tok") or 2,
        moe_family="deepseek",
        first_k_dense=(hf.get("first_k_dense_replace", 0) if hf.get("n_routed_experts") else 0),
        n_shared_experts=hf.get("n_shared_experts") or 0,
        moe_intermediate_size=hf.get("moe_intermediate_size"),
        routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
        scoring_func="sigmoid" if v3 else hf.get("scoring_func", "softmax"),
        router_bias=v3,
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
        n_group=hf.get("n_group") or 1,
        topk_group=hf.get("topk_group") or 1,
        kv_lora_rank=hf["kv_lora_rank"],
        q_lora_rank=hf.get("q_lora_rank"),
        qk_nope_head_dim=hf.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=hf.get("qk_rope_head_dim", 64),
        v_head_dim=hf.get("v_head_dim", 128),
        # V2 applies complex (pair-interleaved) rope unconditionally; V3
        # checkpoints carry the flag (default true).
        rope_interleave=True if not v3 else bool(hf.get("rope_interleave", True)),
    )


# --------------------------------------------------------------------------- #
# PEFT LoRA adapters
# --------------------------------------------------------------------------- #

# PEFT target-module suffix -> our stacked layer key.
_LORA_TARGETS = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
    # short names PEFT configs commonly use
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}
# PEFT fused-module targets (phi-3 layout): the delta's output columns split
# into the per-head tensors the model serves.
_LORA_FUSED = {
    "qkv_proj": ("wq", "wk", "wv"),
    "gate_up_proj": ("w_gate", "w_up"),
}
# Mixtral-style per-expert projections: w1/w3/w2 -> (key, expert) slices.
_LORA_EXPERT = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}
# Targets that have no served matmul (skipped quietly, not an error).
_LORA_IGNORED = ("embed_tokens", "lm_head", "norm")
_LORA_LAYER = re.compile(r"layers\.(\d+)\.(.+)\.lora_A\.weight$")
_LORA_EXPERT_MOD = re.compile(r"experts\.(\d+)\.(w[123])$")


def _check_lora_index(our: str, idx: Any, shape: tuple) -> None:
    """Every leading index (layer, and expert for MoE keys) must be in range."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    for ax, j in enumerate(parts):
        if not 0 <= j < shape[ax]:
            raise ValueError(f"lora delta for {our!r} index {idx} is out of range for "
                             f"model shape {shape}")


def _read_adapter(adapter_dir: str, weight: float):
    """(scale = weight · alpha / r, {tensor name: f32 array}) of a PEFT dir."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    r = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", r))
    st = SafetensorsFile(os.path.join(adapter_dir, "adapter_model.safetensors"))
    return weight * alpha / max(r, 1), {name: st.get(name).float().numpy() for name in st.keys()}


def _fused_sizes(cfg, short: str, n_out: int, adapter_dir: str) -> list[int]:
    if short == "qkv_proj":
        if cfg is None:
            raise ValueError(f"adapter {adapter_dir!r} targets fused {short!r}; "
                             "splitting it needs the model's head sizes (cfg)")
        return [cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_,
                cfg.num_kv_heads * cfg.head_dim_]
    return [n_out // 2] * 2  # gate_up_proj: two equal halves


def load_lora_deltas(adapter_dir: str, weight: float = 1.0,
                     cfg: ArchConfig | None = None) -> dict[str, dict[Any, np.ndarray]]:
    """A PEFT-format adapter as per-key per-layer f32 weight deltas:
    {our_key: {index: [in, out] f32}}, each weight · (alpha/r) · (B@A)ᵀ
    (PEFT stores A [r, in], B [out, r]; our weights are [in, out]). `index`
    is the layer, or (layer, expert) for MoE expert projections. Fused
    phi-3 targets split by output columns (`cfg` gives the qkv head sizes).
    An adapter whose targets include no served matmul raises."""
    scale, tensors = _read_adapter(adapter_dir, weight)
    per_key: dict[str, dict[Any, np.ndarray]] = {}
    unmatched: list[str] = []
    ignored: list[str] = []

    def add(our: str, idx: Any, delta: np.ndarray) -> None:
        tgt = per_key.setdefault(our, {})
        tgt[idx] = tgt[idx] + delta if idx in tgt else delta

    for name, a in tensors.items():
        if not name.endswith("lora_A.weight"):
            continue
        m = _LORA_LAYER.search(name)
        if m is None:
            (ignored if any(tag in name for tag in _LORA_IGNORED) else unmatched).append(name)
            continue
        layer, module = int(m.group(1)), m.group(2)
        b = tensors.get(name[: -len("lora_A.weight")] + "lora_B.weight")
        if b is None:
            unmatched.append(f"{module} (no lora_B)")
            continue
        short = module.split(".")[-1]
        our = _LORA_TARGETS.get(module) or _LORA_TARGETS.get(short)
        if our is not None:
            add(our, layer, (b @ a).T * scale)
            continue
        em = _LORA_EXPERT_MOD.search(module)
        if em is not None:
            add(_LORA_EXPERT[em.group(2)], (layer, int(em.group(1))), (b @ a).T * scale)
            continue
        if short in _LORA_FUSED:
            delta = (b @ a).T * scale  # [in, out_total]
            sizes = _fused_sizes(cfg, short, delta.shape[1], adapter_dir)
            if delta.shape[1] != sum(sizes):
                raise ValueError(f"lora delta for fused {short!r} layer {layer} has "
                                 f"{delta.shape[1]} output cols, expected {sum(sizes)}")
            off = 0
            for part_key, size in zip(_LORA_FUSED[short], sizes):
                add(part_key, layer, delta[:, off: off + size])
                off += size
            continue
        (ignored if any(tag in module for tag in _LORA_IGNORED) else unmatched).append(module)

    if unmatched:
        log.warning("lora adapter %s: unrecognized target modules skipped: %s",
                    adapter_dir, sorted(set(unmatched)))
    if not per_key:
        detail = []
        if unmatched:
            detail.append(f"unrecognized targets: {sorted(set(unmatched))}")
        if ignored:
            detail.append(f"targets with no served matmul (embed/lm_head/norm): "
                          f"{sorted(set(ignored))}")
        raise ValueError(f"lora adapter {adapter_dir!r} matched no served weight — "
                         + ("; ".join(detail) or "no lora_A tensors found"))
    return per_key


def lora_target_dims(cfg: ArchConfig) -> dict[str, tuple[int, int]]:
    """(in, out) of every runtime-servable LoRA target projection, from the
    architecture (a quantized leaf's shape no longer spells them)."""
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    H = cfg.num_heads * cfg.head_dim_
    K = cfg.num_kv_heads * cfg.head_dim_
    return {
        "wq": (D, H), "wk": (D, K), "wv": (D, K), "wo": (H, D),
        "w_gate": (D, F_), "w_up": (D, F_), "w_down": (F_, D),
    }


def load_lora_factors(
    adapter_dir: str, weight: float = 1.0, cfg: ArchConfig | None = None
) -> tuple[int, dict[str, dict[int, tuple[np.ndarray, np.ndarray]]]]:
    """A PEFT-format adapter as UNMERGED per-layer rank factors for runtime
    multi-tenant serving: (rank, {our_key: {layer: (A [in, r] f32, B [r,
    out] f32)}}) with weight·(alpha/r) folded into B in f32, so the served
    delta is the B·(A·x) the merge would have added. Fused phi-3 targets
    split by B's output columns (A is shared). MoE expert targets raise: the
    runtime path serves the dense llama-family projections only. With
    `cfg`, layers and shapes are checked against the model."""
    scale, tensors = _read_adapter(adapter_dir, weight)
    per_key: dict[str, dict[int, tuple[np.ndarray, np.ndarray]]] = {}
    rank = 0

    def add(our: str, layer: int, a_t: np.ndarray, b_t: np.ndarray) -> None:
        nonlocal rank
        tgt = per_key.setdefault(our, {})
        if layer in tgt:
            raise ValueError(f"lora adapter {adapter_dir!r}: duplicate runtime target "
                             f"{our!r} layer {layer}")
        tgt[layer] = (np.ascontiguousarray(a_t), np.ascontiguousarray(b_t))
        rank = max(rank, a_t.shape[1])

    unmatched: list[str] = []
    for name, a in tensors.items():
        if not name.endswith("lora_A.weight"):
            continue
        m = _LORA_LAYER.search(name)
        if m is None:
            if not any(tag in name for tag in _LORA_IGNORED):
                unmatched.append(name)
            continue
        layer, module = int(m.group(1)), m.group(2)
        b = tensors.get(name[: -len("lora_A.weight")] + "lora_B.weight")
        if b is None:
            unmatched.append(f"{module} (no lora_B)")
            continue
        short = module.split(".")[-1]
        if _LORA_EXPERT_MOD.search(module) is not None:
            raise ValueError(
                f"lora adapter {adapter_dir!r} targets MoE expert projections ({module!r}) — "
                "the runtime multi-tenant path serves dense llama-family targets only; "
                "merge at load via `lora_adapters` instead")
        our = _LORA_TARGETS.get(module) or _LORA_TARGETS.get(short)
        if our is not None:
            add(our, layer, a.T, b.T * scale)
            continue
        if short in _LORA_FUSED:
            bt = b.T * scale  # [r, out_total]
            sizes = _fused_sizes(cfg, short, bt.shape[1], adapter_dir)
            if bt.shape[1] != sum(sizes):
                raise ValueError(f"lora delta for fused {short!r} layer {layer} has "
                                 f"{bt.shape[1]} output cols, expected {sum(sizes)}")
            off = 0
            for part_key, size in zip(_LORA_FUSED[short], sizes):
                add(part_key, layer, a.T, bt[:, off: off + size])
                off += size
            continue
        if not any(tag in module for tag in _LORA_IGNORED):
            unmatched.append(module)

    if unmatched:
        log.warning("lora adapter %s: unrecognized target modules skipped: %s",
                    adapter_dir, sorted(set(unmatched)))
    if not per_key:
        raise ValueError(f"lora adapter {adapter_dir!r} matched no served weight — "
                         "no runtime-servable lora_A/lora_B pairs found")
    if cfg is not None:
        dims = lora_target_dims(cfg)
        for our, layers_d in per_key.items():
            d_in, d_out = dims[our]
            for li, (a_t, b_t) in layers_d.items():
                if li >= cfg.num_layers:
                    raise ValueError(f"lora factors for {our!r} target layer {li}, "
                                     f"model has {cfg.num_layers}")
                if a_t.shape[0] != d_in or b_t.shape[1] != d_out:
                    raise ValueError(f"lora factors for {our!r} layer {li} map "
                                     f"{a_t.shape[0]}->{b_t.shape[1]}, model expects "
                                     f"{d_in}->{d_out}")
    return rank, per_key


def apply_lora(cfg: ArchConfig, params: Params, adapter_dir: str,
               weight: float = 1.0) -> Params:
    """A new parameter dict with a PEFT adapter merged in: W += weight ·
    (alpha/r) · (B@A)ᵀ per targeted layer, the delta cast to the weight's
    dtype and added there (the JAX package's `at[].add`). Targeted leaves
    are copied, so `params` is left as it was; quantized trees are
    rejected."""
    per_key = load_lora_deltas(adapter_dir, weight, cfg)
    layers = dict(params["layers"])
    for our, deltas in per_key.items():
        leaf = layers.get(our)
        if leaf is None:
            raise KeyError(f"lora targets {our!r} absent from the model tree")
        if isinstance(leaf, dict):
            raise ValueError(
                "cannot merge a LoRA adapter into quantized weights — either load the "
                "checkpoint unquantized and quantize after merging "
                "(load_hf_checkpoint(lora=...)), or serve the adapter UNMERGED through the "
                "runtime path (a virtual model with `base_model` + `adapter`), which DOES "
                "compose with a quantized base: the delta runs in the model dtype beside "
                "the int8/int4 matmul")
        leaf = leaf.clone()
        for idx, delta in deltas.items():
            _check_lora_index(our, idx, tuple(leaf.shape))
            if tuple(delta.shape) != tuple(leaf[idx].shape):
                raise ValueError(f"lora delta for {our!r} index {idx} has shape "
                                 f"{delta.shape}, model expects {tuple(leaf[idx].shape)}")
            leaf[idx] += torch.from_numpy(delta).to(device=leaf.device, dtype=leaf.dtype)
        layers[our] = leaf
    out = dict(params)
    out["layers"] = layers
    return out


# PEFT module name of each of our target keys.
_PEFT_MODULE = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
                "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj"}


def write_safetensors_f32(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write `tensors` as F32 into one safetensors file."""
    write_safetensors(path, {k: tuple(v.shape) for k, v in tensors.items()}, torch.float32,
                      lambda k: torch.from_numpy(np.asarray(tensors[k], np.float32)))


def write_safetensors(path: str, shapes: dict[str, tuple], dtype: torch.dtype,
                      make) -> None:
    """Write one safetensors file of `shapes` (name → shape), all in `dtype`
    (F32 or BF16), each tensor made by make(name) when its turn comes, so
    only one is held at a time."""
    st, size = {torch.float32: ("F32", 4), torch.bfloat16: ("BF16", 2)}[dtype]
    header, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape) * size
        header[name] = {"dtype": st, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for name in shapes:
            t = make(name).detach().to(dtype).contiguous().cpu()
            f.write((t.view(torch.int16) if dtype == torch.bfloat16 else t).numpy().tobytes())


def save_hf_checkpoint(cfg: ArchConfig, params: Params, ckpt_dir: str) -> None:
    """Write a plain llama-family tree (llama, mistral, qwen2 layouts: no
    MoE, no MLA, no gemma norms, no quantized leaf) as an HF checkpoint,
    `config.json` and one `model.safetensors` in the tree's dtype (bf16 or
    f32), one tensor at a time off the device. The names, transposes and
    config are those of the JAX package's save_hf_checkpoint, so either
    package's loader reads it back bit for bit."""
    if cfg.is_moe or cfg.is_mla or cfg.post_norms or cfg.qk_norm or cfg.norm_plus_one \
            or cfg.embed_scale or any(map(is_quantized, [*params["layers"].values(),
                                                             params.get("lm_head")])):
        raise ValueError(f"{cfg.name}: save_hf_checkpoint writes plain llama-family trees only")
    os.makedirs(ckpt_dir, exist_ok=True)
    layers = params["layers"]
    make: dict[str, Any] = {}
    for our, (suffix, transpose) in _LAYER_MAP.items():
        if our in layers:
            for i in range(cfg.num_layers):
                make[f"model.layers.{i}.{suffix}"] = (
                    lambda t=layers[our], i=i, tr=transpose: t[i].T if tr else t[i])
    make["model.embed_tokens.weight"] = lambda: params["embed"]
    make["model.norm.weight"] = lambda: params["final_norm"]
    if not cfg.tie_embeddings and "lm_head" in params:
        make["lm_head.weight"] = lambda: params["lm_head"]
    shapes = {k: tuple(fn().shape) for k, fn in make.items()}
    write_safetensors(os.path.join(ckpt_dir, "model.safetensors"), shapes,
                      params["embed"].dtype, lambda k: make[k]())
    hf = {"model_type": "qwen2" if cfg.attn_qkv_bias else "llama",
          "hidden_act": "gelu_pytorch_tanh" if cfg.activation == "gelu_tanh" else "silu",
          "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
          "max_position_embeddings": cfg.max_position, "rms_norm_eps": cfg.rms_eps,
          "tie_word_embeddings": cfg.tie_embeddings}
    if cfg.rope_scaling:
        hf["rope_scaling"] = {"rope_type": cfg.rope_scaling, "factor": cfg.rope_scaling_factor,
                              "low_freq_factor": cfg.rope_low_freq_factor,
                              "high_freq_factor": cfg.rope_high_freq_factor,
                              "original_max_position_embeddings":
                                  cfg.rope_original_max_position}
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)


def save_lora_adapter(adapter_dir: str, tensors: dict[str, np.ndarray], r: int,
                      alpha: float) -> None:
    """Write a PEFT-format adapter dir: `adapter_config.json` and the
    tensors as F32 in `adapter_model.safetensors`."""
    os.makedirs(adapter_dir, exist_ok=True)
    write_safetensors_f32(os.path.join(adapter_dir, "adapter_model.safetensors"), tensors)
    with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
        json.dump({"r": int(r), "lora_alpha": float(alpha)}, f)


def random_lora_adapter(cfg: ArchConfig, adapter_dir: str, r: int, alpha: float,
                        targets=("wq", "wv"), seed: int = 0, scale: float = 0.02) -> str:
    """A PEFT adapter of random factors (normal · scale, from a numpy seed)
    on every layer's `targets`, written to `adapter_dir`; returns the dir."""
    rng = np.random.default_rng(seed)
    dims = lora_target_dims(cfg)
    tensors = {}
    for i in range(cfg.num_layers):
        for key in targets:
            d_in, d_out = dims[key]
            pre = f"base_model.model.model.layers.{i}.{_PEFT_MODULE[key]}"
            tensors[f"{pre}.lora_A.weight"] = rng.normal(0, scale, (r, d_in)).astype(np.float32)
            tensors[f"{pre}.lora_B.weight"] = rng.normal(0, scale, (d_out, r)).astype(np.float32)
    save_lora_adapter(adapter_dir, tensors, r, alpha)
    return adapter_dir
