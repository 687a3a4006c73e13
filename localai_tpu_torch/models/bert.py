"""BERT-family encoder in PyTorch (localai_tpu/models/bert.py): sentence
embeddings (bge / sentence-transformers class) and cross-encoder reranking.

- The JAX package's tree: word / position / token-type embeddings, the
  embedding LayerNorm, stacked [L, ...] layer tensors (matmul weights W
  [in, out]), the pooler and, with `num_labels > 0`, the classification
  head (`cls_w` [D, num_labels], `cls_b`). `bert_params_from_numpy` takes
  the JAX tree as numpy arrays.
- `encode_hidden`: post-LN blocks as the original BERT (sublayer, residual
  add, LayerNorm in f32), exact-erf GELU, an additive -1e30 key mask.
  `embed` pools the CLS row or the masked mean and L2-normalises it (norm
  floored at 1e-9); `score_pairs` is the cross-encoder: tanh pooler on the
  CLS row, then the head's first logit.
- Attention and matmuls are plain PyTorch: the JAX package's BERT reaches
  no Pallas kernel (plain einsum and softmax), and B1 is causal. Every
  tensor is f32, and the card runs full f32 matmuls (PyTorch's default
  precision, no TF32), so the card matches the CPU within f32 rounding.
- HF checkpoints: `load_hf_bert` / `save_hf_bert` / `bert_config_from_hf`
  with the reference's name maps (`_TOP_MAP`, `_LAYER_MAP`; BertModel
  names with or without the `bert.` prefix; BertForSequenceClassification's
  `classifier.*` outside it). A checkpoint without a pooler gets the
  identity. `bert_config_from_hf` also reads a classification config's
  head width from `id2label` when `num_labels` is absent, which is how HF
  writes it (the reference reads `num_labels` only).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str = "bert"
    vocab_size: int = 30522
    hidden_size: int = 384  # bge-small
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "cls"  # "cls" | "mean" (sentence-transformers pooling_mode)
    num_labels: int = 0  # >0 adds the cross-encoder classification head

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_PRESETS: dict[str, BertConfig] = {
    "bert-test": BertConfig(
        name="bert-test", vocab_size=512, hidden_size=32, num_layers=2,
        num_heads=2, intermediate_size=64, max_position=128,
    ),
    "bert-rerank-test": BertConfig(
        name="bert-rerank-test", vocab_size=512, hidden_size=32, num_layers=2,
        num_heads=2, intermediate_size=64, max_position=128, num_labels=1,
    ),
    "bge-small": BertConfig(name="bge-small"),
    "bge-base": BertConfig(
        name="bge-base", hidden_size=768, intermediate_size=3072
    ),
    "bge-large": BertConfig(
        name="bge-large", hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096,
    ),
}


def _specs(cfg: BertConfig) -> dict:
    """Leaves as (shape, "normal" | "ones" | "zeros"), the JAX tree."""
    D, L, Fi = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    specs: dict = {
        "word_embed": ((cfg.vocab_size, D), "normal"),
        "pos_embed": ((cfg.max_position, D), "normal"),
        "type_embed": ((cfg.type_vocab_size, D), "normal"),
        "embed_ln_w": ((D,), "ones"), "embed_ln_b": ((D,), "zeros"),
        "layers": {
            "q_w": ((L, D, D), "normal"), "q_b": ((L, D), "zeros"),
            "k_w": ((L, D, D), "normal"), "k_b": ((L, D), "zeros"),
            "v_w": ((L, D, D), "normal"), "v_b": ((L, D), "zeros"),
            "ao_w": ((L, D, D), "normal"), "ao_b": ((L, D), "zeros"),
            "attn_ln_w": ((L, D), "ones"), "attn_ln_b": ((L, D), "zeros"),
            "fc1_w": ((L, D, Fi), "normal"), "fc1_b": ((L, Fi), "zeros"),
            "fc2_w": ((L, Fi, D), "normal"), "fc2_b": ((L, D), "zeros"),
            "out_ln_w": ((L, D), "ones"), "out_ln_b": ((L, D), "zeros"),
        },
        "pooler_w": ((D, D), "normal"), "pooler_b": ((D,), "zeros"),
    }
    if cfg.num_labels > 0:
        specs["cls_w"] = ((D, cfg.num_labels), "normal")
        specs["cls_b"] = ((cfg.num_labels,), "zeros")
    return specs


def init_params(cfg: BertConfig, seed: int = 0, scale: float = 0.02,
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


def bert_params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's BERT tree (numpy arrays, or anything np.asarray
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


def encode_hidden(
    cfg: BertConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    lengths: torch.Tensor,  # [B]
    token_types: Optional[torch.Tensor] = None,  # [B, S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full encoder forward → (hidden [B, S, D] f32, mask [B, S])."""
    B, S = tokens.shape
    dev = tokens.device
    mask = torch.arange(S, device=dev)[None, :] < lengths.to(dev)[:, None]
    tt = torch.zeros_like(tokens) if token_types is None else token_types
    h = params["word_embed"][tokens] + params["pos_embed"][:S][None] + params["type_embed"][tt]
    h = _ln(h, params["embed_ln_w"], params["embed_ln_b"], cfg.layer_norm_eps)
    H, Dh = cfg.num_heads, cfg.head_dim
    bias = torch.where(mask[:, None, None, :], 0.0, -1e30)  # [B, 1, 1, S]
    for li in range(cfg.num_layers):
        lp = {k: v[li] for k, v in params["layers"].items()}
        q = (h @ lp["q_w"] + lp["q_b"]).reshape(B, S, H, Dh)
        k = (h @ lp["k_w"] + lp["k_b"]).reshape(B, S, H, Dh)
        v = (h @ lp["v_w"] + lp["v_b"]).reshape(B, S, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh**-0.5 + bias
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, cfg.hidden_size)
        # post-LN (original BERT): sublayer → residual add → LayerNorm
        h = _ln(h + attn @ lp["ao_w"] + lp["ao_b"], lp["attn_ln_w"], lp["attn_ln_b"],
                cfg.layer_norm_eps)
        ffn = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"])  # exact erf
        h = _ln(h + ffn @ lp["fc2_w"] + lp["fc2_b"], lp["out_ln_w"], lp["out_ln_b"],
                cfg.layer_norm_eps)
    return h, mask


def embed(cfg: BertConfig, params: Params, tokens: torch.Tensor,
          lengths: torch.Tensor) -> torch.Tensor:
    """L2-normalised sentence embeddings [B, D] (CLS pooling, or the masked
    mean with `pooling="mean"`)."""
    h, mask = encode_hidden(cfg, params, tokens, lengths)
    if cfg.pooling == "mean":
        m = mask[..., None].float()
        pooled = (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    else:  # the CLS row
        pooled = h[:, 0]
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def score_pairs(cfg: BertConfig, params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
                token_types: torch.Tensor) -> torch.Tensor:
    """Cross-encoder relevance scores [B] over [CLS] query [SEP] doc [SEP]
    rows (token type 0 for the query segment, 1 for the document's)."""
    if cfg.num_labels <= 0:
        raise ValueError("score_pairs needs a classification head (num_labels > 0)")
    h, _ = encode_hidden(cfg, params, tokens, lengths, token_types)
    pooled = torch.tanh(h[:, 0] @ params["pooler_w"] + params["pooler_b"])
    return (pooled @ params["cls_w"] + params["cls_b"])[:, 0]


# --------------------------------------------------------------------------- #
# HF checkpoint I/O (BertModel names, with or without the "bert." prefix)
# --------------------------------------------------------------------------- #

# our name → (HF name, stored transposed: HF Linear weights are [out, in])
_TOP_MAP = {
    "word_embed": ("embeddings.word_embeddings.weight", False),
    "pos_embed": ("embeddings.position_embeddings.weight", False),
    "type_embed": ("embeddings.token_type_embeddings.weight", False),
    "embed_ln_w": ("embeddings.LayerNorm.weight", False),
    "embed_ln_b": ("embeddings.LayerNorm.bias", False),
    "pooler_w": ("pooler.dense.weight", True),
    "pooler_b": ("pooler.dense.bias", False),
}

_LAYER_MAP = {
    "q_w": ("attention.self.query.weight", True),
    "q_b": ("attention.self.query.bias", False),
    "k_w": ("attention.self.key.weight", True),
    "k_b": ("attention.self.key.bias", False),
    "v_w": ("attention.self.value.weight", True),
    "v_b": ("attention.self.value.bias", False),
    "ao_w": ("attention.output.dense.weight", True),
    "ao_b": ("attention.output.dense.bias", False),
    "attn_ln_w": ("attention.output.LayerNorm.weight", False),
    "attn_ln_b": ("attention.output.LayerNorm.bias", False),
    "fc1_w": ("intermediate.dense.weight", True),
    "fc1_b": ("intermediate.dense.bias", False),
    "fc2_w": ("output.dense.weight", True),
    "fc2_b": ("output.dense.bias", False),
    "out_ln_w": ("output.LayerNorm.weight", False),
    "out_ln_b": ("output.LayerNorm.bias", False),
}


def load_hf_bert(cfg: BertConfig, ckpt_dir: str, device=None) -> Params:
    """An HF BertModel / BertForSequenceClassification safetensors dir →
    the port's f32 tree on `device`."""
    from localai_tpu_torch.engine.weights import _ShardReader

    device = resolve_device(device)
    reader = _ShardReader(ckpt_dir)
    prefix = "bert." if "bert.embeddings.word_embeddings.weight" in reader else ""

    def grab(name: str, transpose: bool) -> torch.Tensor:
        t = reader.get(name).float()
        if transpose and t.dim() == 2:
            t = t.t()
        return t.contiguous().to(device)

    D = cfg.hidden_size
    params: Params = {}
    for our, (suffix, tr) in _TOP_MAP.items():
        if prefix + suffix in reader:
            params[our] = grab(prefix + suffix, tr)
        elif our.startswith("pooler"):  # some bge exports drop the pooler
            params[our] = (torch.eye(D) if our.endswith("_w") else torch.zeros(D)).to(device)
    params["layers"] = {
        our: torch.stack([grab(f"{prefix}encoder.layer.{i}.{suffix}", tr)
                          for i in range(cfg.num_layers)])
        for our, (suffix, tr) in _LAYER_MAP.items()
    }
    if cfg.num_labels > 0:
        # BertForSequenceClassification keeps the head outside the "bert."
        # prefix; both layouts load.
        for head in ("classifier", prefix + "classifier"):
            if f"{head}.weight" in reader:
                params["cls_w"] = grab(f"{head}.weight", True)
                params["cls_b"] = grab(f"{head}.bias", False)
                break
        else:
            params["cls_w"] = torch.zeros((D, cfg.num_labels), device=device)
            params["cls_b"] = torch.zeros((cfg.num_labels,), device=device)
    return params


def save_hf_bert(cfg: BertConfig, params: Params, ckpt_dir: str) -> None:
    """Write `params` as an HF BertModel checkpoint (no prefix; F32
    `model.safetensors` + `config.json`), the classifier with it when the
    config has a head."""
    from localai_tpu_torch.engine.weights import write_safetensors_f32

    os.makedirs(ckpt_dir, exist_ok=True)
    tensors: dict[str, np.ndarray] = {}

    def emit(name: str, t: torch.Tensor, transpose: bool = False) -> None:
        t = t.detach().float()
        tensors[name] = (t.t() if transpose and t.dim() == 2 else t).cpu().numpy()

    for our, (suffix, tr) in _TOP_MAP.items():
        emit(suffix, params[our], tr)
    for our, (suffix, tr) in _LAYER_MAP.items():
        for i in range(cfg.num_layers):
            emit(f"encoder.layer.{i}.{suffix}", params["layers"][our][i], tr)
    if cfg.num_labels > 0 and "cls_w" in params:
        emit("classifier.weight", params["cls_w"], True)
        emit("classifier.bias", params["cls_b"])
    write_safetensors_f32(os.path.join(ckpt_dir, "model.safetensors"), tensors)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "bert",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            **({"num_labels": cfg.num_labels} if cfg.num_labels else {}),
        }, f, indent=1)


def bert_config_from_hf(ckpt_dir: str) -> BertConfig:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    num_labels = hf.get("num_labels")
    if num_labels is None:
        arch = (hf.get("architectures") or [""])[0]
        num_labels = len(hf.get("id2label") or {}) if arch.endswith(
            "SequenceClassification") else 0
    return BertConfig(
        name=hf.get("_name_or_path", "bert"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        num_labels=num_labels,
    )
