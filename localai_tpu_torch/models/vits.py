"""VITS text-to-speech on tensors (localai_tpu/models/vits.py): loads HF
`VitsModel` checkpoints (facebook/mms-tts-*, kakao-enterprise/vits-ljs) and
synthesizes waveforms.

One forward covers the text encoder (windowed relative-position
attention, conv feed-forward) → the stochastic duration predictor (its
flows reversed, rational-quadratic splines) or the plain one → the
alignment expansion → the residual-coupling flow in reverse → the HiFi-GAN
decoder, in NCT layout with torch's own conv and transposed-conv ops. The
names, weight-norm folding, masking and noise handling are the JAX
package's: noise comes in as tensors (`dur_noise`, `prior_noise`), so both
packages compare on one draw, and a padded token bucket (`n_tokens`) gives
the exact-length result on its valid samples.

`init_params` / `save_vits` write a checkpoint directory in the HF layout
(config.json, vocab.json, tokenizer_config.json, model.safetensors) with
seeded random weights: what a published voice is read from, at any
config's widths, for the tests and the card.
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

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VitsConfig:
    vocab_size: int = 38
    hidden_size: int = 192
    num_hidden_layers: int = 6
    num_attention_heads: int = 2
    window_size: int = 4
    ffn_dim: int = 768
    ffn_kernel_size: int = 3
    flow_size: int = 192
    prior_encoder_num_flows: int = 4
    prior_encoder_num_wavenet_layers: int = 4
    wavenet_kernel_size: int = 5
    wavenet_dilation_rate: int = 1
    use_stochastic_duration_prediction: bool = True
    duration_predictor_num_flows: int = 4
    duration_predictor_flow_bins: int = 10
    duration_predictor_tail_bound: float = 5.0
    duration_predictor_kernel_size: int = 3
    duration_predictor_filter_channels: int = 256
    depth_separable_channels: int = 2
    depth_separable_num_layers: int = 3
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    sampling_rate: int = 16000
    speaker_embedding_size: int = 0
    num_speakers: int = 1
    noise_scale: float = 0.667
    noise_scale_duration: float = 0.8
    speaking_rate: float = 1.0
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def sample_rate(self) -> int:  # the engine-facing name (TTSConfig's)
        return self.sampling_rate


def config_from_hf(ckpt_dir: str) -> VitsConfig:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        d = json.load(f)
    fields = {f.name for f in dataclasses.fields(VitsConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    for k in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if "resblock_dilation_sizes" in kw:
        kw["resblock_dilation_sizes"] = tuple(tuple(x) for x in kw["resblock_dilation_sizes"])
    return VitsConfig(**kw)


# --------------------------------------------------------------------------- #
# Weights (HF VitsModel layout; weight norm folded at load)
# --------------------------------------------------------------------------- #


def _fold_weight_norm(raw: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """{name: f32} with weight-norm parametrizations (original0 = g,
    original1 = v, or the legacy weight_g / weight_v) folded to
    name.weight = g · v / ‖v‖."""
    out: dict[str, np.ndarray] = {}
    for name, arr in raw.items():
        for g_suf, v_suf in ((".parametrizations.weight.original0",
                              ".parametrizations.weight.original1"),
                             (".weight_g", ".weight_v")):
            if name.endswith(g_suf):
                base = name[: -len(g_suf)]
                v = raw[base + v_suf]
                norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
                out[base + ".weight"] = arr * v / np.maximum(norm, 1e-12)
                break
            if name.endswith(v_suf):
                break
        else:
            out[name] = arr
    return out


def load_vits_params(ckpt_dir: str, device=None) -> Params:
    """Flat {HF name: f32 tensor on `device`} with weight norm folded."""
    from localai_tpu_torch.engine.weights import SafetensorsFile

    device = resolve_device(device)
    st = SafetensorsFile(os.path.join(ckpt_dir, "model.safetensors"))
    raw = {name: st.get(name).float().numpy() for name in st.keys()}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in _fold_weight_norm(raw).items()}


def is_vits_dir(ckpt_dir: str) -> bool:
    cfg_path = os.path.join(ckpt_dir, "config.json")
    if not os.path.isfile(cfg_path):
        return False
    try:
        with open(cfg_path) as f:
            return json.load(f).get("model_type") == "vits"
    except (OSError, json.JSONDecodeError):
        return False


def param_shapes(cfg: VitsConfig) -> dict[str, tuple]:
    """Every tensor synthesis reads, by its HF name, with its shape (weight
    norm already folded): the inference half of a VitsModel checkpoint."""
    C, Fl, D = cfg.hidden_size, cfg.flow_size, cfg.head_dim
    s: dict[str, tuple] = {"text_encoder.embed_tokens.weight": (cfg.vocab_size, C)}
    for i in range(cfg.num_hidden_layers):
        pre = f"text_encoder.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{pre}.attention.{proj}.weight"] = (C, C)
            s[f"{pre}.attention.{proj}.bias"] = (C,)
        if cfg.window_size:
            for rel in ("emb_rel_k", "emb_rel_v"):
                s[f"{pre}.attention.{rel}"] = (1, 2 * cfg.window_size + 1, D)
        for ln in ("layer_norm", "final_layer_norm"):
            s[f"{pre}.{ln}.weight"] = s[f"{pre}.{ln}.bias"] = (C,)
        k = cfg.ffn_kernel_size
        s[f"{pre}.feed_forward.conv_1.weight"] = (cfg.ffn_dim, C, k)
        s[f"{pre}.feed_forward.conv_1.bias"] = (cfg.ffn_dim,)
        s[f"{pre}.feed_forward.conv_2.weight"] = (C, cfg.ffn_dim, k)
        s[f"{pre}.feed_forward.conv_2.bias"] = (C,)
    s["text_encoder.project.weight"] = (2 * Fl, C, 1)
    s["text_encoder.project.bias"] = (2 * Fl,)

    def wavenet(pre: str, layers: int) -> None:
        for j in range(layers):
            s[f"{pre}.in_layers.{j}.weight"] = (2 * C, C, cfg.wavenet_kernel_size)
            s[f"{pre}.in_layers.{j}.bias"] = (2 * C,)
            rs = 2 * C if j < layers - 1 else C
            s[f"{pre}.res_skip_layers.{j}.weight"] = (rs, C, 1)
            s[f"{pre}.res_skip_layers.{j}.bias"] = (rs,)

    half = Fl // 2
    for i in range(cfg.prior_encoder_num_flows):
        pre = f"flow.flows.{i}"
        s[f"{pre}.conv_pre.weight"], s[f"{pre}.conv_pre.bias"] = (C, half, 1), (C,)
        wavenet(f"{pre}.wavenet", cfg.prior_encoder_num_wavenet_layers)
        s[f"{pre}.conv_post.weight"], s[f"{pre}.conv_post.bias"] = (half, C, 1), (half,)

    def dds(pre: str) -> None:
        for j in range(cfg.depth_separable_num_layers):
            s[f"{pre}.convs_dilated.{j}.weight"] = (C, 1, cfg.duration_predictor_kernel_size)
            s[f"{pre}.convs_dilated.{j}.bias"] = (C,)
            s[f"{pre}.convs_pointwise.{j}.weight"] = (C, C, 1)
            s[f"{pre}.convs_pointwise.{j}.bias"] = (C,)
            for n in ("norms_1", "norms_2"):
                s[f"{pre}.{n}.{j}.weight"] = s[f"{pre}.{n}.{j}.bias"] = (C,)

    dp = "duration_predictor"
    if cfg.use_stochastic_duration_prediction:
        for conv in ("conv_pre", "conv_proj"):
            s[f"{dp}.{conv}.weight"], s[f"{dp}.{conv}.bias"] = (C, C, 1), (C,)
        dds(f"{dp}.conv_dds")
        dsc = cfg.depth_separable_channels
        s[f"{dp}.flows.0.translate"] = s[f"{dp}.flows.0.log_scale"] = (dsc, 1)
        nb = cfg.duration_predictor_flow_bins
        for i in range(2, cfg.duration_predictor_num_flows + 1):
            pre = f"{dp}.flows.{i}"
            s[f"{pre}.conv_pre.weight"], s[f"{pre}.conv_pre.bias"] = (C, dsc // 2, 1), (C,)
            dds(f"{pre}.conv_dds")
            out = dsc // 2 * (3 * nb - 1)
            s[f"{pre}.conv_proj.weight"], s[f"{pre}.conv_proj.bias"] = (out, C, 1), (out,)
    else:
        fc, k = cfg.duration_predictor_filter_channels, cfg.duration_predictor_kernel_size
        s[f"{dp}.conv_1.weight"], s[f"{dp}.conv_1.bias"] = (fc, C, k), (fc,)
        s[f"{dp}.conv_2.weight"], s[f"{dp}.conv_2.bias"] = (fc, fc, k), (fc,)
        for n in ("norm_1", "norm_2"):
            s[f"{dp}.{n}.weight"] = s[f"{dp}.{n}.bias"] = (fc,)
        s[f"{dp}.proj.weight"], s[f"{dp}.proj.bias"] = (1, fc, 1), (1,)

    ch = cfg.upsample_initial_channel
    s["decoder.conv_pre.weight"], s["decoder.conv_pre.bias"] = (ch, Fl, 7), (ch,)
    nk = len(cfg.resblock_kernel_sizes)
    for i, ks in enumerate(cfg.upsample_kernel_sizes):
        cin, ch = ch, ch // 2
        s[f"decoder.upsampler.{i}.weight"], s[f"decoder.upsampler.{i}.bias"] = (cin, ch, ks), (ch,)
        for j, (rk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            for conv in ("convs1", "convs2"):
                for di in range(len(dils)):
                    pre = f"decoder.resblocks.{i * nk + j}.{conv}.{di}"
                    s[f"{pre}.weight"], s[f"{pre}.bias"] = (ch, ch, rk), (ch,)
    s["decoder.conv_post.weight"] = (1, ch, 7)
    return s


def init_params(cfg: VitsConfig, seed: int = 0, device=None) -> Params:
    """Seeded random weights for every tensor of `param_shapes`: norms at
    one (weights) and zero (biases), the duration flows' affine at zero,
    the rest normal with std 1/√fan_in (fan_in: a weight's elements per
    output channel), from a torch generator on `device`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Params = {}
    for name, shape in param_shapes(cfg).items():
        norm = any(tag in name for tag in ("layer_norm.", ".norms_", ".norm_"))
        if norm or name.endswith((".translate", ".log_scale")):
            fill = 1.0 if norm and name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
        elif name.endswith(".bias"):
            out[name] = torch.randn(shape, generator=gen, device=device) * 0.01
        else:
            fan_in = max(1, math.prod(shape[1:]) if len(shape) > 1 else 1)
            out[name] = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
    return out


def save_vits(cfg: VitsConfig, params: Params, ckpt_dir: str, chars: str) -> None:
    """A checkpoint directory in the HF layout: config.json (model_type
    vits and cfg's fields), vocab.json (pad at 0, then `chars`, one id
    each, up to cfg.vocab_size), tokenizer_config.json and
    model.safetensors (f32, plain `.weight` names)."""
    from localai_tpu_torch.engine.weights import write_safetensors

    os.makedirs(ckpt_dir, exist_ok=True)
    write_safetensors(os.path.join(ckpt_dir, "model.safetensors"),
                      {k: tuple(v.shape) for k, v in params.items()}, torch.float32,
                      lambda k: params[k])
    doc = {"model_type": "vits", **dataclasses.asdict(cfg)}
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(doc, f, indent=1)
    vocab = {"<pad>": 0}
    for ch in chars[: cfg.vocab_size - 1]:
        vocab.setdefault(ch, len(vocab))
    with open(os.path.join(ckpt_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(ckpt_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"add_blank": True, "normalize": True}, f)


# --------------------------------------------------------------------------- #
# Character tokenizer (HF VitsTokenizer: lowercase, vocab filter, blanks)
# --------------------------------------------------------------------------- #


class VitsTokenizer:
    def __init__(self, ckpt_dir: str):
        with open(os.path.join(ckpt_dir, "vocab.json")) as f:
            self.vocab: dict[str, int] = json.load(f)
        tc = {}
        tc_path = os.path.join(ckpt_dir, "tokenizer_config.json")
        if os.path.isfile(tc_path):
            with open(tc_path) as f:
                tc = json.load(f)
        self.add_blank = bool(tc.get("add_blank", True))
        self.normalize = bool(tc.get("normalize", True))
        self.pad_id = 0  # HF VitsTokenizer interleaves literal id 0

    def encode(self, text: str) -> list[int]:
        if self.normalize:
            text = text.lower()
        chars = [c for c in text if c in self.vocab]
        if not chars:
            chars = [c for c in self.vocab if c.strip()][:1] or list(self.vocab)[:1]
        ids = [self.vocab[c] for c in chars]
        if self.add_blank:  # [pad, c1, pad, c2, ..., pad]
            inter = [self.pad_id] * (len(ids) * 2 + 1)
            inter[1::2] = ids
            ids = inter
        return ids


# --------------------------------------------------------------------------- #
# Primitive ops (NCT layout, conv weights [out, in, k])
# --------------------------------------------------------------------------- #


def _conv1d(x, w, b=None, dilation: int = 1, groups: int = 1, padding: Optional[int] = None):
    """torch Conv1d; 'same-style' padding (k·d − d) // 2 unless given."""
    pad = ((w.shape[-1] - 1) * dilation) // 2 if padding is None else padding
    return F.conv1d(x, w, b, padding=pad, dilation=dilation, groups=groups)


def _layer_norm_c(x, w, b, eps):
    """LayerNorm over the channel axis of [B, C, T]."""
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[None, :, None] + b[None, :, None]


def _layer_norm_t(x, w, b, eps):
    """LayerNorm over the last axis of [B, T, C]."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _gated(x):
    """WaveNet gate: tanh(first half) · sigmoid(second half) of the channels."""
    C = x.shape[1] // 2
    return torch.tanh(x[:, :C]) * torch.sigmoid(x[:, C:])


# --------------------------------------------------------------------------- #
# Text encoder with windowed relative-position attention
# --------------------------------------------------------------------------- #


def _rel_to_abs(x):
    """[BH, T, 2T-1] relative logits → [BH, T, T] absolute (pad-reshape)."""
    bh, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(bh, t * 2 * t)
    x = F.pad(x, (0, t - 1)).reshape(bh, t + 1, 2 * t - 1)
    return x[:, :t, t - 1:]


def _abs_to_rel(x):
    """[BH, T, T] attention probs → [BH, T, 2T-1] relative layout."""
    bh, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(bh, t * (2 * t - 1))
    x = F.pad(x, (t, 0))
    return x.reshape(bh, t, 2 * t)[:, :, 1:]


def _rel_embeddings(emb, t: int, window: int):
    """The [1, 2w+1, D] table sliced / padded to the [1, 2t-1, D] band."""
    pad = max(t - (window + 1), 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    start = max((window + 1) - t, 0)
    return emb[:, start: start + 2 * t - 1]


def _attention(cfg: VitsConfig, p: Params, pre: str, x, tmask=None):
    """x [B, T, C] → [B, T, C]; tmask [B, T] (1 = valid) masks padded keys."""
    B, T, C = x.shape
    H, D = cfg.num_attention_heads, cfg.head_dim

    def proj(name):
        y = x @ p[f"{pre}.{name}.weight"].T
        b = p.get(f"{pre}.{name}.bias")
        return y + b if b is not None else y

    def heads(y):
        return y.reshape(B, T, H, D).transpose(1, 2).reshape(B * H, T, D)

    q, k, v = heads(proj("q_proj") * D ** -0.5), heads(proj("k_proj")), heads(proj("v_proj"))
    scores = q @ k.transpose(1, 2)  # [BH, T, T]
    if cfg.window_size:
        rel_k = _rel_embeddings(p[f"{pre}.emb_rel_k"], T, cfg.window_size)
        scores = scores + _rel_to_abs(torch.einsum("btd,osd->bts", q, rel_k))
    if tmask is not None:
        km = tmask[:, None, None, :].expand(B, H, 1, T).reshape(B * H, 1, T)
        scores = scores + (1.0 - km) * -1e9
    probs = torch.softmax(scores, dim=-1)
    out = probs @ v
    if cfg.window_size:
        rel_v = _rel_embeddings(p[f"{pre}.emb_rel_v"], T, cfg.window_size)
        out = out + torch.einsum("bts,osd->btd", _abs_to_rel(probs), rel_v)
    out = out.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, C)
    return out @ p[f"{pre}.out_proj.weight"].T + p[f"{pre}.out_proj.bias"]


def text_encoder(cfg: VitsConfig, p: Params, ids, tmask=None):
    """ids [B, T] → (hidden [B, C, T], prior means [B, T, F], prior log
    scales [B, T, F]); tmask [B, T] makes padded positions inert."""
    h = p["text_encoder.embed_tokens.weight"][ids] * math.sqrt(cfg.hidden_size)
    mt = None if tmask is None else tmask[..., None].to(h.dtype)  # [B, T, 1]
    pl, pr = (cfg.ffn_kernel_size - 1) // 2, cfg.ffn_kernel_size // 2
    for i in range(cfg.num_hidden_layers):
        pre = f"text_encoder.encoder.layers.{i}"
        h = _layer_norm_t(h + _attention(cfg, p, f"{pre}.attention", h, tmask),
                          p[f"{pre}.layer_norm.weight"], p[f"{pre}.layer_norm.bias"],
                          cfg.layer_norm_eps)
        y = (h * mt if mt is not None else h).transpose(1, 2)
        if cfg.ffn_kernel_size > 1:
            y = F.pad(y, (pl, pr))
        y = torch.relu(_conv1d(y, p[f"{pre}.feed_forward.conv_1.weight"],
                               p[f"{pre}.feed_forward.conv_1.bias"], padding=0))
        if mt is not None:
            y = y * mt.transpose(1, 2)
        if cfg.ffn_kernel_size > 1:
            y = F.pad(y, (pl, pr))
        y = _conv1d(y, p[f"{pre}.feed_forward.conv_2.weight"],
                    p[f"{pre}.feed_forward.conv_2.bias"], padding=0)
        h = _layer_norm_t(h + y.transpose(1, 2), p[f"{pre}.final_layer_norm.weight"],
                          p[f"{pre}.final_layer_norm.bias"], cfg.layer_norm_eps)
    if mt is not None:
        h = h * mt
    hc = h.transpose(1, 2)  # [B, C, T]
    stats = _conv1d(hc, p["text_encoder.project.weight"], p["text_encoder.project.bias"],
                    padding=0)
    return hc, stats[:, : cfg.flow_size].transpose(1, 2), stats[:, cfg.flow_size:].transpose(1, 2)


# --------------------------------------------------------------------------- #
# WaveNet + residual-coupling flow (reverse)
# --------------------------------------------------------------------------- #


def _wavenet(cfg: VitsConfig, p: Params, pre: str, x, num_layers: int, mask=None):
    """mask [B, 1, T] zeroes frames past the valid length after every
    residual update (a conv at the boundary sees zeros, as torch's
    exact-length tensors' implicit padding would)."""
    C = cfg.hidden_size
    out = torch.zeros_like(x)
    for i in range(num_layers):
        h = _conv1d(x, p[f"{pre}.in_layers.{i}.weight"], p[f"{pre}.in_layers.{i}.bias"],
                    dilation=cfg.wavenet_dilation_rate ** i)
        rs = _conv1d(_gated(h), p[f"{pre}.res_skip_layers.{i}.weight"],
                     p[f"{pre}.res_skip_layers.{i}.bias"], padding=0)
        if i < num_layers - 1:
            x = x + rs[:, :C]
            if mask is not None:
                x = x * mask
            out = out + rs[:, C:]
        else:
            out = out + rs
    return out * mask if mask is not None else out


def _flow_reverse(cfg: VitsConfig, p: Params, z, mask):
    """The residual-coupling block in reverse: z [B, F, T] → the latents
    HiFi-GAN decodes; mask [B, 1, T] marks valid frames."""
    half = cfg.flow_size // 2
    for i in reversed(range(cfg.prior_encoder_num_flows)):
        z = torch.flip(z, dims=(1,))
        pre = f"flow.flows.{i}"
        z0, z1 = z[:, :half], z[:, half:]
        h = _conv1d(z0, p[f"{pre}.conv_pre.weight"], p[f"{pre}.conv_pre.bias"], padding=0) * mask
        h = _wavenet(cfg, p, f"{pre}.wavenet", h, cfg.prior_encoder_num_wavenet_layers, mask)
        m = _conv1d(h, p[f"{pre}.conv_post.weight"], p[f"{pre}.conv_post.bias"], padding=0) * mask
        z = torch.cat([z0, (z1 - m) * mask], dim=1)
    return z


# --------------------------------------------------------------------------- #
# Duration predictors
# --------------------------------------------------------------------------- #


def _dds(cfg: VitsConfig, p: Params, pre: str, x, cond=None, mask=None):
    """Dilated depth-separable conv stack, cond added at entry; mask
    [B, 1, T] zeroes pads before each dilated conv."""
    if cond is not None:
        x = x + cond
    k = cfg.duration_predictor_kernel_size
    for i in range(cfg.depth_separable_num_layers):
        xin = x * mask if mask is not None else x
        h = _conv1d(xin, p[f"{pre}.convs_dilated.{i}.weight"],
                    p[f"{pre}.convs_dilated.{i}.bias"], dilation=k ** i, groups=x.shape[1])
        h = F.gelu(_layer_norm_c(h, p[f"{pre}.norms_1.{i}.weight"], p[f"{pre}.norms_1.{i}.bias"],
                                 cfg.layer_norm_eps))
        h = _conv1d(h, p[f"{pre}.convs_pointwise.{i}.weight"],
                    p[f"{pre}.convs_pointwise.{i}.bias"], padding=0)
        h = F.gelu(_layer_norm_c(h, p[f"{pre}.norms_2.{i}.weight"], p[f"{pre}.norms_2.{i}.bias"],
                                 cfg.layer_norm_eps))
        x = x + h
    return x


def _rq_spline_reverse(cfg: VitsConfig, inputs, uw, uh, ud):
    """Unconstrained rational-quadratic spline, reverse pass (neural spline
    flows; VITS's duration flow). Identity outside ±tail_bound."""
    tb = cfg.duration_predictor_tail_bound
    nb = cfg.duration_predictor_flow_bins
    min_w = min_h = min_d = 1e-3
    inside = (inputs >= -tb) & (inputs <= tb)
    x = torch.clamp(inputs, -tb, tb)
    constant = math.log(math.exp(1 - min_d) - 1)
    ud = F.pad(ud, (1, 1), value=constant)

    def knots(u):
        widths = min_w + (1 - min_w * nb) * torch.softmax(u, dim=-1)
        cum = F.pad(torch.cumsum(widths, dim=-1), (1, 0))
        cum = 2 * tb * cum - tb
        cum[..., 0], cum[..., -1] = -tb, tb
        return cum, cum[..., 1:] - cum[..., :-1]

    cumw, widths = knots(uw)
    cumh, heights = knots(uh)
    derivs = min_d + F.softplus(ud)
    locations = cumh.clone()
    locations[..., -1] += 1e-6  # the reverse pass buckets on the heights
    idx = torch.clamp((x[..., None] >= locations).sum(dim=-1) - 1, 0, nb - 1)[..., None]

    def take(t):
        return torch.gather(t, -1, idx)[..., 0]

    in_cumw, in_w = take(cumw[..., :-1]), take(widths)
    in_cumh, in_h = take(cumh[..., :-1]), take(heights)
    delta = take(heights / widths)
    d0, d1 = take(derivs[..., :-1]), take(derivs[..., 1:])
    t1 = d0 + d1 - 2 * delta
    y = x - in_cumh
    t3 = y * t1
    a = in_h * (delta - d0) + t3
    b = in_h * d0 - t3
    c = -delta * y
    disc = b ** 2 - 4 * a * c
    root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
    return torch.where(inside, root * in_w + in_cumw, inputs)


def _conv_flow_reverse(cfg: VitsConfig, p: Params, pre: str, z, cond, mask=None):
    """VITS ConvFlow reversed: spline-transform the second half given the first."""
    half = cfg.depth_separable_channels // 2
    z0, z1 = z[:, :half], z[:, half:]
    h = _conv1d(z0, p[f"{pre}.conv_pre.weight"], p[f"{pre}.conv_pre.bias"], padding=0)
    h = _dds(cfg, p, f"{pre}.conv_dds", h, cond=cond, mask=mask)
    h = _conv1d(h, p[f"{pre}.conv_proj.weight"], p[f"{pre}.conv_proj.bias"], padding=0)
    B, _, T = z0.shape
    nb = cfg.duration_predictor_flow_bins
    h = h.reshape(B, half, 3 * nb - 1, T).permute(0, 1, 3, 2)  # [B, half, T, 3nb-1]
    s = math.sqrt(cfg.hidden_size)
    z1 = _rq_spline_reverse(cfg, z1, h[..., :nb] / s, h[..., nb: 2 * nb] / s, h[..., 2 * nb:])
    return torch.cat([z0, z1], dim=1)


def _sdp_log_duration(cfg: VitsConfig, p: Params, hidden, noise, tmask=None):
    """The stochastic duration predictor reversed: hidden [B, C, T], noise
    [B, 2, T] (pre-scaled) → log durations [B, 1, T]. The flows run
    [convN, ..., conv2, affine]; flows.1 is skipped, as VITS inference
    skips it."""
    mc = None if tmask is None else tmask[:, None, :].to(hidden.dtype)
    dp = "duration_predictor"
    x = _conv1d(hidden, p[f"{dp}.conv_pre.weight"], p[f"{dp}.conv_pre.bias"], padding=0)
    x = _dds(cfg, p, f"{dp}.conv_dds", x, mask=mc)
    x = _conv1d(x, p[f"{dp}.conv_proj.weight"], p[f"{dp}.conv_proj.bias"], padding=0)
    if mc is not None:
        x = x * mc
    z = noise
    for i in range(cfg.duration_predictor_num_flows, 1, -1):
        z = torch.flip(z, dims=(1,))
        z = _conv_flow_reverse(cfg, p, f"{dp}.flows.{i}", z, x, mask=mc)
    z = torch.flip(z, dims=(1,))
    z = (z - p[f"{dp}.flows.0.translate"][None]) * torch.exp(-p[f"{dp}.flows.0.log_scale"][None])
    return z[:, :1]


def _dp_log_duration(cfg: VitsConfig, p: Params, hidden, tmask=None):
    """The plain duration predictor (use_stochastic=False checkpoints)."""
    mc = None if tmask is None else tmask[:, None, :].to(hidden.dtype)
    k = cfg.duration_predictor_kernel_size
    dp = "duration_predictor"
    x = _conv1d(hidden, p[f"{dp}.conv_1.weight"], p[f"{dp}.conv_1.bias"], padding=k // 2)
    x = _layer_norm_c(torch.relu(x), p[f"{dp}.norm_1.weight"], p[f"{dp}.norm_1.bias"],
                      cfg.layer_norm_eps)
    if mc is not None:
        x = x * mc
    x = _conv1d(x, p[f"{dp}.conv_2.weight"], p[f"{dp}.conv_2.bias"], padding=k // 2)
    x = _layer_norm_c(torch.relu(x), p[f"{dp}.norm_2.weight"], p[f"{dp}.norm_2.bias"],
                      cfg.layer_norm_eps)
    return _conv1d(x, p[f"{dp}.proj.weight"], p[f"{dp}.proj.bias"], padding=0)


# --------------------------------------------------------------------------- #
# HiFi-GAN decoder
# --------------------------------------------------------------------------- #


def hifigan(cfg: VitsConfig, p: Params, spec, mask=None):
    """spec [B, F, T] → waveform [B, T·prod(rates)]; mask [B, 1, T] marks
    valid frames, re-applied (upsampled) after every conv so the padded
    tail never bleeds into valid samples."""
    x = _conv1d(spec, p["decoder.conv_pre.weight"], p["decoder.conv_pre.bias"], padding=3)
    if mask is not None:
        x = x * mask
    nk = len(cfg.resblock_kernel_sizes)
    slope = cfg.leaky_relu_slope
    for i, (rate, ks) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = F.conv_transpose1d(F.leaky_relu(x, slope), p[f"decoder.upsampler.{i}.weight"],
                               p[f"decoder.upsampler.{i}.bias"], stride=rate,
                               padding=(ks - rate) // 2)
        if mask is not None:
            mask = torch.repeat_interleave(mask, rate, dim=-1)
            x = x * mask
        acc = None
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            pre = f"decoder.resblocks.{i * nk + j}"
            y = x
            for di, d in enumerate(dils):
                r = y
                y = _conv1d(F.leaky_relu(y, slope), p[f"{pre}.convs1.{di}.weight"],
                            p[f"{pre}.convs1.{di}.bias"], dilation=d)
                if mask is not None:
                    y = y * mask
                y = _conv1d(F.leaky_relu(y, slope), p[f"{pre}.convs2.{di}.weight"],
                            p[f"{pre}.convs2.{di}.bias"])
                if mask is not None:
                    y = y * mask
                y = y + r
            acc = y if acc is None else acc + y
        x = acc / nk
    x = _conv1d(F.leaky_relu(x), p["decoder.conv_post.weight"], None, padding=3)  # slope 0.01
    if mask is not None:
        x = x * mask
    return torch.tanh(x)[:, 0]


# --------------------------------------------------------------------------- #
# End-to-end synthesis
# --------------------------------------------------------------------------- #


def synthesize(cfg: VitsConfig, p: Params, ids: torch.Tensor, frames: int,
               dur_noise: torch.Tensor, prior_noise: torch.Tensor, speaking_rate: float = 1.0,
               n_tokens: Optional[torch.Tensor] = None):
    """ids [B, T] → (waveform [B, frames·prod(rates)], valid_samples [B]).

    dur_noise [B, 2, T] ~ N(0, 1)·noise_scale_duration and prior_noise
    [B, frames, F] ~ N(0, 1)·noise_scale. The frame budget is fixed;
    durations are clamped into it, and valid_samples says how much of the
    waveform is speech. With n_tokens [B], T may be a padded bucket: pads
    are masked throughout and take zero frames."""
    dev = ids.device
    with torch.no_grad():
        tmask = None
        if n_tokens is not None:
            T = ids.shape[1]
            tmask = (torch.arange(T, device=dev)[None, :] < n_tokens[:, None]).float()
        hidden, m_p, logs_p = text_encoder(cfg, p, ids, tmask)
        if cfg.use_stochastic_duration_prediction:
            log_d = _sdp_log_duration(cfg, p, hidden, dur_noise, tmask)
        else:
            log_d = _dp_log_duration(cfg, p, hidden, tmask)
        dur = torch.ceil(torch.exp(log_d[:, 0]) / speaking_rate)  # [B, T]
        if tmask is not None:
            dur = dur * tmask
        cum = torch.cumsum(dur, dim=-1)
        total = torch.clamp(cum[:, -1], max=frames)  # [B]
        # Output frame f takes the token whose cumulative span covers f.
        fidx = torch.arange(frames, device=dev)[None, :, None]
        starts = F.pad(cum[:, :-1], (1, 0))[:, None, :]
        attn = ((fidx >= starts) & (fidx < cum[:, None, :])).to(m_p.dtype)  # [B, frames, T]
        m_up, logs_up = attn @ m_p, attn @ logs_p
        mask = (torch.arange(frames, device=dev)[None, :] < total[:, None]).to(m_p.dtype)[:, None]
        z_p = (m_up + prior_noise * torch.exp(logs_up)).transpose(1, 2) * mask  # [B, F, frames]
        z = _flow_reverse(cfg, p, z_p, mask)
        wav = hifigan(cfg, p, z * mask, mask)
    up = int(np.prod(cfg.upsample_rates))
    return wav, (total * up).to(torch.int32)


def load_vits(ckpt_dir: str, device=None):
    """(cfg, params, tokenizer) of an HF VITS checkpoint directory."""
    return config_from_hf(ckpt_dir), load_vits_params(ckpt_dir, device), VitsTokenizer(ckpt_dir)
