"""Whisper-family speech-to-text on tensors (localai_tpu/models/whisper.py).

The encoder (two convs, sinusoidal positions, pre-LN transformer) and the
decoder (learned positions, causal self-attention over an f32 cache and
cross-attention over the encoder states) keep the JAX package's stacked
parameter tree, names and layouts (matmul weights [in, out], convs
[out, in, k]), so `params_from_numpy` carries a JAX tree across and the HF
checkpoint I/O (WhisperForConditionalGeneration names) matches.

Activations run in the weights' dtype (cfg.dtype: f32 as the JAX package
runs, or bf16 on the card); layer norms and attention compute in f32 and
cast back, logits are f32 and the self cache is f32 (the JAX program's).
Attention is plain PyTorch, as the JAX `_mha` is plain jnp: the encoder's
is not causal and the decoder's reads a per-row cache prefix, so B1 is no
counterpart here. `transcribe_greedy` runs its fixed number of steps with
the done mask on the device and no host read until the caller reads the
tokens.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "whisper"
    vocab_size: int = 51865
    d_model: int = 384  # whisper-tiny
    enc_layers: int = 4
    dec_layers: int = 4
    n_heads: int = 6
    n_mels: int = 80
    n_audio_ctx: int = 1500  # 30 s of 10 ms frames, conv-halved
    n_text_ctx: int = 448
    ffn_mult: int = 4
    # Special tokens (HF whisper defaults; the test preset overrides).
    sot_id: int = 50258  # <|startoftranscript|>
    eot_id: int = 50257  # <|endoftext|>
    no_timestamps_id: int = 50363
    transcribe_id: int = 50359
    translate_id: int = 50358
    first_lang_id: int = 50259  # <|en|>
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn(self) -> int:
        return self.d_model * self.ffn_mult


WHISPER_PRESETS: dict[str, WhisperConfig] = {
    # Hermetic test preset: one audio "second" is 100 frames → 50 ctx.
    "whisper-test": WhisperConfig(
        name="whisper-test", vocab_size=128, d_model=32, enc_layers=2,
        dec_layers=2, n_heads=2, n_mels=16, n_audio_ctx=64, n_text_ctx=32,
        sot_id=1, eot_id=2, no_timestamps_id=3, transcribe_id=4,
        translate_id=5, first_lang_id=6,
    ),
    "whisper-tiny": WhisperConfig(name="whisper-tiny"),
    "whisper-base": WhisperConfig(
        name="whisper-base", d_model=512, enc_layers=6, dec_layers=6, n_heads=8
    ),
    "whisper-small": WhisperConfig(
        name="whisper-small", d_model=768, enc_layers=12, dec_layers=12, n_heads=12
    ),
    "whisper-large-v3": WhisperConfig(
        name="whisper-large-v3", vocab_size=51866, d_model=1280, enc_layers=32,
        dec_layers=32, n_heads=20, n_mels=128,
    ),
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed audio positional embedding."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class SelfCache(NamedTuple):
    """Decoder self-attention KV cache [L, B, n_text_ctx, H, Dh], f32."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: WhisperConfig, B: int, device) -> "SelfCache":
        shape = (cfg.dec_layers, B, cfg.n_text_ctx, cfg.n_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=torch.float32, device=device),
                   torch.zeros(shape, dtype=torch.float32, device=device))


def _dt(cfg: WhisperConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _block_shapes(L: int, d: int, ffn: int, cross: bool) -> dict[str, tuple]:
    """Each stacked block tensor's shape; *_w of rank 3 are matmul weights."""
    sq, vec = (L, d, d), (L, d)
    shapes = {"ln1_w": vec, "ln1_b": vec, "q_w": sq, "q_b": vec, "k_w": sq, "v_w": sq,
              "v_b": vec, "o_w": sq, "o_b": vec, "ln2_w": vec, "ln2_b": vec,
              "fc1_w": (L, d, ffn), "fc1_b": (L, ffn), "fc2_w": (L, ffn, d), "fc2_b": vec}
    if cross:
        shapes.update({"lnx_w": vec, "lnx_b": vec, "xq_w": sq, "xq_b": vec, "xk_w": sq,
                       "xv_w": sq, "xv_b": vec, "xo_w": sq, "xo_b": vec})
    return shapes


def init_params(cfg: WhisperConfig, seed: int = 0, device=None, scale: float = 0.02) -> Params:
    """Random weights in the JAX package's layout (normal · scale for the
    matmuls, convs, embeddings and text positions; ones / zeros for norms
    and biases; sinusoids for audio positions), drawn from a torch
    generator seeded `seed` on `device`, in cfg.dtype."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dt(cfg)
    d, M = cfg.d_model, cfg.n_mels

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    def block(L, cross):
        out = {}
        for k, shape in _block_shapes(L, d, cfg.ffn, cross).items():
            if len(shape) == 3:
                out[k] = rnd(*shape)
            else:
                out[k] = (torch.ones if k.startswith("ln") and k.endswith("_w")
                          else torch.zeros)(shape, dtype=dt, device=device)
        return out

    ones, zeros = (lambda n: torch.ones(n, dtype=dt, device=device),
                   lambda n: torch.zeros(n, dtype=dt, device=device))
    return {
        "conv1_w": rnd(d, M, 3), "conv1_b": zeros(d),
        "conv2_w": rnd(d, d, 3), "conv2_b": zeros(d),
        "enc_pos": torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(device, dt),
        "enc": block(cfg.enc_layers, False),
        "enc_ln_w": ones(d), "enc_ln_b": zeros(d),
        "embed": rnd(cfg.vocab_size, d),
        "dec_pos": rnd(cfg.n_text_ctx, d),
        "dec": block(cfg.dec_layers, True),
        "dec_ln_w": ones(d), "dec_ln_b": zeros(d),
    }


def params_from_numpy(cfg: WhisperConfig, tree: Params, device=None) -> Params:
    """The JAX package's whisper tree (numpy or anything np.asarray takes)
    → tensors on `device` in cfg.dtype, the same names and layout."""
    device = resolve_device(device)
    dt = _dt(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(device, dt)

    return conv(tree)


def _ln(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _heads(cfg: WhisperConfig, x: torch.Tensor) -> torch.Tensor:
    """[..., d] → [..., H, Dh]"""
    return x.reshape(*x.shape[:-1], cfg.n_heads, cfg.head_dim)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _mha(cfg: WhisperConfig, q, k, v) -> torch.Tensor:
    """q [B,Tq,H,Dh], k / v [B,Tk,H,Dh] → [B,Tq,d], every key visible."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * cfg.head_dim ** -0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(*out.shape[:-2], cfg.d_model).to(q.dtype)


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params.items()}


def encode(cfg: WhisperConfig, params: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T_frames, n_mels] → encoder states [B, T_frames // 2, d].
    T_frames must be 2 · n_audio_ctx (the serving layer pads and trims)."""
    dt = params["conv1_w"].dtype
    x = mel.to(dt).transpose(1, 2)  # [B, M, T]
    x = _gelu(F.conv1d(x, params["conv1_w"], params["conv1_b"], padding=1))
    x = _gelu(F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2, padding=1))
    h = x.transpose(1, 2)  # [B, T_a, d]
    h = h + params["enc_pos"][: h.shape[1]]
    for i in range(cfg.enc_layers):
        lp = _layer(params["enc"], i)
        x = _ln(h, lp["ln1_w"], lp["ln1_b"])
        q = _heads(cfg, x @ lp["q_w"] + lp["q_b"])
        k = _heads(cfg, x @ lp["k_w"])
        v = _heads(cfg, x @ lp["v_w"] + lp["v_b"])
        h = h + _mha(cfg, q, k, v) @ lp["o_w"] + lp["o_b"]
        x = _ln(h, lp["ln2_w"], lp["ln2_b"])
        h = h + _gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
    return _ln(h, params["enc_ln_w"], params["enc_ln_b"])


def cross_kv(cfg: WhisperConfig, params: Params, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention K / V: [L, B, T_a, H, Dh] each."""
    dec = params["dec"]
    ks = torch.stack([_heads(cfg, enc_out @ dec["xk_w"][i]) for i in range(cfg.dec_layers)])
    vs = torch.stack([_heads(cfg, enc_out @ dec["xv_w"][i] + dec["xv_b"][i])
                      for i in range(cfg.dec_layers)])
    return ks, vs


def decode_step(cfg: WhisperConfig, params: Params, tokens: torch.Tensor, pos: torch.Tensor,
                cache: SelfCache, xk: torch.Tensor, xv: torch.Tensor):
    """One decoder step: tokens [B] at positions pos [B] → (logits [B, V]
    f32, the cache with each layer's new row written at pos). Each layer
    attends over the cache rows strictly before pos plus the current
    token, as the JAX step does; the rows are written in place."""
    B = tokens.shape[0]
    scale = cfg.head_dim ** -0.5
    # An id past the table reads its last row, as the JAX gather clamps (a
    # config without its special ids takes the HF defaults, 50257 and up).
    h = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)] + params["dec_pos"][pos]  # [B, d]
    bidx = torch.arange(B, device=tokens.device)
    T = cache.k.shape[2]
    valid = torch.arange(T, device=tokens.device)[None, :] < pos[:, None]  # [B, T]
    for i in range(cfg.dec_layers):
        lp = _layer(params["dec"], i)
        kc, vc = cache.k[i], cache.v[i]  # [B, T, H, Dh]
        x = _ln(h, lp["ln1_w"], lp["ln1_b"])
        q = _heads(cfg, x @ lp["q_w"] + lp["q_b"]).float()  # [B, H, Dh]
        k = _heads(cfg, x @ lp["k_w"])
        v = _heads(cfg, x @ lp["v_w"] + lp["v_b"])
        scores = torch.einsum("bhd,bthd->bht", q, kc) * scale
        scores = torch.where(valid[:, None], scores, torch.full_like(scores, -1e30))
        cur = torch.einsum("bhd,bhd->bh", q, k.float())[..., None] * scale  # [B, H, 1]
        probs = torch.softmax(torch.cat([scores, cur], dim=-1), dim=-1)
        attn = (torch.einsum("bht,bthd->bhd", probs[..., :T], vc)
                + probs[..., T:] * v.float())
        h = h + attn.reshape(B, cfg.d_model).to(h.dtype) @ lp["o_w"] + lp["o_b"]

        x = _ln(h, lp["lnx_w"], lp["lnx_b"])
        xq = _heads(cfg, x @ lp["xq_w"] + lp["xq_b"]).float()
        xprobs = torch.softmax(torch.einsum("bhd,bthd->bht", xq, xk[i].float()) * scale, dim=-1)
        xattn = torch.einsum("bht,bthd->bhd", xprobs, xv[i].float())
        h = h + xattn.reshape(B, cfg.d_model).to(h.dtype) @ lp["xo_w"] + lp["xo_b"]

        x = _ln(h, lp["ln2_w"], lp["ln2_b"])
        h = h + _gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
        kc[bidx, pos] = k.float()
        vc[bidx, pos] = v.float()
    h = _ln(h, params["dec_ln_w"], params["dec_ln_b"])
    logits = h.float() @ params["embed"].float().T
    return logits, cache


class _Greedy:
    """Static buffers of one (batch size, prompt length, max_tokens)
    transcription: the mel input, the cross K / V, the self cache, the
    logits, the prompt, the ids (prompt, then generated), the done mask
    and the step, all written in place, so that graphs captured over
    `encode()` and `steps(1)` replay for every request of that shape."""

    def __init__(self, cfg: WhisperConfig, params: Params, mel: torch.Tensor, n_prompt: int,
                 max_tokens: int):
        B, dev = mel.shape[0], mel.device
        self.cfg, self.params = cfg, params
        self.mel = torch.empty_like(mel)
        kv = (cfg.dec_layers, B, cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim)
        self.xk = torch.empty(kv, dtype=_dt(cfg), device=dev)
        self.xv = torch.empty(kv, dtype=_dt(cfg), device=dev)
        self.cache = SelfCache.zeros(cfg, B, dev)
        self.logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)
        self.prompt = torch.empty((B, n_prompt), dtype=torch.int64, device=dev)
        self.ids = torch.empty((B, n_prompt + max_tokens), dtype=torch.int64, device=dev)
        self.done = torch.empty((B,), dtype=torch.bool, device=dev)
        self.step_i = torch.empty((1,), dtype=torch.int64, device=dev)
        self.graphs: dict[str, Any] = {}  # "encode", "step"

    def reset(self, mel: torch.Tensor, prompt_ids: list[int]) -> None:
        """A request's inputs and a zeroed state (a handful of launches)."""
        self.mel.copy_(mel)
        self.prompt.copy_(torch.tensor(prompt_ids, dtype=torch.int64).expand_as(self.prompt))
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.ids.fill_(self.cfg.eot_id)
        self.done.zero_()
        self.step_i.zero_()

    def encode(self) -> None:
        """The encoder and every layer's cross K / V into the buffers."""
        xk, xv = cross_kv(self.cfg, self.params, encode(self.cfg, self.params, self.mel))
        self.xk.copy_(xk)
        self.xv.copy_(xv)

    def steps(self, k: int) -> None:
        """k decoder steps on the buffers only. Step i feeds the prompt's id
        i while i < the prompt's length, then the greedy pick of the last
        logits (eot once a row has picked it); either way at position i."""
        cfg, B, P = self.cfg, self.done.shape[0], self.prompt.shape[1]
        for _ in range(k):
            i = self.step_i
            gen = i >= P
            greedy = torch.where(self.done, cfg.eot_id, torch.argmax(self.logits, dim=-1))
            forced = self.prompt.index_select(1, torch.clamp(i, max=P - 1))[:, 0]
            tok = torch.where(gen, greedy, forced)
            torch.logical_or(self.done, gen & (tok == cfg.eot_id), out=self.done)
            pos = torch.clamp(i, max=cfg.n_text_ctx - 1).expand(B)
            self.logits.copy_(decode_step(cfg, self.params, tok, pos, self.cache,
                                          self.xk, self.xv)[0])
            self.ids.index_copy_(1, i, tok[:, None])
            self.step_i.add_(1)


def capture_graph(device: torch.device, fn) -> "torch.cuda.CUDAGraph":
    """`fn` run once eagerly (a real run: it loads the libraries and sets up
    cuBLAS's workspace for the stream), then captured. Both run on the
    engines' one capture stream under their capture lock, and the capture
    is in thread-local mode: an engine's loop thread may launch, allocate
    and synchronize its own stream meanwhile. (A device-wide synchronize
    is invalid during any capture; the port makes one only here and in
    the engine's capture, both under the lock.)"""
    from localai_tpu_torch.engine.engine import _CAPTURE_LOCK, _capture_stream

    stream = _capture_stream(device)
    current = torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK, torch.cuda.stream(stream):
        stream.wait_stream(current)
        fn()
        torch.cuda.synchronize(device)  # as torch.cuda.graph does before a capture
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    current.wait_stream(stream)
    return graph


class GreedyGraphs:
    """transcribe_greedy's state on the card, kept between requests: for
    each (batch size, prompt length, max_tokens) its static buffers
    (_Greedy) and two graphs, the encoder's and one decoder step's, each
    captured by the first request that runs it and replayed by the later
    ones: a request launches ~200 graphs from Python, not ~1,400 kernels
    a step. A capture runs a step's Python once more than an eager run
    does (a graph of n steps would run n steps' worth), and while another
    thread runs Python-heavy work, such as an engine's own capture, each
    launch from Python waits its turn for the GIL. At most MAX_SHAPES are
    kept, the least recently used going first, and none of more than
    MAX_KEPT_BATCH chunks: a long utterance's buffers and graphs (GBs at
    whisper-large-v3's widths) are captured for its call and freed after.
    `decode_ms()` is the CUDA-event time of the last call's decoder steps
    (`steps_last` of them)."""

    MAX_SHAPES = 4
    MAX_KEPT_BATCH = 4

    def __init__(self) -> None:
        self._shapes: dict[tuple, _Greedy] = {}  # in order of last use
        self.captures = 0
        self.replays = 0
        self.steps_last = 0
        self._events = None

    def get(self, cfg: WhisperConfig, params: Params, mel: torch.Tensor, n_prompt: int,
            max_tokens: int) -> _Greedy:
        key = (mel.shape[0], n_prompt, max_tokens)
        if mel.shape[0] > self.MAX_KEPT_BATCH:
            return _Greedy(cfg, params, mel, n_prompt, max_tokens)
        st = self._shapes.pop(key, None)
        if st is None or st.params is not params:
            while len(self._shapes) >= self.MAX_SHAPES:
                del self._shapes[next(iter(self._shapes))]
            st = _Greedy(cfg, params, mel, n_prompt, max_tokens)
        self._shapes[key] = st
        return st

    def _run(self, st: _Greedy, name: str, fn) -> None:
        graph = st.graphs.get(name)
        if graph is None:  # its eager run is this call's
            st.graphs[name] = capture_graph(st.mel.device, fn)
            self.captures += 1
        else:
            graph.replay()
            self.replays += 1

    def run(self, st: _Greedy) -> None:
        """The encoder, then every step of the prompt and the generation."""
        self._run(st, "encode", st.encode)
        n = st.ids.shape[1]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            self._run(st, "step", lambda: st.steps(1))
        end.record()
        self.steps_last = n
        self._events = (start, end)

    def decode_ms(self) -> float:
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def clear(self) -> None:
        self._shapes.clear()


def transcribe_greedy(cfg: WhisperConfig, params: Params, mel: torch.Tensor,
                      prompt_ids: list[int], max_tokens: int,
                      graphs: GreedyGraphs | None = None):
    """Whole-utterance greedy transcription: mel [B, 2·n_audio_ctx, n_mels]
    → (tokens [B, max_tokens] int64, eot-padded; n_valid [B]), both on the
    device. Every one of the max_tokens steps runs (a finished row feeds
    eot) and keeps its state on the device, so nothing is read back until
    the caller reads. On the card the encoder and the steps replay
    captured graphs: `graphs`' for the shape, kept for the next request of
    that shape, or without `graphs` ones captured for this call alone."""
    with torch.no_grad():
        if mel.device.type == "cuda":
            graphs = graphs if graphs is not None else GreedyGraphs()
            st = graphs.get(cfg, params, mel, len(prompt_ids), max_tokens)
            st.reset(mel, prompt_ids)
            graphs.run(st)
        else:
            st = _Greedy(cfg, params, mel, len(prompt_ids), max_tokens)
            st.reset(mel, prompt_ids)
            st.encode()
            st.steps(st.ids.shape[1])
        toks = st.ids[:, len(prompt_ids):].clone()
        return toks, (toks != cfg.eot_id).sum(dim=-1)


# --------------------------------------------------------------------------- #
# HF checkpoint I/O (WhisperForConditionalGeneration names)
# --------------------------------------------------------------------------- #

_ENC_MAP = {
    "ln1_w": ("self_attn_layer_norm.weight", False),
    "ln1_b": ("self_attn_layer_norm.bias", False),
    "q_w": ("self_attn.q_proj.weight", True),
    "q_b": ("self_attn.q_proj.bias", False),
    "k_w": ("self_attn.k_proj.weight", True),
    "v_w": ("self_attn.v_proj.weight", True),
    "v_b": ("self_attn.v_proj.bias", False),
    "o_w": ("self_attn.out_proj.weight", True),
    "o_b": ("self_attn.out_proj.bias", False),
    "ln2_w": ("final_layer_norm.weight", False),
    "ln2_b": ("final_layer_norm.bias", False),
    "fc1_w": ("fc1.weight", True),
    "fc1_b": ("fc1.bias", False),
    "fc2_w": ("fc2.weight", True),
    "fc2_b": ("fc2.bias", False),
}

_DEC_EXTRA = {
    "lnx_w": ("encoder_attn_layer_norm.weight", False),
    "lnx_b": ("encoder_attn_layer_norm.bias", False),
    "xq_w": ("encoder_attn.q_proj.weight", True),
    "xq_b": ("encoder_attn.q_proj.bias", False),
    "xk_w": ("encoder_attn.k_proj.weight", True),
    "xv_w": ("encoder_attn.v_proj.weight", True),
    "xv_b": ("encoder_attn.v_proj.bias", False),
    "xo_w": ("encoder_attn.out_proj.weight", True),
    "xo_b": ("encoder_attn.out_proj.bias", False),
}

_TOP = {
    "conv1_w": "model.encoder.conv1.weight", "conv1_b": "model.encoder.conv1.bias",
    "conv2_w": "model.encoder.conv2.weight", "conv2_b": "model.encoder.conv2.bias",
    "enc_pos": "model.encoder.embed_positions.weight",
    "enc_ln_w": "model.encoder.layer_norm.weight", "enc_ln_b": "model.encoder.layer_norm.bias",
    "embed": "model.decoder.embed_tokens.weight",
    "dec_pos": "model.decoder.embed_positions.weight",
    "dec_ln_w": "model.decoder.layer_norm.weight", "dec_ln_b": "model.decoder.layer_norm.bias",
}


def load_hf_whisper(cfg: WhisperConfig, ckpt_dir: str, device=None) -> Params:
    """An HF whisper checkpoint → the tree on `device` in cfg.dtype, one
    stacked tensor filled layer by layer."""
    from localai_tpu_torch.engine.weights import _ShardReader

    device = resolve_device(device)
    dt = _dt(cfg)
    reader = _ShardReader(ckpt_dir)

    def grab(name: str, transpose: bool = False) -> torch.Tensor:
        t = reader.get(name)
        return (t.t() if transpose and t.dim() == 2 else t).to(device, dt)

    def stack(prefix: str, L: int, layer_map: dict) -> Params:
        out: Params = {}
        for our, (suffix, transpose) in layer_map.items():
            first = grab(f"{prefix}.0.{suffix}", transpose)
            t = torch.empty((L, *first.shape), dtype=dt, device=device)
            t[0] = first
            for i in range(1, L):
                t[i] = grab(f"{prefix}.{i}.{suffix}", transpose)
            out[our] = t
        return out

    params = {our: grab(name) for our, name in _TOP.items()}
    params["enc"] = stack("model.encoder.layers", cfg.enc_layers, _ENC_MAP)
    params["dec"] = stack("model.decoder.layers", cfg.dec_layers, dict(_ENC_MAP, **_DEC_EXTRA))
    return params


def save_hf_whisper(cfg: WhisperConfig, params: Params, ckpt_dir: str,
                    dtype: torch.dtype = torch.float32) -> None:
    """The inverse of load_hf_whisper: `model.safetensors` in `dtype` (f32,
    as the JAX package writes, or bf16) and `config.json` with the JAX
    writer's keys plus `torch_dtype`, one tensor off the device at a time."""
    from localai_tpu_torch.engine.weights import write_safetensors

    os.makedirs(ckpt_dir, exist_ok=True)
    make: dict[str, Any] = {name: (lambda our=our: params[our]) for our, name in _TOP.items()}
    for prefix, tree, L, layer_map in (
            ("model.encoder.layers", params["enc"], cfg.enc_layers, _ENC_MAP),
            ("model.decoder.layers", params["dec"], cfg.dec_layers,
             dict(_ENC_MAP, **_DEC_EXTRA))):
        for i in range(L):
            for our, (suffix, transpose) in layer_map.items():
                make[f"{prefix}.{i}.{suffix}"] = (
                    lambda t=tree[our], i=i, tr=transpose: t[i].T if tr else t[i])
    shapes = {k: tuple(fn().shape) for k, fn in make.items()}
    write_safetensors(os.path.join(ckpt_dir, "model.safetensors"), shapes, dtype,
                      lambda k: make[k]())
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "whisper",
            "vocab_size": cfg.vocab_size,
            "d_model": cfg.d_model,
            "encoder_layers": cfg.enc_layers,
            "decoder_layers": cfg.dec_layers,
            "encoder_attention_heads": cfg.n_heads,
            "decoder_attention_heads": cfg.n_heads,
            "num_mel_bins": cfg.n_mels,
            "max_source_positions": cfg.n_audio_ctx,
            "max_target_positions": cfg.n_text_ctx,
            "decoder_start_token_id": cfg.sot_id,
            "eos_token_id": cfg.eot_id,
            "torch_dtype": str(dtype).replace("torch.", ""),
        }, f, indent=1)


def whisper_config_from_hf(ckpt_dir: str) -> WhisperConfig:
    """The JAX package's reading of config.json; a `torch_dtype` of
    bfloat16 or float16 serves in bf16, anything else in f32."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    eos = hf.get("eos_token_id")
    return WhisperConfig(
        name=hf.get("_name_or_path", "whisper"),
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        enc_layers=hf["encoder_layers"],
        dec_layers=hf["decoder_layers"],
        n_heads=hf["encoder_attention_heads"],
        n_mels=hf.get("num_mel_bins", 80),
        n_audio_ctx=hf.get("max_source_positions", 1500),
        n_text_ctx=hf.get("max_target_positions", 448),
        sot_id=hf.get("decoder_start_token_id", 50258),
        eot_id=(eos if isinstance(eos, int) else 50257) or 50257,
        dtype="bfloat16" if hf.get("torch_dtype") in ("bfloat16", "float16") else "float32",
    )
