"""Text-to-speech on tensors: a FastSpeech-style non-autoregressive
acoustic model and a Griffin-Lim vocoder (localai_tpu/models/tts.py).

Char ids → transformer encoder → a fixed-rate length regulator (each
char's state repeated frames_per_char times) → transformer decoder → mel
head; then mel → linear magnitude (the filterbank's pseudo-inverse) →
Griffin-Lim phase recovery with explicit frames, `torch.fft.rfft` /
`irfft` and an overlap-add by `index_add_`. Speaker voices are learned
embeddings added to the encoder output. The parameter tree, names and the
safetensors layout (save_tts / load_tts) are the JAX package's.

Griffin-Lim's first phase: the JAX package draws it from
`jax.random.key(0)`; here the caller may pass it (`phase0`, how the tests
hold both packages to one draw), else it is drawn uniform in [0, 2π) from a
CPU `torch.Generator` seeded 0 (the same draw on the card and the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    name: str = "tts"
    vocab_size: int = 256  # utf-8 bytes
    d_model: int = 256
    n_heads: int = 4
    enc_layers: int = 4
    dec_layers: int = 4
    ffn_mult: int = 4
    n_voices: int = 8
    max_text: int = 256  # chars per chunk
    frames_per_char: int = 6  # fixed-rate length regulator
    n_mels: int = 80
    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 22050

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn(self) -> int:
        return self.d_model * self.ffn_mult

    @property
    def max_frames(self) -> int:
        return self.max_text * self.frames_per_char


TTS_PRESETS: dict[str, TTSConfig] = {
    "tts-test": TTSConfig(
        name="tts-test", d_model=32, n_heads=2, enc_layers=1, dec_layers=1,
        max_text=32, frames_per_char=2, n_mels=20, n_fft=256, hop=64,
        sample_rate=8000, n_voices=2,
    ),
    "tts-base": TTSConfig(name="tts-base"),
}


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_ts = np.log(10000.0) / max(channels // 2 - 1, 1)
    inv = np.exp(-log_ts * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_params(cfg: TTSConfig, seed: int = 0, device=None, scale: float = 0.02) -> Params:
    """Random f32 weights in the JAX package's layout (normal · scale for
    the matmuls and embeddings, ones / zeros for norms and biases,
    sinusoidal positions), from a torch generator seeded `seed` on
    `device`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, ffn = cfg.d_model, cfg.ffn

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device) * scale

    def block(L):
        ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
        zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return {"ln1_w": ones(L, d), "ln1_b": zeros(L, d),
                "q_w": rnd(L, d, d), "k_w": rnd(L, d, d), "v_w": rnd(L, d, d),
                "o_w": rnd(L, d, d),
                "ln2_w": ones(L, d), "ln2_b": zeros(L, d),
                "fc1_w": rnd(L, d, ffn), "fc1_b": zeros(L, ffn),
                "fc2_w": rnd(L, ffn, d), "fc2_b": zeros(L, d)}

    return {
        "embed": rnd(cfg.vocab_size, d),
        "voice": rnd(cfg.n_voices, d),
        "enc_pos": torch.from_numpy(_sinusoids(cfg.max_text, d)).to(device),
        "dec_pos": torch.from_numpy(_sinusoids(cfg.max_frames, d)).to(device),
        "enc": block(cfg.enc_layers),
        "dec": block(cfg.dec_layers),
        "mel_w": rnd(d, cfg.n_mels),
        "mel_b": torch.zeros(cfg.n_mels, device=device),
        "ln_out_w": torch.ones(d, device=device), "ln_out_b": torch.zeros(d, device=device),
    }


def params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's TTS tree → f32 tensors on `device`."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _ln(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * w + b


def _blocks(cfg: TTSConfig, blk: Params, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Non-causal transformer stack. h [B, T, d]; mask [B, T] valid."""
    B, T, d = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    for i in range(blk["q_w"].shape[0]):
        lp = {k: v[i] for k, v in blk.items()}
        x = _ln(h, lp["ln1_w"], lp["ln1_b"])
        q = (x @ lp["q_w"]).reshape(B, T, H, Dh)
        k = (x @ lp["k_w"]).reshape(B, T, H, Dh)
        v = (x @ lp["v_w"]).reshape(B, T, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5
        scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
        attn = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v).reshape(B, T, d)
        h = h + attn @ lp["o_w"]
        x = _ln(h, lp["ln2_w"], lp["ln2_b"])
        h = h + F.gelu(x @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh") @ lp["fc2_w"] \
            + lp["fc2_b"]
    return h


def text_to_mel(cfg: TTSConfig, params: Params, text_ids: torch.Tensor, lengths: torch.Tensor,
                voice: torch.Tensor):
    """text_ids [B, max_text] (zero-padded), lengths [B], voice [B] →
    (mel [B, max_frames, n_mels] f32, frame_mask [B, max_frames])."""
    B, T = text_ids.shape
    r = cfg.frames_per_char
    text_mask = torch.arange(T, device=text_ids.device)[None, :] < lengths[:, None]
    h = params["embed"][text_ids] + params["enc_pos"][None, :T]
    h = h + params["voice"][voice][:, None, :]
    h = _blocks(cfg, params["enc"], h, text_mask)
    hf = torch.repeat_interleave(h, r, dim=1)  # [B, T·r, d]
    frame_mask = torch.repeat_interleave(text_mask, r, dim=1)
    hf = hf + params["dec_pos"][None, : hf.shape[1]]
    hf = _blocks(cfg, params["dec"], hf, frame_mask)
    hf = _ln(hf, params["ln_out_w"], params["ln_out_b"])
    mel = hf @ params["mel_w"] + params["mel_b"]
    mel = torch.where(frame_mask[..., None], mel,
                      torch.full_like(mel, float(np.log(np.float32(1e-5)))))
    return mel, frame_mask


# --------------------------------------------------------------------------- #
# Vocoder: mel → waveform by Griffin-Lim
# --------------------------------------------------------------------------- #


@lru_cache(maxsize=4)
def _mel_inverse(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    from localai_tpu_torch.audio.features import mel_filterbank

    return np.linalg.pinv(mel_filterbank(n_mels, n_fft, sr)).astype(np.float32)  # [freqs, mels]


def _stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    from localai_tpu_torch.audio.features import frames

    return torch.fft.rfft(frames(x, n_fft, hop) * window, dim=-1)  # [n_frames, n_freqs]


def _overlap_add(frames_: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    n_frames, n_fft = frames_.shape
    idx = (torch.arange(n_frames, device=frames_.device)[:, None] * hop
           + torch.arange(n_fft, device=frames_.device)[None, :]).reshape(-1)
    return torch.zeros(length, dtype=frames_.dtype, device=frames_.device).index_add_(
        0, idx, frames_.reshape(-1))


def _istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
           length: int) -> torch.Tensor:
    frames_ = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [n_frames, n_fft]
    x = _overlap_add(frames_, hop, length)
    wsq = _overlap_add((window ** 2).expand(frames_.shape[0], n_fft), hop, length)
    return x / torch.clamp(wsq, min=1e-8)


def first_phase(shape, device=None) -> torch.Tensor:
    """Griffin-Lim's default first phase: uniform in [0, 2π) from a CPU
    generator seeded 0, moved to `device`."""
    gen = torch.Generator().manual_seed(0)
    return (torch.rand(tuple(shape), generator=gen) * (2 * np.pi)).to(device)


def mel_to_audio(cfg: TTSConfig, log_mel: torch.Tensor, n_iter: int = 32,
                 phase0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase recovery of natural-log mel magnitudes
    [T_frames, n_mels] → [T_samples] f32, peak-normalized to 0.95."""
    from localai_tpu_torch.audio.features import hann

    dev = log_mel.device
    inv = torch.from_numpy(_mel_inverse(cfg.n_mels, cfg.n_fft, cfg.sample_rate)).to(dev)
    mag = torch.clamp(torch.exp(log_mel) @ inv.T, min=0.0)  # [T_frames, n_freqs]
    window = hann(cfg.n_fft, dev)
    n_frames = mag.shape[0]
    length = (n_frames - 1) * cfg.hop + cfg.n_fft
    phase = first_phase(mag.shape, dev) if phase0 is None else phase0.to(dev, torch.float32)
    spec = torch.polar(mag, phase)
    for _ in range(n_iter):
        x = _istft(spec, cfg.n_fft, cfg.hop, window, length)
        new = _stft(x, cfg.n_fft, cfg.hop, window)[:n_frames]
        spec = torch.polar(mag, torch.angle(new))
    audio = _istft(spec, cfg.n_fft, cfg.hop, window, length)
    return audio / torch.clamp(audio.abs().max(), min=1e-6) * 0.95


def synthesize(cfg: TTSConfig, params: Params, text_ids: torch.Tensor, length: int,
               voice: int, phase0: Optional[torch.Tensor] = None):
    """One utterance: text_ids [max_text] zero-padded → (audio [max_samples]
    f32, n_samples int tensor)."""
    dev = text_ids.device
    with torch.no_grad():
        mel, frame_mask = text_to_mel(cfg, params, text_ids[None],
                                      torch.tensor([length], device=dev),
                                      torch.tensor([voice], device=dev))
        audio = mel_to_audio(cfg, mel[0], phase0=phase0)
    n_valid = frame_mask[0].sum()
    return audio, torch.clamp(n_valid * cfg.hop, max=audio.shape[0])


# --------------------------------------------------------------------------- #
# Checkpoint I/O (the JAX package's safetensors layout)
# --------------------------------------------------------------------------- #


def save_tts(cfg: TTSConfig, params: Params, ckpt_dir: str) -> None:
    from localai_tpu_torch.engine.weights import write_safetensors_f32

    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for k, v in params.items():
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if k2 is None else f"{k}.{k2}"] = v2.detach().float().cpu().numpy()
    write_safetensors_f32(os.path.join(ckpt_dir, "model.safetensors"), flat)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({"model_type": "localai-tts", **dataclasses.asdict(cfg)}, f, indent=1)


def load_tts(ckpt_dir: str, device=None) -> tuple[TTSConfig, Params]:
    from localai_tpu_torch.engine.weights import SafetensorsFile

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    hf.pop("model_type", None)
    cfg = TTSConfig(**hf)
    params: Params = {"enc": {}, "dec": {}}
    st = SafetensorsFile(os.path.join(ckpt_dir, "model.safetensors"))
    for name in st.keys():
        t = st.get(name).float().to(device)
        if "." in name:
            grp, sub = name.split(".", 1)
            params.setdefault(grp, {})[sub] = t
        else:
            params[name] = t
    return cfg, params
