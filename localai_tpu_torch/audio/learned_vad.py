"""Learned voice-activity detection, inference only: a small conv + GRU
network on tensors (localai_tpu/audio/learned_vad.py).

Log-mel frames → two 'same' 1-D convs over time → a GRU written out step
by step with the JAX package's gate order ([z, r, n], n's recurrent term
gated by r) → a per-frame speech probability, then the run-length
post-processing of the energy detector (audio/vad.py). Weights are a
safetensors file read by the port's own parser; the shipped
`assets/vad-base.safetensors` is a byte-identical copy of the JAX
package's. `StreamingDetector` answers `detect`'s question about a buffer
that grows by appends (the realtime socket's) at a cost per append that
does not grow with the buffer. The trainers (synthetic and formant
corpora, evaluation) are not served and not ported here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from localai_tpu_torch.audio.vad import VADSegment
from localai_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VadNetConfig:
    n_mels: int = 40
    conv_channels: int = 32
    hidden: int = 48
    frame_hop_s: float = 0.01  # log-mel hop (features.HOP / SAMPLE_RATE)


def _conv_t(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, T, C_in], w [k, C_in, C_out] → 'same' conv over time [B, T, C_out]."""
    k = w.shape[0]  # odd: SAME pads (k - 1) / 2 on each side
    y = torch.nn.functional.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=(k - 1) // 2)
    return y.transpose(1, 2) + b


def forward(cfg: VadNetConfig, p: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] (log-mel) → speech probability [B, T]."""
    x = torch.relu(_conv_t(mel, p["conv1_w"], p["conv1_b"]))
    x = torch.relu(_conv_t(x, p["conv2_w"], p["conv2_b"]))  # [B, T, C]
    g_all = x @ p["gru_wx"] + p["gru_b"]  # [B, T, 3H]: every step's input term
    h0 = torch.zeros((x.shape[0], p["gru_wh"].shape[0]), dtype=x.dtype, device=x.device)
    return _head(p, _gru(p, g_all, h0))


def _gru(p: Params, g_all: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU from state h [B, H] over the input terms g_all [B, T, 3H] →
    every step's state [B, T, H]."""
    H = p["gru_wh"].shape[0]
    hs = []
    for t in range(g_all.shape[1]):
        g = g_all[:, t]
        gh = h @ p["gru_wh"]
        z = torch.sigmoid(g[:, :H] + gh[:, :H])
        r = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else h.new_zeros((h.shape[0], 0, H))


def _head(p: Params, hs: torch.Tensor) -> torch.Tensor:
    logits = hs @ p["head_w"] + p["head_b"]  # [B, T, 1]
    return torch.sigmoid(logits[..., 0])


def features(audio: np.ndarray, cfg: VadNetConfig, sample_rate: int = 16_000,
             device=None) -> torch.Tensor:
    """[T_samples] → log-mel [1, T_frames, n_mels] on `device`."""
    from localai_tpu_torch.audio.features import log_mel_spectrogram
    from localai_tpu_torch.audio.wav import resample

    x = np.asarray(audio, np.float32)
    if sample_rate != 16_000:
        x = resample(x, sample_rate, 16_000)
    return log_mel_spectrogram(x, n_mels=cfg.n_mels, device=device)[None]


def _segments(active: np.ndarray, hop_s: float, total: float, min_speech_ms: float,
              min_silence_ms: float, pad_ms: float) -> list[VADSegment]:
    """Runs of active frames → merge gaps under min_silence → drop runs
    under min_speech → pad (silero's post-processing semantics)."""
    min_speech = max(1, int(min_speech_ms / 1000 / hop_s))
    min_sil = max(1, int(min_silence_ms / 1000 / hop_s))
    edges = np.diff(np.concatenate([[0], np.asarray(active, np.int8), [0]]))
    segs = [[int(s), int(e)] for s, e in zip(np.flatnonzero(edges == 1),
                                             np.flatnonzero(edges == -1))]
    merged: list[list[int]] = []
    for s in segs:
        if merged and s[0] - merged[-1][1] < min_sil:
            merged[-1][1] = s[1]
        else:
            merged.append(s)
    pad = pad_ms / 1000.0
    return [VADSegment(start=max(0.0, s * hop_s - pad), end=min(total, e * hop_s + pad))
            for s, e in merged if e - s >= min_speech]


def detect(cfg: VadNetConfig, p: Params, audio: np.ndarray, sample_rate: int = 16_000,
           threshold: float = 0.5, min_speech_ms: float = 90.0, min_silence_ms: float = 150.0,
           pad_ms: float = 30.0) -> list[VADSegment]:
    """Speech segments from the learned frame probabilities, smoothed as
    energy_vad smooths its frames; the net runs where its weights are."""
    device = p["conv1_w"].device
    with torch.no_grad():
        probs = forward(cfg, p, features(audio, cfg, sample_rate, device=device))[0]
    active = (probs > threshold).cpu().numpy()
    return _segments(active, cfg.frame_hop_s, len(audio) / sample_rate, min_speech_ms,
                     min_silence_ms, pad_ms)


class StreamingDetector:
    """`detect` of a buffer that grows by pushes (a realtime socket's input),
    at a cost per push that does not grow with the buffer: after each
    push, the segments `detect` gives for everything pushed so far.

    The whole-buffer answer changes only near the buffer's end, except
    through one number: the log-mel clamp at the signal's peak − 8. So the
    detector keeps, across pushes, the 16 kHz samples' resampling state,
    every final frame's log10 mel (its window lies in samples that no
    longer change), the GRU state after the frames whose convolution
    outputs are final, their decisions, and the peak those were computed
    at. A push resamples and frames only its new samples and the few at
    the end that the whole-buffer version pads, runs the convolutions over
    the new frames and their receptive field, and the GRU from the kept
    state; the frames whose outputs are not final yet are recomputed at
    every push and never kept. When the peak differs from the one the
    kept state was computed at (the loudest frame so far arrived), the
    GRU state is recomputed from the first frame: once for each new peak,
    which speech sets early. The answer is `detect`'s, with its default
    threshold and run lengths, up to rounding."""

    def __init__(self, sample_rate: int = 16_000):
        from math import gcd

        self.sample_rate = int(sample_rate)
        g = gcd(self.sample_rate, 16_000)
        self._up, self._down = 16_000 // g, self.sample_rate // g
        # Input samples an output of resample() reaches on either side
        # (scipy's resample_poly: 10 * max(up, down) taps each side of the
        # upsampled signal), plus one.
        self._reach = 0 if self._up == self._down else \
            -(-10 * max(self._up, self._down) // self._up) + 1
        self._x = np.zeros((0,), np.float32)  # input samples from _x0 on
        self._x0 = 0
        self._n = 0  # input samples pushed
        self._raw: Optional[torch.Tensor] = None  # log10 mel of the final frames
        self._peak: Optional[torch.Tensor] = None  # their max
        self._kept_at: Optional[float] = None  # the peak the kept state used
        self._h: Optional[torch.Tensor] = None  # GRU state after the kept frames
        self._active = np.zeros((0,), bool)  # the kept frames' decisions
        self.seconds = 0.0  # of 16 kHz audio pushed
        self.recomputes = 0  # pushes that recomputed the GRU from the first frame

    def _n16(self, n: int) -> int:
        """len(resample(x)) for n input samples."""
        return -(-n * self._up // self._down)

    def _resampled(self, a: int) -> np.ndarray:
        """Samples a.. of resample(everything pushed), from the input's tail
        (resample_poly is a local filter, so outputs far enough from the
        segment's start equal the whole signal's)."""
        from localai_tpu_torch.audio.wav import resample

        if self._up == self._down:
            self._x, self._x0 = self._x[a - self._x0:], a  # later pushes start at or after a
            return self._x
        s = max(0, (a * self._down // self._up - self._reach - self._down)
                // self._down * self._down)
        self._x, self._x0 = self._x[s - self._x0:], s
        return resample(self._x, self.sample_rate, 16_000)[a - s * self._up // self._down:]

    def push(self, cfg: VadNetConfig, p: Params, samples: np.ndarray) -> list[VADSegment]:
        from localai_tpu_torch.audio.features import HOP, N_FFT, log10_mel, scale_log_mel

        self._x = np.concatenate([self._x, np.asarray(samples, np.float32)])
        self._n += len(samples)
        n16 = self._n16(self._n)
        self.seconds = n16 / 16_000.0
        pad = N_FFT // 2
        if n16 <= pad:  # too short to reflect-pad, as for detect
            return []
        T = n16 // HOP  # the whole buffer's frames (its last one dropped)
        stable = max(0, n16 if self._reach == 0 else
                     (self._n - self._reach - 1) * self._up // self._down)
        final = min(T, max(0, (stable - pad) // HOP + 1))  # frames in stable samples only
        f0 = 0 if self._raw is None else self._raw.shape[0]
        dev = p["conv1_w"].device
        a = max(0, HOP * f0 - pad)
        y = torch.from_numpy(np.ascontiguousarray(self._resampled(a))).to(dev)
        # The whole signal's reflection at its start, where frame f0 reaches it
        # (a reflection's last k samples are the reflection of k).
        y = torch.nn.functional.pad(y[None, None], (max(0, pad - HOP * f0), pad),
                                    mode="reflect")[0, 0]
        raw = log10_mel(y, cfg.n_mels)[: T - f0]  # frames f0 .. T - 1
        if final > f0:
            new = raw[: final - f0]
            peak = new.max()
            self._peak = peak if self._peak is None else torch.maximum(self._peak, peak)
            self._raw = new if self._raw is None else torch.cat([self._raw, new])
        tail = raw[max(0, final - f0):]  # frames final .. T - 1, recomputed every push
        peaks = [t for t in (self._peak, tail.max() if tail.numel() else None) if t is not None]
        peak = float(torch.stack(peaks).max())
        r = (p["conv1_w"].shape[0] - 1) // 2 + (p["conv2_w"].shape[0] - 1) // 2
        kept = len(self._active)
        if self._kept_at != peak:  # a new peak: every kept frame's features moved
            kept, self._h, self._active = 0, None, np.zeros((0,), bool)
            self._kept_at = peak
            self.recomputes += 1
        w0 = max(0, kept - r)  # the convolutions' receptive field before the first new frame
        raws = [t for t in ((self._raw[w0:] if self._raw is not None else None), tail)
                if t is not None and t.shape[0]]
        feats = scale_log_mel(torch.cat(raws), peak)[None]
        x = torch.relu(_conv_t(feats, p["conv1_w"], p["conv1_b"]))
        x = torch.relu(_conv_t(x, p["conv2_w"], p["conv2_b"]))
        g_all = (x @ p["gru_wx"] + p["gru_b"])[:, kept - w0:]
        keep_to = max(kept, min(T, final - r))  # frames whose convolution outputs are final
        h = self._h if self._h is not None else \
            torch.zeros((1, p["gru_wh"].shape[0]), dtype=x.dtype, device=dev)
        hs_kept = _gru(p, g_all[:, : keep_to - kept], h)
        if hs_kept.shape[1]:
            h = hs_kept[:, -1]
        hs = torch.cat([hs_kept, _gru(p, g_all[:, keep_to - kept:], h)], dim=1)
        active = (_head(p, hs)[0] > 0.5).cpu().numpy()  # detect()'s defaults throughout
        self._h = h
        self._active = np.concatenate([self._active, active[: keep_to - kept]])
        return _segments(np.concatenate([self._active, active[keep_to - kept:]]),
                         cfg.frame_hop_s, self.seconds, 90.0, 150.0, 30.0)


def save_params(path: str, p: Params) -> None:
    from localai_tpu_torch.engine.weights import write_safetensors_f32

    write_safetensors_f32(path, {k: v.detach().float().cpu().numpy() for k, v in p.items()})


def load_params(path: str, device=None) -> Params:
    """The net's tensors from a safetensors file, f32 on `device`."""
    from localai_tpu_torch.engine.weights import SafetensorsFile

    device = resolve_device(device)
    st = SafetensorsFile(path)
    return {name: st.get(name).float().to(device) for name in st.keys()}


def config_from_params(p: Params) -> VadNetConfig:
    """The net's shape from its weights (the safetensors file is the one
    source of truth; nothing else is persisted)."""
    return VadNetConfig(n_mels=int(p["conv1_w"].shape[1]),
                        conv_channels=int(p["conv1_w"].shape[2]),
                        hidden=int(p["gru_wx"].shape[1]) // 3)


def find_weights(model_dir: str) -> Optional[str]:
    for name in ("vad.safetensors", "model.safetensors"):
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return path
    return None


def packaged_weights() -> Optional[str]:
    """The port's copy of the pretrained net (assets/vad-base.safetensors,
    trained offline by the JAX package's train_formant); None if not
    shipped."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "assets", "vad-base.safetensors")
    return path if os.path.isfile(path) else None
