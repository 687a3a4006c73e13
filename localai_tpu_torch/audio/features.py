"""Log-mel spectrogram on tensors, whisper's front end
(localai_tpu/audio/features.py).

The steps are the JAX package's: reflect pad, explicit frames gathered at
the hop, a hann window of n_fft + 1 samples with the last dropped, `rfft`,
power, the final frame dropped, the slaney mel filterbank as a matmul,
log10 clamped to max − 8, then (x + 4) / 4. The framing is written out
(not `torch.stft`, whose framing and window differ), so both packages see
the same frames. The filterbank is numpy, built once per shape.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_MELS = 80


def _hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above): whisper's filterbank."""
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log_step = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), m * (200.0 / 3))


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular filterbank."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def hann(n_fft: int, device=None) -> torch.Tensor:
    """The periodic hann window the JAX package uses: np.hanning(n_fft + 1)
    without its last sample, f32."""
    return torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def frames(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., T] → [..., 1 + (T − n_fft) // hop, n_fft]: the frames at the hop."""
    n = 1 + (x.shape[-1] - n_fft) // hop
    idx = (torch.arange(n, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :])
    return x[..., idx]


def log_mel_spectrogram(audio, n_mels: int = N_MELS, n_fft: int = N_FFT,
                        hop: int = HOP, device=None) -> torch.Tensor:
    """Whisper-style log-mel of 16 kHz samples: [n_frames, n_mels] f32 on
    `device` (the samples' own device when they are a tensor, else the
    CPU)."""
    x = torch.as_tensor(np.asarray(audio, np.float32) if not torch.is_tensor(audio) else audio,
                        dtype=torch.float32, device=device)
    pad = n_fft // 2
    x = torch.nn.functional.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    # whisper drops the final frame (center framing, then a trim)
    logmel = log10_mel(x, n_mels, n_fft, hop)[:-1]
    return scale_log_mel(logmel, logmel.max())


def log10_mel(x: torch.Tensor, n_mels: int = N_MELS, n_fft: int = N_FFT,
              hop: int = HOP) -> torch.Tensor:
    """The frames of an already padded signal → log10 of their mel power
    (floored at 1e-10), [n_frames, n_mels], before the clamp."""
    spec = torch.fft.rfft(frames(x, n_fft, hop) * hann(n_fft, x.device), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2  # [n_frames, n_freqs]
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(x.device)
    return torch.log10(torch.clamp(power @ fb.T, min=1e-10))


def scale_log_mel(logmel: torch.Tensor, peak: torch.Tensor | float) -> torch.Tensor:
    """log10 mel → features: clamped to the signal's peak − 8, then (x + 4) / 4."""
    return (torch.maximum(logmel, torch.as_tensor(peak, device=logmel.device) - 8.0)
            + 4.0) / 4.0
