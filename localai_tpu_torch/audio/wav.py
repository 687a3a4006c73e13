"""WAV read/write and PCM resampling (host side): a copy of the JAX
package's localai_tpu/audio/wav.py, which is numpy only.

Reference equivalents: pkg/sound/float32.go + resample.go (PCM conversion and
linear resampling for the realtime endpoint) and the ffmpeg shell-outs in the
whisper/audio endpoints. Here: stdlib `wave` for containers, numpy for PCM
math, polyphase resampling via scipy (baked into the image).
"""

from __future__ import annotations

import io
import wave

import numpy as np


def read_wav(data: bytes | str) -> tuple[np.ndarray, int]:
    """Decode a WAV container → (float32 mono samples in [-1, 1], sample_rate).

    Accepts bytes or a path. Multi-channel audio is averaged to mono
    (matching the reference's whisper preprocessing).
    """
    f = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else open(data, "rb")
    try:
        with wave.open(f, "rb") as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    finally:
        f.close()

    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def write_wav(samples: np.ndarray, sample_rate: int, path: str | None = None) -> bytes:
    """Encode float32 samples in [-1, 1] as 16-bit mono WAV. Returns the
    bytes; also writes to `path` when given."""
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm16.tobytes())
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample float32 audio (e.g. 44.1k → whisper's 16k)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(sr_in), int(sr_out))
    return resample_poly(np.asarray(x, np.float64), sr_out // g, sr_in // g).astype(
        np.float32
    )
