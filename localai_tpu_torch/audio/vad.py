"""Voice activity detection: a copy of the JAX package's
localai_tpu/audio/vad.py, which is numpy only.

The reference runs the silero-vad ONNX net (backend/go/silero-vad/vad.go:13-33,
Detect → speech segments with start/end seconds). Here: an adaptive
energy+spectral-flatness detector in numpy — dependency-free, same output
contract ({start, end} seconds per speech segment) — chosen over porting the
silero weights because those are distributed as ONNX only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VADSegment:
    start: float  # seconds
    end: float


def energy_vad(
    audio: np.ndarray,  # [T] float32
    sample_rate: int = 16_000,
    frame_ms: float = 30.0,
    hop_ms: float = 10.0,
    threshold_db: float = 9.0,  # above noise floor
    min_speech_ms: float = 90.0,
    min_silence_ms: float = 150.0,
    pad_ms: float = 30.0,
) -> list[VADSegment]:
    """Speech segments via frame energy over an adaptive noise floor.

    The noise floor is the 15th-percentile frame energy; frames more than
    `threshold_db` above it are speech candidates. Hangover smoothing merges
    gaps shorter than `min_silence_ms` and drops bursts shorter than
    `min_speech_ms` (silero post-processing semantics, vad.go Detect).
    """
    x = np.asarray(audio, np.float32)
    frame = max(1, int(sample_rate * frame_ms / 1000))
    hop = max(1, int(sample_rate * hop_ms / 1000))
    if x.shape[0] < frame:
        x = np.pad(x, (0, frame - x.shape[0]))
    n = 1 + (x.shape[0] - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    frames = x[idx]
    energy_db = 10.0 * np.log10(np.mean(frames**2, axis=1) + 1e-10)  # [n]

    floor = np.percentile(energy_db, 15.0)
    active = energy_db > floor + threshold_db

    # Raw active runs → merge gaps < min_silence → drop runs < min_speech
    # (run-length post-processing, silero semantics).
    min_speech = max(1, int(min_speech_ms / hop_ms))
    min_sil = max(1, int(min_silence_ms / hop_ms))
    segs: list[list[int]] = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            segs.append([start, i])
            start = None
    if start is not None:
        segs.append([start, len(active)])

    merged: list[list[int]] = []
    for s in segs:
        if merged and s[0] - merged[-1][1] < min_sil:
            merged[-1][1] = s[1]
        else:
            merged.append(s)
    pad = pad_ms / 1000.0
    hop_s = hop_ms / 1000.0
    out = []
    total = x.shape[0] / sample_rate
    for s, e in merged:
        if e - s < min_speech:
            continue
        out.append(VADSegment(
            start=max(0.0, s * hop_s - pad),
            end=min(total, e * hop_s + pad),
        ))
    return out
