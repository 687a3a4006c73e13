"""Formant speech synthesis: the VAD training corpus generator, a copy of
the JAX package's localai_tpu/audio/formant_speech.py (numpy only). The
port serves no trainer; its tests and chip_smoke.py make speech-like
input with it.

The reference ships silero-vad's published weights (backend/go/silero-vad/
vad.go:13-33), trained on thousands of hours of real speech. This build
environment has zero egress — no corpus, no checkpoints — so the learned
VAD (audio/learned_vad.py) trains on SYNTHESIZED speech instead. For that
to transfer, the synthesizer must reproduce what makes speech *speech* to a
mel-frontend model, which simple harmonic bursts (the r3 trainer) do not:

  * a glottal pulse train with jitter/shimmer and a declining F0 contour;
  * vowel FORMANT resonances (second-order IIR resonators at F1-F3 from a
    phonetic table, with coarticulation glides between adjacent vowels);
  * consonants: fricative noise shaped into sibilant/non-sibilant bands,
    plosives as silence-gap + release burst, nasals as low-passed voicing;
  * syllabic rhythm (3-8 Hz), word pauses INSIDE an utterance (labelled
    non-speech), per-syllable stress, speaker-dependent pitch ranges;
  * realistic negatives: white/pink noise, 50/60 Hz hum with harmonics,
    music-like sustained chords, DTMF-ish tones, impulsive clicks, and
    babble built from overlapping attenuated utterances.

Everything is numpy + scipy.signal.lfilter; sample-accurate speech labels
come back with the audio so mel-frame targets are exact.
"""

from __future__ import annotations

import numpy as np

SR = 16_000

# (F1, F2, F3) Hz — classic vowel formant chart values.
VOWELS = {
    "a": (800, 1200, 2500),
    "e": (500, 1900, 2500),
    "i": (300, 2300, 3000),
    "o": (450, 800, 2600),
    "u": (325, 700, 2530),
    "@": (500, 1500, 2500),  # schwa
    "ae": (700, 1700, 2600),
}
_VOWEL_LIST = list(VOWELS.values())
_BANDWIDTHS = (60.0, 90.0, 120.0)


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int = SR) -> np.ndarray:
    """Second-order IIR formant resonator (Klatt-style)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    b = [1 - 2 * r * np.cos(theta) + r * r]
    return lfilter(b, a, x).astype(np.float32)


def _glottal_source(n: int, f0_curve: np.ndarray, rng, sr: int = SR) -> np.ndarray:
    """Pulse train at the (time-varying) pitch with jitter + shimmer, plus a
    touch of aspiration noise."""
    phase = np.cumsum(f0_curve / sr)
    # jitter: per-cycle pitch perturbation via phase noise
    phase = phase + np.cumsum(rng.normal(0, 0.0008, n))
    saw = (phase % 1.0).astype(np.float32)
    # Rosenberg-ish pulse: asymmetric rise/fall from the phase ramp
    pulse = np.where(saw < 0.6, np.sin(np.pi * saw / 0.6) ** 2, 0.0)
    # differentiate (radiation characteristic) and add shimmer
    src = np.diff(pulse, prepend=pulse[:1]).astype(np.float32)
    shimmer = 1.0 + 0.08 * rng.standard_normal(n).astype(np.float32)
    asp = rng.normal(0, 0.01, n).astype(np.float32)
    return src * shimmer + asp


def _fricative(n: int, rng, sibilant: bool, sr: int = SR) -> np.ndarray:
    if n <= 0:
        return np.zeros(0, np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    lo, hi = (3500, 7500) if sibilant else (1500, 4000)
    x = _resonator(noise, (lo + hi) / 2, hi - lo, sr)
    return x / (np.abs(x).max() + 1e-6)


def synth_utterance(
    rng: np.random.Generator,
    seconds: float = 2.0,
    sr: int = SR,
) -> tuple[np.ndarray, np.ndarray]:
    """One speaker saying a few 'words' → (audio [n], speech label [n]).

    Words are syllable strings (optional consonant onset + vowel nucleus);
    inter-word pauses are labelled 0 so the net learns utterance-internal
    silence, not just leading/trailing quiet.
    """
    n = int(seconds * sr)
    audio = np.zeros(n, np.float32)
    label = np.zeros(n, np.float32)

    f0_base = rng.uniform(85, 255)  # speaker pitch
    pos = int(rng.uniform(0.0, 0.25) * n)
    while pos < n - sr // 5:
        # one word: 1-4 syllables
        n_syll = int(rng.integers(1, 5))
        word_start = pos
        prev_vowel = None
        for _ in range(n_syll):
            # optional consonant onset
            c_kind = rng.choice(["none", "fric", "plosive", "nasal"],
                                p=[0.25, 0.3, 0.3, 0.15])
            if c_kind == "fric":
                d = int(rng.uniform(0.05, 0.12) * sr)
                e = min(n, pos + d)
                if e > pos:
                    seg = _fricative(e - pos, rng, bool(rng.integers(0, 2)), sr)
                    audio[pos:e] += 0.25 * rng.uniform(0.5, 1.0) * seg
                    label[pos:e] = 1.0
                pos = e
            elif c_kind == "plosive":
                gap = int(rng.uniform(0.02, 0.05) * sr)  # closure (silence)
                pos = min(n, pos + gap)
                d = int(rng.uniform(0.01, 0.03) * sr)
                e = min(n, pos + d)
                if e > pos:
                    burst = _fricative(e - pos, rng, bool(rng.integers(0, 2)), sr)
                    audio[pos:e] += 0.35 * burst
                    label[pos:e] = 1.0
                pos = e
            elif c_kind == "nasal":
                d = int(rng.uniform(0.04, 0.09) * sr)
                e = min(n, pos + d)
                if e > pos:
                    f0c = np.full(e - pos, f0_base * rng.uniform(0.9, 1.1), np.float32)
                    seg = _resonator(_glottal_source(e - pos, f0c, rng, sr), 280, 120, sr)
                    audio[pos:e] += 0.3 * seg / (np.abs(seg).max() + 1e-6)
                    label[pos:e] = 1.0
                pos = e
            if pos >= n:
                break
            # vowel nucleus with formant glide from the previous vowel
            d = int(rng.uniform(0.07, 0.22) * sr)
            e = min(n, pos + d)
            m = e - pos
            if m <= 8:
                break
            vowel = _VOWEL_LIST[int(rng.integers(0, len(_VOWEL_LIST)))]
            t = np.arange(m) / sr
            # F0: declination + slow wander
            f0c = f0_base * (1.0 - 0.12 * (pos / n)) * (
                1.0 + 0.06 * np.sin(2 * np.pi * rng.uniform(2, 5) * t
                                    + rng.uniform(0, 6.28))
            )
            src = _glottal_source(m, f0c.astype(np.float32), rng, sr)
            seg = np.zeros(m, np.float32)
            glide = min(m, int(0.04 * sr))
            for fi, (f, bw) in enumerate(zip(vowel, _BANDWIDTHS)):
                if prev_vowel is not None and glide > 4:
                    # coarticulation: resonate the glide at the midpoint
                    fmid = (prev_vowel[fi] + f) / 2
                    head = _resonator(src[:glide], fmid, bw * 1.5, sr)
                    tail = _resonator(src, f, bw, sr)[glide:]
                    seg += np.concatenate([head, tail])
                else:
                    seg += _resonator(src, f, bw, sr)
            stress = rng.uniform(0.35, 1.0)
            env = np.minimum(1.0, np.minimum(np.arange(m), m - np.arange(m))
                             / max(1, int(0.012 * sr))).astype(np.float32)
            audio[pos:e] += stress * env * seg / (np.abs(seg).max() + 1e-6)
            label[pos:e] = 1.0
            prev_vowel = vowel
            pos = e
            if pos >= n:
                break
        # word gap — em-dash pause, labelled silence
        if rng.uniform() < 0.25 and pos - word_start > int(0.1 * sr):
            pos += int(rng.uniform(0.25, 0.6) * sr)  # long pause
        else:
            pos += int(rng.uniform(0.04, 0.15) * sr)
    peak = np.abs(audio).max()
    if peak > 1e-6:
        audio = 0.5 * audio / peak
    return audio, label


def synth_negative(rng: np.random.Generator, seconds: float = 2.0,
                   sr: int = SR) -> np.ndarray:
    """Hard non-speech: what an energy detector false-triggers on."""
    n = int(seconds * sr)
    kind = rng.choice(["tones", "chord", "hum", "clicks", "noise_burst"])
    t = np.arange(n) / sr
    if kind == "tones":  # DTMF-ish dual tones keyed on/off
        audio = np.zeros(n, np.float32)
        pos = 0
        while pos < n:
            d = int(rng.uniform(0.1, 0.4) * sr)
            e = min(n, pos + d)
            f1, f2 = rng.uniform(600, 1000), rng.uniform(1200, 1700)
            audio[pos:e] = 0.3 * (np.sin(2 * np.pi * f1 * t[: e - pos])
                                  + np.sin(2 * np.pi * f2 * t[: e - pos]))
            pos = e + int(rng.uniform(0.05, 0.3) * sr)
        return audio
    if kind == "chord":  # sustained music-like chord with vibrato
        root = rng.uniform(110, 440)
        audio = sum(
            (0.2 / (i + 1)) * np.sin(2 * np.pi * root * r * t
                                     * (1 + 0.002 * np.sin(2 * np.pi * 5.5 * t)))
            for i, r in enumerate((1.0, 1.25, 1.5, 2.0))
        )
        return (audio * rng.uniform(0.3, 0.9)).astype(np.float32)
    if kind == "hum":  # mains hum + harmonics
        base = rng.choice([50.0, 60.0])
        audio = sum((0.3 / h) * np.sin(2 * np.pi * base * h * t)
                    for h in range(1, 6))
        return audio.astype(np.float32)
    if kind == "clicks":
        audio = rng.normal(0, 0.01, n).astype(np.float32)
        for _ in range(int(rng.integers(3, 10))):
            p = int(rng.uniform(0, 0.95) * n)
            audio[p: p + 40] += rng.uniform(0.3, 0.8) * rng.standard_normal(40)
        return audio
    # shaped noise bursts
    audio = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        d = int(rng.uniform(0.1, 0.5) * sr)
        e = min(n, pos + d)
        audio[pos:e] = _resonator(rng.standard_normal(e - pos).astype(np.float32),
                                  rng.uniform(200, 4000), 800, sr)
        audio[pos:e] *= 0.2 / (np.abs(audio[pos:e]).max() + 1e-6)
        pos = e + int(rng.uniform(0.1, 0.4) * sr)
    return audio


def _background(rng: np.random.Generator, n: int, sr: int = SR) -> np.ndarray:
    """Noise floor: white / pink / babble / hum."""
    kind = rng.choice(["white", "pink", "babble", "hum", "silenceish"])
    if kind == "white":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "pink":
        white = rng.standard_normal(n + 1024).astype(np.float32)
        spec = np.fft.rfft(white)
        spec /= np.maximum(np.sqrt(np.arange(len(spec)) + 1.0), 1.0)
        return np.fft.irfft(spec)[:n].astype(np.float32)
    if kind == "babble":
        acc = np.zeros(n, np.float32)
        for _ in range(4):
            a, _l = synth_utterance(rng, n / sr, sr)
            shift = int(rng.uniform(0, 0.3) * n)
            acc += np.roll(a, shift)
        return acc
    if kind == "hum":
        t = np.arange(n) / sr
        return sum((1.0 / h) * np.sin(2 * np.pi * 50.0 * h * t)
                   for h in range(1, 4)).astype(np.float32)
    return rng.normal(0, 0.2, n).astype(np.float32)


def corpus_batch(
    rng: np.random.Generator,
    n_pos: int = 8,
    n_neg: int = 4,
    seconds: float = 2.0,
    sr: int = SR,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(audios, sample labels): utterances mixed into noise at 0-30 dB SNR,
    plus pure negatives (label all-zero)."""
    xs, ys = [], []
    n = int(seconds * sr)
    for _ in range(n_pos):
        speech, label = synth_utterance(rng, seconds, sr)
        bg = _background(rng, n, sr)
        sp_pow = float(np.mean(speech**2)) + 1e-9
        bg_pow = float(np.mean(bg**2)) + 1e-9
        snr_db = rng.uniform(0, 30)
        bg = bg * np.sqrt(sp_pow / bg_pow / (10 ** (snr_db / 10)))
        mix = speech + bg
        peak = np.abs(mix).max()
        if peak > 1.0:
            mix = mix / peak
        xs.append(mix.astype(np.float32))
        ys.append(label)
    for _ in range(n_neg):
        neg = synth_negative(rng, seconds, sr)
        lvl = rng.uniform(0.2, 1.0)
        xs.append((lvl * neg).astype(np.float32))
        ys.append(np.zeros(n, np.float32))
    return xs, ys
