"""Resident engines for the audio modalities: speech to text (whisper),
TTS (the acoustic model + Griffin-Lim, or a VITS voice) and VAD
(localai_tpu/engine/audio_engine.py).

No loop thread: each call runs under the engine's lock. The engines keep
the lifecycle surface the model manager reads of every engine (`start`,
`stop`, `cancel_all`, `metrics`, `drop_device_state`, `is_dead` always
False, an empty `postmortem_path`, no `journal`), so supervision, /system
and eviction treat them as any other. Not ported yet: MusicgenEngine
(ROADMAP Queue A item 13 (e)).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from localai_tpu_torch.models import tts as tts_model
from localai_tpu_torch.models import whisper as whisper_model


class _BaseAudioEngine:
    is_dead = False  # no loop to die
    postmortem_path = ""
    journal = None

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.m_requests = 0
        self.m_audio_seconds = 0.0
        self._busy_time = 0.0
        self.params: Any = None

    def start(self) -> None:  # resident once constructed
        pass

    def stop(self) -> None:
        pass

    def cancel_all(self) -> int:
        return 0

    def drop_device_state(self) -> None:
        """Drop the weights, so their memory returns to the allocator now."""
        with self._lock:
            self.params = None

    def _params(self):
        if self.params is None:
            raise RuntimeError("model was unloaded")
        return self.params

    def metrics(self) -> dict[str, float]:
        return {"requests": float(self.m_requests),
                "audio_seconds_processed": self.m_audio_seconds,
                "busy_seconds": self._busy_time}


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class WhisperEngine(_BaseAudioEngine):
    """Chunked transcription on one resident whisper model: an utterance
    is cut into fixed chunks of 2·n_audio_ctx mel frames (whisper's 30 s
    window for published checkpoints) and every chunk decodes in one
    batched `transcribe_greedy`, MAX_NEW_TOKENS steps, read back once. On
    the card the engine keeps each chunk count's buffers and its encoder
    and decoder-step graphs (whisper.GreedyGraphs) for the next request of
    that count."""

    MAX_NEW_TOKENS = 192

    def __init__(self, cfg: whisper_model.WhisperConfig, params: Any, tokenizer=None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.device = _device_of(params)
        self.tokenizer = tokenizer  # an HF WhisperTokenizer, or None (byte fallback)
        self.graphs = whisper_model.GreedyGraphs()

    @property
    def chunk_samples(self) -> int:
        from localai_tpu_torch.audio.features import HOP

        return 2 * self.cfg.n_audio_ctx * HOP

    def _prompt_ids(self, language: Optional[str], translate: bool) -> list[int]:
        cfg = self.cfg
        lang_id = cfg.first_lang_id
        if language and self.tokenizer is not None:
            tok = self.tokenizer.convert_tokens_to_ids(f"<|{language}|>")
            if tok is not None and tok >= 0:
                lang_id = tok
        task = cfg.translate_id if translate else cfg.transcribe_id
        return [cfg.sot_id, lang_id, task, cfg.no_timestamps_id]

    def decode_tokens(self, ids: list[int]) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids, skip_special_tokens=True)
        return "".join(chr(t) for t in ids if 32 <= t < 127)  # printable-byte identity

    def mels(self, audio: np.ndarray) -> torch.Tensor:
        """[n_chunks, 2·n_audio_ctx, n_mels] log-mel of 16 kHz samples, zero
        padded to whole chunks, on the engine's device."""
        from localai_tpu_torch.audio.features import log_mel_spectrogram

        cs = self.chunk_samples
        n_chunks = max(1, -(-len(audio) // cs))
        padded = np.zeros((n_chunks * cs,), np.float32)
        padded[: len(audio)] = audio
        x = torch.from_numpy(padded).to(self.device)
        frames = 2 * self.cfg.n_audio_ctx
        return torch.stack([log_mel_spectrogram(x[c * cs: (c + 1) * cs], n_mels=self.cfg.n_mels)
                            [:frames] for c in range(n_chunks)])

    def transcribe(self, audio: np.ndarray, language: Optional[str] = None,
                   translate: bool = False) -> dict:
        """16 kHz f32 samples → {text, segments (one a chunk), language,
        duration}, the JAX engine's answer."""
        t0 = time.monotonic()
        cs = self.chunk_samples
        with self._lock:
            params = self._params()
            mel = self.mels(audio)
            toks, n_valid = whisper_model.transcribe_greedy(
                self.cfg, params, mel, self._prompt_ids(language, translate),
                self.MAX_NEW_TOKENS, graphs=self.graphs)
            toks, n_valid = toks.cpu().numpy(), n_valid.cpu().numpy()
        segments, texts = [], []
        chunk_s = cs / 16000.0
        for c in range(mel.shape[0]):
            ids = [int(t) for t in toks[c, : int(n_valid[c])]]
            text = self.decode_tokens(ids).strip()
            texts.append(text)
            segments.append({"id": c, "start": c * chunk_s,
                             "end": min(len(audio) / 16000.0, (c + 1) * chunk_s),
                             "text": text, "tokens": ids})
        self.m_requests += 1
        self.m_audio_seconds += len(audio) / 16000.0
        self._busy_time += time.monotonic() - t0
        return {"text": " ".join(t for t in texts if t).strip(), "segments": segments,
                "language": language or "en", "duration": len(audio) / 16000.0}

    def drop_device_state(self) -> None:
        with self._lock:
            self.params = None
            self.graphs.clear()

    def metrics(self) -> dict[str, float]:
        return dict(super().metrics(), graph_captures=float(self.graphs.captures),
                    graph_replays=float(self.graphs.replays))


class TTSEngine(_BaseAudioEngine):
    """Text → waveform on one resident acoustic model + Griffin-Lim."""

    def __init__(self, cfg: tts_model.TTSConfig, params: Any, voices: Optional[list[str]] = None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.device = _device_of(params)
        self.voices = voices or [f"voice-{i}" for i in range(cfg.n_voices)]

    def voice_id(self, voice: Optional[str]) -> int:
        if not voice:
            return 0
        if voice in self.voices:
            return self.voices.index(voice) % self.cfg.n_voices
        try:
            return int(voice) % self.cfg.n_voices
        except ValueError:
            return 0

    def _chunks(self, text: str) -> list[bytes]:
        data = text.encode("utf-8")[: self.cfg.max_text * 16] or b" "
        return [data[i: i + self.cfg.max_text] for i in range(0, len(data), self.cfg.max_text)]

    def _one(self, chunk: bytes, vid: int) -> np.ndarray:
        ids = np.zeros((self.cfg.max_text,), np.int64)
        ids[: len(chunk)] = np.frombuffer(chunk, np.uint8)
        audio, n = tts_model.synthesize(self.cfg, self._params(),
                                        torch.from_numpy(ids).to(self.device), len(chunk), vid)
        return audio[: int(n)].cpu().numpy()

    def synthesize_stream(self, text: str, voice: Optional[str] = None):
        """Float32 sample chunks, one a text chunk of max_text bytes: the
        first audio arrives after one chunk's synthesis."""
        vid = self.voice_id(voice)
        for chunk in self._chunks(text):
            with self._lock:
                samples = self._one(chunk, vid)
            self.m_audio_seconds += len(samples) / self.cfg.sample_rate
            yield samples
        self.m_requests += 1

    def synthesize(self, text: str, voice: Optional[str] = None) -> tuple[np.ndarray, int]:
        """(float32 samples, sample rate); long text is cut at max_text bytes
        and the waveforms concatenated."""
        t0 = time.monotonic()
        vid = self.voice_id(voice)
        with self._lock:
            outs = [self._one(chunk, vid) for chunk in self._chunks(text)]
        wav = np.concatenate(outs) if outs else np.zeros((1,), np.float32)
        self.m_requests += 1
        self.m_audio_seconds += len(wav) / self.cfg.sample_rate
        self._busy_time += time.monotonic() - t0
        return wav, self.cfg.sample_rate


class VitsEngine(_BaseAudioEngine):
    """Text → waveform on a published VITS voice (models/vits.py), with
    TTSEngine's synthesize interface. Token and frame counts round up to
    fixed buckets (the model masks the padding by n_tokens). The noise is
    drawn from a CPU torch generator seeded by a per-engine request count
    (the JAX engine draws from jax.random keys of the same count)."""

    TOKEN_BUCKETS = (64, 256, 1024)
    FRAME_BUCKETS = (256, 1024, 4096)
    FRAMES_PER_TOKEN = 16  # a generous upper estimate that picks the frame bucket

    def __init__(self, cfg, params, tokenizer, voices: Optional[list[str]] = None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.device = _device_of(params)
        self.tokenizer = tokenizer
        self.voices = voices or ["default"]
        self._seed = 0

    @property
    def sample_rate(self) -> int:
        return self.cfg.sampling_rate

    def buckets(self, n_ids: int, rate: float) -> tuple[int, int]:
        """(token bucket, frame bucket) of a text of n_ids tokens; past the
        tables, whole multiples of the largest bucket (never a cap that
        would cut long text)."""
        tb = next((b for b in self.TOKEN_BUCKETS if b >= n_ids),
                  -(-n_ids // self.TOKEN_BUCKETS[-1]) * self.TOKEN_BUCKETS[-1])
        want = int(self.FRAMES_PER_TOKEN * n_ids / max(rate, 0.25))
        frames = next((b for b in self.FRAME_BUCKETS if b >= want),
                      -(-want // self.FRAME_BUCKETS[-1]) * self.FRAME_BUCKETS[-1])
        return tb, frames

    def noise(self, seed: int, tokens: int, frames: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The request's noise on the host: duration noise [1, 2, tokens]
        and prior noise [1, frames, flow_size], standard normals from a CPU
        generator seeded `seed`, scaled by the config's noise scales."""
        gen = torch.Generator().manual_seed(seed)
        dur = torch.randn((1, 2, tokens), generator=gen) * self.cfg.noise_scale_duration
        prior = torch.randn((1, frames, self.cfg.flow_size), generator=gen) * self.cfg.noise_scale
        return dur, prior

    def synthesize(self, text: str, voice: Optional[str] = None,
                   speaking_rate: Optional[float] = None) -> tuple[np.ndarray, int]:
        from localai_tpu_torch.models import vits as vits_model

        t0 = time.monotonic()
        ids = self.tokenizer.encode(text or " ")
        rate = float(speaking_rate or self.cfg.speaking_rate)
        tb, frames = self.buckets(len(ids), rate)
        padded = torch.zeros((1, tb), dtype=torch.int64)
        padded[0, : len(ids)] = torch.tensor(ids)
        with self._lock:
            params = self._params()
            self._seed += 1
            dur_noise, prior_noise = self.noise(self._seed, tb, frames)
            wav, n = vits_model.synthesize(
                self.cfg, params, padded.to(self.device), frames, dur_noise.to(self.device),
                prior_noise.to(self.device), speaking_rate=rate,
                n_tokens=torch.tensor([len(ids)], device=self.device))
            samples = wav[0, : int(n[0])].float().cpu().numpy()
        self.m_requests += 1
        self.m_audio_seconds += len(samples) / self.sample_rate
        self._busy_time += time.monotonic() - t0
        return samples, self.sample_rate

    def synthesize_stream(self, text: str, voice: Optional[str] = None):
        """Sentence-chunked streaming: the first audio after the first clause."""
        parts = [p for p in re.split(r"(?<=[.!?;:\n])\s+", text or " ") if p.strip()]
        for part in parts or [" "]:
            samples, _sr = self.synthesize(part, voice)
            yield samples


class VADEngine(_BaseAudioEngine):
    """Voice-activity detection: the learned conv + GRU net
    (audio/learned_vad.py) with weights, else the weightless energy
    detector (audio/vad.py)."""

    def __init__(self, vad_cfg=None, params: Optional[Any] = None) -> None:
        super().__init__()
        self.vad_cfg = vad_cfg
        self.params = params if params is not None else {}

    def detect(self, audio: np.ndarray, sample_rate: int = 16_000) -> list[dict]:
        t0 = time.monotonic()
        with self._lock:
            if self.vad_cfg is not None and self.params:
                from localai_tpu_torch.audio.learned_vad import detect as learned_detect

                segs = learned_detect(self.vad_cfg, self.params, audio, sample_rate)
            else:
                from localai_tpu_torch.audio.vad import energy_vad

                segs = energy_vad(audio, sample_rate)
        self.m_requests += 1
        self.m_audio_seconds += len(audio) / sample_rate
        self._busy_time += time.monotonic() - t0
        return [{"start": s.start, "end": s.end} for s in segs]

    def push(self, stream, samples: np.ndarray):
        """A StreamingDetector's segments after `samples` were appended to its
        buffer, on this engine's net; None without a net (the energy
        detector needs the whole buffer)."""
        if self.vad_cfg is None or not self.params:
            return None
        t0 = time.monotonic()
        with self._lock:
            segs = stream.push(self.vad_cfg, self._params(), samples)
        self.m_audio_seconds += len(samples) / stream.sample_rate
        self._busy_time += time.monotonic() - t0
        return segs
