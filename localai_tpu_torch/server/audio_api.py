"""Audio endpoints: transcription (STT), speech (TTS), sound generation, VAD
(localai_tpu/server/audio_api.py: the same routes, answers, formats and
errors).

/v1/sound-generation is served by a model with that use case: a tts
model's voice, as the JAX server serves it where no MusicGen engine
resolves (MusicGen itself is ROADMAP Queue A item 13 (e)).

Reference routes: core/http/endpoints/openai/transcription.go (multipart file
→ whisper), endpoints/localai/tts.go + endpoints/elevenlabs (TTS),
endpoints/localai/vad.go (silero VAD RPC). Handlers resolve the model by
usecase exactly like the text endpoints do.
"""

from __future__ import annotations

import numpy as np

from localai_tpu_torch.config import Usecase
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.manager import ModelManager
from localai_tpu_torch.server.openai_api import OpenAIApi


class AudioApi:
    def __init__(self, manager: ModelManager, base: OpenAIApi):
        self.manager = manager
        self._base = base  # reuse model resolution helpers

    def register(self, r: Router) -> None:
        r.add("POST", "/v1/audio/transcriptions", self.transcribe)
        r.add("POST", "/v1/audio/translations", self.translate)
        r.add("POST", "/v1/audio/speech", self.speech)
        r.add("POST", "/tts", self.speech)  # LocalAI native route
        r.add("POST", "/v1/audio/speech/stream", self.speech_stream)
        r.add("POST", "/tts/stream", self.speech_stream)
        # elevenlabs-compatible aliases (reference: routes/elevenlabs.go)
        r.add("POST", "/v1/text-to-speech/:voice_id", self.speech_elevenlabs)
        r.add("POST", "/v1/sound-generation", self.sound_generation)
        r.add("POST", "/vad", self.vad)
        r.add("POST", "/v1/vad", self.vad)

    # ------------------------------------------------------------------ #
    # STT
    # ------------------------------------------------------------------ #

    def _transcribe_impl(self, req: Request, translate: bool) -> Response:
        from localai_tpu_torch.audio import read_wav, resample

        form = req.form()
        if "file" not in form:
            raise ApiError(400, "missing form field 'file'")
        _fname, blob = form["file"]

        def field(name: str, default: str = "") -> str:
            if name in form:
                return form[name][1].decode("utf-8", "replace").strip()
            return default

        model = field("model")
        language = field("language") or None
        response_format = field("response_format", "json")

        try:
            audio, sr = read_wav(blob)
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"could not decode audio file (WAV required): {e}") from None
        audio = resample(audio, sr, 16_000)

        fake = Request(
            method=req.method, path=req.path, params=req.params, query=req.query,
            headers=req.headers, body={"model": model} if model else {},
        )
        lm, lease = self._base._resolve(fake, Usecase.TRANSCRIPT)
        try:
            result = lm.engine.transcribe(audio, language=language, translate=translate)
        finally:
            lease.release()

        if response_format == "text":
            return Response(body=result["text"], content_type="text/plain; charset=utf-8")
        if response_format == "verbose_json":
            return Response(body={
                "task": "translate" if translate else "transcribe",
                "language": result["language"],
                "duration": result["duration"],
                "text": result["text"],
                "segments": result["segments"],
            })
        return Response(body={"text": result["text"], "segments": result["segments"]})

    def transcribe(self, req: Request) -> Response:
        return self._transcribe_impl(req, translate=False)

    def translate(self, req: Request) -> Response:
        return self._transcribe_impl(req, translate=True)

    # ------------------------------------------------------------------ #
    # TTS / sound generation
    # ------------------------------------------------------------------ #

    def _tts_impl(self, req: Request, usecase: Usecase) -> Response:
        from localai_tpu_torch.audio import write_wav

        body = req.body or {}
        text = body.get("input") or body.get("text")
        if not text or not isinstance(text, str):
            raise ApiError(400, "input text is required")
        fmt = (body.get("response_format") or "wav").lower()
        if fmt not in ("wav", "pcm"):
            raise ApiError(400, f"response_format {fmt!r} not supported (wav, pcm)")

        lm, lease = self._base._resolve(req, usecase)
        try:
            samples, sr = lm.engine.synthesize(text, voice=body.get("voice"))
        finally:
            lease.release()
        if fmt == "pcm":
            pcm16 = (np.clip(samples, -1, 1) * 32767.0).astype(np.int16)
            return Response(body=pcm16.tobytes(), content_type="audio/pcm",
                            headers={"X-Sample-Rate": str(sr)})
        return Response(body=write_wav(samples, sr), content_type="audio/wav")

    def speech(self, req: Request) -> Response:
        return self._tts_impl(req, Usecase.TTS)

    def speech_elevenlabs(self, req: Request) -> Response:
        """elevenlabs contract: voice in the route, text in body `text`."""
        body = dict(req.body or {})
        body.setdefault("voice", req.params.get("voice_id"))
        patched = Request(
            method=req.method, path=req.path, params=req.params,
            query=req.query, headers=req.headers, body=body,
        )
        return self._tts_impl(patched, Usecase.TTS)

    def speech_stream(self, req: Request):
        """Chunked streaming TTS: WAV header + PCM chunks as each text
        segment is synthesized (reference: TTSStreamEndpoint)."""
        import struct

        from localai_tpu_torch.server.app import RawStream

        body = req.body or {}
        text = body.get("input") or body.get("text")
        if not text or not isinstance(text, str):
            raise ApiError(400, "input text is required")
        lm, lease = self._base._resolve(req, Usecase.TTS)
        sr = lm.engine.cfg.sample_rate

        def chunks():
            try:
                # Streaming WAV: RIFF/data sizes set to the unknown-length
                # sentinel (players and ffmpeg accept this for live streams).
                hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                       + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                       + b"data" + struct.pack("<I", 0xFFFFFFFF))
                yield hdr
                for samples in lm.engine.synthesize_stream(text, voice=body.get("voice")):
                    pcm16 = (np.clip(samples, -1, 1) * 32767.0).astype(np.int16)
                    yield pcm16.tobytes()
            finally:
                lease.release()

        return RawStream(chunks(), content_type="audio/wav")

    def sound_generation(self, req: Request) -> Response:
        """Prompt → audio, ElevenLabs-shaped like the reference (text,
        model_id, duration_seconds, prompt_influence, do_sample, seed):
        the JAX server's validation and errors, then the resolved model's
        voice synthesizes the text (no MusicGen engine here; ROADMAP Queue
        A item 13 (e))."""
        from localai_tpu_torch.audio import write_wav

        body = dict(req.body or {})
        text = body.get("text") or body.get("input")
        if not text or not isinstance(text, str):
            raise ApiError(400, "text is required")
        fmt = (body.get("response_format") or "wav").lower()
        if fmt not in ("wav", "pcm"):
            raise ApiError(400, f"response_format {fmt!r} not supported (wav, pcm)")
        if body.get("model_id") and not body.get("model"):
            body["model"] = body["model_id"]
        if body.get("seed") is not None:
            try:
                int(body["seed"])
            except (TypeError, ValueError):
                raise ApiError(400, "seed must be an integer") from None
        patched = Request(
            method=req.method, path=req.path, params=req.params,
            query=req.query, headers=req.headers, body=body,
        )
        lm, lease = self._base._resolve(patched, Usecase.SOUND_GENERATION)
        try:
            samples, sr = lm.engine.synthesize(text, voice=body.get("voice"))
        finally:
            lease.release()
        if fmt == "pcm":
            pcm16 = (np.clip(samples, -1, 1) * 32767.0).astype(np.int16)
            return Response(body=pcm16.tobytes(), content_type="audio/pcm",
                            headers={"X-Sample-Rate": str(sr)})
        return Response(body=write_wav(samples, sr), content_type="audio/wav")

    # ------------------------------------------------------------------ #
    # VAD
    # ------------------------------------------------------------------ #

    def vad(self, req: Request) -> Response:
        body = req.body or {}
        audio = body.get("audio")
        if not isinstance(audio, list) or not audio:
            raise ApiError(400, "audio must be a non-empty array of float samples")
        sr = int(body.get("sample_rate") or 16_000)
        x = np.asarray(audio, np.float32)

        lm, lease = self._base._resolve(req, Usecase.VAD)
        try:
            segments = lm.engine.detect(x, sr)
        finally:
            lease.release()
        return Response(body={"segments": segments})
