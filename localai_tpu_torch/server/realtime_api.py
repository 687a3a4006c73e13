"""OpenAI-realtime-compatible voice WebSocket (localai_tpu/server/realtime_api.py:
the same events, in the same order).

Reference: core/http/endpoints/openai/realtime.go (1,301 LoC; session event
loop over a websocket: audio in → transcription → LLM → TTS audio out) and
its types file. The same protocol subset on the port: whisper for STT, the
llama engine for the turn (B1 at admission, B2 in the decode graphs), the
TTS engine for audio out, each resolved through the same ModelManager
usecases as the REST routes.

Supported client events: session.update, input_audio_buffer.append /
commit / clear, conversation.item.create, response.create, response.cancel.
Server events mirror OpenAI's: session.created/updated, committed,
item.created, response.created, response.audio_transcript.delta,
response.text.delta, response.audio.delta, response.done, error.
"""

from __future__ import annotations

import base64
import collections
import logging
import time
import uuid
from typing import Any, Optional

import numpy as np

from localai_tpu_torch.config import Usecase
from localai_tpu_torch.server.app import Request, Router
from localai_tpu_torch.server.manager import ModelManager
from localai_tpu_torch.server.openai_api import OpenAIApi
from localai_tpu_torch.server.ws import WebSocket, WebSocketUpgrade

log = logging.getLogger("localai_tpu_torch.realtime")


def _rid(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:20]}"


class RealtimeSession:
    def __init__(self, api: "RealtimeApi", query_model: Optional[str]):
        self.api = api
        self.config: dict[str, Any] = {
            "id": _rid("sess"),
            "model": query_model or "",
            "modalities": ["text", "audio"],
            "instructions": "",
            "voice": "",
            "input_audio_format": "pcm16",
            "output_audio_format": "pcm16",
            "input_sample_rate": 24_000,
            "output_sample_rate": 24_000,
            "temperature": 0.7,
            "max_response_output_tokens": 512,
            # {"type": "server_vad", "silence_duration_ms": 500} enables
            # automatic turn detection (reference: realtime.go server VAD
            # via silero; here the learned net, _vad_segments).
            "turn_detection": None,
            "transcription_model": None,
            "tts_model": None,
        }
        self.conversation: list[dict[str, str]] = []
        self.audio_buffer = bytearray()
        self._speech_started = False
        self._vad = None  # the buffer's StreamingDetector, made at the first append
        self._vad_fed = 0  # buffer samples it has been given

    # ------------------------------------------------------------------ #

    def run(self, ws: WebSocket) -> None:
        ws.send_json({"type": "session.created", "session": self.config})
        while True:
            ev = ws.recv_json()
            if ev is None:
                return
            try:
                self.handle(ws, ev)
            except Exception as e:  # noqa: BLE001 — error event, keep session
                log.exception("realtime event failed")
                ws.send_json({"type": "error", "error": {
                    "type": "server_error", "message": f"{type(e).__name__}: {e}",
                }})

    def handle(self, ws: WebSocket, ev: dict) -> None:
        kind = ev.get("type")
        if kind == "session.update":
            patch = ev.get("session") or {}
            for k, v in patch.items():
                if k in self.config and k != "id":
                    self.config[k] = v
            ws.send_json({"type": "session.updated", "session": self.config})
        elif kind == "input_audio_buffer.append":
            self.audio_buffer.extend(base64.b64decode(ev.get("audio") or ""))
            self._maybe_auto_commit(ws)
        elif kind == "input_audio_buffer.clear":
            self.audio_buffer.clear()
            self._vad = None
            ws.send_json({"type": "input_audio_buffer.cleared"})
        elif kind == "input_audio_buffer.commit":
            self._commit_audio(ws)
        elif kind == "conversation.item.create":
            item = ev.get("item") or {}
            text = " ".join(
                c.get("text", "") for c in item.get("content") or []
                if c.get("type") in ("input_text", "text")
            ).strip()
            role = item.get("role", "user")
            if text:
                self.conversation.append({"role": role, "content": text})
            ws.send_json({"type": "conversation.item.created", "item": {
                "id": item.get("id") or _rid("item"), "type": "message",
                "role": role,
                "content": [{"type": "input_text", "text": text}],
            }})
        elif kind == "response.create":
            self._respond(ws, ev.get("response") or {})
        elif kind == "response.cancel":
            ws.send_json({"type": "response.cancelled"})
        else:
            ws.send_json({"type": "error", "error": {
                "type": "invalid_request_error",
                "message": f"unknown event type {kind!r}",
            }})

    # ------------------------------------------------------------------ #

    def _vad_segments(self) -> tuple[list[tuple[float, float]], float]:
        """((start, end) speech spans, seconds) of the buffer so far, at 16
        kHz. A configured vad-backend model's learned net decides (the
        learned conv+GRU net fills the silero role; reference: realtime.go
        server VAD via silero), else the shipped pretrained net. Either
        runs as a StreamingDetector that is given only the samples appended
        since the last call, so an append costs the same at any buffer
        length. A VAD model without weights, or no net at all, runs the
        energy detector over the whole buffer."""
        from localai_tpu_torch.audio import learned_vad as LV

        sr = int(self.config["input_sample_rate"])
        if self._vad is None or self._vad.sample_rate != sr:
            self._vad, self._vad_fed = LV.StreamingDetector(sr), 0
        n = len(self.audio_buffer) // 2
        new = np.frombuffer(bytes(self.audio_buffer[2 * self._vad_fed: 2 * n]),
                            np.int16).astype(np.float32) / 32768.0
        segs = None
        cfg = self.api.manager.configs.first_with(Usecase.VAD)
        if cfg is not None:
            lm, lease = self.api.manager.lease(cfg.name)
            try:
                segs = lm.engine.push(self._vad, new)
            finally:
                lease.release()
        else:
            packaged = LV.packaged_weights()
            if packaged is not None:
                if not hasattr(self.api, "_builtin_vad"):
                    params = LV.load_params(packaged, device=self.api.manager.device)
                    self.api._builtin_vad = (LV.config_from_params(params), params)
                segs = self._vad.push(*self.api._builtin_vad, new)
        self._vad_fed = n
        if segs is not None:
            return [(s.start, s.end) for s in segs], self._vad.seconds
        from localai_tpu_torch.audio import resample
        from localai_tpu_torch.audio.vad import energy_vad

        pcm = np.frombuffer(bytes(self.audio_buffer[: 2 * n]), np.int16).astype(np.float32)
        audio16 = resample(pcm / 32768.0, sr, 16_000)
        return [(s.start, s.end) for s in energy_vad(audio16, 16_000)], len(audio16) / 16_000.0

    def _maybe_auto_commit(self, ws: WebSocket) -> None:
        """Server-VAD turn detection: commit + respond once speech is
        followed by enough trailing silence. Each call's VAD time goes to
        the api's `vad_ms` record."""
        td = self.config.get("turn_detection") or {}
        if td.get("type") != "server_vad" or not self.audio_buffer:
            return
        t0 = time.perf_counter()
        segs, seconds = self._vad_segments()
        self.api.vad_ms.append((seconds, (time.perf_counter() - t0) * 1e3))
        if not segs:
            return
        if not self._speech_started:
            self._speech_started = True
            ws.send_json({"type": "input_audio_buffer.speech_started"})
        silence_s = float(td.get("silence_duration_ms", 500)) / 1000.0
        trailing = seconds - segs[-1][1]
        if trailing >= silence_s:
            ws.send_json({"type": "input_audio_buffer.speech_stopped"})
            self._speech_started = False
            self._commit_audio(ws)
            self._respond(ws, {})

    def _commit_audio(self, ws: WebSocket) -> None:
        from localai_tpu_torch.audio import resample

        item_id = _rid("item")
        if not self.audio_buffer:
            ws.send_json({"type": "error", "error": {
                "type": "invalid_request_error",
                "message": "input audio buffer is empty",
            }})
            return
        pcm = np.frombuffer(bytes(self.audio_buffer), np.int16).astype(np.float32) / 32768.0
        self.audio_buffer.clear()
        self._vad = None
        sr = int(self.config["input_sample_rate"])
        audio16 = resample(pcm, sr, 16_000)

        lm, lease = self.api._lease(Usecase.TRANSCRIPT, self.config.get("transcription_model"))
        try:
            result = lm.engine.transcribe(audio16)
        finally:
            lease.release()
        text = result["text"]
        self.conversation.append({"role": "user", "content": text})
        ws.send_json({"type": "input_audio_buffer.committed", "item_id": item_id})
        ws.send_json({"type": "conversation.item.created", "item": {
            "id": item_id, "type": "message", "role": "user",
            "content": [{"type": "input_audio", "transcript": text}],
        }})

    def _respond(self, ws: WebSocket, overrides: dict) -> None:
        from localai_tpu_torch.engine.engine import GenRequest

        resp_id = _rid("resp")
        modalities = overrides.get("modalities") or self.config["modalities"]
        instructions = overrides.get("instructions") or self.config["instructions"]
        ws.send_json({"type": "response.created", "response": {"id": resp_id}})

        messages = []
        if instructions:
            messages.append({"role": "system", "content": instructions})
        messages.extend(self.conversation)
        if not messages:
            messages = [{"role": "user", "content": ""}]

        lm, lease = self.api._lease(Usecase.CHAT, self.config.get("model") or None)
        try:
            prompt = lm.evaluator.template_messages(messages)
            ids = lm.engine.tokenizer.encode(
                prompt, add_bos=not lm.cfg.template.use_tokenizer_template
            )
            gen = GenRequest(
                prompt_ids=ids,
                max_new_tokens=int(self.config["max_response_output_tokens"]),
                temperature=float(self.config["temperature"]),
                stop=lm.evaluator.stop_sequences(),
            )
            handle = lm.engine.submit(gen)
            parts: list[str] = []
            delta_type = (
                "response.audio_transcript.delta"
                if "audio" in modalities else "response.text.delta"
            )
            for tev in handle:
                if tev.kind == "token":
                    parts.append(tev.text)
                    ws.send_json({
                        "type": delta_type, "response_id": resp_id,
                        "delta": tev.text,
                    })
                elif tev.kind == "error":
                    ws.send_json({"type": "error", "error": {
                        "type": "server_error", "message": tev.error,
                    }})
                    return
        finally:
            lease.release()
        text = "".join(parts)
        self.conversation.append({"role": "assistant", "content": text})

        if "audio" in modalities:
            self._send_audio(ws, resp_id, text)

        ws.send_json({"type": "response.done", "response": {
            "id": resp_id, "status": "completed",
            "output": [{
                "type": "message", "role": "assistant",
                "content": [{"type": "text", "text": text}],
            }],
        }})

    def _send_audio(self, ws: WebSocket, resp_id: str, text: str) -> None:
        from localai_tpu_torch.audio import resample

        try:
            lm, lease = self.api._lease(Usecase.TTS, self.config.get("tts_model"))
        except Exception:  # noqa: BLE001 — no TTS model configured: text only
            return
        try:
            samples, sr = lm.engine.synthesize(text or " ", voice=self.config.get("voice"))
        finally:
            lease.release()
        out_sr = int(self.config["output_sample_rate"])
        pcm = resample(samples, sr, out_sr)
        pcm16 = (np.clip(pcm, -1, 1) * 32767.0).astype(np.int16).tobytes()
        chunk = out_sr * 2 // 10  # 100 ms per delta
        for off in range(0, len(pcm16), chunk):
            ws.send_json({
                "type": "response.audio.delta", "response_id": resp_id,
                "delta": base64.b64encode(pcm16[off: off + chunk]).decode(),
            })
        ws.send_json({"type": "response.audio.done", "response_id": resp_id})


class EphemeralKeys:
    """Short-lived client secrets for realtime connects.

    POST /v1/realtime/sessions mints one; the WS handshake (and nothing
    else) accepts it as a bearer token. The reference stubs this endpoint
    with a 501 (realtime.go:185-189); OpenAI's real contract returns a
    session object whose client_secret.value expires in ~60 s — that is
    what browsers need to connect without the server API key.
    """

    TTL_S = 60.0
    # Exactly the WS connect path: admitting /v1/realtime/sessions would let
    # an ephemeral secret mint its own replacement forever.
    WS_PATH = "/v1/realtime"

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._keys: dict[str, tuple[float, dict]] = {}  # secret -> (expiry, session cfg)

    def mint(self, session_cfg: dict) -> tuple[str, int]:
        import secrets
        import time

        value = "ek_" + secrets.token_hex(16)
        expires = time.time() + self.TTL_S
        with self._lock:
            now = time.time()
            for k in [k for k, (exp, _) in self._keys.items() if exp < now]:
                del self._keys[k]
            self._keys[value] = (expires, session_cfg)
        return value, int(expires)

    def valid(self, token: str, path: str) -> bool:
        """Auth-hook: a live ephemeral key admits the WS connect only."""
        import time

        if path != self.WS_PATH:
            return False
        with self._lock:
            entry = self._keys.get(token)
            return entry is not None and entry[0] >= time.time()

    def session_for(self, token: str) -> Optional[dict]:
        import time

        with self._lock:
            entry = self._keys.get(token)
            if entry is None or entry[0] < time.time():
                return None
            return entry[1]


class RealtimeApi:
    def __init__(self, manager: ModelManager, base: OpenAIApi):
        self.manager = manager
        self._base = base
        self.ephemeral = EphemeralKeys()
        # (buffer seconds, VAD ms) of the latest server-VAD appends
        self.vad_ms: collections.deque = collections.deque(maxlen=4096)

    def register(self, r: Router) -> None:
        r.add("GET", "/v1/realtime", self.realtime)
        # REST session endpoints (reference routes openai.go:21-22; its
        # handler is a 501 stub — this is the real OpenAI contract).
        r.add("POST", "/v1/realtime/sessions", self.create_session)
        r.add("POST", "/v1/realtime/transcription_session",
              self.create_transcription_session)
        # OpenAI's documented path is the plural form; the reference
        # registers the singular (openai.go:22) — serve both.
        r.add("POST", "/v1/realtime/transcription_sessions",
              self.create_transcription_session)
        # create_server's auth consults this for realtime-scoped bearers.
        r.ephemeral_keys = self.ephemeral

    def _lease(self, usecase: Usecase, name: Optional[str]):
        if not name:
            cfg = self.manager.configs.first_with(usecase)
            if cfg is None:
                raise RuntimeError(f"no model configured for {usecase}")
            name = cfg.name
        return self.manager.lease(name)

    def _mint_session(self, body: dict, obj: str) -> "Response":
        from localai_tpu_torch.server.app import Response

        template = RealtimeSession(self, body.get("model"))
        for k, v in (body or {}).items():
            if k in template.config and k != "id":
                template.config[k] = v
        secret, expires_at = self.ephemeral.mint(dict(template.config))
        session = dict(template.config)
        session["object"] = obj
        session["client_secret"] = {"value": secret, "expires_at": expires_at}
        return Response(body=session)

    def create_session(self, req: Request) -> "Response":
        return self._mint_session(req.body or {}, "realtime.session")

    def create_transcription_session(self, req: Request) -> "Response":
        body = dict(req.body or {})
        # transcription sessions carry the STT model in input_audio_transcription
        iat = body.get("input_audio_transcription") or {}
        if iat.get("model"):
            body["transcription_model"] = iat["model"]
        resp = self._mint_session(body, "realtime.transcription_session")
        resp.body["input_audio_transcription"] = iat or {"model": ""}
        return resp

    def realtime(self, req: Request) -> WebSocketUpgrade:
        model = (req.query.get("model") or [None])[0]
        session = RealtimeSession(self, model)
        # A connect with a minted client_secret resumes its session config.
        header = req.headers.get("authorization", "") or req.headers.get("Authorization", "")
        token = header[7:] if header.startswith("Bearer ") else header
        stored = self.ephemeral.session_for(token) if token else None
        if stored:
            session.config.update(stored)  # minted configs carry their own id
            if model:
                session.config["model"] = model
        return WebSocketUpgrade(session.run)
