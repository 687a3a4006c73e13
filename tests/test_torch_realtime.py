"""The port's realtime voice socket (/v1/realtime) against the JAX
server's on the CPU, over one models dir (tests/test_torch_audio.py's:
whisper-test, tts-test and the f32 tiny llama from the JAX package's
weights). A raw RFC 6455 client drives both servers with the same events:
the handshake's accept key, session.created / session.updated, the error
events, a text turn, an audio round trip (pcm16 in → whisper → the llama
turn → pcm16 out) and a server-VAD turn with the packaged learned VAD give
the JAX server's events in its order, equal text (ids exact on f32) and
audio deltas within 2 LSB of pcm16. The session routes mint ephemeral
client secrets that admit the socket, and only the socket, behind an API
key; an oversized frame closes with 1009."""

import base64
import hashlib
import json
import os
import socket
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from localai_tpu.audio import wav as jwav
from localai_tpu_torch.server.ws import accept_key

from test_torch_audio import PCM_TOL, _speech, start_servers, write_audio_models

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
# The turn's sampling: greedy (a sampled turn draws from each package's own
# generator), 8 tokens.
GREEDY = {"temperature": 0.0, "max_response_output_tokens": 8}


class WSClient:
    """A minimal masked-frame client over a raw socket."""

    def __init__(self, base: str, path: str, headers=None, expect: str = "101"):
        host, port = base.split("//")[1].split(":")
        self.sock = socket.create_connection((host, int(port)), timeout=300)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\n{extra}Sec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.f = self.sock.makefile("rb")
        self.status = self.f.readline().decode()
        if expect not in self.status:
            raise AssertionError(self.status)
        self.accept = None
        while True:
            line = self.f.readline().decode().strip()
            if not line:
                break
            k, _, v = line.partition(":")
            if k.lower() == "sec-websocket-accept":
                self.accept = v.strip()
        if expect == "101":
            want = base64.b64encode(hashlib.sha1((key + _GUID).encode()).digest()).decode()
            assert self.accept == want == accept_key(key)

    def send_raw(self, payload: bytes, op: int = 0x1) -> None:
        mask = os.urandom(4)
        n = len(payload)
        header = bytes([0x80 | op])
        if n < 126:
            header += bytes([0x80 | n])
        elif n < (1 << 16):
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        self.sock.sendall(header + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))

    def send_json(self, obj: dict) -> None:
        self.send_raw(json.dumps(obj).encode())

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.f.read(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def recv_frame(self) -> tuple[int, bytes]:
        b1, b2 = self._read(2)
        ln = b2 & 0x7F
        if ln == 126:
            (ln,) = struct.unpack(">H", self._read(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", self._read(8))
        return b1 & 0x0F, self._read(ln)

    def recv_json(self) -> dict:
        while True:
            op, payload = self.recv_frame()
            if op == 0x1:
                return json.loads(payload)
            if op == 0x8:
                raise ConnectionError("server sent close")

    def until(self, kind: str) -> list[dict]:
        out = []
        while True:
            out.append(self.recv_json())
            if out[-1]["type"] == kind:
                return out

    def close(self) -> None:
        self.sock.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("rt-models")
    write_audio_models(root)
    info, stop = start_servers(root, extra_vad=False)
    yield info
    stop()


def _b64(x: np.ndarray) -> str:
    return base64.b64encode((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes()).decode()


def _shape(ev: dict):
    """An event without its random ids."""
    if isinstance(ev, dict):
        return {k: _shape(v) for k, v in ev.items()
                if k not in ("id", "item_id", "response_id", "delta")}
    if isinstance(ev, list):
        return [_shape(v) for v in ev]
    return ev


def _session(servers, script, path="/v1/realtime?model=chat", headers=None):
    """Run `script(ws)` on both servers; returns {side: its result}."""
    out = {}
    for side in ("jax", "port"):
        ws = WSClient(servers[side], path, headers)
        try:
            out[side] = script(ws)
        finally:
            ws.close()
    return out


def test_handshake_update_and_errors_match_jax_server(servers):
    def script(ws):
        evs = [ws.recv_json()]
        ws.send_json({"type": "session.update", "session": {
            "instructions": "Be terse.", "modalities": ["text"], "id": "nope"}})
        evs.append(ws.recv_json())
        for ev in ({"type": "bogus.event"}, {"type": "input_audio_buffer.commit"},
                   {"type": "input_audio_buffer.clear"}, {"type": "response.cancel"}):
            ws.send_json(ev)
            evs.append(ws.recv_json())
        ws.send_raw(b"{not json")
        evs.append(ws.recv_json())
        return evs

    got = _session(servers, script)
    assert [_shape(e) for e in got["port"]] == [_shape(e) for e in got["jax"]]
    assert got["port"][1]["session"]["instructions"] == "Be terse."
    assert got["port"][1]["session"]["id"] == got["port"][0]["session"]["id"]


def test_text_turn_matches_jax_server(servers):
    def script(ws):
        ws.recv_json()
        ws.send_json({"type": "session.update", "session": {"modalities": ["text"], **GREEDY}})
        ws.recv_json()
        ws.send_json({"type": "conversation.item.create", "item": {
            "type": "message", "role": "user",
            "content": [{"type": "input_text", "text": "hello"}]}})
        ws.recv_json()
        ws.send_json({"type": "response.create"})
        return ws.until("response.done")

    got = _session(servers, script)
    assert [_shape(e) for e in got["port"]] == [_shape(e) for e in got["jax"]]
    deltas = {k: [e["delta"] for e in v if e["type"] == "response.text.delta"]
              for k, v in got.items()}
    assert deltas["port"] == deltas["jax"] and deltas["port"]


def _audio_deltas(evs) -> np.ndarray:
    raw = b"".join(base64.b64decode(e["delta"]) for e in evs if e["type"] == "response.audio.delta")
    return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0


def test_audio_round_trip_matches_jax_server(servers):
    """pcm16 at 24 kHz in two appends, commit, then a response with audio:
    the transcript, the turn's text and the pcm16 out of tts-test."""
    speech = jwav.resample(_speech(21, 0.5, silence_s=0.1), 16_000, 24_000)

    def script(ws):
        ws.recv_json()
        ws.send_json({"type": "session.update", "session": GREEDY})
        ws.recv_json()
        half = len(speech) // 2
        for part in (speech[:half], speech[half:]):
            ws.send_json({"type": "input_audio_buffer.append", "audio": _b64(part)})
        ws.send_json({"type": "input_audio_buffer.commit"})
        evs = [ws.recv_json(), ws.recv_json()]
        ws.send_json({"type": "response.create"})
        return evs + ws.until("response.done")

    got = _session(servers, script)
    assert [_shape(e) for e in got["port"]] == [_shape(e) for e in got["jax"]]
    kinds = [e["type"] for e in got["port"]]
    assert kinds[:3] == ["input_audio_buffer.committed", "conversation.item.created",
                         "response.created"] and "response.audio.done" in kinds
    want, audio = _audio_deltas(got["jax"]), _audio_deltas(got["port"])
    assert audio.shape == want.shape and audio.size > 0
    np.testing.assert_allclose(audio, want, atol=PCM_TOL, rtol=0)


def test_server_vad_turn_matches_jax_server(servers):
    """server_vad with no VAD model configured: the packaged learned net
    decides; speech then trailing silence commits and responds unasked."""
    sr = 24_000
    speech = jwav.resample(_speech(11, 0.8, silence_s=0.0), 16_000, sr)
    silence = np.zeros(int(sr * 0.6), np.float32)

    def script(ws):
        ws.recv_json()
        ws.send_json({"type": "session.update", "session": {
            "modalities": ["text"], **GREEDY,
            "turn_detection": {"type": "server_vad", "silence_duration_ms": 300}}})
        ws.recv_json()
        for part in (speech, silence):
            ws.send_json({"type": "input_audio_buffer.append", "audio": _b64(part)})
        return ws.until("response.done")

    got = _session(servers, script)
    assert [_shape(e) for e in got["port"]] == [_shape(e) for e in got["jax"]]
    kinds = [e["type"] for e in got["port"]]
    assert kinds.index("input_audio_buffer.speech_started") \
        < kinds.index("input_audio_buffer.speech_stopped") \
        < kinds.index("input_audio_buffer.committed") < kinds.index("response.created")


def test_server_vad_in_small_appends_matches_jax_server(servers):
    """server_vad as a client streams: 200 ms appends of speech, then of
    silence. The port's VAD takes only each append's new samples (its
    StreamingDetector), the JAX server's reruns the whole buffer; both
    commit at the same append and answer with the same events."""
    sr = 24_000
    x = jwav.resample(_speech(12, 0.6, silence_s=0.6), 16_000, sr)
    step = sr // 5

    def script(ws):
        ws.recv_json()
        ws.send_json({"type": "session.update", "session": {
            "modalities": ["text"], **GREEDY,
            "turn_detection": {"type": "server_vad", "silence_duration_ms": 300}}})
        ws.recv_json()
        for i in range(0, len(x), step):
            ws.send_json({"type": "input_audio_buffer.append", "audio": _b64(x[i: i + step])})
        out = ws.until("response.done")
        ws.send_json({"type": "input_audio_buffer.commit"})  # what the turn left behind
        return out + [ws.recv_json()]

    got = _session(servers, script)
    assert [_shape(e) for e in got["port"]] == [_shape(e) for e in got["jax"]]
    kinds = [e["type"] for e in got["port"]]
    assert kinds[:3] == ["input_audio_buffer.speech_started", "input_audio_buffer.speech_stopped",
                         "input_audio_buffer.committed"] and kinds[-1] == "input_audio_buffer.committed"


def _post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("path,body", [
    ("/v1/realtime/sessions", {"model": "chat", "voice": "voice-1", "bogus": 1}),
    ("/v1/realtime/transcription_session", {"input_audio_transcription": {"model": "stt"}}),
    ("/v1/realtime/transcription_sessions", {}),
])
def test_session_routes_match_jax_server(servers, path, body):
    (js, jb), (ps, pb) = (_post(servers[s], path, body) for s in ("jax", "port"))
    assert js == ps == 200
    for b in (jb, pb):
        assert b["client_secret"]["value"].startswith("ek_")
        b.pop("client_secret")
        b.pop("id")
    assert pb == jb


def test_ephemeral_secret_admits_the_socket_only(tmp_path):
    """Behind an API key: a minted secret opens /v1/realtime and resumes its
    session config; it is refused on every other route; no token is 401."""
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.realtime_api import RealtimeApi
    from test_torch_audio import _serve

    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path),
                            api_keys=["sk-test"])
    tm = ModelManager(app, device="cpu")
    tr = Router()
    oai = OpenAIApi(tm)
    oai.register(tr)
    RealtimeApi(tm, oai).register(tr)
    server = create_server(app, tr)
    base = _serve(server)
    try:
        status, sess = _post(base, "/v1/realtime/sessions", {"instructions": "hi"},
                             {"Authorization": "Bearer sk-test"})
        assert status == 200
        secret = sess["client_secret"]["value"]
        auth = {"Authorization": f"Bearer {secret}"}
        ws = WSClient(base, "/v1/realtime", auth)
        created = ws.recv_json()
        ws.close()
        assert created["session"]["instructions"] == "hi"
        assert _post(base, "/v1/realtime/sessions", {}, auth)[0] == 401
        WSClient(base, "/v1/realtime", expect="401")
        # An oversized frame header closes the socket with 1009.
        ws = WSClient(base, "/v1/realtime", auth)
        ws.recv_json()
        ws.sock.sendall(bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 30) + os.urandom(4))
        op, payload = ws.recv_frame()
        ws.close()
        assert op == 0x8 and struct.unpack(">H", payload[:2])[0] == 1009
    finally:
        server.shutdown()
        tm.shutdown()
