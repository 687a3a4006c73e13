"""Minimal RFC 6455 WebSocket support for the stdlib HTTP server (a copy of
localai_tpu/server/ws.py, which is stdlib only).

The reference's realtime endpoint rides gofiber's websocket upgrade
(core/http/endpoints/openai/realtime.go). Here the handshake and framing are
implemented directly — ~150 lines, no dependency — and handlers return a
`WebSocketUpgrade` from the router to take over the connection.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Any, Callable, Optional

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# Largest accepted message (single frame or fragmented total). Realtime audio
# chunks are well under this; anything bigger is a memory-exhaustion attempt.
MAX_MESSAGE_BYTES = 16 * 1024 * 1024


class WebSocketUpgrade:
    """Handler return value: accept the upgrade, then run `session(ws)`."""

    def __init__(self, session: Callable[["WebSocket"], None]):
        self.session = session


def accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((client_key + _GUID).encode()).digest()
    ).decode()


class WebSocket:
    """Blocking frame-level API over an upgraded socket."""

    def __init__(self, rfile, wfile):
        self._r = rfile
        self._w = wfile
        self.open = True

    # ------------------------------------------------------------------ #
    # Receive
    # ------------------------------------------------------------------ #

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._r.read(n - len(buf))
            if not chunk:
                raise ConnectionError("websocket peer closed")
            buf += chunk
        return buf

    def recv(self) -> Optional[tuple[int, bytes]]:
        """Next complete message → (opcode, payload); None once closed.
        Handles fragmentation, ping/pong, and unmasking."""
        message = b""
        msg_op = None
        while True:
            if not self.open:
                return None
            try:
                b1, b2 = self._read_exact(2)
            except ConnectionError:
                self.open = False
                return None
            fin = bool(b1 & 0x80)
            op = b1 & 0x0F
            masked = bool(b2 & 0x80)
            ln = b2 & 0x7F
            if ln == 126:
                (ln,) = struct.unpack(">H", self._read_exact(2))
            elif ln == 127:
                (ln,) = struct.unpack(">Q", self._read_exact(8))
            # The length field is client-controlled; cap it (and the
            # accumulated fragmented message) before buffering anything, or a
            # client claiming a multi-GB payload drives unbounded allocation.
            # Control frames may interleave a fragmented message and never
            # join it — but RFC 6455 §5.5 bounds them to 125 bytes (protocol
            # error beyond that, 1002), which also blocks ping amplification.
            if op >= 0x8:
                if ln > 125:
                    self.close(code=1002)
                    return None
            elif ln + len(message) > MAX_MESSAGE_BYTES:
                self.close(code=1009)  # Message Too Big
                return None
            mask = self._read_exact(4) if masked else None
            payload = self._read_exact(ln)
            if mask:
                payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
            if op == OP_CLOSE:
                self._send_frame(OP_CLOSE, b"")
                self.open = False
                return None
            if op == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if op == OP_PONG:
                continue
            if op in (OP_TEXT, OP_BIN):
                msg_op = op
                message = payload
            elif op == OP_CONT:
                message += payload
            if fin:
                return (msg_op or OP_TEXT), message

    def recv_json(self) -> Optional[dict]:
        while True:
            msg = self.recv()
            if msg is None:
                return None
            op, payload = msg
            if op != OP_TEXT:
                continue
            try:
                return json.loads(payload)
            except json.JSONDecodeError:
                self.send_json({"type": "error", "error": {
                    "message": "invalid JSON frame"}})

    # ------------------------------------------------------------------ #
    # Send
    # ------------------------------------------------------------------ #

    def _send_frame(self, op: int, payload: bytes) -> None:
        header = bytes([0x80 | op])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < (1 << 16):
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        try:
            self._w.write(header + payload)
            self._w.flush()
        except (BrokenPipeError, ConnectionResetError):
            self.open = False

    def send_text(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode())

    def send_json(self, obj: dict[str, Any]) -> None:
        self.send_text(json.dumps(obj))

    def send_bytes(self, data: bytes) -> None:
        self._send_frame(OP_BIN, data)

    def close(self, code: int = 1000) -> None:
        if self.open:
            self._send_frame(OP_CLOSE, struct.pack(">H", code))
            self.open = False
