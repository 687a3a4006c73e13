"""Video files for /v1/videos (localai_tpu/utils/video_io.py).

MPEG-4 through OpenCV's built-in encoder when `cv2` imports and its writer
opens; otherwise an animated GIF from `encode_gif`, which needs no PIL:
one global palette (the frames' own colours when there are at most 256,
else the 3-3-2 colour cube, each channel to its nearest level), LZW codes
written 9 bits wide with a clear code every 254 pixels (a valid stream
any decoder reads, about 9 bits a pixel), a frame delay of frame_ms / 10
centiseconds and the NETSCAPE loop-forever block.
"""

from __future__ import annotations

import logging
import os
import struct
import uuid

import numpy as np

log = logging.getLogger("localai_tpu_torch.video_io")

CONTENT_TYPES = {".mp4": "video/mp4", ".gif": "image/gif"}

_LEVELS = (8, 8, 4)  # the 3-3-2 cube


def _palette(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(palette [256, 3] uint8, indices [F, H, W] uint8)."""
    flat = frames.reshape(-1, 3)
    key = (flat[:, 0].astype(np.uint32) << 16) | (flat[:, 1].astype(np.uint32) << 8) \
        | flat[:, 2].astype(np.uint32)
    uniq, inv = np.unique(key, return_inverse=True)
    pal = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        pal[:len(uniq)] = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], -1)
        return pal, inv.astype(np.uint8).reshape(frames.shape[:3])
    idx = [np.rint(flat[:, c].astype(np.float32) * (n - 1) / 255.0).astype(np.uint32)
           for c, n in enumerate(_LEVELS)]
    codes = (idx[0] << 5) | (idx[1] << 2) | idx[2]
    r, g, b = np.meshgrid(*[np.arange(n) for n in _LEVELS], indexing="ij")
    for c, (lv, n) in enumerate(zip((r, g, b), _LEVELS)):
        pal[(r.ravel() << 5) | (g.ravel() << 2) | b.ravel(), c] = np.rint(
            lv.ravel() * 255.0 / (n - 1)).astype(np.uint8)
    return pal, codes.astype(np.uint8).reshape(frames.shape[:3])


def _lzw_literal(indices: np.ndarray) -> bytes:
    """The image data sub-blocks of one frame: min code size 8, every code a
    9-bit literal, a clear code ahead of every 254 pixels, then end."""
    px = indices.reshape(-1).astype(np.uint16)
    n = len(px)
    chunks = (n + 253) // 254
    codes = np.empty(n + chunks + 1, np.uint16)
    pos = np.arange(n) + np.arange(n) // 254 + 1  # each chunk's pixels after its clear
    codes[pos] = px
    codes[np.arange(chunks) * 255] = 256  # clear
    codes[-1] = 257  # end of information
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray([8])
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out + b"\x00")


def encode_gif(frames: list[np.ndarray], frame_ms: int = 125) -> bytes:
    """uint8 RGB frames [H, W, 3] → an animated GIF89a that loops forever."""
    stack = np.stack([np.asarray(f, np.uint8) for f in frames])
    h, w = stack.shape[1:3]
    pal, idx = _palette(stack)
    delay = max(1, int(frame_ms) // 10)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + pal.tobytes())
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for f in range(len(stack)):
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + _lzw_literal(idx[f])
    return bytes(out + b"\x3b")


def write_video(content_dir: str, frames: list[np.ndarray], frame_ms: int = 125,
                fmt: str = "mp4") -> tuple[str, str]:
    """Write frames to content_dir; returns (file name, content type). "mp4"
    encodes MPEG-4 through OpenCV and falls back to GIF when it is
    unavailable; "gif" writes the animated GIF."""
    os.makedirs(content_dir, exist_ok=True)
    name = uuid.uuid4().hex
    frame_ms = max(1, int(frame_ms))
    if fmt == "mp4":
        path = os.path.join(content_dir, f"{name}.mp4")
        try:
            import cv2

            h, w = frames[0].shape[:2]
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     1000.0 / frame_ms, (w, h))
            if not writer.isOpened():
                raise RuntimeError("VideoWriter failed to open")
            for f in frames:
                writer.write(np.ascontiguousarray(f[..., ::-1]))  # RGB → BGR
            writer.release()
            if os.path.getsize(path) == 0:
                raise RuntimeError("VideoWriter produced an empty file")
            return f"{name}.mp4", "video/mp4"
        except Exception as e:  # noqa: BLE001 — no cv2 or no codec: GIF
            log.warning("mp4 encode unavailable (%s); falling back to GIF", e)
            if os.path.exists(path):
                os.remove(path)
    fname = f"{name}.gif"
    with open(os.path.join(content_dir, fname), "wb") as f:
        f.write(encode_gif(frames, frame_ms))
    return fname, "image/gif"
