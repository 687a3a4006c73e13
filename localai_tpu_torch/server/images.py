"""Image content of chat messages: `image_url` parts with inline data URIs
decoded to uint8 [H, W, 3] arrays (the JAX server's `_extract_images`).

PIL decodes when it imports (it is imported here, at the call, never with
the module). Without it a PNG still decodes, by `decode_png`: 8-bit
grayscale, RGB, palette, grayscale + alpha and RGBA, non-interlaced, on
zlib from the standard library; any other format is refused with an
ImageDecodeError naming the missing decoder, which the server answers
with 400. A part whose bytes do not decode is skipped, as the JAX server
skips it.

`encode_png` writes the images the image routes return (8-bit RGB or
grayscale, filter None, zlib level 6): lossless, so a decoder reads back
the exact pixels PIL's encoder would have stored; `to_gray` is PIL's
convert("L").
"""

from __future__ import annotations

import base64
import io
import logging
import struct
import zlib

import numpy as np

log = logging.getLogger("localai_tpu_torch.images")

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


class ImageDecodeError(ValueError):
    """An image this process has no decoder for."""


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b, c = prev[x], prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG → uint8 [H, W, 3] RGB (alpha dropped,
    palette and grayscale expanded), as PIL's convert("RGB") gives."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ImageDecodeError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: "
            "only 8-bit non-interlaced PNGs decode without PIL (not installed)")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        return palette[px[..., 0]]
    if ch <= 2:  # grayscale (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB or [H, W] grayscale → PNG bytes (no PIL)."""
    a = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = a.shape[:2]
    ctype = 2 if a.ndim == 3 else 0
    raw = np.zeros((h, 1 + a[0].size), np.uint8)  # filter byte 0 (None) a scanline
    raw[:, 1:] = a.reshape(h, -1)
    return (_PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 RGB → uint8 luma, PIL's convert("L") (ITU-R 601-2, fixed point)."""
    a = np.asarray(img, np.uint32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes → uint8 [H, W, 3] RGB: PIL when it imports, else the PNG
    decoder (ImageDecodeError for any other format)."""
    try:
        from PIL import Image
    except ImportError:
        if data.startswith(_PNG_MAGIC):
            return decode_png(data)
        raise ImageDecodeError("image content other than PNG needs PIL, which is not "
                               "installed on this server") from None
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def extract_images(messages: list) -> list[np.ndarray]:
    """Decode every `image_url` content part with a data: URI (zero
    egress: other URLs are not fetched) → uint8 arrays. A part that does
    not decode is skipped; a format with no decoder here raises
    ImageDecodeError."""
    out = []
    for m in messages:
        content = m.get("content") if isinstance(m, dict) else None
        if not isinstance(content, list):
            continue
        for part in content:
            if not isinstance(part, dict) or part.get("type") != "image_url":
                continue
            url = (part.get("image_url") or {}).get("url", "")
            if not url.startswith("data:"):
                continue
            try:
                out.append(decode_image(base64.b64decode(url.split(",", 1)[-1])))
            except ImageDecodeError:
                raise
            except Exception as e:  # noqa: BLE001 — a bad part is skipped, as the JAX server does
                log.info("image part skipped: %s: %s", type(e).__name__, e)
    return out
