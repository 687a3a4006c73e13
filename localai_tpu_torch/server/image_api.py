"""Image and video generation endpoints (localai_tpu/server/image_api.py:
the same routes, fields, answers and 400s).

Reference: core/http/endpoints/openai/image.go (b64 / url response, files
under generated_content_dir served back over HTTP) and endpoints/openai/
video.go. Images go out as PNG from server/images.encode_png and videos
through utils/video_io.write_video (MPEG-4 by OpenCV, else a GIF), so
neither needs PIL; sources and masks decode through server/images
(PIL when it imports, else 8-bit PNG).
"""

from __future__ import annotations

import base64
import os
import re
import time
import uuid

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.config import Usecase
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.images import decode_image, encode_png, to_gray
from localai_tpu_torch.server.manager import ModelManager
from localai_tpu_torch.server.openai_api import OpenAIApi

_SIZE_RE = re.compile(r"^(\d+)x(\d+)$")
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


class ImageApi:
    def __init__(self, manager: ModelManager, base: OpenAIApi, content_dir: str):
        self.manager = manager
        self._base = base
        self.content_dir = content_dir

    def register(self, r: Router) -> None:
        r.add("POST", "/v1/images/generations", self.generations)
        r.add("POST", "/images/generations", self.generations)
        r.add("POST", "/v1/images/inpainting", self.inpainting)
        r.add("POST", "/v1/videos", self.videos)
        r.add("GET", "/generated-images/:name", self.serve_image)
        r.add("GET", "/generated-videos/:name", self.serve_video)

    # ------------------------------------------------------------------ #

    def _parse_size(self, body) -> tuple[int, int] | None:
        size = body.get("size")
        if not size:
            return None
        m = _SIZE_RE.match(str(size))
        if not m:
            raise ApiError(400, f"invalid size {size!r} (expected WxH)")
        w, h = int(m.group(1)), int(m.group(2))
        if not (8 <= w <= 4096 and 8 <= h <= 4096):
            raise ApiError(400, "size out of range")
        return (w, h)

    @staticmethod
    def _decode_b64_image(body: dict, *keys: str, field: str = "image"):
        """First present key → decoded RGB array; malformed input → 400."""
        blob64 = next((body[k] for k in keys if body.get(k)), None)
        if blob64 is None:
            return None
        try:
            return decode_image(base64.b64decode(blob64))
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"{field} is not a decodable image: {e}") from None

    @staticmethod
    def _num_field(body: dict, key: str) -> float | None:
        """Numeric body field or 400 (never a 500 from a bad string)."""
        if body.get(key) is None:
            return None
        try:
            return float(body[key])
        except (TypeError, ValueError):
            raise ApiError(400, f"{key} must be a number") from None

    def _publish(self, png: bytes, response_format: str) -> dict:
        if response_format == "b64_json":
            return {"b64_json": base64.b64encode(png).decode()}
        os.makedirs(self.content_dir, exist_ok=True)
        name = f"{uuid.uuid4().hex}.png"
        with open(os.path.join(self.content_dir, name), "wb") as f:
            f.write(png)
        return {"url": f"/generated-images/{name}"}

    def generations(self, req: Request) -> Response:
        body = req.body or {}
        prompt = body.get("prompt")
        if not prompt or not isinstance(prompt, str):
            raise ApiError(400, "prompt is required")
        n = int(body.get("n") or 1)
        if not 1 <= n <= 8:
            raise ApiError(400, "n must be between 1 and 8")
        steps = int(body.get("step") or body.get("steps") or 20)
        size = self._parse_size(body)
        response_format = body.get("response_format") or "url"

        kw = {}
        init = self._decode_b64_image(body, "image", "src")
        if init is not None:  # img2img: a base64 source + strength
            kw["init_image"] = init
            strength = self._num_field(body, "strength")
            if strength is not None:
                kw["strength"] = strength
        ctrl = self._decode_b64_image(body, "control_image", field="control_image")
        if ctrl is not None:  # ControlNet conditioning (the checkpoint's controlnet/)
            kw["control_image"] = ctrl
            scale = self._num_field(body, "control_scale")
            if scale is not None:
                kw["control_scale"] = scale

        lm, lease = self._base._resolve(req, Usecase.IMAGE)
        try:
            images = lm.engine.generate(
                prompt, n=n, steps=steps, seed=body.get("seed"), size=size,
                guidance=float(body.get("guidance_scale") or 4.0), **kw,
            )
        except (ValueError, TypeError) as e:
            # e.g. control_image against a checkpoint without controlnet/
            raise ApiError(400, str(e)) from None
        finally:
            lease.release()
        data = [self._publish(encode_png(img), response_format) for img in images]
        return Response(body={"created": int(time.time()), "data": data})

    def inpainting(self, req: Request) -> Response:
        """Multipart form with `image` and `mask` files (white = repaint),
        `prompt`, optional `steps` / `seed` / `model` / `response_format`."""
        form = req.form()
        for field in ("image", "mask"):
            if field not in form:
                raise ApiError(400, f"missing form field {field!r}")

        def text_field(name: str, default: str = "") -> str:
            return form[name][1].decode("utf-8", "replace").strip() if name in form else default

        prompt = text_field("prompt")
        if not prompt:
            raise ApiError(400, "prompt is required")
        try:
            img = decode_image(form["image"][1])
            mask = to_gray(decode_image(form["mask"][1]))
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"could not decode image/mask: {e}") from None
        if mask.shape != img.shape[:2]:  # nearest, as PIL's NEAREST
            m = torch.from_numpy(mask.astype(np.float32))[None, None]
            mask = F.interpolate(m, size=img.shape[:2], mode="nearest-exact")[0, 0].numpy()
            mask = mask.astype(np.uint8)
        steps = int(text_field("steps", "") or 25)
        seed = text_field("seed", "")
        model = text_field("model", "")
        response_format = text_field("response_format", "url")

        fake = Request(method=req.method, path=req.path, params=req.params, query=req.query,
                       headers=req.headers, body={"model": model} if model else {})
        lm, lease = self._base._resolve(fake, Usecase.IMAGE)
        try:
            out = lm.engine.inpaint(prompt, img, mask, steps=steps,
                                    seed=int(seed) if seed else None)
        except ValueError as e:  # e.g. a Flux checkpoint (no inpainting path)
            raise ApiError(400, str(e)) from None
        finally:
            lease.release()
        return Response(body={"created": int(time.time()),
                              "data": [self._publish(encode_png(out), response_format)]})

    def videos(self, req: Request) -> Response:
        body = req.body or {}
        prompt = body.get("prompt")
        if not prompt or not isinstance(prompt, str):
            raise ApiError(400, "prompt is required")
        n_frames = int(body.get("n_frames") or 8)
        if not 2 <= n_frames <= 64:
            raise ApiError(400, "n_frames must be between 2 and 64")
        steps = int(body.get("step") or body.get("steps") or 12)
        fmt = str(body.get("format") or "mp4")
        if fmt not in ("mp4", "gif"):
            raise ApiError(400, "format must be mp4 or gif")
        # validated before generating: a bad value must not waste the run
        frame_ms = int(self._num_field(body, "frame_ms") or 125)

        kw = {}
        init = self._decode_b64_image(body, "image", "file", "src")
        if init is not None:  # image → video: the source anchors every frame
            kw["init_image"] = init
            strength = self._num_field(body, "strength")
            if strength is not None:
                kw["strength"] = strength

        lm, lease = self._base._resolve(req, Usecase.VIDEO)
        try:
            frames = lm.engine.generate_video(
                prompt, n_frames=n_frames, steps=steps, seed=body.get("seed"),
                negative_prompt=str(body.get("negative_prompt") or ""), **kw,
            )
        except ValueError as e:  # e.g. n_frames beyond the adapter's window
            raise ApiError(400, str(e)) from None
        finally:
            lease.release()

        from localai_tpu_torch.utils.video_io import write_video

        name, _ctype = write_video(self.content_dir, frames, frame_ms=frame_ms, fmt=fmt)
        return Response(body={"created": int(time.time()),
                              "data": [{"url": f"/generated-videos/{name}"}]})

    # ------------------------------------------------------------------ #

    def _serve(self, name: str, ctype: str) -> Response:
        if not _NAME_RE.match(name):
            raise ApiError(400, "invalid file name")
        path = os.path.join(self.content_dir, name)
        if not os.path.exists(path):
            raise ApiError(404, f"{name} not found")
        with open(path, "rb") as f:
            return Response(body=f.read(), content_type=ctype)

    def serve_image(self, req: Request) -> Response:
        return self._serve(req.params["name"], "image/png")

    def serve_video(self, req: Request) -> Response:
        from localai_tpu_torch.utils.video_io import CONTENT_TYPES

        name = req.params["name"]
        return self._serve(name, CONTENT_TYPES.get(os.path.splitext(name)[1], "video/mp4"))
