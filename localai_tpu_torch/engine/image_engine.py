"""Resident engines for image and video generation
(localai_tpu/engine/image_engine.py): the DiT presets (DiffusionEngine),
diffusers SD / SDXL checkpoints with ControlNet, img2img, inpainting and
AnimateDiff video (LatentDiffusionEngine), and Flux (FluxEngine).

No loop thread: each request runs under the engine's lock, eagerly (no
compiled-program cache: the JAX engines' jit LRU has nothing to hold
here). A request's noise comes from a torch generator on the engine's
device seeded by the request's seed (0 when unset), so a seed gives the
same bytes on one device; the JAX engines draw from jax.random keys of the
same seed. Resizes go through F.interpolate with antialias
(models/vision.resize_uint8: bilinear as PIL's, masks nearest as PIL's
NEAREST), not PIL. The lifecycle surface is the audio engines' (`start`,
`stop`, `cancel_all`, `metrics`, `drop_device_state`, `is_dead` False).
Not ported yet: YolosEngine and DetectionEngine (ROADMAP Queue A item 13 (e)).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.models import diffusion as dit
from localai_tpu_torch.models import flux as fx
from localai_tpu_torch.models import latent_diffusion as ld
from localai_tpu_torch.models.vision import resize_uint8


def _prep_source_image(img: np.ndarray, w: int, h: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] → f32 [1, 3, h, w] in [0, 1] at generation size."""
    src = resize_uint8(np.asarray(img, np.uint8), h, w, "bilinear")
    return (torch.from_numpy(src).permute(2, 0, 1)[None].float() / 255.0).to(device)


def _resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [H, W] → f32 {0, 1} [h, w]: nearest as PIL's NEAREST, then the
    JAX engine's threshold (127 on 0-255 masks, 0.5 on 0-1 ones)."""
    m = torch.from_numpy(np.asarray(mask, np.float32))[None, None]
    m = F.interpolate(m, size=(h, w), mode="nearest-exact")[0, 0].numpy()
    return (m > 127).astype(np.float32) if m.max() > 1.0 else (m > 0.5).astype(np.float32)


def _to_uint8(imgs: torch.Tensor) -> list[np.ndarray]:
    """[B, 3, H, W] f32 in [0, 1] → B uint8 [H, W, 3] (x · 255 + 0.5, truncated)."""
    a = (imgs.permute(0, 2, 3, 1).float() * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    return list(a)


def _resize_out(img: np.ndarray, size: Optional[tuple[int, int]]) -> np.ndarray:
    if size is None or (img.shape[1], img.shape[0]) == tuple(size):
        return img
    return resize_uint8(img, size[1], size[0], "bilinear")


def _generator(seed, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0 if seed is None else int(seed) & 0x7FFFFFFF)


def _randn(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """Every draw of a request: unit normal f32 from its generator."""
    return torch.randn(shape, generator=gen, device=device)


class _BaseImageEngine:
    is_dead = False  # no loop to die
    postmortem_path = ""
    journal = None
    cache = None

    def __init__(self, params: Any) -> None:
        self.params = params
        self.device = _device_of(params)
        self._lock = threading.Lock()
        self.m_requests = 0
        self.m_images = 0
        self._busy_time = 0.0

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
        return {"requests": float(self.m_requests), "images_generated": float(self.m_images),
                "busy_seconds": self._busy_time}

    def _count(self, t0: float, images: int) -> None:
        self.m_requests += 1
        self.m_images += images
        self._busy_time += time.monotonic() - t0


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class DiffusionEngine(_BaseImageEngine):
    """A DiT preset or own-format checkpoint (models/diffusion.py)."""

    def __init__(self, cfg: dit.DiffusionConfig, params: Any):
        super().__init__(params)
        self.cfg = cfg

    def _text_ids(self, prompt: str) -> np.ndarray:
        data = prompt.encode("utf-8")[: self.cfg.text_ctx]
        ids = np.zeros((self.cfg.text_ctx,), np.int64)
        ids[: len(data)] = np.frombuffer(data, np.uint8)
        return ids

    def _ids(self, prompt: str, n: int) -> torch.Tensor:
        ids = np.broadcast_to(self._text_ids(prompt), (n, self.cfg.text_ctx))
        return torch.from_numpy(np.array(ids)).to(self.device)

    def _shape(self, n: int) -> tuple:
        s = self.cfg.image_size
        return (n, s, s, self.cfg.channels)

    def generate(self, prompt: str, n: int = 1, steps: int = 20, seed: Optional[int] = None,
                 guidance: float = 4.0, size: Optional[tuple[int, int]] = None
                 ) -> list[np.ndarray]:
        """n uint8 RGB images at the model's resolution, resized to `size`
        on the host. Deterministic for a seed. img2img and control images
        are a TypeError (a 400), as in the JAX engine."""
        t0 = time.monotonic()
        with self._lock:
            gen = _generator(seed, self.device)
            noise = _randn(gen, self._shape(n), self.device)
            imgs = dit.generate(self.cfg, self._params(), self._ids(prompt, n), steps=steps,
                                guidance=guidance, noise=noise)
        out = [_resize_out(img, size) for img in _to_uint8(imgs.permute(0, 3, 1, 2))]
        self._count(t0, n)
        return out

    def inpaint(self, prompt: str, image: np.ndarray, mask: np.ndarray, steps: int = 20,
                seed: Optional[int] = None, guidance: float = 4.0) -> np.ndarray:
        """RePaint-style inpainting at model resolution, resized back to the
        input's size. mask: nonzero = repaint."""
        t0 = time.monotonic()
        H, W = image.shape[:2]
        s = self.cfg.image_size
        img = torch.from_numpy(resize_uint8(image, s, s, "bilinear")).float()[None] / 255.0
        m = torch.from_numpy(_resize_mask(mask, s, s))[None]
        with self._lock:
            gen = _generator(seed, self.device)
            noise = _randn(gen, self._shape(1), self.device)
            noise_steps = _randn(gen, (steps, *self._shape(1)), self.device)
            out = dit.inpaint(self.cfg, self._params(), self._ids(prompt, 1),
                              img.to(self.device), m.to(self.device), steps=steps,
                              guidance=guidance, noise=noise, noise_steps=noise_steps)
        result = _resize_out(_to_uint8(out.permute(0, 3, 1, 2))[0], (W, H))
        self._count(t0, 1)
        return result

    def generate_video(self, prompt: str, n_frames: int = 8, steps: int = 12,
                       seed: Optional[int] = None, guidance: float = 4.0,
                       negative_prompt: str = "", init_image: Optional[np.ndarray] = None,
                       strength: float = 0.8) -> list[np.ndarray]:
        """Frames of one batched diffusion whose noise is slerped between two
        endpoint draws (a latent sweep). negative_prompt is accepted for the
        API's sake: own-format checkpoints condition on no negative text."""
        if init_image is not None:
            raise ValueError(
                "image-to-video needs a latent-diffusion checkpoint (this "
                "own-format model has no VAE to encode the source image)")
        t0 = time.monotonic()
        with self._lock:
            gen = _generator(seed, self.device)
            e0, e1 = (_randn(gen, self._shape(1)[1:], self.device) for _ in range(2))
            noise = slerp_frames(e0, e1, n_frames)
            frames = dit.generate(self.cfg, self._params(), self._ids(prompt, n_frames),
                                  steps=steps, guidance=guidance, noise=noise)
        out = _to_uint8(frames.permute(0, 3, 1, 2))
        self._count(t0, n_frames)
        return out


def slerp_frames(e0: torch.Tensor, e1: torch.Tensor, n: int) -> torch.Tensor:
    """n spherical interpolations from e0 to e1, stacked."""
    dot = float((e0 * e1).sum() / (e0.norm() * e1.norm()))
    theta = float(np.arccos(np.clip(dot, -1.0, 1.0)))
    ts = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return torch.stack([(np.sin((1 - t) * theta) * e0 + np.sin(t * theta) * e1)
                        / max(np.sin(theta), 1e-6) for t in ts])


class FluxEngine(_BaseImageEngine):
    """Flux.1-class checkpoints (models/flux.py), with LatentDiffusionEngine's
    generate surface. Guidance-distilled: no CFG pass, no negative prompt;
    ControlNet and inpainting are SD / SDXL features."""

    def __init__(self, cfg: fx.FluxPipelineConfig, params: Any, tokenizers):
        super().__init__(params)
        self.cfg = cfg
        self.tokenizer, self.tokenizer2 = tokenizers

    def inpaint(self, *args, **kwargs):
        raise ValueError("Flux checkpoints do not serve inpainting (an SD/SDXL feature)")

    def generate_video(self, *args, **kwargs):
        raise ValueError("Flux checkpoints do not serve video generation; use an SD "
                         "checkpoint with a motion adapter")

    def _round_size(self, size) -> tuple[int, int]:
        if size is None:
            return 1024, 1024
        gran = 2 * self.cfg.vae.spatial_scale  # latents pack 2x2
        w, h = size
        return max(gran, (w // gran) * gran), max(gran, (h // gran) * gran)

    def _ids(self, tok, prompt: str, n: int, length: int) -> torch.Tensor:
        enc = tok(prompt, padding="max_length", max_length=length, truncation=True)["input_ids"]
        return torch.tensor(enc, dtype=torch.long, device=self.device).expand(n, length)

    def generate(self, prompt: str, n: int = 1, steps: int = 20, seed: Optional[int] = None,
                 guidance: float = 3.5, size: Optional[tuple[int, int]] = None,
                 negative_prompt: str = "", scheduler: Optional[str] = None,
                 init_image: Optional[np.ndarray] = None, strength: float = 0.8,
                 **unsupported) -> list[np.ndarray]:
        if unsupported.get("control_image") is not None:
            raise ValueError("Flux checkpoints do not take control_image")
        if scheduler not in (None, "", "euler", "flow_euler", "flow_match_euler"):
            raise ValueError(f"Flux serves the flow-matching euler schedule only (got "
                             f"{scheduler!r})")
        t0 = time.monotonic()
        gw, gh = self._round_size(size)
        clip_ids = self._ids(self.tokenizer, prompt, n, self.cfg.clip.max_position_embeddings)
        t5_ids = self._ids(self.tokenizer2, prompt, n, self.cfg.t5_max_length)
        init = None
        if init_image is not None:
            strength = min(max(float(strength), 0.0), 1.0)
            init = _prep_source_image(init_image, gw, gh, self.device).expand(n, -1, -1, -1)
        vs = self.cfg.vae.spatial_scale
        with self._lock:
            gen = _generator(seed, self.device)
            noise = _randn(gen, (n, self.cfg.vae.latent_channels, gh // vs, gw // vs),
                           self.device)
            imgs = fx.generate(self.cfg, self._params(), clip_ids, t5_ids, steps=steps,
                               guidance=guidance, height=gh, width=gw, init_image=init,
                               strength=strength, init_noise=noise)
        out = [_resize_out(img, size) for img in _to_uint8(imgs)]
        self._count(t0, n)
        return out


class LatentDiffusionEngine(_BaseImageEngine):
    """Diffusers SD-1.5 / SDXL-class checkpoints (models/latent_diffusion.py),
    with DiffusionEngine's surface so the image and video routes serve
    either. `motion` (MotionConfig, params) makes generate_video run the
    AnimateDiff UNet; without it, a latent sweep."""

    def __init__(self, cfg: ld.SDPipelineConfig, params: Any, tokenizer,
                 default_scheduler: str = "ddim", motion: Optional[tuple] = None):
        super().__init__(params)
        self.cfg = cfg
        if isinstance(tokenizer, tuple):  # SDXL: (tokenizer, tokenizer_2)
            self.tokenizer, self.tokenizer2 = tokenizer
        else:
            self.tokenizer, self.tokenizer2 = tokenizer, None
        self.default_scheduler = default_scheduler
        self.motion = motion

    def drop_device_state(self) -> None:
        with self._lock:
            self.params = self.motion = None

    def _ids(self, prompt: str, batch: int, second: bool = False) -> torch.Tensor:
        tok = self.tokenizer2 if (second and self.tokenizer2 is not None) else self.tokenizer
        S = self.cfg.text.max_position_embeddings
        enc = tok(prompt, padding="max_length", max_length=S, truncation=True)["input_ids"]
        return torch.tensor(enc, dtype=torch.long, device=self.device).expand(batch, S)

    def _native_size(self) -> int:
        return int(self.cfg.unet.sample_size) * self.cfg.vae.spatial_scale

    def _round_size(self, size) -> tuple[int, int]:
        if size is None:
            s = self._native_size()
            return s, s
        # latents must survive the UNet's down / up ladder
        gran = self.cfg.vae.spatial_scale * 2 ** (len(self.cfg.unet.block_out_channels) - 1)
        w, h = size
        return max(gran, (w // gran) * gran), max(gran, (h // gran) * gran)

    def generate(self, prompt: str, n: int = 1, steps: int = 20, seed: Optional[int] = None,
                 guidance: float = 7.5, size: Optional[tuple[int, int]] = None,
                 negative_prompt: str = "", scheduler: Optional[str] = None,
                 control_image: Optional[np.ndarray] = None, control_scale: float = 1.0,
                 init_image: Optional[np.ndarray] = None, strength: float = 0.8,
                 _init_noise: Optional[torch.Tensor] = None,
                 _known: Optional[tuple] = None) -> list[np.ndarray]:
        t0 = time.monotonic()
        sched = scheduler or self.default_scheduler
        gw, gh = self._round_size(size)
        is_xl = self.cfg.is_xl
        kw: dict[str, Any] = {}
        if is_xl:
            kw["cond_ids2"] = self._ids(prompt, n, second=True)
            kw["uncond_ids2"] = self._ids(negative_prompt or "", n, second=True)
        if control_image is not None:
            if "controlnet" not in self._params():
                raise ValueError("this checkpoint has no controlnet/ weights")
            kw["control_image"] = _prep_source_image(control_image, gw, gh,
                                                     self.device).expand(n, -1, -1, -1)
            kw["control_scale"] = float(control_scale)
        if init_image is not None:
            kw["init_image"] = _prep_source_image(init_image, gw, gh,
                                                  self.device).expand(n, -1, -1, -1)
            kw["strength"] = min(max(float(strength), 0.0), 1.0)
        if _known is not None:
            kw["known_latent"], kw["known_mask"] = _known
        with self._lock:
            gen = _generator(seed, self.device)
            imgs = ld.generate(self.cfg, self._params(), self._ids(prompt, n),
                               self._ids(negative_prompt or "", n), steps=steps,
                               guidance=guidance, height=gh, width=gw, scheduler=sched,
                               init_noise=_init_noise,
                               noise=lambda shape: _randn(gen, shape, self.device), **kw)
        out = [_resize_out(img, size) for img in _to_uint8(imgs)]
        self._count(t0, n)
        return out

    def inpaint(self, prompt: str, image: np.ndarray, mask: np.ndarray, steps: int = 20,
                seed: Optional[int] = None, guidance: float = 7.5) -> np.ndarray:
        """Known-latent DDIM inpainting at the native size, resized back."""
        H, W = image.shape[:2]
        s = self._native_size()
        vs = self.cfg.vae.spatial_scale
        img = _prep_source_image(image, s, s, self.device)
        m = torch.from_numpy(_resize_mask(mask, s // vs, s // vs))[None, None].to(self.device)
        with self._lock:
            known = ld.vae_encode(self.cfg.vae, self._params()["vae"], img)
        out = self.generate(prompt, n=1, steps=steps, seed=seed, guidance=guidance,
                            size=(s, s), scheduler="ddim", _known=(known, m))[0]
        return _resize_out(out, (W, H))

    def generate_video(self, prompt: str, n_frames: int = 8, steps: int = 12,
                       seed: Optional[int] = None, guidance: float = 7.5,
                       negative_prompt: str = "", init_image: Optional[np.ndarray] = None,
                       strength: float = 0.8) -> list[np.ndarray]:
        """Text → video: AnimateDiff's motion UNet with a loaded adapter; else
        a latent sweep (frame noise slerped between two draws) through
        generate. init_image anchors every frame (img2vid)."""
        if self.motion is not None:
            return self._generate_video_motion(prompt, n_frames, steps, seed, guidance,
                                               negative_prompt, init_image, strength)
        s = self._native_size()
        vs = self.cfg.vae.spatial_scale
        gen = _generator(seed, self.device)
        lat = (self.cfg.unet.in_channels, s // vs, s // vs)
        e0, e1 = (_randn(gen, lat, self.device) for _ in range(2))
        kw = {"init_image": init_image, "strength": strength} if init_image is not None else {}
        return self.generate(prompt, n=n_frames, steps=steps, seed=seed, guidance=guidance,
                             negative_prompt=negative_prompt, size=(s, s), scheduler="ddim",
                             _init_noise=slerp_frames(e0, e1, n_frames), **kw)

    def _generate_video_motion(self, prompt, n_frames, steps, seed, guidance,
                               negative_prompt="", init_image=None, strength=0.8):
        from localai_tpu_torch.models import video_diffusion as vd

        t0 = time.monotonic()
        mcfg, mparams = self.motion
        if n_frames > mcfg.max_seq_length:
            raise ValueError(f"n_frames={n_frames} exceeds the motion adapter's trained "
                             f"window ({mcfg.max_seq_length} frames)")
        s = self._native_size()
        vs = self.cfg.vae.spatial_scale
        init = None
        if init_image is not None:
            strength = min(max(float(strength), 0.0), 1.0)
            init = _prep_source_image(init_image, s, s, self.device)
        with self._lock:
            gen = _generator(seed, self.device)
            noise = _randn(gen, (n_frames, self.cfg.unet.in_channels, s // vs, s // vs),
                           self.device)
            frames = vd.generate_video(self.cfg, self._params(), mcfg, mparams,
                                       self._ids(prompt, 1), self._ids(negative_prompt or "", 1),
                                       frames=n_frames, steps=steps, guidance=guidance,
                                       height=s, width=s, init_image=init, strength=strength,
                                       init_noise=noise)
        out = _to_uint8(frames)
        self._count(t0, n_frames)
        return out
