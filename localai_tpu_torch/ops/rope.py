"""Rotary position embeddings with every scaling family the JAX package
serves (localai_tpu/ops/rope.py): none, linear, llama3, yarn and longrope.

The rotation is the split-half (neox) form, computed in float32 and cast
back. Frequencies are small [head_dim/2] float32 tensors built on the
caller's device.
"""

from __future__ import annotations

import math

import torch

from localai_tpu_torch.models.config import ArchConfig


def rope_frequencies(cfg: ArchConfig, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [head_dim/2], float32."""
    hd = cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim_
    dims = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (cfg.rope_theta ** (dims / hd))
    if cfg.rope_scaling == "linear":
        inv_freq = inv_freq / cfg.rope_scaling_factor
    elif cfg.rope_scaling == "llama3":
        # Llama-3.1/3.2 long-context NTK-by-parts scaling.
        low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smooth = torch.clamp(smooth, 0.0, 1.0)
        mid = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen, scaled,
            torch.where(wavelen < high_wavelen, inv_freq, mid),
        )
    elif cfg.rope_scaling == "yarn":
        # YaRN: interpolate low frequencies by `factor`, keep high ones, with
        # a linear ramp between the beta_fast / beta_slow rotation counts.
        factor = cfg.rope_scaling_factor
        orig = cfg.rope_original_max_position

        def correction_dim(n_rot: float) -> float:
            return (hd * math.log(orig / (n_rot * 2 * math.pi))) / (
                2 * math.log(cfg.rope_theta)
            )

        low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
        high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), hd - 1)
        ramp = torch.clamp((dims / 2 - low) / max(high - low, 1e-3), 0.0, 1.0)
        extrapolation_factor = 1.0 - ramp
        inv_freq = (
            inv_freq / factor * (1.0 - extrapolation_factor)
            + inv_freq * extrapolation_factor
        )
    elif cfg.rope_scaling == "longrope":
        # Phi-3 LongRoPE: a published per-frequency rescale table; the long
        # table serves when the deployment window exceeds the training one.
        use_long = cfg.max_position > cfg.rope_original_max_position
        table = cfg.rope_long_factor if use_long else cfg.rope_short_factor
        if table is None:
            raise ValueError("rope_scaling 'longrope' requires long/short factor tables")
        ext = _factor_table(tuple(table), device)
        if ext.shape[0] != hd // 2:
            raise ValueError(
                f"longrope factor table has {ext.shape[0]} entries, head_dim "
                f"{hd} needs {hd // 2}"
            )
        inv_freq = 1.0 / (ext * cfg.rope_theta ** (dims / hd))
    elif cfg.rope_scaling not in (None, ""):
        raise ValueError(f"unknown rope_scaling {cfg.rope_scaling!r}")
    return inv_freq


# LongRoPE factor tables on their devices, made once: a decode block reads
# them inside a CUDA graph capture, where a host-to-device copy may not run.
_FACTOR_TABLES: dict[tuple, torch.Tensor] = {}


def _factor_table(table: tuple, device) -> torch.Tensor:
    key = (table, str(torch.device(device) if device is not None else "cpu"))
    ext = _FACTOR_TABLES.get(key)
    if ext is None:
        ext = _FACTOR_TABLES[key] = torch.tensor(table, dtype=torch.float32, device=device)
    return ext


def rope_frequencies_local(cfg: ArchConfig, device=None) -> torch.Tensor | None:
    """Sliding (local) layers' inverse frequencies, or None when all layers
    share one schedule (gemma-3 local layers run an unscaled base)."""
    if not cfg.rope_local_theta:
        return None
    hd = cfg.head_dim_
    dims = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (cfg.rope_local_theta ** (dims / hd))


def rope_query_amp(cfg: ArchConfig) -> float:
    """Static query pre-multiplier carrying the scaling family's attention-
    amplitude correction (m² on q alone ≡ m on both cos/sin tables)."""
    if cfg.rope_scaling == "yarn":
        m = (
            cfg.rope_attn_factor
            if cfg.rope_attn_factor is not None
            else 0.1 * math.log(cfg.rope_scaling_factor) + 1.0
        )
        return float(m * m)
    if cfg.rope_scaling == "longrope":
        if cfg.rope_attn_factor is not None:
            m = cfg.rope_attn_factor
        else:
            factor = cfg.max_position / max(cfg.rope_original_max_position, 1)
            m = (
                math.sqrt(1.0 + math.log(factor) / math.log(cfg.rope_original_max_position))
                if factor > 1.0
                else 1.0
            )
        return float(m * m)
    return 1.0


def rope_rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Split-half rotation from angles [..., seq, head_dim/2];
    x: [..., seq, heads, head_dim]."""
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate half-pairs. x: [..., seq, heads, head_dim], positions: [..., seq]."""
    angles = positions[..., :, None].float() * inv_freq  # [..., seq, hd/2]
    return rope_rotate(x, angles)
