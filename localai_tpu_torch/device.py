"""Device choice for the port's entry points.

The port runs on the card. An entry point given no device takes `cuda` and
raises when there is none; the CPU serves only callers that ask for it by
name (the tests do, to compare with the JAX package).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: localai_tpu_torch runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch paths on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
