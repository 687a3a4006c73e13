"""System / accelerator introspection for `/system` (the port's
counterpart of localai_tpu/utils/sysinfo.py).

Reference: pkg/xsysinfo (CPU caps, GPU VRAM via gonvml). Reported from
`torch.cuda`: each visible GPU's name, compute capability, total and free
memory (`mem_get_info`), plus host RAM and the CPU count. The port serves
one GPU, so `recommend_mesh` answers tensor_parallel 1 until multi-GPU
serving is ported (ROADMAP Queue A item 14, multi-GPU).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _host_ram_bytes() -> Optional[int]:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


def device_names(device: torch.device) -> list[str]:
    """The engines' device, and every visible GPU by index and name."""
    out = [str(device)]
    if torch.cuda.is_available():
        out += [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())]
    return out


def device_info(device: torch.device) -> dict[str, Any]:
    """Per-GPU and aggregate accelerator info (safe on CPU-only hosts)."""
    cuda = torch.cuda.is_available()
    out: dict[str, Any] = {
        "platform": device.type,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [],
        "host_ram_bytes": _host_ram_bytes(),
        "cpu_count": os.cpu_count(),
    }
    for i in range(out["device_count"]):
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        out["devices"].append({
            "id": i,
            "kind": props.name,
            "capability": f"{props.major}.{props.minor}",
            "memory_bytes": int(total),
            "memory_free_bytes": int(free),
            "memory_allocated_bytes": int(torch.cuda.memory_allocated(i)),
            "memory_reserved_bytes": int(torch.cuda.memory_reserved(i)),
        })
    mem = [d["memory_bytes"] for d in out["devices"]]
    out["total_memory_bytes"] = sum(mem) if mem else None
    return out


def recommend_mesh() -> dict[str, int]:
    """Mesh sizes the server would use: one GPU, so tp = 1."""
    return {"dp": 1, "tp": 1, "ep": 1, "sp": 1}
