"""Output post-processing ("finetune" in reference terms; a copy of
localai_tpu/utils/finetune.py).

Reference: core/backend/llm.go:217-265 Finetune — echo, cutstrings regex
removal, extract_regex harvesting (e.g. pull a result out of XML tags),
trim_space prefixes, trim_suffix suffixes — applied to every LLM prediction
before it is returned.
"""

from __future__ import annotations

import re
import threading

_cache: dict[str, re.Pattern] = {}
_lock = threading.Lock()


def _regex(pattern: str) -> re.Pattern:
    with _lock:
        rx = _cache.get(pattern)
        if rx is None:
            rx = _cache[pattern] = re.compile(pattern)
        return rx


def finetune(cfg, prompt: str, prediction: str) -> str:
    """Apply a model config's output post-processing chain.

    Order matches the reference: echo → cutstrings → extract_regex →
    trim_space → trim_suffix.
    """
    if getattr(cfg, "echo", False):
        prediction = prompt + prediction

    for pattern in getattr(cfg, "cutstrings", None) or []:
        prediction = _regex(pattern).sub("", prediction)

    extracted = ""
    for pattern in getattr(cfg, "extract_regex", None) or []:
        m = _regex(pattern).search(prediction)
        if m:
            extracted += m.group(0)
    if extracted:
        prediction = extracted

    for prefix in getattr(cfg, "trim_space", None) or []:
        prediction = prediction.removeprefix(prefix).strip()

    for suffix in getattr(cfg, "trim_suffix", None) or []:
        prediction = prediction.removesuffix(suffix).strip()
    return prediction


def needs_finetune(cfg) -> bool:
    return bool(
        getattr(cfg, "echo", False)
        or getattr(cfg, "cutstrings", None)
        or getattr(cfg, "extract_regex", None)
        or getattr(cfg, "trim_space", None)
        or getattr(cfg, "trim_suffix", None)
    )
