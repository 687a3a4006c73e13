"""Gallery index: YAML-over-URI model listings (a copy of
localai_tpu/gallery/gallery.py).

Reference format (gallery/index.yaml + core/gallery/gallery.go:22-80): a YAML
list of entries with `name`, `description`, `license`, `tags`, `files`
(filename/uri/sha256) and config `overrides`. This loader accepts the same
shape; `config` / `overrides` become ModelConfig fields.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional

import yaml

from localai_tpu_torch.downloader import download


@dataclasses.dataclass
class GalleryEntry:
    name: str
    description: str = ""
    license: str = ""
    tags: list[str] = dataclasses.field(default_factory=list)
    # Artifact files: [{"filename": ..., "uri": ..., "sha256": ...}]
    files: list[dict[str, str]] = dataclasses.field(default_factory=list)
    # ModelConfig overrides written into the installed YAML.
    overrides: dict[str, Any] = dataclasses.field(default_factory=dict)
    gallery: str = ""  # owning gallery name

    @property
    def id(self) -> str:
        return f"{self.gallery}@{self.name}" if self.gallery else self.name

    @classmethod
    def from_dict(cls, d: dict[str, Any], gallery: str = "") -> "GalleryEntry":
        return cls(
            name=str(d.get("name", "")),
            description=str(d.get("description", "")),
            license=str(d.get("license", "")),
            tags=list(d.get("tags") or []),
            files=[dict(f) for f in (d.get("files") or [])],
            overrides=dict(d.get("overrides") or d.get("config") or {}),
            gallery=gallery,
        )


@dataclasses.dataclass
class Gallery:
    name: str
    url: str


_INDEX_TTL_S = 30.0
_index_cache: dict[str, tuple[float, list[GalleryEntry]]] = {}


def load_index(gallery: Gallery, ttl: float = _INDEX_TTL_S) -> list[GalleryEntry]:
    """Fetch and parse a gallery's index.yaml (file:// or http(s)).

    A short-TTL in-memory cache keeps UI polling of /models/available from
    re-fetching every index on every request."""
    import time

    cached = _index_cache.get(gallery.url)
    if cached is not None and time.monotonic() - cached[0] < ttl:
        return cached[1]
    with tempfile.TemporaryDirectory() as td:
        path = download(gallery.url, os.path.join(td, "index.yaml"))
        with open(path) as f:
            docs = yaml.safe_load(f)
    if docs is None:
        return []
    if not isinstance(docs, list):
        raise ValueError(f"gallery {gallery.name}: index must be a YAML list")
    out = []
    for d in docs:
        if isinstance(d, dict) and d.get("name"):
            out.append(GalleryEntry.from_dict(d, gallery=gallery.name))
    _index_cache[gallery.url] = (time.monotonic(), out)
    return out


def find_entry(
    galleries: list[Gallery], entry_id: str
) -> Optional[GalleryEntry]:
    """Resolve "gallery@name" or bare "name" across configured galleries.

    Per-gallery fetch failures are isolated (like list_available) so one
    broken gallery cannot mask an entry present in a healthy one."""
    import logging

    want_gallery, _, want_name = entry_id.rpartition("@")
    for g in galleries:
        if want_gallery and g.name != want_gallery:
            continue
        try:
            entries = load_index(g)
        except Exception as e:  # noqa: BLE001 — skip broken galleries
            logging.getLogger("localai_tpu_torch.gallery").warning("gallery %s: %s", g.name, e)
            continue
        for e in entries:
            if e.name == want_name:
                return e
    return None
