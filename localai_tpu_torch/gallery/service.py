"""Async model-install jobs with progress polling (a copy of
localai_tpu/gallery/service.py; the Hugging Face endpoint of `hf://` models
is a parameter, ApplicationConfig.hf_endpoint in the server).

Reference: core/services/gallery.go (job queue consumed by a worker
goroutine; per-op status in an OpCache polled at /models/jobs/:uuid) +
core/gallery/models.go:75-159 (resolve entry → download files with
resume+SHA → write per-model YAML) and :363 DeleteModelFromSystem.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import re
import shutil
import threading
import time
import uuid as uuidlib
from typing import Any, Optional

import yaml

from localai_tpu_torch.downloader import download
from localai_tpu_torch.downloader.hf_api import DEFAULT_HF_ENDPOINT
from localai_tpu_torch.gallery.gallery import Gallery, GalleryEntry, find_entry, load_index

log = logging.getLogger("localai_tpu_torch.gallery")

_NAME_RE = re.compile(r"^[a-zA-Z0-9_][a-zA-Z0-9_\-.]*$")


def _safe_name(name: str) -> str:
    """Reject path separators / traversal in model names — these become
    filesystem paths under models_dir (reference: model_config.go:480-508)."""
    if not name or not _NAME_RE.match(name) or ".." in name:
        raise ValueError(f"invalid model name {name!r}")
    return name


def _safe_artifact_path(target_dir: str, filename: str) -> str:
    """Join an index-provided filename under target_dir, refusing escapes —
    a malicious gallery index must not be able to write outside its dir."""
    dest = os.path.realpath(os.path.join(target_dir, filename))
    root = os.path.realpath(target_dir)
    if not (dest == root or dest.startswith(root + os.sep)):
        raise ValueError(f"artifact filename escapes install dir: {filename!r}")
    return dest


@dataclasses.dataclass
class InstallJob:
    uuid: str
    name: str
    status: str = "pending"  # pending | downloading | done | error
    progress: float = 0.0  # 0..100
    message: str = ""
    error: Optional[str] = None
    downloaded_files: list[str] = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict[str, Any]:
        return {
            "uuid": self.uuid,
            "name": self.name,
            "processed": self.status in ("done", "error"),
            "status": self.status,
            "progress": round(self.progress, 1),
            "message": self.message,
            "error": self.error,
            "downloaded_files": self.downloaded_files,
        }


class GalleryService:
    """Owns the configured galleries and the install worker."""

    def __init__(self, models_dir: str, config_loader=None, galleries: Optional[list[Gallery]] = None,
                 hf_endpoint: str = DEFAULT_HF_ENDPOINT):
        self.models_dir = models_dir
        self.hf_endpoint = hf_endpoint
        self.config_loader = config_loader  # ModelConfigLoader to refresh after installs
        self.galleries: list[Gallery] = list(galleries or [])
        self.jobs: dict[str, InstallJob] = {}
        self._lock = threading.Lock()
        self._q: "queue.Queue[tuple[InstallJob, GalleryEntry, dict]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # Galleries
    # ------------------------------------------------------------------ #

    def add_gallery(self, name: str, url: str) -> None:
        with self._lock:
            if any(g.name == name for g in self.galleries):
                raise ValueError(f"gallery {name!r} already configured")
            self.galleries.append(Gallery(name=name, url=url))

    def remove_gallery(self, name: str) -> bool:
        with self._lock:
            before = len(self.galleries)
            self.galleries = [g for g in self.galleries if g.name != name]
            return len(self.galleries) < before

    def list_available(self) -> list[dict[str, Any]]:
        out = []
        for g in list(self.galleries):
            try:
                for e in load_index(g):
                    out.append({
                        "id": e.id, "name": e.name, "description": e.description,
                        "license": e.license, "tags": e.tags, "gallery": g.name,
                        "installed": self.installed(e.name),
                    })
            except Exception as err:  # noqa: BLE001 — one bad gallery must not hide others
                log.warning("gallery %s: %s", g.name, err)
        return out

    def _installed(self, name: str) -> bool:
        if not _NAME_RE.match(name or ""):
            return False  # never turn an index-supplied name into a path
        return os.path.exists(os.path.join(self.models_dir, f"{name}.yaml"))

    # ------------------------------------------------------------------ #
    # Install jobs
    # ------------------------------------------------------------------ #

    def apply(
        self,
        entry_id: Optional[str] = None,
        name: Optional[str] = None,
        overrides: Optional[dict[str, Any]] = None,
        files: Optional[list[dict[str, str]]] = None,
    ) -> str:
        """Queue an install; returns the job uuid (poll via `job()`).

        Either `entry_id` resolves against the configured galleries, or an
        inline entry is given via `files` (+ overrides) — mirroring the
        reference's /models/apply accepting both gallery ids and raw URLs.
        """
        if entry_id:
            entry = find_entry(self.galleries, entry_id)
            if entry is None:
                raise KeyError(f"gallery entry {entry_id!r} not found")
        elif files or overrides:
            if not name:
                raise ValueError("name is required for inline installs")
            entry = GalleryEntry(name=name, files=list(files or []), overrides=dict(overrides or {}))
        else:
            raise ValueError("either id or files/overrides is required")

        job = InstallJob(uuid=str(uuidlib.uuid4()), name=_safe_name(name or entry.name))
        with self._lock:
            self.jobs[job.uuid] = job
        self._q.put((job, entry, dict(overrides or {})))
        self._ensure_worker()
        return job.uuid

    def job(self, job_uuid: str) -> Optional[dict[str, Any]]:
        with self._lock:
            j = self.jobs.get(job_uuid)
            return j.to_dict() if j else None

    def installed(self, name: str) -> bool:
        """Is this model present — via gallery install or any loaded config
        (covers .yml files and multi-doc models.yaml too)?"""
        if not _NAME_RE.match(name or ""):
            return False
        if self.config_loader is not None and getattr(self.config_loader, "get", None):
            if self.config_loader.get(name) is not None:
                return True
        return self._installed(name)

    def delete_model(self, name: str) -> bool:
        """Remove an installed model's YAML + artifact dir (models.go:363)."""
        _safe_name(name)
        removed = False
        ypath = os.path.join(self.models_dir, f"{name}.yaml")
        if os.path.exists(ypath):
            os.remove(ypath)
            removed = True
        adir = os.path.join(self.models_dir, name)
        if os.path.isdir(adir):
            shutil.rmtree(adir)
            removed = True
        if removed and self.config_loader is not None:
            self.config_loader.load_all()
        return removed

    # ------------------------------------------------------------------ #
    # Worker
    # ------------------------------------------------------------------ #

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, daemon=True, name="gallery-install"
            )
            self._worker.start()

    def _run(self) -> None:
        while True:
            job, entry, overrides = self._q.get()
            try:
                self._install(job, entry, overrides)
                job.status = "done"
                job.progress = 100.0
                job.message = f"installed {job.name}"
            except Exception as e:  # noqa: BLE001 — job must record its failure
                log.exception("install %s failed", job.name)
                job.status = "error"
                job.error = f"{type(e).__name__}: {e}"

    def _install(self, job: InstallJob, entry: GalleryEntry, overrides: dict[str, Any]) -> None:
        job.status = "downloading"
        name = job.name
        target_dir = os.path.join(self.models_dir, name)
        nfiles = max(1, len(entry.files))
        for i, f in enumerate(entry.files):
            fname = f.get("filename") or os.path.basename(f["uri"])
            job.message = f"downloading {fname}"

            def progress(done: int, total: int, _i=i) -> None:
                frac = (done / total) if total > 0 else 0.0
                job.progress = 95.0 * (_i + min(1.0, frac)) / nfiles

            dest = download(
                f["uri"], _safe_artifact_path(target_dir, fname),
                sha256=f.get("sha256"), progress=progress,
            )
            job.downloaded_files.append(dest)
            job.progress = 95.0 * (i + 1) / nfiles

        cfg: dict[str, Any] = {"name": name}
        if entry.files:
            cfg["model"] = target_dir
        cfg.update(entry.overrides)
        cfg.update(overrides)
        cfg["name"] = name  # overrides must not detach the config from the job
        for field in ("model", "tokenizer", "draft_model"):
            val = cfg.get(field)
            if isinstance(val, str) and val.startswith("hf://"):
                # Whole-repo HF checkpoint: fetch config + safetensors +
                # tokenizer with resume (downloader/hf_api.py) instead of
                # enumerating shard filenames in the index.
                from localai_tpu_torch.downloader.hf_api import fetch_hf_model

                repo = val[len("hf://"):]
                job.message = f"fetching {repo}"

                def progress(path, done, total):
                    job.message = f"downloading {os.path.basename(path)}"

                sub = target_dir if field == "model" else os.path.join(
                    target_dir, field
                )
                fetch_hf_model(repo, sub, progress=progress, endpoint=self.hf_endpoint)
                job.downloaded_files.append(sub)
                cfg[field] = sub
        with open(os.path.join(self.models_dir, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
        if self.config_loader is not None:
            self.config_loader.load_all()
