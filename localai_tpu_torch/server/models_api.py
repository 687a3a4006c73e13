"""Model import / edit / reload endpoints (a copy of
localai_tpu/server/models_api.py; Hugging Face imports fetch from
ApplicationConfig.hf_endpoint).

Reference: endpoints/localai/import_model.go (POST /models/import,
/models/import-uri with config discovery) and edit_model.go (edit +
ReloadModelsEndpoint). Import writes a YAML into the models dir through the
same loader the boot path uses; URI imports run as async jobs (HF repo
checkpoints fetched file-by-file with resume).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import uuid
from typing import Any, Optional

from localai_tpu_torch.config import ModelConfig
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.manager import ModelManager

log = logging.getLogger("localai_tpu_torch.models_api")


def discover_model_config(uri: str, name: str = "",
                          preferences: Optional[dict] = None) -> dict[str, Any]:
    """Build a model-config dict from a URI (reference: importers.
    DiscoverModelConfig). Supported: arch presets, file:// checkpoint dirs,
    huggingface://owner/repo."""
    from localai_tpu_torch.models.config import PRESETS

    prefs = preferences or {}
    if uri in PRESETS:
        return {"name": name or uri, "model": uri, **prefs}
    if uri.startswith("file://"):
        path = uri[len("file://"):]
        if not os.path.isdir(path):
            raise ApiError(400, f"checkpoint dir {path!r} not found")
        return {"name": name or os.path.basename(path.rstrip("/")), "model": path, **prefs}
    if uri.startswith("huggingface://"):
        repo = uri[len("huggingface://"):].strip("/")
        if repo.count("/") != 1:
            raise ApiError(400, "huggingface:// import needs owner/repo")
        default = repo.split("/")[1].lower()
        cfg = {"name": name or default, "model": repo, "_hf_repo": repo, **prefs}
        if "whisper" in repo.lower():
            cfg.setdefault("backend", "whisper")
        if any(k in repo.lower() for k in ("bge", "minilm", "e5-")):
            cfg.setdefault("backend", "bert")
        return cfg
    raise ApiError(400, f"cannot discover a model config from {uri!r}")


class ModelsApi:
    def __init__(self, manager: ModelManager):
        self.manager = manager
        self._jobs: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()

    def register(self, r: Router) -> None:
        r.add("POST", "/models/import", self.import_model)
        r.add("POST", "/models/import-uri", self.import_uri)
        r.add("GET", "/models/import-jobs/:uuid", self.import_job)
        r.add("GET", "/models/config/:name", self.get_config)
        r.add("POST", "/models/edit/:name", self.edit_model)
        r.add("PUT", "/models/edit/:name", self.edit_model)
        r.add("POST", "/models/reload", self.reload)

    # ------------------------------------------------------------------ #

    def import_model(self, req: Request) -> Response:
        """Create a model config from an explicit dict (import_model.go)."""
        body = req.body or {}
        if not isinstance(body, dict) or not body:
            raise ApiError(400, "model config object required")
        try:
            cfg = ModelConfig.from_dict(dict(body))
            if not cfg.name:
                raise ValueError("name is required")
            path = self.manager.configs.write(cfg)
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid model config: {e}") from None
        return Response(status=201, body={"name": cfg.name, "path": path})

    def import_uri(self, req: Request) -> Response:
        """Discover + install a model from a URI; async for HF repos."""
        body = req.body or {}
        uri = body.get("uri")
        if not uri or not isinstance(uri, str):
            raise ApiError(400, "uri is required")
        cfg_dict = discover_model_config(
            uri, name=body.get("name", ""), preferences=body.get("preferences") or {}
        )
        repo = cfg_dict.pop("_hf_repo", None)
        if repo is None:
            cfg = ModelConfig.from_dict(cfg_dict)
            path = self.manager.configs.write(cfg)
            return Response(status=201, body={
                "name": cfg.name, "path": path, "status": "installed",
            })

        job_id = uuid.uuid4().hex
        job = {"uuid": job_id, "name": cfg_dict["name"], "uri": uri,
               "processed": False, "error": None, "message": "downloading",
               "progress": 0.0, "started_at": time.time()}
        with self._lock:
            self._jobs[job_id] = job

        def run() -> None:
            try:
                from localai_tpu_torch.downloader import fetch_hf_model

                dest = os.path.join(self.manager.app_cfg.models_dir, cfg_dict["name"])

                def progress(fname, done, total):
                    job["message"] = f"downloading {fname}"
                    if total > 0:
                        job["progress"] = round(done / total * 100.0, 1)

                fetch_hf_model(repo, dest, progress=progress,
                               endpoint=self.manager.app_cfg.hf_endpoint)
                cfg_dict["model"] = dest
                cfg = ModelConfig.from_dict(cfg_dict)
                self.manager.configs.write(cfg)
                job["message"] = "installed"
            except Exception as e:  # noqa: BLE001 — surfaced via the job
                job["error"] = f"{type(e).__name__}: {e}"
                job["message"] = "failed"
                log.warning("import of %s failed: %s", uri, e)
            finally:
                job["processed"] = True

        threading.Thread(target=run, daemon=True,
                         name="models-import").start()
        return Response(status=202, body={"uuid": job_id, "name": cfg_dict["name"]})

    def import_job(self, req: Request) -> Response:
        with self._lock:
            job = self._jobs.get(req.params["uuid"])
        if job is None:
            raise ApiError(404, f"import job {req.params['uuid']!r} not found")
        return Response(body=job)

    # ------------------------------------------------------------------ #

    def get_config(self, req: Request) -> Response:
        """Full persisted config for one model (the WebUI editor's source)."""
        name = req.params["name"]
        cfg = self.manager.configs.get(name)
        if cfg is None:
            raise ApiError(404, f"model {name!r} not found")
        return Response(body=cfg.to_dict())

    def edit_model(self, req: Request) -> Response:
        """Patch + persist a model config; the loaded engine is evicted so
        the next request serves the new config (edit_model.go)."""
        name = req.params["name"]
        cfg = self.manager.configs.get(name)
        if cfg is None:
            raise ApiError(404, f"model {name!r} not found")
        body = req.body or {}
        if not isinstance(body, dict) or not body:
            raise ApiError(400, "patch object required")
        merged = cfg.to_dict()
        merged.update(body)
        merged["name"] = name  # renames go through import+delete
        try:
            new_cfg = ModelConfig.from_dict(merged)
            self.manager.configs.write(new_cfg)
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid model config: {e}") from None
        if self.manager.peek(name) is not None:
            self.manager.unload(name, drain_s=10.0)
        return Response(body=new_cfg.to_dict())

    def reload(self, req: Request) -> Response:
        """Re-read every model YAML (ReloadModelsEndpoint)."""
        evicted = self.manager.reload_configs()
        return Response(body={
            "status": "reloaded",
            "models": self.manager.configs.names(),
            "evicted": evicted,
        })
