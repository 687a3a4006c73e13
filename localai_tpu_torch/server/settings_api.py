"""Runtime settings API (a copy of localai_tpu/server/settings_api.py).

Reference: the settings endpoints + runtime_settings.json tier (LocalAI
persists mutable settings and applies them over flags at boot). GET returns
the mutable set; PUT applies changes live (watchdog budgets, LRU budget,
machine tag) and persists them when a runtime_settings_path is configured.
"""

from __future__ import annotations

from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.manager import ModelManager


class SettingsApi:
    def __init__(self, app_cfg: ApplicationConfig, manager: ModelManager):
        self.app_cfg = app_cfg
        self.manager = manager

    def register(self, r: Router) -> None:
        r.add("GET", "/settings", self.get)
        r.add("PUT", "/settings", self.put)
        r.add("POST", "/settings", self.put)

    def get(self, req: Request) -> Response:
        """Current mutable runtime settings."""
        return Response(body={
            k: getattr(self.app_cfg, k) for k in ApplicationConfig.RUNTIME_MUTABLE
        })

    def put(self, req: Request) -> Response:
        """Apply + persist runtime settings ({key: value} subset)."""
        body = req.body or {}
        unknown = set(body) - set(ApplicationConfig.RUNTIME_MUTABLE)
        if unknown:
            raise ApiError(400, f"unknown or immutable settings: {sorted(unknown)}")
        for k, v in body.items():
            field_type = type(getattr(self.app_cfg, k))
            try:
                setattr(self.app_cfg, k, field_type(v))
            except (TypeError, ValueError):
                raise ApiError(400, f"invalid value for {k}: {v!r}") from None
        # Live application: the watchdog thread may need to exist now.
        if (
            self.app_cfg.watchdog_idle_timeout_s > 0
            or self.app_cfg.watchdog_busy_timeout_s > 0
        ):
            self.manager.ensure_watchdog()
        self.app_cfg.save_runtime_settings()
        return Response(body=self.get(req).body)
