"""Gallery HTTP endpoints: browse, install (async job), poll, delete (a copy
of localai_tpu/server/gallery_api.py).

Reference routes (core/http/routes/localai.go:43-74 + endpoints/localai/
gallery.go): GET /models/available, POST /models/apply, GET
/models/jobs/:uuid, POST/DELETE /models/galleries, DELETE /models/:name
(endpoints/localai/import_model.go handles raw installs the same way the
inline files/overrides form does here).
"""

from __future__ import annotations

from typing import Any

from localai_tpu_torch.gallery import GalleryService
from localai_tpu_torch.server.app import ApiError, Request, Response, Router


class GalleryApi:
    def __init__(self, service: GalleryService, manager=None):
        self.service = service
        self.manager = manager  # for unloading deleted models

    def register(self, r: Router) -> None:
        r.add("GET", "/models/available", self.available)
        r.add("POST", "/models/apply", self.apply)
        r.add("GET", "/models/jobs/:uuid", self.job)
        r.add("GET", "/models/galleries", self.galleries)
        r.add("POST", "/models/galleries", self.add_gallery)
        r.add("DELETE", "/models/galleries", self.remove_gallery)
        r.add("POST", "/models/delete/:name", self.delete_model)

    def available(self, req: Request) -> Response:
        return Response(body=self.service.list_available())

    def apply(self, req: Request) -> Response:
        body: dict[str, Any] = req.body or {}
        try:
            uuid = self.service.apply(
                entry_id=body.get("id"),
                name=body.get("name"),
                overrides=body.get("overrides") or body.get("config_overrides"),
                files=body.get("files"),
            )
        except KeyError as e:
            raise ApiError(404, str(e)) from None
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return Response(body={"uuid": uuid, "status": f"/models/jobs/{uuid}"})

    def job(self, req: Request) -> Response:
        j = self.service.job(req.params["uuid"])
        if j is None:
            raise ApiError(404, f"job {req.params['uuid']!r} not found")
        return Response(body=j)

    def galleries(self, req: Request) -> Response:
        return Response(body=[
            {"name": g.name, "url": g.url} for g in self.service.galleries
        ])

    def add_gallery(self, req: Request) -> Response:
        body = req.body or {}
        name, url = body.get("name"), body.get("url")
        if not name or not url:
            raise ApiError(400, "name and url are required")
        try:
            self.service.add_gallery(name, url)
        except ValueError as e:
            raise ApiError(409, str(e)) from None
        return Response(body={"status": "ok"})

    def remove_gallery(self, req: Request) -> Response:
        body = req.body or {}
        name = body.get("name")
        if not name:
            raise ApiError(400, "name is required")
        if not self.service.remove_gallery(name):
            raise ApiError(404, f"gallery {name!r} not found")
        return Response(body={"status": "ok"})

    def delete_model(self, req: Request) -> Response:
        name = req.params["name"]
        try:
            # Verify it is actually gallery-installed BEFORE unloading, so a
            # 404 never tears down a running model configured elsewhere.
            if not self.service._installed(name):
                raise ApiError(404, f"model {name!r} is not installed")
            if self.manager is not None:
                self.manager.unload(name)
            self.service.delete_model(name)
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return Response(body={"status": "ok"})
