"""/stores/{set,get,delete,find} endpoints (localai_tpu/server/stores_api.py).

Reference: core/http/endpoints/localai/stores.go + core/backend/stores.go;
request/response shapes follow core/schema (StoresSet/Get/Delete/Find).
The stores' keys live on the registry's device (the card unless the
caller passes another).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.stores import StoreRegistry


class StoresApi:
    def __init__(self, registry: StoreRegistry | None = None):
        self.registry = registry or StoreRegistry()

    def register(self, r: Router) -> None:
        r.add("POST", "/stores/set", self.set)
        r.add("POST", "/stores/get", self.get)
        r.add("POST", "/stores/delete", self.delete)
        r.add("POST", "/stores/find", self.find)

    def _store(self, body: dict[str, Any]):
        return self.registry.get(body.get("store") or "")

    @staticmethod
    def _keys(body: dict[str, Any], field: str = "keys") -> np.ndarray:
        keys = body.get(field)
        if not isinstance(keys, list) or not keys:
            raise ApiError(400, f"{field} must be a non-empty array of float arrays")
        try:
            return np.asarray(keys, np.float32)
        except (ValueError, TypeError):
            raise ApiError(400, f"{field} must be rectangular float arrays") from None

    def set(self, req: Request) -> Response:
        body = req.body or {}
        keys = self._keys(body)
        values = body.get("values")
        if not isinstance(values, list) or len(values) != len(keys):
            raise ApiError(400, "values must be an array matching keys length")
        if not all(isinstance(v, str) for v in values):
            raise ApiError(400, "values must be strings (serialize structured data as JSON)")
        try:
            self._store(body).set(keys, [v.encode() for v in values])
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return Response(body={})

    def get(self, req: Request) -> Response:
        body = req.body or {}
        keys = self._keys(body)
        values = self._store(body).get(keys)
        found_keys, found_vals = [], []
        for k, v in zip(keys, values):
            if v is not None:
                found_keys.append([float(x) for x in k])
                found_vals.append(v.decode("utf-8", "replace"))
        return Response(body={"keys": found_keys, "values": found_vals})

    def delete(self, req: Request) -> Response:
        body = req.body or {}
        keys = self._keys(body)
        self._store(body).delete(keys)
        return Response(body={})

    def find(self, req: Request) -> Response:
        body = req.body or {}
        key = body.get("key")
        if not isinstance(key, list) or not key:
            raise ApiError(400, "key must be a non-empty float array")
        topk_raw = body.get("topk", 10)
        if not isinstance(topk_raw, int) or isinstance(topk_raw, bool) or topk_raw < 0:
            raise ApiError(400, "topk must be a non-negative integer")
        topk = topk_raw
        try:
            keys, values, sims = self._store(body).find(np.asarray(key, np.float32), topk)
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return Response(body={
            "keys": [[float(x) for x in k] for k in keys],
            "values": [v.decode("utf-8", "replace") for v in values],
            "similarities": [float(s) for s in sims],
        })
