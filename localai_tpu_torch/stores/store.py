"""In-memory vector store with cosine top-k on the device
(localai_tpu/stores/store.py).

Semantics as the reference's (backend/go/local-store/store.go):
- set: upsert by exact key (float bit-pattern equality);
- get / delete: exact-key lookup;
- find: cosine-similarity top-k, with the normalized fast path (when every
  stored vector is unit-norm, cosine is the dot product with the
  normalised query and the divide is skipped: store.go's `normalized`).

The keys live once, as one f32 matrix on the store's device; the host
keeps the exact-key index (key bytes -> row) and the values. A find is one
matmul there and a stable descending sort, so tied similarities come back
lowest row first, as `jax.lax.top_k` gives them (`torch.topk` promises no
order on ties), and reads back its k rows; a delete reads the kept rows
back once to rebuild the index. Matmuls are full f32.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.device import resolve_device


def _normalized(rows: np.ndarray) -> bool:
    return bool(np.allclose(np.linalg.norm(rows, axis=-1), 1.0, atol=1e-3))


class VectorStore:
    def __init__(self, dim: Optional[int] = None, device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._dev_keys: Optional[torch.Tensor] = None  # [N, dim] f32
        self._values: list[bytes] = []
        self._index: dict[bytes, int] = {}  # key bytes -> row
        self._all_normalized = True

    def __len__(self) -> int:
        return len(self._values)

    def _check_dim(self, arr: np.ndarray) -> None:
        if self.dim is None:
            self.dim = arr.shape[-1]
        elif arr.shape[-1] != self.dim:
            raise ValueError(f"key dim {arr.shape[-1]} != store dim {self.dim}")

    def set(self, keys: np.ndarray, values: list[bytes]) -> None:
        keys = np.asarray(keys, np.float32)
        if keys.ndim != 2 or len(keys) != len(values):
            raise ValueError("keys must be [N, D] with one value per key")
        with self._lock:
            self._check_dim(keys)
            new_rows: list[np.ndarray] = []
            for k, v in zip(keys, values):
                kb = k.tobytes()
                row = self._index.get(kb)
                if row is not None:
                    self._values[row] = v  # upsert (also dedupes within a batch)
                else:
                    self._index[kb] = len(self._values)
                    self._values.append(v)
                    new_rows.append(k)
            if new_rows:
                stacked = np.stack(new_rows)
                new_dev = torch.from_numpy(stacked).to(self.device)
                self._dev_keys = (new_dev if self._dev_keys is None
                                  else torch.cat([self._dev_keys, new_dev]))
                # Only the new rows need checking (O(new), not O(N)).
                self._all_normalized = self._all_normalized and _normalized(stacked)

    def get(self, keys: np.ndarray) -> list[Optional[bytes]]:
        keys = np.asarray(keys, np.float32)
        with self._lock:
            out = []
            for k in keys:
                row = self._index.get(k.tobytes())
                out.append(self._values[row] if row is not None else None)
            return out

    def delete(self, keys: np.ndarray) -> int:
        keys = np.asarray(keys, np.float32)
        with self._lock:
            rows = {r for k in keys if (r := self._index.get(k.tobytes())) is not None}
            if not rows:
                return 0
            keep = np.ones(len(self._values), bool)
            keep[sorted(rows)] = False
            self._dev_keys = self._dev_keys[torch.from_numpy(keep).to(self.device)]
            kept = self._dev_keys.cpu().numpy()
            self._values = [v for i, v in enumerate(self._values) if keep[i]]
            self._index = {k.tobytes(): i for i, k in enumerate(kept)}
            if not self._all_normalized and len(kept):
                # Removing the offending rows may restore the fast path.
                self._all_normalized = _normalized(kept)
            elif not len(kept):
                self._all_normalized = True
            return len(rows)

    def find(self, key: np.ndarray, topk: int) -> tuple[np.ndarray, list[bytes], np.ndarray]:
        """Returns (keys [K, D], values, similarities [K]) sorted
        descending, ties lowest row first."""
        q = np.asarray(key, np.float32).reshape(-1)
        with self._lock:
            if not len(self._values):
                return np.zeros((0, self.dim or len(q)), np.float32), [], np.zeros((0,), np.float32)
            if self.dim is not None and len(q) != self.dim:
                raise ValueError(f"query dim {len(q)} != store dim {self.dim}")
            dev_mat = self._dev_keys
            values = list(self._values)
            normalized = self._all_normalized  # a snapshot with mat, same lock
        k = min(topk, len(values))
        if k <= 0:
            return np.zeros((0, self.dim), np.float32), [], np.zeros((0,), np.float32)
        # The query is always normalised (store.go requires both sides
        # normalised for the fast path; normalising q makes the flag about
        # the stored rows only).
        qn = q / max(float(np.linalg.norm(q)), 1e-9)
        sims = dev_mat @ torch.from_numpy(qn).to(self.device)
        if not normalized:
            sims = sims / dev_mat.norm(dim=-1).clamp(min=1e-9)
        vals, idx = torch.sort(sims, descending=True, stable=True)
        idx = idx[:k]
        rows = idx.cpu().numpy()
        return dev_mat[idx].cpu().numpy(), [values[i] for i in rows], vals[:k].cpu().numpy()


class StoreRegistry:
    """Named stores on one device, created on first use (the reference
    runs one store per loaded local-store backend; here a name → store
    map)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._stores: dict[str, VectorStore] = {}
        self._lock = threading.Lock()

    def get(self, name: str = "") -> VectorStore:
        with self._lock:
            if name not in self._stores:
                self._stores[name] = VectorStore(device=self.device)
            return self._stores[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._stores)
