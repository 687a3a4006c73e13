"""Resident engine for BERT-family encoders: embeddings and cross-encoder
rerank (localai_tpu/engine/bert_engine.py).

No loop thread: each call pads its rows to a power-of-two bucket (16 up to
the model's max_position), runs one forward under the engine's lock and
returns numpy arrays. The engine also has the members the model manager's
supervision reads of every engine (`is_dead` always False, an empty
`postmortem_path`, no `journal`, `drop_device_state`, `cancel_all`,
`metrics`), so /system, /backend/monitor, the watchdog and eviction treat
a BERT model as any other.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from localai_tpu_torch.engine.engine import pad_rows
from localai_tpu_torch.models import bert as bert_model


def _bucket(n: int, lo: int = 16, hi: int = 512) -> int:
    b = lo
    while b < min(n, hi):
        b *= 2
    return min(b, hi)


class BertEngine:
    is_dead = False  # no loop to die
    postmortem_path = ""
    journal = None

    def __init__(self, cfg: bert_model.BertConfig, params: Any, tokenizer):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params["word_embed"].device
        self._lock = threading.Lock()
        self.m_requests = 0
        self._busy_time = 0.0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def cancel_all(self) -> int:
        return 0

    def drop_device_state(self) -> None:
        """Drop the weights, so their memory returns to the allocator now."""
        with self._lock:
            self.params = None

    def metrics(self) -> dict[str, float]:
        return {"requests": float(self.m_requests), "busy_seconds": self._busy_time}

    def _run(self, fn, *arrays: np.ndarray) -> np.ndarray:
        """fn(params, *tensors) under the lock, counted and timed."""
        t0 = time.monotonic()
        with self._lock:
            if self.params is None:
                raise RuntimeError(f"model {self.cfg.name!r} was unloaded")
            ts = [torch.from_numpy(a).to(self.device) for a in arrays]
            out = fn(self.params, *ts).cpu().numpy()
            self.m_requests += 1
            self._busy_time += time.monotonic() - t0
        return out

    def embed(self, ids_batch: list[list[int]]) -> np.ndarray:
        """L2-normalised embeddings [N, D], rows cut to the bucket."""
        S = _bucket(max(len(x) for x in ids_batch), hi=self.cfg.max_position)
        toks, lens = pad_rows(ids_batch, S)
        return self._run(lambda p, t, n: bert_model.embed(self.cfg, p, t, n), toks, lens)

    def rerank(self, query_ids: list[int], docs_ids: list[list[int]]) -> np.ndarray:
        """Cross-encoder scores [N] over [CLS] q [SEP] d [SEP] rows; the
        tokenizer's `cls_id` / `sep_id` where it has them. The query is cut
        to max_position // 2, each document to what is left."""
        if self.cfg.num_labels <= 0:
            raise RuntimeError(f"model {self.cfg.name!r} has no classification head")
        sep = getattr(self.tokenizer, "sep_id", None)
        cls = getattr(self.tokenizer, "cls_id", None)
        limit = self.cfg.max_position
        q = list(query_ids)[:limit // 2]
        rows, types = [], []
        for d in docs_ids:
            d = list(d)[:limit - len(q) - 3] or [0]
            row = ([cls] if cls is not None else []) + q
            tt = [0] * len(row)
            if sep is not None:
                row, tt = row + [sep], tt + [0]
            row, tt = row + d, tt + [1] * len(d)
            if sep is not None:
                row, tt = row + [sep], tt + [1]
            rows.append(row[:limit])
            types.append(tt[:limit])
        S = _bucket(max(len(r) for r in rows), hi=limit)
        toks, lens = pad_rows(rows, S)
        tts, _ = pad_rows(types, S)
        return self._run(lambda p, t, n, tt: bert_model.score_pairs(self.cfg, p, t, n, tt),
                         toks, lens, tts)
