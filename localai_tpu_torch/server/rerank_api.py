"""Rerank (jina-compatible) endpoint: `/v1/rerank` and `/rerank`
(localai_tpu/server/rerank_api.py).

Reference: core/http/routes/jina.go → endpoints/jina/rerank.go (query +
documents → relevance-sorted results). A llama model scores each document
by its mean log-likelihood given the query (`Engine.rerank`), a `bert`
cross-encoder by its classification head (`BertEngine.rerank`). Only a
model whose config serves the RERANK usecase is asked. Not ported yet:
`/v1/detection`, which the reference registers here (ROADMAP Queue A item
13, satellite engines and models).
"""

from __future__ import annotations

import numpy as np

from localai_tpu_torch.config import Usecase
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.manager import ModelManager
from localai_tpu_torch.server.openai_api import OpenAIApi


class RerankApi:
    def __init__(self, manager: ModelManager, base: OpenAIApi):
        self.manager = manager
        self._base = base

    def register(self, r: Router) -> None:
        r.add("POST", "/v1/rerank", self.rerank)
        r.add("POST", "/rerank", self.rerank)

    def rerank(self, req: Request) -> Response:
        body = req.body or {}
        query = body.get("query")
        documents = body.get("documents")
        if not query or not isinstance(query, str):
            raise ApiError(400, "query is required")
        if not documents or not isinstance(documents, list):
            raise ApiError(400, "documents must be a non-empty array")
        docs = [d.get("text", "") if isinstance(d, dict) else str(d) for d in documents]
        top_n = int(body.get("top_n") or len(docs))

        lm, lease = self._base._resolve(req, Usecase.RERANK)
        try:
            tok = lm.engine.tokenizer
            q_ids = tok.encode(query) or [0]
            d_ids = [tok.encode(d) or [0] for d in docs]
            scores = lm.engine.rerank(q_ids, d_ids)
        finally:
            lease.release()

        order = np.argsort(-scores)[:top_n]
        results = [
            {"index": int(i), "relevance_score": float(scores[i]), "document": {"text": docs[i]}}
            for i in order
        ]
        n_tokens = len(q_ids) + sum(len(d) for d in d_ids)
        return Response(body={
            "model": lm.cfg.name,
            "results": results,
            "usage": {"total_tokens": n_tokens, "prompt_tokens": n_tokens},
        })
