"""OpenAI-compatible text endpoints over the port's engine (the text routes
of localai_tpu/server/openai_api.py).

Routes: `/v1/chat/completions` and `/v1/completions` (streamed as SSE with
the usage in the last chunk, or whole), `/v1/models`, `/v1/models/{id}`,
`/readyz`, `/healthz`, `/version`. The `model` field (or the query, or a
bearer token naming a model) selects a model or a virtual model; a virtual
model carries its tenant's adapter into every request. `n > 1` runs as
independent clones, each its own request.

A request field the port cannot honour yet gets HTTP 400 naming it, never
silent neglect: tools / functions, grammar, a JSON response_format,
logprobs, best_of > 1, deadline_s and image content (ROADMAP Queue A items
3, main-path engine completeness; 6, grammar decode on the card; 7, tree
sampling and logprobs; 13, satellite engines and models).
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Any, Iterator, Optional

from localai_tpu_torch import __version__
from localai_tpu_torch.config import LoraConfigError, Usecase
from localai_tpu_torch.engine.engine import AdapterError, GenRequest, QueueFullError
from localai_tpu_torch.server.app import ApiError, Request, Response, Router, SSEStream
from localai_tpu_torch.server.finetune import finetune, needs_finetune
from localai_tpu_torch.server.manager import LoadedModel, ModelManager, UnsupportedBackendError


def _now() -> int:
    return int(time.time())


def _fingerprint() -> str:
    return f"localai-tpu-torch-{__version__}"


def _reject_unported(body: dict[str, Any], chat: bool) -> None:
    """400 for every request field the port cannot honour yet."""
    def unported(field: str, item: str) -> None:
        raise ApiError(400, f"{field!r} is not supported by this server yet "
                            f"(ROADMAP Queue A item {item})")

    grammar = "6, grammar decode on the card"
    logprobs = "7, tree sampling and logprobs"

    tools = body.get("tools") or body.get("functions")
    if tools and body.get("tool_choice") != "none":
        unported("tools" if body.get("tools") else "functions", grammar)
    if body.get("grammar"):
        unported("grammar", grammar)
    rf = body.get("response_format") or {}
    if isinstance(rf, dict) and rf.get("type") in ("json_object", "json_schema"):
        unported("response_format", grammar)
    lp = body.get("logprobs")
    if lp not in (None, False, 0):
        unported("logprobs", logprobs)
    if chat and body.get("top_logprobs"):
        unported("top_logprobs", logprobs)
    bo = body.get("best_of")
    if bo is not None and bo != 1:
        unported("best_of", logprobs)
    if body.get("deadline_s"):
        unported("deadline_s", "3, main-path engine completeness")
    if chat:
        for m in body.get("messages") or []:
            content = m.get("content") if isinstance(m, dict) else None
            if isinstance(content, list) and any(
                    isinstance(p, dict) and p.get("type") in ("image_url", "input_image")
                    for p in content):
                unported("image content", "13, satellite engines and models")


class OpenAIApi:
    def __init__(self, manager: ModelManager):
        self.manager = manager
        self.started_at = time.time()
        self.router: Optional[Router] = None

    def register(self, r: Router) -> None:
        self.router = r
        for prefix in ("/v1", ""):
            r.add("POST", f"{prefix}/chat/completions", self.chat)
            r.add("POST", f"{prefix}/completions", self.completion)
            r.add("GET", f"{prefix}/models", self.list_models)
        r.add("GET", "/v1/models/:name", self.get_model)
        r.add("GET", "/healthz", self.health)
        r.add("GET", "/readyz", self.health)
        r.add("GET", "/version", self.version)
        # Engine gauges (Engine.metrics(), adapter tier included) ride the
        # Prometheus scrape as localai_engine_*{model=...}.
        r.gauge_source = self.engine_gauges

    # ------------------------------------------------------------------ #
    # Helpers
    # ------------------------------------------------------------------ #

    def _resolve_name(self, req: Request, usecase: Usecase) -> str:
        """body → route param → query param → bearer token naming a
        configured model → the first config serving the usecase."""
        body = req.body or {}
        name = body.get("model") or (req.params or {}).get("name")
        if not name:
            name = (req.query.get("model") or [None])[0]
        if not name:
            auth = req.headers.get("authorization", "")
            token = auth[7:] if auth.startswith("Bearer ") else ""
            if token and self.manager.configs.get(token) is not None:
                name = token
        if not name:
            cfg = self.manager.configs.first_with(usecase)
            if cfg is None:
                raise ApiError(404, f"no model configured for {usecase}")
            name = cfg.name
        cfg = self.manager.configs.get(name)
        if cfg is None:
            raise ApiError(404, f"model {name!r} not found")
        if not cfg.has_usecase(usecase):
            raise ApiError(400, f"model {name!r} does not support {usecase}")
        return name

    def _resolve(self, req: Request, usecase: Usecase):
        """Loaded model + idempotent lease, taken atomically w.r.t. eviction."""
        name = self._resolve_name(req, usecase)
        try:
            return self.manager.lease(name)
        except KeyError:
            raise ApiError(404, f"model {name!r} not found") from None
        except LoraConfigError as e:
            raise ApiError(400, str(e)) from None
        except UnsupportedBackendError as e:
            raise ApiError(501, str(e), "server_error") from None

    @staticmethod
    def _submit_all(lm: LoadedModel, gens: list) -> list:
        """Submit every GenRequest: a full queue is 429 + Retry-After, an
        adapter error 400; handles already submitted are cancelled."""
        handles = []
        try:
            for g in gens:
                handles.append(lm.engine.submit(g))
        except QueueFullError as e:
            for h in handles:
                h.cancel()
            raise ApiError(429, str(e), "rate_limit_exceeded", retry_after=e.retry_after_s) from None
        except AdapterError as e:
            for h in handles:
                h.cancel()
            raise ApiError(400, str(e)) from None
        return handles

    def _gen_request(self, lm: LoadedModel, body: dict[str, Any], prompt_ids: list[int],
                     extra_stop: Optional[list[str]] = None) -> GenRequest:
        cfg = lm.cfg
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        stop = list(stop) + [s for s in (extra_stop or []) if s not in stop]
        max_tokens = body.get("max_completion_tokens") or body.get("max_tokens") or cfg.max_tokens

        def pick(key: str, default):
            v = body.get(key)
            return default if v is None else v

        logit_bias = {}
        for k, v in (body.get("logit_bias") or {}).items():
            try:
                logit_bias[int(k)] = float(v)
            except (TypeError, ValueError):
                raise ApiError(400, f"invalid logit_bias entry {k!r}") from None
        return GenRequest(
            prompt_ids=prompt_ids,
            max_new_tokens=int(max_tokens),
            temperature=float(pick("temperature", cfg.temperature)),
            top_k=int(pick("top_k", cfg.top_k)),
            top_p=float(pick("top_p", cfg.top_p)),
            min_p=float(pick("min_p", cfg.min_p)),
            repeat_penalty=float(pick("repeat_penalty", cfg.repeat_penalty)),
            presence_penalty=float(pick("presence_penalty", cfg.presence_penalty)),
            frequency_penalty=float(pick("frequency_penalty", cfg.frequency_penalty)),
            stop=stop,
            seed=body.get("seed", cfg.seed),
            logit_bias=logit_bias,
            # vLLM-style extension: fixed-length generations for benchmarks.
            ignore_eos=bool(body.get("ignore_eos", False)),
            # A virtual model resolves to its base's engine + this tenant.
            adapter=getattr(lm, "adapter", None),
        )

    @staticmethod
    def _n_choices(body: dict[str, Any]) -> int:
        n = body.get("n") or 1
        try:
            n = int(n)
        except (TypeError, ValueError):
            raise ApiError(400, "n must be an integer") from None
        if n < 1 or n > 64:
            raise ApiError(400, "n must be between 1 and 64")
        return n

    @staticmethod
    def _clones(gens_for, n: int) -> list:
        """n independent requests; a given seed is offset per clone so the
        choices differ."""
        gens = []
        for i in range(n):
            g = gens_for()
            if g.seed is not None and n > 1:
                g.seed = int(g.seed) + i
            gens.append(g)
        return gens

    @staticmethod
    def _merge_streams(handles: list) -> Iterator[tuple[int, Any]]:
        """Interleave events from several handles as (index, event), each
        handle drained by its own reader thread."""
        if len(handles) == 1:
            for ev in handles[0]:
                yield 0, ev
            return
        q: "queue.Queue[tuple[int, Any]]" = queue.Queue()

        def reader(idx: int, h) -> None:
            for ev in h:
                q.put((idx, ev))

        for idx, h in enumerate(handles):
            threading.Thread(target=reader, args=(idx, h), daemon=True,
                             name=f"stream-reader-{idx}").start()
        done = 0
        while done < len(handles):
            idx, ev = q.get()
            if ev.kind in ("done", "error"):
                done += 1
            yield idx, ev

    @staticmethod
    def _collect(handle) -> tuple[str, Any]:
        """Drain one handle → (text, final event)."""
        parts: list[str] = []
        final = None
        for ev in handle:
            if ev.kind == "token":
                parts.append(ev.text)
            elif ev.kind == "error":
                raise ApiError(500, ev.error, "server_error")
            else:
                final = ev
        return "".join(parts), final

    def _note_request_metrics(self, model_name: str, finals: list) -> None:
        """Per-model lifecycle histograms from the terminal events' timings."""
        m = getattr(self.router, "metrics", None) if self.router else None
        if m is None:
            return
        labels = {"model": model_name}
        for f in finals:
            if f is None:
                continue
            m.observe("queue_wait", f.timing_queue_wait, labels)
            m.observe("admit", f.timing_prompt_processing, labels)
            m.observe("ttft", f.timing_queue_wait + f.timing_prompt_processing, labels)
            if f.completion_tokens > 1 and f.timing_token_generation > 0:
                m.observe("inter_token", f.timing_token_generation / (f.completion_tokens - 1),
                          labels)

    @staticmethod
    def _sum_usage(finals: list, extra: bool) -> dict[str, Any]:
        pt = sum(f.prompt_tokens for f in finals)
        ct = sum(f.completion_tokens for f in finals)
        u = {"prompt_tokens": pt, "completion_tokens": ct, "total_tokens": pt + ct}
        if extra:
            # The Extra-Usage header surfaces the engine's timings.
            u["timing_prompt_processing"] = sum(f.timing_prompt_processing for f in finals)
            u["timing_token_generation"] = sum(f.timing_token_generation for f in finals)
        return u

    def _stream(self, lm: LoadedModel, lease, handles: list, base: dict, first, token_chunk,
                final_chunk, extra_usage: bool) -> SSEStream:
        """The SSE body shared by both routes: `first` chunks, one chunk per
        token event, then one final chunk per choice with the usage on the
        last. A failed choice cancels its siblings and ends the stream."""
        def cancel_all() -> None:
            for h in handles:
                h.cancel()

        def events() -> Iterator[dict]:
            try:
                for c in first:
                    yield {**base, "choices": [c]}
                finals: list[Any] = [None] * len(handles)
                for idx, ev in self._merge_streams(handles):
                    if ev.kind == "token":
                        yield {**base, "choices": [token_chunk(idx, ev.text)]}
                    elif ev.kind == "error":
                        cancel_all()
                        yield {"error": {"message": ev.error, "type": "server_error"}}
                        return
                    else:
                        finals[idx] = ev
                done = [f for f in finals if f is not None]
                self._note_request_metrics(lm.cfg.name, done)
                for idx, final in enumerate(finals):
                    if final is None:
                        continue
                    out = {**base, "choices": [final_chunk(idx, final.finish_reason)]}
                    if idx == len(finals) - 1:
                        out["usage"] = self._sum_usage(done, extra_usage)
                    yield out
            finally:
                lease.release()

        return SSEStream(events(), on_disconnect=cancel_all)

    def _run_all(self, lm: LoadedModel, lease, gens: list) -> list:
        """Submit and drain every request → [(text, final event)]."""
        try:
            handles = self._submit_all(lm, gens)
            try:
                results = [self._collect(h) for h in handles]
            except BaseException:
                for h in handles:
                    h.cancel()
                raise
        finally:
            lease.release()
        self._note_request_metrics(lm.cfg.name, [r[1] for r in results])
        return results

    # ------------------------------------------------------------------ #
    # Chat
    # ------------------------------------------------------------------ #

    def chat(self, req: Request) -> Response | SSEStream:
        body = req.body or {}
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise ApiError(400, "messages is required and must be a non-empty array")
        _reject_unported(body, chat=True)
        lm, lease = self._resolve(req, Usecase.CHAT)
        try:
            return self._chat_inner(req, lm, lease, body)
        except BaseException:
            lease.release()  # idempotent
            raise

    def _chat_inner(self, req: Request, lm: LoadedModel, lease, body: dict[str, Any]):
        prompt = lm.evaluator.template_messages(body["messages"])
        add_bos = not lm.cfg.template.use_tokenizer_template
        ids = lm.engine.tokenizer.encode(prompt, add_bos=add_bos)
        n = self._n_choices(body)
        gens = self._clones(
            lambda: self._gen_request(lm, body, ids, extra_stop=lm.evaluator.stop_sequences()), n)
        rid = f"chatcmpl-{uuid.uuid4().hex[:28]}"
        created = _now()
        model_name = lm.cfg.name
        extra_usage = "extra-usage" in req.headers
        if body.get("stream"):
            handles = self._submit_all(lm, gens)
            base = {"id": rid, "object": "chat.completion.chunk", "created": created,
                    "model": model_name, "system_fingerprint": _fingerprint()}
            return self._stream(
                lm, lease, handles, base,
                first=[{"index": i, "delta": {"role": "assistant", "content": ""},
                        "finish_reason": None} for i in range(n)],
                token_chunk=lambda i, text: {"index": i, "delta": {"content": text},
                                             "finish_reason": None},
                final_chunk=lambda i, finish: {"index": i, "delta": {}, "finish_reason": finish},
                extra_usage=extra_usage)
        results = self._run_all(lm, lease, gens)
        choices = []
        for idx, (text, final) in enumerate(results):
            if needs_finetune(lm.cfg):
                text = finetune(lm.cfg, prompt, text)
            choices.append({"index": idx, "message": {"role": "assistant", "content": text},
                            "finish_reason": final.finish_reason})
        return Response(body={
            "id": rid, "object": "chat.completion", "created": created, "model": model_name,
            "system_fingerprint": _fingerprint(), "choices": choices,
            "usage": self._sum_usage([r[1] for r in results], extra_usage),
        })

    # ------------------------------------------------------------------ #
    # Completion
    # ------------------------------------------------------------------ #

    def completion(self, req: Request) -> Response | SSEStream:
        body = req.body or {}
        prompts = body.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        if not prompts or not all(isinstance(p, str) for p in prompts):
            raise ApiError(400, "prompt must be a string or array of strings")
        _reject_unported(body, chat=False)
        lm, lease = self._resolve(req, Usecase.COMPLETION)
        try:
            return self._completion_inner(req, lm, lease, body, prompts)
        except BaseException:
            lease.release()
            raise

    def _completion_inner(self, req: Request, lm: LoadedModel, lease, body: dict[str, Any],
                          prompts: list[str]):
        n = self._n_choices(body)
        gens, templated = [], []
        for p in prompts:
            t = lm.evaluator.template_completion(p)
            templated.append(t)
            ids = lm.engine.tokenizer.encode(t, add_bos=True)
            gens.extend(self._clones(lambda: self._gen_request(lm, body, ids), n))
        rid = f"cmpl-{uuid.uuid4().hex[:28]}"
        created = _now()
        extra_usage = "extra-usage" in req.headers
        if body.get("stream"):
            handles = self._submit_all(lm, gens)
            base = {"id": rid, "object": "text_completion", "created": created,
                    "model": lm.cfg.name}
            return self._stream(
                lm, lease, handles, base, first=[],
                token_chunk=lambda i, text: {"index": i, "text": text, "finish_reason": None},
                final_chunk=lambda i, finish: {"index": i, "text": "", "finish_reason": finish},
                extra_usage=extra_usage)
        results = self._run_all(lm, lease, gens)
        choices = []
        for idx, (text, final) in enumerate(results):
            prompt = prompts[idx // n]
            if needs_finetune(lm.cfg):
                text = finetune(lm.cfg, templated[idx // n], text)
            if body.get("echo") and not lm.cfg.echo:
                text = prompt + text
            choices.append({"index": idx, "text": text, "finish_reason": final.finish_reason})
        return Response(body={
            "id": rid, "object": "text_completion", "created": created, "model": lm.cfg.name,
            "choices": choices, "usage": self._sum_usage([r[1] for r in results], extra_usage),
        })

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    def list_models(self, req: Request) -> Response:
        data = [{"id": cfg.name, "object": "model", "created": _now(), "owned_by": "localai-tpu"}
                for cfg in self.manager.list_configs()]
        return Response(body={"object": "list", "data": data})

    def get_model(self, req: Request) -> Response:
        name = req.params["name"]
        if self.manager.configs.get(name) is None:
            raise ApiError(404, f"model {name!r} not found")
        return Response(body={"id": name, "object": "model", "created": _now(),
                              "owned_by": "localai-tpu"})

    def health(self, req: Request) -> Response:
        return Response(body={"status": "ok"})

    def version(self, req: Request) -> Response:
        return Response(body={"version": __version__})

    def engine_gauges(self):
        """(name, labels, value) for every loaded model's Engine.metrics();
        peek() only: a scrape never loads a model."""
        out = []
        for n in self.manager.loaded_names():
            lm = self.manager.peek(n)
            if lm is None:
                continue
            for k, v in lm.engine.metrics().items():
                out.append((f"localai_engine_{k}", {"model": n}, v))
        return out
