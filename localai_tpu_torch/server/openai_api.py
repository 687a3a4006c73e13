"""OpenAI-compatible text endpoints over the port's engine (the text routes
of localai_tpu/server/openai_api.py).

Routes: `/v1/chat/completions` and `/v1/completions` (streamed as SSE with
the usage in the last chunk, or whole), `/v1/edits`, `/v1/embeddings`
(strings or token arrays; a llama or a bert model), `/v1/tokenize`,
`/v1/models`, `/v1/models/{id}`, `/readyz`, `/healthz`, `/version`, and the
monitoring and debug routes: `/system`, `/backend/monitor`,
`/backend/shutdown`, `/debug/trace/{response id}` (the request's span tree,
its trace id from the client's W3C `traceparent` header or one minted
here), `/debug/timeline` (every engine's journal as Chrome trace JSON,
which Perfetto loads) and `/debug/profile` (a `torch.profiler` window into
ApplicationConfig.profile_dir; 403 without one, 409 while one runs). A
quarantined model answers 503 with Retry-After. The
`model` field (or the query, or a bearer token naming a model) selects a
model or a virtual model; a virtual model carries its tenant's adapter into
every request. `n > 1` and `best_of` run as one choice group: one request
per branch, each with its own grammar machine and seed (seed + i), which a
paged engine admits with one prefill (`Engine.submit_fork`) and any other
as independent clones. `best_of > n` ranks the branches by cumulative
logprob (ties in submission order) and returns the top n. `logprobs` /
`top_logprobs` (chat) and `logprobs` (completions) return each token's
logprob and its top alternatives, whole and streamed. `deadline_s` in a
body, else the model's, bounds a request end to end.

Constrained decoding and tool calling, as the JAX server serves them: chat
`tools` (or the legacy `functions`) add a tools prompt, and the reply's
JSON or `<function=...>` calls come back as `tool_calls` (finish_reason
"tool_calls"), whole or streamed (a stream buffers a reply whose first
character is one of `{[<`); `tool_choice` "required" or naming a tool
constrains the reply to a call's schema, "none" drops the tools;
`response_format` json_object / json_schema constrains it to JSON; a GBNF
`grammar` (chat and completions) takes precedence over both. The engine
runs the constraint on the device DFA or the host candidate walk.

Vision chat, as the JAX server serves it: the first `image_url` data URI
of a chat (server/images.py) goes through the model's tower (a `vlm`,
`llava` or `multimodal` backend), and its features fill a span of
placeholder ids right after BOS; a Qwen2-VL tower also yields the grid the
m-rope streams come from. A model without a tower ignores the image. An
image format this server has no decoder for is a 400 naming it.

A `remote` or `subprocess` model (engine/remote.py) is served by another
process: chat, completions, embeddings and tokenize relay its request
there as it came (`_proxy_remote`), a stream frame by frame as the peer
writes them. A peer that cannot be reached answers 502, and one that dies
mid-stream ends the stream with an error frame; this server goes on
serving its other models.
"""

from __future__ import annotations

import queue
import threading
import time
import urllib.error
import uuid
from typing import Any, Callable, Iterator, Optional

from localai_tpu_torch import __version__
from localai_tpu_torch.config import LoraConfigError, Usecase
from localai_tpu_torch.engine.engine import AdapterError, GenRequest, QueueFullError
from localai_tpu_torch.engine.remote import RemoteEngine
from localai_tpu_torch.functions import parse_function_calls, tools_prompt_for
from localai_tpu_torch.functions.gbnf import CompiledGrammar, GbnfConstraint, GbnfParseError
from localai_tpu_torch.functions.jsonschema import GrammarConstraint, tool_call_schema
from localai_tpu_torch.models.qwen2_vl import mrope_positions_for_span
from localai_tpu_torch.observe import profile as oprofile
from localai_tpu_torch.observe.timeline import chrome_trace
from localai_tpu_torch.observe.trace import STORE, new_traceparent, parse_traceparent
from localai_tpu_torch.server.app import ApiError, Request, Response, Router, SSEStream
from localai_tpu_torch.server.finetune import finetune, needs_finetune
from localai_tpu_torch.server.images import ImageDecodeError, extract_images
from localai_tpu_torch.server.manager import (
    LoadedModel,
    ModelManager,
    ModelQuarantinedError,
    UnsupportedBackendError,
)
from localai_tpu_torch.sysinfo import device_info, device_names, recommend_mesh


def _now() -> int:
    return int(time.time())


def _fingerprint() -> str:
    return f"localai-tpu-torch-{__version__}"


def _gbnf_factory(body: dict[str, Any]) -> Optional[Callable[[], Any]]:
    """A factory of machines for a raw `grammar` (GBNF) field, or None. A
    malformed grammar, or one too deep to parse, is a 400."""
    text = body.get("grammar")
    if not (isinstance(text, str) and text.strip()):
        return None
    try:
        compiled = CompiledGrammar(text)
    except (GbnfParseError, RecursionError, MemoryError) as e:
        raise ApiError(400, f"invalid grammar: {e}") from None
    return lambda: GbnfConstraint(compiled)


def _chat_tools(body: dict[str, Any]) -> tuple[list, Optional[Callable[[], Any]]]:
    """The tools a chat request offers (legacy `functions` included; none
    under tool_choice "none") and the factory of its grammar machines:
    json_object / json_schema response formats, a call of the tools
    tool_choice requires or names (an unknown name is a 400), and a GBNF
    `grammar`, which takes precedence over both. A factory, not a machine:
    each request (each n > 1 clone) advances its own."""
    tools = body.get("tools") or []
    if body.get("functions"):  # the legacy field
        tools = [{"type": "function", "function": f} for f in body["functions"]]
    tool_choice = body.get("tool_choice")
    if tool_choice == "none":
        tools = []
    make = None
    rf = body.get("response_format") or {}
    if isinstance(rf, dict) and rf.get("type") == "json_object":
        make = lambda: GrammarConstraint({"type": "object"})  # noqa: E731
    elif isinstance(rf, dict) and rf.get("type") == "json_schema":
        schema = (rf.get("json_schema") or {}).get("schema") or {}
        make = lambda: GrammarConstraint(schema)  # noqa: E731
    if tools and (tool_choice == "required" or isinstance(tool_choice, dict)):
        selected = tools
        if isinstance(tool_choice, dict):
            fname = (tool_choice.get("function") or {}).get("name")
            selected = [t for t in tools if (t.get("function") or {}).get("name") == fname]
            if not selected:
                raise ApiError(400, f"tool_choice names unknown function {fname!r}")
        schema = tool_call_schema(selected)
        make = lambda: GrammarConstraint(schema)  # noqa: E731
    return tools, _gbnf_factory(body) or make


class _ToolStream:
    """One streamed choice of a chat request that offers tools: a reply
    whose first non-blank character is one of `{[<` is buffered and parsed
    for calls at the end (a tool_calls delta, finish_reason "tool_calls");
    any other reply streams as it comes."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.parts: list[str] = []
        self.emitted = 0
        self.buffering: Optional[bool] = None

    def token(self, text: str) -> list[dict]:
        self.parts.append(text)
        if self.buffering is None:
            head = "".join(self.parts).lstrip()
            if head:
                self.buffering = head[0] in "{[<"
        if self.buffering is False:
            out = "".join(self.parts[self.emitted:])
            self.emitted = len(self.parts)
            return [{"content": out}]
        return []

    def final(self, finish: str) -> tuple[list[dict], str]:
        text = "".join(self.parts)
        if self.buffering:
            calls = parse_function_calls(text, self.cfg)
            if calls:
                return [{"tool_calls": [{**c, "index": i} for i, c in enumerate(calls)]}], \
                    "tool_calls"
            return ([{"content": text}] if text else []), finish
        tail = "".join(self.parts[self.emitted:])
        return ([{"content": tail}] if tail else []), finish


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
            r.add("POST", f"{prefix}/edits", self.edit)
            r.add("POST", f"{prefix}/embeddings", self.embeddings)
        r.add("POST", "/v1/tokenize", self.tokenize)
        r.add("POST", "/tokenize", self.tokenize)
        r.add("GET", "/v1/models/:name", self.get_model)
        r.add("GET", "/healthz", self.health)
        r.add("GET", "/readyz", self.health)
        r.add("GET", "/version", self.version)
        r.add("GET", "/system", self.system)
        r.add("GET", "/backend/monitor", self.backend_monitor)
        r.add("POST", "/backend/monitor", self.backend_monitor)
        r.add("POST", "/backend/shutdown", self.backend_shutdown)
        # Request-lifecycle observability: per-request span trees (W3C
        # traceparent carried in), the engine journals as Perfetto-loadable
        # Chrome trace JSON, and an opt-in torch.profiler capture window.
        r.add("GET", "/debug/trace/:request_id", self.debug_trace)
        r.add("GET", "/debug/timeline", self.debug_timeline)
        r.add("POST", "/debug/profile", self.debug_profile)
        if self.manager.app_cfg.profile_dir:
            oprofile.prepare()  # on this (the server's main) thread
        # Engine gauges (Engine.metrics(), adapter tier included) and the
        # manager's supervision gauges ride the Prometheus scrape.
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
        except ModelQuarantinedError as e:
            # Crash-only supervision tripped its restart budget: a typed 503
            # with the quarantine's remaining window, not a respawn loop.
            raise ApiError(503, str(e), "server_error", retry_after=e.retry_after_s) from None

    def _proxy_remote(self, req: Request, lm: LoadedModel, lease) -> Response | SSEStream:
        """Relay a request to an out-of-process backend (backend `remote` or
        `subprocess`; reference: every backend is a separate gRPC process,
        initializers.go:50-154). The request's own budget (body deadline_s,
        else the model's) bounds the proxy's socket. The peer's HTTP errors
        come back as they are; a peer that cannot be reached is a 502."""
        eng = lm.engine
        stream = bool((req.body or {}).get("stream"))
        try:
            deadline = float((req.body or {}).get("deadline_s") or lm.cfg.deadline_s or 0.0)
        except (TypeError, ValueError):
            deadline = 0.0
        try:
            resp = eng.request(req.path, req.body, method=req.method, deadline_s=deadline)
        except urllib.error.HTTPError as e:
            body = e.read()
            lease.release()
            return Response(status=e.code, body=body,
                            content_type=e.headers.get("Content-Type", "application/json"))
        except Exception as e:  # noqa: BLE001
            lease.release()
            raise ApiError(502, f"remote backend failed: {e}", "server_error") from None
        if stream and "event-stream" in (resp.headers.get("Content-Type") or ""):
            def events() -> Iterator[Any]:
                # One frame out per frame in: readline returns as soon as the
                # peer's chunk holding the line arrives. A stream that ends
                # without the peer's [DONE] was cut (a truncated chunked body
                # reads as a plain end).
                done, failure = False, "the stream ended without [DONE]"
                try:
                    for raw in resp:
                        line = raw.decode("utf-8", "replace").strip()
                        if line.startswith("data: "):
                            payload = line[6:]
                            if payload == "[DONE]":  # the writer adds its own
                                done = True
                            else:
                                yield payload
                except Exception as e:  # noqa: BLE001 — the peer died mid-stream
                    failure = f"{type(e).__name__}: {e}"
                finally:
                    resp.close()
                    lease.release()
                if not done:
                    yield {"error": {"message": f"remote backend failed mid-stream: {failure}",
                                     "type": "server_error", "code": 502}}

            return SSEStream(events(), on_disconnect=resp.close)
        try:
            data = resp.read()
        except Exception as e:  # noqa: BLE001 — the peer died mid-answer
            raise ApiError(502, f"remote backend failed: {e}", "server_error") from None
        finally:
            resp.close()
            lease.release()
        return Response(body=data,
                        content_type=resp.headers.get("Content-Type", "application/json"))

    @staticmethod
    def _tag_requests(gens: list, rid: str, traceparent: str) -> None:
        """Stamp each GenRequest with its tracing identity: the response
        id keys /debug/trace/{id} (choice i > 0 gets `-i`), and a
        traceparent is minted when the client sent none (or a malformed
        one), so every choice of a request shares one trace id."""
        if not (traceparent and parse_traceparent(traceparent)):
            traceparent = new_traceparent()
        for i, g in enumerate(gens):
            g.request_id = rid if i == 0 else f"{rid}-{i}"
            g.traceparent = traceparent

    @staticmethod
    def _submit_all(lm: LoadedModel, gens: list, group: int = 1) -> list:
        """Submit every GenRequest: a full queue is 429 + Retry-After, an
        adapter error 400; handles already submitted are cancelled. With
        `group` > 1 each run of `group` same-prompt requests (one choice
        group) goes through one `submit_fork`: a single prefill on a paged
        engine, independent clones otherwise (the same outputs)."""
        handles = []
        try:
            for k in range(0, len(gens), group):
                handles.extend(lm.engine.submit_fork(gens[k:k + group]))
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
            # End to end: the body's deadline, else the model's.
            deadline_s=float(pick("deadline_s", cfg.deadline_s)),
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
    def _best_of(body: dict[str, Any], n: int) -> int:
        """The validated `best_of` branch count: best_of branches off one
        prefill, ranked by cumulative logprob, the top n returned. n when
        absent; a stream cannot rank after the fact, so best_of > n on a
        stream is a client error (OpenAI's semantics)."""
        bo = body.get("best_of")
        if bo is None:
            return n
        try:
            bo = int(bo)
        except (TypeError, ValueError):
            raise ApiError(400, "best_of must be an integer") from None
        if bo < n:
            raise ApiError(400, "best_of must be >= n")
        if bo > 64:
            raise ApiError(400, "best_of must be between n and 64")
        if bo > n and body.get("stream"):
            raise ApiError(400, "best_of > n cannot be used with streaming")
        return bo

    @staticmethod
    def _select_best(results: list, n: int) -> list:
        """best_of ranking of one choice group: the highest cumulative
        token logprob first (ties keep submission order), the top n."""
        def score(r) -> float:
            return sum(ev.logprob for ev in r[1] if ev.logprob is not None)

        order = sorted(range(len(results)), key=lambda i: (-score(results[i]), i))
        return [results[i] for i in order[:n]]

    @staticmethod
    def _clones(gens_for, n: int) -> list:
        """n requests of one choice group; a given seed is offset per
        branch so the choices differ."""
        gens = []
        for i in range(n):
            g = gens_for()
            if g.seed is not None and n > 1:
                g.seed = int(g.seed) + i
            gens.append(g)
        return gens

    @staticmethod
    def _chat_logprobs(body: dict[str, Any]) -> int:
        """A chat request's logprobs: 0 = off, else the top N to return."""
        if not body.get("logprobs"):
            return 0
        top = body.get("top_logprobs")
        top = 1 if top is None else int(top)
        if top < 0 or top > 20:
            raise ApiError(400, "top_logprobs must be between 0 and 20")
        return max(top, 1)

    @staticmethod
    def _completion_lp(body: dict[str, Any]) -> int:
        """A completions request's logprobs: 0 = off, else the top N."""
        lp = body.get("logprobs")
        if lp is None or lp is False:
            return 0
        lp = 1 if lp is True else int(lp)
        if lp < 0 or lp > 20:
            raise ApiError(400, "logprobs must be between 0 and 20")
        return lp

    @staticmethod
    def _lp_entry(lm: LoadedModel, ev) -> dict[str, Any]:
        """One OpenAI chat logprobs content entry from a token event."""
        s = lm.engine.token_text(ev.token_id)
        return {
            "token": s,
            "logprob": ev.logprob,
            "bytes": list(s.encode("utf-8")),
            "top_logprobs": [
                {"token": lm.engine.token_text(i), "logprob": v,
                 "bytes": list(lm.engine.token_text(i).encode("utf-8"))}
                for i, v in (ev.top_logprobs or [])
            ],
        }

    def _chat_lp_content(self, lm: LoadedModel, tok_events: list) -> dict[str, Any]:
        return {"content": [self._lp_entry(lm, ev) for ev in tok_events
                            if ev.logprob is not None]}

    @staticmethod
    def _completion_lp_block(lm: LoadedModel, toks: list, offset0: int) -> dict[str, Any]:
        """The legacy completions logprobs block of one choice."""
        tokens, token_lps, tops, offsets = [], [], [], []
        off = offset0
        for ev in toks:
            if ev.logprob is None:
                continue
            s = lm.engine.token_text(ev.token_id)
            tokens.append(s)
            token_lps.append(ev.logprob)
            tops.append({lm.engine.token_text(i): v for i, v in (ev.top_logprobs or [])})
            offsets.append(off)
            off += len(s)
        return {"tokens": tokens, "token_logprobs": token_lps, "top_logprobs": tops,
                "text_offset": offsets}

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
    def _collect(handle) -> tuple[str, list, Any]:
        """Drain one handle → (text, token events, final event)."""
        parts: list[str] = []
        toks: list = []
        final = None
        for ev in handle:
            if ev.kind == "token":
                parts.append(ev.text)
                toks.append(ev)
            elif ev.kind == "error":
                raise ApiError(500, ev.error, "server_error")
            else:
                final = ev
        return "".join(parts), toks, final

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
        """The SSE body shared by both routes: `first` chunks, the chunks
        `token_chunk(index, event)` makes of each token event (a list, maybe
        empty), then per choice the chunks `final_chunk(index, finish)`
        makes, the usage on the very last. A failed choice cancels its
        siblings and ends the stream."""
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
                        for c in token_chunk(idx, ev):
                            yield {**base, "choices": [c]}
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
                    chunks = final_chunk(idx, final.finish_reason)
                    for k, c in enumerate(chunks):
                        out = {**base, "choices": [c]}
                        if idx == len(finals) - 1 and k == len(chunks) - 1:
                            out["usage"] = self._sum_usage(done, extra_usage)
                        yield out
            finally:
                lease.release()

        return SSEStream(events(), on_disconnect=cancel_all)

    def _run_all(self, lm: LoadedModel, lease, gens: list, group: int = 1) -> list:
        """Submit (choice groups of `group`) and drain every request →
        [(text, token events, final event)]."""
        try:
            handles = self._submit_all(lm, gens, group)
            try:
                results = [self._collect(h) for h in handles]
            except BaseException:
                for h in handles:
                    h.cancel()
                raise
        finally:
            lease.release()
        self._note_request_metrics(lm.cfg.name, [r[2] for r in results])
        return results

    # ------------------------------------------------------------------ #
    # Chat
    # ------------------------------------------------------------------ #

    def chat(self, req: Request) -> Response | SSEStream:
        body = req.body or {}
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise ApiError(400, "messages is required and must be a non-empty array")
        lm, lease = self._resolve(req, Usecase.CHAT)
        if isinstance(lm.engine, RemoteEngine):
            return self._proxy_remote(req, lm, lease)
        try:
            return self._chat_inner(req, lm, lease, body)
        except BaseException:
            lease.release()  # idempotent
            raise

    def _gens(self, lm: LoadedModel, body: dict[str, Any], ids: list[int], n: int,
              make_grammar, lp_n: int, extra_stop=None) -> list:
        """One choice group of the request: `bo` = best_of branches (n when
        absent), each with its own grammar machine; best_of > n ranks by
        cumulative logprob, so it asks for logprobs whatever the client
        asked (the response carries them only if the client did)."""
        bo = self._best_of(body, n)

        def one() -> GenRequest:
            g = self._gen_request(lm, body, ids, extra_stop=extra_stop)
            g.grammar = make_grammar() if make_grammar else None
            g.logprobs = lp_n if bo == n else max(lp_n, 1)
            return g
        return self._clones(one, bo)

    @staticmethod
    def _image_span(lm: LoadedModel, body: dict[str, Any], ids: list[int], add_bos: bool):
        """The chat's first image through the model's tower: (ids with a
        placeholder span of zeros right after BOS, (features, offset, m-rope
        streams or None)). Without an image or a tower: (ids, (None, 0,
        None))."""
        try:
            images = extract_images(body["messages"])
        except ImageDecodeError as e:
            raise ApiError(400, str(e)) from None
        vision = lm.vision
        if not images or vision is None:
            return ids, (None, 0, None)
        offset = 1 if (add_bos and ids) else 0
        grid = None
        if vision.kind == "qwen2_vl":
            embeds, grid = vision.encode_with_grid(images[0])
        else:
            embeds = vision.encode(images[0])
        ids = ids[:offset] + [0] * embeds.shape[0] + ids[offset:]
        mrope = None
        if grid is not None:
            mrope, _delta = mrope_positions_for_span(len(ids), offset, grid, merge=vision.merge)
        return ids, (embeds, offset, mrope)

    def _chat_inner(self, req: Request, lm: LoadedModel, lease, body: dict[str, Any]):
        tools, make_grammar = _chat_tools(body)
        prompt = lm.evaluator.template_messages(
            body["messages"], tools_prompt=tools_prompt_for(tools) if tools else "")
        add_bos = not lm.cfg.template.use_tokenizer_template
        ids = lm.engine.tokenizer.encode(prompt, add_bos=add_bos)
        n = self._n_choices(body)
        lp_n = self._chat_logprobs(body)
        ids, image = self._image_span(lm, body, ids, add_bos)
        gens = self._gens(lm, body, ids, n, make_grammar, lp_n,
                          extra_stop=lm.evaluator.stop_sequences())
        for g in gens:
            g.image_embeds, g.image_offset, g.mrope_positions = image
        rid = f"chatcmpl-{uuid.uuid4().hex[:28]}"
        self._tag_requests(gens, rid, req.headers.get("traceparent", ""))
        created = _now()
        model_name = lm.cfg.name
        extra_usage = "extra-usage" in req.headers
        if body.get("stream"):
            handles = self._submit_all(lm, gens, group=len(gens))
            base = {"id": rid, "object": "chat.completion.chunk", "created": created,
                    "model": model_name, "system_fingerprint": _fingerprint()}

            def choice(i: int, delta: dict, finish=None, ev=None) -> dict:
                c = {"index": i, "delta": delta, "finish_reason": finish}
                if lp_n and ev is not None and ev.logprob is not None:
                    c["logprobs"] = {"content": [self._lp_entry(lm, ev)]}
                return c

            if tools:
                states = [_ToolStream(lm.cfg) for _ in range(n)]

                def token_chunk(i: int, ev) -> list[dict]:
                    return [choice(i, d, ev=ev) for d in states[i].token(ev.text)]

                def final_chunk(i: int, finish: str) -> list[dict]:
                    deltas, finish = states[i].final(finish)
                    return [choice(i, d) for d in deltas] + [choice(i, {}, finish)]
            else:
                def token_chunk(i: int, ev) -> list[dict]:
                    return [choice(i, {"content": ev.text}, ev=ev)]

                def final_chunk(i: int, finish: str) -> list[dict]:
                    return [choice(i, {}, finish)]

            return self._stream(
                lm, lease, handles, base,
                first=[choice(i, {"role": "assistant", "content": ""}) for i in range(n)],
                token_chunk=token_chunk, final_chunk=final_chunk, extra_usage=extra_usage)
        results = self._run_all(lm, lease, gens, group=len(gens))
        # Usage counts every branch (the client paid for best_of of them);
        # the choices are the ranked top n.
        all_finals = [r[2] for r in results]
        if len(results) > n:
            results = self._select_best(results, n)
        choices = []
        for idx, (text, toks, final) in enumerate(results):
            if needs_finetune(lm.cfg):
                text = finetune(lm.cfg, prompt, text)
            message: dict[str, Any] = {"role": "assistant", "content": text}
            finish = final.finish_reason
            calls = parse_function_calls(text, lm.cfg) if tools else []
            if calls:
                message = {"role": "assistant", "content": None, "tool_calls": calls}
                finish = "tool_calls"
            c: dict[str, Any] = {"index": idx, "message": message, "finish_reason": finish}
            if lp_n:
                c["logprobs"] = self._chat_lp_content(lm, toks)
            choices.append(c)
        return Response(body={
            "id": rid, "object": "chat.completion", "created": created, "model": model_name,
            "system_fingerprint": _fingerprint(), "choices": choices,
            "usage": self._sum_usage(all_finals, extra_usage),
        })

    # ------------------------------------------------------------------ #
    # Completion / edit
    # ------------------------------------------------------------------ #

    def completion(self, req: Request) -> Response | SSEStream:
        body = req.body or {}
        prompts = body.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        if not prompts or not all(isinstance(p, str) for p in prompts):
            raise ApiError(400, "prompt must be a string or array of strings")
        lm, lease = self._resolve(req, Usecase.COMPLETION)
        if isinstance(lm.engine, RemoteEngine):
            return self._proxy_remote(req, lm, lease)
        try:
            return self._completion_inner(req, lm, lease, body, prompts)
        except BaseException:
            lease.release()
            raise

    def _completion_inner(self, req: Request, lm: LoadedModel, lease, body: dict[str, Any],
                          prompts: list[str]):
        n = self._n_choices(body)
        lp_n = self._completion_lp(body)
        make_grammar = _gbnf_factory(body)
        gens, templated = [], []
        for p in prompts:
            t = lm.evaluator.template_completion(p)
            templated.append(t)
            ids = lm.engine.tokenizer.encode(t, add_bos=True)
            gens.extend(self._gens(lm, body, ids, n, make_grammar, lp_n))
        bo = len(gens) // len(prompts)  # each prompt's choice group
        rid = f"cmpl-{uuid.uuid4().hex[:28]}"
        self._tag_requests(gens, rid, req.headers.get("traceparent", ""))
        created = _now()
        extra_usage = "extra-usage" in req.headers
        if body.get("stream"):
            handles = self._submit_all(lm, gens, group=bo)
            base = {"id": rid, "object": "text_completion", "created": created,
                    "model": lm.cfg.name}

            def token_chunk(i: int, ev) -> list[dict]:
                c: dict[str, Any] = {"index": i, "text": ev.text, "finish_reason": None}
                if lp_n and ev.logprob is not None:
                    c["logprobs"] = self._completion_lp_block(lm, [ev], 0)
                return [c]

            return self._stream(
                lm, lease, handles, base, first=[], token_chunk=token_chunk,
                final_chunk=lambda i, finish: [{"index": i, "text": "", "finish_reason": finish}],
                extra_usage=extra_usage)
        results = self._run_all(lm, lease, gens, group=bo)
        all_finals = [r[2] for r in results]
        if bo > n:
            results = [r for k in range(0, len(results), bo)
                       for r in self._select_best(results[k:k + bo], n)]
        choices = []
        for idx, (text, toks, final) in enumerate(results):
            prompt = prompts[idx // n]
            if needs_finetune(lm.cfg):
                text = finetune(lm.cfg, templated[idx // n], text)
            offset0 = 0
            if body.get("echo") and not lm.cfg.echo:
                text = prompt + text
                offset0 = len(prompt)
            c: dict[str, Any] = {"index": idx, "text": text, "finish_reason": final.finish_reason}
            if lp_n:
                c["logprobs"] = self._completion_lp_block(lm, toks, offset0)
            choices.append(c)
        return Response(body={
            "id": rid, "object": "text_completion", "created": created, "model": lm.cfg.name,
            "choices": choices, "usage": self._sum_usage(all_finals, extra_usage),
        })

    def edit(self, req: Request) -> Response:
        body = req.body or {}
        instruction = body.get("instruction", "")
        if not instruction:
            raise ApiError(400, "instruction is required")
        lm, lease = self._resolve(req, Usecase.EDIT)
        try:
            prompt = lm.evaluator.template_edit(instruction, body.get("input", ""))
            ids = lm.engine.tokenizer.encode(prompt, add_bos=True)
            g = self._gen_request(lm, body, ids)
            self._tag_requests([g], f"edit-{uuid.uuid4().hex[:28]}",
                               req.headers.get("traceparent", ""))
            text, final = self._submit_all(lm, [g])[0].result()
        finally:
            lease.release()
        self._note_request_metrics(lm.cfg.name, [final])
        if needs_finetune(lm.cfg):
            text = finetune(lm.cfg, prompt, text)
        return Response(body={
            "object": "edit", "created": _now(),
            "choices": [{"index": 0, "text": text}],
            "usage": self._sum_usage([final], "extra-usage" in req.headers),
        })

    def embeddings(self, req: Request) -> Response:
        """Embeddings of a string, a token array, or a list of either
        (`Engine.embed` on a llama model, `BertEngine.embed` on a bert
        one; a `remote` or `subprocess` model relays the request)."""
        body = req.body or {}
        inputs = body.get("input", "")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            raise ApiError(400, "input must be a non-empty string or array")
        lm, lease = self._resolve(req, Usecase.EMBEDDINGS)
        if isinstance(lm.engine, RemoteEngine):
            return self._proxy_remote(req, lm, lease)
        try:
            tok = lm.engine.tokenizer
            ids_batch: list[list[int]] = []
            for item in inputs:
                if isinstance(item, str):
                    ids_batch.append(tok.encode(item) or [0])
                elif isinstance(item, list):  # pre-tokenized input
                    ids_batch.append([int(t) for t in item] or [0])
                else:
                    raise ApiError(400, "input items must be strings or token arrays")
            # An id past the embedding table would fault the device (the
            # reference's gather clamps it instead).
            V = lm.engine.cfg.vocab_size
            if any(not 0 <= t < V for ids in ids_batch for t in ids):
                raise ApiError(400, f"input token ids must be in [0, {V})")
            vecs = lm.engine.embed(ids_batch)
        finally:
            lease.release()
        n_tokens = sum(len(x) for x in ids_batch)
        return Response(body={
            "object": "list", "model": lm.cfg.name,
            "data": [{"object": "embedding", "index": i, "embedding": [float(x) for x in vec]}
                     for i, vec in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    def tokenize(self, req: Request) -> Response:
        body = req.body or {}
        content = body.get("content", "")
        lm, lease = self._resolve(req, Usecase.TOKENIZE)
        if isinstance(lm.engine, RemoteEngine):
            return self._proxy_remote(req, lm, lease)
        try:
            ids = lm.engine.tokenizer.encode(content)
        finally:
            lease.release()
        return Response(body={"tokens": ids})

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

    def system(self, req: Request) -> Response:
        loaded = self.manager.loaded_names()
        backends = {}
        for n in loaded:
            lm = self.manager.peek(n)  # a monitoring poll never loads a model
            if lm is not None:
                backends[n] = lm.engine.metrics()
        return Response(body={
            "backends": backends,
            "loaded_models": loaded,
            "configured_models": self.manager.configs.names(),
            "devices": device_names(self.manager.device),
            "sysinfo": device_info(self.manager.device),
            "recommended_mesh": recommend_mesh(),
            "uptime_s": time.time() - self.started_at,
            "version": __version__,
        })

    def engine_gauges(self):
        """(name, labels, value) for every loaded model's Engine.metrics()
        and the manager's supervision gauges; peek() only: a scrape never
        loads a model. A dead loop's gauge carries its postmortem path."""
        out = []
        for n in self.manager.loaded_names():
            lm = self.manager.peek(n)
            if lm is None:
                continue
            try:
                gauges = lm.engine.metrics()
            except Exception:  # noqa: BLE001 — a scrape survives a dying engine
                continue
            for k, v in gauges.items():
                labels = {"model": n}
                if k == "loop_dead":
                    pm = lm.engine.postmortem_path
                    if pm:
                        labels["postmortem"] = pm
                out.append((f"localai_engine_{k}", labels, v))
        out.extend(self.manager.health_gauges())
        return out

    def backend_monitor(self, req: Request) -> Response:
        body = req.body or {}
        name = body.get("model") or (req.query.get("model") or [None])[0]
        if not name:
            raise ApiError(400, "model is required")
        lm = self.manager.peek(name)
        if lm is None:
            raise ApiError(404, f"model {name!r} is not loaded")
        return Response(body={
            "model": name,
            "metrics": lm.engine.metrics(),
            "loaded_for_s": time.monotonic() - lm.loaded_at,
            "in_flight": lm.in_flight,
            "supervision": self.manager.restart_stats(name),
        })

    def backend_shutdown(self, req: Request) -> Response:
        body = req.body or {}
        name = body.get("model")
        if not name:
            raise ApiError(400, "model is required")
        if not self.manager.unload(name):
            raise ApiError(404, f"model {name!r} is not loaded")
        return Response(body={"status": "ok"})

    # ------------------------------------------------------------------ #
    # Request-lifecycle observability
    # ------------------------------------------------------------------ #

    def debug_trace(self, req: Request) -> Response:
        """Span tree(s) of one request id, grouped by trace id. The id is
        the OpenAI response id (`chatcmpl-*`, `cmpl-*`, `edit-*`; `-i` for
        choice i > 0)."""
        rid = req.params["request_id"]
        data = STORE.get_json(rid)
        if data is None:
            raise ApiError(404, f"no trace recorded for request {rid!r} (traces are kept "
                                "for the most recent requests only)")
        return Response(body=data)

    def _engine_journals(self, model: Optional[str]) -> dict:
        """{model name: EventJournal} of the loaded engines (peek only: a
        debug pull never loads a model)."""
        out: dict = {}
        for n in self.manager.loaded_names():
            if model and n != model:
                continue
            lm = self.manager.peek(n)
            if lm is not None and lm.engine.journal is not None:
                out[n] = lm.engine.journal
        return out

    def debug_timeline(self, req: Request) -> Response:
        """The engine journal(s) as Chrome trace-event JSON: load the body
        in Perfetto or chrome://tracing. `?model=` narrows to one model."""
        model = (req.query.get("model") or [None])[0]
        journals = self._engine_journals(model)
        if not journals:
            raise ApiError(404, "no event journal available"
                           + (f" for model {model!r}" if model else "")
                           + " — is the model loaded and trace_journal_events > 0?")
        return Response(body=chrome_trace(journals))

    def debug_profile(self, req: Request) -> Response:
        """One torch.profiler capture window (POST {"seconds": N}) into
        ApplicationConfig.profile_dir (LOCALAI_PROFILE): profiling perturbs
        serving and writes traces to disk, so it is an explicit operator
        opt-in (403 without it). A second concurrent window gets 409."""
        prof_dir = self.manager.app_cfg.profile_dir
        if not prof_dir:
            raise ApiError(403, "profiling is disabled — set LOCALAI_PROFILE=<output dir> "
                                "to allow /debug/profile capture windows")
        seconds = float((req.body or {}).get("seconds", 1.0))
        try:
            result = oprofile.capture(prof_dir, seconds)
        except RuntimeError as e:
            raise ApiError(409, str(e)) from None
        # Mark the window in every journal, so the timeline and the
        # profiler's trace line up.
        for j in self._engine_journals(None).values():
            j.stage("profile", a=result["seconds"])
        return Response(body={"status": "ok", **result})
