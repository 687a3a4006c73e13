"""Stdlib HTTP server: routing, auth, SSE and raw byte streaming, multipart
forms, the WebSocket upgrade, Prometheus metrics (localai_tpu/server/app.py).

Reference: core/http/app.go:45-226 (echo middleware chain: body limit, error
handler, request logging, CORS, API-key auth, metrics) — rebuilt with
http.server.ThreadingHTTPServer so the framework dependency is zero and the
streaming path is a direct engine-queue → chunked-write loop.
"""

from __future__ import annotations

import hmac
import json
import logging
import re
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator, Optional
from urllib.parse import parse_qs, urlparse

from localai_tpu_torch.config import ApplicationConfig

log = logging.getLogger("localai_tpu_torch.http")

MAX_BODY = 100 * 1024 * 1024  # reference uses a 50MB gRPC cap; HTTP gets 100MB


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]
    query: dict[str, list[str]]
    headers: dict[str, str]
    body: Optional[dict[str, Any]]
    raw_body: bytes = b""

    def form(self) -> dict[str, tuple[Optional[str], bytes]]:
        """Parse a multipart/form-data body → {field: (filename|None, bytes)}.

        Used by the audio transcription endpoints — the
        reference gets this from echo's form binding; here it is a direct
        RFC 7578 boundary parse over raw_body.
        """
        ctype = self.headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            raise ApiError(400, "expected multipart/form-data")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            raise ApiError(400, "multipart body missing boundary")
        boundary = m.group(1).encode()
        out: dict[str, tuple[Optional[str], bytes]] = {}
        for part in self.raw_body.split(b"--" + boundary):
            part = part.strip(b"\r\n")
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" in part:
                head, _, content = part.partition(b"\r\n\r\n")
            else:
                head, _, content = part.partition(b"\n\n")
            name = filename = None
            for line in head.decode("utf-8", "replace").splitlines():
                if line.lower().startswith("content-disposition"):
                    nm = re.search(r'name="([^"]*)"', line)
                    fm = re.search(r'filename="([^"]*)"', line)
                    name = nm.group(1) if nm else None
                    filename = fm.group(1) if fm else None
            if name is not None:
                out[name] = (filename, content)
        return out


@dataclass
class Response:
    status: int = 200
    body: Any = None  # dict → JSON; str/bytes → raw
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)


class RawStream:
    """Handler return value that streams raw byte chunks (chunked encoding) —
    e.g. streaming TTS audio (reference: TTSStreamEndpoint, tts.go:71-80)."""

    def __init__(self, chunks: Iterator[bytes], content_type: str = "application/octet-stream"):
        self.chunks = chunks
        self.content_type = content_type


class SSEStream:
    """Handler return value that streams `data:` frames from a generator.

    `on_disconnect` (optional) is invoked when the client drops mid-stream so
    the producer can cancel upstream work — e.g. the engine request handle —
    instead of decoding to max_new_tokens into an unread queue.
    """

    def __init__(self, events: Iterator[Any], on_disconnect: Optional[Callable[[], None]] = None):
        self.events = events
        self.on_disconnect = on_disconnect


class ApiError(Exception):
    def __init__(self, status: int, message: str, kind: str = "invalid_request_error",
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.kind = kind
        # Backpressure/quarantine errors (429/503) carry a
        # Retry-After hint derived from observed admission latency or the
        # remaining quarantine window.
        self.retry_after = retry_after

    def to_response(self) -> Response:
        # OpenAI-style error envelope (reference: core/http error handler).
        headers = {}
        if self.retry_after is not None:
            headers["Retry-After"] = str(max(1, int(-(-self.retry_after // 1))))
        return Response(
            status=self.status,
            body={"error": {"message": str(self), "type": self.kind, "code": self.status}},
            headers=headers,
        )


class Metrics:
    """Named, labeled duration histograms + engine gauges, Prometheus text
    format.

    Reference: core/services/metrics.go:28-46 (OTel histogram `api_call`).
    Generalized: `observe(name, seconds, labels)` records into
    any histogram — `api_call` by path as before, plus the per-model
    request-lifecycle histograms (ttft, inter_token, queue_wait, admit)
    the API layer feeds from terminal-event timings. Each histogram
    renders its own `# HELP`/`# TYPE` block.

    Gauges come from two places: `gauge()` for values the server pushes,
    and `add_gauge_source()` callbacks polled at scrape time — how the
    per-model engine gauges (kv pages, queue depth, preemptions, swap
    bytes, prefix host tier — Engine.metrics()) reach /metrics without the
    HTTP layer holding engine references."""

    BUCKETS = (0.005, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0, float("inf"))

    # # HELP text per histogram (unknown names get a generic line).
    HELP = {
        "api_call": "API call duration seconds",
        "ttft": "Time to first token seconds (queue wait included)",
        "inter_token": "Mean inter-token interval seconds per request",
        "queue_wait": "Seconds a request waited in the pending queue",
        "admit": "Admission-to-first-token seconds (prefill + sample)",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Histograms keyed by (name, sorted label items).
        self._hist: dict[tuple[str, tuple], list[int]] = {}
        self._sum: dict[tuple[str, tuple], float] = {}
        self._count: dict[tuple[str, tuple], int] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._gauge_sources: list[Callable[[], Any]] = []

    def observe(self, name: str, seconds: float,
                labels: Optional[dict[str, str]] = None) -> None:
        """Record one duration sample into the named histogram."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            h = self._hist.setdefault(key, [0] * len(self.BUCKETS))
            for i, b in enumerate(self.BUCKETS):
                if seconds <= b:
                    h[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + seconds
            self._count[key] = self._count.get(key, 0) + 1

    def gauge(self, name: str, value: float,
              labels: Optional[dict[str, str]] = None) -> None:
        """Set a gauge sample (push path). `name` should already carry the
        localai_ prefix convention."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            self._gauges[key] = float(value)

    def add_gauge_source(self, fn: Callable[[], Any]) -> None:
        """Register a scrape-time callback yielding (name, labels, value)
        triples — polled fresh on every /metrics render. Registration is
        locked: render() snapshots this list under the same lock (the
        unguarded append/iterate pair was a cross-thread race)."""
        with self._lock:
            self._gauge_sources.append(fn)

    @staticmethod
    def _fmt_labels(labels: tuple, extra: str = "") -> str:
        inner = ",".join(f'{k}="{v}"' for k, v in labels)
        if extra:
            inner = f"{inner},{extra}" if inner else extra
        if not inner:
            return ""
        return "{" + inner + "}"

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            hist = {k: list(v) for k, v in self._hist.items()}
            sums = dict(self._sum)
            counts = dict(self._count)
            samples = dict(self._gauges)
            sources = list(self._gauge_sources)
        by_hist: dict[str, list[tuple]] = {}
        for name, labels in hist:
            by_hist.setdefault(name, []).append(labels)
        for name in sorted(by_hist):
            help_text = self.HELP.get(name, f"{name} duration seconds")
            lines.append(f"# HELP localai_{name} {help_text}")
            lines.append(f"# TYPE localai_{name} histogram")
            for labels in sorted(by_hist[name]):
                key = (name, labels)
                h = hist[key]
                for i, b in enumerate(self.BUCKETS):
                    le = "+Inf" if b == float("inf") else repr(b)
                    le_label = f'le="{le}"'
                    lines.append(
                        f"localai_{name}_bucket"
                        f"{self._fmt_labels(labels, le_label)} {h[i]}"
                    )
                lines.append(
                    f"localai_{name}_sum{self._fmt_labels(labels)} {sums[key]}"
                )
                lines.append(
                    f"localai_{name}_count{self._fmt_labels(labels)} "
                    f"{counts[key]}"
                )
        # Gauge sources run OUTSIDE the lock (they may scrape engines).
        for src in sources:
            try:
                for name, labels, value in src():
                    key = (name, tuple(sorted((labels or {}).items())))
                    samples[key] = float(value)
            except Exception:  # noqa: BLE001 — a scrape must never 500
                log.exception("gauge source failed during /metrics render")
        by_name: dict[str, list[tuple[tuple, float]]] = {}
        for (name, labels), value in samples.items():
            by_name.setdefault(name, []).append((labels, value))
        for name in sorted(by_name):
            lines.append(f"# TYPE {name} gauge")
            for labels, value in sorted(by_name[name]):
                lines.append(f"{name}{self._fmt_labels(labels)} {value}")
        return "\n".join(lines) + "\n"


Handler = Callable[[Request], "Response | SSEStream"]


class Router:
    def __init__(self) -> None:
        # thread: single-writer main — the route table is built during
        # startup, before create_server() spawns handler threads; handlers
        # only read it
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        # The (method, pattern, handler) triples as declared: the OpenAPI
        # document is built from them (server/openapi.py).
        self.declared: list[tuple[str, str, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        """Pattern params as `:name` segments, e.g. `/models/jobs/:uuid`."""
        regex = re.sub(r":(\w+)", r"(?P<\1>[^/]+)", pattern)
        self.routes.append((method.upper(), re.compile(f"^{regex}$"), handler))
        self.declared.append((method.upper(), pattern, handler))

    def match(self, method: str, path: str) -> Optional[tuple[Handler, dict[str, str]]]:
        for m, rx, h in self.routes:
            if m != method.upper():
                continue
            match = rx.match(path)
            if match:
                return h, match.groupdict()
        return None

    def methods_for(self, path: str) -> set[str]:
        return {m for m, rx, _ in self.routes if rx.match(path)}


# Paths that never require auth (reference: auth.go exempts health endpoints).
AUTH_EXEMPT = {"/healthz", "/readyz", "/version"}


def create_server(app_cfg: ApplicationConfig, router: Router) -> ThreadingHTTPServer:
    metrics = Metrics()
    # Per-model engine gauges: an API layer that registered a gauge source
    # on the router (OpenAIApi.register) gets polled at every scrape.
    src = getattr(router, "gauge_source", None)
    if src is not None:
        metrics.add_gauge_source(src)
    router.metrics = metrics
    router.add("GET", "/metrics", lambda req: Response(
        body=metrics.render(), content_type="text/plain; version=0.0.4"
    ))

    class RequestHandlerImpl(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "localai-tpu-torch"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug("%s " + fmt, self.address_string(), *args)

        def _deny(self, status: int, msg: str) -> None:
            self._respond(ApiError(status, msg).to_response())

        def _authed(self) -> bool:
            if not app_cfg.api_keys:
                return True
            path = urlparse(self.path).path
            if path in AUTH_EXEMPT:
                return True
            header = self.headers.get("Authorization", "")
            token = header[7:] if header.startswith("Bearer ") else header
            if not token:
                token = self.headers.get("x-api-key", "") or self.headers.get("xi-api-key", "")
            # Constant-time compare over bytes (reference: auth.go constant-
            # time option); bytes form tolerates non-ASCII header values.
            tb = token.encode("utf-8", "surrogateescape")
            if any(hmac.compare_digest(tb, k.encode()) for k in app_cfg.api_keys):
                return True
            # Minted realtime client secrets admit realtime paths only
            # (RealtimeApi attaches the registry at route registration).
            eph = getattr(router, "ephemeral_keys", None)
            return eph is not None and eph.valid(token, path)

        def _common_headers(self) -> dict[str, str]:
            h = {}
            if app_cfg.cors:
                h["Access-Control-Allow-Origin"] = "*"
                h["Access-Control-Allow-Headers"] = "Authorization, Content-Type, Extra-Usage"
                h["Access-Control-Allow-Methods"] = "GET, POST, DELETE, OPTIONS"
            if app_cfg.machine_tag:
                h["LocalAI-Machine-Tag"] = app_cfg.machine_tag
            # Cluster role advertisement: health probes from the
            # federation front door read this to role-type affinity picks
            # (prefill/decode workers need no side-channel registration).
            role = (app_cfg.cluster_role or "").split(",")[0].strip()
            if role and role != "mixed":
                h["LocalAI-Cluster-Role"] = role
            return h

        def _respond(self, resp: Response) -> None:
            body = resp.body
            if isinstance(body, (dict, list)):
                data = json.dumps(body).encode()
            elif isinstance(body, str):
                data = body.encode()
            elif body is None:
                data = b""
            else:
                data = body
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in {**self._common_headers(), **resp.headers}.items():
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(data)

        def _respond_sse(self, stream: SSEStream) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "keep-alive")
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in self._common_headers().items():
                self.send_header(k, v)
            self.end_headers()

            def write_chunk(payload: bytes) -> None:
                self.wfile.write(f"{len(payload):X}\r\n".encode() + payload + b"\r\n")
                self.wfile.flush()

            try:
                for ev in stream.events:
                    if isinstance(ev, (dict, list)):
                        ev = json.dumps(ev)
                    write_chunk(f"data: {ev}\n\n".encode())
                write_chunk(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                log.debug("SSE client disconnected")
                if stream.on_disconnect is not None:
                    try:
                        stream.on_disconnect()
                    except Exception:  # noqa: BLE001
                        log.exception("SSE on_disconnect callback failed")
            finally:
                # Close the generator so its finally blocks (lease release)
                # run deterministically even when the client dropped early.
                stream.events.close()
                try:
                    write_chunk(b"")  # terminating chunk
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def _upgrade_websocket(self, upgrade) -> None:
            from localai_tpu_torch.server.ws import WebSocket, accept_key

            key = self.headers.get("Sec-WebSocket-Key")
            if (self.headers.get("Upgrade", "").lower() != "websocket") or not key:
                self._deny(400, "expected a WebSocket upgrade request")
                return
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", accept_key(key))
            self.end_headers()
            self.wfile.flush()
            ws = WebSocket(self.rfile, self.wfile)
            try:
                upgrade.session(ws)
            except (BrokenPipeError, ConnectionResetError, ConnectionError):
                log.debug("websocket client disconnected")
            finally:
                ws.close()
                self.close_connection = True

        def _respond_raw_stream(self, stream: "RawStream") -> None:
            self.send_response(200)
            self.send_header("Content-Type", stream.content_type)
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in self._common_headers().items():
                self.send_header(k, v)
            self.end_headers()
            try:
                for chunk in stream.chunks:
                    if chunk:
                        self.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                log.debug("raw-stream client disconnected")
            finally:
                if hasattr(stream.chunks, "close"):
                    stream.chunks.close()

        def _handle(self) -> None:
            start = time.monotonic()
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/") or "/"
            if self.command == "OPTIONS":
                self.send_response(204)
                for k, v in self._common_headers().items():
                    self.send_header(k, v)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            if not self._authed():
                self._deny(401, "invalid or missing API key")
                return

            matched = router.match(self.command, path)
            if matched is None:
                if router.methods_for(path):
                    self._deny(405, f"method {self.command} not allowed for {path}")
                else:
                    self._deny(404, f"no route for {path}")
                return
            handler, params = matched

            raw = b""
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY:
                self._deny(413, "request body too large")
                return
            if length:
                raw = self.rfile.read(length)
            body = None
            if raw:
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype or raw.lstrip()[:1] in (b"{", b"["):
                    try:
                        body = json.loads(raw)
                    except json.JSONDecodeError as e:
                        self._deny(400, f"invalid JSON body: {e}")
                        return

            req = Request(
                method=self.command,
                path=path,
                params=params,
                query=parse_qs(parsed.query),
                headers={k.lower(): v for k, v in self.headers.items()},
                body=body,
                raw_body=raw,
            )
            try:
                result = handler(req)
                from localai_tpu_torch.server.ws import WebSocketUpgrade

                if isinstance(result, WebSocketUpgrade):
                    self._upgrade_websocket(result)
                    return
            except ApiError as e:
                self._respond(e.to_response())
                return
            except Exception as e:  # noqa: BLE001
                log.exception("handler error for %s %s", self.command, path)
                self._respond(ApiError(500, f"{type(e).__name__}: {e}", "server_error").to_response())
                return
            finally:
                metrics.observe("api_call", time.monotonic() - start,
                                {"path": path})

            if isinstance(result, SSEStream):
                self._respond_sse(result)
            elif isinstance(result, RawStream):
                self._respond_raw_stream(result)
            else:
                self._respond(result)

        def do_GET(self):  # noqa: N802
            self._handle()

        do_POST = do_DELETE = do_PUT = do_HEAD = do_OPTIONS = do_GET

    class Server(ThreadingHTTPServer):
        # The socketserver default backlog of 5 RSTs connection bursts —
        # any concurrent client fan-in (n>1 requests, federation, stress)
        # trips it. Match a production accept queue.
        request_queue_size = 128
        daemon_threads = True

    server = Server((app_cfg.address, app_cfg.port), RequestHandlerImpl)
    server.daemon_threads = True
    return server
