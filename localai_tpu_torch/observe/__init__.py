"""Request-lifecycle tracing and the engine flight recorder (the port's
counterpart of localai_tpu/observe/).

- `journal`  — a preallocated bounded ring buffer of typed events owned by
  the engine loop (append is lock-free from the loop thread, O(1), no
  Python-object allocation, no device sync). Cross-thread producers
  (submit) stage into a small locked sidecar the loop drains.
- `trace`    — per-request span trees keyed by a request id (the OpenAI
  response id at the HTTP layer) carrying the W3C `traceparent` of the
  HTTP header through GenRequest.
- `timeline` — journal → Chrome trace-event JSON (Perfetto-loadable),
  served at `/debug/timeline`.
- `postmortem` — the flight recorder: on engine-loop death the last
  journal events and a host-state snapshot dump to a JSON file whose path
  rides the `loop_dead` gauge labels and the manager log.

These four are copies of the JAX package's modules and import no torch.
`fence` (CUDA-event device times, EngineConfig.trace_fence) and `profile`
(`torch.profiler` capture windows, /debug/profile) are the port's own.
"""

from localai_tpu_torch.observe.journal import EventJournal  # noqa: F401
from localai_tpu_torch.observe.trace import (  # noqa: F401
    STORE,
    RequestTrace,
    TraceStore,
    format_traceparent,
    new_traceparent,
    parse_traceparent,
)
