"""Application-level configuration (a copy of localai_tpu/config/app_config.py).

Reference: core/config/application_config.go (461 LoC, functional AppOption
pattern fed by ~70 kong CLI flags with env aliases, core/cli/run.go:23-120).
Here: one dataclass, populated from env vars (LOCALAI_*) and/or CLI args.
These are deployment settings (address, port, models dir, keys, cluster
knobs, the journal, fence, profile and fault-schedule switches, the
galleries and the model hub); none of them routes kernel work. Without
LOCALAI_GALLERIES, from_env lists the packaged starter gallery
(`localai-tpu`, a file:// URL of localai_tpu_torch/gallery/index.yaml), as
the JAX package does. The Hugging Face endpoint of hf:// and
huggingface:// installs is LOCALAI_HF_ENDPOINT here (the JAX package's
downloader reads HF_ENDPOINT itself).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default, cast=str):
    v = os.environ.get(name)
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes", "on")
    return cast(v)


@dataclasses.dataclass
class ApplicationConfig:
    address: str = "127.0.0.1"
    port: int = 8080
    models_dir: str = "models"
    generated_content_dir: str = "generated"

    # Auth (reference: core/http/middleware/auth.go).
    api_keys: list[str] = dataclasses.field(default_factory=list)

    # Lifecycle (reference: watchdog flags, run.go). max_active_models <= 0
    # means unlimited (reference MaxActiveBackends default) — HBM is the real
    # budget; set a positive value to enforce LRU eviction.
    max_active_models: int = 0
    watchdog_idle_timeout_s: float = 0.0  # 0 disables
    watchdog_busy_timeout_s: float = 0.0
    watchdog_interval_s: float = 5.0  # reference ticks at 30s (watchdog.go:197)

    # Crash-only restart budget (docs/ROBUSTNESS.md): when a
    # model's engine loop dies, the manager evicts it and the next request
    # transparently reloads — up to restart_budget deaths per
    # restart_window_s. One more death inside the window quarantines the
    # model for quarantine_s: requests get a clean typed 503 instead of
    # feeding a reload/crash loop. restart_budget < 0 = never quarantine.
    restart_budget: int = 3
    restart_window_s: float = 300.0
    quarantine_s: float = 300.0

    # Engine defaults.
    preload_models: list[str] = dataclasses.field(default_factory=list)
    default_context_size: int = 2048

    # Model galleries: [{"name": ..., "url": ...}] (reference: run.go
    # --galleries flag / GALLERIES env, JSON-encoded).
    galleries: list[dict] = dataclasses.field(default_factory=list)
    # The Hugging Face hub that hf:// and huggingface:// installs fetch
    # from: a mirror or a local server replaces it.
    hf_endpoint: str = "https://huggingface.co"

    # Cluster scheduling (docs/CLUSTER.md). cluster_role declares
    # this process's place in a disaggregated fleet (prefill|decode|mixed;
    # a comma list assigns per-replica roles for in-process fan-out) — it
    # rides every HTTP response as LocalAI-Cluster-Role so the federation
    # front door's affinity scheduler can role-type its picks.
    # cluster_replicas >= 2 fans each text model across that many same-host
    # engine replicas (shared weights, per-replica KV pools) behind the
    # prefix-affinity scheduler. affinity_spans bounds how many leading
    # prompt spans are hashed per request; transfer_max_bytes caps one
    # prefill→decode KV span frame.
    cluster_role: str = "mixed"
    cluster_replicas: int = 0
    affinity_spans: int = 8
    transfer_max_bytes: int = 64 << 20
    # Multi-host cluster (docs/CLUSTER.md § multi-host).
    # cluster_peers names REMOTE workers ("name=http://host:port" or bare
    # URLs, comma-separated in the env mirror) this process may hand
    # prefill work to / fetch KV spans from over the networked LAIKV
    # stream; roles are discovered from each peer's LocalAI-Cluster-Role
    # header. transfer_chunk_bytes sizes one stream chunk (each chunk
    # carries its own CRC32); transfer_checksum=false skips checksum
    # verification on trusted links (framing is still parsed);
    # transfer_resumes bounds how many times a dropped fetch resumes from
    # its verified offset before degrading to recompute.
    # cluster_gauge_stale_s bounds how old a remote replica's scraped
    # gauges may be before the scheduler treats the host as dead.
    cluster_peers: list[str] = dataclasses.field(default_factory=list)
    transfer_chunk_bytes: int = 1 << 20
    transfer_checksum: bool = True
    transfer_resumes: int = 2
    cluster_gauge_stale_s: float = 5.0
    # jax.distributed serving bootstrap: process 0's host:port,
    # the process count, and this process's rank. Empty/0 = single-process.
    # Env mirrors LOCALAI_COORDINATOR / LOCALAI_NUM_PROCESSES /
    # LOCALAI_PROCESS_ID match the train dryrun's contract.
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = 0

    # Flight recorder (docs/OBSERVABILITY.md): directory where a
    # dying engine loop dumps its postmortem JSON (journal tail + state
    # snapshot). "" = a stable tempdir child. Forwarded to every engine
    # through the manager; LOCALAI_POSTMORTEM_DIR overrides either way.
    postmortem_dir: str = ""
    # Observability and faults (docs/OBSERVABILITY.md), the variables the
    # JAX engine and server read themselves; the port reads them here
    # only. trace_journal (LOCALAI_TRACE_JOURNAL) overrides every model's
    # trace_journal_events (None = each model's own); trace_fence
    # (LOCALAI_TRACE_FENCE) turns on fenced device times in every engine;
    # profile_dir (LOCALAI_PROFILE) allows /debug/profile capture windows
    # into that directory; faults (LOCALAI_FAULTS, "seed:7,rate:0.05,
    # max:4,sites:a|b") arms a seeded fault schedule at ModelManager
    # construction.
    trace_journal: Optional[int] = None
    trace_fence: bool = False
    profile_dir: str = ""
    faults: str = ""

    cors: bool = True
    metrics: bool = True
    debug: bool = False

    machine_tag: str = ""  # echoed as a response header when set

    # Config hot-reload (reference: fsnotify watcher, startup.go:209-319).
    watch_configs: bool = False
    config_watch_interval_s: float = 2.0

    # Mutable-at-runtime settings persisted to this JSON (reference:
    # runtime_settings.json applied at boot + settings API).
    runtime_settings_path: str = ""

    RUNTIME_MUTABLE = (
        "max_active_models",
        "watchdog_idle_timeout_s",
        "watchdog_busy_timeout_s",
        "watchdog_interval_s",
        "default_context_size",
        "machine_tag",
        "cors",
    )

    def apply_runtime_settings(self) -> dict:
        """Load runtime_settings.json over this config (boot-time tier —
        env < file < API updates). Returns the applied dict."""
        import json

        if not self.runtime_settings_path or not os.path.exists(self.runtime_settings_path):
            return {}
        with open(self.runtime_settings_path) as f:
            data = json.load(f)
        applied = {}
        for k in self.RUNTIME_MUTABLE:
            if k in data:
                field_type = type(getattr(self, k))
                setattr(self, k, field_type(data[k]))
                applied[k] = data[k]
        return applied

    def save_runtime_settings(self) -> None:
        import json

        if not self.runtime_settings_path:
            return
        os.makedirs(os.path.dirname(self.runtime_settings_path) or ".", exist_ok=True)
        with open(self.runtime_settings_path, "w") as f:
            json.dump({k: getattr(self, k) for k in self.RUNTIME_MUTABLE}, f, indent=1)

    @classmethod
    def from_env(cls, **overrides) -> "ApplicationConfig":
        cfg = cls(
            address=_env("LOCALAI_ADDRESS", cls.address),
            port=_env("LOCALAI_PORT", cls.port, int),
            models_dir=_env("LOCALAI_MODELS_PATH", cls.models_dir),
            generated_content_dir=_env("LOCALAI_GENERATED_CONTENT_PATH", cls.generated_content_dir),
            max_active_models=_env("LOCALAI_MAX_ACTIVE_MODELS", cls.max_active_models, int),
            watchdog_idle_timeout_s=_env("LOCALAI_WATCHDOG_IDLE_TIMEOUT", 0.0, float),
            watchdog_busy_timeout_s=_env("LOCALAI_WATCHDOG_BUSY_TIMEOUT", 0.0, float),
            watchdog_interval_s=_env("LOCALAI_WATCHDOG_INTERVAL", cls.watchdog_interval_s, float),
            restart_budget=_env("LOCALAI_RESTART_BUDGET", cls.restart_budget, int),
            restart_window_s=_env("LOCALAI_RESTART_WINDOW", cls.restart_window_s, float),
            quarantine_s=_env("LOCALAI_QUARANTINE", cls.quarantine_s, float),
            default_context_size=_env("LOCALAI_CONTEXT_SIZE", cls.default_context_size, int),
            cluster_role=_env("LOCALAI_CLUSTER_ROLE", cls.cluster_role),
            cluster_replicas=_env("LOCALAI_CLUSTER_REPLICAS", cls.cluster_replicas, int),
            affinity_spans=_env("LOCALAI_AFFINITY_SPANS", cls.affinity_spans, int),
            transfer_max_bytes=_env("LOCALAI_TRANSFER_MAX_BYTES", cls.transfer_max_bytes, int),
            transfer_chunk_bytes=_env("LOCALAI_TRANSFER_CHUNK_BYTES", cls.transfer_chunk_bytes, int),
            transfer_checksum=_env("LOCALAI_TRANSFER_CHECKSUM", cls.transfer_checksum, bool),
            transfer_resumes=_env("LOCALAI_TRANSFER_RESUMES", cls.transfer_resumes, int),
            cluster_gauge_stale_s=_env("LOCALAI_CLUSTER_GAUGE_STALE", cls.cluster_gauge_stale_s, float),
            coordinator_address=_env("LOCALAI_COORDINATOR", cls.coordinator_address),
            num_processes=_env("LOCALAI_NUM_PROCESSES", cls.num_processes, int),
            process_id=_env("LOCALAI_PROCESS_ID", cls.process_id, int),
            postmortem_dir=_env("LOCALAI_POSTMORTEM_DIR", cls.postmortem_dir),
            trace_journal=_env("LOCALAI_TRACE_JOURNAL", cls.trace_journal, int),
            trace_fence=_env("LOCALAI_TRACE_FENCE", cls.trace_fence, bool),
            profile_dir=_env("LOCALAI_PROFILE", cls.profile_dir),
            faults=_env("LOCALAI_FAULTS", cls.faults),
            cors=_env("LOCALAI_CORS", True, bool),
            metrics=not _env("LOCALAI_DISABLE_METRICS", False, bool),
            debug=_env("LOCALAI_DEBUG", False, bool),
            machine_tag=_env("LOCALAI_MACHINE_TAG", ""),
            hf_endpoint=_env("LOCALAI_HF_ENDPOINT", cls.hf_endpoint),
        )
        keys = os.environ.get("LOCALAI_API_KEY", "")
        if keys:
            cfg.api_keys = [k.strip() for k in keys.split(",") if k.strip()]
        preload = os.environ.get("LOCALAI_PRELOAD_MODELS", "")
        if preload:
            cfg.preload_models = [m.strip() for m in preload.split(",") if m.strip()]
        peers = os.environ.get("LOCALAI_CLUSTER_PEERS", "")
        if peers:
            cfg.cluster_peers = [p.strip() for p in peers.split(",") if p.strip()]
        galleries = os.environ.get("LOCALAI_GALLERIES", "")
        if galleries:
            import json

            cfg.galleries = json.loads(galleries)
        else:
            # The packaged starter gallery (the reference ships
            # gallery/index.yaml as its default, core/cli/run.go).
            from localai_tpu_torch.gallery import builtin_gallery_url

            cfg.galleries = [{"name": "localai-tpu", "url": builtin_gallery_url()}]
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
