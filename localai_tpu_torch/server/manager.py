"""Model lifecycle manager: lazy engine loading with singleflight + LRU, and
virtual models (the LLM part of localai_tpu/server/manager.py).

One manager owns every engine of the process, all on one device. "Loading"
reads a checkpoint (an HF safetensors directory or a GGUF file), or draws a
preset's random weights, onto the device and
starts an engine; "evicting" stops the engine and drops its tensors. A
virtual model (`base_model` + `adapter` in its YAML) resolves to its base's
one shared engine with the adapter registered as a runtime LoRA tenant, so
N tenants cost one set of base weights.

Crash-only supervision, as the JAX package's manager: an engine whose loop
died is reaped (by the next get() or the watchdog, traffic or not) and the
next request loads a fresh one, up to `restart_budget` deaths in
`restart_window_s`; one more quarantines the model for `quarantine_s`
(ModelQuarantinedError, HTTP 503 with Retry-After). The watchdog also
evicts idle and wedged models, and the config watcher evicts a model whose
YAML changed. The `manager_load` fault site sits at the entry of a load,
and LOCALAI_FAULTS (ApplicationConfig.faults) arms a seeded schedule at
construction. The journal, fence and postmortem settings reach every
engine (LOCALAI_TRACE_JOURNAL over the YAML's trace_journal_events).

Backends served: `llama` (and `rerank`, the reference's name for a llama
model that serves rerank), `vlm` / `llava` / `multimodal` (a llama engine
with a vision tower: a Qwen2-VL checkpoint's own, or a llava tower from
`options.vision` or the checkpoint), `bert` (embedders and
cross-encoders, engine/bert_engine.py), and the out-of-process `remote`
(a relay to another server, options.url) and `subprocess` (a supervised
child server of this package on the manager's device, in
`<models_dir>/.subprocess-<name>`; engine/remote.py), and the audio
backends `whisper` (also a `llama` model named like a whisper preset),
`tts` (the acoustic model or a VITS voice) and `vad`
(engine/audio_engine.py), and the image backends `diffusion` /
`diffusers` / `stablediffusion` (engine/image_engine.py: a DiT preset or
own-format checkpoint, a diffusers SD / SDXL checkpoint with its LoRAs,
ControlNet and motion adapter, or a Flux checkpoint). Reap, restart and
quarantine act on in-process engines only: an out-of-process engine never
reports dead, and a subprocess's death is its child's exit, which the next
request's respawn handles; unloading one stops its child. Not ported yet:
every other backend (ROADMAP Queue A item 13, satellite engines and
models; MusicGen's names refuse naming item 13 (e)). No YAML or server knob is dropped in silence: the
bounded-admission, fork, speculative-decoding and observability knobs
reach the engine (a `draft_model` loads from a preset or a checkpoint dir
beside the target), a server knob of an unported item fails its startup
naming the item, and the multi-GPU ones warn.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import threading
import time
from typing import Optional

from localai_tpu_torch.config import (
    ApplicationConfig,
    LoraConfigError,
    ModelConfig,
    ModelConfigLoader,
)
from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.engine.engine import Engine, EngineConfig
from localai_tpu_torch.engine.tokenizer import load_tokenizer
from localai_tpu_torch.templates import Evaluator
from localai_tpu_torch.testing import faults

log = logging.getLogger("localai_tpu_torch.manager")

# YAML route switches of the JAX package. The port has none: its wrappers
# always launch their kernels on the card.
_ROUTE_SWITCHES = ("paged_kernel", "quant_kernel", "lora_kernel")

# Backends served by the llama engine: `rerank` is the reference's name for
# a llama model whose config serves rerank (its loader falls through to
# the llama path); `llava` / `vlm` / `multimodal` attach a vision tower.
_VLM_BACKENDS = ("llava", "vlm", "multimodal")
_LLAMA_BACKENDS = ("llama", "rerank", *_VLM_BACKENDS)
# The JAX manager's image backend names, one loader.
_DIFFUSION_BACKENDS = ("diffusion", "diffusers", "stablediffusion")
# The JAX manager's MusicGen backend names (ROADMAP Queue A item 13 (e)).
_SOUNDGEN_BACKENDS = ("musicgen", "soundgen", "sound-generation")

# Server knobs of ROADMAP Queue A items not ported yet: set, one fails the
# server's startup naming its item.
_UNPORTED_APP_KNOBS = (
    (("cluster_replicas", "cluster_peers"), "12, cluster"),
)


def _non_default(obj, keys) -> list[str]:
    """`key=value` of each dataclass field in `keys` set away from its
    default."""
    fields = {f.name: f for f in dataclasses.fields(obj)}
    out = []
    for k in keys:
        f = fields[k]
        default = f.default_factory() if f.default is dataclasses.MISSING else f.default
        if getattr(obj, k) != default:
            out.append(f"{k}={getattr(obj, k)!r}")
    return out


def check_app_knobs(app_cfg: ApplicationConfig) -> None:
    """Server startup refuses a server knob of an unported item."""
    for keys, item in _UNPORTED_APP_KNOBS:
        bad = [f"{k}={getattr(app_cfg, k)!r}" for k in keys if getattr(app_cfg, k)]
        if bad:
            raise UnsupportedBackendError(
                f"{', '.join(bad)}: not ported yet (ROADMAP Queue A item {item}) — unset it")


class UnsupportedBackendError(NotImplementedError):
    """A model config names a backend the port does not serve yet, or sets
    a knob of a module it has not ported."""


class ModelQuarantinedError(RuntimeError):
    """The model's engine died more than restart_budget times inside
    restart_window_s, so the manager stopped respawning it. Requests get
    this typed error — HTTP 503 with Retry-After — instead of feeding a
    reload / crash loop."""

    def __init__(self, name: str, retry_after_s: float, deaths: int) -> None:
        super().__init__(
            f"model {name!r} quarantined after {deaths} engine deaths in "
            f"its restart window — retry in ~{retry_after_s:.0f}s"
        )
        self.model = name
        self.retry_after_s = max(1.0, retry_after_s)
        self.deaths = deaths


class LoadedModel:
    def __init__(self, cfg: ModelConfig, engine: Engine, evaluator: Evaluator):
        self.cfg = cfg
        self.engine = engine
        self.evaluator = evaluator
        # The vision tower of a vlm backend (models/vision.VisionEncoder or
        # models/qwen2_vl.Qwen2VLVisionEncoder), else None.
        self.vision = None
        self.loaded_at = time.monotonic()
        self.last_used = time.monotonic()
        self.busy_since: Optional[float] = None
        self.in_flight = 0
        self._lock = threading.Lock()

    def touch(self) -> None:
        self.last_used = time.monotonic()

    def acquire(self) -> None:
        with self._lock:
            self.in_flight += 1
            if self.busy_since is None:
                self.busy_since = time.monotonic()
            self.touch()

    def release(self) -> None:
        with self._lock:
            self.in_flight = max(0, self.in_flight - 1)
            if self.in_flight == 0:
                self.busy_since = None
            self.touch()

    def lease(self) -> "Lease":
        return Lease(self)


class VirtualModel(LoadedModel):
    """A per-tenant view over a shared base engine: the same Engine (the
    adapter is registered as a runtime tenant and every request carries
    `adapter=<name>`), with the tenant's own ModelConfig (templates, system
    prompt, generation defaults). In-flight accounting goes to the base, so
    eviction sees the engine's true load."""

    def __init__(self, cfg: ModelConfig, base: LoadedModel, adapter: str,
                 evaluator: Evaluator):
        super().__init__(cfg, base.engine, evaluator)
        self.base = base
        self.adapter = adapter

    def touch(self) -> None:
        super().touch()
        self.base.touch()

    def acquire(self) -> None:
        self.base.acquire()

    def release(self) -> None:
        self.base.release()


class Lease:
    """Idempotent in-flight marker: release() is safe to call from both a
    streaming generator's finally and an error path."""

    def __init__(self, lm: LoadedModel):
        self._lm = lm
        self._released = False
        self._lock = threading.Lock()
        lm.acquire()

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
        self._lm.release()


class ModelManager:
    def __init__(self, app_cfg: ApplicationConfig,
                 config_loader: Optional[ModelConfigLoader] = None, device="cuda"):
        check_app_knobs(app_cfg)
        self.device = resolve_device(device)
        self.app_cfg = app_cfg
        self.configs = config_loader or ModelConfigLoader(app_cfg.models_dir)
        self.configs.load_all()
        self._loaded: dict[str, LoadedModel] = {}
        self._lock = threading.Lock()
        self._loading: dict[str, threading.Event] = {}
        # Crash-only supervision: per-model engine-death times inside the
        # rolling restart window, lifetime totals, and the quarantine clock
        # (a monotonic deadline; absent = clear).
        self._death_times: dict[str, list[float]] = {}
        self._restart_total: dict[str, int] = {}
        self._quarantined_until: dict[str, float] = {}
        self._quarantine_total: dict[str, int] = {}
        faults.ensure_installed(app_cfg.faults)
        self._wd_stop = threading.Event()
        self._wd_thread: Optional[threading.Thread] = None
        if app_cfg.watchdog_idle_timeout_s > 0 or app_cfg.watchdog_busy_timeout_s > 0:
            self.ensure_watchdog()
        self._cw_thread: Optional[threading.Thread] = None
        if app_cfg.watch_configs:
            self.start_config_watcher(app_cfg.config_watch_interval_s)

    def list_configs(self) -> list[ModelConfig]:
        return [self.configs.get(n) for n in self.configs.names()]

    def loaded_names(self) -> list[str]:
        with self._lock:
            return sorted(self._loaded)

    @staticmethod
    def _engine_dead(lm: LoadedModel) -> bool:
        """Crash-only death probe: an engine without a loop of its own (an
        out-of-process backend) never reports dead."""
        return bool(getattr(lm.engine, "is_dead", False))

    def _note_death_locked(self, name: str, now: float) -> None:
        """Record one observed engine death; trip the quarantine when the
        restart budget for the rolling window is exhausted. Caller holds
        self._lock."""
        window = max(0.0, self.app_cfg.restart_window_s)
        times = [t for t in self._death_times.get(name, ()) if now - t < window]
        times.append(now)
        self._death_times[name] = times
        self._restart_total[name] = self._restart_total.get(name, 0) + 1
        budget = self.app_cfg.restart_budget
        if budget >= 0 and len(times) > budget:
            self._quarantined_until[name] = now + self.app_cfg.quarantine_s
            self._quarantine_total[name] = self._quarantine_total.get(name, 0) + 1
            log.error("model %s: %d engine deaths within %.0fs (budget %d) — quarantined "
                      "for %.0fs", name, len(times), window, budget, self.app_cfg.quarantine_s)

    def _reap_dead(self, name: str, teardown: bool = True) -> Optional[LoadedModel]:
        """Evict a loaded model whose engine loop died (the in-process
        analogue of a crashed backend process): the next get() loads a
        fresh engine — a transparent restart — unless the restart budget
        is exhausted, in which case the model sits in quarantine. Returns
        the reaped model (None if there was none), which is torn down on a
        thread here, or by the caller with `teardown=False`."""
        with self._lock:
            lm = self._loaded.get(name)
            if lm is None or not self._engine_dead(lm):
                return None
            self._loaded.pop(name)
            self._note_death_locked(name, time.monotonic())
        pm = lm.engine.postmortem_path
        log.warning("model %s: engine loop died (%s) — evicted for crash-only restart%s",
                    name, lm.engine._loop_dead, f" — postmortem: {pm}" if pm else "")
        if teardown:
            self._start_teardown(lm)
        return lm

    def _start_teardown(self, lm: LoadedModel) -> None:
        threading.Thread(target=self._teardown, args=(lm,), daemon=True,
                         name="model-teardown").start()

    def _check_quarantine(self, name: str) -> None:
        with self._lock:
            until = self._quarantined_until.get(name, 0.0)
            now = time.monotonic()
            if until > now:
                deaths = len(self._death_times.get(name, ()))
                raise ModelQuarantinedError(name, until - now, deaths)
            if until:
                self._quarantined_until.pop(name, None)

    def restart_stats(self, name: str) -> dict:
        """Supervision counters for one model (monitoring surface)."""
        with self._lock:
            now = time.monotonic()
            return {
                "restarts_total": self._restart_total.get(name, 0),
                "deaths_in_window": len(self._death_times.get(name, ())),
                "quarantines_total": self._quarantine_total.get(name, 0),
                "quarantined_for_s": max(0.0, self._quarantined_until.get(name, 0.0) - now),
            }

    def health_gauges(self):
        """(name, labels, value) supervision gauges for the /metrics scrape:
        they live on the manager, not on the (replaceable) engines."""
        with self._lock:
            restarts = dict(self._restart_total)
            quarantines = dict(self._quarantine_total)
            until = dict(self._quarantined_until)
        now = time.monotonic()
        out = []
        for n, c in restarts.items():
            out.append(("localai_model_restarts", {"model": n}, float(c)))
        for n, c in quarantines.items():
            out.append(("localai_model_quarantines", {"model": n}, float(c)))
            out.append(("localai_model_quarantined", {"model": n},
                        1.0 if until.get(n, 0.0) > now else 0.0))
        return out

    def get(self, name: str) -> LoadedModel:
        """Singleflight load. Raises KeyError for unknown models,
        ModelQuarantinedError while the model's restart budget is
        exhausted; a dead engine is reaped first and loaded again. Virtual
        models resolve to the base's shared engine with the adapter
        registered as a runtime tenant."""
        vcfg = self.configs.get(name)
        if vcfg is not None and (vcfg.base_model or vcfg.adapter):
            return self._get_virtual(name, vcfg)
        while True:
            # The quarantine a reap trips is checked before the dead engine's
            # teardown starts: Thread.start() waits for the new thread, whose
            # gc.collect() holds the GIL for as long as the heap takes, and
            # a check after it could find a short quarantine already over.
            reaped = self._reap_dead(name, teardown=False)
            try:
                self._check_quarantine(name)
            finally:
                if reaped is not None:
                    self._start_teardown(reaped)
            with self._lock:
                lm = self._loaded.get(name)
                if lm is not None and not self._engine_dead(lm):
                    lm.touch()
                    return lm
                if lm is not None:
                    continue  # died between the reap and here: reap again
                ev = self._loading.get(name)
                if ev is None:
                    ev = threading.Event()
                    self._loading[name] = ev
                    break  # we are the loader
            ev.wait()  # someone else is loading; retry
        try:
            cfg = self.configs.get(name)
            if cfg is None:
                raise KeyError(f"model {name!r} not found")
            try:
                lm = self._load(cfg)
            except (KeyError, RuntimeError, UnsupportedBackendError):
                raise
            except Exception as e:
                # A failed load (bad checkpoint, out of memory) errors this
                # one call and leaves serving up.
                gc.collect()
                raise RuntimeError(f"failed to load model {name!r}: {e}") from e
            with self._lock:
                self._loaded[name] = lm
                self._evict_lru_locked(protect=name)
            return lm
        finally:
            with self._lock:
                self._loading.pop(name, None)
            ev.set()

    def _get_virtual(self, name: str, cfg: ModelConfig) -> VirtualModel:
        """Load or reuse the base engine, register the adapter as a runtime
        tenant (idempotent; the engine fetches and promotes its factors at
        the first admission), and hand back a per-tenant view."""
        cfg.validate()  # typed LoraConfigError on half-configured entries
        base_cfg = self.configs.get(cfg.base_model)
        if base_cfg is None:
            raise KeyError(f"virtual model {name!r}: base model {cfg.base_model!r} not found")
        if base_cfg.base_model or base_cfg.adapter:
            raise LoraConfigError(f"virtual model {name!r}: base {cfg.base_model!r} is itself "
                                  "a virtual model — adapters do not nest")
        if base_cfg.lora_adapters:
            raise LoraConfigError(
                f"virtual model {name!r}: base {cfg.base_model!r} merges `lora_adapters` at "
                "load — a base serving runtime adapter tenants must keep its weights pristine")
        base = self.get(cfg.base_model)
        engine = base.engine
        engine.register_adapter(name, self._resolve_ckpt_dir(cfg.adapter),
                                weight=cfg.adapter_weight)
        return VirtualModel(cfg, base, adapter=name, evaluator=Evaluator(cfg, engine.tokenizer))

    def lease(self, name: str) -> tuple[LoadedModel, Lease]:
        """get() + acquire, atomically with respect to eviction. Virtual
        models anchor on their base (they are never in _loaded)."""
        while True:
            lm = self.get(name)
            anchor = getattr(lm, "base", lm)
            with self._lock:
                if self._loaded.get(anchor.cfg.name) is anchor:
                    return lm, lm.lease()
            # evicted between get() and now: load again and retry

    def peek(self, name: str) -> Optional[LoadedModel]:
        """A loaded model, without triggering a load (monitoring paths)."""
        with self._lock:
            return self._loaded.get(name)

    def unload(self, name: str, drain_s: float = 30.0) -> bool:
        """Drain in-flight requests (up to drain_s) in the background, then
        stop the engine and drop its tensors."""
        with self._lock:
            lm = self._loaded.pop(name, None)
        if lm is None:
            return False
        threading.Thread(target=self._drain_and_teardown, args=(lm, drain_s), daemon=True,
                         name="unload-drain").start()
        return True

    def _drain_and_teardown(self, lm: LoadedModel, drain_s: float) -> None:
        deadline = time.monotonic() + drain_s
        while lm.in_flight > 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        self._teardown(lm)

    def shutdown(self) -> None:
        self._wd_stop.set()
        with self._lock:
            loaded = list(self._loaded.values())
            self._loaded.clear()
        for lm in loaded:
            self._teardown(lm)

    # ------------------------------------------------------------------ #
    # Config hot-reload (mtime polling of the models dir)
    # ------------------------------------------------------------------ #

    def ensure_watchdog(self) -> None:
        """Start the watchdog thread (idempotent)."""
        if self._wd_thread is None:
            self._wd_thread = threading.Thread(target=self._watchdog_loop, daemon=True,
                                               name="watchdog")
            self._wd_thread.start()

    def start_config_watcher(self, interval_s: float = 2.0) -> None:
        if self._cw_thread is not None:
            return
        # Baseline taken synchronously: a change made after construction is
        # always seen, however slow the thread is to start.
        baseline = self._config_snapshot()
        self._cw_thread = threading.Thread(target=self._config_watch_loop,
                                           args=(interval_s, baseline), daemon=True,
                                           name="config-watcher")
        self._cw_thread.start()

    def _config_snapshot(self) -> dict[str, float]:
        out: dict[str, float] = {}
        try:
            for fname in os.listdir(self.app_cfg.models_dir):
                if fname.endswith((".yaml", ".yml")):
                    path = os.path.join(self.app_cfg.models_dir, fname)
                    try:
                        out[path] = os.stat(path).st_mtime
                    except OSError:
                        pass
        except OSError:
            pass
        return out

    def _config_watch_loop(self, interval_s: float, last: dict[str, float]) -> None:
        while not self._wd_stop.wait(interval_s):
            snap = self._config_snapshot()
            if snap == last:
                continue
            last = snap
            try:
                self.reload_configs()
            except Exception:  # noqa: BLE001 — a bad yaml must not kill the loop
                log.exception("config reload failed")

    def reload_configs(self) -> int:
        """Re-read every model YAML; evict loaded models whose config changed
        or disappeared (the next request loads them fresh). Returns the
        number of evictions."""
        old = {n: self.configs.get(n) for n in self.configs.names()}
        self.configs.load_all()
        evicted = 0
        for name in self.loaded_names():
            new_cfg = self.configs.get(name)
            if new_cfg is None or new_cfg != old.get(name):
                log.info("config for %s changed — evicting for reload", name)
                self.unload(name, drain_s=10.0)
                evicted += 1
        return evicted

    # ------------------------------------------------------------------ #
    # Watchdog (reference: pkg/model/watchdog.go)
    # ------------------------------------------------------------------ #

    def _watchdog_loop(self) -> None:
        while not self._wd_stop.wait(self.app_cfg.watchdog_interval_s):
            try:
                self._watchdog_tick()
            except Exception:  # noqa: BLE001 — the watchdog must survive
                log.exception("watchdog tick failed")

    def _watchdog_tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        idle_t = self.app_cfg.watchdog_idle_timeout_s
        busy_t = self.app_cfg.watchdog_busy_timeout_s
        with self._lock:
            snapshot = list(self._loaded.items())
        for name, lm in snapshot:
            if self._engine_dead(lm):
                # Reap a dead engine now, traffic or not: its memory frees
                # and the restart-budget clock starts from the real death.
                self._reap_dead(name)
                continue
            if busy_t > 0 and lm.busy_since is not None and now - lm.busy_since > busy_t:
                # A wedged generation would hold its slot forever: its
                # requests are cancelled (their streams end with
                # finish_reason stop) and the engine is evicted.
                n = lm.engine.cancel_all()
                log.warning("watchdog: model %s busy for >%gs — cancelled %d requests and "
                            "evicting", name, busy_t, n)
                self.unload(name, drain_s=5.0)
            elif idle_t > 0 and lm.in_flight == 0 and now - lm.last_used > idle_t:
                log.info("watchdog: model %s idle for >%gs — evicting", name, idle_t)
                self.unload(name, drain_s=0.0)

    # ------------------------------------------------------------------ #

    def _teardown(self, lm: LoadedModel) -> None:
        log.info("evicting model %s", lm.cfg.name)
        lm.engine.stop()
        lm.engine.drop_device_state()
        lm.vision = None  # the tower's weights go with the engine's
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    def _evict_lru_locked(self, protect: str = "") -> None:
        """LRU down to max_active_models (<= 0: unlimited). `protect` is the
        model a get() is about to hand out."""
        budget = self.app_cfg.max_active_models
        if budget <= 0:
            return
        while len(self._loaded) > budget:
            idle = [(lm.last_used, n) for n, lm in self._loaded.items()
                    if lm.in_flight == 0 and n != protect]
            if not idle:
                return  # everything busy; the next call retries
            _, victim = min(idle)
            lm = self._loaded.pop(victim)
            threading.Thread(target=self._drain_and_teardown, args=(lm, 30.0), daemon=True,
                             name="unload-drain").start()

    def _resolve_ckpt_dir(self, model: str) -> str:
        if os.path.isabs(model):
            return model
        return os.path.join(self.app_cfg.models_dir, model)

    def _parse_lora_entries(self, cfg: ModelConfig) -> list[tuple[str, float]]:
        """lora_adapters YAML entries ("path" or {"path": ..., "weight":
        1.0}) → [(resolved path, weight)]."""
        out = []
        for entry in cfg.lora_adapters:
            if isinstance(entry, dict):
                apath, w = str(entry.get("path", "")), float(entry.get("weight", 1.0))
            else:
                apath, w = str(entry), 1.0
            if not apath:
                raise ValueError(f"model {cfg.name!r}: lora_adapters entry missing a path")
            out.append((self._resolve_ckpt_dir(apath), w))
        return out

    def _load(self, cfg: ModelConfig) -> LoadedModel:
        """Load a llama-backend model: a preset name draws random weights
        from seed 0 on the device (straight into the quantized form with
        `quantization`), a directory is read as an HF checkpoint (quantized
        and LoRA-merged on the host as it is read), and a `.gguf` file keeps
        its quantized tensors in B3's grouped forms (engine/gguf.py) with
        the tokenizer its metadata spells."""
        from localai_tpu_torch.engine.gguf import load_gguf_checkpoint
        from localai_tpu_torch.engine.weights import (
            arch_from_hf_config,
            load_hf_checkpoint,
            params_from_numpy,
        )
        from localai_tpu_torch.models.config import PRESETS, get_arch
        from localai_tpu_torch.models.llama import init_params
        from localai_tpu_torch.models.quant import init_params_quantized

        from localai_tpu_torch.models.whisper import WHISPER_PRESETS

        faults.fire("manager_load")  # an injected load failure
        loader = {"bert": self._load_bert, "remote": self._load_remote,
                  "subprocess": self._load_subprocess, "whisper": self._load_whisper,
                  "tts": self._load_tts, "vad": self._load_vad}.get(cfg.backend)
        if cfg.backend in _DIFFUSION_BACKENDS:
            loader = self._load_diffusion
        if loader is None and cfg.backend == "llama" and (
                cfg.model in WHISPER_PRESETS or "whisper" in cfg.model):
            loader = self._load_whisper  # the JAX manager's routing of whisper names
        if loader is not None:
            return loader(cfg)
        if cfg.backend in _SOUNDGEN_BACKENDS:
            raise UnsupportedBackendError(
                f"model {cfg.name!r}: backend {cfg.backend!r} (MusicGen sound generation) is "
                "not ported yet (ROADMAP Queue A item 13 (e))")
        if cfg.backend not in _LLAMA_BACKENDS:
            raise UnsupportedBackendError(
                f"model {cfg.name!r}: backend {cfg.backend!r} is not ported yet "
                "(ROADMAP Queue A item 13, satellite engines and models); the port "
                "serves the llama, vlm (llava / multimodal), bert, whisper, tts, vad, diffusion "
                "(diffusers / stablediffusion), remote and subprocess backends")
        switched = [f"{k}={getattr(cfg, k)!r}" for k in _ROUTE_SWITCHES
                    if getattr(cfg, k) != "auto"]
        if switched:
            log.warning("model %s: %s ignored — the port has no kernel route switch; its "
                        "kernels always run on the card", cfg.name, ", ".join(switched))
        if "prefix_admit_async_compile" in cfg.options:
            log.warning("model %s: prefix_admit_async_compile ignored — the port's cached "
                        "admission runs eagerly and compiles nothing", cfg.name)
        # The reference acts on these only across devices, and degrades a
        # tp the devices cannot hold: one warning each.
        multi = _non_default(cfg, ("sp_prefill",))
        if cfg.tensor_parallel > 1:
            multi.insert(0, f"tensor_parallel={cfg.tensor_parallel!r}")
        for knob in multi:
            log.warning("model %s: %s ignored — the port serves one GPU (ROADMAP Queue A "
                        "item 14, multi-GPU)", cfg.name, knob)
        t0 = time.monotonic()
        ckpt_dir: Optional[str] = None
        gguf_tree = gguf_tok_dir = None
        if cfg.model.endswith(".gguf"):
            path = self._resolve_ckpt_dir(cfg.model)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"model {cfg.name!r}: {path!r} not found")
            arch, gguf_tree, gguf_tok_dir = load_gguf_checkpoint(path)
        elif cfg.model in PRESETS:
            arch = get_arch(cfg.model)
        else:
            ckpt_dir = self._resolve_ckpt_dir(cfg.model)
            if not os.path.isdir(ckpt_dir):
                raise FileNotFoundError(
                    f"model {cfg.name!r}: checkpoint dir {ckpt_dir!r} not found and not an "
                    f"arch preset ({sorted(PRESETS)})")
            arch = arch_from_hf_config(ckpt_dir)
        arch = _apply_rope_overrides(arch, cfg)

        tok_path = cfg.tokenizer or gguf_tok_dir or ckpt_dir
        if tok_path and tok_path != "synthetic-bytes" and not _has_tokenizer_files(tok_path):
            tok_path = None
        tokenizer = load_tokenizer(tok_path, vocab_size=arch.vocab_size)
        if cfg.lora_adapters and ckpt_dir is None:
            # GGUF payloads are already quantized: there is no bf16 tensor
            # to merge a delta into.
            raise ValueError(f"model {cfg.name!r}: lora_adapters require an HF safetensors "
                             "checkpoint (not GGUF or a synthetic preset)")
        if gguf_tree is not None:
            # The file's forms are served as they are: the engine quantizes
            # only a tree with no quantized matmul weight (an F16 / BF16 file).
            params = params_from_numpy(arch, gguf_tree, device=self.device)
            del gguf_tree
        elif ckpt_dir is not None:
            lora = self._parse_lora_entries(cfg)
            params = load_hf_checkpoint(arch, ckpt_dir, device=self.device,
                                        quantize=cfg.quantization, lora=lora or None)
            for adir, w in lora:
                log.info("model %s: merged lora adapter %s (weight=%.2f)", cfg.name, adir, w)
        elif cfg.quantization and cfg.quantization != "none":
            # A preset with quantization is drawn straight into the quantized
            # form, one layer at a time, so a model whose bf16 weights would
            # not fit (mixtral-8x7b) still loads.
            params = init_params_quantized(arch, seed=0, mode=cfg.quantization,
                                           device=self.device)
        else:
            params = init_params(arch, seed=0, device=self.device)
        draft_arch = draft_params = None
        if cfg.draft_model and cfg.spec_mode in ("prompt_lookup", "self_draft"):
            # The model-free modes draft from the target's own weights or
            # the token streams: the checkpoint would sit dead in memory.
            log.info("model %s: spec_mode=%s is model-free — skipping draft checkpoint %s",
                     cfg.name, cfg.spec_mode, cfg.draft_model)
        elif cfg.draft_model:
            if cfg.draft_model in PRESETS:
                draft_arch = get_arch(cfg.draft_model)
                draft_params = init_params(draft_arch, seed=1, device=self.device)
            else:
                dd = self._resolve_ckpt_dir(cfg.draft_model)
                draft_arch = arch_from_hf_config(dd)
                draft_params = load_hf_checkpoint(draft_arch, dd, device=self.device)
        engine = Engine(
            arch, params, tokenizer, device=self.device,
            quantization="" if cfg.quantization == "none" else cfg.quantization,
            engine_cfg=EngineConfig(
                max_slots=cfg.max_slots, max_seq=cfg.context_size,
                kv_pages=cfg.kv_pages, kv_page_size=cfg.kv_page_size,
                kv_page_headroom=cfg.kv_page_headroom, kv_cache_dtype=cfg.kv_cache_dtype,
                kv_preempt=cfg.kv_preempt, kv_swap_bytes=cfg.kv_swap_bytes,
                kv_scale=cfg.kv_scale, prefill_chunk=cfg.prefill_chunk,
                max_pending=cfg.max_pending, adapter_cache_bytes=cfg.adapter_cache_bytes,
                attention_sink=cfg.attention_sink, attention_window=cfg.attention_window,
                kv_spill_bytes=cfg.kv_spill_bytes, kv_l1_span=cfg.kv_l1_span,
                queue_timeout_s=cfg.queue_timeout_s, deadline_s=cfg.deadline_s,
                fork_sampling=cfg.fork_sampling, spec_mode=cfg.spec_mode,
                self_draft_layers=cfg.self_draft_layers,
                spec_accept_ewma=cfg.spec_accept_ewma,
                spec_draft_buckets=tuple(cfg.spec_draft_buckets),
                trace_journal_events=(cfg.trace_journal_events
                                      if self.app_cfg.trace_journal is None
                                      else self.app_cfg.trace_journal),
                trace_fence=self.app_cfg.trace_fence,
                postmortem_dir=self.app_cfg.postmortem_dir,
            ),
            draft_cfg=draft_arch, draft_params=draft_params, n_draft=cfg.n_draft,
        )
        lm = LoadedModel(cfg, engine, Evaluator(cfg, tokenizer))
        vlm = cfg.backend in _VLM_BACKENDS
        if vlm:
            try:
                lm.vision = self._load_vision(cfg, arch, ckpt_dir)
            except BaseException:
                engine.stop()
                raise
        engine.start()
        log.info("loaded model %s (arch=%s, %s%s) in %.1fs", cfg.name, arch.name, self.device,
                 " +vision" if vlm else "", time.monotonic() - t0)
        return lm

    def _load_vision(self, cfg: ModelConfig, arch, ckpt_dir: Optional[str]):
        """The tower of a vlm backend, as the JAX manager attaches it: a
        Qwen2-VL checkpoint's own (native resolution + m-rope), else the
        `options.vision` preset (random weights from a torch generator,
        seed 2: not the JAX package's draw) or the checkpoint's llava
        tower. The projector must land in the decoder's width."""
        from localai_tpu_torch.models import qwen2_vl as QV
        from localai_tpu_torch.models import vision as V

        varch = cfg.options.get("vision", "")
        if ckpt_dir is not None and QV.is_qwen2_vl_dir(ckpt_dir):
            qcfg = QV.vision_config_from_hf(ckpt_dir)
            if qcfg.hidden_size != arch.hidden_size:
                raise ValueError(f"qwen2-vl merger dim {qcfg.hidden_size} != LLM "
                                 f"hidden {arch.hidden_size}")
            return QV.Qwen2VLVisionEncoder(
                qcfg, QV.load_hf_qwen2_vl_vision(qcfg, ckpt_dir, device=self.device))
        if varch in V.VISION_PRESETS:
            vcfg = V.VISION_PRESETS[varch]
            vparams = V.init_params(vcfg, seed=2, device=self.device)
        elif ckpt_dir is not None:
            vcfg = V.vision_config_from_hf(ckpt_dir)
            vparams = V.load_hf_vision(vcfg, ckpt_dir, device=self.device)
        else:
            raise ValueError(f"model {cfg.name!r}: vlm backend needs options.vision "
                             f"(preset) or a checkpoint with a vision tower")
        if vcfg.llm_dim != arch.hidden_size:
            raise ValueError(f"vision projector dim {vcfg.llm_dim} != LLM hidden "
                             f"{arch.hidden_size}")
        return V.VisionEncoder(vcfg, vparams)

    def _load_bert(self, cfg: ModelConfig) -> LoadedModel:
        """A bert embedder or cross-encoder: a preset draws random f32
        weights from seed 0 on the device, a directory is read as an HF
        BertModel / BertForSequenceClassification checkpoint; then the
        tokenizer (the YAML's, else the checkpoint's, else bytes)."""
        from localai_tpu_torch.engine.bert_engine import BertEngine
        from localai_tpu_torch.models import bert as B

        t0 = time.monotonic()
        if cfg.model in B.BERT_PRESETS:
            bcfg = B.BERT_PRESETS[cfg.model]
            params = B.init_params(bcfg, seed=0, device=self.device)
            tok_path = cfg.tokenizer or None
        else:
            ckpt_dir = self._resolve_ckpt_dir(cfg.model)
            if not os.path.isdir(ckpt_dir):
                raise FileNotFoundError(
                    f"model {cfg.name!r}: bert checkpoint {ckpt_dir!r} not found")
            bcfg = B.bert_config_from_hf(ckpt_dir)
            params = B.load_hf_bert(bcfg, ckpt_dir, device=self.device)
            tok_path = cfg.tokenizer or ckpt_dir
        if tok_path and not _has_tokenizer_files(tok_path):
            tok_path = None
        tokenizer = load_tokenizer(tok_path, vocab_size=bcfg.vocab_size)
        log.info("loaded model %s (bert %s, %s) in %.1fs", cfg.name, bcfg.name, self.device,
                 time.monotonic() - t0)
        return LoadedModel(cfg, BertEngine(bcfg, params, tokenizer), None)

    def _load_whisper(self, cfg: ModelConfig) -> LoadedModel:
        """Whisper speech to text: a preset draws random weights from seed 0
        on the device, a directory is read as an HF whisper checkpoint
        (with its tokenizer when it ships one)."""
        from localai_tpu_torch.engine.audio_engine import WhisperEngine
        from localai_tpu_torch.models import whisper as W

        if cfg.model in W.WHISPER_PRESETS:
            wcfg = W.WHISPER_PRESETS[cfg.model]
            return LoadedModel(cfg, WhisperEngine(
                wcfg, W.init_params(wcfg, seed=0, device=self.device)), None)
        ckpt_dir = self._resolve_ckpt_dir(cfg.model)
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"model {cfg.name!r}: whisper checkpoint {ckpt_dir!r} not found")
        wcfg = W.whisper_config_from_hf(ckpt_dir)
        params = W.load_hf_whisper(wcfg, ckpt_dir, device=self.device)
        tokenizer = None
        if _has_tokenizer_files(ckpt_dir):
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(ckpt_dir, local_files_only=True)
        return LoadedModel(cfg, WhisperEngine(wcfg, params, tokenizer), None)

    def _load_tts(self, cfg: ModelConfig) -> LoadedModel:
        """Text to speech: a preset draws random weights from seed 0; a
        directory is an HF VITS voice (is_vits_dir) or the JAX package's own
        TTS layout (save_tts). A MusicGen directory is ROADMAP Queue A item
        13 (e)."""
        from localai_tpu_torch.engine.audio_engine import TTSEngine, VitsEngine
        from localai_tpu_torch.models import tts as T
        from localai_tpu_torch.models import vits as V

        voices = cfg.options.get("voices")
        if cfg.model in T.TTS_PRESETS:
            tcfg = T.TTS_PRESETS[cfg.model]
            return LoadedModel(cfg, TTSEngine(tcfg, T.init_params(tcfg, seed=0,
                                                                  device=self.device),
                                              voices=voices), None)
        ckpt_dir = self._resolve_ckpt_dir(cfg.model)
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(f"model {cfg.name!r}: tts checkpoint {ckpt_dir!r} not found")
        if _model_type(ckpt_dir) == "musicgen":
            raise UnsupportedBackendError(
                f"model {cfg.name!r}: {ckpt_dir!r} is a MusicGen checkpoint; sound generation "
                "is not ported yet (ROADMAP Queue A item 13 (e))")
        if V.is_vits_dir(ckpt_dir):
            vcfg, vparams, vtok = V.load_vits(ckpt_dir, device=self.device)
            return LoadedModel(cfg, VitsEngine(vcfg, vparams, vtok, voices=voices), None)
        tcfg, params = T.load_tts(ckpt_dir, device=self.device)
        return LoadedModel(cfg, TTSEngine(tcfg, params, voices=voices), None)

    def _load_vad(self, cfg: ModelConfig) -> LoadedModel:
        """Voice activity: the packaged learned net by default (`model`
        empty, builtin, base, vad-base or silero), a directory's
        vad.safetensors / model.safetensors, or `model: energy` for the
        weightless detector."""
        from localai_tpu_torch.audio import learned_vad as LV
        from localai_tpu_torch.engine.audio_engine import VADEngine

        weights = None
        if cfg.model in ("", "builtin", "base", "vad-base", "silero"):
            weights = LV.packaged_weights()
        if weights is None and cfg.model and cfg.model != "energy":
            ckpt_dir = self._resolve_ckpt_dir(cfg.model)
            if not os.path.isdir(ckpt_dir):
                raise FileNotFoundError(
                    f"model {cfg.name!r}: vad checkpoint {ckpt_dir!r} not found")
            weights = LV.find_weights(ckpt_dir)
            if not weights:
                raise FileNotFoundError(
                    f"model {cfg.name!r}: no vad.safetensors/model.safetensors in {ckpt_dir!r}")
        if weights is None:
            return LoadedModel(cfg, VADEngine(), None)
        params = LV.load_params(weights, device=self.device)
        return LoadedModel(cfg, VADEngine(LV.config_from_params(params), params), None)

    def _load_diffusion(self, cfg: ModelConfig) -> LoadedModel:
        """Image generation: a DiT preset draws random f32 weights from seed
        0 on the device; a directory is a Flux checkpoint (options.dtype,
        bf16 by default), a diffusers SD / SDXL checkpoint (options.dtype,
        else its stored dtype, with lora_adapters merged, options.scheduler checked here and
        a motion adapter from options.motion_adapter or its
        motion_adapter/ subdir) or an own-format DiT checkpoint. The
        refusals are the JAX loader's, word for word."""
        from localai_tpu_torch.engine.image_engine import (
            DiffusionEngine,
            FluxEngine,
            LatentDiffusionEngine,
        )
        from localai_tpu_torch.models import diffusion as D

        if cfg.model in D.DIFFUSION_PRESETS:
            if cfg.lora_adapters:
                raise ValueError(
                    f"model {cfg.name!r}: lora_adapters need a diffusers-"
                    "layout SD/SDXL checkpoint (not a synthetic preset)")
            dcfg = D.DIFFUSION_PRESETS[cfg.model]
            return LoadedModel(cfg, DiffusionEngine(dcfg, D.init_params(
                dcfg, seed=0, device=self.device)), None)
        ckpt_dir = self._resolve_ckpt_dir(cfg.model)
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"model {cfg.name!r}: diffusion checkpoint {ckpt_dir!r} not found")
        from localai_tpu_torch.models import flux as FX
        from localai_tpu_torch.models import latent_diffusion as LD

        import torch

        dtypes = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float32": torch.float32, "fp32": torch.float32}
        opt = str(cfg.options.get("dtype", "bfloat16")).lower()
        if opt not in dtypes:
            raise ValueError(
                f"model {cfg.name!r}: options.dtype {opt!r} — use bfloat16 or float32")
        if FX.is_flux_dir(ckpt_dir):
            if cfg.lora_adapters:
                raise ValueError(
                    f"model {cfg.name!r}: lora_adapters target SD/SDXL "
                    "checkpoints (kohya format); Flux LoRA is unsupported")
            fcfg, fparams, ftoks = FX.load_flux_pipeline(ckpt_dir, dtype=dtypes[opt],
                                                         device=self.device)
            return LoadedModel(cfg, FluxEngine(fcfg, fparams, ftoks), None)
        if LD.is_diffusers_dir(ckpt_dir):
            from localai_tpu_torch.models import video_diffusion as VD

            ldcfg, ldparams, tok = LD.load_pipeline(
                ckpt_dir, dtype=dtypes[opt] if "dtype" in cfg.options else None,
                device=self.device)
            for apath, w in self._parse_lora_entries(cfg):
                n_merged = LD.load_diffusion_lora(apath, ldparams, w)
                if n_merged == 0:
                    raise ValueError(
                        f"model {cfg.name!r}: lora adapter {apath!r} "
                        "matched no unet/text-encoder tensors")
                log.info("model %s: merged %d lora tensors from %s (weight=%.2f)",
                         cfg.name, n_merged, apath, w)
            motion = None
            mdir = cfg.options.get("motion_adapter") or ""
            if mdir:
                mdir = self._resolve_ckpt_dir(str(mdir))
            elif VD.is_motion_adapter_dir(os.path.join(ckpt_dir, "motion_adapter")):
                mdir = os.path.join(ckpt_dir, "motion_adapter")
            if mdir:
                if not VD.is_motion_adapter_dir(mdir):
                    raise FileNotFoundError(
                        f"model {cfg.name!r}: motion_adapter {mdir!r} is "
                        "not a diffusers MotionAdapter dir")
                dt = next(iter(ldparams["unet"].values())).dtype
                motion = VD.load_motion_adapter(mdir, dtype=dt, device=self.device)
                log.info("model %s: motion adapter loaded from %s", cfg.name, mdir)
            sched = str(cfg.options.get("scheduler", "ddim"))
            if sched not in LD.SUPPORTED_SCHEDULERS:  # fail at load, not at a request
                raise ValueError(
                    f"model {cfg.name!r}: unknown scheduler {sched!r} "
                    f"(supported: {', '.join(sorted(LD.SUPPORTED_SCHEDULERS))})")
            return LoadedModel(cfg, LatentDiffusionEngine(
                ldcfg, ldparams, tok, default_scheduler=sched, motion=motion), None)
        if cfg.lora_adapters:
            raise ValueError(
                f"model {cfg.name!r}: lora_adapters need a diffusers-"
                "layout SD/SDXL checkpoint (this is an own-format "
                "diffusion checkpoint)")
        dcfg, params = D.load_diffusion(ckpt_dir, device=self.device)
        return LoadedModel(cfg, DiffusionEngine(dcfg, params), None)

    def _load_remote(self, cfg: ModelConfig) -> LoadedModel:
        from localai_tpu_torch.engine.remote import RemoteEngine

        url = cfg.options.get("url")
        if not url:
            raise ValueError(f"model {cfg.name!r}: backend remote needs options.url")
        eng = RemoteEngine(url, remote_model=cfg.options.get("remote_model", ""),
                           api_key=cfg.options.get("api_key", ""))
        return LoadedModel(cfg, eng, None)

    def _load_subprocess(self, cfg: ModelConfig) -> LoadedModel:
        """A child server of this package owns the model (options.child is
        its YAML; else the model, context, token and slot settings of this
        one), on this manager's device. Nothing spawns here: the first
        request does."""
        from localai_tpu_torch.engine.remote import SubprocessEngine

        child = dict(cfg.options.get("child") or {})
        if not child:
            child = {"model": cfg.model, "context_size": cfg.context_size,
                     "max_tokens": cfg.max_tokens, "max_slots": cfg.max_slots}
        eng = SubprocessEngine(
            cfg.name, child,
            workdir=os.path.join(self.app_cfg.models_dir, f".subprocess-{cfg.name}"),
            device=str(self.device), env_extra=cfg.options.get("env") or {})
        return LoadedModel(cfg, eng, None)


def _apply_rope_overrides(arch, cfg):
    """YAML rope knobs override the checkpoint's (model_config.go
    rope_scaling / rope_freq_base are user config)."""
    import dataclasses

    updates = {}
    if cfg.rope_freq_base:
        updates["rope_theta"] = float(cfg.rope_freq_base)
    rs = cfg.rope_scaling
    if rs:
        stype = rs.get("rope_type") or rs.get("type")
        if stype == "su":
            stype = "longrope"
        if stype not in ("linear", "llama3", "yarn", "longrope"):
            raise ValueError(f"model {cfg.name!r}: rope_scaling needs rope_type in "
                             f"linear/llama3/yarn/longrope (got {stype!r})")
        updates["rope_scaling"] = stype
        for key, field, cast in (
            ("factor", "rope_scaling_factor", float),
            ("original_max_position_embeddings", "rope_original_max_position", int),
            ("low_freq_factor", "rope_low_freq_factor", float),
            ("high_freq_factor", "rope_high_freq_factor", float),
            ("beta_fast", "rope_beta_fast", float),
            ("beta_slow", "rope_beta_slow", float),
        ):
            if key in rs:
                updates[field] = cast(rs[key])
        if rs.get("long_factor"):
            updates["rope_long_factor"] = tuple(rs["long_factor"])
        if rs.get("short_factor"):
            updates["rope_short_factor"] = tuple(rs["short_factor"])
        if rs.get("attention_factor") is not None:
            updates["rope_attn_factor"] = float(rs["attention_factor"])
        # A scaled rope serves past the checkpoint's window: lift
        # max_position to the deployment context.
        updates["max_position"] = max(arch.max_position, cfg.context_size)
    return dataclasses.replace(arch, **updates) if updates else arch


def _model_type(ckpt_dir: str) -> str:
    """config.json's model_type, or "" without a readable one."""
    import json

    try:
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            return str(json.load(f).get("model_type", ""))
    except (OSError, ValueError):
        return ""


def _has_tokenizer_files(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, f))
               for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json"))
