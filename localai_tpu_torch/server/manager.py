"""Model lifecycle manager: lazy engine loading with singleflight + LRU, and
virtual models (the LLM part of localai_tpu/server/manager.py).

One manager owns every engine of the process, all on one device. "Loading"
reads a checkpoint (an HF safetensors directory or a GGUF file), or draws a
preset's random weights, onto the device and
starts an engine; "evicting" stops the engine and drops its tensors. A
virtual model (`base_model` + `adapter` in its YAML) resolves to its base's
one shared engine with the adapter registered as a runtime LoRA tenant, so
N tenants cost one set of base weights.

Not ported yet: the watchdog, crash-only quarantine and config watcher
(ROADMAP Queue A item 11, runtime, observability and faults), and every
backend but `llama` (item 13, satellite engines and models). No YAML or
server knob is dropped in silence: the bounded-admission, fork and
speculative-decoding knobs reach the engine (a `draft_model` loads from a
preset or a checkpoint dir beside the target), a knob of an unported item fails the load (or, for the
server's, its startup) naming the item, and the multi-GPU ones warn.
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

log = logging.getLogger("localai_tpu_torch.manager")

# YAML route switches of the JAX package. The port has none: its wrappers
# always launch their kernels on the card.
_ROUTE_SWITCHES = ("paged_kernel", "quant_kernel", "lora_kernel")

# Model knobs of ROADMAP Queue A items not ported yet: set away from its
# default, one fails the load naming its item.
_UNPORTED_MODEL_KNOBS = (
    (("trace_journal_events",), "11, runtime, observability and faults"),
)
# Server knobs of items not ported yet: set, one fails the server's startup.
_UNPORTED_APP_KNOBS = (
    (("postmortem_dir",), "11, runtime, observability and faults"),
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


class LoadedModel:
    def __init__(self, cfg: ModelConfig, engine: Engine, evaluator: Evaluator):
        self.cfg = cfg
        self.engine = engine
        self.evaluator = evaluator
        self.last_used = time.monotonic()
        self.in_flight = 0
        self._lock = threading.Lock()

    def touch(self) -> None:
        self.last_used = time.monotonic()

    def acquire(self) -> None:
        with self._lock:
            self.in_flight += 1
            self.touch()

    def release(self) -> None:
        with self._lock:
            self.in_flight = max(0, self.in_flight - 1)
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

    def list_configs(self) -> list[ModelConfig]:
        return [self.configs.get(n) for n in self.configs.names()]

    def loaded_names(self) -> list[str]:
        with self._lock:
            return sorted(self._loaded)

    def get(self, name: str) -> LoadedModel:
        """Singleflight load. Raises KeyError for unknown models; virtual
        models resolve to the base's shared engine with the adapter
        registered as a runtime tenant."""
        vcfg = self.configs.get(name)
        if vcfg is not None and (vcfg.base_model or vcfg.adapter):
            return self._get_virtual(name, vcfg)
        while True:
            with self._lock:
                lm = self._loaded.get(name)
                if lm is not None:
                    lm.touch()
                    return lm
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
        with self._lock:
            loaded = list(self._loaded.values())
            self._loaded.clear()
        for lm in loaded:
            self._teardown(lm)

    def _teardown(self, lm: LoadedModel) -> None:
        log.info("evicting model %s", lm.cfg.name)
        lm.engine.stop()
        lm.engine.params = None
        lm.engine.cache = None
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

        if cfg.backend != "llama":
            raise UnsupportedBackendError(
                f"model {cfg.name!r}: backend {cfg.backend!r} is not ported yet "
                "(ROADMAP Queue A item 13, satellite engines and models); the port "
                "serves the llama backend")
        switched = [f"{k}={getattr(cfg, k)!r}" for k in _ROUTE_SWITCHES
                    if getattr(cfg, k) != "auto"]
        if switched:
            log.warning("model %s: %s ignored — the port has no kernel route switch; its "
                        "kernels always run on the card", cfg.name, ", ".join(switched))
        if "prefix_admit_async_compile" in cfg.options:
            log.warning("model %s: prefix_admit_async_compile ignored — the port's cached "
                        "admission runs eagerly and compiles nothing", cfg.name)
        for keys, item in _UNPORTED_MODEL_KNOBS:
            bad = _non_default(cfg, keys)
            if bad:
                raise UnsupportedBackendError(
                    f"model {cfg.name!r}: {', '.join(bad)} not ported yet (ROADMAP Queue A "
                    f"item {item}) — remove it from the model config")
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
            ),
            draft_cfg=draft_arch, draft_params=draft_params, n_draft=cfg.n_draft,
        )
        engine.start()
        log.info("loaded model %s (arch=%s, %s) in %.1fs", cfg.name, arch.name, self.device,
                 time.monotonic() - t0)
        return LoadedModel(cfg, engine, Evaluator(cfg, tokenizer))


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


def _has_tokenizer_files(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, f))
               for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json"))
