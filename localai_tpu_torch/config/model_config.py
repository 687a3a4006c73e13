"""Per-model YAML configuration (a copy of localai_tpu/config/model_config.py,
so one models dir configures either package).

The PyTorch port reads the same schema. It passes none of the route
switches `paged_kernel` / `quant_kernel` / `lora_kernel` on (its wrappers
always launch their kernels on the card; server/manager.py warns once when
a YAML sets one), and it serves the llama and bert backends.

TPU-native rework of the reference ModelConfig (core/config/model_config.go:
31-83 fields, :363-478 SetDefaults, :480-508 validation, :520-538 usecase
flags, :593-679 GuessUsecases). Differences by design:

- `backend` names a JAX model family (llama-family decoder today) instead of a
  subprocess binary; `model` points at an HF-format checkpoint directory or an
  arch preset name (random-init, for benchmarks) instead of a GGUF file.
- Parallelism is part of the model config (mesh axes tp/dp/ep/sp), because on
  TPU the sharding plan is as much a property of serving a model as its
  context size — the reference buries this in engine-specific options
  (tensor_split, grpc-server.cpp:493-496).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import re
from typing import Any, Optional

import yaml


class Usecase(enum.Flag):
    """Endpoint routing flags (reference: model_config.go:520-538)."""

    CHAT = enum.auto()
    COMPLETION = enum.auto()
    EDIT = enum.auto()
    EMBEDDINGS = enum.auto()
    TOKENIZE = enum.auto()
    RERANK = enum.auto()
    IMAGE = enum.auto()
    VIDEO = enum.auto()
    TTS = enum.auto()
    TRANSCRIPT = enum.auto()
    SOUND_GENERATION = enum.auto()
    VAD = enum.auto()
    DETECTION = enum.auto()

    @classmethod
    def any_llm(cls) -> "Usecase":
        return cls.CHAT | cls.COMPLETION | cls.EDIT | cls.EMBEDDINGS | cls.TOKENIZE


_NAME_RE = re.compile(r"^[a-zA-Z0-9_\-./:]+$")


class LoraConfigError(ValueError):
    """A LoRA serving configuration is self-contradictory
    (docs/LORA_SERVING.md): merge-at-load `lora_adapters` and a runtime
    `adapter` configured against the same base would apply the delta twice
    (or silently disagree about quantization order), a virtual model is
    missing its `base_model`/`adapter` half, or virtual models are nested.
    Typed so the manager/API can 400 the one model instead of failing the
    config load."""


@dataclasses.dataclass
class TemplateConfig:
    """Prompt template selection (reference: TemplateConfig model_config.go:250-278)."""

    chat: Optional[str] = None  # jinja2 template for the whole chat
    chat_message: Optional[str] = None  # jinja2 template applied per message
    completion: Optional[str] = None
    edit: Optional[str] = None
    use_tokenizer_template: bool = False  # use the HF tokenizer's chat template
    family: Optional[str] = None  # built-in family: llama3 | chatml | mistral | alpaca


@dataclasses.dataclass
class ParallelConfig:
    """Mesh axes for serving this model (tp over ICI first; see parallel.mesh)."""

    tp: int = 0  # 0 = all devices
    dp: int = 1
    ep: int = 1
    sp: int = 1


@dataclasses.dataclass
class ModelConfig:
    name: str = ""
    backend: str = "llama"  # JAX model family
    model: str = ""  # checkpoint dir (HF safetensors) or arch preset name
    tokenizer: str = ""  # tokenizer dir; empty = byte-level fallback
    description: str = ""

    # Generation defaults (reference: PredictionOptions / LLMConfig).
    context_size: int = 2048
    max_tokens: int = 512
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None
    stop: list[str] = dataclasses.field(default_factory=list)

    # Engine shape knobs.
    max_slots: int = 8
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # Tensor-parallel serving (docs/SHARDED_SERVING.md): shard the
    # weights, KV cache/page pool, and Pallas kernels over this many chips.
    # The flat knob (reference: llama.cpp tensor_split / vLLM
    # tensor_parallel_size) — wins over the nested parallel.tp when > 0;
    # 0 = auto (all devices left after dp/ep/sp, degraded to the
    # architecture's max_valid_tp). A value the model cannot shard evenly
    # degrades to that max with a warning instead of failing the load.
    # LOCALAI_TENSOR_PARALLEL env var overrides ("auto" = all devices).
    tensor_parallel: int = 0
    # Paged KV cache (engine/engine.py kv_pages): pool HBM scales with live
    # context instead of max_slots × context_size. 0 = dense cache.
    kv_pages: int = 0
    kv_page_size: int = 128
    # On-demand KV page growth (docs/PAGED_ATTENTION.md): admission
    # reserves only the prompt's pages + this headroom; decode grows the
    # table as the context actually extends. LOCALAI_KV_PAGE_HEADROOM
    # env var overrides.
    kv_page_headroom: int = 1
    # Mid-decode pool-exhaustion policy: swap | recompute | auto (see
    # EngineConfig.kv_preempt). The port reads no environment override.
    kv_preempt: str = "auto"
    # Host-RAM budget for preempt-swap images + spilled prefix-cache spans
    # (the prefix cache's second level). 0 disables the tier. The port
    # reads no environment override.
    kv_swap_bytes: int = 256 << 20
    # KV-cache storage dtype (reference: cache_type_k/cache_type_v →
    # CacheTypeKey/Value, backend.proto:261-262). "fp8" halves KV HBM — 2x
    # servable context at the same pool size. Empty = model dtype.
    kv_cache_dtype: str = ""
    # Paged decode attention kernel (docs/PAGED_ATTENTION.md): "auto" runs
    # the fused ragged paged-attention Pallas kernel on TPU and the XLA
    # reference elsewhere; "pallas"/"xla" force one.
    paged_kernel: str = "auto"
    # Quantized-matmul kernel (docs/QUANTIZATION.md): "auto" runs the fused
    # Pallas dequant-matmul kernels for decode-shape matmuls on TPU (packed
    # int8/int4 bytes unpacked + scaled in VMEM registers — one HBM pass)
    # and the XLA dequant path elsewhere; "pallas"/"xla" force one.
    # LOCALAI_QUANT_KERNEL env var overrides.
    quant_kernel: str = "auto"
    # Per-head KV dequant scale for a SCALED fp8 paged pool: rows store
    # value/kv_scale, readers multiply back in-kernel (docs/QUANTIZATION.md
    # § fp8 KV). 1.0 = cast-only storage. Requires kv_pages > 0 and an fp8
    # kv_cache_dtype. LOCALAI_KV_SCALE env var overrides.
    kv_scale: float = 1.0
    # Chunked ragged prefill (docs/CHUNKED_PREFILL.md): prompts longer than
    # this admit in prefill_chunk-token chunks interleaved with decode
    # blocks, so a long prompt never stalls running requests and TTFT for
    # short prompts stops queueing behind long ones. Power of two; 0 = off
    # (single-shot admission). LOCALAI_PREFILL_CHUNK env var overrides.
    prefill_chunk: int = 0
    # Million-token context serving (docs/LONG_CONTEXT.md).
    # Windowed+sink attention: decode (and the paged chunked-prefill
    # prefix walk) attends only the first attention_sink positions plus
    # the trailing attention_window — linear-cost long context. 0 = full
    # attention. LOCALAI_ATTENTION_SINK / LOCALAI_ATTENTION_WINDOW env
    # vars override.
    attention_sink: int = 0
    attention_window: int = 0
    # Host-RAM budget for spilled COLD pages (pages behind every live
    # query's window; restored byte-exactly when needed hot again).
    # 0 disables spill. LOCALAI_KV_SPILL_BYTES env var overrides.
    kv_spill_bytes: int = 0
    # Hierarchical page tables: page ids per L0 table page (0 = flat
    # table). Keeps a 1M-token slot's table out of the kernel's scalar-
    # prefetch/SMEM budget and shares directories CoW across slots.
    # LOCALAI_KV_L1_SPAN env var overrides.
    kv_l1_span: int = 0
    # Sequence-parallel chunked prefill toggle (sp > 1 + paged pool):
    # ring-shard each prefill chunk's attention over "sp".
    # LOCALAI_SP_PREFILL env var overrides ("0" disables).
    sp_prefill: bool = True
    # Tree-batched parallel sampling (docs/TREE_SAMPLING.md):
    # n>1 / best_of groups admit ONE shared prefill and fork the slot
    # CoW per branch on paged engines. Off → every branch is an
    # independent clone admission. LOCALAI_FORK_SAMPLING env var
    # overrides ("0" disables).
    fork_sampling: bool = True

    # Bounded admission + deadlines (docs/ROBUSTNESS.md). A full
    # pending queue rejects at submit (HTTP 429 + Retry-After); requests
    # queued past queue_timeout_s are shed with an error; deadline_s is the
    # default end-to-end deadline for requests that don't carry their own.
    # 0 disables each. LOCALAI_MAX_PENDING / LOCALAI_QUEUE_TIMEOUT /
    # LOCALAI_DEADLINE env vars override.
    max_pending: int = 0
    queue_timeout_s: float = 0.0
    deadline_s: float = 0.0

    # Request-lifecycle event journal capacity
    # (docs/OBSERVABILITY.md): ring-buffer size of the engine flight
    # recorder behind /debug/timeline and the loop-death postmortem.
    # 0 disables. LOCALAI_TRACE_JOURNAL env var overrides.
    trace_journal_events: int = 4096

    # Speculative decoding (reference: draft_model/n_draft,
    # core/config/model_config.go:211-212; docs/SPECULATIVE.md).
    draft_model: str = ""  # arch preset or checkpoint dir; empty = off
    n_draft: int = 5
    # Draft source: off | draft_model | prompt_lookup | self_draft | auto
    # (auto = draft_model when draft_model is set, else off). The model-
    # free modes (prompt_lookup / self_draft) need no draft checkpoint —
    # when one of them is selected the manager skips loading draft_model
    # entirely (zero extra HBM). LOCALAI_SPEC_MODE env var overrides.
    spec_mode: str = "auto"
    # spec_mode=self_draft: how many leading target layers draft (0 = auto,
    # num_layers // 4). LOCALAI_SELF_DRAFT_LAYERS env var overrides.
    self_draft_layers: int = 0
    # Per-slot acceptance EWMA coefficient driving acceptance-aware draft
    # lengths (docs/SPECULATIVE.md § scheduler).
    # LOCALAI_SPEC_ACCEPT_EWMA env var overrides.
    spec_accept_ewma: float = 0.4
    # Draft-length buckets the verify programs compile for ([] = auto:
    # {0, n_draft/2, n_draft}). LOCALAI_SPEC_DRAFT_BUCKETS env var
    # overrides (comma-separated).
    spec_draft_buckets: list = dataclasses.field(default_factory=list)

    # LoRA adapters merged into the base weights at load (reference:
    # backend.proto LoraAdapter/LoraScale; grpc-server.cpp params_parse).
    # Entries: "path" or {"path": ..., "weight": 1.0}; paths resolve like
    # `model` (absolute or under models_dir).
    lora_adapters: list = dataclasses.field(default_factory=list)

    # Multi-tenant runtime LoRA (docs/LORA_SERVING.md). A config
    # naming `base_model` + `adapter` is a VIRTUAL MODEL: it resolves to
    # the base's ONE shared engine with the adapter registered as a tenant
    # — the OpenAI `model` field then selects the tenant, and N virtual
    # models cost one set of base weights instead of N engines. The
    # adapter path resolves like `model`; the delta is applied UNMERGED
    # in the decode/prefill programs (composes with a quantized base).
    # Mutually exclusive with `lora_adapters` on the same config, and the
    # BASE must not itself merge lora_adapters (LoraConfigError).
    base_model: str = ""
    adapter: str = ""
    adapter_weight: float = 1.0
    # Ragged per-slot LoRA delta kernel: auto | pallas | xla
    # (docs/LORA_SERVING.md; LOCALAI_LORA_KERNEL env var overrides).
    lora_kernel: str = "auto"
    # Host-RAM byte budget for the adapter factor-image tier (LRU; lets
    # registered adapters far exceed device residency).
    # LOCALAI_ADAPTER_CACHE_BYTES env var overrides.
    adapter_cache_bytes: int = 64 << 20

    # Weight-only quantization at load ("int8"; reference analogue:
    # quantized GGUF serving). Halves weight HBM traffic + footprint.
    quantization: str = ""

    # RoPE overrides (reference: core/config/model_config.go:231-237
    # rope_scaling / rope_freq_base forwarded to engines). Keys mirror HF
    # rope_scaling: rope_type (linear|llama3|yarn|longrope), factor,
    # original_max_position_embeddings, low/high_freq_factor,
    # beta_fast/beta_slow, long_factor/short_factor, attention_factor.
    rope_scaling: Optional[dict] = None
    rope_freq_base: float = 0.0  # overrides rope_theta when > 0

    # Output post-processing (reference Finetune, core/backend/llm.go:217-265).
    echo: bool = False
    cutstrings: list = dataclasses.field(default_factory=list)
    extract_regex: list = dataclasses.field(default_factory=list)
    trim_space: list = dataclasses.field(default_factory=list)
    trim_suffix: list = dataclasses.field(default_factory=list)

    # Capabilities.
    embeddings: bool = False
    template: TemplateConfig = dataclasses.field(default_factory=TemplateConfig)
    system_prompt: str = ""

    # Free-form extras (kept for forward-compat, like the reference's
    # yaml passthrough options).
    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    known_usecases: Optional[Usecase] = None  # explicit override

    def validate(self) -> None:
        """Reject path traversal and malformed names (model_config.go:480-508)
        plus contradictory LoRA serving setups."""
        if not self.name or not _NAME_RE.match(self.name):
            raise ValueError(f"invalid model name {self.name!r}")
        for field in ("model", "tokenizer", "adapter", "base_model"):
            v = getattr(self, field)
            if ".." in v.split(os.sep):
                raise ValueError(f"path traversal in {field}: {v!r}")
        if self.base_model or self.adapter:
            if not (self.base_model and self.adapter):
                raise LoraConfigError(
                    f"model {self.name!r}: a virtual model needs BOTH "
                    "`base_model` and `adapter` (docs/LORA_SERVING.md)"
                )
            if self.lora_adapters:
                raise LoraConfigError(
                    f"model {self.name!r}: `lora_adapters` (merge-at-load) "
                    "and a runtime `adapter` on the same config would apply "
                    "a delta twice — pick ONE path (docs/LORA_SERVING.md)"
                )

    def usecases(self) -> Usecase:
        """Endpoint routing (reference GuessUsecases, model_config.go:593-679)."""
        if self.known_usecases is not None:
            return self.known_usecases
        b = self.backend
        if b == "whisper" or "whisper" in self.model:
            return Usecase.TRANSCRIPT
        if b == "tts" or b in ("piper", "bark"):
            return Usecase.TTS | Usecase.SOUND_GENERATION
        if b in ("musicgen", "soundgen", "sound-generation"):
            return Usecase.SOUND_GENERATION
        if b == "vad" or "silero" in self.model:
            return Usecase.VAD
        if b == "diffusion" or b in ("diffusers", "stablediffusion"):
            return Usecase.IMAGE | Usecase.VIDEO
        if b == "bert":
            uc = Usecase.EMBEDDINGS | Usecase.TOKENIZE
            if "rerank" in self.model.lower() or "rerank" in self.name.lower():
                uc |= Usecase.RERANK
            return uc
        if b == "rerank" or "rerank" in self.name.lower():
            return Usecase.RERANK
        if b == "detection":
            return Usecase.DETECTION
        uc = Usecase.CHAT | Usecase.COMPLETION | Usecase.EDIT | Usecase.TOKENIZE
        if self.embeddings or "bert" in self.backend or "embed" in self.name.lower():
            uc |= Usecase.EMBEDDINGS
        return uc

    def has_usecase(self, uc: Usecase) -> bool:
        return bool(self.usecases() & uc)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "ModelConfig":
        data = dict(data)
        tmpl = data.pop("template", None) or {}
        par = data.pop("parallel", None) or {}
        known = data.pop("known_usecases", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        extra = {k: v for k, v in data.items() if k not in fields}
        kept = {k: v for k, v in data.items() if k in fields and k != "options"}
        cfg = cls(**kept)
        cfg.template = TemplateConfig(**tmpl) if isinstance(tmpl, dict) else TemplateConfig()
        cfg.parallel = ParallelConfig(**par) if isinstance(par, dict) else ParallelConfig()
        cfg.options = {**extra, **(data.get("options") or {})}
        if known:
            uc = Usecase(0)
            for item in known:
                uc |= Usecase[item.upper()]
            cfg.known_usecases = uc
        return cfg

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.known_usecases is not None:
            d["known_usecases"] = [u.name.lower() for u in Usecase if self.known_usecases & u]
        else:
            d.pop("known_usecases")
        return d


class ModelConfigLoader:
    """Loads and watches per-model YAML configs from a directory.

    Reference: core/config/model_config_loader.go (LoadModelConfigsFromPath);
    one YAML file per model, or a multi-doc `models.yaml`.
    """

    def __init__(self, models_dir: str):
        self.models_dir = models_dir
        self._configs: dict[str, ModelConfig] = {}

    def load_all(self) -> dict[str, ModelConfig]:
        self._configs = {}
        if not os.path.isdir(self.models_dir):
            return self._configs
        for fname in sorted(os.listdir(self.models_dir)):
            if not fname.endswith((".yaml", ".yml")):
                continue
            path = os.path.join(self.models_dir, fname)
            try:
                with open(path) as f:
                    docs = list(yaml.safe_load_all(f))
            except yaml.YAMLError as e:
                raise ValueError(f"invalid YAML in {path}: {e}") from e
            for doc in docs:
                if not isinstance(doc, dict):
                    continue
                entries = doc.get("models") if "models" in doc else [doc]
                if not isinstance(entries, list):
                    entries = [entries]
                for entry in entries:
                    cfg = ModelConfig.from_dict(entry)
                    if not cfg.name:
                        cfg.name = os.path.splitext(fname)[0]
                    cfg.validate()
                    self._configs[cfg.name] = cfg
        return self._configs

    def register(self, cfg: ModelConfig) -> None:
        cfg.validate()
        self._configs[cfg.name] = cfg

    def get(self, name: str) -> Optional[ModelConfig]:
        return self._configs.get(name)

    def names(self) -> list[str]:
        return sorted(self._configs)

    def first_with(self, uc: Usecase) -> Optional[ModelConfig]:
        """Default-model pick for an endpoint (reference:
        BuildFilteredFirstAvailableDefaultModel, middleware/request.go:92)."""
        for name in self.names():
            if self._configs[name].has_usecase(uc):
                return self._configs[name]
        return None

    def write(self, cfg: ModelConfig) -> str:
        """Persist a model config as YAML (model import API)."""
        cfg.validate()
        os.makedirs(self.models_dir, exist_ok=True)
        path = os.path.join(self.models_dir, f"{cfg.name.replace('/', '_')}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
        self._configs[cfg.name] = cfg
        return path

    def delete(self, name: str) -> bool:
        cfg = self._configs.pop(name, None)
        if cfg is None:
            return False
        path = os.path.join(self.models_dir, f"{name.replace('/', '_')}.yaml")
        if os.path.exists(path):
            os.remove(path)
        return True
