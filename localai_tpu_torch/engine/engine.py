"""Continuous-batching serving engine over a dense KV cache or a paged KV
pool (PyTorch port of localai_tpu/engine/engine.py).

One resident engine owns the device. Requests are multiplexed onto a fixed
number of KV-cache slots by one loop thread ("engine-loop"):

- Admission is fused and batched: one call prefills a group of prompts of
  the same power-of-two bucket, writes their KV into their slots, sets
  each slot's penalty counts and bias row, and samples each first token.
- Decode runs in N-step blocks: the sampled tokens stay on the device
  from step to step, the block's KV rows ride a block-local window that is
  written to the cache once at the end, and the block's tokens come back
  to the host in ONE device-to-host copy. The block body reads and writes
  only persistent device buffers; on the card it runs as one CUDA graph
  per shape (sampler variant, block size, dense read window or paged,
  LoRA stacks), captured at the shape's first block or by `warmup()` and
  replayed from then on (the reference's jitted block cache). On the CPU
  the body runs eagerly.
- Each block picks the cheapest sampler its active slots allow: greedy,
  simple (unfiltered categorical) or filtered (top-k / top-p / min-p).
- With `kv_pages > 0` the cache is one shared page pool: device memory
  scales with live context, not slots × max_seq. Admission reserves the
  prompt's pages plus `kv_page_headroom`; each decode block first grows
  every active slot's page table on the host, and when the pool cannot
  cover the growth the youngest slot is preempted by recompute (its pages
  freed, prompt + generated requeued at the head under the same handle,
  its sampler state kept). Decode attention walks each slot's own pages
  (the ragged paged-attention kernel on the card).
- With `prefill_chunk > 0` (paged pool only) prompts longer than a chunk
  admit chunk by chunk: at most one chunk runs between decode blocks, each
  writes its K/V straight into the slot's pages, the slot's table is kept
  off the decode blocks (SCRATCH) until the final chunk, and the final
  chunk samples the first token and installs the slot.
- Long context: with `attention_window > 0` decode (and, on a paged pool,
  the chunked-prefill prefix walk) attends only the first
  `attention_sink` positions and the trailing window, so each chunk and
  each decode step costs the same at any context length. `kv_l1_span > 0`
  replaces each slot's flat page-table row with a directory of
  refcounted table pages (ops/ptable's hierarchical pair), and
  `kv_spill_bytes > 0` copies pages that fell behind every query's window
  to pinned host memory and returns their device pages to the pool.
- Weights may be quantized (`Engine(..., quantization="int8"|"int4")`
  quantizes plain params where they lie; a tree already quantized, e.g. by
  `load_hf_checkpoint(quantize=)`, is served as it is): decode-shape
  matmuls run the fused dequant kernels. The KV cache may be stored in fp8
  (`kv_cache_dtype`), and a paged fp8 pool may carry a per-head scale
  (`kv_scale`) so large K / V stay inside the format's range.
- Multi-tenant runtime LoRA: `register_adapter(name, peft_dir)` makes a
  tenant, and `GenRequest(adapter=name)` serves it. A tenant's factors are
  read through a host LRU (`adapter_cache_bytes`) and promoted into the
  stacked device factors at its first admission; once those exist, every
  admission and decode block adds each row's own delta beside each base
  product (the ragged LoRA kernel on the card for decode rows, id 0 = the
  null adapter for adapter-less rows). Adapter requests admit alone and
  single-shot; a pinned device row is never evicted.
- Streaming is UTF-8-safe incremental detokenization with stop-sequence
  hold-back; every generated token posts exactly one event, and every
  request ends with exactly one terminal event (done or error) on every
  exit path: finish, cancel, stop(), a failed dispatch, loop death.

Sampling noise is a pure function of the slot's seed (the request's, or
one drawn from the OS when it has none), kept on the device, and of the
position of the token being drawn (ops/sampling.gumbel_noise). A seeded
request therefore gives the same bytes whatever else shares the batch,
whatever the block size, chunking or preemption, and a block holds no
generator state, so it can be captured. The reference's threefry streams
are not reproduced.

Not ported yet (ROADMAP Queue A): CUDA graphs of admission and prefill
chunks and pipelined dispatch, the prefix cache (and with it table-page
sharing and the restore of spilled pages), the host swap tier (preemption
always recomputes), chunked prefill over a dense cache, grammar, logprobs,
speculative decoding, fork / n>1, tp and sequence-parallel prefill,
deadlines.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Iterator, Optional

import numpy as np
import torch

from localai_tpu_torch import kernels
from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.engine.weights import load_lora_factors, lora_target_dims
from localai_tpu_torch.models import llama
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.quant import is_prequantized, quantize_params
from localai_tpu_torch.ops import ptable as _pt
from localai_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplingParams,
    sample,
    sample_greedy,
    sample_simple,
    update_counts,
)

log = logging.getLogger("localai_tpu_torch.engine")


class AdapterError(RuntimeError):
    """A multi-tenant LoRA adapter operation failed: an unknown adapter
    name, a name rebound to another source, a mixture-of-experts base, or
    every device adapter row pinned by an active request."""


class QueueFullError(RuntimeError):
    """submit() rejected a request because the pending queue is at
    EngineConfig.max_pending. Carries a Retry-After hint derived from the
    engine's observed admission latency."""

    def __init__(self, depth: int, limit: int, retry_after_s: float) -> None:
        super().__init__(
            f"engine queue full ({depth} pending, max_pending={limit}) — "
            f"retry in ~{retry_after_s:.0f}s"
        )
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s


_SAMPLING_FIELDS = (
    "temperature",
    "top_k",
    "top_p",
    "min_p",
    "repeat_penalty",
    "presence_penalty",
    "frequency_penalty",
)


def _sampling_params(rows: torch.Tensor) -> SamplingParams:
    """SamplingParams from a [7, B] f32 tensor in _SAMPLING_FIELDS order."""
    return SamplingParams(
        temperature=rows[0], top_k=rows[1].to(torch.int32), top_p=rows[2],
        min_p=rows[3], repeat_penalty=rows[4], presence_penalty=rows[5],
        frequency_penalty=rows[6],
    )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_seq: int = 2048
    min_prefill_bucket: int = 32
    # Seeds of the idle slots' sampling noise (a slot takes its request's
    # seed at admission).
    base_seed: int = 0
    # Decode-block sizes the scheduler chooses from: bigger blocks amortize
    # the per-block host work, smaller ones bound end-of-request overshoot.
    block_sizes: tuple[int, ...] = (64, 16, 4, 1)
    # Pending-queue bound; submit() past it raises QueueFullError. 0 = no bound.
    max_pending: int = 0
    # Paged KV pool: kv_pages > 0 replaces the dense [slots, max_seq] cache
    # with a shared pool of kv_pages pages of kv_page_size rows (plus one
    # SCRATCH page). max_seq must divide by kv_page_size. 0 = dense cache.
    kv_pages: int = 0
    kv_page_size: int = 128
    # Pages reserved at admission beyond the prompt bucket, so the first
    # decode blocks do not stall on growth.
    kv_page_headroom: int = 1
    # Chunked prefill (paged pool only): prompts longer than this many
    # tokens admit in chunks interleaved with decode blocks. A power of two
    # >= min_prefill_bucket; 0 = single-shot admission.
    prefill_chunk: int = 0
    # KV-cache storage dtype: "" = the model's; "fp8" / "fp8_e4m3" (e4m3fn)
    # or "fp8_e5m2" halve the KV bytes of a bf16 cache.
    kv_cache_dtype: str = ""
    # Per-head KV scale of a paged fp8 pool: rows are stored as value /
    # kv_scale and multiplied back by every reader, so K / V larger than
    # e4m3's ±448 keep their values. 1.0 = unscaled storage. Needs
    # kv_pages > 0 and an fp8 kv_cache_dtype.
    kv_scale: float = 1.0
    # Host-RAM byte budget of the adapter tier: fetched adapter factor
    # images stay in an LRU under it, so registered adapters can far exceed
    # the device-resident ones (a miss re-reads the adapter from disk).
    adapter_cache_bytes: int = 64 << 20
    # Sink + window attention: with attention_window > 0, decode (and, on a
    # paged pool, the chunked-prefill prefix walk) attends only rows at
    # positions < attention_sink plus rows within attention_window of the
    # query (StreamingLLM-style, absolute rope positions). On a paged pool
    # it needs chunked prefill with prefill_chunk <= attention_window, so
    # every long admission takes the one masked path; models with a
    # sliding window of their own are refused. 0 = full attention.
    attention_sink: int = 0
    attention_window: int = 0
    # Host-RAM byte budget of spilled cold pages: with the window on, pages
    # wholly behind every live query's window (and past the sink) are copied
    # to pinned host memory and their device pages return to the pool. The
    # images are dropped when the slot ends. 0 = no spill.
    kv_spill_bytes: int = 0
    # Hierarchical page tables (paged pool only): N >= 2 page ids per table
    # page; each slot's table is a directory of ceil(max_pages / N) table
    # pages instead of one max_pages row. 0 = flat tables.
    kv_l1_span: int = 0

    def cache_dtype(self, model_dtype: torch.dtype) -> torch.dtype:
        table = {
            "": None,
            "fp8": torch.float8_e4m3fn,
            "fp8_e4m3": torch.float8_e4m3fn,
            "fp8_e5m2": torch.float8_e5m2,
        }
        if self.kv_cache_dtype not in table:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not supported — "
                             "use 'fp8' (e4m3) or 'fp8_e5m2'")
        dt = table[self.kv_cache_dtype]
        return model_dtype if dt is None else dt

    def buckets(self) -> list[int]:
        out, b = [], self.min_prefill_bucket
        while b < self.max_seq:
            out.append(b)
            b *= 2
        out.append(self.max_seq)
        return out


@dataclasses.dataclass
class GenRequest:
    prompt_ids: list[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    stop: list[str] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None
    ignore_eos: bool = False
    logit_bias: dict[int, float] = dataclasses.field(default_factory=dict)
    # Name of a registered runtime LoRA adapter (Engine.register_adapter)
    # applied unmerged to this request; None = the base model.
    adapter: Optional[str] = None
    # Set by the engine on a request it requeued after preempting it: what
    # the re-admitted slot restores (generated tokens, streamed text, the
    # sampling seed). Callers leave it None.
    resume: Optional[dict] = None


@dataclasses.dataclass
class TokenEvent:
    kind: str  # "token" | "done" | "error"
    text: str = ""
    token_id: int = -1
    finish_reason: Optional[str] = None  # "stop" | "length"
    error: Optional[str] = None
    # Filled on "done".
    prompt_tokens: int = 0
    completion_tokens: int = 0
    timing_prompt_processing: float = 0.0  # seconds, admission → first token
    timing_token_generation: float = 0.0
    timing_queue_wait: float = 0.0  # seconds, submit → admission


class RequestHandle:
    """Streaming consumer side of a submitted request."""

    def __init__(self) -> None:
        self._q: "queue.Queue[TokenEvent]" = queue.Queue()
        self.cancelled = threading.Event()
        self.t_submit: float = 0.0
        self.t_admit: float = 0.0

    def __iter__(self) -> Iterator[TokenEvent]:
        while True:
            ev = self._q.get()
            yield ev
            if ev.kind in ("done", "error"):
                return

    def cancel(self) -> None:
        self.cancelled.set()

    def result(self) -> tuple[str, TokenEvent]:
        """Drain the stream; returns (full text, final event)."""
        parts: list[str] = []
        final = TokenEvent(kind="error", error="empty stream")
        for ev in self:
            if ev.kind == "token":
                parts.append(ev.text)
            final = ev
        if final.kind == "error":
            raise RuntimeError(final.error)
        return "".join(parts), final


@dataclasses.dataclass
class _Slot:
    request: GenRequest
    handle: RequestHandle
    prompt_len: int
    generated: list[int] = dataclasses.field(default_factory=list)
    emitted_len: int = 0  # chars of decoded text already streamed
    scheduled: int = 0  # tokens dispatched (admission token + decode steps)
    sched_rows: int = 0  # cache rows written or dispatched (prompt + decode steps)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0


class Engine:
    """Persistent multi-slot generation engine for one loaded model."""

    _KV_WIN_MIN = 256  # smallest read-side KV window (doubles up to max_seq)

    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        tokenizer,
        engine_cfg: Optional[EngineConfig] = None,
        device=None,
        quantization: str = "",
    ) -> None:
        llama.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        if ecfg.max_slots < 1 or ecfg.max_seq < 2 or ecfg.min_prefill_bucket < 1:
            raise ValueError("max_slots >= 1, max_seq >= 2 and min_prefill_bucket >= 1 required")
        if not ecfg.block_sizes or min(ecfg.block_sizes) < 1:
            raise ValueError("block_sizes must be positive")
        if ecfg.max_pending < 0:
            raise ValueError("max_pending must be >= 0 (0 = unbounded)")
        if ecfg.adapter_cache_bytes < 0:
            raise ValueError("adapter_cache_bytes must be >= 0")
        self._check_paged_config(ecfg)
        self._check_long_context(cfg, ecfg)
        if (cfg.attention_sink, cfg.attention_window) != (ecfg.attention_sink,
                                                          ecfg.attention_window):
            # The model functions read the knobs from the (frozen) ArchConfig.
            cfg = dataclasses.replace(cfg, attention_sink=ecfg.attention_sink,
                                      attention_window=ecfg.attention_window)
            self.cfg = cfg
        if ecfg.kv_scale <= 0:
            raise ValueError("kv_scale must be > 0")
        if ecfg.kv_scale != 1.0 and not (ecfg.kv_pages > 0 and ecfg.kv_cache_dtype):
            raise ValueError(
                "kv_scale != 1.0 requires a paged pool (kv_pages > 0) with an fp8 "
                "kv_cache_dtype — the dense cache has no scaled path")
        model_dtype = llama.torch_dtype(cfg.dtype)
        cache_dtype = ecfg.cache_dtype(model_dtype)
        pdev = params["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine device is {self.device}")
        if quantization and not is_prequantized(params):
            params = quantize_params(cfg, params, quantization)
        self.params = params
        B, S, V = ecfg.max_slots, ecfg.max_seq, cfg.vocab_size
        dev = self.device
        # Device state, one row per slot; the cache is dense [L, B, S, K, Hd]
        # or the page pool [L, kv_pages + 1, page, K, Hd].
        self._paged = ecfg.kv_pages > 0
        if self._paged:
            self.cache = llama.paged_cache_zeros(cfg, ecfg.kv_pages + 1, ecfg.kv_page_size,
                                                 dtype=cache_dtype, device=dev)
        else:
            self.cache = llama.KVCache.zeros(cfg, B, S, dtype=cache_dtype, device=dev)
        # Per-head (k, v) scales [2, K] of a scaled fp8 pool; None = unscaled
        # storage. The block-local window of a scaled pool stays in the
        # model dtype: rows are scaled and cast once, at the pool write.
        self._kv_scales = None
        self._local_dtype = cache_dtype
        if ecfg.kv_scale != 1.0:
            self._kv_scales = torch.full((2, cfg.num_kv_heads), float(ecfg.kv_scale),
                                         dtype=torch.float32, device=dev)
            self._local_dtype = model_dtype
        self.counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.bias = torch.zeros((B, V), dtype=torch.float32, device=dev)
        self.d_tokens = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.d_positions = torch.zeros((B,), dtype=torch.int64, device=dev)
        # Each slot's sampling seed (a draw's noise is a pure function of
        # the seed and the drawn token's position) and its host mirror.
        self.d_seed = torch.arange(B, dtype=torch.int64, device=dev) + ecfg.base_seed
        self.h_seed = np.arange(B, dtype=np.int64) + ecfg.base_seed
        # Host state (loop thread only).
        self.slots: list[Optional[_Slot]] = [None] * B
        self.h_active = np.zeros((B,), bool)
        self.h_sampling = {k: np.zeros((B,), np.float32) for k in _SAMPLING_FIELDS}
        self.h_sampling["top_p"][:] = 1.0
        self.h_sampling["repeat_penalty"][:] = 1.0
        # Paged pool accounting (loop thread only). h_ptable [B, MP] mirrors
        # each slot's pages and goes to the device with every dispatch;
        # unused entries point at SCRATCH (the pool's last page, which no
        # slot attends), so idle slots and overshoot rows land harmlessly.
        self._max_pages = S // ecfg.kv_page_size if self._paged else 0
        self._scratch_page = ecfg.kv_pages
        self.h_ptable = np.full((B, max(self._max_pages, 1)), self._scratch_page, np.int32)
        self._free_pages: list[int] = list(range(ecfg.kv_pages))
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._page_refs = np.zeros((max(ecfg.kv_pages, 1),), np.int32)
        # Hierarchical page tables (kv_l1_span > 0): h_l1 [B, ML1] holds each
        # slot's directory of TABLE-PAGE ids, h_l0 [NTP + 1, SPAN] the global
        # table-page pool (row 0 = the all-SCRATCH table page every idle
        # directory entry points at). Table pages are refcounted and copied
        # before a write through a shared one (_ptable_set), as the
        # reference does for the prefix cache's shared spans. NTP covers
        # every slot's full directory twice over, so claims do not fail.
        self._l1_span = ecfg.kv_l1_span if self._paged else 0
        self._hier = self._l1_span > 0
        self._ml1 = -(-max(self._max_pages, 1) // self._l1_span) if self._hier else 0
        ntp = (B + 2) * self._ml1
        self._scratch_tp = 0
        self.h_l0 = np.full((ntp + 1, max(self._l1_span, 1)), self._scratch_page, np.int32)
        self.h_l1 = np.full((B, max(self._ml1, 1)), self._scratch_tp, np.int32)
        self._tp_free: list[int] = list(range(1, ntp + 1))
        self._tp_refs = np.zeros((ntp + 1,), np.int32)
        self._slot_tps: list[list[int]] = [[] for _ in range(B)]
        # Cold-page spill: per slot {page column: (k, v) host images [L, 1,
        # page, K, Hd]} of spilled cold pages; the slot's _slot_pages entry
        # holds the SPILLED (-1) sentinel and its table entry SCRATCH.
        # _spill_bytes counts the images against kv_spill_bytes; each slot's
        # scan resumes at its cursor (query positions only grow).
        self._slot_spill: list[dict] = [{} for _ in range(B)]
        self._spill_cursor = np.zeros((B,), np.int64)
        self._spill_bytes = 0
        self._spill_on = self._paged and ecfg.attention_window > 0 and ecfg.kv_spill_bytes > 0
        self.m_kv_pages_spilled = 0
        self.m_kv_spill_bytes_out = 0
        self.m_kv_spill_skips = 0
        # A decode block could not grow some slot: admissions pause until
        # growth succeeds (the youngest slot is preempted meanwhile).
        self._growth_blocked = False
        # In-progress chunked admissions, oldest first: each holds a
        # reserved, inactive slot and its page row, withheld from h_ptable.
        self._chunkings: list[dict] = []
        # Multi-tenant LoRA. _adapter_registry (name -> {dir, weight}) is the
        # only adapter state touched off the loop thread (register_adapter,
        # submit), under _adapter_lock. The rest is loop-thread only: the
        # host factor-image LRU (_adapter_host, bounded by
        # adapter_cache_bytes), the device row table (_adapter_rows /
        # _adapter_refs / _adapter_last), the stacked factors (_lora_tree:
        # {key: {"a": [L, NA, in, R], "b": [L, NA, R, out]}}, row 0 = the
        # all-zero null adapter) and each slot's row (h_adapter). A row's
        # refcount changes only in _adapter_acquire / _adapter_unpin.
        self._adapter_lock = threading.Lock()
        self._adapter_registry: dict[str, dict] = {}
        self._adapter_host: OrderedDict[str, dict] = OrderedDict()
        self._adapter_host_bytes = 0
        self._adapter_rows: list[Optional[str]] = []
        self._adapter_refs = np.zeros((0,), np.int32)
        self._adapter_last: list[float] = []
        self._lora_tree: Optional[dict] = None
        self._lora_keys: tuple = ()
        self._lora_rank = 0
        self.h_adapter = np.zeros((B,), np.int32)
        # The decode block's operands and result live in fixed device
        # buffers, so a captured graph of the block body replays on them:
        # the control pack [8, B] (the active row, then _SAMPLING_FIELDS),
        # the page table [B, MP] (hierarchical: the directories [B, ML1] and
        # the table-page pool [NTP + 1, SPAN]), the adapter rows [B] and the
        # sampled ids [n, B]. Each block copies its host rows in from pinned
        # staging tensors (loop thread only).
        pin = dev.type == "cuda"
        MP = self.h_ptable.shape[1]
        self._h_pack = torch.zeros((1 + len(_SAMPLING_FIELDS), B), dtype=torch.float32,
                                   pin_memory=pin)
        self._h_ptable = torch.zeros((B, MP), dtype=torch.int32, pin_memory=pin)
        self._h_adapter = torch.zeros((B,), dtype=torch.int32, pin_memory=pin)
        self._b_pack = torch.zeros(self._h_pack.shape, dtype=torch.float32, device=dev)
        self._b_ptable = torch.full((B, MP), self._scratch_page, dtype=torch.int32, device=dev)
        self._h_l1 = torch.zeros(self.h_l1.shape, dtype=torch.int32, pin_memory=pin)
        self._b_l1 = torch.zeros(self.h_l1.shape, dtype=torch.int32, device=dev)
        self._h_l0 = self._b_l0 = None
        self._b_adapter = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._b_out = torch.zeros((max(ecfg.block_sizes), B), dtype=torch.int64, device=dev)
        # CUDA graphs of the block body (_block_key -> (graph, launch counts
        # of one replay, the kernel workspaces it captured)), all in one
        # memory pool while any of them lives: blocks replay one at a time
        # on one stream.
        self._graph_cache: dict[tuple, tuple] = {}
        self._graph_pool = None
        self._graph_stream = None
        if self._hier:
            self._l0_buffers()
        self.m_graph_captures = 0
        self.m_graph_replays = 0
        self.m_graph_capture_s = 0.0
        self.m_adapter_fetches = 0
        self.m_adapter_promotes = 0
        self.m_adapter_evictions = 0
        # Cross-thread state.
        self._pending: deque[tuple[GenRequest, RequestHandle]] = deque()
        self._pending_lock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop_dead: Optional[str] = None
        self._admit_wait_ewma = 0.0
        # Counters.
        self.m_prompt_tokens = 0
        self.m_generated_tokens = 0
        self.m_queue_shed = 0
        self.m_admissions = 0  # single-shot admission dispatches
        self.m_blocks = 0
        self.m_decode_steps = 0
        self.m_prefill_chunks = 0
        self.m_chunks_interleaved = 0  # chunks dispatched while slots decode
        self.m_chunked_admits = 0
        self.m_kv_pages_peak = 0
        self.m_kv_pages_grown = 0
        self.m_kv_preemptions = 0
        self._decode_tokens = 0
        self._decode_time = 0.0

    @staticmethod
    def _check_long_context(cfg: ArchConfig, ecfg: EngineConfig) -> None:
        """The JAX package's validation of the long-context knobs."""
        sink, win = ecfg.attention_sink, ecfg.attention_window
        if sink < 0 or win < 0:
            raise ValueError("attention_sink / attention_window must be >= 0")
        if sink and not win:
            raise ValueError("attention_sink without attention_window is full attention "
                             "— set attention_window > 0 (or drop the sink)")
        if win:
            if cfg.sliding_window:
                raise ValueError(f"attention_window composes with full-attention models "
                                 f"only — {cfg.name} already has an architectural "
                                 f"sliding window")
            if cfg.mrope_section:
                raise ValueError("attention_window excludes m-rope (VLM) models this "
                                 "round — text decoders only")
            if ecfg.kv_pages > 0:
                C0 = ecfg.prefill_chunk
                if not C0:
                    raise ValueError("attention_window on a paged pool requires chunked "
                                     "prefill (prefill_chunk > 0) — long admissions must "
                                     "run the one masked prefix-walk path")
                if C0 > win:
                    raise ValueError(f"prefill_chunk={C0} must be <= attention_window="
                                     f"{win} (the in-chunk causal part must sit inside "
                                     "the window for the mask to stay exact)")
        if ecfg.kv_spill_bytes < 0:
            raise ValueError("kv_spill_bytes must be >= 0")
        if ecfg.kv_l1_span:
            if ecfg.kv_l1_span < 2:
                raise ValueError("kv_l1_span must be >= 2 (0 = flat table)")
            if ecfg.kv_pages <= 0:
                raise ValueError("kv_l1_span (hierarchical page tables) requires a paged "
                                 "pool (kv_pages > 0)")

    @staticmethod
    def _check_paged_config(ecfg: EngineConfig) -> None:
        """The JAX package's validation of the paged-pool and chunking knobs."""
        if ecfg.kv_pages < 0:
            raise ValueError("kv_pages must be >= 0 (0 = dense cache)")
        if ecfg.kv_page_headroom < 0:
            raise ValueError("kv_page_headroom must be >= 0")
        C = ecfg.prefill_chunk
        if C < 0 or (C and (C < ecfg.min_prefill_bucket or C & (C - 1))):
            raise ValueError(f"prefill_chunk={C} must be a power of two >= "
                             f"min_prefill_bucket={ecfg.min_prefill_bucket}")
        if ecfg.kv_pages > 0:
            if ecfg.kv_page_size < 1 or ecfg.max_seq % ecfg.kv_page_size:
                raise ValueError(f"max_seq={ecfg.max_seq} must divide by "
                                 f"kv_page_size={ecfg.kv_page_size}")
        elif C:
            raise NotImplementedError(
                "prefill_chunk > 0 with a dense cache needs prefill_tail, which is not "
                "ported yet (ROADMAP Queue A item 3, main-path engine completeness); use "
                "kv_pages > 0")

    # ------------------------------------------------------------------ #
    # Public surface
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop_guard, daemon=True, name="engine-loop"
            )
            self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        # No consumer may hang across stop(): every request still holding a
        # slot or waiting in the queue gets a terminal event. A duplicate
        # done on a stream that already finished is harmless.
        for slot in self.slots:
            if slot is not None:
                slot.handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
        with self._pending_lock:
            pending, self._pending = list(self._pending), deque()
        for _req, handle in pending:
            handle._q.put(TokenEvent(kind="done", finish_reason="stop"))

    def submit(self, request: GenRequest) -> RequestHandle:
        if not request.prompt_ids:
            raise ValueError("empty prompt")
        request = dataclasses.replace(request, prompt_ids=list(request.prompt_ids))
        limit = self.ecfg.max_seq - 1
        if len(request.prompt_ids) > limit:
            # Truncate from the left but keep the leading token (BOS).
            head = request.prompt_ids[0]
            request.prompt_ids = [head] + request.prompt_ids[-(limit - 1):]
            log.warning("prompt truncated to %d tokens (max_seq=%d)", limit, self.ecfg.max_seq)
        if self._paged and self._pages_worst(request) > self.ecfg.kv_pages:
            # Admission reserves only prompt + headroom and grows on demand,
            # but a request whose whole context can never fit would preempt
            # everyone and still starve.
            raise ValueError(
                f"request needs up to {self._pages_worst(request)} KV pages, pool has "
                f"{self.ecfg.kv_pages}: lower max_new_tokens or grow kv_pages")
        if request.adapter is not None:
            # Fail fast on tenant identity; the fetch / promote happens at
            # admission on the loop thread (and may still fail there, as an
            # error event: disk, every device row pinned).
            with self._adapter_lock:
                known = request.adapter in self._adapter_registry
            if not known:
                raise AdapterError(f"unknown adapter {request.adapter!r} — "
                                   "register_adapter() first")
        handle = RequestHandle()
        handle.t_submit = time.monotonic()
        # The dead check and the append share _pending_lock with the loop's
        # set-dead-and-drain: a submit either sees the death or is drained.
        with self._pending_lock:
            dead = self._loop_dead
            if dead is None:
                if self.ecfg.max_pending and len(self._pending) >= self.ecfg.max_pending:
                    self.m_queue_shed += 1
                    raise QueueFullError(len(self._pending), self.ecfg.max_pending,
                                         max(1.0, self._admit_wait_ewma))
                self._pending.append((request, handle))
        if dead is not None:
            handle._q.put(TokenEvent(kind="error", error=dead))
            return handle
        self._wake.set()
        self.start()
        return handle

    def generate(self, prompt_ids: list[int], **kw) -> tuple[str, TokenEvent]:
        return self.submit(GenRequest(prompt_ids=list(prompt_ids), **kw)).result()

    @property
    def is_dead(self) -> bool:
        return self._loop_dead is not None

    def metrics(self) -> dict[str, float]:
        tps = self._decode_tokens / self._decode_time if self._decode_time > 0 else 0.0
        out = {
            "prompt_tokens_processed": float(self.m_prompt_tokens),
            "tokens_generated": float(self.m_generated_tokens),
            "tokens_per_second": tps,
            "active_slots": float(int(self.h_active.sum())),
            "queue_depth": float(len(self._pending)),
            "queue_shed": float(self.m_queue_shed),
            "admissions": float(self.m_admissions),
            "decode_blocks": float(self.m_blocks),
            "decode_steps": float(self.m_decode_steps),
            "prefill_chunks": float(self.m_prefill_chunks),
            "prefill_chunks_interleaved": float(self.m_chunks_interleaved),
            "chunked_admits": float(self.m_chunked_admits),
            "kv_pages_free": float(len(self._free_pages)),
            "kv_pages_peak": float(self.m_kv_pages_peak),
            "kv_pages_grown": float(self.m_kv_pages_grown),
            "kv_preemptions": float(self.m_kv_preemptions),
            "kv_pages_spilled": float(self.m_kv_pages_spilled),
            "kv_spill_bytes_out": float(self.m_kv_spill_bytes_out),
            "spilled_pages": float(sum(len(d) for d in list(self._slot_spill))),
            "spill_bytes": float(self._spill_bytes),
            "kv_spill_skips": float(self.m_kv_spill_skips),
            "weight_bytes": float(self._weight_bytes()),
            "decode_graphs": float(len(self._graph_cache)),
            "decode_graph_captures": float(self.m_graph_captures),
            "decode_graph_replays": float(self.m_graph_replays),
            "decode_graph_capture_s": float(self.m_graph_capture_s),
            "admit_wait_ms": float(self._admit_wait_ewma * 1000.0),
            "loop_dead": 1.0 if self._loop_dead is not None else 0.0,
        }
        with self._adapter_lock:
            n_adapters = len(self._adapter_registry)
        if n_adapters or self._lora_tree is not None:
            out["adapters_registered"] = float(n_adapters)
            out["adapter_device_resident"] = float(
                sum(1 for name in list(self._adapter_rows) if name is not None))
            out["adapter_host_bytes"] = float(self._adapter_host_bytes)
            out["adapter_fetches"] = float(self.m_adapter_fetches)
            out["adapter_promotes"] = float(self.m_adapter_promotes)
            out["adapter_evictions"] = float(self.m_adapter_evictions)
        return out

    def _weight_bytes(self) -> int:
        """Bytes of the parameters on the device (payloads and scales)."""
        def size(t) -> int:
            if isinstance(t, dict):
                return sum(size(v) for v in t.values())
            return t.numel() * t.element_size()
        return size(self.params)

    # ------------------------------------------------------------------ #
    # Engine loop
    # ------------------------------------------------------------------ #

    def _bucket_for(self, n: int) -> int:
        for b in self.ecfg.buckets():
            if n <= b:
                return b
        return self.ecfg.max_seq

    def _loop_guard(self) -> None:
        """Run the loop; if it dies, fail every live and pending request
        with an error event instead of leaving its caller blocked."""
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — terminal: report and drain
            log.exception("engine loop died; failing all live requests")
            err = f"engine loop died: {type(e).__name__}: {e}"
            with self._pending_lock:
                self._loop_dead = err
                pending, self._pending = list(self._pending), deque()
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    slot.handle._q.put(TokenEvent(kind="error", error=err))
                    self._release(i)
            for _req, handle in pending:
                handle._q.put(TokenEvent(kind="error", error=err))

    def _loop(self) -> None:
        while not self._shutdown.is_set():
            self._purge_pending()
            self._finish_cancelled()
            if self._growth_blocked and not self.h_active.any():
                # The growth-starved slots are gone: nothing waits on pages.
                self._growth_blocked = False
            progressed = self._admit_pending()
            if self.h_active.any() and self._has_unscheduled():
                progressed = True
                try:
                    if not self._run_block():
                        # The pool cannot cover the block's page growth:
                        # free the youngest slot's pages so the rest go on.
                        self._preempt_youngest()
                except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                    self._fail_block(e)
            # At most one prefill chunk between two decode blocks.
            progressed = self._advance_chunked() or progressed
            self._spill_cold_pages()
            if not progressed:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _fail_block(self, e: Exception) -> None:
        """A failed decode block: one error event per active request, and
        its slot released."""
        log.exception("decode block failed")
        for i, slot in enumerate(self.slots):
            if slot is not None and self.h_active[i]:
                slot.handle._q.put(TokenEvent(kind="error", error=f"{type(e).__name__}: {e}"))
                self._release(i)

    def _purge_pending(self) -> None:
        """Drop cancelled entries from the pending queue, one terminal
        event each (admission only looks at the queue head, and only when a
        slot is free)."""
        if not self._pending:
            return
        with self._pending_lock:
            kept, dropped = deque(), []
            for item in self._pending:
                (dropped if item[1].cancelled.is_set() else kept).append(item)
            self._pending = kept
        for _req, handle in dropped:
            handle._q.put(TokenEvent(kind="done", finish_reason="stop"))

    def _finish_cancelled(self) -> None:
        """Active slots whose caller cancelled end now (nothing is in
        flight between loop iterations); a chunked admission ends at its
        next chunk (_advance_chunked)."""
        for i, slot in enumerate(self.slots):
            if slot is not None and self.h_active[i] and slot.handle.cancelled.is_set():
                self._finish(i, "stop")

    def _note_admitted(self, handle: RequestHandle) -> None:
        handle.t_admit = time.monotonic()
        wait = max(0.0, handle.t_admit - handle.t_submit)
        self._admit_wait_ewma = (wait if self._admit_wait_ewma == 0.0
                                 else 0.8 * self._admit_wait_ewma + 0.2 * wait)

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #

    def _admit_pending(self) -> bool:
        """Admit pending requests into free slots: one fused admission per
        group of same-bucket prompts at the queue head, or the start of one
        chunked admission. On the paged pool a group takes only the pages
        the pool has now (backpressure), and nothing is admitted while a
        live slot waits on page growth."""
        admitted = False
        if self._growth_blocked:
            return admitted
        while True:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return admitted
            group: list[tuple[GenRequest, RequestHandle]] = []
            bucket = 0
            pages_planned = 0
            chunk_item = None
            with self._pending_lock:
                while self._pending and len(group) < len(free):
                    request, handle = self._pending[0]
                    if handle.cancelled.is_set():
                        self._pending.popleft()
                        handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
                        continue
                    if self._chunkable(request):
                        # Long prompts leave the queue before bucketing; a
                        # group already gathered dispatches first.
                        if not group:
                            chunk_item = self._pending.popleft()
                        break
                    if request.adapter is not None and group:
                        break  # adapter requests admit alone: dispatch the group first
                    if self._paged:
                        need = self._pages_needed(request)
                        if pages_planned + need > len(self._free_pages):
                            break  # pool backpressure — wait for a finish
                        pages_planned += need
                    b = self._bucket_for(len(request.prompt_ids))
                    if group and b != bucket:
                        break  # different bucket — next round
                    bucket = b
                    group.append(self._pending.popleft())
                    if request.adapter is not None:
                        # Alone, so a fetch / promote failure fails exactly
                        # one tenant's request.
                        break
            if chunk_item is not None:
                request, handle = chunk_item
                if not self._chunk_start(request, handle):
                    return admitted  # pool backpressure — requeued at the head
                self._note_admitted(handle)
                admitted = True
                continue
            if not group:
                return admitted
            for _req, handle in group:
                self._note_admitted(handle)
            try:
                self._dispatch_admit(group, bucket, free[: len(group)])
            except Exception as e:  # noqa: BLE001 — surface to callers, keep serving
                log.exception("admission failed (m=%d)", len(group))
                for _req, handle in group:
                    handle._q.put(TokenEvent(kind="error", error=f"{type(e).__name__}: {e}"))
            admitted = True

    def _request_controls(self, group):
        """Host-side sampling rows [7, m], logit-bias rows [m, V] and one
        sampling seed per request [m] int64; a preempted request keeps the
        seed it had."""
        m, V = len(group), self.cfg.vocab_size
        samp = np.zeros((len(_SAMPLING_FIELDS), m), np.float32)
        bias_rows = np.zeros((m, V), np.float32)
        seeds = np.zeros((m,), np.int64)
        for j, (r, _h) in enumerate(group):
            for fi, k in enumerate(_SAMPLING_FIELDS):
                samp[fi, j] = getattr(r, k)
            for tid, bval in r.logit_bias.items():
                if 0 <= int(tid) < V:
                    bias_rows[j, int(tid)] = bval
            if r.resume is not None:
                seeds[j] = r.resume["seed"]
            elif r.seed is not None:
                seeds[j] = r.seed & 0x7FFFFFFF
            else:  # unseeded requests draw a random seed (reference default -1)
                seeds[j] = int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF
        return samp, bias_rows, seeds

    def _install_first(self, logits, prompt, lens, samp, bias_rows, seeds, slot_ids):
        """Sample each admitted prompt's first token (its noise keyed by the
        token's position, lens) and install the slots' device state:
        penalty counts (prompt + first token), bias row, the token, its
        position and the seed. prompt [m, S] right-padded to lens [m].
        Returns the first tokens [m] on the device."""
        m, V = prompt.shape[0], self.cfg.vocab_size
        dev = self.device
        valid = (torch.arange(prompt.shape[1], device=dev)[None, :] < lens[:, None]).to(torch.int32)
        rows = torch.zeros((m, V), dtype=torch.int32, device=dev)
        rows.scatter_add_(1, prompt, valid)
        # Logits may cover more ids than the tokenizer decodes (padded
        # embedding rows): mask those out of sampling for good.
        bias_rows = torch.from_numpy(bias_rows).to(dev)
        tok_v = min(getattr(self.tokenizer, "vocab_size", V) or V, V)
        if tok_v < V:
            bias_rows[:, tok_v:] = NEG_INF
        sp = _sampling_params(torch.from_numpy(samp).to(dev))
        d_seeds = torch.from_numpy(seeds).to(dev)
        toks = sample(logits, d_seeds, lens, sp, rows, bias_rows)
        rows[torch.arange(m, device=dev), toks] += 1
        sl = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        self.counts[sl] = rows
        self.bias[sl] = bias_rows
        self.d_tokens[sl] = toks
        self.d_positions[sl] = lens
        self.d_seed[sl] = d_seeds
        return toks

    def _claim_slot(self, s: int, request: GenRequest, handle: RequestHandle,
                    seed: int, t_admit: float) -> None:
        """Host state of a freshly admitted slot (after its admission ran)."""
        for k in _SAMPLING_FIELDS:
            self.h_sampling[k][s] = getattr(request, k)
        self.h_seed[s] = seed
        n = len(request.prompt_ids)
        self.slots[s] = _Slot(request=request, handle=handle, prompt_len=n, scheduled=1,
                              sched_rows=n, t_submit=handle.t_submit, t_admit=t_admit)
        self._apply_resume(s)
        self.h_active[s] = True

    def _post_first(self, s: int, tok: int) -> None:
        slot = self.slots[s]
        if not slot.t_first:  # a resumed request keeps its first-token time
            slot.t_first = time.monotonic()
        self.m_prompt_tokens += slot.prompt_len
        self._post_token(s, tok)

    def _dispatch_admit(self, group, bucket: int, slot_ids: list[int]) -> None:
        m = len(group)
        t0 = time.monotonic()
        # Pin each request's adapter into a device row before anything else
        # is claimed: a fetch / promote failure then fails this group (an
        # adapter request admits alone) with nothing else to unwind.
        adapter_rows = [0] * m
        try:
            for j, (r, _h) in enumerate(group):
                if r.adapter:
                    adapter_rows[j] = self._adapter_acquire(r.adapter)
        except Exception:
            for row in adapter_rows:
                self._adapter_unpin(row)
            raise
        try:
            self._dispatch_admit_pinned(group, bucket, slot_ids, adapter_rows, t0)
        except Exception:
            for row in adapter_rows:
                self._adapter_unpin(row)
            raise

    def _dispatch_admit_pinned(self, group, bucket: int, slot_ids: list[int],
                               adapter_rows: list[int], t0: float) -> None:
        m = len(group)
        prompt = np.zeros((m, bucket), np.int64)
        lens = np.zeros((m,), np.int64)
        for j, (r, _h) in enumerate(group):
            prompt[j, : len(r.prompt_ids)] = r.prompt_ids
            lens[j] = len(r.prompt_ids)
        samp, bias_rows, seeds = self._request_controls(group)
        dev = self.device
        table_rows = None
        if self._paged:
            for (r, _h), s in zip(group, slot_ids):
                if self._pages_alloc(s, self._pages_needed(r)) is None:
                    for s2 in slot_ids:  # the planner counted these pages
                        self._pages_free(s2)
                    raise RuntimeError("KV page pool exhausted at admission")
            table_rows = self._device_table(self.h_l1[slot_ids] if self._hier
                                            else self.h_ptable[slot_ids])
        d_prompt, d_lens = torch.from_numpy(prompt).to(dev), torch.from_numpy(lens).to(dev)
        # Once any adapter is device-resident every admission carries the
        # stacks; adapter-less rows ride id 0, the exact-zero null adapter.
        lora = None
        if self._lora_tree is not None:
            lora = (self._lora_tree,
                    torch.from_numpy(np.asarray(adapter_rows, np.int32)).to(dev))
        try:
            logits, ks, vs = llama.prefill(self.cfg, self.params, d_prompt, d_lens, lora=lora)
            for j, s in enumerate(slot_ids):
                if table_rows is not None:
                    llama.write_prefill_to_pool(self.cache, _pt.select_row(table_rows, j), ks,
                                                vs, j, kv_scale=self._kv_scales)
                else:
                    llama.write_prefill_to_cache(self.cache, ks[:, j:j + 1], vs[:, j:j + 1], s)
            toks = self._install_first(logits, d_prompt, d_lens, samp, bias_rows, seeds,
                                       slot_ids)
            toks_host = toks.tolist()  # the admission's one device-to-host copy
        except Exception:
            if self._paged:
                for s in slot_ids:
                    self._pages_free(s)
            raise
        self.m_admissions += 1
        # Claim the slots only after a successful admission, so a failed
        # one leaves no slot state behind.
        for j, ((r, handle), s) in enumerate(zip(group, slot_ids)):
            self._claim_slot(s, r, handle, int(seeds[j]), t0)
            # The pin passes to the slot; _release drops it from here on.
            self.h_adapter[s], adapter_rows[j] = adapter_rows[j], 0
        for j, s in enumerate(slot_ids):
            self._post_first(s, int(toks_host[j]))

    # ------------------------------------------------------------------ #
    # Decode blocks
    # ------------------------------------------------------------------ #

    def _remaining(self, s: _Slot) -> int:
        return min(s.request.max_new_tokens - s.scheduled,
                   self.ecfg.max_seq - s.prompt_len - s.scheduled)

    def _has_unscheduled(self) -> bool:
        """Some active slot still has token budget left."""
        return any(s is not None and self.h_active[i] and self._remaining(s) > 0
                   for i, s in enumerate(self.slots))

    def _pick_block_size(self) -> int:
        """The smallest block covering the largest remaining budget over the
        active slots, or the largest block when none covers it."""
        remaining = 1
        for i, s in enumerate(self.slots):
            if s is not None and self.h_active[i]:
                remaining = max(remaining, self._remaining(s))
        sizes = sorted(self.ecfg.block_sizes)
        for n in sizes:
            if n >= remaining:
                return n
        return sizes[-1]

    def _run_block(self) -> bool:
        """One n-step decode block: grow the pages it writes, stage the
        control rows, run the body (a graph replay on the card), one host
        copy, then stream. Returns False, having dispatched nothing, when
        the page pool cannot cover the block's growth."""
        n = self._pick_block_size()
        if not self._grow_for_decode(n):
            return False
        t0 = time.monotonic()
        act = self.h_active.copy()
        hs = self.h_sampling
        idx = np.flatnonzero(act)
        sampled = hs["temperature"][idx] > 0
        needs_filter = bool(np.any(sampled & (
            (hs["top_k"][idx] > 0) | (hs["top_p"][idx] < 1) | (hs["min_p"][idx] > 0))))
        variant = "filtered" if needs_filter else ("simple" if sampled.any() else "greedy")
        win = 0
        if not self._paged:
            # Read-side KV window: the smallest power of two (>= 256)
            # covering every active slot's pre-block rows; the cache holds
            # nothing the block reads past it, so attention streams less.
            S = self.ecfg.max_seq
            maxpos = max(self.slots[i].prompt_len + self.slots[i].scheduled for i in idx)
            win = self._KV_WIN_MIN
            while win < min(maxpos, S):
                win *= 2
            win = min(win, S)
        self._stage_block(act)
        self._decode_block(n, variant, win)
        toks = self._b_out[:n].cpu().numpy()  # the block's one device-to-host copy
        self.m_blocks += 1
        self.m_decode_steps += n
        for i in idx:
            self.slots[i].scheduled += n
            self.slots[i].sched_rows += n
        consumed = 0
        for step in range(n):
            for i in idx:
                if self.slots[i] is None:
                    continue  # finished earlier in this block
                consumed += 1
                self._post_token(int(i), int(toks[step, i]))
        self._decode_tokens += consumed
        self._decode_time += time.monotonic() - t0
        return True

    def _stage_block(self, act: np.ndarray) -> None:
        """Copy a block's host control rows into the body's device buffers,
        in place, from pinned memory: the active row and the sampling
        fields, the page table, the adapter rows. The previous block's
        copies are done: each block ends with a host read of its ids."""
        pack = self._h_pack.numpy()
        pack[0] = act
        for fi, k in enumerate(_SAMPLING_FIELDS):
            pack[fi + 1] = self.h_sampling[k]
        self._b_pack.copy_(self._h_pack, non_blocking=True)
        if self._hier:
            self._l0_buffers()
            self._h_l1.numpy()[:] = self.h_l1
            self._b_l1.copy_(self._h_l1, non_blocking=True)
            self._h_l0.numpy()[:] = self.h_l0
            self._b_l0.copy_(self._h_l0, non_blocking=True)
        elif self._paged:
            self._h_ptable.numpy()[:] = self.h_ptable
            self._b_ptable.copy_(self._h_ptable, non_blocking=True)
        if self._lora_tree is not None:
            self._h_adapter.numpy()[:] = self.h_adapter
            self._b_adapter.copy_(self._h_adapter, non_blocking=True)

    def _l0_buffers(self) -> None:
        """(Re)allocate the pinned and device buffers of the table-page pool
        to h_l0's rows. h_l0 grows only if a table-page claim finds the pool
        empty (_tp_claim); the graphs captured on the old device buffer are
        dropped, and the layout part of the block key moves with the rows,
        so no replay reads past a buffer it captured."""
        if self._b_l0 is not None and self._b_l0.shape == self.h_l0.shape:
            return
        pin = self.device.type == "cuda"
        self._h_l0 = torch.zeros(self.h_l0.shape, dtype=torch.int32, pin_memory=pin)
        self._b_l0 = torch.full(self.h_l0.shape, self._scratch_page, dtype=torch.int32,
                                device=self.device)
        self._graph_cache = {k: v for k, v in self._graph_cache.items()
                             if k[4:] == self._table_key()}

    def _table_key(self) -> tuple:
        """The part of a block's key that names a hierarchical table's
        layout (the table-page pool's rows); empty for a flat table."""
        return (("hier", self.h_l0.shape[0]),) if self._hier else ()

    def _device_table(self, rows: np.ndarray):
        """A table operand for rows of host table rows (flat [m, MP] or
        directories [m, ML1]); a hierarchical one carries the current
        table-page pool."""
        rows = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        if self._hier:
            return (rows, torch.from_numpy(self.h_l0).to(self.device))
        return rows

    def _block_key(self, n: int, variant: str, win: int) -> tuple:
        """What fixes a block's graph (the reference's block-cache key):
        the sampler variant, n, the dense read window (0 on a paged pool),
        once adapters are resident the stacks' (keys, rows, rank), and for
        a hierarchical table its layout."""
        lora = None
        if self._lora_tree is not None:
            rows = next(iter(self._lora_tree.values()))["a"].shape[1]
            lora = (self._lora_keys, rows, self._lora_rank)
        return (variant, n, win, lora) + self._table_key()

    def _decode_block(self, n: int, variant: str, win: int) -> None:
        """Run the block body on the staged buffers: eagerly on the CPU; on
        the card as the CUDA graph of its shape, captured at the shape's
        first block and replayed from then on. A failed capture or replay
        raises (the loop fails the block's requests)."""
        if self.device.type != "cuda":
            self._block_body(n, variant, win)
            return
        key = self._block_key(n, variant, win)
        entry = self._graph_cache.get(key)
        if entry is None:
            self._capture_block(key, n, variant, win)
        else:
            kernels.replay_counted(entry[0], entry[1])
            self.m_graph_replays += 1

    def _capture_block(self, key: tuple, n: int, variant: str, win: int) -> None:
        """A shape's first block on the card. The body runs eagerly on the
        capture stream first: that run is the real block, and it does what
        must not happen inside a capture (loading the kernel libraries,
        creating cuBLAS handles and the stream's workspace, setting kernel
        attributes, growing the split workspaces to this shape). Then the
        body is captured, which executes nothing. The graph keeps the
        workspaces it captured alive, and the replays add the launches its
        wrappers counted during the capture."""
        t0 = time.monotonic()
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if not self._graph_cache:
            # A pool lives while a graph captured into it does: once the
            # last one is dropped (_lora_rebuild), captures need a new pool.
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._graph_stream
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()

        def capture() -> None:
            graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
            try:
                self._block_body(n, variant, win)
            finally:
                graph.capture_end()

        with torch.cuda.stream(stream):
            self._block_body(n, variant, win)
            torch.cuda.synchronize(self.device)  # as torch.cuda.graph does before a capture
            deltas = kernels.captured_counts(capture)
        current.wait_stream(stream)
        self._graph_cache[key] = (graph, deltas, kernels.live_workspaces())
        self.m_graph_captures += 1
        self.m_graph_capture_s += time.monotonic() - t0

    def _block_body(self, n: int, variant: str, win: int) -> None:
        """n decode steps over every slot, on persistent device buffers
        only: it reads the staged controls (_b_pack, the table, _b_adapter),
        the tokens, positions and seeds, counts, bias, the cache and the
        params, and writes the counts, the cache (once, at the end), the
        tokens and positions (in place) and the ids (_b_out[:n]). Idle
        slots are masked; on a paged pool they walk no pages (limit 0) and
        write into SCRATCH. `win` < max_seq reads a dense cache through
        that window. No host sync."""
        cfg, B, S = self.cfg, self.ecfg.max_slots, self.ecfg.max_seq
        dev = self.device
        active = self._b_pack[0] > 0
        act_i32 = active.to(torch.int32)
        sp = _sampling_params(self._b_pack[1:])
        ptable = None
        read_cache = self.cache
        if self._paged:
            ptable = (self._b_l1, self._b_l0) if self._hier else self._b_ptable
        elif win < S:
            read_cache = llama.KVCache(k=self.cache.k[:, :, :win], v=self.cache.v[:, :, :win])
        shape = (cfg.num_layers, B, n, cfg.num_kv_heads, cfg.head_dim_)
        local_k = torch.zeros(shape, dtype=self._local_dtype, device=dev)
        local_v = torch.zeros(shape, dtype=self._local_dtype, device=dev)
        tokens, positions = self.d_tokens, self.d_positions
        if self._paged:
            positions = torch.where(active, positions, 0)
        start_pos = positions
        lora = None if self._lora_tree is None else (self._lora_tree, self._b_adapter)
        for step in range(n):
            logits, local_k, local_v = llama.decode_step_windowed(
                cfg, self.params, tokens, positions, read_cache, local_k, local_v, step,
                ptable=ptable, kv_scale=self._kv_scales, lora=lora)
            # The drawn token sits at positions + 1: its noise is keyed there.
            if variant == "greedy":
                nxt = sample_greedy(logits, sp, self.counts, self.bias)
            elif variant == "simple":
                nxt = sample_simple(logits, self.d_seed, positions + 1, sp, self.counts,
                                    self.bias)
            else:
                nxt = sample(logits, self.d_seed, positions + 1, sp, self.counts, self.bias)
            update_counts(self.counts, nxt, act_i32)
            nxt = torch.where(active, nxt, 0)
            self._b_out[step] = nxt
            # Clamp so idle / overshooting slots stay inside their own rows.
            positions = torch.clamp(positions + 1, max=S - 1)
            tokens = nxt
        if self._paged:
            llama.write_block_to_pool(self.cache, ptable, local_k, local_v, start_pos,
                                      kv_scale=self._kv_scales)
        else:
            llama.write_block_to_cache(self.cache, local_k, local_v, start_pos)
        self.d_tokens.copy_(tokens)
        self.d_positions.copy_(positions)

    # ------------------------------------------------------------------ #
    # Warmup (the reference's Engine.warmup)
    # ------------------------------------------------------------------ #

    def warmup(self, prompt_len: int = 8) -> None:
        """Run every serving shape once before traffic arrives: one
        admission of each power-of-two group size up to max_slots at
        `prompt_len`'s bucket, then every decode-block shape the scheduler
        can pick (each of block_sizes x the three sampler variants, and on
        a dense cache every read window at block_sizes[0]), so on the card
        every block graph is captured here and serving only replays. Then
        one 2-token generate through the loop.

        Runs against the live state with every slot idle (call it before
        traffic): throwaway writes land in idle rows or SCRATCH, and the
        per-slot device rows (counts, bias, tokens, positions, seeds) are
        put back as they were. The reference's grammar and logprobs
        programs wait for their ports."""
        if any(s is not None for s in self.slots) or self._pending:
            raise RuntimeError("warmup() needs an idle engine: call it before traffic")
        state = (self.counts, self.bias, self.d_tokens, self.d_positions, self.d_seed)
        saved = [t.clone() for t in state]
        bucket = self._bucket_for(prompt_len)
        m = 1
        while m <= self.ecfg.max_slots:
            self._warm_admit(m, bucket)
            m *= 2
        S = self.ecfg.max_seq
        variants = ("greedy", "simple", "filtered")
        for n in self.ecfg.block_sizes:
            for variant in variants:
                self._warm_block(n, variant, 0 if self._paged else S)
        if not self._paged:
            w = self._KV_WIN_MIN
            while w < S:
                for variant in variants:
                    self._warm_block(self.ecfg.block_sizes[0], variant, w)
                w *= 2
        _, ev = self.generate([1] * prompt_len, max_new_tokens=2)
        if ev.kind != "done":
            raise RuntimeError(f"warmup generate ended with {ev.kind}: {ev.error}")
        for t, old in zip(state, saved):
            t.copy_(old)

    def _warm_admit(self, m: int, bucket: int) -> None:
        """One throwaway admission of m one-token prompts into slots
        0..m-1: KV into those idle rows (dense) or SCRATCH (paged)."""
        dev = self.device
        prompt = torch.zeros((m, bucket), dtype=torch.int64, device=dev)
        lens = torch.ones((m,), dtype=torch.int64, device=dev)
        lora = None
        if self._lora_tree is not None:
            lora = (self._lora_tree, torch.zeros((m,), dtype=torch.int32, device=dev))
        logits, ks, vs = llama.prefill(self.cfg, self.params, prompt, lens, lora=lora)
        scratch = torch.full((max(self._max_pages, 1),), self._scratch_page, dtype=torch.int32,
                             device=dev)
        for j in range(m):
            if self._paged:
                llama.write_prefill_to_pool(self.cache, scratch, ks, vs, j,
                                            kv_scale=self._kv_scales)
            else:
                llama.write_prefill_to_cache(self.cache, ks[:, j:j + 1], vs[:, j:j + 1], j)
        samp = np.zeros((len(_SAMPLING_FIELDS), m), np.float32)
        samp[_SAMPLING_FIELDS.index("top_p")] = 1.0
        samp[_SAMPLING_FIELDS.index("repeat_penalty")] = 1.0
        toks = self._install_first(logits, prompt, lens, samp,
                                   np.zeros((m, self.cfg.vocab_size), np.float32),
                                   np.zeros((m,), np.int64), list(range(m)))
        toks.cpu()

    def _warm_block(self, n: int, variant: str, win: int) -> None:
        """One decode block of this shape with every slot idle."""
        self._stage_block(np.zeros_like(self.h_active))
        self._decode_block(n, variant, win)
        self._b_out[:n].cpu()

    # ------------------------------------------------------------------ #
    # Paged KV pool: page allocator (loop thread only)
    # ------------------------------------------------------------------ #

    def _pages_worst(self, request: GenRequest) -> int:
        """Worst-case pages of a request: the prefill writes a whole bucket
        of rows, and decode may reach prompt + max_new. The submit gate, and
        the cap on admission headroom."""
        plen = len(request.prompt_ids)
        rows = max(self._bucket_for(plen), min(plen + request.max_new_tokens, self.ecfg.max_seq))
        return -(-rows // self.ecfg.kv_page_size)

    def _pages_needed(self, request: GenRequest) -> int:
        """Pages a single-shot admission reserves: the prompt's bucket plus
        kv_page_headroom, never past the worst case; decode growth takes
        the rest as the context crosses page boundaries."""
        base = -(-self._bucket_for(len(request.prompt_ids)) // self.ecfg.kv_page_size)
        cap = max(base, self._pages_worst(request))
        return min(base + self.ecfg.kv_page_headroom, cap)

    def _pages_alloc(self, slot_idx: int, n: int,
                     shared: Optional[list[int]] = None) -> Optional[np.ndarray]:
        """Build a slot's page table: `shared` pages (one more reference
        each) followed by `n` fresh ones. Returns the slot's table row
        ([MP] flat, its [ML1] directory hierarchical), or None, changing
        nothing, when the pool cannot cover it."""
        if self._slot_pages[slot_idx]:
            # Overwriting a held table would leak its pages' references.
            log.error("_pages_alloc: slot %d already held %d pages — releasing them",
                      slot_idx, len(self._slot_pages[slot_idx]))
            self._pages_free(slot_idx)
        shared = list(shared or [])
        fresh = self._pages_claim(max(0, min(n, self._max_pages - len(shared))))
        if fresh is None:
            return None
        self._pages_addref(shared)
        pages = shared + fresh
        self._slot_pages[slot_idx] = pages
        if self._hier:
            return self._ptable_build_slot(slot_idx, pages)
        # Unused tail entries stay on SCRATCH, so rows past the slot's
        # pages (block overshoot) land where nobody reads.
        row = np.full((self._max_pages,), self._scratch_page, np.int32)
        row[: len(pages)] = pages
        self.h_ptable[slot_idx] = row
        return row

    def _pages_claim(self, n: int) -> Optional[list[int]]:
        """Pop `n` fresh pages from the free list, refcount 1 each, or
        None (no change) when the pool cannot cover them."""
        if n < 0 or len(self._free_pages) < n:
            return None
        fresh = [self._free_pages.pop() for _ in range(n)]
        for p in fresh:
            self._page_refs[p] = 1
        self.m_kv_pages_peak = max(self.m_kv_pages_peak,
                                   self.ecfg.kv_pages - len(self._free_pages))
        return fresh

    def _pages_addref(self, pages: list[int]) -> None:
        """One more reference on pages already allocated. A free page is
        taken off the free list instead, so it cannot alias the next claim."""
        for p in pages:
            if self._page_refs[p] <= 0:
                log.error("addref of free page %d — reclaiming it", p)
                if p in self._free_pages:
                    self._free_pages.remove(p)
                self._page_refs[p] = 1
                continue
            self._page_refs[p] += 1

    def _pages_release(self, pages: list[int]) -> None:
        """Drop one reference per page; a page returns to the free list at
        refcount 0. A double release is ignored (it would let two slots
        claim the same page); a spilled column's sentinel (-1) owns no
        device page."""
        for p in pages:
            if p < 0:
                continue
            if self._page_refs[p] <= 0:
                log.error("double release of page %d ignored", p)
                self._page_refs[p] = 0
                continue
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                self._free_pages.append(p)

    def _pages_grow_slot(self, slot_idx: int, need_pages: int) -> bool:
        """Extend a live slot's table to `need_pages` pages: a host array
        write, shipped with the next dispatch."""
        need_pages = min(need_pages, self._max_pages)
        have = len(self._slot_pages[slot_idx])
        grow = need_pages - have
        if grow <= 0:
            return True
        fresh = self._pages_claim(grow)
        if fresh is None:
            return False
        self._slot_pages[slot_idx].extend(fresh)
        if self._hier:
            for off, p in enumerate(fresh):
                self._ptable_set(slot_idx, have + off, p)
        else:
            self.h_ptable[slot_idx, have:need_pages] = fresh
        self.m_kv_pages_grown += grow
        return True

    def _grow_for_decode(self, steps: int) -> bool:
        """Grow every active slot's table over the rows the next `steps`
        decode steps write that a later block may read (rows of tokens past
        a slot's budget are overshoot and may land in SCRATCH). Returns
        False, and blocks admissions, when some slot cannot grow."""
        if not self._paged:
            return True
        page = self.ecfg.kv_page_size
        for i, s in enumerate(self.slots):
            if s is None or not self.h_active[i]:
                continue
            rows = min(s.sched_rows + min(steps, max(self._remaining(s), 0)), self.ecfg.max_seq)
            if not self._pages_grow_slot(i, -(-rows // page)):
                self._growth_blocked = True
                return False
        self._growth_blocked = False
        return True

    def _pages_free(self, slot_idx: int) -> None:
        # The slot stays in every decode block's scatter until re-admitted:
        # its stale table must not alias pages handed to the next request.
        if self._hier:
            self._ptable_free_slot(slot_idx)
        else:
            self.h_ptable[slot_idx] = self._scratch_page
        self._pages_release(self._slot_pages[slot_idx])
        self._slot_pages[slot_idx] = []
        # Spilled images die with the slot (their device pages went back to
        # the pool when they spilled); the prefix cache that would restore
        # them is not ported.
        self._spill_bytes -= len(self._slot_spill[slot_idx]) * self._page_bytes()
        self._slot_spill[slot_idx] = {}
        self._spill_cursor[slot_idx] = 0

    # ------------------------------------------------------------------ #
    # Hierarchical page tables (kv_l1_span > 0): each slot's directory of
    # refcounted table pages (h_l1 -> rows of h_l0). The page allocator
    # above is the same for both layouts; these keep the mapping. Sharing
    # table pages with prefix entries waits for the prefix cache.
    # ------------------------------------------------------------------ #

    def _tp_claim(self) -> int:
        """Claim a fresh table page (refcount 1, all-SCRATCH content). The
        pool is sized so it cannot run dry; if it does, it grows (and the
        next block re-keys its graph: _l0_buffers) instead of corrupting
        state."""
        if not self._tp_free:
            grow = max(self._ml1, 1)
            base = self.h_l0.shape[0]
            self.h_l0 = np.concatenate([
                self.h_l0, np.full((grow, self.h_l0.shape[1]), self._scratch_page, np.int32)])
            self._tp_refs = np.concatenate([self._tp_refs, np.zeros((grow,), np.int32)])
            self._tp_free.extend(range(base, base + grow))
            log.error("table-page pool exhausted — grew by %d", grow)
        tp = self._tp_free.pop()
        self._tp_refs[tp] = 1
        self.h_l0[tp, :] = self._scratch_page
        return tp

    def _tp_release(self, tps: list[int]) -> None:
        """Drop one reference per table page; free at refcount 0. The
        SCRATCH table page is never released; a double release is ignored."""
        for tp in tps:
            if tp == self._scratch_tp:
                continue
            if self._tp_refs[tp] <= 0:
                log.error("double release of table page %d ignored", tp)
                self._tp_refs[tp] = 0
                continue
            self._tp_refs[tp] -= 1
            if self._tp_refs[tp] == 0:
                self._tp_free.append(tp)

    def _ptable_set(self, slot_idx: int, pos: int, page_id: int) -> None:
        """Point column `pos` of a slot's directory at `page_id`, claiming
        the table pages up to it and copying a shared one before writing
        through it."""
        span = self._l1_span
        c, o = divmod(pos, span)
        tps = self._slot_tps[slot_idx]
        while len(tps) <= c:
            tp_new = self._tp_claim()
            tps.append(tp_new)
            self.h_l1[slot_idx, len(tps) - 1] = tp_new
        tp = tps[c]
        if self._tp_refs[tp] > 1:
            tp_new = self._tp_claim()
            self.h_l0[tp_new, :] = self.h_l0[tp]
            self._tp_release([tp])
            tps[c] = tp_new
            self.h_l1[slot_idx, c] = tp_new
            tp = tp_new
        self.h_l0[tp, o] = page_id

    def _ptable_build_slot(self, slot_idx: int, pages: list[int]) -> np.ndarray:
        """Build a slot's directory for `pages` in freshly claimed table
        pages. Returns the slot's L1 row (the counterpart of a flat row)."""
        if self._slot_tps[slot_idx]:
            log.error("slot %d already held a directory — releasing it", slot_idx)
            self._ptable_free_slot(slot_idx)
        self.h_l1[slot_idx, :] = self._scratch_tp
        for pos, p in enumerate(pages):
            self._ptable_set(slot_idx, pos, p)
        return self.h_l1[slot_idx].copy()

    def _ptable_free_slot(self, slot_idx: int) -> None:
        self._tp_release(self._slot_tps[slot_idx])
        self._slot_tps[slot_idx] = []
        self.h_l1[slot_idx, :] = self._scratch_tp

    # ------------------------------------------------------------------ #
    # Cold-page spill (attention_window > 0, kv_spill_bytes > 0): a page
    # whose last row sits more than attention_window behind every query
    # the slot can still run (and past the sink) is never attended again,
    # since query positions only grow. Its bytes are copied to pinned host
    # memory, its device page returns to the pool, and its table entry
    # points at SCRATCH, which the skip never reads.
    # ------------------------------------------------------------------ #

    _SPILL_MAX_PER_TICK = 64  # pages a loop iteration: bounds one gather

    def _page_bytes(self) -> int:
        """Device bytes of one page's K and V rows over every layer."""
        k = self.cache.k
        return 2 * k[:, 0].numel() * k.element_size()

    def _spill_cold_pages(self) -> None:
        """Loop-thread tick: move the cold middle pages of live and chunking
        slots to the host, at most _SPILL_MAX_PER_TICK a tick and within
        kv_spill_bytes. A failed copy leaves that batch hot (exact either
        way) and counts it in kv_spill_skips."""
        if not self._spill_on:
            return
        page = self.ecfg.kv_page_size
        swin = self.cfg.attention_window
        sink_cols = -(-self.cfg.attention_sink // page) if self.cfg.attention_sink else 0
        # Slack under the floor below: a chunk's queries start at its
        # offset and a block's at the slot's processed rows; the margin
        # keeps a whole chunk and a whole block of distance besides.
        margin = self.ecfg.prefill_chunk + max(self.ecfg.block_sizes)
        pb = self._page_bytes()
        by_slot = {st["slot"]: st for st in self._chunkings}
        done = 0
        for i in range(self.ecfg.max_slots):
            if done >= self._SPILL_MAX_PER_TICK:
                return
            st = by_slot.get(i)
            if st is not None:
                floor = st["offset"]
            elif self.h_active[i] and self.slots[i] is not None:
                s = self.slots[i]
                floor = s.prompt_len + len(s.generated)
            else:
                continue
            pages = self._slot_pages[i]
            cand: list[int] = []
            c = max(int(self._spill_cursor[i]), sink_cols)
            while (c < len(pages) and (c + 1) * page <= floor - swin - margin
                   and done + len(cand) < self._SPILL_MAX_PER_TICK):
                p = pages[c]
                if p < 0:
                    self._spill_cursor[i] = c + 1  # already spilled
                elif self._page_refs[p] > 1:
                    # Another table reads it: releasing ours frees nothing.
                    self.m_kv_spill_skips += 1
                    self._spill_cursor[i] = c + 1
                elif self._spill_bytes + (len(cand) + 1) * pb > self.ecfg.kv_spill_bytes:
                    break  # budget full: retry once images are dropped
                else:
                    cand.append(c)
                c += 1
            if not cand:
                continue
            try:
                hk, hv = self._pages_to_host([pages[c] for c in cand])
            except Exception:  # noqa: BLE001 — the pages stay hot, attention stays exact
                log.exception("cold-page spill failed (slot %d)", i)
                self.m_kv_spill_skips += len(cand)
                self._spill_cursor[i] = cand[-1] + 1
                continue
            for j, c in enumerate(cand):
                self._slot_spill[i][c] = (hk[:, j:j + 1], hv[:, j:j + 1])
                self._pages_release([pages[c]])
                pages[c] = -1
                if self._hier:
                    self._ptable_set(i, c, self._scratch_page)
                elif st is not None:
                    st["table_row"][c] = self._scratch_page
                else:
                    self.h_ptable[i, c] = self._scratch_page
                self._spill_cursor[i] = c + 1
            nbytes = len(cand) * pb
            self._spill_bytes += nbytes
            self.m_kv_pages_spilled += len(cand)
            self.m_kv_spill_bytes_out += nbytes
            done += len(cand)

    def _pages_to_host(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Copy pool pages to host tensors [L, n, page, K, Hd] (pinned on the
        card). The gather and the copy go on the engine's one stream before
        the pages are released, so no later write to a recycled page can
        overtake them; nothing waits for the copy."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        out = []
        for pool in (self.cache.k, self.cache.v):
            rows = pool[:, idx]
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=self.device.type == "cuda")
            host.copy_(rows, non_blocking=True)
            out.append(host)
        return out[0], out[1]

    # ------------------------------------------------------------------ #
    # Chunked prefill (paged pool): a long prompt admits chunk by chunk,
    # one chunk between two decode blocks. Mid chunks write K/V only; the
    # final chunk also samples the first token and installs the slot.
    # ------------------------------------------------------------------ #

    def _chunkable(self, request: GenRequest) -> bool:
        """Whether a prompt admits chunk by chunk. Adapter prompts never do:
        the chunk pass carries no per-slot LoRA operand (as in the JAX
        package), so they admit single-shot. Under the sink + window every
        paged admission longer than one chunk takes the chunks' masked
        prefix walk; shorter ones stay single-shot, exact there because
        each query's window covers the whole prompt (chunk <= window)."""
        C = self.ecfg.prefill_chunk
        return (bool(C) and self._paged and len(request.prompt_ids) > C
                and request.adapter is None)

    def _chunk_admit_rows(self, total_len: int) -> int:
        """Rows a chunked admission writes: whole mid chunks of C tokens
        and the final tail's bucket (padding included)."""
        C = self.ecfg.prefill_chunk
        mids, rem = 0, total_len
        while rem > C:
            rem -= C
            mids += 1
        return mids * C + self._bucket_for(max(rem, 1))

    def _chunk_start(self, request: GenRequest, handle: RequestHandle) -> bool:
        """Reserve a slot and the pages the chunks write (plus headroom) and
        queue the chunked admission. Returns False, with the request back
        at the queue head, when the pool cannot cover it."""
        ids = request.prompt_ids
        slot_idx = next(i for i, s in enumerate(self.slots) if s is None)
        page = self.ecfg.kv_page_size
        rows = self._chunk_admit_rows(len(ids))
        base = -(-rows // page)
        worst = max(rows, min(len(ids) + request.max_new_tokens, self.ecfg.max_seq))
        cap = max(base, -(-worst // page))
        table_row = self._pages_alloc(slot_idx, min(base + self.ecfg.kv_page_headroom, cap))
        if table_row is None:
            with self._pending_lock:
                self._pending.appendleft((request, handle))
            return False
        # The slot stays on SCRATCH until its final chunk: decode blocks
        # write every slot each step, and must not reach pages this
        # prefill owns. The chunk dispatches carry the real row (the
        # directory row, hierarchical: table-page contents ride current).
        if self._hier:
            self.h_l1[slot_idx, :] = self._scratch_tp
        else:
            self.h_ptable[slot_idx] = self._scratch_page
        self.slots[slot_idx] = _Slot(request=request, handle=handle, prompt_len=len(ids),
                                     sched_rows=len(ids), t_submit=handle.t_submit)
        self._chunkings.append({"request": request, "handle": handle, "slot": slot_idx,
                                "ids": ids, "offset": 0, "t0": time.monotonic(),
                                "table_row": table_row})
        return True

    def _advance_chunked(self) -> bool:
        """Run the next chunk of the oldest chunked admission. Returns
        whether anything happened."""
        if not self._chunkings:
            return False
        st = self._chunkings[0]
        slot_idx = st["slot"]
        if st["handle"].cancelled.is_set():
            st["handle"]._q.put(TokenEvent(kind="done", finish_reason="stop"))
            self._release(slot_idx)
            return True
        if self.h_active.any():
            self.m_chunks_interleaved += 1
        C = self.ecfg.prefill_chunk
        try:
            if len(st["ids"]) - st["offset"] > C:
                self._dispatch_chunk(st, C)
                st["offset"] += C
            else:
                self._chunkings.pop(0)
                self._dispatch_chunk_final(st)
        except Exception as e:  # noqa: BLE001 — fail the request, keep serving
            log.exception("chunked prefill dispatch failed (slot %d)", slot_idx)
            st["handle"]._q.put(TokenEvent(kind="error", error=f"{type(e).__name__}: {e}"))
            self._release(slot_idx)
        return True

    def _dispatch_chunk(self, st: dict, n: int, with_logits: bool = False):
        """Prefill `n` tokens of a chunked admission at its offset against
        the rows already in its pages, writing theirs (the final tail is
        bucketed). Returns the last token's logits [1, V], or None."""
        offset = st["offset"]
        seg = st["ids"][offset: offset + n]
        toks = np.zeros((1, self._bucket_for(len(seg)) if with_logits else n), np.int64)
        toks[0, : len(seg)] = seg
        dev = self.device
        logits, _ = llama.prefill_chunk_paged(
            self.cfg, self.params, torch.from_numpy(toks).to(dev),
            torch.tensor([len(seg)], device=dev), torch.tensor([offset], device=dev),
            self.cache, self._device_table(st["table_row"][None]),
            with_logits=with_logits, kv_scale=self._kv_scales)
        self.m_prefill_chunks += 1
        return logits

    def _dispatch_chunk_final(self, st: dict) -> None:
        """The last <= prefill_chunk tokens: prefill, first-token sample and
        slot activation."""
        request, handle, s = st["request"], st["handle"], st["slot"]
        ids = st["ids"]
        logits = self._dispatch_chunk(st, len(ids) - st["offset"], with_logits=True)
        samp, bias_rows, seeds = self._request_controls([(request, handle)])
        dev = self.device
        full = torch.as_tensor(np.asarray([ids], np.int64)).to(dev)
        toks = self._install_first(logits, full, torch.tensor([len(ids)], device=dev),
                                   samp, bias_rows, seeds, [s])
        tok = int(toks.tolist()[0])  # the admission's one device-to-host copy
        # Publish the real table: blocks from here on read and write it.
        if self._hier:
            self.h_l1[s] = st["table_row"]
        else:
            self.h_ptable[s] = st["table_row"]
        self.m_chunked_admits += 1
        self._claim_slot(s, request, handle, int(seeds[0]), st["t0"])
        self._post_first(s, tok)

    # ------------------------------------------------------------------ #
    # Preemption by recompute
    # ------------------------------------------------------------------ #

    def _preempt_youngest(self) -> None:
        """Free the youngest live slot's pages so growth-blocked older slots
        can go on. The victim's request is requeued at the head as prompt +
        generated, under the same handle and with no terminal event; its
        re-admission recomputes the KV and continues the stream
        (_apply_resume), re-pinning its adapter (maybe into another row).
        Recompute is the only policy: the host swap tier is not ported."""
        live = [i for i, s in enumerate(self.slots) if s is not None and self.h_active[i]]
        if not live:
            return
        victim = max(live, key=lambda i: (self.slots[i].t_submit, i))
        slot = self.slots[victim]
        r = slot.request
        rec = {
            "orig_prompt_len": slot.prompt_len,
            "generated": list(slot.generated),
            "emitted_len": slot.emitted_len,
            "t_submit": slot.t_submit,
            "t_admit": slot.t_admit,
            "t_first": slot.t_first,
            "seed": int(self.h_seed[victim]),
        }
        resume_req = dataclasses.replace(
            r, prompt_ids=list(r.prompt_ids) + list(slot.generated), resume=rec)
        self.m_kv_preemptions += 1
        self._release(victim)
        with self._pending_lock:
            self._pending.appendleft((resume_req, slot.handle))
        # _growth_blocked stays set: the freed pages go to the starved
        # slots first, not straight back to the victim at the queue head.
        log.info("preempted slot %d (recompute, %d rows)", victim,
                 slot.prompt_len + len(slot.generated))

    def _apply_resume(self, slot_idx: int) -> None:
        """Turn a freshly admitted slot that is a preempted request back
        into it: its original prompt, its generated tokens and streamed
        text (the next event continues the same handle) and its timings.
        The admission has just sampled the next token."""
        slot = self.slots[slot_idx]
        rec = slot.request.resume
        if rec is None:
            return
        n = rec["orig_prompt_len"]
        slot.request = dataclasses.replace(
            slot.request, prompt_ids=list(slot.request.prompt_ids[:n]), resume=None)
        slot.prompt_len = n
        slot.generated = list(rec["generated"])
        slot.emitted_len = rec["emitted_len"]
        slot.scheduled = len(slot.generated) + 1
        slot.t_submit, slot.t_admit, slot.t_first = rec["t_submit"], rec["t_admit"], rec["t_first"]

    # ------------------------------------------------------------------ #
    # Token bookkeeping / streaming
    # ------------------------------------------------------------------ #

    def _post_token(self, slot_idx: int, tok: int) -> None:
        """Append one generated token to a slot: stream text, check stops."""
        slot = self.slots[slot_idx]
        r, handle = slot.request, slot.handle
        if handle.cancelled.is_set():
            self._finish(slot_idx, "stop")
            return
        is_eos = (not r.ignore_eos) and tok in self.tokenizer.eos_ids
        if not is_eos:
            slot.generated.append(tok)
            self.m_generated_tokens += 1
        text = self.tokenizer.decode(slot.generated)
        new = text[slot.emitted_len:]

        finish: Optional[str] = None
        if is_eos:
            finish = "stop"
        elif r.stop:
            # Stop-sequence scan over the un-emitted tail plus the overlap a
            # stop may share with already-emitted text.
            window_start = max(0, slot.emitted_len - max(len(s) for s in r.stop))
            window = text[window_start:]
            cut = None
            for s in r.stop:
                at = window.find(s)
                if at >= 0:
                    cut = window_start + at if cut is None else min(cut, window_start + at)
            if cut is not None:
                new = text[slot.emitted_len: cut]
                finish = "stop"
        if finish is None and (
            len(slot.generated) >= r.max_new_tokens
            or slot.prompt_len + len(slot.generated) >= self.ecfg.max_seq
        ):
            finish = "length"

        if finish is None:
            # Hold back partial UTF-8 (the decoder renders an incomplete
            # sequence as U+FFFD) and any tail that could start a stop.
            hold = 1 if new.endswith("�") else 0
            if r.stop:
                # Scan stop prefixes against the stable part only: trailing
                # replacement chars may re-render on the next token.
                stable = new.rstrip("�")
                pend = len(new) - len(stable)
                for s in r.stop:
                    for k in range(min(len(s) - 1, len(stable)), 0, -1):
                        if stable.endswith(s[:k]):
                            hold = max(hold, pend + k)
                            break
            if hold:
                new = new[: len(new) - hold]

        if not is_eos or new:
            # Every generated token posts exactly one event, even when all
            # its bytes are held back; an EOS posts only to flush held text.
            slot.emitted_len += len(new)
            handle._q.put(TokenEvent(kind="token", text=new, token_id=tok))
        if finish is not None:
            self._finish(slot_idx, finish)

    def _finish(self, slot_idx: int, reason: str) -> None:
        slot = self.slots[slot_idx]
        now = time.monotonic()
        t_first = slot.t_first or now
        h = slot.handle
        h._q.put(TokenEvent(
            kind="done",
            finish_reason=reason,
            prompt_tokens=slot.prompt_len,
            completion_tokens=len(slot.generated),
            timing_prompt_processing=t_first - slot.t_admit,
            timing_token_generation=now - t_first,
            timing_queue_wait=max(0.0, h.t_admit - h.t_submit),
        ))
        self._release(slot_idx)

    def _release(self, slot_idx: int) -> None:
        """Give a slot back: its chunked admission (if any), its adapter pin
        and its pages go with it. Every teardown path (finish, cancel,
        error, stop, preemption, loop death) comes through here."""
        self.slots[slot_idx] = None
        self.h_active[slot_idx] = False
        self._slot_release_adapter(slot_idx)
        if self._chunkings:
            self._chunkings = [st for st in self._chunkings if st["slot"] != slot_idx]
        if self._paged:
            self._pages_free(slot_idx)

    # ------------------------------------------------------------------ #
    # Multi-tenant LoRA adapters
    # ------------------------------------------------------------------ #

    def register_adapter(self, name: str, adapter_dir: str, weight: float = 1.0) -> None:
        """Register a PEFT-format adapter as a servable tenant. Metadata
        only (no disk read): the factors are fetched through the host tier
        and promoted into the device stacks at the first admission that
        names it. Idempotent for the same (dir, weight); rebinding a name to
        another source raises AdapterError (a tenant's identity stays fixed
        while its requests may be in flight), and so does a mixture-of-experts
        base, as in the JAX package: runtime adapters serve dense bases."""
        if self.cfg.is_moe:
            raise AdapterError(
                f"runtime LoRA adapters serve dense llama-family bases only ({self.cfg.name} "
                "is MoE) — merge at load via `lora_adapters` instead")
        with self._adapter_lock:
            prev = self._adapter_registry.get(name)
            if prev is not None:
                if prev["dir"] != adapter_dir or prev["weight"] != float(weight):
                    raise AdapterError(
                        f"adapter {name!r} is already registered from {prev['dir']!r} "
                        f"(weight={prev['weight']}) — unregister/rename instead of rebinding")
                return
            self._adapter_registry[name] = {"dir": adapter_dir, "weight": float(weight)}

    def adapter_names(self) -> list[str]:
        with self._adapter_lock:
            return sorted(self._adapter_registry)

    def _adapter_image(self, name: str, reg: dict) -> dict:
        """The host-tier factor image of one adapter: {rank, stacks: {key:
        (A [L, in, r], B [L, r, out]) f32 numpy}, bytes}. A hit moves to the
        LRU's end; a miss reads the adapter from disk and is inserted under
        adapter_cache_bytes, evicting the least recently used images. An
        image larger than the whole budget serves this promote and is not
        kept."""
        entry = self._adapter_host.get(name)
        if entry is not None:
            self._adapter_host.move_to_end(name)
            return entry
        rank, per_key = load_lora_factors(reg["dir"], reg["weight"], self.cfg)
        dims = lora_target_dims(self.cfg)
        L = self.cfg.num_layers
        stacks: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        nbytes = 0
        for key, layers_d in per_key.items():
            d_in, d_out = dims[key]
            a = np.zeros((L, d_in, rank), np.float32)
            b = np.zeros((L, rank, d_out), np.float32)
            for li, (a_t, b_t) in layers_d.items():
                r = a_t.shape[1]
                a[li, :, :r] = a_t
                b[li, :r, :] = b_t
            stacks[key] = (a, b)
            nbytes += a.nbytes + b.nbytes
        entry = {"rank": rank, "stacks": stacks, "bytes": nbytes}
        self._adapter_host[name] = entry
        self._adapter_host_bytes += nbytes
        self.m_adapter_fetches += 1
        budget = self.ecfg.adapter_cache_bytes
        # The new image is last, so the front is never it while len > 1.
        while self._adapter_host_bytes > budget and len(self._adapter_host) > 1:
            _victim, gone = self._adapter_host.popitem(last=False)
            self._adapter_host_bytes -= gone["bytes"]
        if self._adapter_host_bytes > budget:
            # The image alone exceeds the budget: serve it, do not keep it.
            self._adapter_host_bytes -= self._adapter_host.pop(name)["bytes"]
        return entry

    def _lora_rebuild(self, keys: tuple, na: int, rank: int) -> None:
        """(Re)allocate the stacked device factors at (keys, na rows, rank)
        in the model dtype and copy every resident adapter's rows and ranks
        from the old stacks. Row 0 is the all-zero null adapter. Rows grow
        by doubling, capped at max_slots + 1 (_adapter_acquire)."""
        dims = lora_target_dims(self.cfg)
        dt = llama.torch_dtype(self.cfg.dtype)
        L = self.cfg.num_layers
        old = self._lora_tree or {}
        new_tree: dict = {}
        for key in keys:
            d_in, d_out = dims[key]
            a = torch.zeros((L, na, d_in, rank), dtype=dt, device=self.device)
            b = torch.zeros((L, na, rank, d_out), dtype=dt, device=self.device)
            o = old.get(key)
            if o is not None:
                ona, orank = o["a"].shape[1], o["a"].shape[3]
                a[:, :ona, :, :orank] = o["a"]
                b[:, :ona, :orank, :] = o["b"]
            new_tree[key] = {"a": a, "b": b}
        self._lora_tree = new_tree
        # Graphs that captured the old stacks would read freed memory.
        self._graph_cache = {k: v for k, v in self._graph_cache.items() if k[3] is None}
        self._lora_keys = keys
        self._lora_rank = rank
        while len(self._adapter_rows) < na:
            self._adapter_rows.append(None)
            self._adapter_last.append(0.0)
        if len(self._adapter_refs) < na:
            refs = np.zeros((na,), np.int32)
            refs[: len(self._adapter_refs)] = self._adapter_refs
            self._adapter_refs = refs

    def _lora_write_row(self, row: int, image: dict) -> None:
        """Write one host factor image into device row `row`, in place, for
        every stacked key: absent keys write zeros (a recycled row never
        keeps the previous tenant's factors) and a smaller rank is padded
        with zeros. Values are cast to the model dtype from f32."""
        dims = lora_target_dims(self.cfg)
        L, rank = self.cfg.num_layers, self._lora_rank
        for key in self._lora_keys:
            d_in, d_out = dims[key]
            ent = self._lora_tree[key]
            st = image["stacks"].get(key)
            if st is None:
                ent["a"][:, row] = 0
                ent["b"][:, row] = 0
                continue
            a_np, b_np = st
            r = a_np.shape[-1]
            a_t = torch.zeros((L, d_in, rank), dtype=torch.float32)
            b_t = torch.zeros((L, rank, d_out), dtype=torch.float32)
            a_t[:, :, :r] = torch.from_numpy(a_np)
            b_t[:, :r, :] = torch.from_numpy(b_np)
            ent["a"][:, row] = a_t.to(device=self.device, dtype=ent["a"].dtype)
            ent["b"][:, row] = b_t.to(device=self.device, dtype=ent["b"].dtype)

    def _adapter_acquire(self, name: str) -> int:
        """Pin `name` into a device adapter row and return the row (the only
        place a row is claimed; loop thread only). A resident adapter just
        gains a reference; otherwise its image is fetched through the host
        tier and promoted into a free row, a new row (doubling, up to
        max_slots + 1), or the least recently used UNPINNED row. A row with
        live references is never evicted: AdapterError when all are."""
        with self._adapter_lock:
            reg = self._adapter_registry.get(name)
        if reg is None:
            raise AdapterError(f"unknown adapter {name!r} — register_adapter() first")
        if name in self._adapter_rows:
            row = self._adapter_rows.index(name)
        else:
            image = self._adapter_image(name, reg)
            keys = tuple(sorted(set(self._lora_keys) | set(image["stacks"])))
            rank = max(self._lora_rank, image["rank"], 1)
            cap = self.ecfg.max_slots + 1
            na = len(self._adapter_rows)
            row = next((i for i in range(1, na) if self._adapter_rows[i] is None), None)
            if row is None and na < cap:
                row = max(1, na)
                na = min(cap, max(2, na * 2))
            if row is None:
                cands = [i for i in range(1, na)
                         if self._adapter_rows[i] is not None and self._adapter_refs[i] == 0]
                if cands:
                    row = min(cands, key=lambda i: self._adapter_last[i])
                    self._adapter_rows[row] = None
                    self.m_adapter_evictions += 1
            if row is None:
                raise AdapterError("every device adapter row is pinned by an active request — "
                                   "retry when traffic drains or raise max_slots")
            if keys != self._lora_keys or rank != self._lora_rank or na != len(self._adapter_rows):
                self._lora_rebuild(keys, na, rank)
            self._lora_write_row(row, image)
            self._adapter_rows[row] = name
            self.m_adapter_promotes += 1
        self._adapter_refs[row] += 1
        self._adapter_last[row] = time.monotonic()
        return row

    def _adapter_unpin(self, row: int) -> None:
        """Drop one reference on a device adapter row (the only decrement;
        loop thread only). Row 0 is never pinned; an underflow is logged and
        clamped, as a double page release is."""
        if row <= 0 or row >= len(self._adapter_refs):
            return
        if self._adapter_refs[row] <= 0:
            log.error("adapter refcount underflow at device row %d ignored", row)
            self._adapter_refs[row] = 0
            return
        self._adapter_refs[row] -= 1

    def _slot_release_adapter(self, slot_idx: int) -> None:
        """Unpin a slot's adapter row (any teardown path, via _release)."""
        row = int(self.h_adapter[slot_idx])
        if row:
            self.h_adapter[slot_idx] = 0
            self._adapter_unpin(row)
