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
  to the host in ONE device-to-host copy.
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
- Weights may be quantized (`Engine(..., quantization="int8"|"int4")`
  quantizes plain params where they lie; a tree already quantized, e.g. by
  `load_hf_checkpoint(quantize=)`, is served as it is): decode-shape
  matmuls run the fused dequant kernels. The KV cache may be stored in fp8
  (`kv_cache_dtype`), and a paged fp8 pool may carry a per-head scale
  (`kv_scale`) so large K / V stay inside the format's range.
- Streaming is UTF-8-safe incremental detokenization with stop-sequence
  hold-back; every generated token posts exactly one event, and every
  request ends with exactly one terminal event (done or error) on every
  exit path: finish, cancel, stop(), a failed dispatch, loop death.

Each slot samples from its own torch.Generator, seeded from the request's
seed (or from the OS when it has none), so a seeded request gives the same
bytes whatever else shares the batch.

Not ported yet (ROADMAP Queue A): pipelined dispatch and CUDA graphs,
the prefix cache, the host swap tier (preemption always recomputes),
hierarchical page tables, chunked prefill over a dense cache, grammar,
logprobs, speculative decoding, fork / n>1, LoRA, tp, deadlines.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

import numpy as np
import torch

from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models import llama
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.quant import is_prequantized, quantize_params
from localai_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplingParams,
    sample,
    sample_greedy,
    sample_simple,
    update_counts,
)

log = logging.getLogger("localai_tpu_torch.engine")


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
    # Seeds the idle slots' generators (a slot takes its request's seed at
    # admission).
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
    # Set by the engine on a request it requeued after preempting it: what
    # the re-admitted slot restores (generated tokens, streamed text, the
    # sampler's generator state). Callers leave it None.
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
        self._check_paged_config(ecfg)
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
        self.generators = [self._generator(ecfg.base_seed + i) for i in range(B)]
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
        # A decode block could not grow some slot: admissions pause until
        # growth succeeds (the youngest slot is preempted meanwhile).
        self._growth_blocked = False
        # In-progress chunked admissions, oldest first: each holds a
        # reserved, inactive slot and its page row, withheld from h_ptable.
        self._chunkings: list[dict] = []
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
                "ported yet (ROADMAP Queue A items 3 and 7); use kv_pages > 0")

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g

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
        return {
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
            "weight_bytes": float(self._weight_bytes()),
            "admit_wait_ms": float(self._admit_wait_ewma * 1000.0),
            "loop_dead": 1.0 if self._loop_dead is not None else 0.0,
        }

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
        generator per request; a preempted request continues its saved
        generator state."""
        m, V = len(group), self.cfg.vocab_size
        samp = np.zeros((len(_SAMPLING_FIELDS), m), np.float32)
        bias_rows = np.zeros((m, V), np.float32)
        gens = []
        for j, (r, _h) in enumerate(group):
            for fi, k in enumerate(_SAMPLING_FIELDS):
                samp[fi, j] = getattr(r, k)
            for tid, bval in r.logit_bias.items():
                if 0 <= int(tid) < V:
                    bias_rows[j, int(tid)] = bval
            # Unseeded requests draw a random seed (reference default -1).
            g = self._generator(r.seed & 0x7FFFFFFF if r.seed is not None
                                else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF)
            if r.resume is not None:
                g.set_state(r.resume["gen_state"])
            gens.append(g)
        return samp, bias_rows, gens

    def _install_first(self, logits, prompt, lens, samp, bias_rows, gens, slot_ids):
        """Sample each admitted prompt's first token and install the slots'
        device state: penalty counts (prompt + first token), bias row, the
        token and its position. prompt [m, S] right-padded to lens [m].
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
        toks = sample(logits, [g if t > 0 else None for g, t in zip(gens, samp[0])],
                      sp, rows, bias_rows)
        rows[torch.arange(m, device=dev), toks] += 1
        sl = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        self.counts[sl] = rows
        self.bias[sl] = bias_rows
        self.d_tokens[sl] = toks
        self.d_positions[sl] = lens
        return toks

    def _claim_slot(self, s: int, request: GenRequest, handle: RequestHandle,
                    generator: torch.Generator, t_admit: float) -> None:
        """Host state of a freshly admitted slot (after its admission ran)."""
        for k in _SAMPLING_FIELDS:
            self.h_sampling[k][s] = getattr(request, k)
        self.generators[s] = generator
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
        prompt = np.zeros((m, bucket), np.int64)
        lens = np.zeros((m,), np.int64)
        for j, (r, _h) in enumerate(group):
            prompt[j, : len(r.prompt_ids)] = r.prompt_ids
            lens[j] = len(r.prompt_ids)
        samp, bias_rows, gens = self._request_controls(group)
        dev = self.device
        table_rows = None
        if self._paged:
            for (r, _h), s in zip(group, slot_ids):
                if self._pages_alloc(s, self._pages_needed(r)) is None:
                    for s2 in slot_ids:  # the planner counted these pages
                        self._pages_free(s2)
                    raise RuntimeError("KV page pool exhausted at admission")
            table_rows = torch.from_numpy(self.h_ptable[slot_ids]).to(dev)
        d_prompt, d_lens = torch.from_numpy(prompt).to(dev), torch.from_numpy(lens).to(dev)
        try:
            logits, ks, vs = llama.prefill(self.cfg, self.params, d_prompt, d_lens)
            for j, s in enumerate(slot_ids):
                if table_rows is not None:
                    llama.write_prefill_to_pool(self.cache, table_rows[j], ks, vs, j,
                                                kv_scale=self._kv_scales)
                else:
                    llama.write_prefill_to_cache(self.cache, ks[:, j:j + 1], vs[:, j:j + 1], s)
            toks = self._install_first(logits, d_prompt, d_lens, samp, bias_rows, gens, slot_ids)
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
            self._claim_slot(s, r, handle, gens[j], t0)
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
        """One n-step decode block: grow the pages it writes, dispatch, one
        host copy, then stream. Returns False, having dispatched nothing,
        when the page pool cannot cover the block's growth."""
        n = self._pick_block_size()
        if not self._grow_for_decode(n):
            return False
        t0 = time.monotonic()
        cfg, B, S = self.cfg, self.ecfg.max_slots, self.ecfg.max_seq
        dev = self.device
        act = self.h_active.copy()
        hs = self.h_sampling
        idx = np.flatnonzero(act)
        sampled = hs["temperature"][idx] > 0
        needs_filter = bool(np.any(sampled & (
            (hs["top_k"][idx] > 0) | (hs["top_p"][idx] < 1) | (hs["min_p"][idx] > 0))))
        variant = "filtered" if needs_filter else ("simple" if sampled.any() else "greedy")
        ptable = None
        read_cache = self.cache
        if self._paged:
            # Each slot walks its own pages, bounded by its own position.
            ptable = torch.from_numpy(self.h_ptable).to(dev)
        else:
            # Read-side KV window: the smallest power of two (>= 256)
            # covering every active slot's pre-block rows; the cache holds
            # nothing the block reads past it, so attention streams less.
            maxpos = max(self.slots[i].prompt_len + self.slots[i].scheduled for i in idx)
            win = self._KV_WIN_MIN
            while win < min(maxpos, S):
                win *= 2
            if win < S:
                read_cache = llama.KVCache(k=self.cache.k[:, :, :win], v=self.cache.v[:, :, :win])

        pack = np.stack([act.astype(np.float32)] + [hs[k] for k in _SAMPLING_FIELDS])
        d_pack = torch.from_numpy(pack).to(dev)  # the block's control rows, one copy
        active = d_pack[0] > 0
        act_i32 = active.to(torch.int32)
        sp = _sampling_params(d_pack[1:])
        gens = [self.generators[i] if act[i] and hs["temperature"][i] > 0 else None
                for i in range(B)]
        shape = (cfg.num_layers, B, n, cfg.num_kv_heads, cfg.head_dim_)
        local_k = torch.zeros(shape, dtype=self._local_dtype, device=dev)
        local_v = torch.zeros(shape, dtype=self._local_dtype, device=dev)
        tokens, positions = self.d_tokens, self.d_positions
        if self._paged:
            # Idle slots walk no pages (limit 0) and write into SCRATCH.
            positions = torch.where(active, positions, 0)
        start_pos = positions
        out = torch.empty((n, B), dtype=torch.int64, device=dev)
        for step in range(n):
            logits, local_k, local_v = llama.decode_step_windowed(
                cfg, self.params, tokens, positions, read_cache, local_k, local_v, step,
                ptable=ptable, kv_scale=self._kv_scales)
            if variant == "greedy":
                nxt = sample_greedy(logits, sp, self.counts, self.bias)
            elif variant == "simple":
                nxt = sample_simple(logits, gens, sp, self.counts, self.bias)
            else:
                nxt = sample(logits, gens, sp, self.counts, self.bias)
            update_counts(self.counts, nxt, act_i32)
            nxt = torch.where(active, nxt, 0)
            out[step] = nxt
            # Clamp so idle / overshooting slots stay inside their own rows.
            positions = torch.clamp(positions + 1, max=S - 1)
            tokens = nxt
        if self._paged:
            llama.write_block_to_pool(self.cache, ptable, local_k, local_v, start_pos,
                                      kv_scale=self._kv_scales)
        else:
            llama.write_block_to_cache(self.cache, local_k, local_v, start_pos)
        self.d_tokens, self.d_positions = tokens, positions
        toks = out.cpu().numpy()  # the block's one device-to-host copy
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
        [MP], or None, changing nothing, when the pool cannot cover it."""
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
        claim the same page)."""
        for p in pages:
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
        self._pages_release(self._slot_pages[slot_idx])
        self._slot_pages[slot_idx] = []
        # The slot stays in every decode block's scatter until re-admitted:
        # its stale table must not alias pages handed to the next request.
        self.h_ptable[slot_idx] = self._scratch_page

    # ------------------------------------------------------------------ #
    # Chunked prefill (paged pool): a long prompt admits chunk by chunk,
    # one chunk between two decode blocks. Mid chunks write K/V only; the
    # final chunk also samples the first token and installs the slot.
    # ------------------------------------------------------------------ #

    def _chunkable(self, request: GenRequest) -> bool:
        C = self.ecfg.prefill_chunk
        return bool(C) and self._paged and len(request.prompt_ids) > C

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
        # prefill owns. The chunk dispatches carry the real row.
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
            self.cache, torch.from_numpy(st["table_row"][None]).to(dev),
            with_logits=with_logits, kv_scale=self._kv_scales)
        self.m_prefill_chunks += 1
        return logits

    def _dispatch_chunk_final(self, st: dict) -> None:
        """The last <= prefill_chunk tokens: prefill, first-token sample and
        slot activation."""
        request, handle, s = st["request"], st["handle"], st["slot"]
        ids = st["ids"]
        logits = self._dispatch_chunk(st, len(ids) - st["offset"], with_logits=True)
        samp, bias_rows, gens = self._request_controls([(request, handle)])
        dev = self.device
        full = torch.as_tensor(np.asarray([ids], np.int64)).to(dev)
        toks = self._install_first(logits, full, torch.tensor([len(ids)], device=dev),
                                   samp, bias_rows, gens, [s])
        tok = int(toks.tolist()[0])  # the admission's one device-to-host copy
        # Publish the real table: blocks from here on read and write it.
        self.h_ptable[s] = st["table_row"]
        self.m_chunked_admits += 1
        self._claim_slot(s, request, handle, gens[0], st["t0"])
        self._post_first(s, tok)

    # ------------------------------------------------------------------ #
    # Preemption by recompute
    # ------------------------------------------------------------------ #

    def _preempt_youngest(self) -> None:
        """Free the youngest live slot's pages so growth-blocked older slots
        can go on. The victim's request is requeued at the head as prompt +
        generated, under the same handle and with no terminal event; its
        re-admission recomputes the KV and continues the stream
        (_apply_resume). Recompute is the only policy: the host swap tier
        is not ported."""
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
            "gen_state": self.generators[victim].get_state(),
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
        """Give a slot back: its chunked admission (if any) and its pages go
        with it."""
        self.slots[slot_idx] = None
        self.h_active[slot_idx] = False
        if self._chunkings:
            self._chunkings = [st for st in self._chunkings if st["slot"] != slot_idx]
        if self._paged:
            self._pages_free(slot_idx)
