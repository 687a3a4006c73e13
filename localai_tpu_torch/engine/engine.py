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
  cover the growth (after evicting prefix spans) the youngest slot is
  preempted (kv_preempt): swapped to pinned host memory and restored byte
  for byte at re-admission, or recomputed (prompt + generated requeued at
  the head under the same handle, its sampler state kept). Decode
  attention walks each slot's own pages (the ragged paged-attention
  kernel on the card).
- Prefix cache (`prefix_cache_entries`): an admission whose prompt shares
  a prefix with a stored span (a system prompt, the earlier turns of a
  chat) prefills only its tail. A dense hit copies the span's rows into
  the slot and runs `prefill_tail` against them; a paged hit maps the
  span's pages read-only into the slot's table (copy on write, table
  pages too) and runs the tail as chunks from the page-aligned match, so
  B2's prefix walk reads the shared pages in place. Spans evicted for pool
  pressure go to the pinned host tier (`kv_swap_bytes`) and swap back in
  at a later hit.
- With `prefill_chunk > 0` prompts longer than a chunk admit chunk by
  chunk: at most one chunk runs between decode blocks. On a paged pool
  each writes its K/V straight into the slot's pages and the slot's table
  is kept off the decode blocks (SCRATCH) until the final chunk; on a
  dense cache each runs `prefill_tail` over the slot's written rows and
  writes its rows after them, and the slot's carried position is pinned
  at max_seq - 1 so the decode blocks' idle writes land past them. The
  final chunk samples the first token and installs the slot.
- Logprobs (`GenRequest.logprobs` = N): every token event carries the
  sampled token's logprob and the top N of log_softmax(logits + bias),
  the model's distribution before penalties, temperature and the grammar
  mask. A decode block with such a slot computes the top LOGPROB_TOPK in
  its graph and brings them back in its one host read.
- Tree sampling: `submit_fork(requests)` admits a group of same-prompt
  requests (n > 1, best_of) with ONE prefill; each branch then addrefs
  the primary's full prompt pages, gets a private copy of its partly
  filled last page and samples its own first token from the primary's
  final logits, so a seeded branch gives the bytes its clone would.
  Branches that cannot fork (no free slot, pool pressure) and dense
  engines clone. `fork(handle, n)` forks a live stream mid-way.
- Bounded admission: `queue_timeout_s` sheds requests left pending that
  long, `deadline_s` (per request or the engine default) sheds pending and
  cancels active ones; `cancel_all()` ends every request.
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
- Grammar-constrained decoding (`GenRequest.grammar`: a JSON-schema
  GrammarConstraint or a GbnfConstraint, functions/): a schema that
  compiles to a token-level DFA (functions/dfa.py) runs on the device. Its
  tables sit in persistent device buffers, the first token is masked to
  the start state's legal set, and every decode block masks each
  constrained slot's logits to its state's row and advances the state
  after sampling (ops/grammar.py), inside the block's graph and at full
  depth: "fast" mode gathers an [S, V] next-state table (automata of at
  most 256 states), "walk" mode walks the token's char classes. Other
  slots ride the FREE state unmasked. The rest (a schema still compiling
  on its daemon thread, a second schema while the first has live slots,
  a recursive grammar, a resumed request) take the host candidate walk:
  one-step blocks that also return each slot's top 64 ids, from which the
  host picks the best legal token; a pick other than the sampled token
  replaces the slot's next input (d_tokens). Grammar requests admit
  alone; preemption takes a grammar slot last, and always recomputes it.
- Speculative decoding (`spec_mode`, docs/SPECULATIVE.md): a draft model
  (`Engine(draft_cfg=, draft_params=, n_draft=)`), prompt lookup (n-gram
  drafts from each slot's own history, on the host) or self-draft (the
  target's first layers) proposes up to n_draft tokens a slot; one
  `decode_chunk` of the target scores them all, and an accept scan keeps
  the output exactly the target's: greedy ids equal the plain engine's,
  sampled ones follow its distribution (accept with probability
  min(1, p/q), else draw from the residual, on noise streams of their own:
  ops/sampling.verify_step). Each slot's draft length follows its
  acceptance EWMA, bucketed into `spec_draft_buckets`; a round in which no
  slot drafts is a plain block. A round is one CUDA graph per shape on the
  card, like a decode block. Logprob and host-walk grammar slots take plain
  blocks; a draft model refuses adapters, always recomputes on preemption
  and clones fork groups.
- Streaming is UTF-8-safe incremental detokenization with stop-sequence
  hold-back; every generated token posts exactly one event, and every
  request ends with exactly one terminal event (done or error) on every
  exit path: finish, cancel, stop(), a failed dispatch, loop death.
- Observability (observe/): the loop owns a bounded event journal
  (`trace_journal_events`; `journal`), appended lock-free at every
  lifecycle step and coalesced once a loop window with its host-phase
  vector (engine/runtime.LoopPhases); a request with a `request_id` or a
  `traceparent` records a span tree in observe/trace.STORE, ended by its
  one terminal event. With `trace_fence` each block's device time comes
  from a CUDA event pair read after the block's own host read. When the
  loop dies, every pool page and host-tier byte is released before any
  caller unblocks, and a postmortem JSON (journal tail, host state only)
  goes to `postmortem_dir` (`postmortem_path`).
- Embeddings and rerank: `embed(ids_batch)` (mean-pooled, L2-normed
  final hidden states) and `rerank(query_ids, docs_ids)` (each document's
  mean log-likelihood given the query) run one eager full-sequence
  forward at a prefill bucket, on the loop thread between two of its
  iterations (`_on_loop`), and return numpy arrays.
- Fault sites (testing/faults): one `faults.fire(site)` at each seam the
  JAX package hooks, all in host code before a graph capture or replay; a
  seeded FaultSchedule drives the containment paths.

Sampling noise is a pure function of the slot's seed (the request's, or
one drawn from the OS when it has none), kept on the device, and of the
position of the token being drawn (ops/sampling.gumbel_noise). A seeded
request therefore gives the same bytes whatever else shares the batch,
whatever the block size, chunking or preemption, and a block holds no
generator state, so it can be captured. The reference's threefry streams
are not reproduced.

Not ported yet (ROADMAP Queue A): CUDA graphs of admission and prefill
chunks and pipelined dispatch with its control stager (item 1), the
export and import of prefix spans between replicas (the cluster, with
its mid-stream grammar failover, its fault sites and journal events; item
12), tp and sequence-parallel prefill with the `collective_dispatch`
fault site (item 14). The
reference's prefix_admit_async_compile has no counterpart: a cached
admission runs eagerly and compiles nothing; nor have its
LOCALAI_GRAMMAR_DFA, LOCALAI_QUEUE_TIMEOUT, LOCALAI_DEADLINE,
LOCALAI_FORK_SAMPLING and LOCALAI_SPEC_* switches: the engine reads no
environment variable (the server's LOCALAI_TRACE_JOURNAL,
LOCALAI_TRACE_FENCE and LOCALAI_POSTMORTEM_DIR arrive through
config/app_config.py and the manager).
"""

from __future__ import annotations

import copy
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
from localai_tpu_torch.engine import speclookup
from localai_tpu_torch.engine.runtime import DeadlineIndex, LoopPhases
from localai_tpu_torch.engine.weights import load_lora_factors, lora_target_dims
from localai_tpu_torch.models import llama
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.models.quant import is_prequantized, quantize_params
from localai_tpu_torch.functions import dfa as dfa_mod
from localai_tpu_torch.functions.dfa import MAX_TOK_LEN
from localai_tpu_torch.functions.gbnf import GbnfConstraint
from localai_tpu_torch.functions.jsonschema import GrammarConstraint
from localai_tpu_torch.observe import postmortem as opostmortem
from localai_tpu_torch.observe import trace as otrace
from localai_tpu_torch.observe.fence import DeviceFence
from localai_tpu_torch.observe.journal import EventJournal
from localai_tpu_torch.ops import grammar as _gr
from localai_tpu_torch.ops import ptable as _pt
from localai_tpu_torch.ops.sampling import (
    NEG_INF,
    STREAM_DRAFT,
    SamplingParams,
    gumbel_noise,
    processed_logprobs,
    sample,
    sample_greedy,
    sample_simple,
    update_counts,
    verify_step,
)
from localai_tpu_torch.testing import faults

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


# One side stream a device for every engine's first runs and graph
# captures, and a lock that keeps two engines' captures off it at once.
# cuBLAS keeps a workspace for every (handle, stream) it has run on (32 MiB
# on Hopper) for the life of the process: a stream of each engine's own
# would leak one workspace for every engine a crash-only restart loads.
_CAPTURE_STREAMS: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _multimodal(request: "GenRequest") -> bool:
    """An image span or m-rope streams."""
    return request.image_embeds is not None or request.mrope_positions is not None


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    with _CAPTURE_LOCK:
        stream = _CAPTURE_STREAMS.get(device)
        if stream is None:
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        return stream


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
    # Prefix cache (the reference's cache_prompt): an LRU of prefilled K/V
    # spans keyed by token prefixes. An admission whose prompt shares a
    # stored span's prefix (a system prompt, the earlier turns of a chat)
    # prefills only its tail. Dense entries are device copies of the rows;
    # paged entries hold references on the slot's full pages, which later
    # admissions map read-only. 0 disables.
    prefix_cache_entries: int = 8
    # Shortest prefix, in tokens, that is saved or matched: shorter ones
    # cost less to prefill again than to keep.
    prefix_cache_min: int = 32
    # Device bytes of stored spans. Eviction honours whichever of this and
    # prefix_cache_entries trips first; a larger span is not saved.
    prefix_cache_bytes: int = 1 << 30
    # What a decode block does when page growth finds the pool empty, once
    # prefix spans are evicted: preempt the youngest slot and
    #   "swap"      copy its pages to the host tier (kv_swap_bytes) and
    #               restore them byte for byte at re-admission;
    #   "recompute" drop them and re-admit prompt + generated through the
    #               ordinary prefill;
    #   "auto"      swap when the span fits a quarter of kv_swap_bytes,
    #               else recompute.
    kv_preempt: str = "auto"
    # Pinned host-RAM budget shared by preemption swap images and prefix
    # spans evicted from the pool (the prefix cache's host tier, which a
    # later hit swaps back in). 0 disables the tier: preemption recomputes.
    kv_swap_bytes: int = 256 << 20
    # Bounded admission: a request still pending after queue_timeout_s
    # seconds is shed with an error event (it would be admitted into a
    # saturated engine only to blow its caller's timeout anyway).
    # deadline_s is the end-to-end deadline of requests that carry none of
    # their own (GenRequest.deadline_s): past it a pending request is shed
    # and an active one cancelled. 0 disables each.
    queue_timeout_s: float = 0.0
    deadline_s: float = 0.0
    # Tree sampling: submit_fork() admits a same-prompt group with one
    # prefill and forks the slot per branch (paged pools only). False
    # admits every branch as its own clone (the same bytes, N prefills).
    fork_sampling: bool = True
    # Speculative decoding (docs/SPECULATIVE.md), the draft source:
    #   "off"           plain decode blocks only;
    #   "draft_model"   a separate draft checkpoint (the Engine's draft_cfg,
    #                   draft_params and n_draft);
    #   "prompt_lookup" per-slot n-gram matches over prompt + output, mined
    #                   on the host (engine/speclookup.py);
    #   "self_draft"    the target's own first self_draft_layers layers and
    #                   head, over a dense scratch KV of those layers;
    #   "auto"          draft_model when a draft is given, else off (the
    #                   model-free modes are opt-in: they change which noise
    #                   a sampled request draws).
    spec_mode: str = "auto"
    # self_draft's layer count; 0 = num_layers // 4 (at least 1).
    self_draft_layers: int = 0
    # How far a slot's acceptance EWMA moves toward each round's accepted /
    # drafted ratio; the EWMA sets the slot's next draft length (cold slots
    # draft 0 and ride the plain blocks).
    spec_accept_ewma: float = 0.4
    # A round's draft window is the smallest of these covering its longest
    # per-slot draft (one graph per bucket); () = {0, n_draft // 2, n_draft}.
    spec_draft_buckets: tuple[int, ...] = ()
    # Request-lifecycle event journal: capacity (in events) of the loop's
    # preallocated ring — queued / admitted / chunk / decode-block /
    # preempt / swap / resume / prefix-hit / terminal events plus one
    # coalesced record a loop window. Appends are lock-free from the loop
    # thread, O(1) and never touch the device. 0 disables the journal (and
    # with it /debug/timeline and the postmortem's journal tail).
    trace_journal_events: int = 4096
    # Fenced per-block device time: each decode block or round is
    # bracketed by a CUDA event pair whose elapsed time (read after the
    # block's own host read, so no extra synchronisation) rides the
    # journal's loop_iter record. A measurement mode; 0.0 on the CPU.
    trace_fence: bool = False
    # Flight-recorder directory: where the dying loop writes its
    # postmortem JSON (journal tail + host-state snapshot). "" = a stable
    # tempdir child (observe/postmortem.default_dir).
    postmortem_dir: str = ""

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
    # Grammar-constrained decoding (functions.jsonschema.GrammarConstraint
    # or functions.gbnf.GbnfConstraint): every emitted token keeps the text
    # a legal prefix, and EOS is legal only once the grammar is complete.
    # The object is this request's own machine (the host walk advances it).
    # Penalty counts track the sampled, not an overridden, token.
    grammar: Optional[Any] = None
    # Top-N logprobs per generated token (0 = off, at most LOGPROB_TOPK):
    # every token event carries the sampled token's logprob and the top N
    # alternatives of log_softmax(logits + bias), the model's distribution
    # before penalties, temperature and the grammar mask (OpenAI's).
    logprobs: int = 0
    # Multimodal (VLM): projected image features [N, hidden] (a tensor on
    # the engine's device, or anything torch.as_tensor takes) injected over
    # prompt_ids[image_offset : image_offset + N] at prefill (llava's
    # semantics; the placeholder ids under the span are ignored). Image
    # requests admit alone and single-shot, never fork and never touch the
    # prefix cache.
    image_embeds: Optional[Any] = None
    image_offset: int = 0
    # Qwen2-VL m-rope: [3, len(prompt_ids)] (t, h, w) position streams
    # (models/qwen2_vl.mrope_positions_for_span). None = standard rope.
    mrope_positions: Optional[Any] = None
    # End-to-end deadline in seconds from submit(): pending past it, the
    # request is shed with an error event; active, it is cancelled. 0 =
    # the engine default (EngineConfig.deadline_s), which may be 0 too.
    deadline_s: float = 0.0
    # Request-lifecycle tracing: a caller-visible request id (the OpenAI
    # response id at the HTTP layer) keys the span tree at
    # /debug/trace/{request_id}; traceparent is the W3C header value the
    # trace id comes from. Both empty = untraced (library callers pay
    # nothing but a journal id).
    request_id: str = ""
    traceparent: str = ""
    # Set by submit_fork() on a group's primary: [(branch request, branch
    # handle), ...] forked off its slot right after its prefill. Every path
    # that ends a pending primary also ends or requeues these. Callers
    # leave it None.
    fork_group: Optional[list] = None
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
    # Filled on "token" when the request asked for logprobs.
    logprob: Optional[float] = None
    top_logprobs: Optional[list] = None  # [(token_id, logprob)] descending


class _EventQueue(queue.Queue):
    """Token-event queue that mirrors TERMINAL events into the request's
    trace. Every path that ends a stream — finish, cancel, deadline sweeps,
    loop death, stop() — puts its terminal event here, so each traced
    request records exactly one terminal (RequestTrace.terminal is
    idempotent; stop()'s duplicate done events are ignored). Untraced
    requests pay one attribute check per event."""

    def __init__(self) -> None:
        super().__init__()
        self.trace: Optional[otrace.RequestTrace] = None

    def put(self, item, *args, **kwargs):
        tr = self.trace
        if tr is not None and getattr(item, "kind", None) in ("done", "error"):
            tr.terminal(item)
        super().put(item, *args, **kwargs)


class RequestHandle:
    """Streaming consumer side of a submitted request."""

    def __init__(self) -> None:
        self._q: _EventQueue = _EventQueue()
        self.cancelled = threading.Event()
        self.t_submit: float = 0.0
        self.t_admit: float = 0.0
        # Absolute monotonic deadline (submit + deadline_s), or None.
        self.deadline: Optional[float] = None
        # The journal's request id (the request's request_id, else one
        # made from the handle) and the span tree (None = untraced).
        self.rid: str = ""
        self.trace: Optional[otrace.RequestTrace] = None

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
    # The grammar runs on the device DFA in this mode ("fast" | "walk"), or
    # False: no grammar, or the host candidate walk.
    dfa: Any = False


def pad_rows(rows: list[list[int]], S: int) -> tuple[np.ndarray, np.ndarray]:
    """[N, S] int64 right-padded ids (each row cut to S) and their lengths."""
    toks = np.zeros((len(rows), S), np.int64)
    lens = np.zeros((len(rows),), np.int64)
    for i, r in enumerate(rows):
        r = list(r)[:S]
        toks[i, :len(r)] = r
        lens[i] = len(r)
    return toks, lens


class _LoopJob:
    """One call another thread hands the loop thread (`Engine._on_loop`):
    the loop runs it between two iterations and sets `done` with its
    result or its error."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn) -> None:
        self.fn = fn
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class Engine:
    """Persistent multi-slot generation engine for one loaded model."""

    _KV_WIN_MIN = 256  # smallest read-side KV window (doubles up to max_seq)
    GRAMMAR_TOPK = 64  # candidates a host-walk step returns per slot
    LOGPROB_TOPK = 20  # OpenAI caps top_logprobs at 20
    # Device DFA buffers grow through these buckets (states, char classes),
    # so one captured graph serves every table set that fits.
    _DFA_STATE_BUCKETS = (64, 256, 1024, 3073)
    _DFA_CLASS_BUCKETS = (128, 256)
    # Acceptance-aware speculation: a slot whose acceptance EWMA falls below
    # the floor drafts 0 (plain decode); every PROBE_EVERY cold rounds it
    # tries the smallest nonzero bucket, so a stream that turned
    # predictable warms back up. A model-free plan in which no slot drafts
    # caps the plain block at REPLAN_BLOCK steps, so the scheduler plans
    # again soon.
    _SPEC_EWMA_FLOOR = 0.15
    _SPEC_PROBE_EVERY = 32
    _SPEC_REPLAN_BLOCK = 16

    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        tokenizer,
        engine_cfg: Optional[EngineConfig] = None,
        device=None,
        quantization: str = "",
        draft_cfg: Optional[ArchConfig] = None,
        draft_params: Any = None,
        n_draft: int = 5,
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
        if ecfg.queue_timeout_s < 0 or ecfg.deadline_s < 0:
            raise ValueError("queue_timeout_s / deadline_s must be >= 0")
        if ecfg.adapter_cache_bytes < 0:
            raise ValueError("adapter_cache_bytes must be >= 0")
        if ecfg.kv_preempt not in ("swap", "recompute", "auto"):
            raise ValueError(f"kv_preempt={ecfg.kv_preempt!r}: use swap|recompute|auto")
        if ecfg.trace_journal_events < 0:
            raise ValueError("trace_journal_events must be >= 0 (0 = off)")
        self._check_paged_config(ecfg)
        self._check_long_context(cfg, ecfg)
        if (cfg.attention_sink, cfg.attention_window) != (ecfg.attention_sink,
                                                          ecfg.attention_window):
            # The model functions read the knobs from the (frozen) ArchConfig.
            cfg = dataclasses.replace(cfg, attention_sink=ecfg.attention_sink,
                                      attention_window=ecfg.attention_window)
            self.cfg = cfg
        cfg = self._check_spec(cfg, draft_cfg, n_draft)
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
        # Speculative decoding's device state: the draft model's dense cache
        # (d_cache) or the self-draft scratch over the target's first layers
        # (sd_cache), [L_draft, B, S, K, Hd] in the draft's dtype. A slot's
        # rows are brought up to date before a round whenever they lag its
        # position (h_dsync: the position they hold rows below, -1 = none):
        # a new slot, or plain blocks in between.
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.d_cache = self.sd_cache = None
        if draft_cfg is not None:
            llama.check_supported(draft_cfg)
            if draft_params["embed"].device.type != self.device.type:
                raise ValueError(f"draft params live on {draft_params['embed'].device}, "
                                 f"engine device is {self.device}")
            self.draft_params = draft_params
            self.d_cache = llama.KVCache.zeros(draft_cfg, B, S, device=dev)
        if self._spec_mode == "self_draft":
            self.sd_cache = llama.KVCache.zeros(dataclasses.replace(
                cfg, num_layers=cfg.self_draft_layers), B, S, device=dev)
        self.h_dsync = np.full((B,), -1, np.int64)
        # Acceptance-aware scheduling (loop thread only): each slot's EWMA of
        # accepted / drafted (optimistic start), its last draft length and
        # probe counter, and its prompt-lookup suffix index ((slot, index,
        # tokens fed) or None).
        self.h_accept_ewma = np.ones((B,), np.float32)
        self.h_draft_len = np.zeros((B,), np.int32)
        self._spec_probe = np.zeros((B,), np.int32)
        self._lookup: list[Optional[tuple]] = [None] * B
        self.m_spec_rounds = 0  # slot rounds that emitted
        self.m_spec_dispatches = 0  # rounds run
        self.m_spec_accepted = 0
        self.m_spec_drafted = 0
        self.m_spec_draft_len = 0.0
        self.m_spec_dlen_hist: dict[int, int] = {}
        self.m_spec_syncs = 0  # slots whose draft rows were brought up to date
        self.m_spec_draft_prefills = 0  # draft-model prefill calls of those syncs
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
            self._kv_scales = torch.full((2, cfg.cache_kv_heads), float(ecfg.kv_scale),
                                         dtype=torch.float32, device=dev)
            self._local_dtype = model_dtype
        self.counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.bias = torch.zeros((B, V), dtype=torch.float32, device=dev)
        self.d_tokens = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.d_positions = torch.zeros((B,), dtype=torch.int64, device=dev)
        # m-rope (Qwen2-VL): each slot decodes with rope at its position +
        # its delta (max(pos3) + 1 - prompt length after an image prefill,
        # 0 for text). The device buffer is written in place where a slot
        # is installed, and the block body (its graph) reads it; the host
        # mirror rides swap records. None on other models.
        self._mrope = bool(cfg.mrope_section)
        self.h_rope_delta = np.zeros((B,), np.int64)
        self.d_rope_delta = (torch.zeros((B,), dtype=torch.int64, device=dev)
                             if self._mrope else None)
        # Each slot's sampling seed (a draw's noise is a pure function of
        # the seed and the drawn token's position) and its host mirror.
        self.d_seed = torch.arange(B, dtype=torch.int64, device=dev) + ecfg.base_seed
        self.h_seed = np.arange(B, dtype=np.int64) + ecfg.base_seed
        # Grammar: each slot's DFA state (row 0 = FREE) and whether it is
        # DFA-constrained (h_gmask, staged with every block). The active
        # table set (_dfa: key, mode, host tables) lives in the grow-only
        # device buffers _g_mask [S, ceil(V/8)] u8, _g_trans [S, C] i16,
        # _g_next [S_fast, V] i16 and _g_cls [V, MAX_TOK_LEN] i16, whose
        # sizes _g_dims (S, C, S_fast) are part of a DFA block's graph key.
        self.d_gstate = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.h_gmask = np.zeros((B,), np.float32)
        self._dfa: Optional[dict] = None
        self._dfa_building: set = set()  # schema keys compiling off-thread
        self._g_dims = (0, 0, 0)
        self._g_mask = self._g_trans = self._g_next = self._g_cls = None
        # Buffer sizes and modes of the prewarmed schemas: warmup(grammar=
        # True) grows the buffers to them and captures those DFA blocks.
        self._dfa_want = (0, 0, 0)
        self._dfa_warm_modes: set = set()
        self._tok_strs: Optional[list[str]] = None
        self._tok_fp: Optional[str] = None
        self._fc_buckets: Optional[dict] = None
        self.m_dfa_tokens = 0
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
        # before a write through a shared one (_ptable_set): prefix entries
        # pin the table pages covering their spans, and a hit maps the full
        # ones into its directory. NTP covers a full directory for every
        # slot and every prefix entry, plus copies in flight, so claims do
        # not fail.
        self._l1_span = ecfg.kv_l1_span if self._paged else 0
        self._hier = self._l1_span > 0
        self._ml1 = -(-max(self._max_pages, 1) // self._l1_span) if self._hier else 0
        ntp = (B + max(ecfg.prefix_cache_entries, 0) + 2) * self._ml1
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
        self.m_kv_pages_restored = 0
        # Prefix cache, most recently used first. A device-tier entry is
        # {"key": int32 tokens, "valid": rows} plus, dense, "pb" rows of
        # "k" / "v" [L, 1, pb, K, Hd] copies, or, paged, the "pages" it
        # holds a reference on (and, hierarchical, the table pages "tps").
        # Host-tier entries (paged only: spans evicted for pool pressure)
        # hold pinned images "hk" / "hv" [L, n, page, K, Hd] and their
        # "bytes"; _host_bytes counts them and the swap images of queued
        # preempted requests against kv_swap_bytes.
        self._prefix_entries: list[dict] = []
        self._prefix_host: list[dict] = []
        self._host_bytes = 0
        self.m_prefix_hits = 0
        self.m_prefix_tokens = 0
        self.m_prefix_host_hits = 0
        self.m_kv_preempt_swaps = 0
        self.m_kv_preempt_recomputes = 0
        self.m_kv_swap_bytes_out = 0
        self.m_kv_swap_bytes_in = 0
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
        # the control pack [10, B] (the active row, _SAMPLING_FIELDS, the
        # grammar-DFA row, a speculative round's draft lengths), the page
        # table [B, MP] (hierarchical: the directories [B, ML1] and the
        # table-page pool [NTP + 1, SPAN]), the
        # adapter rows [B] and the sampled ids [n, B], followed (a host-walk
        # block) by each slot's top GRAMMAR_TOPK ids [K, B] from row _tk_row
        # and (a logprob block) from row _lp_row, per step, the sampled
        # token's logprob, the top LOGPROB_TOPK ids and their logprobs
        # [1 + 2 * LK, B] (logprobs as the bits of f32, _f2i). Each block
        # copies its host rows in from pinned staging tensors (loop thread
        # only).
        pin = dev.type == "cuda"
        MP = self.h_ptable.shape[1]
        self._h_pack = torch.zeros((3 + len(_SAMPLING_FIELDS), B), dtype=torch.float32,
                                   pin_memory=pin)
        self._h_ptable = torch.zeros((B, MP), dtype=torch.int32, pin_memory=pin)
        self._h_adapter = torch.zeros((B,), dtype=torch.int32, pin_memory=pin)
        self._b_pack = torch.zeros(self._h_pack.shape, dtype=torch.float32, device=dev)
        self._b_ptable = torch.full((B, MP), self._scratch_page, dtype=torch.int32, device=dev)
        self._h_l1 = torch.zeros(self.h_l1.shape, dtype=torch.int32, pin_memory=pin)
        self._b_l1 = torch.zeros(self.h_l1.shape, dtype=torch.int32, device=dev)
        self._h_l0 = self._b_l0 = None
        self._b_adapter = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._tk_row = max(ecfg.block_sizes)
        self._lk = min(self.LOGPROB_TOPK, V)
        self._lp_w = 1 + 2 * self._lk
        self._lp_row = self._tk_row + min(self.GRAMMAR_TOPK, V)
        self._b_out = torch.zeros((max(self._lp_row + self._tk_row * self._lp_w,
                                       self._spec_buckets[-1] + 2), B),
                                  dtype=torch.int64, device=dev)
        # A prompt-lookup round's drafts [B, kmax], staged like the pack.
        self._h_drafts = torch.zeros((B, self._spec_buckets[-1]), dtype=torch.int64,
                                     pin_memory=pin)
        self._b_drafts = torch.zeros(self._h_drafts.shape, dtype=torch.int64, device=dev)
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
        self._warm_prerun = False  # set by _warm_block around its block
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
        # Deadlines and queue-timeout expiries of submitted requests: the
        # loop's wait wakes at the earliest.
        self._deadlines = DeadlineIndex()
        # Mid-stream forks staged by fork() for the loop: (source handle,
        # seeds, branch handles).
        self._fork_requests: list[tuple] = []
        self._fork_lock = threading.Lock()
        # Embed / rerank calls staged by _on_loop for the loop thread.
        self._jobs: list[_LoopJob] = []
        self._job_lock = threading.Lock()
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
        self.m_queue_timeouts = 0
        self.m_deadline_expired = 0
        self.m_forks = 0  # branches admitted by forking a slot
        self.m_fork_clone_fallbacks = 0  # branches that admitted as clones
        self._decode_tokens = 0
        self._decode_time = 0.0
        # Observability: the loop-owned event journal (None = off), the
        # fence's CUDA event pair, the per-iteration host-phase accumulator
        # of the coalesced loop_iter record, and the path of the flight-
        # recorder dump (set when the loop dies).
        self._journal = (EventJournal(ecfg.trace_journal_events)
                         if ecfg.trace_journal_events > 0 else None)
        self._trace_fence = bool(ecfg.trace_fence)
        self._fence = DeviceFence(self.device) if self._trace_fence else None
        self._last_fence_ms = 0.0
        self._phases = LoopPhases()
        self._postmortem_path = ""
        self.m_loop_host_ms = 0.0
        self.m_loop_blocks = 0
        self.m_loop_jobs = 0  # _on_loop calls (embed / rerank) served
        self.m_loop_jobs_ms = 0.0

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

    def _check_spec(self, cfg: ArchConfig, draft_cfg: Optional[ArchConfig],
                    n_draft: int) -> ArchConfig:
        """The JAX package's validation of the speculative knobs (its
        texts): sets the resolved mode, n_draft and the draft-length
        buckets, and returns cfg with self_draft_layers set for self_draft
        (the one static object the layer helpers receive)."""
        ecfg = self.ecfg
        self.n_draft = max(1, int(n_draft))
        if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"draft model vocab ({draft_cfg.vocab_size}) must match the "
                             f"target vocab ({cfg.vocab_size})")
        mode = ecfg.spec_mode
        if mode not in ("off", "auto", "draft_model", "prompt_lookup", "self_draft"):
            raise ValueError(f"spec_mode={mode!r}: use "
                             "off|draft_model|prompt_lookup|self_draft|auto")
        if mode == "auto":
            mode = "draft_model" if draft_cfg is not None else "off"
        if mode == "draft_model" and draft_cfg is None:
            raise ValueError("spec_mode=draft_model needs a draft checkpoint "
                             "(draft_model in the model YAML / draft_cfg+draft_params)")
        if mode in ("prompt_lookup", "self_draft") and draft_cfg is not None:
            raise ValueError(f"spec_mode={mode} is model-free — the configured draft "
                             "model would sit dead in HBM; drop draft_model or use "
                             "spec_mode=draft_model")
        if mode == "self_draft":
            if cfg.is_moe or cfg.is_mla or cfg.first_k_dense:
                raise ValueError(
                    "spec_mode=self_draft needs a homogeneous dense layer stack "
                    f"({cfg.name} is {'MoE' if cfg.is_moe else 'MLA/dense-prefix'}) — use "
                    "prompt_lookup instead")
            kl = ecfg.self_draft_layers or max(1, cfg.num_layers // 4)
            if not 1 <= kl < cfg.num_layers:
                raise ValueError(f"self_draft_layers={kl} must be in [1, "
                                 f"num_layers={cfg.num_layers})")
            if cfg.self_draft_layers != kl:
                cfg = dataclasses.replace(cfg, self_draft_layers=kl)
                self.cfg = cfg
        self._spec_mode = mode
        if not 0.0 < ecfg.spec_accept_ewma <= 1.0:
            raise ValueError("spec_accept_ewma must be in (0, 1]")
        raw = ecfg.spec_draft_buckets
        if raw:
            buckets = sorted({int(b) for b in raw if int(b) >= 0} | {0})
        else:
            buckets = sorted({0, self.n_draft // 2, self.n_draft})
        if mode != "off" and buckets[-1] < 1:
            raise ValueError(f"spec_draft_buckets={raw} needs at least one bucket >= 1")
        self._spec_buckets = tuple(buckets)
        if ecfg.attention_window and (mode != "off" or draft_cfg is not None):
            raise ValueError("attention_window excludes speculative decoding this round "
                             "— the verify chunk has no windowed+sink variant; drop "
                             "spec_mode/draft_model or the window")
        return cfg

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
                # A chunking fork primary's branches end with it.
                self._fork_group_fail(slot.request, TokenEvent(kind="done", finish_reason="stop"))
        with self._pending_lock:
            pending, self._pending = list(self._pending), deque()
        for req, handle in pending:
            self._resume_discard(req)
            handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
            self._fork_group_fail(req, TokenEvent(kind="done", finish_reason="stop"))
        with self._fork_lock:
            staged, self._fork_requests = self._fork_requests, []
        for _src, _seeds, handles in staged:
            for bh in handles:
                bh._q.put(TokenEvent(kind="done", finish_reason="stop"))
        self._fail_jobs("engine stopped")
        if self._tok_fp is not None:
            # Tables prewarm pinned against this tokenizer can never hit
            # again once the model is gone.
            dfa_mod.unpin(self._tok_fp)

    def drop_device_state(self) -> None:
        """Drop every reference this (stopped) engine holds on device
        memory — weights, caches, prefix copies, adapter stacks and the
        captured graphs with their private pool — so the memory returns to
        the allocator now, not whenever the engine object is collected (a
        manager reaping a dead engine loads its successor meanwhile)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("drop_device_state() needs a stopped engine")
        self._graph_cache = {}
        self._graph_pool = self._graph_stream = None
        self.params = self.draft_params = None
        self.cache = self.d_cache = self.sd_cache = None
        self._prefix_entries = []
        self._prefix_host = []
        self._lora_tree = None
        self._dfa = None
        self._g_mask = self._g_trans = self._g_next = self._g_cls = None

    def clear_prefix_cache(self) -> None:
        """Drop every prefix entry of both tiers, returning their pages and
        table pages. Needs a stopped engine (or the loop thread): the
        cache is loop-thread state."""
        if self._thread is not None and threading.current_thread() is not self._thread:
            raise RuntimeError("clear_prefix_cache() needs a stopped engine")
        for entry in self._prefix_entries:
            self._prefix_drop(entry)
        self._prefix_entries = []
        for entry in self._prefix_host:
            self._host_bytes -= entry["bytes"]
        self._prefix_host = []

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
        self._check_multimodal(request)
        if request.adapter is not None:
            # Fail fast on tenant identity; the fetch / promote happens at
            # admission on the loop thread (and may still fail there, as an
            # error event: disk, every device row pinned).
            if self.draft_cfg is not None:
                raise AdapterError("adapter requests are not supported with a separate "
                                   "draft model — use model-free spec_mode instead")
            with self._adapter_lock:
                known = request.adapter in self._adapter_registry
            if not known:
                raise AdapterError(f"unknown adapter {request.adapter!r} — "
                                   "register_adapter() first")
        if request.grammar is not None or request.logprobs > 0:
            self._token_strings()  # built here, not on the engine loop
        handle = self._new_handle(request)
        # The dead check and the append share _pending_lock with the loop's
        # set-dead-and-drain: a submit either sees the death or is drained.
        try:
            with self._pending_lock:
                dead = self._loop_dead
                if dead is None:
                    if self.ecfg.max_pending and len(self._pending) >= self.ecfg.max_pending:
                        self.m_queue_shed += 1
                        raise QueueFullError(len(self._pending), self.ecfg.max_pending,
                                             max(1.0, self._admit_wait_ewma))
                    self._pending.append((request, handle))
        except QueueFullError as e:
            # The handle never reaches a consumer: its trace ends here.
            if handle.trace is not None:
                handle.trace.terminal(TokenEvent(kind="error", error=str(e)))
            raise
        if dead is not None:
            handle._q.put(TokenEvent(kind="error", error=dead))
            return handle
        self._jstage("queued", rid=handle.rid, a=float(len(request.prompt_ids)))
        self._wake.set()
        self.start()
        return handle

    def _check_multimodal(self, request: GenRequest) -> None:
        """The JAX package's checks of an image span and m-rope streams (its
        texts), and the speculative refusal: rounds on an m-rope model
        rotate at row positions (draft steps and the verify chunk take no
        rope delta), which is wrong for an image slot."""
        if request.image_embeds is not None:
            if self.draft_cfg is not None:
                raise ValueError("multimodal requests are not supported with a draft model")
            n = len(request.image_embeds)
            if request.image_offset < 0 or request.image_offset + n > len(request.prompt_ids):
                raise ValueError(
                    f"image span [{request.image_offset}, {request.image_offset + n}) "
                    f"outside the prompt ({len(request.prompt_ids)} tokens)")
        if request.mrope_positions is not None:
            if self.draft_cfg is not None:
                raise ValueError("mrope requests are not supported with a draft model")
            p3 = np.asarray(request.mrope_positions)
            if p3.shape != (3, len(request.prompt_ids)):
                raise ValueError(f"mrope_positions shape {p3.shape} != (3, prompt_len)")
        if _multimodal(request) and self._mrope and self._spec_mode != "off":
            raise ValueError(
                f"multimodal requests are not supported with speculative decoding "
                f"(spec_mode={self._spec_mode}) on an m-rope model: its rounds take no "
                f"per-slot rope delta")

    def _new_handle(self, request: GenRequest) -> RequestHandle:
        """A request's handle: its journal id and (with a request_id or a
        traceparent) its span tree in observe/trace.STORE, its deadline
        (the request's, else the engine default) and queue-timeout expiry
        pushed on the index the loop's wait reads."""
        handle = RequestHandle()
        handle.t_submit = time.monotonic()
        handle.rid = request.request_id or f"h{id(handle):x}"
        if request.request_id or request.traceparent:
            tr = otrace.RequestTrace(handle.rid, traceparent=request.traceparent,
                                     engine=self.cfg.name)
            handle.trace = tr
            handle._q.trace = tr
            otrace.STORE.register(tr)
            tr.note("queued", prompt_tokens=len(request.prompt_ids))
        deadline_s = request.deadline_s or self.ecfg.deadline_s
        if deadline_s > 0:
            handle.deadline = handle.t_submit + deadline_s
            self._deadlines.push(handle.deadline)
        if self.ecfg.queue_timeout_s > 0:
            self._deadlines.push(handle.t_submit + self.ecfg.queue_timeout_s)
        return handle

    def generate(self, prompt_ids: list[int], **kw) -> tuple[str, TokenEvent]:
        return self.submit(GenRequest(prompt_ids=list(prompt_ids), **kw)).result()

    def token_text(self, tok: int) -> str:
        """The string of one token id (logprob entries of the API)."""
        return self._token_str(tok)

    def embed(self, ids_batch: list[list[int]]) -> np.ndarray:
        """Batched sentence embeddings [N, D] f32, L2-normalised: one
        forward at the bucket of the longest row (rows cut to it), run on
        the loop thread (`_on_loop`)."""
        toks, lens = pad_rows(ids_batch, self._bucket_for(max(len(x) for x in ids_batch)))

        def run() -> np.ndarray:
            dev = self.device
            out = llama.encode(self.cfg, self.params, torch.from_numpy(toks).to(dev),
                               torch.from_numpy(lens).to(dev))
            return out.cpu().numpy()
        return self._on_loop(run)

    def rerank(self, query_ids: list[int], docs_ids: list[list[int]]) -> np.ndarray:
        """Relevance scores [N] f32: each document's mean conditional
        log-likelihood given the query; higher is more relevant. The query
        is cut to (max_seq - 1) // 2 tokens and each document to the rest
        ([0] for an empty one), as in the reference; run on the loop thread
        (`_on_loop`)."""
        limit = self.ecfg.max_seq - 1
        q = list(query_ids)[:limit // 2]
        rows = [q + (list(d)[:limit - len(q)] or [0]) for d in docs_ids]
        toks, lens = pad_rows(rows, self._bucket_for(max(len(r) for r in rows)))
        conds = np.full((len(rows),), len(q), np.int64)

        def run() -> np.ndarray:
            dev = self.device
            out = llama.sequence_logprob(
                self.cfg, self.params, torch.from_numpy(toks).to(dev),
                torch.from_numpy(lens).to(dev), torch.from_numpy(conds).to(dev))
            return out.cpu().numpy()
        return self._on_loop(run)

    def cancel_all(self) -> int:
        """Cancel every active and pending request (and the branches of
        pending fork groups); returns how many. The loop posts their
        terminal events; with no live loop thread (never started, stopped,
        dead) the pending ones are drained here, so no result() hangs."""
        n = 0
        with self._pending_lock:
            for req, handle in self._pending:
                handle.cancel()
                n += 1
                for _r, bh in (req.fork_group or ()):
                    bh.cancel()
                    n += 1
        for slot in list(self.slots):
            if slot is not None:
                slot.handle.cancel()
                n += 1
        self._wake.set()
        loop = self._thread
        if loop is None or not loop.is_alive():
            with self._pending_lock:
                pending, self._pending = list(self._pending), deque()
            for req, handle in pending:
                self._resume_discard(req)
                handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
                self._fork_group_fail(req, TokenEvent(kind="done", finish_reason="stop"))
        return n

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
            "queue_timeouts": float(self.m_queue_timeouts),
            "deadline_expired": float(self.m_deadline_expired),
            "fork_branches": float(self.m_forks),
            "fork_clone_fallbacks": float(self.m_fork_clone_fallbacks),
            "kv_pages_spilled": float(self.m_kv_pages_spilled),
            "kv_spill_bytes_out": float(self.m_kv_spill_bytes_out),
            "spilled_pages": float(sum(len(d) for d in list(self._slot_spill))),
            "spill_bytes": float(self._spill_bytes),
            "kv_spill_skips": float(self.m_kv_spill_skips),
            "kv_pages_restored": float(self.m_kv_pages_restored),
            "prefix_hits": float(self.m_prefix_hits),
            "prefix_tokens": float(self.m_prefix_tokens),
            "prefix_host_hits": float(self.m_prefix_host_hits),
            "prefix_entries": float(len(self._prefix_entries)),
            "prefix_host_entries": float(len(self._prefix_host)),
            "kv_preempt_swaps": float(self.m_kv_preempt_swaps),
            "kv_preempt_recomputes": float(self.m_kv_preempt_recomputes),
            "kv_swap_bytes_out": float(self.m_kv_swap_bytes_out),
            "kv_swap_bytes_in": float(self.m_kv_swap_bytes_in),
            "kv_host_tier_bytes": float(self._host_bytes),
            "weight_bytes": float(self._weight_bytes()),
            "decode_graphs": float(len(self._graph_cache)),
            "decode_graph_captures": float(self.m_graph_captures),
            "decode_graph_replays": float(self.m_graph_replays),
            "decode_graph_capture_s": float(self.m_graph_capture_s),
            "admit_wait_ms": float(self._admit_wait_ewma * 1000.0),
            "loop_dead": 1.0 if self._loop_dead is not None else 0.0,
            # Host ms the loop windows that dispatched a block spent outside
            # their wait phase (the journal's loop_iter records).
            "loop_blocks": float(self.m_loop_blocks),
            "loop_host_ms_total": float(self.m_loop_host_ms),
            "loop_host_overhead_per_block_ms": float(
                self.m_loop_host_ms / max(self.m_loop_blocks, 1)),
            # Embed / rerank forwards the loop ran between its iterations
            # (not in the phase vector or the host total above).
            "loop_jobs": float(self.m_loop_jobs),
            "loop_jobs_ms_total": float(self.m_loop_jobs_ms),
        }
        if self._journal is not None:
            # Journal health: events recorded, and cross-thread events a
            # stalled writer dropped.
            out["journal_events"] = float(self._journal.n)
            out["journal_dropped"] = float(self._journal.dropped_staged)
        if self.m_dfa_tokens:
            out["grammar_dfa_tokens"] = float(self.m_dfa_tokens)
        if self._spec_mode != "off":
            # accept_rate = emitted / scored (the drafts and one bonus or
            # residual draw a slot round); spec_rounds counts slot rounds
            # that emitted, spec_dispatches the rounds run; the histogram
            # counts each active slot's planned draft length.
            out["spec_rounds"] = float(self.m_spec_rounds)
            out["spec_dispatches"] = float(self.m_spec_dispatches)
            out["spec_tokens_accepted"] = float(self.m_spec_accepted)
            out["spec_tokens_drafted"] = float(self.m_spec_drafted)
            out["spec_accept_rate"] = (
                self.m_spec_accepted / max(1, self.m_spec_drafted + self.m_spec_rounds)
                if self.m_spec_rounds else 0.0)
            out["spec_draft_len"] = float(self.m_spec_draft_len)
            out["spec_draft_syncs"] = float(self.m_spec_syncs)
            out["spec_draft_prefills"] = float(self.m_spec_draft_prefills)
            act = self.h_active.copy()
            out["spec_accept_ewma"] = (float(self.h_accept_ewma[act].mean())
                                       if act.any() else 1.0)
            for k, v in sorted(dict(self.m_spec_dlen_hist).items()):
                out[f"spec_draft_len_hist_{k}"] = float(v)
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

    # ------------------------------------------------------------------ #
    # Lifecycle journal, traces, postmortem
    # ------------------------------------------------------------------ #

    @property
    def journal(self) -> Optional[EventJournal]:
        """The engine's event journal (None when trace_journal_events=0);
        /debug/timeline renders it as a Perfetto-loadable trace."""
        return self._journal

    @property
    def postmortem_path(self) -> str:
        """Path of the flight-recorder dump written when the loop died
        ("" while alive); rides the loop_dead gauge labels."""
        return self._postmortem_path

    def _jnote(self, event: str, rid: str = "", slot: int = -1,
               a: float = 0.0, b: float = 0.0, phases=None) -> None:
        """Loop-thread journal append (lock-free; no-op when disabled).
        `phases` (loop_iter only) is the LOOP_PHASES-ordered ms vector."""
        j = self._journal
        if j is not None:
            j.append(event, rid=rid, slot=slot, a=a, b=b, phases=phases)

    def _jstage(self, event: str, rid: str = "", slot: int = -1,
                a: float = 0.0, b: float = 0.0) -> None:
        """Cross-thread journal emit (submit): staged into the journal's
        sidecar, drained by the loop thread in order."""
        j = self._journal
        if j is not None:
            j.stage(event, rid=rid, slot=slot, a=a, b=b)

    def _jnote_fault(self, e: BaseException) -> None:
        """Journal an injected fault under its site's event type
        (fault_<site>); real failures journal as "error" only."""
        if not isinstance(e, faults.InjectedFault):
            return
        msg = str(e)
        for site in faults.SITES:
            if f"at {site} " in msg:
                self._jnote("fault_" + site)
                return

    def _write_postmortem(self, reason: str, live: list, pending_rids: list) -> str:
        """Flight-recorder dump of a dead loop: the journal tail and a
        snapshot of host state only (no device read, so it survives a
        poisoned CUDA context). Runs on the dying loop thread, after the
        pool was released and the terminal events posted."""
        j = self._journal
        payload = {
            "reason": reason,
            "engine": self.cfg.name,
            "wall_time": time.time(),
            "slots": [
                {"slot": i, "rid": rid, "generated": gen, "prompt_len": plen}
                for i, rid, gen, plen in live
            ],
            "pending": list(pending_rids),
            "pending_depth": len(pending_rids),
            "pool": {
                "kv_pages": int(self.ecfg.kv_pages),
                "free_pages": len(self._free_pages),
                "host_tier_bytes": int(self._host_bytes),
                "spilled_pages": int(sum(len(d) for d in self._slot_spill)),
                "spill_bytes": int(self._spill_bytes),
                "prefix_entries": len(self._prefix_entries),
                "prefix_host_entries": len(self._prefix_host),
            },
            "config": {
                "max_slots": self.ecfg.max_slots,
                "max_seq": self.ecfg.max_seq,
                "kv_page_size": self.ecfg.kv_page_size,
                "prefill_chunk": self.ecfg.prefill_chunk,
                "tensor_parallel": 1,
            },
            "journal": j.snapshot(last=512) if j is not None else [],
        }
        return opostmortem.write(self.ecfg.postmortem_dir, self.cfg.name, payload)

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
        with an error event instead of leaving its caller blocked. The pool
        and the host tier are released BEFORE any terminal event posts (a
        caller that unblocks may assert at once that the pool is fully
        accounted), and the postmortem is written from host state only."""
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — terminal: report and drain
            log.exception("engine loop died; failing all live requests")
            err = f"engine loop died: {type(e).__name__}: {e}"
            with self._pending_lock:
                self._loop_dead = err
                pending, self._pending = list(self._pending), deque()
            # The dying request set, captured before the teardown clears
            # it: the postmortem names exactly what was live and pending.
            live_slots = [(i, s) for i, s in enumerate(self.slots) if s is not None]
            live_snapshot = [(i, s.handle.rid, len(s.generated), s.prompt_len)
                             for i, s in live_slots]
            pending_rids = [h.rid for _r, h in pending]
            try:
                for request, _handle in pending:
                    self._resume_discard(request)
                self._release_all_state()
            except Exception:  # noqa: BLE001 — best effort on a dead engine
                log.exception("post-death state release failed")
            ev = TokenEvent(kind="error", error=err)
            for _i, slot in live_slots:
                slot.handle._q.put(dataclasses.replace(ev))
                self._fork_group_fail(slot.request, ev)
            for request, handle in pending:
                handle._q.put(dataclasses.replace(ev))
                self._fork_group_fail(request, ev)
            with self._fork_lock:
                staged, self._fork_requests = self._fork_requests, []
            for _src, _seeds, handles in staged:
                for bh in handles:
                    bh._q.put(dataclasses.replace(ev))
            self._fail_jobs(err)
            # Flight recorder: this thread is the journal's writer, so the
            # final events and the dump race nothing.
            try:
                j = self._journal
                if j is not None:
                    j.drain_staged()
                self._jnote("loop_dead", a=float(len(live_snapshot)),
                            b=float(len(pending_rids)))
                self._jnote_fault(e)
                self._postmortem_path = self._write_postmortem(err, live_snapshot,
                                                               pending_rids)
                log.error("engine postmortem written to %s", self._postmortem_path)
            except Exception:  # noqa: BLE001 — the dump must not mask the crash
                log.exception("postmortem write failed")

    def _release_all_state(self) -> None:
        """Drop every slot's, chunked admission's and prefix entry's claim
        on the page pool, the adapter rows and the host tier after a loop
        death. Host bookkeeping only (no device read or sync): it must
        work on a CUDA context a real fault poisoned."""
        self._chunkings = []
        self._growth_blocked = False
        for i in range(self.ecfg.max_slots):
            self._release(i)
        if len(self._adapter_refs):
            self._adapter_refs[:] = 0
        for entry in self._prefix_entries:
            self._prefix_drop(entry)
        self._prefix_entries = []
        self._prefix_host = []
        self._host_bytes = 0
        self._spill_bytes = 0

    def _loop(self) -> None:
        ph = self._phases
        while not self._shutdown.is_set():
            faults.fire("engine_loop")  # an injected loop death
            ph.mark()
            ph.iters += 1
            did = processed = False
            jr = self._journal
            if jr is not None:
                # Cross-thread events (queued) into the single-writer ring.
                jr.drain_staged()
            ph.lap("drain")
            self._deadlines.due(time.monotonic())  # pops what expired
            self._purge_pending()
            self._enforce_deadlines()
            self._finish_cancelled()
            ph.lap("purge")
            self._service_forks()
            ph.lap("housekeeping")
            if self._service_job():
                ph.mark()  # an embed / rerank forward: not loop overhead
            if self._growth_blocked and not self.h_active.any():
                # The growth-starved slots are gone: nothing waits on pages.
                self._growth_blocked = False
            progressed = self._admit_pending()
            ph.lap("admit")
            if self.h_active.any() and self._has_unscheduled():
                progressed = True
                try:
                    did = self._run_block()
                    if not did:
                        # The pool cannot cover the block's page growth:
                        # free the youngest slot's pages so the rest go on.
                        self._preempt_youngest()
                        ph.lap("prep")
                except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                    self._fail_block(e)
                    ph.lap("dispatch")
                processed = did
            # At most one prefill chunk between two decode blocks.
            progressed = self._advance_chunked() or progressed
            ph.lap("dispatch")
            self._spill_cold_pages()
            ph.lap("housekeeping")
            if not progressed:
                # Wake at the earliest deadline, so an idle engine still
                # sheds a pending request on time.
                due = self._deadlines.next_due() - time.monotonic()
                self._wake.wait(timeout=min(0.05, max(due, 0.0)))
                self._wake.clear()
                ph.lap("wait")
            self._flush_loop_iter(did, processed)

    def _flush_loop_iter(self, did: bool, processed: bool) -> None:
        """Coalesced loop_iter emission: every host millisecond lands in
        exactly one loop_iter window, attributed by phase. A window closes
        on a dispatched block, or after ~25 ms of quiet waiting; a pure
        idle window is dropped, so a long-idle server never evicts the
        lifecycle events a postmortem needs. Under trace_fence a window
        that dispatched carries the block's fenced device ms in `b`."""
        ph = self._phases
        host_ms = ph.total()  # excludes the wait phase
        if not (did or processed) and host_ms < 25.0:
            if ph.ms["wait"] >= 1000.0:
                ph.reset()
            return
        self.m_loop_host_ms += host_ms
        if did:
            self.m_loop_blocks += 1
        self._jnote("loop_iter", slot=-1, a=float(int(self.h_active.sum())),
                    b=self._last_fence_ms if (self._trace_fence and did) else host_ms,
                    phases=ph.vector())
        ph.reset()

    def _fail_block(self, e: Exception) -> None:
        """A failed decode block: one error event per active request, and
        its slot released."""
        log.exception("decode block failed")
        self._jnote("error", a=1.0)
        self._jnote_fault(e)
        for i, slot in enumerate(self.slots):
            if slot is not None and self.h_active[i]:
                slot.handle._q.put(TokenEvent(kind="error", error=f"{type(e).__name__}: {e}"))
                self._release(i)

    def _purge_pending(self) -> None:
        """Drop cancelled, deadline-expired and queue-timed-out entries
        from the pending queue, one terminal event each (admission only
        looks at the queue head, and only when a slot is free: a saturated
        engine would otherwise hold their callers' streams open)."""
        if not self._pending:
            return
        with self._pending_lock:
            now = time.monotonic()
            qt = self.ecfg.queue_timeout_s
            kept, dropped = deque(), []
            for request, handle in self._pending:
                if handle.cancelled.is_set():
                    dropped.append((request, handle, None))
                elif handle.deadline is not None and now > handle.deadline:
                    dropped.append((request, handle, "deadline"))
                elif qt > 0 and handle.t_submit > 0 and now - handle.t_submit > qt:
                    dropped.append((request, handle, "queue-timeout"))
                else:
                    kept.append((request, handle))
            self._pending = kept
        for request, handle, why in dropped:
            self._resume_discard(request)
            if why is None:
                handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
                # A cancelled fork primary's live branches requeue as
                # independents (each pays its own prefill).
                self._fork_group_requeue(request)
                continue
            if why == "deadline":
                self.m_deadline_expired += 1
                waited = now - handle.t_submit if handle.t_submit else 0.0
                err = f"deadline exceeded after {waited:.1f}s in queue (deadline_s)"
            else:
                self.m_queue_timeouts += 1
                err = (f"request timed out after {self.ecfg.queue_timeout_s:.1f}s in queue "
                       f"(queue_timeout_s) — server saturated")
            handle.cancel()  # a racing admission must not serve it anyway
            handle._q.put(TokenEvent(kind="error", error=err))
            # An expired fork primary takes its whole group down: the
            # branches share its prompt, deadline pressure and fate.
            self._fork_group_fail(request, TokenEvent(kind="error", error=err))

    def _enforce_deadlines(self) -> None:
        """Cancel live slots whose deadline has passed. An active slot ends
        right after (_finish_cancelled), a chunking one at its next chunk
        boundary (_advance_chunked); both release their pages."""
        now = time.monotonic()
        for slot in self.slots:
            if slot is None:
                continue
            h = slot.handle
            if h.deadline is not None and now > h.deadline and not h.cancelled.is_set():
                self.m_deadline_expired += 1
                h.cancel()

    def _finish_cancelled(self) -> None:
        """Active slots whose caller cancelled end now (nothing is in
        flight between loop iterations); a chunked admission ends at its
        next chunk (_advance_chunked)."""
        for i, slot in enumerate(self.slots):
            if slot is not None and self.h_active[i] and slot.handle.cancelled.is_set():
                self._finish(i, "stop")

    def _note_admitted(self, handle: RequestHandle) -> None:
        handle.t_admit = time.monotonic()
        if handle.trace is not None:
            handle.trace.note("admitted")
        wait = max(0.0, handle.t_admit - handle.t_submit)
        self._admit_wait_ewma = (wait if self._admit_wait_ewma == 0.0
                                 else 0.8 * self._admit_wait_ewma + 0.2 * wait)

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #

    def _admit_pending(self) -> bool:
        """Admit pending requests into free slots: one fused admission per
        group of same-bucket prompts at the queue head, the start of one
        chunked admission (a long prompt, or any prefix hit on a paged
        pool), a dense prefix hit's tail prefill, or the swap-in of a
        preempted request. On the paged pool a group takes only the pages
        the pool has now, after evicting prefix spans (backpressure), and
        nothing is admitted while a live slot waits on page growth."""
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
            chunk_item = swap_item = hit_item = fork_item = None
            # Cancelled fork primaries requeue their live branches once the
            # lock is released (_fork_group_requeue takes it).
            requeue_forks: list[GenRequest] = []
            with self._pending_lock:
                while self._pending and len(group) < len(free):
                    request, handle = self._pending[0]
                    if handle.cancelled.is_set():
                        self._pending.popleft()
                        self._resume_discard(request)
                        handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
                        if request.fork_group:
                            requeue_forks.append(request)
                        continue
                    if request.resume is not None and request.resume.get("mode") == "swap":
                        # A swap resume has no prefill to batch: alone.
                        if not group:
                            swap_item = self._pending.popleft()
                        break
                    hit = (self._prefix_find(request.prompt_ids)
                           if self._cached_admit_ok(request) else None)
                    if self._chunkable(request, hit[1] if hit else 0):
                        # Long prompts and paged hits leave the queue before
                        # bucketing; a group already gathered dispatches first.
                        if not group:
                            chunk_item = (self._pending.popleft(), hit)
                        break
                    if request.fork_group is not None:
                        # A fork primary admits alone: its branches claim
                        # more slots right after its prefill.
                        if not group:
                            fork_item = self._pending.popleft()
                        break
                    if hit is not None:  # dense cache: the tail prefills alone
                        if not group:
                            hit_item = (self._pending.popleft(), hit)
                        break
                    alone = (request.adapter is not None or request.grammar is not None
                             or request.logprobs > 0 or _multimodal(request))
                    if alone and group:
                        break  # adapter, grammar, logprob and image requests admit alone
                    if self._paged:
                        need = self._pages_needed(request)
                        if pages_planned + need > len(self._free_pages):
                            # A cached span can be prefilled again; a queued
                            # request cannot be served otherwise.
                            self._prefix_evict_for_pages(pages_planned + need)
                        if pages_planned + need > len(self._free_pages):
                            break  # pool backpressure — wait for a finish
                        pages_planned += need
                    b = self._bucket_for(len(request.prompt_ids))
                    if group and b != bucket:
                        break  # different bucket — next round
                    bucket = b
                    group.append(self._pending.popleft())
                    if alone:
                        # An adapter request alone, so a fetch / promote
                        # failure fails exactly one tenant's request; a
                        # grammar one, so its first token gets its mask; a
                        # logprob one as the reference's variant split; an
                        # image one, whose span and streams are its own.
                        break
            for req in requeue_forks:
                self._fork_group_requeue(req)
            if swap_item is not None:
                request, handle = swap_item
                need = self._resume_swap_pages(request)
                if len(self._free_pages) < need:
                    self._prefix_evict_for_pages(need)
                try:
                    ok = (len(self._free_pages) >= need
                          and self._dispatch_resume_swap(request, handle, free[0]))
                except Exception as e:  # noqa: BLE001 — fail this request, keep serving
                    self._admission_failed([swap_item], e, "swap resume")
                    admitted = True
                    continue
                if ok:
                    self._note_admitted(handle)
                    if handle.trace is not None:
                        # A swap resume runs no admission: no first token
                        # marks the stream back in decode.
                        handle.trace.note("resumed")
                    admitted = True
                    continue
                with self._pending_lock:
                    self._pending.appendleft(swap_item)
                return admitted  # pool backpressure — wait for a finish
            if chunk_item is not None:
                (request, handle), hit = chunk_item
                try:
                    started = self._chunk_start(request, handle, hit)
                except Exception as e:  # noqa: BLE001 — fail this request, keep serving
                    self._admission_failed([(request, handle)], e, "chunked admission")
                    admitted = True
                    continue
                if not started:
                    return admitted  # pool backpressure — requeued at the head
                self._note_admitted(handle)
                admitted = True
                continue
            if fork_item is not None:
                if not self._dispatch_fork_primary(fork_item, free[0]):
                    return admitted  # pool backpressure — requeued at the head
                admitted = True
                continue
            if hit_item is not None:
                (request, handle), (entry, match_len) = hit_item
                self._note_admitted(handle)
                try:
                    self._dispatch_admit_cached(request, handle, free[0], entry, match_len)
                except Exception as e:  # noqa: BLE001 — surface to the caller, keep serving
                    self._admission_failed([(request, handle)], e, "cached admission")
                admitted = True
                continue
            if not group:
                return admitted
            for _req, handle in group:
                self._note_admitted(handle)
            try:
                self._dispatch_admit(group, bucket, free[: len(group)])
            except Exception as e:  # noqa: BLE001 — surface to callers, keep serving
                self._admission_failed(group, e, f"admission (m={len(group)})")
            admitted = True

    def _admission_failed(self, group, e: Exception, what: str) -> None:
        """A failed admission (nothing of it claimed, or all of it undone):
        one error event per request, its fork branches ended with it, and a
        queued swap image's host bytes given back."""
        if isinstance(e, faults.InjectedFault):
            log.warning("%s failed: %s", what, e)
        else:
            log.exception("%s failed", what)
        self._jnote("error", a=float(len(group)))
        self._jnote_fault(e)
        ev = TokenEvent(kind="error", error=f"{type(e).__name__}: {e}")
        for request, handle in group:
            self._resume_discard(request)
            handle._q.put(dataclasses.replace(ev))
            self._fork_group_fail(request, ev)

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

    def _install_first(self, logits, prompt, lens, samp, bias_rows, seeds, slot_ids,
                       route=None, with_lp=False, rope_delta=None):
        """Sample each admitted prompt's first token (its noise keyed by the
        token's position, lens) and install the slots' device state:
        penalty counts (prompt + first token), bias row, the token, its
        position and the seed. prompt [m, S] right-padded to lens [m].
        `route` is the grammar's (_grammar_route): a DFA mode masks the
        draw to the start state's legal set (the stored bias row stays
        unmasked) and sets each slot's DFA state to the state after its
        token; "host" also returns the top GRAMMAR_TOPK ids of logits +
        bias [m, K] for the host walk. `with_lp` also returns each first
        token's logprob [m], the top LOGPROB_TOPK ids [m, LK] and their
        logprobs of log_softmax(logits + bias) (unmasked by the grammar).
        On an m-rope model it also sets each slot's rope delta (`rope_delta`
        [m] host ints; 0 for every slot without it). Returns (first tokens
        [m], those ids or None, the logprobs or None), on the device."""
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
        dfa = route if route in ("fast", "walk") else False
        draw_rows = bias_rows
        if dfa:
            host = self._dfa["host"]
            legal = np.unpackbits(host.mask_bits[host.init_state], bitorder="little")[:V]
            gmask0 = np.where(legal.astype(bool), 0.0, NEG_INF).astype(np.float32)
            draw_rows = bias_rows + torch.from_numpy(gmask0).to(dev)[None, :]
        toks = sample(logits, d_seeds, lens, sp, rows, draw_rows)
        tk = None
        if route == "host":
            tk = torch.topk(logits.float() + bias_rows, min(self.GRAMMAR_TOPK, V), dim=-1).indices
        lp = self._logprobs(logits, bias_rows, toks) if with_lp else None
        rows[torch.arange(m, device=dev), toks] += 1
        sl = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        self.counts[sl] = rows
        self.bias[sl] = bias_rows
        self.d_tokens[sl] = toks
        self.d_positions[sl] = lens
        self.d_seed[sl] = d_seeds
        if self._mrope:
            deltas = np.zeros((m,), np.int64) if rope_delta is None else np.asarray(rope_delta)
            self.h_rope_delta[slot_ids] = deltas
            self.d_rope_delta[sl] = torch.from_numpy(deltas).to(dev)
        if dfa:
            init = torch.full((m,), self._dfa["host"].init_state, dtype=torch.int32, device=dev)
            self.d_gstate[sl] = _gr.dfa_advance(dfa, self._dfa_table(dfa), self._g_cls, init,
                                                toks)
        return toks, tk, lp

    def _logprobs(self, logits: torch.Tensor, bias: torch.Tensor, toks: torch.Tensor):
        """(the tokens' logprobs [m], top LOGPROB_TOPK ids [m, LK], their
        logprobs [m, LK]) of log_softmax(logits + bias): the reference's
        logprob epilogue, before penalties, temperature and grammar."""
        logp = torch.log_softmax(logits.float() + bias, dim=-1)
        vals, ids = torch.topk(logp, self._lk, dim=-1)
        return logp.gather(1, toks[:, None].to(torch.int64))[:, 0], ids, vals

    @staticmethod
    def _f2i(x: torch.Tensor) -> torch.Tensor:
        """f32 values as int64 holding their bits, to ride an id buffer."""
        return x.float().contiguous().view(torch.int32).to(torch.int64)

    @staticmethod
    def _i2f(a: np.ndarray) -> np.ndarray:
        """The host inverse of _f2i."""
        return np.ascontiguousarray(a).astype(np.int32).view(np.float32)

    def _first_host(self, toks: torch.Tensor, tk: Optional[torch.Tensor], lp=None):
        """The admission's one device-to-host copy: the first tokens [m],
        the host walk's candidates [m, K] and the logprobs [(token's, ids
        [LK], values [LK])] per row (None without them)."""
        parts = [toks[:, None]]
        if tk is not None:
            parts.append(tk)
        if lp is not None:
            parts += [self._f2i(lp[0][:, None]), lp[1], self._f2i(lp[2])]
        if len(parts) == 1:
            return toks.tolist(), None, None
        both = torch.cat(parts, dim=1).cpu().numpy()
        cands = lps = None
        k = 1
        if tk is not None:
            cands, k = both[:, 1:1 + tk.shape[1]], 1 + tk.shape[1]
        if lp is not None:
            lk = self._lk
            lps = [(float(self._i2f(row[k:k + 1])[0]), row[k + 1:k + 1 + lk],
                    self._i2f(row[k + 1 + lk:k + 1 + 2 * lk])) for row in both]
        return both[:, 0].tolist(), cands, lps

    def _claim_slot(self, s: int, request: GenRequest, handle: RequestHandle,
                    seed: int, t_admit: float, route=None) -> None:
        """Host state of a freshly admitted slot (after its admission ran)."""
        for k in _SAMPLING_FIELDS:
            self.h_sampling[k][s] = getattr(request, k)
        self.h_seed[s] = seed
        n = len(request.prompt_ids)
        dfa = route if route in ("fast", "walk") else False
        self.slots[s] = _Slot(request=request, handle=handle, prompt_len=n, scheduled=1,
                              sched_rows=n, t_submit=handle.t_submit, t_admit=t_admit, dfa=dfa)
        self._apply_resume(s)
        self.h_active[s] = True
        self.h_gmask[s] = 1.0 if dfa else 0.0

    def _post_first(self, s: int, tok: int, cands=None, lp=None) -> None:
        """Post an admitted slot's first token (with its logprobs `lp`, if
        any); a host-walk slot first picks its grammar's token from the
        sampled one and `cands`."""
        slot = self.slots[s]
        tok = self._grammar_pick(s, tok, cands, admission=True)
        if tok is None:
            return
        tr = slot.handle.trace
        if not slot.t_first:  # a resumed request keeps its first-token time
            slot.t_first = time.monotonic()
            self._jnote("first_token", rid=slot.handle.rid, slot=s)
            if tr is not None:
                tr.note("first_token")
        elif tr is not None:
            # A recompute resume re-admits through the prefill: the stream
            # is back in decode.
            tr.note("resumed")
        self.m_prompt_tokens += slot.prompt_len
        self._post_token(s, tok, lp)

    def _dispatch_admit(self, group, bucket: int, slot_ids: list[int]) -> None:
        faults.fire("device_dispatch")
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
        faults.fire("device_dispatch")
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
            try:
                for (r, _h), s in zip(group, slot_ids):
                    if self._pages_alloc(s, self._pages_needed(r)) is None:
                        raise RuntimeError("KV page pool exhausted at admission")
            except Exception:
                for s2 in slot_ids:  # the planner counted these pages
                    self._pages_free(s2)
                raise
            table_rows = self._device_table(self.h_l1[slot_ids] if self._hier
                                            else self.h_ptable[slot_ids])
        # Grammar and logprob requests admit alone (_admit_pending).
        route = self._grammar_route(group[0][0]) if m == 1 else None
        with_lp = m == 1 and group[0][0].logprobs > 0
        d_prompt, d_lens = torch.from_numpy(prompt).to(dev), torch.from_numpy(lens).to(dev)
        # Once any adapter is device-resident every admission carries the
        # stacks; adapter-less rows ride id 0, the exact-zero null adapter.
        lora = None
        if self._lora_tree is not None:
            lora = (self._lora_tree,
                    torch.from_numpy(np.asarray(adapter_rows, np.int32)).to(dev))
        # Image requests admit alone (_admit_pending).
        inject, mrope, rope_delta = self._multimodal_args(group[0][0], bucket, m)
        try:
            logits, ks, vs = llama.prefill(self.cfg, self.params, d_prompt, d_lens, lora=lora,
                                           inject=inject, mrope=mrope)
            for j, s in enumerate(slot_ids):
                if table_rows is not None:
                    llama.write_prefill_to_pool(self.cache, _pt.select_row(table_rows, j), ks,
                                                vs, j, kv_scale=self._kv_scales)
                else:
                    llama.write_prefill_to_cache(self.cache, ks[:, j:j + 1], vs[:, j:j + 1], s)
            toks, tk, lp = self._install_first(logits, d_prompt, d_lens, samp, bias_rows, seeds,
                                               slot_ids, route, with_lp, rope_delta)
            toks_host, cands, lps = self._first_host(toks, tk, lp)
        except Exception:
            if self._paged:
                for s in slot_ids:
                    self._pages_free(s)
            raise
        self.m_admissions += 1
        # Claim the slots only after a successful admission, so a failed
        # one leaves no slot state behind.
        for j, ((r, handle), s) in enumerate(zip(group, slot_ids)):
            self._claim_slot(s, r, handle, int(seeds[j]), t0, route)
            # The pin passes to the slot; _release drops it from here on.
            self.h_adapter[s], adapter_rows[j] = adapter_rows[j], 0
            self._jnote("admitted", rid=handle.rid, slot=s, a=float(lens[j]), b=float(m))
        for (r, _h), s in zip(group, slot_ids):
            # Before the first token posts: it may finish and free the slot.
            self._admission_save(s, r)
        if group[0][0].fork_group is not None:  # a fork primary admits alone
            self._fork_after_admit(slot_ids[0], group[0][0], logits, route)
        for j, s in enumerate(slot_ids):
            self._post_first(s, int(toks_host[j]), None if cands is None else cands[j],
                             None if lps is None else lps[j])

    def _multimodal_args(self, request: GenRequest, bucket: int, m: int):
        """An admission's `inject` ((embeds [1, N, D], offsets [1]) on the
        device) and `mrope` ([1, 3, bucket]: the prompt's streams, the
        padding continuing each one, which attention masks anyway), and the
        slot's rope delta [1] (max(pos3) + 1 - the original prompt length:
        a recompute resume re-prefills its generated tokens too, and its
        streams continue over them as the padding does). (None, None, None)
        for a group without them."""
        if m != 1 or not _multimodal(request):
            return None, None, None
        dev = self.device
        inject = mrope = rope_delta = None
        if request.image_embeds is not None:
            embeds = torch.as_tensor(request.image_embeds, device=dev)
            inject = (embeds[None], torch.tensor([request.image_offset], device=dev))
        if request.mrope_positions is not None:
            p3 = np.asarray(request.mrope_positions, np.int64)
            L3 = p3.shape[1]
            full = np.zeros((1, 3, bucket), np.int64)
            full[0, :, :L3] = p3
            if bucket > L3:
                last = p3[:, -1] if L3 else np.zeros((3,), np.int64)
                full[0, :, L3:] = last[:, None] + 1 + np.arange(bucket - L3)[None, :]
            mrope = torch.from_numpy(full).to(dev)
            rope_delta = [int(p3.max()) + 1 - L3]
        return inject, mrope, rope_delta

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
        faults.fire("device_dispatch")
        # A live host-walk slot makes every block one step, "grammar": the
        # filtered sampler plus each slot's candidates, for the host to pick
        # from before the next step. DFA slots need nothing of the host.
        grammar = self._legacy_grammar_active()
        dfa = self._dfa["mode"] if self._dfa_grammar_active() else False
        # A live logprob slot adds the logprob epilogue (its own graphs).
        lp = any(self.h_active[i] and s is not None and s.request.logprobs > 0
                 for i, s in enumerate(self.slots))
        n = 1 if grammar else self._pick_block_size()
        # Speculative decoding: a round whenever some slot drafts. Logprob
        # and host-walk grammar slots take plain blocks (so does a draft
        # model with DFA slots, as in the reference).
        smode = self._spec_mode
        if (smode != "off" and not grammar and not lp
                and not (smode == "draft_model" and dfa)):
            plan = self._spec_plan(smode)
            if plan is not None:
                return self._run_spec_round(smode, *plan, dfa)
            if smode in ("prompt_lookup", "self_draft"):
                # Nothing to draft now: keep the plain block short, so the
                # scheduler plans again soon (a stream may turn repetitive
                # mid-flight, and a long block would sail past the match).
                for bs in sorted(self.ecfg.block_sizes, reverse=True):
                    if bs <= self._SPEC_REPLAN_BLOCK:
                        n = min(n, bs)
                        break
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
        if grammar:
            variant = "grammar"
        win = 0
        if not self._paged and (grammar or dfa):
            win = self.ecfg.max_seq  # constrained blocks read the whole cache
        elif not self._paged:
            # Read-side KV window: the smallest power of two (>= 256)
            # covering every active slot's pre-block rows; the cache holds
            # nothing the block reads past it, so attention streams less.
            S = self.ecfg.max_seq
            maxpos = max(self.slots[i].prompt_len + self.slots[i].scheduled for i in idx)
            win = self._KV_WIN_MIN
            while win < min(maxpos, S):
                win *= 2
            win = min(win, S)
        self._phases.lap("prep")
        self._stage_block(act)
        self._phases.lap("commit")
        self._fenced(n, lambda: self._decode_block(n, variant, win, dfa, lp))
        cands = lps = None
        if grammar or lp:  # the block's one device-to-host copy: ids, candidates, logprobs
            out = self._b_out[:self._lp_row + n * self._lp_w if lp else self._lp_row]
            out = out.cpu().numpy()
            toks = out[:n]
            if grammar:
                cands = out[self._tk_row:self._lp_row].T
            if lp:
                lps = out[self._lp_row:].reshape(n, self._lp_w, -1)
        else:
            toks = self._b_out[:n].cpu().numpy()  # the block's one device-to-host copy
        self._read_fence()
        self.m_blocks += 1
        self.m_decode_steps += n
        if dfa:
            self.m_dfa_tokens += n * int((self.h_gmask * act).sum())
        for i in idx:
            self.slots[i].scheduled += n
            self.slots[i].sched_rows += n
        consumed = 0
        for step in range(n):
            for i in idx:
                if self.slots[i] is None:
                    continue  # finished earlier in this block
                tok = self._grammar_pick(int(i), int(toks[step, i]),
                                         None if cands is None else cands[i])
                if tok is None:
                    continue
                consumed += 1
                tlp = None
                if lps is not None:
                    col, lk = lps[step, :, i], self._lk
                    tlp = (float(self._i2f(col[:1])[0]), col[1:1 + lk],
                           self._i2f(col[1 + lk:1 + 2 * lk]))
                self._post_token(int(i), tok, tlp)
        self._decode_tokens += consumed
        self._decode_time += time.monotonic() - t0
        self._phases.lap("process")
        return True

    def _fenced(self, n: int, run) -> None:
        """Run a block's or round's device work (`run`: a graph replay, or
        the first run and capture of its shape) between the fence's CUDA
        events, and journal its decode_block (a = n, b = host dispatch
        ms). The fault sites of a block all fire before this: nothing
        raises between a capture's begin and end but the body itself."""
        t0 = time.monotonic()
        fence = self._fence
        if fence is not None:
            fence.begin()
        run()
        if fence is not None:
            fence.end()
        self._jnote("decode_block", slot=-1, a=float(n), b=(time.monotonic() - t0) * 1000.0)
        self._phases.lap("dispatch")

    def _read_fence(self) -> None:
        """After the block's host read: its fenced device ms (0.0 without
        trace_fence, or on the CPU)."""
        self._last_fence_ms = self._fence.elapsed_ms() if self._fence is not None else 0.0

    def _stage_block(self, act: np.ndarray, dlens: Optional[np.ndarray] = None,
                     drafts: Optional[np.ndarray] = None) -> None:
        """Copy a block's host control rows into the body's device buffers,
        in place, from pinned memory: the active row and the sampling
        fields (and a round's draft lengths), the page table, the adapter
        rows, a prompt-lookup round's drafts. The previous block's copies
        are done: each block ends with a host read of its ids."""
        faults.fire("control_commit")
        pack = self._h_pack.numpy()
        pack[0] = act
        for fi, k in enumerate(_SAMPLING_FIELDS):
            pack[fi + 1] = self.h_sampling[k]
        pack[1 + len(_SAMPLING_FIELDS)] = self.h_gmask
        pack[2 + len(_SAMPLING_FIELDS)] = 0 if dlens is None else dlens
        self._b_pack.copy_(self._h_pack, non_blocking=True)
        if drafts is not None:
            self._h_drafts.numpy()[:, :drafts.shape[1]] = drafts
            self._b_drafts.copy_(self._h_drafts, non_blocking=True)
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
                             if tuple(e for e in k[4:] if e[0] == "hier") == self._table_key()}

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

    def _block_key(self, n: int, variant: str, win: int, dfa=False, lp=False) -> tuple:
        """What fixes a block's graph (the reference's block-cache key):
        the sampler variant, n, the dense read window (0 on a paged pool),
        once adapters are resident the stacks' (keys, rows, rank), for a
        hierarchical table its layout, with DFA slots live the mode and
        the sizes of the table buffers (_g_dims), and the logprob
        epilogue."""
        lora = None
        if self._lora_tree is not None:
            rows = next(iter(self._lora_tree.values()))["a"].shape[1]
            lora = (self._lora_keys, rows, self._lora_rank)
        return ((variant, n, win, lora) + self._table_key()
                + ((("dfa", dfa) + self._g_dims,) if dfa else ())
                + ((("lp",),) if lp else ()))

    def _decode_block(self, n: int, variant: str, win: int, dfa=False, lp=False) -> None:
        """Run the block body on the staged buffers (`_graph_run`); under
        _warm_block a capture's eager run is one step of it."""
        prerun = ((lambda: self._block_body(1, variant, win, dfa, lp))
                  if self._warm_prerun else None)
        self._graph_run(self._block_key(n, variant, win, dfa, lp),
                        lambda: self._block_body(n, variant, win, dfa, lp), prerun)

    def _graph_run(self, key: tuple, body, prerun=None) -> None:
        """Run a body of persistent buffers (a decode block, a speculative
        round): eagerly on the CPU; on the card as the CUDA graph of its
        key, captured at the key's first run and replayed from then on. A
        failed capture or replay raises (the loop fails the requests).
        `prerun` (warmup's) stands in for the body's eager run before a
        capture."""
        if self.device.type != "cuda":
            body()
            return
        entry = self._graph_cache.get(key)
        if entry is None:
            self._capture_block(key, body, prerun)
        else:
            kernels.replay_counted(entry[0], entry[1])
            self.m_graph_replays += 1

    def _capture_block(self, key: tuple, body, prerun=None) -> None:
        """A key's first run on the card. The body runs eagerly on the
        capture stream first: that run is the real block, and it does what
        must not happen inside a capture (loading the kernel libraries,
        creating cuBLAS handles and the stream's workspace, setting kernel
        attributes, growing the split workspaces to this shape). A
        `prerun` runs in its place where the block's results are thrown
        away (warmup: a one-step block of the same operations and shapes).
        Then the body is captured, which executes nothing. The graph keeps
        the workspaces it captured alive, and the replays add the launches
        its wrappers counted during the capture."""
        t0 = time.monotonic()
        if self._graph_stream is None:
            self._graph_stream = _capture_stream(self.device)
        if not self._graph_cache:
            # A pool lives while a graph captured into it does: once the
            # last one is dropped (_lora_rebuild), captures need a new pool.
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._graph_stream
        current = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()

        def capture() -> None:
            graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()

        with _CAPTURE_LOCK, torch.cuda.stream(stream):
            stream.wait_stream(current)
            (prerun or body)()
            torch.cuda.synchronize(self.device)  # as torch.cuda.graph does before a capture
            deltas = kernels.captured_counts(capture)
        current.wait_stream(stream)
        self._graph_cache[key] = (graph, deltas, kernels.live_workspaces())
        self.m_graph_captures += 1
        self.m_graph_capture_s += time.monotonic() - t0

    def _block_body(self, n: int, variant: str, win: int, dfa=False, lp=False) -> None:
        """n decode steps over every slot, on persistent device buffers
        only: it reads the staged controls (_b_pack, the table, _b_adapter),
        the tokens, positions and seeds, counts, bias, the cache and the
        params, and writes the counts, the cache (once, at the end), the
        tokens and positions (in place) and the ids (_b_out[:n]). Idle
        slots are masked; on a paged pool they walk no pages (limit 0) and
        write into SCRATCH. `win` < max_seq reads a dense cache through
        that window. With `dfa` (the active table set's mode) slots whose
        grammar row of the pack is set sample from their DFA state's legal
        tokens and advance d_gstate; the others ride the FREE state. The
        "grammar" variant (n = 1) samples as "filtered" and also writes
        each slot's top GRAMMAR_TOPK ids of logits + bias to _b_out from
        row _tk_row. With `lp` each step also writes the sampled tokens'
        logprobs and the top LOGPROB_TOPK of log_softmax(logits + bias) (the
        unmasked distribution) from row _lp_row. No host sync."""
        cfg, B, S, V = self.cfg, self.ecfg.max_slots, self.ecfg.max_seq, self.cfg.vocab_size
        dev = self.device
        nf = len(_SAMPLING_FIELDS)
        active = self._b_pack[0] > 0
        act_i32 = active.to(torch.int32)
        sp = _sampling_params(self._b_pack[1:1 + nf])
        if dfa:
            gs = torch.where(self._b_pack[1 + nf] > 0, self.d_gstate, 0)
            gtable = self._dfa_table(dfa)
        ptable = None
        read_cache = self.cache
        if self._paged:
            ptable = (self._b_l1, self._b_l0) if self._hier else self._b_ptable
        elif win < S:
            read_cache = llama.KVCache(k=self.cache.k[:, :, :win], v=self.cache.v[:, :, :win])
        shape = (cfg.num_layers, B, n, cfg.cache_kv_heads)
        local_k = torch.zeros((*shape, cfg.cache_k_dim), dtype=self._local_dtype, device=dev)
        local_v = torch.zeros((*shape, cfg.cache_v_dim), dtype=self._local_dtype, device=dev)
        tokens, positions = self.d_tokens, self.d_positions
        if self._paged:
            positions = torch.where(active, positions, 0)
        start_pos = positions
        lora = None if self._lora_tree is None else (self._lora_tree, self._b_adapter)
        for step in range(n):
            logits, local_k, local_v = llama.decode_step_windowed(
                cfg, self.params, tokens, positions, read_cache, local_k, local_v, step,
                ptable=ptable, kv_scale=self._kv_scales, lora=lora, rope_delta=self.d_rope_delta)
            slogits = logits
            if dfa:
                slogits = torch.where(_gr.dfa_allowed(self._g_mask, gs, V), logits, NEG_INF)
            # The drawn token sits at positions + 1: its noise is keyed there.
            if variant == "greedy":
                nxt = sample_greedy(slogits, sp, self.counts, self.bias)
            elif variant == "simple":
                nxt = sample_simple(slogits, self.d_seed, positions + 1, sp, self.counts,
                                    self.bias)
            else:
                nxt = sample(slogits, self.d_seed, positions + 1, sp, self.counts, self.bias)
            update_counts(self.counts, nxt, act_i32)
            if dfa:
                gs = torch.where(active, _gr.dfa_advance(dfa, gtable, self._g_cls, gs, nxt), gs)
            nxt = torch.where(active, nxt, 0)
            self._b_out[step] = nxt
            if variant == "grammar":
                K = self._lp_row - self._tk_row
                self._b_out[self._tk_row:self._lp_row] = torch.topk(
                    logits.float() + self.bias, K, dim=-1).indices.T
            if lp:
                tok_lp, ids, vals = self._logprobs(logits, self.bias, nxt)
                r0, lk = self._lp_row + step * self._lp_w, self._lk
                self._b_out[r0] = self._f2i(tok_lp)
                self._b_out[r0 + 1:r0 + 1 + lk] = ids.T
                self._b_out[r0 + 1 + lk:r0 + 1 + 2 * lk] = self._f2i(vals).T
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
        if dfa:
            self.d_gstate.copy_(gs)

    # ------------------------------------------------------------------ #
    # Warmup (the reference's Engine.warmup)
    # ------------------------------------------------------------------ #

    def warmup(self, prompt_len: int = 8, grammar: bool = False,
               logprobs: bool = False) -> None:
        """Run every serving shape once before traffic arrives: one
        admission of each power-of-two group size up to max_slots at
        `prompt_len`'s bucket, then every decode-block shape the scheduler
        can pick (each of block_sizes x the three sampler variants, and on
        a dense cache every read window at block_sizes[0]) and, with
        speculation on, every round shape (_warm_rounds), so on the card
        every block and round graph is captured here and serving only
        replays. Then one 2-token generate through the loop.

        grammar=True then also runs the one-step host-walk ("grammar")
        block and a {"type": "boolean"} request through the host walk (or
        its DFA, once built), and, for each mode of the schemas
        prewarm_grammar compiled, grows the DFA table buffers to them and
        runs every DFA block shape (and, model-free speculation on, every
        DFA round shape), so serving those schemas captures nothing.

        logprobs=True then also runs every block shape with the logprob
        epilogue and a 2-token logprob request, so serving a logprob
        request captures nothing.

        Runs against the live state with every slot idle (call it before
        traffic): throwaway writes land in idle rows or SCRATCH, and the
        per-slot device rows (counts, bias, tokens, positions, seeds, DFA
        states) are put back as they were."""
        if any(s is not None for s in self.slots) or self._pending:
            raise RuntimeError("warmup() needs an idle engine: call it before traffic")
        state = (self.counts, self.bias, self.d_tokens, self.d_positions, self.d_seed,
                 self.d_gstate)
        saved = [t.clone() for t in state]
        bucket = self._bucket_for(prompt_len)
        m = 1
        while m <= self.ecfg.max_slots:
            self._warm_admit(m, bucket)
            m *= 2
        S = self.ecfg.max_seq
        variants = ("greedy", "simple", "filtered")
        for lp in (False, True) if logprobs else (False,):
            for n in self.ecfg.block_sizes:
                for variant in variants:
                    self._warm_block(n, variant, 0 if self._paged else S, lp=lp)
            if not self._paged:
                w = self._KV_WIN_MIN
                while w < S:
                    for variant in variants:
                        self._warm_block(self.ecfg.block_sizes[0], variant, w, lp=lp)
                    w *= 2
            if not lp:
                self._warm_rounds()
            _, ev = self.generate([1] * prompt_len, max_new_tokens=2, logprobs=int(lp))
            if ev.kind != "done":
                raise RuntimeError(f"warmup generate ended with {ev.kind}: {ev.error}")
        if grammar:
            self._token_strings()  # built here, not on the engine loop
            full = 0 if self._paged else S  # constrained blocks read the whole cache
            self._warm_block(1, "grammar", full)
            # Before the DFA blocks: a cached boolean table set may grow the
            # buffers, and a growth drops the graphs captured on them.
            _, ev = self.generate([1] * prompt_len, max_new_tokens=4,
                                  grammar=GrammarConstraint({"type": "boolean"}))
            if ev.kind != "done":
                raise RuntimeError(f"warmup grammar generate ended with {ev.kind}: {ev.error}")
            if self._dfa_warm_modes:
                self._dfa_buffers(*self._dfa_want)
            for mode in sorted(self._dfa_warm_modes):
                for n in self.ecfg.block_sizes:
                    for variant in variants:
                        self._warm_block(n, variant, full, mode)
                self._warm_block(1, "grammar", full, mode)
                if self._spec_mode in ("prompt_lookup", "self_draft"):
                    self._warm_rounds(mode)
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
        toks, _, _ = self._install_first(logits, prompt, lens, samp,
                                      np.zeros((m, self.cfg.vocab_size), np.float32),
                                      np.zeros((m,), np.int64), list(range(m)))
        toks.cpu()

    def _warm_block(self, n: int, variant: str, win: int, dfa=False, lp=False) -> None:
        """One decode block of this shape with every slot idle. Its capture
        on the card runs one step eagerly first, not n: every step runs the
        same operations on the same weights, pool and slots (only the
        block-local KV rows grow with n), and nothing reads a throwaway
        block's results."""
        self._stage_block(np.zeros_like(self.h_active))
        self._warm_prerun = True
        try:
            self._decode_block(n, variant, win, dfa, lp)
        finally:
            self._warm_prerun = False
        self._b_out.cpu()

    # ------------------------------------------------------------------ #
    # Speculative decoding (docs/SPECULATIVE.md): per-slot draft lengths
    # from each slot's acceptance EWMA, one round (draft, verify, accept)
    # per dispatch, run as the CUDA graph of its shape on the card.
    # ------------------------------------------------------------------ #

    def _slot_pos(self, i: int) -> int:
        """The position of slot i's current token (its last generated one,
        the next input): the rows below it are written."""
        s = self.slots[i]
        return s.prompt_len + len(s.generated) - 1

    def _spec_len_for(self, i: int, kmax: int) -> int:
        """The EWMA's draft length for one active slot (probe bookkeeping
        happens when the plan commits): below the floor a cold slot drafts
        0 until its probe counter retries the smallest nonzero bucket."""
        a = float(self.h_accept_ewma[i])
        if a < self._SPEC_EWMA_FLOOR:
            if self._spec_probe[i] >= self._SPEC_PROBE_EVERY:
                for b in self._spec_buckets:
                    if b > 0:
                        return min(b, kmax)
            return 0
        return max(1, min(kmax, int(round(a * kmax))))

    def _lookup_propose(self, i: int, kmax: int) -> list:
        """Slot i's draft from its suffix index, built at the slot's first
        plan and fed only the history appended since (prompt first, then
        the generated tokens)."""
        slot = self.slots[i]
        st = self._lookup[i]
        if st is None or st[0] is not slot:
            st = (slot, speclookup.SuffixIndex(), 0)
        _s, ix, fed = st
        prompt = slot.request.prompt_ids
        total = len(prompt) + len(slot.generated)
        if fed < total:
            if fed < len(prompt):
                ix.extend(prompt[fed:])
                fed = len(prompt)
            ix.extend(slot.generated[fed - len(prompt):])
            fed = total
        self._lookup[i] = (slot, ix, fed)
        return ix.propose(kmax)

    def _spec_plan(self, mode: str):
        """Plan one round: each active slot's draft length from its EWMA
        (for prompt lookup, no longer than its match; never past what its
        token budget can use), the window bucketed up to the smallest
        covering entry of the buckets. Returns (kb, dlens [B], drafts
        [B, kb] or None), or None when no slot drafts (the caller runs a
        plain block). The reference waits while earlier dispatches are in
        flight, since a suffix mined from a lagging history is stale; the
        port reads each block's ids before it plans the next, so its host
        history is always current and it never waits."""
        B = self.ecfg.max_slots
        kmax = self._spec_buckets[-1]
        dlens = np.zeros((B,), np.int32)
        drafts = np.zeros((B, kmax), np.int64) if mode == "prompt_lookup" else None
        live = [i for i in range(B) if self.h_active[i] and self.slots[i] is not None]
        for i in live:
            want = min(self._spec_len_for(i, kmax), max(self._remaining(self.slots[i]) - 1, 0))
            if mode == "prompt_lookup" and want > 0:
                prop = self._lookup_propose(i, kmax)
                want = min(want, len(prop))
                drafts[i, :want] = prop[:want]
            dlens[i] = want
        for i in live:
            if dlens[i] == 0:
                if self.h_accept_ewma[i] < self._SPEC_EWMA_FLOOR:
                    self._spec_probe[i] += 1
            elif self.h_accept_ewma[i] < self._SPEC_EWMA_FLOOR:
                self._spec_probe[i] = 0  # the probe fired: one trial round
            self.m_spec_dlen_hist[int(dlens[i])] = self.m_spec_dlen_hist.get(int(dlens[i]), 0) + 1
        need = int(dlens.max())
        if need == 0:
            return None
        kb = next(b for b in self._spec_buckets if b >= need)
        return kb, dlens, (drafts[:, :kb] if drafts is not None else None)

    def _spec_sync(self, idx) -> None:
        """Bring the draft's dense cache up to date below each active slot's
        position where its rows lag (a new slot, a resumed one, plain blocks
        since its last round). self_draft copies the target's rows of its
        first layers (gather_pages on a pool, fp8 rows dequantized with the
        kv scales): they are what the early exit would have written.
        draft_model prefills the draft over the slot's history (the flash
        kernel on the card), slots of one bucket in one call. The reference
        fuses a draft prefill into every admission program and syncs the
        self-draft scratch once per slot generation; this one path serves
        fresh, chunked, prefix-hit and resumed admissions alike."""
        lag = [int(i) for i in idx if self.h_dsync[i] != self._slot_pos(i)]
        if not lag:
            return
        self.m_spec_syncs += len(lag)
        dev = self.device
        if self._spec_mode == "self_draft":
            kl = self.cfg.self_draft_layers
            sd = self.sd_cache
            for i in lag:
                p = self._slot_pos(i)
                if self._paged:
                    n = -(-p // self.ecfg.kv_page_size)
                    pages = torch.tensor(self._slot_pages[i][:n], dtype=torch.int64)
                    k, v = llama.gather_pages(llama.KVCache(self.cache.k[:kl], self.cache.v[:kl]),
                                              pages, self._kv_scales)
                    k, v = k[:, 0], v[:, 0]
                else:
                    k, v = self.cache.k[:kl, i], self.cache.v[:kl, i]
                sd.k[:, i, :p] = k[:, :p].to(sd.k.dtype)
                sd.v[:, i, :p] = v[:, :p].to(sd.v.dtype)
                self.h_dsync[i] = p
            return
        by_bucket: dict[int, list[int]] = {}
        for i in lag:
            by_bucket.setdefault(self._bucket_for(self._slot_pos(i)), []).append(i)
        for bucket, group in by_bucket.items():
            toks = np.zeros((len(group), bucket), np.int64)
            lens = np.zeros((len(group),), np.int64)
            for j, i in enumerate(group):
                p = self._slot_pos(i)
                s = self.slots[i]
                toks[j, :p] = (list(s.request.prompt_ids) + s.generated)[:p]
                lens[j] = p
            self.m_spec_draft_prefills += 1
            _, ks, vs = llama.prefill(self.draft_cfg, self.draft_params,
                                      torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev))
            for j, i in enumerate(group):
                llama.write_rows_to_cache(self.d_cache, i, ks[:, j:j + 1], vs[:, j:j + 1], 0)
                self.h_dsync[i] = int(lens[j])

    def _spec_window(self, mode: str, kb: int, idx) -> int:
        """A round's dense read window: the smallest power of two (>= 256)
        covering every active slot's rows through its window, or max_seq.
        It bounds the reads of the dense caches (the target's, the
        draft's); 0 on a paged pool with no draft cache."""
        if self._paged and mode == "prompt_lookup":
            return 0
        S = self.ecfg.max_seq
        need = max(self._slot_pos(int(i)) for i in idx) + kb + 1
        w = self._KV_WIN_MIN
        while w < min(need, S):
            w *= 2
        return min(w, S)

    def _spec_key(self, mode: str, kb: int, variant: str, win: int, dfa=False) -> tuple:
        """A round's graph key, laid out as `_block_key`'s (the LoRA part
        fourth, tagged tuples after): the mode and sampler variant, the
        window kb, the dense read window, the LoRA stacks (model-free modes
        only), the table layout and the DFA buffers."""
        lora = None
        if self._lora_tree is not None and mode != "draft_model":
            rows = next(iter(self._lora_tree.values()))["a"].shape[1]
            lora = (self._lora_keys, rows, self._lora_rank)
        return ((("spec", mode, variant), kb, win, lora) + self._table_key()
                + ((("dfa", dfa) + self._g_dims,) if dfa else ()))

    def _decode_round(self, mode: str, kb: int, variant: str, win: int, dfa=False) -> None:
        """Run a round body on the staged buffers (`_graph_run`)."""
        self._graph_run(self._spec_key(mode, kb, variant, win, dfa),
                        lambda: self._spec_body(mode, kb, variant, win, dfa))

    def _spec_body(self, mode: str, kb: int, variant: str, win: int, dfa=False) -> None:
        """One speculative round over every slot, on persistent buffers
        only (the reference's _get_spec_block):

        1. the draft window: prompt lookup's kb drafts from _b_drafts, or
           kb decode_steps of the draft (the draft model, or the target's
           first layers over the scratch) sampling from its processed
           distribution q at the round-start counts, then one step for its
           K/V row only (a fully accepted window's next round reads it);
        2. one decode_chunk of the target over the current token and the kb
           drafts (B2's multi-query form on a pool);
        3. the accept scan, counts updated token by token: slot b tests
           draft t while t < its draft length (pack row 9) and then draws a
           bonus token from p; a rejection draws from the residual and ends
           the slot's window. "greedy" (no sampled slot) reduces the test
           to argmax agreement; "sampled" is the exact stochastic test
           (ops/sampling.verify_step). DFA slots (model-free modes) mask p
           to their state's legal set and advance per emitted token.

        Writes the emitted ids (-1 past a slot's window) to _b_out[:kb+1]
        and their count to _b_out[kb+1]; the tokens, positions, counts,
        cache, draft cache and DFA states advance in place. Idle slots are
        masked; on a pool they sit at position 0 and write into SCRATCH.
        `win` < max_seq reads the dense caches through that window. No
        host sync."""
        cfg, B, S, V = self.cfg, self.ecfg.max_slots, self.ecfg.max_seq, self.cfg.vocab_size
        dev = self.device
        nf = len(_SAMPLING_FIELDS)
        pack = self._b_pack
        active = pack[0] > 0
        sp = _sampling_params(pack[1:1 + nf])
        dlen = pack[2 + nf].to(torch.int64)
        if dfa:
            gs = torch.where(pack[1 + nf] > 0, self.d_gstate, 0)
            gtable = self._dfa_table(dfa)
        ptable = None
        if self._paged:
            ptable = (self._b_l1, self._b_l0) if self._hier else self._b_ptable
        rows = win if 0 < win < S else 0
        tokens, positions, seeds = self.d_tokens, self.d_positions, self.d_seed
        if self._paged:
            positions = torch.where(active, positions, 0)
        qlogs = None
        if mode == "prompt_lookup":
            chunk = torch.cat([tokens[:, None], self._b_drafts[:, :kb]], dim=1)
        else:
            if mode == "self_draft":
                dcfg, dparams = llama.self_draft_view(cfg, self.params)
                dcache = self.sd_cache
            else:
                dcfg, dparams, dcache = self.draft_cfg, self.draft_params, self.d_cache
            cur, drafted, qlogs = tokens, [], []
            for i in range(kb):
                pos_i = torch.clamp(positions + i, max=S - 1)
                logits, _ = llama.decode_step(dcfg, dparams, cur, pos_i, dcache, read_rows=rows)
                if variant == "greedy":
                    cur = sample_greedy(logits, sp, self.counts, self.bias)
                else:
                    ql = processed_logprobs(logits, sp, self.counts, self.bias)
                    cur = torch.argmax(ql + gumbel_noise(seeds, pos_i + 1, V, STREAM_DRAFT), dim=-1)
                    qlogs.append(ql)
                drafted.append(cur)
            llama.decode_step(dcfg, dparams, cur, torch.clamp(positions + kb, max=S - 1), dcache,
                              with_logits=False, read_rows=rows)
            chunk = torch.stack([tokens] + drafted, dim=1)
        pos_chunk = torch.clamp(positions[:, None] + torch.arange(kb + 1, device=dev)[None, :],
                                max=S - 1)
        lora = None
        if self._lora_tree is not None and mode != "draft_model":
            lora = (self._lora_tree, self._b_adapter)
        logits_all, _ = llama.decode_chunk(cfg, self.params, chunk, pos_chunk, self.cache,
                                           ptable=ptable, kv_scale=self._kv_scales, lora=lora,
                                           read_rows=0 if self._paged else rows)
        still = torch.ones((B,), dtype=torch.bool, device=dev)
        cur_tok = tokens
        acc = torch.zeros((B,), dtype=torch.int64, device=dev)
        for t in range(kb + 1):
            lt = logits_all[:, t]
            if dfa:
                lt = torch.where(_gr.dfa_allowed(self._g_mask, gs, V), lt, NEG_INF)
            x = chunk[:, min(t + 1, kb)]
            bonus = dlen <= t
            if variant == "greedy":
                tok = sample_greedy(lt, sp, self.counts, self.bias)
                take = (x == tok) & ~bonus
            else:
                pl = processed_logprobs(lt, sp, self.counts, self.bias)
                ql = qlogs[min(t, kb - 1)] if qlogs else None
                take, tok = verify_step(pl, x, ql, bonus, seeds, positions + t + 1)
            emit = still & active
            update_counts(self.counts, tok, emit.to(torch.int32))
            if dfa:
                gs = torch.where(emit, _gr.dfa_advance(dfa, gtable, self._g_cls, gs, tok), gs)
            cur_tok = torch.where(emit, tok, cur_tok)
            acc = acc + emit.to(torch.int64)
            self._b_out[t] = torch.where(emit, tok, -1)
            still = still & take
        self._b_out[kb + 1] = acc
        self.d_tokens.copy_(torch.where(active, cur_tok, tokens))
        self.d_positions.copy_(torch.clamp(positions + acc, max=S - 1))
        if dfa:
            self.d_gstate.copy_(gs)

    def _run_spec_round(self, mode: str, kb: int, dlens: np.ndarray,
                        drafts: Optional[np.ndarray], dfa=False) -> bool:
        """One speculative round: grow the pages of kb + 1 rows, bring the
        draft caches up to date, stage the controls (and prompt lookup's
        drafts), run the round (a graph replay on the card), one host copy,
        then post the emitted tokens and fold each slot's accepted /
        drafted ratio into its EWMA. Returns False, having dispatched
        nothing, when the pool cannot cover the growth."""
        faults.fire("spec_verify")
        if not self._grow_for_decode(kb + 1):
            return False
        t0 = time.monotonic()
        act = self.h_active.copy()
        idx = np.flatnonzero(act)
        if mode != "prompt_lookup":
            self._spec_sync(idx)
        pos0 = {int(i): self._slot_pos(int(i)) for i in idx}
        variant = "sampled" if np.any(self.h_sampling["temperature"][idx] > 0) else "greedy"
        win = self._spec_window(mode, kb, idx)
        self._phases.lap("prep")
        self._stage_block(act, dlens, drafts)
        self._phases.lap("commit")
        self._fenced(kb + 1, lambda: self._decode_round(mode, kb, variant, win, dfa))
        drafted = int(dlens[idx].sum())
        self._jnote("spec_draft", a=float(drafted), b=float(kb))
        out = self._b_out[:kb + 2].cpu().numpy()  # the round's one device-to-host copy
        self._read_fence()
        toks, acc = out[:kb + 1], out[kb + 1]
        self.m_blocks += 1
        self.m_spec_dispatches += 1
        self.h_draft_len[idx] = dlens[idx]
        self.m_spec_draft_len = float(dlens[idx].sum()) / max(1, len(idx))
        if dfa:
            self.m_dfa_tokens += int(sum(acc[i] for i in idx if self.h_gmask[i]))
        for i in idx:
            self.slots[i].scheduled += int(acc[i])
            self.slots[i].sched_rows += int(acc[i])
            if mode != "prompt_lookup":
                self.h_dsync[i] = pos0[int(i)] + int(acc[i])
        emitted = np.zeros((self.ecfg.max_slots,), np.int64)
        for t in range(kb + 1):
            for i in idx:
                if self.slots[i] is None:
                    continue  # finished earlier in this round
                tok = int(toks[t, i])
                if tok < 0:
                    continue
                emitted[i] += 1
                self._post_token(int(i), tok)
        consumed = int(emitted.sum())
        self.m_spec_rounds += int((emitted > 0).sum())
        self.m_spec_accepted += consumed
        self._decode_tokens += consumed
        # A round always emits one token that is no draft (the bonus or the
        # residual draw), so a slot accepted emitted - 1 of its drafts.
        alpha = self.ecfg.spec_accept_ewma
        for i in idx:
            if emitted[i] == 0:
                continue
            self.m_spec_drafted += int(dlens[i])
            if dlens[i] > 0 and self.slots[i] is not None:
                ratio = (emitted[i] - 1) / float(dlens[i])
                self.h_accept_ewma[i] = (1.0 - alpha) * self.h_accept_ewma[i] + alpha * ratio
        self._jnote("spec_verify", a=float(drafted), b=float(consumed))
        self._decode_time += time.monotonic() - t0
        self._phases.lap("process")
        return True

    def _warm_round(self, kb: int, variant: str, win: int, dfa=False) -> None:
        """One speculative round of this shape with every slot idle."""
        B = self.ecfg.max_slots
        drafts = np.zeros((B, kb), np.int64) if self._spec_mode == "prompt_lookup" else None
        self._stage_block(np.zeros_like(self.h_active), np.zeros((B,), np.int32), drafts)
        self._decode_round(self._spec_mode, kb, variant, win, dfa)
        self._b_out.cpu()

    def _warm_rounds(self, dfa=False) -> None:
        """Every round shape the scheduler can pick: each nonzero bucket,
        both sampler variants, and every dense read window (0 alone on a
        pool with no draft cache)."""
        if self._spec_mode == "off":
            return
        S = self.ecfg.max_seq
        wins = [0]
        if not (self._paged and self._spec_mode == "prompt_lookup"):
            wins, w = [], self._KV_WIN_MIN
            while w < S:
                wins.append(w)
                w *= 2
            wins.append(S)
        for kb in self._spec_buckets:
            if kb == 0:
                continue
            for variant in ("greedy", "sampled"):
                for w in wins:
                    self._warm_round(kb, variant, w, dfa)

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

    def _pages_alloc(self, slot_idx: int, n: int, shared: Optional[list[int]] = None,
                     shared_tps: Optional[list[int]] = None) -> Optional[np.ndarray]:
        """Build a slot's page table: `shared` pages (a prefix span, one
        more reference each, never written by the slot: its writes land
        past the span) followed by `n` fresh ones. Hierarchical, the full
        table pages of `shared_tps` (the span's entry's) map by reference.
        Returns the slot's table row ([MP] flat, its [ML1] directory
        hierarchical), or None, changing nothing, when the pool cannot
        cover it."""
        # An injected allocator failure fires before any mutation, so the
        # pool stays exactly accounted across it.
        faults.fire("page_alloc")
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
            return self._ptable_build_slot(slot_idx, pages, shared_tps, len(shared))
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
        if len(self._free_pages) < grow:
            self._prefix_evict_for_pages(grow)
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
        # the pool when they spilled; a prefix save restores them first).
        self._spill_bytes -= len(self._slot_spill[slot_idx]) * self._page_bytes()
        self._slot_spill[slot_idx] = {}
        self._spill_cursor[slot_idx] = 0

    # ------------------------------------------------------------------ #
    # Hierarchical page tables (kv_l1_span > 0): each slot's directory of
    # refcounted table pages (h_l1 -> rows of h_l0). The page allocator
    # above is the same for both layouts; these keep the mapping. Prefix
    # entries pin the table pages over their spans, and a hit maps the
    # full ones by reference (copy on write).
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
        # A chunking slot's directory rides its chunk state, not h_l1.
        st = next((st for st in self._chunkings if st["slot"] == slot_idx), None)
        l1 = st["table_row"] if st is not None else self.h_l1[slot_idx]
        while len(tps) <= c:
            tp_new = self._tp_claim()
            tps.append(tp_new)
            l1[len(tps) - 1] = tp_new
        tp = tps[c]
        if self._tp_refs[tp] > 1:
            tp_new = self._tp_claim()
            self.h_l0[tp_new, :] = self.h_l0[tp]
            self._tp_release([tp])
            tps[c] = tp_new
            l1[c] = tp_new
            tp = tp_new
        self.h_l0[tp, o] = page_id

    def _table_set(self, slot_idx: int, col: int, page_id: int) -> None:
        """Point one column of a live or chunking slot's table at
        `page_id`, in whichever table it rides."""
        if self._hier:
            self._ptable_set(slot_idx, col, page_id)
            return
        st = next((st for st in self._chunkings if st["slot"] == slot_idx), None)
        (st["table_row"] if st is not None else self.h_ptable[slot_idx])[col] = page_id

    def _ptable_build_slot(self, slot_idx: int, pages: list[int],
                           shared_tps: Optional[list[int]] = None,
                           n_shared: int = 0) -> np.ndarray:
        """Build a slot's directory for `pages`: the whole table pages of
        the leading `n_shared` shared pages reuse `shared_tps` (the donor
        entry's, one more reference each), the rest go into freshly
        claimed ones. Returns the slot's L1 row (the counterpart of a flat
        row)."""
        if self._slot_tps[slot_idx]:
            log.error("slot %d already held a directory — releasing it", slot_idx)
            self._ptable_free_slot(slot_idx)
        self.h_l1[slot_idx, :] = self._scratch_tp
        full = min(n_shared // self._l1_span, len(shared_tps or []))
        for c in range(full):
            tp = shared_tps[c]
            self._tp_refs[tp] += 1
            self._slot_tps[slot_idx].append(tp)
            self.h_l1[slot_idx, c] = tp
        for pos in range(full * self._l1_span, len(pages)):
            self._ptable_set(slot_idx, pos, pages[pos])
        return self.h_l1[slot_idx].copy()

    def _entry_tps(self, slot_idx: int, n_pages: int) -> list[int]:
        """The slot's table pages covering its first n_pages pages, one
        more reference each: a prefix entry's half of directory sharing.
        A later write through one of them copies it first (_ptable_set)."""
        tps = self._slot_tps[slot_idx][: -(-n_pages // self._l1_span)]
        for tp in tps:
            self._tp_refs[tp] += 1
        return list(tps)

    def _entry_tps_for_pages(self, pages: list[int]) -> list[int]:
        """Fresh table pages mapping an entry's page list (a span swapped
        back in from the host tier, which no slot's directory holds)."""
        span = self._l1_span
        tps = []
        for c in range(-(-len(pages) // span)):
            tp = self._tp_claim()
            part = pages[c * span: (c + 1) * span]
            self.h_l0[tp, : len(part)] = part
            tps.append(tp)
        return tps

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
        return self._prefix_span_bytes(self.ecfg.kv_page_size)

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
                faults.fire("page_spill")
                hk, hv = self._pages_to_host([pages[c] for c in cand])
            except Exception as e:  # noqa: BLE001 — the pages stay hot, attention stays exact
                self._jnote_fault(e)
                if not isinstance(e, faults.InjectedFault):
                    log.exception("cold-page spill failed (slot %d)", i)
                self.m_kv_spill_skips += len(cand)
                self._spill_cursor[i] = cand[-1] + 1
                continue
            for j, c in enumerate(cand):
                self._slot_spill[i][c] = (hk[:, j:j + 1], hv[:, j:j + 1])
                self._pages_release([pages[c]])
                pages[c] = -1
                self._table_set(i, c, self._scratch_page)
                self._spill_cursor[i] = c + 1
            nbytes = len(cand) * pb
            self._spill_bytes += nbytes
            self.m_kv_pages_spilled += len(cand)
            self.m_kv_spill_bytes_out += nbytes
            done += len(cand)
            self._jnote("page_spill", slot=i, a=float(len(cand)), b=float(nbytes))

    def _pages_to_host(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Copy pool pages to host tensors [L, n, page, K, Hd] (pinned on the
        card). The gather and the copy go on the engine's one stream before
        the pages are released, so no later write to a recycled page can
        overtake them; nothing waits for the copy."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        return self._to_host(self.cache.k[:, idx]), self._to_host(self.cache.v[:, idx])

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of a device tensor, pinned on the card, copied on
        the engine's stream without waiting."""
        if t.numel() == 0:  # MLA's zero-width V: nothing to pin or copy
            return torch.empty(t.shape, dtype=t.dtype)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.device.type == "cuda")
        host.copy_(t, non_blocking=True)
        return host

    # ------------------------------------------------------------------ #
    # Chunked prefill: a long prompt admits chunk by chunk, one chunk
    # between two decode blocks. Mid chunks write K/V only; the final chunk
    # also samples the first token and installs the slot.
    # ------------------------------------------------------------------ #

    def _chunkable(self, request: GenRequest, match_len: int = 0) -> bool:
        """Whether a prompt admits chunk by chunk. Every prefix hit on a
        paged pool does (its chunks start at the page-aligned match, and
        B2's prefix walk reads the shared pages in place), as does a prompt
        whose uncached tail is longer than prefill_chunk (on a dense cache a
        hit with a shorter tail takes the cached single-shot path). Adapter
        prompts never do: the chunk pass carries no per-slot LoRA operand
        (as in the JAX package), so they admit single-shot. Under the sink +
        window every paged admission longer than one chunk takes the
        chunks' masked prefix walk; shorter misses stay single-shot, exact
        there because each query's window covers the whole prompt (chunk <=
        window)."""
        if request.adapter is not None or _multimodal(request):
            return False  # image prompts too: their span and streams cover the whole prompt
        C = self.ecfg.prefill_chunk
        if self._paged:
            return bool(match_len) or (bool(C) and len(request.prompt_ids) > C)
        return bool(C) and len(request.prompt_ids) - match_len > C

    def _chunk_len(self) -> int:
        """Tokens a chunk prefills: prefill_chunk, or with chunking off (a
        paged prefix hit) the whole tail as one final chunk."""
        return self.ecfg.prefill_chunk or self.ecfg.max_seq

    def _chunk_admit_rows(self, total_len: int, match_len: int = 0) -> int:
        """Rows a chunked admission covers: the matched prefix, whole mid
        chunks and the final tail's bucket (padding included)."""
        C = self._chunk_len()
        mids, rem = 0, total_len - match_len
        while rem > C:
            rem -= C
            mids += 1
        return match_len + mids * C + self._bucket_for(max(rem, 1))

    def _chunk_start(self, request: GenRequest, handle: RequestHandle,
                     hit: Optional[tuple] = None) -> bool:
        """Reserve a slot and the pages the chunks write (plus headroom) and
        queue the chunked admission. A prefix hit (entry, match_len) maps
        the span's pages read-only ahead of fresh ones and starts the
        chunks at match_len; a host-tier span is swapped back in first, and
        degrades to a miss when the pool cannot take it. Returns False,
        with the request back at the queue head, when the pool cannot cover
        the admission."""
        ids = request.prompt_ids
        slot_idx = next(i for i, s in enumerate(self.slots) if s is None)
        entry, match_len = hit if hit is not None else (None, 0)
        if entry is not None and "hk" in entry:
            entry = self._prefix_promote(entry)
        if entry is not None and not any(e is entry for e in self._prefix_entries):
            entry = None  # not promoted, or evicted since the find
        if entry is None:
            match_len = 0
        table_row = None
        if self._paged:
            table_row = self._chunk_pages(request, handle, slot_idx, entry, match_len)
            if table_row is None:
                return False
        else:
            # Dense: pin the idle slot's carried position at S - 1 first, so
            # the decode blocks' idle writes land past the rows the chunks
            # write; a hit's span seeds the slot's rows, which the chunks
            # then read as their prefix.
            self.d_positions[slot_idx] = self.ecfg.max_seq - 1
            if entry is not None:
                llama.write_rows_to_cache(self.cache, slot_idx, entry["k"], entry["v"], 0)
        if entry is not None:
            self._prefix_bump(entry)
            self.m_prefix_hits += 1
            self.m_prefix_tokens += match_len
            self._note_prefix_hit(handle, slot_idx, match_len)
        self.slots[slot_idx] = _Slot(request=request, handle=handle, prompt_len=len(ids),
                                     sched_rows=len(ids), t_submit=handle.t_submit)
        self._chunkings.append({"request": request, "handle": handle, "slot": slot_idx,
                                "ids": ids, "offset": match_len, "t0": time.monotonic(),
                                "table_row": table_row})
        return True

    def _note_prefix_hit(self, handle: RequestHandle, slot_idx: int, match_len: int) -> None:
        self._jnote("prefix_hit", rid=handle.rid, slot=slot_idx, a=float(match_len))
        if handle.trace is not None:
            handle.trace.note("prefix_hit", matched_tokens=match_len)

    def _chunk_pages(self, request: GenRequest, handle: RequestHandle, slot_idx: int,
                     entry: Optional[dict], match_len: int) -> Optional[np.ndarray]:
        """A paged chunked admission's table: the hit's span read-only,
        then fresh pages for the rows the chunks write (plus headroom).
        None, with the request back at the queue head, when the pool cannot
        cover it."""
        ids = request.prompt_ids
        page = self.ecfg.kv_page_size
        shared = entry["pages"][: match_len // page] if entry is not None else []
        rows = self._chunk_admit_rows(len(ids), match_len)
        base = -(-rows // page) - len(shared)
        worst = max(rows, min(len(ids) + request.max_new_tokens, self.ecfg.max_seq))
        cap = max(base, -(-worst // page) - len(shared))
        fresh = min(base + self.ecfg.kv_page_headroom, cap)
        if len(self._free_pages) < fresh:
            self._prefix_evict_for_pages(fresh, protect=[entry] if entry is not None else [])
        table_row = self._pages_alloc(
            slot_idx, fresh, shared=shared,
            shared_tps=entry.get("tps") if entry is not None else None)
        if table_row is None:
            with self._pending_lock:
                self._pending.appendleft((request, handle))
            return None
        # The slot stays on SCRATCH until its final chunk: decode blocks
        # write every slot each step, and must not reach pages this
        # prefill owns. The chunk dispatches carry the real row (the
        # directory row, hierarchical: table-page contents ride current).
        if self._hier:
            self.h_l1[slot_idx, :] = self._scratch_tp
        else:
            self.h_ptable[slot_idx] = self._scratch_page
        return table_row

    def _advance_chunked(self) -> bool:
        """Run the next chunk of the oldest chunked admission. Returns
        whether anything happened."""
        if not self._chunkings:
            return False
        st = self._chunkings[0]
        slot_idx = st["slot"]
        if st["handle"].cancelled.is_set():
            st["handle"]._q.put(TokenEvent(kind="done", finish_reason="stop"))
            self._fork_group_requeue(st["request"])
            self._release(slot_idx)
            return True
        if self.h_active.any():
            self.m_chunks_interleaved += 1
        C = self._chunk_len()
        try:
            if len(st["ids"]) - st["offset"] > C:
                self._dispatch_chunk(st, C)
                st["offset"] += C
            else:
                self._chunkings.pop(0)
                self._dispatch_chunk_final(st)
        except Exception as e:  # noqa: BLE001 — fail the request, keep serving
            log.exception("chunked prefill dispatch failed (slot %d)", slot_idx)
            self._jnote("error", a=1.0)
            self._jnote_fault(e)
            ev = TokenEvent(kind="error", error=f"{type(e).__name__}: {e}")
            st["handle"]._q.put(ev)
            self._fork_group_fail(st["request"], ev)
            self._release(slot_idx)
        return True

    def _dispatch_chunk(self, st: dict, n: int, with_logits: bool = False):
        """Prefill `n` tokens of a chunked admission at its offset against
        the rows already written for it, writing theirs (the final tail is
        bucketed). Paged, through its pages (B2's prefix walk); dense,
        `prefill_tail` over the slot's rows up to the read window
        _bucket_for(offset), its rows written after them, and the slot's
        carried position pinned at S - 1 again. Returns the last token's
        logits [1, V], or None."""
        faults.fire("device_dispatch")
        offset = st["offset"]
        seg = st["ids"][offset: offset + n]
        toks = np.zeros((1, self._bucket_for(len(seg)) if with_logits else n), np.int64)
        toks[0, : len(seg)] = seg
        dev = self.device
        d_toks = torch.from_numpy(toks).to(dev)
        d_len, d_off = torch.tensor([len(seg)], device=dev), torch.tensor([offset], device=dev)
        if self._paged:
            logits, _ = llama.prefill_chunk_paged(
                self.cfg, self.params, d_toks, d_len, d_off,
                self.cache, self._device_table(st["table_row"][None]),
                with_logits=with_logits, kv_scale=self._kv_scales)
        else:
            s, pwin = st["slot"], self._bucket_for(max(offset, 1))
            logits, tks, tvs = llama.prefill_tail(
                self.cfg, self.params, d_toks, d_len, d_off,
                self.cache.k[:, s:s + 1, :pwin], self.cache.v[:, s:s + 1, :pwin])
            llama.write_rows_to_cache(self.cache, s, tks, tvs, offset)
            self.d_positions[s] = self.ecfg.max_seq - 1
            if not with_logits:
                logits = None
        self.m_prefill_chunks += 1
        if not with_logits:
            self._jnote("chunk", rid=st["handle"].rid, slot=st["slot"], a=float(n))
        return logits

    def _dispatch_chunk_final(self, st: dict) -> None:
        """The last <= prefill_chunk tokens: prefill, first-token sample and
        slot activation."""
        request, handle, s = st["request"], st["handle"], st["slot"]
        ids = st["ids"]
        logits = self._dispatch_chunk(st, len(ids) - st["offset"], with_logits=True)
        samp, bias_rows, seeds = self._request_controls([(request, handle)])
        dev = self.device
        route = self._grammar_route(request)
        full = torch.as_tensor(np.asarray([ids], np.int64)).to(dev)
        toks, tk, lp = self._install_first(logits, full, torch.tensor([len(ids)], device=dev),
                                           samp, bias_rows, seeds, [s], route,
                                           request.logprobs > 0)
        toks_host, cands, lps = self._first_host(toks, tk, lp)
        # Publish the real table: blocks from here on read and write it.
        if self._hier:
            self.h_l1[s] = st["table_row"]
        elif self._paged:
            self.h_ptable[s] = st["table_row"]
        self.m_chunked_admits += 1
        self._claim_slot(s, request, handle, int(seeds[0]), st["t0"], route)
        self._jnote("admitted", rid=handle.rid, slot=s, a=float(len(ids)), b=1.0)
        self._admission_save(s, request)
        if request.fork_group is not None:
            self._fork_after_admit(s, request, logits, route)
        self._post_first(s, int(toks_host[0]), None if cands is None else cands[0],
                         None if lps is None else lps[0])

    # ------------------------------------------------------------------ #
    # Tree sampling: a same-prompt group (n > 1, best_of) admits ONE
    # prefill and forks the primary's slot per branch: each branch takes a
    # reference on the full prompt pages (whole table pages too), a private
    # copy of the partly filled boundary page, and samples its own first
    # token from the primary's final logits by the clone admission's own
    # recipe (_install_first). fork() forks a live stream mid-way.
    # ------------------------------------------------------------------ #

    def _fork_supported(self, requests: list[GenRequest]) -> bool:
        """Whether a group can admit by forking: a paged pool with
        fork_sampling, and every branch agreeing on what shapes the
        prompt's K/V and the first token's mask (the adapter, the logit
        bias, grammar or none). Resumed requests clone, and so does every
        group of an engine with a draft model, as in the reference."""
        if not (self._paged and self.ecfg.fork_sampling) or self.draft_cfg is not None:
            return False
        r0 = requests[0]
        b0 = r0.logit_bias or {}
        g0 = r0.grammar is not None
        for r in requests:
            if r.resume is not None or r.adapter != r0.adapter or _multimodal(r):
                return False
            if (r.logit_bias or {}) != b0 or (r.grammar is not None) != g0:
                return False
        return True

    def _pages_fork_need(self, request: GenRequest) -> int:
        """Fresh pages one forked branch claims: its copy of the partly
        filled boundary page (if the prompt does not end on a page) plus
        decode headroom, never past what it could write beyond the shared
        span. The rest it shares with the primary."""
        page = self.ecfg.kv_page_size
        plen = len(request.prompt_ids)
        partial = 1 if plen % page else 0
        cap = max(partial, self._pages_worst(request) - plen // page)
        return min(partial + self.ecfg.kv_page_headroom, cap)

    def submit_fork(self, requests: list[GenRequest]) -> list[RequestHandle]:
        """Admit a group of same-prompt requests with ONE prefill: the
        first is the primary and takes the ordinary admission (single-shot,
        chunked or a prefix hit); the rest fork off its slot right after
        its prefill. An engine or group that cannot fork (dense cache,
        fork_sampling off, mixed adapters / bias / grammar) submits N
        independent requests: the same outputs, N prefills. Returns one
        handle per request, in order."""
        if not requests:
            return []
        if len(requests) == 1:
            return [self.submit(requests[0])]
        p0 = list(requests[0].prompt_ids)
        for r in requests[1:]:
            if list(r.prompt_ids) != p0:
                raise ValueError("submit_fork requires identical prompts across the group")
        if not self._fork_supported(requests):
            return [self.submit(r) for r in requests]
        branches = []
        limit = self.ecfg.max_seq - 1
        for r in requests[1:]:
            ids = list(r.prompt_ids)
            if len(ids) > limit:  # submit()'s truncation, as the primary's
                ids = [ids[0]] + ids[-(limit - 1):]
            rr = dataclasses.replace(r, prompt_ids=ids, fork_group=None)
            bh = self._new_handle(rr)
            self._jstage("queued", rid=bh.rid, a=float(len(ids)))
            branches.append((rr, bh))
        primary = dataclasses.replace(requests[0], fork_group=branches)
        try:
            h0 = self.submit(primary)
        except BaseException as e:
            # The branch handles never reach the loop: close them here.
            for _r, bh in branches:
                bh._q.put(TokenEvent(kind="error", error=f"fork submit failed: {e}"))
            raise
        if self._loop_dead is not None:
            # submit() saw a dead loop and errored the primary; nothing
            # will ever detach the group. A duplicate terminal is harmless.
            for _r, bh in branches:
                bh._q.put(TokenEvent(kind="error", error=self._loop_dead))
        return [h0] + [bh for _r, bh in branches]

    def _fork_group_fail(self, request: GenRequest, event: TokenEvent) -> None:
        """A fork primary's terminal event goes to every branch handle (the
        branches never reach _pending, so no other path would close them)."""
        group = request.fork_group
        if not group:
            return
        request.fork_group = None
        for _r, h in group:
            h._q.put(dataclasses.replace(event))

    def _fork_group_requeue(self, request: GenRequest) -> None:
        """The fork primary was cancelled before its admission: its live
        branches requeue as independent requests (each pays its own
        prefill), cancelled ones get their terminal event. Takes
        _pending_lock."""
        group = request.fork_group
        if not group:
            return
        request.fork_group = None
        live = []
        for r, h in group:
            if h.cancelled.is_set():
                h._q.put(TokenEvent(kind="done", finish_reason="stop"))
            else:
                live.append((r, h))
        if not live:
            return
        with self._pending_lock:
            dead = self._loop_dead
            if dead is None:
                self._pending.extend(live)
        if dead is not None:
            for _r, h in live:
                h._q.put(TokenEvent(kind="error", error=dead))
            return
        self._wake.set()

    def _dispatch_fork_primary(self, item: tuple, slot_idx: int) -> bool:
        """A fork primary's single-shot admission, budgeting the pages of
        the whole tree when the pool can ever hold it. Returns False, with
        the primary back at the queue head, on pool backpressure; a failed
        admission fails the whole group."""
        request, handle = item
        need = self._pages_needed(request)
        tree = need + sum(self._pages_fork_need(r) for r, _h in request.fork_group)
        if tree <= self.ecfg.kv_pages:
            need = tree
        if need > len(self._free_pages):
            self._prefix_evict_for_pages(need)
        if need > len(self._free_pages):
            with self._pending_lock:
                self._pending.appendleft(item)
            return False
        self._note_admitted(handle)
        try:
            self._dispatch_admit([item], self._bucket_for(len(request.prompt_ids)), [slot_idx])
        except Exception as e:  # noqa: BLE001 — surface to callers, keep serving
            self._admission_failed([item], e, "fork primary admission")
        return True

    def _fork_after_admit(self, src: int, request: GenRequest, logits: torch.Tensor,
                          route=None) -> None:
        """Admit the primary's branches by forking its freshly admitted
        slot, before anything else touches it: each branch references the
        full prompt pages (and, hierarchical, the whole table pages over
        them), gets a private copy of the boundary page, and samples its
        first token from the primary's final logits [1, V]. Branches that
        cannot fork (no free slot, pool pressure, an adapter pin failure, a
        failed dispatch) admit as clones through _pending."""
        branches, request.fork_group = request.fork_group, None
        if not branches:
            return
        page = self.ecfg.kv_page_size
        plen = len(request.prompt_ids)
        nfull, partial = divmod(plen, page)
        src_pages = list(self._slot_pages[src])
        clones, forked, copies = [], [], []
        taken: set[int] = set()
        for r, h in branches:
            if h.cancelled.is_set():
                h._q.put(TokenEvent(kind="done", finish_reason="stop"))
                continue
            dst = next((i for i, s in enumerate(self.slots) if s is None and i not in taken),
                       None)
            if dst is None:
                clones.append((r, h))
                continue
            need = self._pages_fork_need(r)
            if len(self._free_pages) < need:
                self._prefix_evict_for_pages(need)
            try:
                # An injected fork failure (or allocator fault): the branch
                # degrades to a clone admission, the journal records it.
                faults.fire("slot_fork")
                row = self._pages_alloc(dst, need, shared=src_pages[:nfull],
                                        shared_tps=self._slot_tps[src] if self._hier else None)
            except Exception as e:  # noqa: BLE001 — this branch clones
                self._jnote_fault(e)
                if not isinstance(e, faults.InjectedFault):
                    log.exception("fork allocation failed: the branch admits as a clone")
                clones.append((r, h))
                continue
            if row is None:
                clones.append((r, h))
                continue
            arow = 0
            if r.adapter:
                try:
                    arow = self._adapter_acquire(r.adapter)
                except Exception as e:  # noqa: BLE001 — this branch clones
                    self._jnote_fault(e)
                    self._pages_free(dst)
                    clones.append((r, h))
                    continue
            if partial:
                copies.append((src_pages[nfull], self._slot_pages[dst][nfull]))
            taken.add(dst)
            forked.append((dst, r, h, arow))
        if forked:
            try:
                self._dispatch_fork(request.prompt_ids, forked, copies, logits, route, src)
                self.m_forks += len(forked)
            except Exception as e:  # noqa: BLE001 — degrade to clones, keep serving
                log.exception("fork dispatch failed: %d branches admit as clones",
                              len(forked))
                self._jnote("error", a=float(len(forked)))
                self._jnote_fault(e)
                for dst, r, h, arow in forked:
                    if self.slots[dst] is not None:
                        self._release(dst)
                    else:
                        self._pages_free(dst)
                        self._adapter_unpin(arow)
                    clones.append((r, h))
        if clones:
            self.m_fork_clone_fallbacks += len(clones)
            with self._pending_lock:
                self._pending.extend(clones)
            self._wake.set()

    def _dispatch_fork(self, prompt_ids: list[int], forked: list, copies: list,
                       logits: torch.Tensor, route, src: int) -> None:
        """Device work and slot installs of a fork set: the boundary-page
        copies first (on the one stream, before any block writes a copy),
        then each branch's first token by the clone admission's recipe on
        the primary's logits (its own seed, noise keyed by the prompt
        length, penalty counts of the prompt), one host read, the slots.
        `src` is the primary's slot (the branches' forked journal events)."""
        dev = self.device
        if copies:
            sidx = torch.as_tensor([a for a, _b in copies], dtype=torch.int64, device=dev)
            didx = torch.as_tensor([b for _a, b in copies], dtype=torch.int64, device=dev)
            for pool in (self.cache.k, self.cache.v):
                pool[:, didx] = pool[:, sidx]
        nb = len(forked)
        group = [(r, h) for _d, r, h, _a in forked]
        dsts = [d for d, _r, _h, _a in forked]
        samp, bias_rows, seeds = self._request_controls(group)
        prompt = torch.as_tensor(np.asarray([prompt_ids] * nb, np.int64)).to(dev)
        lens = torch.full((nb,), len(prompt_ids), dtype=torch.int64, device=dev)
        with_lp = any(r.logprobs > 0 for r, _h in group)
        toks, tk, lp = self._install_first(logits.expand(nb, -1).contiguous(), prompt, lens,
                                           samp, bias_rows, seeds, dsts, route, with_lp)
        toks_host, cands, lps = self._first_host(toks, tk, lp)
        t0 = time.monotonic()
        for j, (dst, r, h, arow) in enumerate(forked):
            self._note_admitted(h)
            self._claim_slot(dst, r, h, int(seeds[j]), t0, route)
            self.h_adapter[dst] = arow
            self._jnote("forked", rid=h.rid, slot=dst, a=float(len(prompt_ids)), b=float(src))
            if h.trace is not None:
                h.trace.note("forked", source_slot=src)
        for j, dst in enumerate(dsts):
            if self.slots[dst] is not None:
                self._post_first(dst, int(toks_host[j]), None if cands is None else cands[j],
                                 None if lps is None else lps[j])

    def fork(self, handle: RequestHandle, n: int = 1,
             seeds: Optional[list] = None) -> list[RequestHandle]:
        """Fork a live stream `n` ways at its current position: each branch
        inherits the prompt and the generation so far (paged: the K/V
        shared by page references, the boundary page copied) and decodes on
        with a seed of its own. Branch streams carry only the tokens after
        the fork. Runs on the loop thread between its iterations; a source
        that is no active stream by then gives each branch an error event.
        A dense engine requeues prompt + generation as a fresh request. A
        mid-stream fork has no clone to equal: no clone continues a
        stream. Thread-safe."""
        if n < 1:
            raise ValueError("fork n must be >= 1")
        if seeds is not None and len(seeds) != n:
            raise ValueError(f"fork got {len(seeds)} seeds for n={n}")
        out = []
        for _ in range(n):
            bh = RequestHandle()
            bh.t_submit = time.monotonic()
            bh.rid = f"h{id(bh):x}"
            out.append(bh)
        entry = (handle, list(seeds) if seeds is not None else [None] * n, out)
        with self._fork_lock:
            self._fork_requests.append(entry)
        # After the append: a loop that died drained the staged forks under
        # _fork_lock after setting _loop_dead, so a live read means ours is
        # still ahead of any drain.
        dead = self._loop_dead
        if dead is not None:
            with self._fork_lock:
                self._fork_requests = [e for e in self._fork_requests if e is not entry]
            for bh in out:
                bh._q.put(TokenEvent(kind="error", error=dead))
            return out
        self._wake.set()
        return out

    def _service_forks(self) -> None:
        """Run the mid-stream forks fork() staged (loop thread, between
        iterations: nothing is in flight, so every live slot's device rows
        match its host state)."""
        if not self._fork_requests:
            return
        with self._fork_lock:
            staged, self._fork_requests = self._fork_requests, []
        for src_handle, seeds, handles in staged:
            src = next((i for i, s in enumerate(self.slots)
                        if s is not None and s.handle is src_handle and self.h_active[i]), None)
            if src is None:
                for bh in handles:
                    bh._q.put(TokenEvent(kind="error",
                                         error="fork source is not an active stream"))
                continue
            self._fork_midstream(src, seeds, handles)

    def _on_loop(self, fn):
        """fn() run on the loop thread between two of its iterations; its
        result returned, or its error raised, to the caller.

        Why the loop thread and not a lock: the loop captures and replays
        decode blocks on the shared capture stream and grows the kernels'
        shared split workspaces (kernels.live_workspaces) while it runs a
        block; a forward from another thread meanwhile would race both.
        Between iterations nothing is in flight. With no loop (never
        started, or stopped) fn runs on the caller's thread. A loop that is
        dead, or dies or stops while the call waits, raises its error:
        `_fail_jobs` drains what it staged, and the wait polls the thread,
        so no caller hangs."""
        loop = self._thread
        if loop is None or threading.current_thread() is loop:
            if self._loop_dead is not None or self.params is None:
                raise RuntimeError(self._loop_dead or "engine stopped")
            return fn()
        job = _LoopJob(fn)
        with self._job_lock:
            self._jobs.append(job)
        # After the append, as in fork(): a loop that died drained the
        # staged jobs under _job_lock after setting _loop_dead.
        if self._loop_dead is not None:
            self._fail_jobs(self._loop_dead)
        self._wake.set()
        while not job.done.wait(0.1):
            if not loop.is_alive():
                self._fail_jobs(self._loop_dead or "engine stopped")
        if job.error is not None:
            raise job.error
        return job.result

    def _service_job(self) -> bool:
        """Run the oldest call `_on_loop` staged (loop thread, between
        iterations). One an iteration: queued forwards take turns with the
        decode blocks, so a live stream stalls for one forward at a time,
        not for the sum of the queue. A call that raises fails its caller,
        not the loop; if the loop dies, its guard fails the calls still
        staged. The call's time goes to m_loop_jobs_ms, outside the phase
        vector: it is the caller's forward, not loop overhead. Returns
        whether a call ran."""
        if not self._jobs:
            return False
        with self._job_lock:
            if not self._jobs:
                return False
            job = self._jobs.pop(0)
            more = bool(self._jobs)
        t0 = time.monotonic()
        try:
            job.result = job.fn()
        except Exception as e:  # noqa: BLE001 — the caller's error
            job.error = e
        except BaseException as e:
            job.error = RuntimeError(f"engine loop died: {type(e).__name__}: {e}")
            raise
        finally:
            job.done.set()
            self.m_loop_jobs += 1
            self.m_loop_jobs_ms += (time.monotonic() - t0) * 1000.0
        if more:
            self._wake.set()  # the next one after this iteration's block
        return True

    def _fail_jobs(self, reason: str) -> None:
        """End every staged `_on_loop` call with RuntimeError(reason)."""
        with self._job_lock:
            staged, self._jobs = self._jobs, []
        for job in staged:
            job.error = RuntimeError(reason)
            job.done.set()

    def _fork_midstream(self, src: int, seeds: list, handles: list) -> None:
        """Fork one live slot. Paged: reference the full pages below the
        boundary (the rows written so far), copy the boundary page, copy
        the slot's device rows (counts, bias, token, position, DFA state)
        and give the branch a seed mixed from the source's and a salt.
        Dense: prompt + generation requeue as a fresh request whose stream
        continues from the fork point."""
        slot = self.slots[src]
        req0 = slot.request
        gen = list(slot.generated)
        boundary = slot.prompt_len + max(0, len(gen) - 1)
        page = self.ecfg.kv_page_size
        for j, bh in enumerate(handles):
            seed = seeds[j]
            salt = (int(seed) & 0x7FFFFFFF if seed is not None
                    else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF)
            rg = copy.deepcopy(req0.grammar) if req0.grammar is not None else None
            if not self._paged:
                r = dataclasses.replace(
                    req0, prompt_ids=list(req0.prompt_ids) + gen, fork_group=None, resume=None,
                    grammar=rg, seed=int(seed) if seed is not None else req0.seed,
                    max_new_tokens=max(1, req0.max_new_tokens - len(gen)))
                with self._pending_lock:
                    self._pending.append((r, bh))
                self.m_fork_clone_fallbacks += 1
                self._wake.set()
                continue
            dst = next((i for i, s in enumerate(self.slots) if s is None), None)
            nfull, partial = divmod(boundary, page)
            src_pages = list(self._slot_pages[src])
            need = min((1 if partial else 0) + self.ecfg.kv_page_headroom,
                       max(1 if partial else 0, self._pages_worst(req0) - nfull))
            row = None
            if dst is not None:
                if len(self._free_pages) < need:
                    self._prefix_evict_for_pages(need)
                try:
                    row = self._pages_alloc(dst, need, shared=src_pages[:nfull],
                                            shared_tps=self._slot_tps[src] if self._hier
                                            else None)
                except Exception as e:  # noqa: BLE001 — fail this branch only
                    self._jnote_fault(e)
                    bh._q.put(TokenEvent(kind="error",
                                         error=f"fork failed: {type(e).__name__}: {e}"))
                    continue
            if row is None:
                bh._q.put(TokenEvent(kind="error", error="fork failed: no slot/page capacity"))
                continue
            arow = 0
            if req0.adapter:
                try:
                    arow = self._adapter_acquire(req0.adapter)
                except Exception as e:  # noqa: BLE001 — fail this branch only
                    self._jnote_fault(e)
                    self._pages_free(dst)
                    bh._q.put(TokenEvent(kind="error", error="fork failed: adapter pin"))
                    continue
            if partial:
                sp, dp = src_pages[nfull], self._slot_pages[dst][nfull]
                for pool in (self.cache.k, self.cache.v):
                    pool[:, dp] = pool[:, sp]
            for t in (self.counts, self.bias, self.d_tokens, self.d_positions, self.d_gstate,
                      self.d_rope_delta):
                if t is not None:
                    t[dst] = t[src]
            self.h_rope_delta[dst] = self.h_rope_delta[src]
            new_seed = (int(self.h_seed[src]) * 1000003 + salt) & 0x7FFFFFFF
            self.d_seed[dst] = new_seed
            self.h_seed[dst] = new_seed
            r = dataclasses.replace(req0, prompt_ids=list(req0.prompt_ids), fork_group=None,
                                    resume=None, grammar=rg,
                                    seed=int(seed) if seed is not None else req0.seed)
            for k in _SAMPLING_FIELDS:
                self.h_sampling[k][dst] = getattr(r, k)
            ns = _Slot(request=r, handle=bh, prompt_len=slot.prompt_len, generated=list(gen),
                       emitted_len=slot.emitted_len, scheduled=len(gen), sched_rows=boundary,
                       t_submit=bh.t_submit, dfa=slot.dfa)
            ns.t_admit = ns.t_first = time.monotonic()
            self.slots[dst] = ns
            self.h_active[dst] = True
            self.h_gmask[dst] = self.h_gmask[src]
            self.h_adapter[dst] = arow
            self.m_forks += 1
            self._note_admitted(bh)
            self._jnote("forked", rid=bh.rid, slot=dst, a=float(boundary), b=float(src))

    # ------------------------------------------------------------------ #
    # Prefix cache (loop thread only): an LRU of prefilled K/V spans keyed
    # by token prefixes. Dense entries copy the slot's rows; paged entries
    # hold references on its full pages (copy on write: a slot maps them
    # read-only and writes only rows past the span) and, hierarchical, on
    # the table pages covering them. Spans evicted for pool pressure move
    # to the pinned host tier, and a later hit swaps them back in.
    # ------------------------------------------------------------------ #

    @property
    def _prefix_enabled(self) -> bool:
        return self.ecfg.prefix_cache_entries > 0

    @staticmethod
    def _cached_admit_ok(request: GenRequest) -> bool:
        """Adapter requests never use the prefix cache, in either
        direction: their wk / wv deltas make the K/V rows the tenant's.
        Nor do image requests: their placeholder ids are zeros, so a span
        keyed by them would hand one image's rows to a request with the
        same text and another image (and m-rope rows are rotated by their
        streams, not by their row positions)."""
        return request.adapter is None and not _multimodal(request)

    def _prefix_span_bytes(self, rows: int) -> int:
        """Device bytes of `rows` K and V rows over every layer, in the
        cache's storage dtype (under MLA the latent K row alone: V is
        zero-width)."""
        k, v = self.cache.k, self.cache.v
        return k.shape[0] * rows * k.shape[-2] * (k.shape[-1] + v.shape[-1]) * k.element_size()

    def _prefix_find(self, prompt_ids: list[int]) -> Optional[tuple[dict, int]]:
        """The longest common prefix with a stored span, as (entry,
        match_len), or None. On a paged pool the match rounds down to a
        page (a slot writes only fresh pages). At least one tail token is
        left to prefill; a match under prefix_cache_min, or whose tail does
        not fit behind it, is a miss. The host tier wins only with a
        strictly longer match, since it must be swapped in first."""
        if not self._prefix_enabled or len(prompt_ids) < 2:
            return None
        prompt = np.asarray(prompt_ids, np.int32)
        cap = len(prompt_ids) - 1
        best, best_len = None, 0
        for tier in (self._prefix_entries, self._prefix_host):
            for entry in tier:
                n = min(entry["valid"], cap, len(entry["key"]))
                if n <= best_len:
                    continue
                eq = entry["key"][:n] == prompt[:n]
                match = n if eq.all() else int(np.argmin(eq))
                if self._paged:
                    match -= match % self.ecfg.kv_page_size
                if match > best_len:
                    best, best_len = entry, match
        if best is None or best_len < max(self.ecfg.prefix_cache_min, 1):
            return None
        if best_len + self._bucket_for(len(prompt_ids) - best_len) > self.ecfg.max_seq:
            return None
        return best, best_len

    def _prefix_bump(self, entry: dict) -> None:
        """Move a device-tier entry to the front of the LRU."""
        for idx, e in enumerate(self._prefix_entries):
            if e is entry:
                self._prefix_entries.insert(0, self._prefix_entries.pop(idx))
                return

    def _admission_save(self, slot_idx: int, request: GenRequest) -> None:
        """Save an admitted slot's prompt rows, if they extend the stored
        coverage by at least prefix_cache_min tokens."""
        if self._cached_admit_ok(request):
            self._prefix_save(slot_idx, request.prompt_ids, len(request.prompt_ids),
                              min_extend=self.ecfg.prefix_cache_min)

    def _prefix_save(self, slot_idx: int, key_tokens, valid_len: int,
                     min_extend: int = 0) -> None:
        """Store the slot's rows [0, valid_len) under `key_tokens`: after an
        admission (the prompt, min_extend = prefix_cache_min: a span that
        barely extends a stored one is not worth its copy) and at finish
        (prompt + generated, the next turn's prefix, min_extend = 0). A
        paged entry takes a reference on the slot's full pages below
        valid_len and copies nothing; a slot with spilled cold pages gets
        them back first, and on pool pressure the save is skipped."""
        if not self._prefix_enabled or valid_len < self.ecfg.prefix_cache_min:
            return
        if self._paged:
            n_pages = valid_len // self.ecfg.kv_page_size
            valid_len = n_pages * self.ecfg.kv_page_size
            if valid_len < self.ecfg.prefix_cache_min or n_pages == 0:
                return
            if n_pages * self._page_bytes() > self.ecfg.prefix_cache_bytes:
                return
        key = np.asarray(key_tokens, np.int32)[:valid_len]
        if min_extend:
            cov = 0
            for e in self._prefix_entries:
                n = min(e["valid"], valid_len)
                if n <= cov:
                    continue
                eq = e["key"][:n] == key[:n]
                cov = max(cov, n if eq.all() else int(np.argmin(eq)))
            if cov and valid_len - cov < min_extend:
                return
        if self._paged and self._slot_spill[slot_idx]:
            # A span pins only device pages: restore the spilled ones first,
            # or skip the save (pool pressure, a failed restore; the
            # request is served either way, a missing span only costs a
            # prefill later).
            try:
                restored = self._restore_spilled(slot_idx)
            except Exception as e:  # noqa: BLE001 — degrade to no save
                self._jnote_fault(e)
                if not isinstance(e, faults.InjectedFault):
                    log.exception("spill restore failed (slot %d)", slot_idx)
                restored = False
            if not restored:
                return
        # An entry covering the span makes it redundant; the entries it
        # covers go.
        kept = []
        for e in self._prefix_entries:
            n = min(len(key), e["valid"])
            if e["valid"] >= valid_len and (e["key"][:n] == key[:n]).all():
                return
            if e["valid"] <= valid_len and (e["key"][:e["valid"]] == key[:e["valid"]]).all():
                self._prefix_drop(e)
                continue
            kept.append(e)
        keep_h = []
        for e in self._prefix_host:
            if e["valid"] <= valid_len and (e["key"][:e["valid"]] == key[:e["valid"]]).all():
                self._host_bytes -= e["bytes"]
                continue
            keep_h.append(e)
        self._prefix_host = keep_h
        if self._paged:
            pages = self._slot_pages[slot_idx][:n_pages]
            self._pages_addref(pages)
            entry = {"key": key, "valid": valid_len, "pages": list(pages)}
            if self._hier:
                entry["tps"] = self._entry_tps(slot_idx, n_pages)
            sizes = [len(e["pages"]) * self._page_bytes() for e in [entry] + kept]
        else:
            pb = self._bucket_for(valid_len)
            if self._prefix_span_bytes(pb) > self.ecfg.prefix_cache_bytes:
                self._prefix_entries = kept
                return
            entry = {"key": key, "valid": valid_len, "pb": pb,
                     "k": self.cache.k[:, slot_idx:slot_idx + 1, :pb].clone(),
                     "v": self.cache.v[:, slot_idx:slot_idx + 1, :pb].clone()}
            sizes = [self._prefix_span_bytes(e["pb"]) for e in [entry] + kept]
        kept.insert(0, entry)
        # The LRU bounds: prefix_cache_entries, then prefix_cache_bytes.
        cut = min(len(kept), self.ecfg.prefix_cache_entries)
        total = 0
        for idx in range(cut):
            total += sizes[idx]
            if total > self.ecfg.prefix_cache_bytes:
                cut = idx
                break
        for e in kept[cut:]:
            self._prefix_drop(e)
        self._prefix_entries = kept[:cut]

    def _prefix_drop(self, entry: dict) -> None:
        """Release a device-tier entry's page and table-page references (a
        dense entry's copies are simply freed)."""
        if entry.get("pages"):
            self._pages_release(entry["pages"])
            entry["pages"] = []
        if entry.get("tps"):
            self._tp_release(entry["tps"])
            entry["tps"] = []

    def _prefix_evict_for_pages(self, need: int, protect: Optional[list] = None) -> None:
        """Evict least recently used entries, spilling each to the host
        tier, until `need` pages are free or only `protect`ed entries (the
        ones this admission maps) remain. A live request outranks a span:
        a span can be prefilled again."""
        if not self._paged:
            return
        protect = protect or []
        idx = len(self._prefix_entries) - 1
        while len(self._free_pages) < need and idx >= 0:
            e = self._prefix_entries[idx]
            if not any(e is p for p in protect):
                self._prefix_spill(e)
                self._prefix_drop(e)
                self._prefix_entries.pop(idx)
            idx -= 1

    def _prefix_spill(self, entry: dict) -> None:
        """Copy an evicted span's pages to the host tier, within
        kv_swap_bytes (making room by dropping its oldest spans)."""
        pages = entry.get("pages")
        if not pages or self.ecfg.kv_swap_bytes <= 0:
            return
        nbytes = len(pages) * self._page_bytes()
        if not self._host_make_room(nbytes):
            return
        hk, hv = self._pages_to_host(pages)
        self._prefix_host.insert(0, {"key": entry["key"], "valid": entry["valid"],
                                     "hk": hk, "hv": hv, "bytes": nbytes})
        self._host_bytes += nbytes
        self.m_kv_swap_bytes_out += nbytes

    def _prefix_promote(self, hentry: dict) -> Optional[dict]:
        """Swap a host-tier span back into fresh pages and make it a
        device-tier entry again. Returns the entry, or None (the span goes
        back to the host tier) when the pool cannot take it now: the hit
        then degrades to a miss."""
        npg = hentry["hk"].shape[1]
        # Out of the tier first, so the evictions below cannot drop it.
        self._prefix_host = [e for e in self._prefix_host if e is not hentry]
        self._host_bytes -= hentry["bytes"]
        if len(self._free_pages) < npg:
            self._prefix_evict_for_pages(npg)
        pages = self._pages_claim(npg)
        if pages is None:
            self._prefix_host.insert(0, hentry)
            self._host_bytes += hentry["bytes"]
            return None
        self._pages_from_host(pages, hentry["hk"], hentry["hv"])
        entry = {"key": hentry["key"], "valid": hentry["valid"], "pages": pages}
        if self._hier:
            entry["tps"] = self._entry_tps_for_pages(pages)
        self._prefix_entries.insert(0, entry)
        while len(self._prefix_entries) > self.ecfg.prefix_cache_entries:
            dead = self._prefix_entries.pop()
            self._prefix_spill(dead)
            self._prefix_drop(dead)
        self.m_kv_swap_bytes_in += hentry["bytes"]
        self.m_prefix_host_hits += 1
        return entry

    def _host_make_room(self, need: int) -> bool:
        """Fit `need` bytes into kv_swap_bytes by dropping the oldest host
        spans. Swap images of queued preempted requests are state, not
        cache: they are never dropped."""
        if need > self.ecfg.kv_swap_bytes:
            return False
        while self._host_bytes + need > self.ecfg.kv_swap_bytes and self._prefix_host:
            self._host_bytes -= self._prefix_host.pop()["bytes"]
        return self._host_bytes + need <= self.ecfg.kv_swap_bytes

    def _dispatch_admit_cached(self, request: GenRequest, handle: RequestHandle,
                               slot_idx: int, entry: dict, match_len: int) -> None:
        """A prefix hit on the dense cache: the span's rows go into the
        slot, the tail prefills against them (llama.prefill_tail), its rows
        follow the span, and the first token is sampled with the penalty
        counts of the whole prompt (the JAX package's cached admission)."""
        faults.fire("device_dispatch")
        t0 = time.monotonic()
        ids = request.prompt_ids
        tail = ids[match_len:]
        dev = self.device
        toks = np.zeros((1, self._bucket_for(len(tail))), np.int64)
        toks[0, : len(tail)] = tail
        logits, tks, tvs = llama.prefill_tail(
            self.cfg, self.params, torch.from_numpy(toks).to(dev),
            torch.tensor([len(tail)], device=dev), torch.tensor([match_len], device=dev),
            entry["k"], entry["v"])
        llama.write_rows_to_cache(self.cache, slot_idx, entry["k"], entry["v"], 0)
        llama.write_rows_to_cache(self.cache, slot_idx, tks, tvs, match_len)
        samp, bias_rows, seeds = self._request_controls([(request, handle)])
        route = self._grammar_route(request)
        full = torch.as_tensor(np.asarray([ids], np.int64)).to(dev)
        first, tk, lp = self._install_first(logits, full, torch.tensor([len(ids)], device=dev),
                                            samp, bias_rows, seeds, [slot_idx], route,
                                            request.logprobs > 0)
        toks_host, cands, lps = self._first_host(first, tk, lp)
        self._prefix_bump(entry)
        self.m_prefix_hits += 1
        self.m_prefix_tokens += match_len
        self._claim_slot(slot_idx, request, handle, int(seeds[0]), t0, route)
        self._note_prefix_hit(handle, slot_idx, match_len)
        self._jnote("admitted", rid=handle.rid, slot=slot_idx, a=float(len(ids)))
        self._admission_save(slot_idx, request)
        self._post_first(slot_idx, int(toks_host[0]), None if cands is None else cands[0],
                         None if lps is None else lps[0])

    # ------------------------------------------------------------------ #
    # Host swap tier: page images in pinned host memory. Copies go on the
    # engine's one stream: an image is gathered on the device before its
    # pages are released (no later write to a recycled page overtakes
    # it), and a swap-in lands before the next block; the host never
    # reads an image itself.
    # ------------------------------------------------------------------ #

    def _restore_spilled(self, slot_idx: int) -> bool:
        """Bring a slot's spilled cold pages back into fresh pages, byte for
        byte (a prefix save pins only device pages). Returns False when the
        pool cannot take them now."""
        images = self._slot_spill[slot_idx]
        if not images:
            return True
        faults.fire("page_spill")
        need = len(images)
        if len(self._free_pages) < need:
            self._prefix_evict_for_pages(need)
        fresh = self._pages_claim(need)
        if fresh is None:
            return False
        cols = sorted(images)
        self._pages_from_host(fresh, [images[c][0] for c in cols],
                              [images[c][1] for c in cols])
        pages = self._slot_pages[slot_idx]
        for p, c in zip(fresh, cols):
            pages[c] = p
            self._table_set(slot_idx, c, p)
        self._spill_bytes -= need * self._page_bytes()
        self._slot_spill[slot_idx] = {}
        self._spill_cursor[slot_idx] = 0
        self.m_kv_pages_restored += need
        self._jnote("page_restore", slot=slot_idx, a=float(need),
                    b=float(need * self._page_bytes()))
        return True

    def _pages_from_host(self, pages: list[int], hk, hv) -> None:
        """Write host images (one tensor [L, n, page, K, Hd], or a list of
        them covering `pages` in order) into pool pages, as stored."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for pool, img in ((self.cache.k, hk), (self.cache.v, hv)):
            parts = img if isinstance(img, list) else [img]
            pool[:, idx] = torch.cat([t.to(self.device, non_blocking=True) for t in parts], dim=1)

    def _swap_out_slot_span(self, slot_idx: int, n_live: int):
        """A swap image of the slot's first n_live pages, its spilled cold
        pages spliced in from their host images on the device (not
        restored to the pool first)."""
        faults.fire("host_swap")
        pages = self._slot_pages[slot_idx][:n_live]
        if all(p >= 0 for p in pages):
            return self._pages_to_host(pages)
        idx = torch.as_tensor([p if p >= 0 else self._scratch_page for p in pages],
                              dtype=torch.int64, device=self.device)
        out = []
        for pool, side in ((self.cache.k, 0), (self.cache.v, 1)):
            rows = pool[:, idx]
            for c, img in self._slot_spill[slot_idx].items():
                if c < n_live:
                    rows[:, c] = img[side][:, 0].to(self.device, non_blocking=True)
            out.append(self._to_host(rows))
        return out[0], out[1]

    def _resume_swap_pages(self, request: GenRequest) -> int:
        """Pages a queued swap resume takes: its image's plus headroom,
        within the request's worst case."""
        rec = request.resume
        n_live = rec["hk"].shape[1]
        worst = -(-min(rec["orig_prompt_len"] + request.max_new_tokens, self.ecfg.max_seq)
                  // self.ecfg.kv_page_size)
        return min(n_live + self.ecfg.kv_page_headroom, max(n_live, worst))

    def _resume_discard(self, request: GenRequest) -> None:
        """Give back a queued swap resume's host bytes (it was cancelled or
        drained)."""
        rec = request.resume
        if rec is not None and rec.get("bytes"):
            self._host_bytes -= rec["bytes"]
            rec["bytes"] = 0
            rec.pop("hk", None)
            rec.pop("hv", None)

    def _dispatch_resume_swap(self, request: GenRequest, handle: RequestHandle,
                              slot_idx: int) -> bool:
        """Re-admit a swap-preempted request: pages, the image back into
        them, the slot's device rows (penalty counts, bias, last token, its
        position, seed) and host state. No prefill and no sample: the slot
        decodes on from where it stopped. Returns False when the pool
        cannot cover it (nothing changed); a failed adapter re-pin ends the
        request with an error event. A failed copy raises with nothing
        claimed: the caller ends the request (_admission_failed)."""
        faults.fire("host_swap")
        rec = request.resume
        row_a = 0
        if request.adapter:
            try:
                row_a = self._adapter_acquire(request.adapter)
            except Exception as e:  # noqa: BLE001 — fail one tenant only
                log.exception("adapter re-pin failed on swap resume")
                self._jnote_fault(e)
                self._resume_discard(request)
                handle._q.put(TokenEvent(kind="error", error=f"{type(e).__name__}: {e}"))
                return True
        try:
            if self._pages_alloc(slot_idx, self._resume_swap_pages(request)) is None:
                self._adapter_unpin(row_a)
                return False
            n_live = rec["hk"].shape[1]
            self._pages_from_host(self._slot_pages[slot_idx][:n_live], rec["hk"], rec["hv"])
            dev = self.device
            self.counts[slot_idx] = rec["counts"].to(dev, non_blocking=True)
            self.bias[slot_idx] = rec["bias"].to(dev, non_blocking=True)
            self.d_tokens[slot_idx] = rec["d_tok"]
            self.d_positions[slot_idx] = rec["d_pos"]
            self.d_seed[slot_idx] = rec["seed"]
            if self._mrope:
                self.h_rope_delta[slot_idx] = rec["rope_delta"]
                self.d_rope_delta[slot_idx] = rec["rope_delta"]
        except Exception:
            self._pages_free(slot_idx)
            self._adapter_unpin(row_a)
            raise
        for k in _SAMPLING_FIELDS:
            self.h_sampling[k][slot_idx] = getattr(request, k)
        self.h_seed[slot_idx] = rec["seed"]
        orig = dataclasses.replace(
            request, prompt_ids=list(request.prompt_ids[: rec["orig_prompt_len"]]), resume=None)
        self.slots[slot_idx] = _Slot(
            request=orig, handle=handle, prompt_len=rec["orig_prompt_len"],
            generated=list(rec["generated"]), emitted_len=rec["emitted_len"],
            scheduled=len(rec["generated"]), sched_rows=rec["d_pos"],
            t_submit=rec["t_submit"], t_admit=rec["t_admit"], t_first=rec["t_first"])
        self.h_active[slot_idx] = True
        self.h_adapter[slot_idx] = row_a
        self._host_bytes -= rec["bytes"]
        self.m_kv_swap_bytes_in += rec["bytes"]
        self._jnote("swap_in", rid=handle.rid, slot=slot_idx, a=float(rec["bytes"]))
        return True

    # ------------------------------------------------------------------ #
    # Preemption: swap or recompute
    # ------------------------------------------------------------------ #

    def _preempt_youngest(self) -> None:
        """Free the youngest live slot's pages so growth-blocked older slots
        can go on. The victim's request is requeued at the head as prompt +
        generated, under the same handle and with no terminal event, and
        continues the stream when re-admitted. kv_preempt picks how: a
        swap copies its live pages (spilled ones spliced in) and device
        rows to the host tier, and the swap-in restores them byte for
        byte; a recompute re-admits through the prefill (_apply_resume).
        A swap falls back to recompute when kv_swap_bytes is 0 or the host
        tier cannot make room. The adapter is re-pinned either way (maybe
        into another row). Noise is a pure function of (seed, position),
        so the seed is all the sampler state a slot needs back."""
        live = [i for i, s in enumerate(self.slots) if s is not None and self.h_active[i]]
        # A grammar slot goes last, and always recomputes: a swap could not
        # restore its DFA state into a table set that may have changed.
        cands = [i for i in live if self.slots[i].request.grammar is None]
        grammar_victim = not cands
        cands = cands or live
        if not cands:
            return
        victim = max(cands, key=lambda i: (self.slots[i].t_submit, i))
        slot = self.slots[victim]
        r = slot.request
        ctx_rows = slot.prompt_len + len(slot.generated)
        n_live = min(-(-ctx_rows // self.ecfg.kv_page_size), len(self._slot_pages[victim]))
        span_bytes = n_live * self._page_bytes()
        policy = self.ecfg.kv_preempt
        if grammar_victim or self.draft_cfg is not None:
            # A draft model's dense cache has no swap image: recompute (its
            # rows are prefilled again before the slot's next round). The
            # model-free modes swap: the self-draft scratch syncs from the
            # restored pages.
            policy = "recompute"
        elif policy == "auto":
            policy = "swap" if span_bytes * 4 <= self.ecfg.kv_swap_bytes else "recompute"
        if policy == "swap" and (self.ecfg.kv_swap_bytes <= 0
                                 or not self._host_make_room(span_bytes)):
            policy = "recompute"
        if grammar_victim and slot.dfa:
            # The device DFA never advanced the host machine: replay the
            # generated tokens, so the resume (host walk: a resume never
            # takes the DFA) goes on from the right state.
            for tok in slot.generated:
                self._grammar_advance(r.grammar, int(tok))
        rec = {
            "mode": policy,
            "rope_delta": int(self.h_rope_delta[victim]),
            "orig_prompt_len": slot.prompt_len,
            "generated": list(slot.generated),
            "emitted_len": slot.emitted_len,
            "t_submit": slot.t_submit,
            "t_admit": slot.t_admit,
            "t_first": slot.t_first,
            "seed": int(self.h_seed[victim]),
        }
        if policy == "swap":
            try:
                hk, hv = self._swap_out_slot_span(victim, n_live)
            except Exception as e:  # noqa: BLE001 — a failed swap-out recomputes instead
                self._jnote_fault(e)
                if not isinstance(e, faults.InjectedFault):
                    log.exception("swap-out failed (slot %d): recomputing", victim)
                policy = rec["mode"] = "recompute"
        if policy == "swap":
            rec.update(hk=hk, hv=hv, bytes=span_bytes,
                       counts=self._to_host(self.counts[victim]),
                       bias=self._to_host(self.bias[victim]),
                       d_tok=int(self.d_tokens[victim]), d_pos=int(self.d_positions[victim]))
            self._host_bytes += span_bytes
            self.m_kv_swap_bytes_out += span_bytes
            self.m_kv_preempt_swaps += 1
        else:
            self.m_kv_preempt_recomputes += 1
        resume_req = dataclasses.replace(
            r, prompt_ids=list(r.prompt_ids) + list(slot.generated), resume=rec)
        self.m_kv_preemptions += 1
        self._jnote("preempt", rid=slot.handle.rid, slot=victim, a=float(ctx_rows))
        if policy == "swap":
            self._jnote("swap_out", rid=slot.handle.rid, slot=victim, a=float(span_bytes))
        if slot.handle.trace is not None:
            slot.handle.trace.note("preempt", policy=policy, ctx_rows=ctx_rows)
        self._release(victim)
        with self._pending_lock:
            self._pending.appendleft((resume_req, slot.handle))
        # _growth_blocked stays set: the freed pages go to the starved
        # slots first, not straight back to the victim at the queue head.
        log.info("preempted slot %d (%s, %d rows)", victim, policy, ctx_rows)

    def _apply_resume(self, slot_idx: int) -> None:
        """Turn a freshly admitted slot that is a preempted request back
        into it: its original prompt, its generated tokens and streamed
        text (the next event continues the same handle) and its timings.
        The admission has just sampled the next token."""
        slot = self.slots[slot_idx]
        rec = slot.request.resume
        if rec is None:
            return
        self._jnote("resume", rid=slot.handle.rid, slot=slot_idx,
                    a=float(len(rec["generated"])))
        n = rec["orig_prompt_len"]
        slot.request = dataclasses.replace(
            slot.request, prompt_ids=list(slot.request.prompt_ids[:n]), resume=None)
        slot.prompt_len = n
        slot.generated = list(rec["generated"])
        slot.emitted_len = rec["emitted_len"]
        slot.scheduled = len(slot.generated) + 1
        slot.t_submit, slot.t_admit, slot.t_first = rec["t_submit"], rec["t_admit"], rec["t_first"]

    # ------------------------------------------------------------------ #
    # Grammar-constrained decoding: the device DFA (functions/dfa.py tables
    # in persistent buffers, ops/grammar.py in the block) and the host
    # candidate walk.
    # ------------------------------------------------------------------ #

    def _token_strings(self) -> list[str]:
        if self._tok_strs is None:
            self._tok_strs = self.tokenizer.token_strings()
        return self._tok_strs

    def _token_str(self, tok: int) -> str:
        strs = self._token_strings()
        return strs[tok] if 0 <= tok < len(strs) else ""

    def _tok_fingerprint(self) -> str:
        """A stable identity of the tokenizer's string table for the table
        cache (an id() may be reused after collection and alias two
        tokenizers' tables)."""
        if self._tok_fp is None:
            import hashlib

            strs = self._token_strings()
            h = hashlib.md5()
            h.update(str(len(strs)).encode())
            for t in strs:
                h.update(t.encode("utf-8", "surrogateescape"))
                h.update(b"\x00")
            self._tok_fp = h.hexdigest()
        return self._tok_fp

    def _legacy_grammar_active(self) -> bool:
        """Some live slot's grammar takes the host candidate walk."""
        return any(self.h_active[i] and s is not None and s.request.grammar is not None
                   and not s.dfa for i, s in enumerate(self.slots))

    def _dfa_grammar_active(self) -> bool:
        return any(self.h_active[i] and s is not None and s.dfa
                   for i, s in enumerate(self.slots))

    def prewarm_grammar(self, schema: Any) -> bool:
        """Compile a schema's tables now (pinned in the table cache), so its
        first request already runs on the device DFA; an uncached schema
        otherwise builds off-thread while its first request host-walks. A
        later warmup(grammar=True) grows the device buffers to it and
        captures its DFA blocks. Returns whether the DFA will serve it."""
        tables = dfa_mod.tables_for(
            schema, self._token_strings(), set(self.tokenizer.eos_ids), self.cfg.vocab_size,
            tokenizer_id=self._tok_fingerprint(), pin=True)
        layout = self._dfa_layout(tables) if tables is not None else None
        if layout is None:
            return False
        mode, S_pad, C_pad = layout
        self._dfa_want = (max(self._dfa_want[0], S_pad), max(self._dfa_want[1], C_pad),
                          max(self._dfa_want[2], S_pad if mode == "fast" else 0))
        self._dfa_warm_modes.add(mode)
        return True

    def _grammar_route(self, request: GenRequest) -> Optional[str]:
        """How an admission serves the request's grammar: None (none), the
        device DFA's mode, or "host" (the candidate walk). A resumed
        request keeps the host walk: its machine carries the state a fresh
        DFA start would lose."""
        if request.grammar is None:
            return None
        if request.resume is None:
            tables = self._dfa_for(request)
            if tables is not None:
                return tables["mode"]
        return "host"

    def _dfa_for(self, request: GenRequest) -> Optional[dict]:
        """The active table set for this request's grammar, or None (host
        walk). One set is active at a time, and it changes only while no
        DFA slot is live (their states index it): a second concurrent
        schema host-walks. An uncached schema builds on a daemon thread
        while this request host-walks; the loop never compiles one."""
        schema = getattr(request.grammar, "schema", None)
        if (isinstance(schema, dict) and "__gbnf__" in schema
                and not isinstance(request.grammar, GbnfConstraint)):
            # Only a GbnfConstraint carries the marker: a user's JSON schema
            # holding that key would desync the device and host machines.
            return None
        key = dfa_mod.schema_key(schema)
        if self._dfa is not None and self._dfa["key"] == key:
            return self._dfa
        if self._dfa_grammar_active():
            return None
        tok_strs = self._token_strings()
        if key in self._dfa_building:
            return None
        fp, V = self._tok_fingerprint(), self.cfg.vocab_size
        eos = set(self.tokenizer.eos_ids)
        if not dfa_mod.is_cached(schema, fp, V):
            self._dfa_building.add(key)

            def build() -> None:
                try:
                    dfa_mod.tables_for(schema, tok_strs, eos, V, tokenizer_id=fp)
                finally:
                    self._dfa_building.discard(key)
                    self._wake.set()

            threading.Thread(target=build, daemon=True, name="grammar-dfa-build").start()
            return None
        # cached_only: an entry evicted since the check host-walks this
        # request rather than make the loop the builder.
        tables = dfa_mod.tables_for(schema, tok_strs, eos, V, tokenizer_id=fp, cached_only=True)
        layout = self._dfa_layout(tables) if tables is not None else None
        if layout is None:
            return None
        self._dfa_install(key, tables, layout)
        log.info("grammar DFA ready: %s mode, %d states, schema %.60s...", layout[0],
                 tables.trans.shape[0], key)
        return self._dfa

    def _dfa_layout(self, tables) -> Optional[tuple]:
        """(mode, states bucket, class bucket) of a table set, or None when
        it exceeds the largest bucket."""
        S1, C = tables.trans.shape
        S_pad = next((b for b in self._DFA_STATE_BUCKETS if b >= S1), None)
        C_pad = next((b for b in self._DFA_CLASS_BUCKETS if b >= C), None)
        if S_pad is None or C_pad is None:
            return None
        return ("fast" if tables.next_tok is not None else "walk"), S_pad, C_pad

    def _dfa_buffers(self, S: int, C: int, S_fast: int) -> None:
        """Grow the device table buffers to at least (S, C, S_fast) rows:
        mask and transitions of S states, C classes, a next-token table of
        S_fast states. A growth allocates new buffers, empties them (the
        FREE row only), drops the graphs captured on the old ones and the
        active set (the next _dfa_for copies it in again); the new sizes
        re-key DFA blocks. Loop thread or an idle engine only."""
        want = (max(self._g_dims[0], S), max(self._g_dims[1], C), max(self._g_dims[2], S_fast))
        if want == self._g_dims:
            return
        V, dev = self.cfg.vocab_size, self.device
        self._g_mask = torch.zeros((want[0], -(-V // 8)), dtype=torch.uint8, device=dev)
        self._g_mask[0] = 0xFF  # FREE: every token legal
        self._g_trans = torch.zeros(want[:2], dtype=torch.int16, device=dev)
        self._g_next = (torch.zeros((want[2], V), dtype=torch.int16, device=dev)
                        if want[2] else None)
        if self._g_cls is None:
            self._g_cls = torch.full((V, MAX_TOK_LEN), -1, dtype=torch.int16, device=dev)
        self._g_dims = want
        self._dfa = None
        self._graph_cache = {k: v for k, v in self._graph_cache.items()
                             if all(e[0] != "dfa" for e in k[4:])}

    def _dfa_install(self, key: str, tables, layout: tuple) -> None:
        """Make a table set the active one: copy it into the device buffers
        in place (grown first if it does not fit). Only while no DFA slot
        is live."""
        mode, S_pad, C_pad = layout
        self._dfa_buffers(S_pad, C_pad, S_pad if mode == "fast" else 0)
        S1, C = tables.trans.shape
        self._g_mask.zero_()
        self._g_mask[:S1] = torch.from_numpy(tables.mask_bits).to(self.device)
        self._g_trans.zero_()
        self._g_trans[:S1, :C] = torch.from_numpy(tables.trans).to(self.device)
        if mode == "fast":
            self._g_next.zero_()
            self._g_next[:S1] = torch.from_numpy(tables.next_tok).to(self.device)
        self._g_cls.copy_(torch.from_numpy(tables.tok_cls))
        self._dfa = {"key": key, "mode": mode, "host": tables}

    def _dfa_table(self, mode: str) -> torch.Tensor:
        """The transition buffer a mode reads: next_tok (fast) or trans."""
        return self._g_next if mode == "fast" else self._g_trans

    def _first_char_buckets(self) -> dict[str, list[int]]:
        """Token ids by first character (once per tokenizer): the host
        walk's last resort scans only the buckets its machine allows."""
        if self._fc_buckets is None:
            buckets: dict[str, list[int]] = {}
            eos = set(self.tokenizer.eos_ids)
            for tok in range(self.cfg.vocab_size):
                if tok in eos:
                    continue
                t = self._token_str(tok)
                if t:
                    buckets.setdefault(t[0], []).append(tok)
            self._fc_buckets = buckets
        return self._fc_buckets

    def _grammar_pick(self, slot_idx: int, tok: int, cands, admission: bool = False):
        """The token a slot emits for the sampled `tok`: itself, or for a
        host-walk slot its grammar's choice from `cands` (then the slot's
        next input; the penalty counts keep the sampled token). None when
        the grammar admits no token: the request ends with an error."""
        slot = self.slots[slot_idx]
        if slot.request.grammar is None or slot.dfa:
            return tok
        chosen = self._grammar_choose(slot.request, tok, cands)
        if chosen is None:
            where = "this model's vocabulary" if admission else "the candidate set"
            slot.handle._q.put(TokenEvent(kind="error",
                                          error=f"grammar admits no token from {where}"))
            self._release(slot_idx)
            return None
        if chosen != tok:
            self.d_tokens[slot_idx] = chosen
        return chosen

    def _grammar_choose(self, request: GenRequest, sampled: int, candidates) -> Optional[int]:
        """The best grammar-legal token: the sampled one if legal (keeps
        temperature sampling while the model follows the grammar), else
        the candidates in probability order, else a scan of the
        first-character buckets the machine allows; EOS is legal only once
        the grammar is complete. Advances the machine past the pick."""
        g = request.grammar
        complete = g.complete()
        eos = self.tokenizer.eos_ids

        def ok(t: int) -> bool:
            if t in eos:
                return complete
            return g.allowed(self._token_str(t))

        if ok(sampled):
            self._grammar_advance(g, sampled)
            return sampled
        for t in np.asarray(candidates).tolist():
            if t != sampled and ok(t):
                self._grammar_advance(g, int(t))
                return int(t)
        for c, toks in self._first_char_buckets().items():
            if not g.allowed(c):
                continue
            for t in toks:
                if g.allowed(self._token_str(t)):
                    self._grammar_advance(g, t)
                    return t
        if complete:
            return next(iter(eos), None)
        return None

    def _grammar_advance(self, g, tok: int) -> None:
        if tok not in self.tokenizer.eos_ids:
            g.advance(self._token_str(tok))

    # ------------------------------------------------------------------ #
    # Token bookkeeping / streaming
    # ------------------------------------------------------------------ #

    def _post_token(self, slot_idx: int, tok: int, lp=None) -> None:
        """Append one generated token to a slot: stream text, check stops.
        `lp`, for a logprob request, is this step's (the sampled token's
        logprob, top LOGPROB_TOPK ids, their logprobs)."""
        slot = self.slots[slot_idx]
        r, handle = slot.request, slot.handle
        if handle.cancelled.is_set():
            self._finish(slot_idx, "stop")
            return
        logprob = top_logprobs = None
        if lp is not None and r.logprobs > 0:
            tok_lp, lp_ids, lp_vals = lp
            logprob = float(tok_lp)
            ids = [int(i) for i in lp_ids]
            if r.grammar is not None and not slot.dfa:
                # The host walk may replace the sampled token: the emitted
                # one's logprob comes from the top list when it is there.
                # (A DFA slot samples from its mask: its token is emitted.)
                logprob = float(lp_vals[ids.index(tok)]) if tok in ids else None
            top_logprobs = [(i, float(v)) for i, v in zip(ids[:r.logprobs],
                                                          lp_vals[:r.logprobs])]
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
        if (finish is None and r.grammar is not None and not slot.dfa
                and r.grammar.strictly_complete()):
            # Host walk: the text can no longer be extended. A DFA slot ends
            # by sampling EOS, the only legal token in such a state.
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
            handle._q.put(TokenEvent(kind="token", text=new, token_id=tok, logprob=logprob,
                                     top_logprobs=top_logprobs))
        if finish is not None:
            self._finish(slot_idx, finish)

    def _finish(self, slot_idx: int, reason: str) -> None:
        slot = self.slots[slot_idx]
        if self._cached_admit_ok(slot.request):
            # The rows of the prompt and of every generated token but the
            # last are written (a token's row lands when it is fed back):
            # the next turn of a chat starts with them. A span with
            # generated rows is new and always saved; one without is the
            # admission's span again and takes its bar.
            valid = slot.prompt_len + max(0, len(slot.generated) - 1)
            self._prefix_save(slot_idx, list(slot.request.prompt_ids) + slot.generated, valid,
                              min_extend=0 if valid > slot.prompt_len
                              else self.ecfg.prefix_cache_min)
        now = time.monotonic()
        t_first = slot.t_first or now
        h = slot.handle
        self._jnote("terminal", rid=h.rid, slot=slot_idx, a=float(len(slot.generated)))
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
        self.h_gmask[slot_idx] = 0.0
        # The next slot starts optimistic, with no suffix index and no
        # draft rows.
        self.h_accept_ewma[slot_idx] = 1.0
        self._spec_probe[slot_idx] = 0
        self._lookup[slot_idx] = None
        self.h_dsync[slot_idx] = -1
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
        base, as in the JAX package: runtime adapters serve dense bases. An
        engine with a draft model refuses adapters too (the draft would
        decode without the delta); the model-free modes serve them."""
        if self.draft_cfg is not None:
            raise AdapterError(
                "runtime LoRA adapters are not supported with a separate draft model — "
                "the draft would decode without the delta; model-free speculation "
                "(spec_mode=prompt_lookup/self_draft) serves adapter tenants")
        if self.cfg.is_mla or self.cfg.is_moe:
            raise AdapterError(
                f"runtime LoRA adapters serve dense llama-family bases only ({self.cfg.name} "
                f"is {'MLA' if self.cfg.is_mla else 'MoE'}) — merge at load via "
                "`lora_adapters` instead")
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
        faults.fire("adapter_fetch")
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
            faults.fire("adapter_fetch")
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
