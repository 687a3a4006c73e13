"""Continuous-batching serving engine, dense KV cache
(PyTorch port of localai_tpu/engine/engine.py).

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
- Streaming is UTF-8-safe incremental detokenization with stop-sequence
  hold-back; every generated token posts exactly one event, and every
  request ends with exactly one terminal event (done or error) on every
  exit path: finish, cancel, stop(), a failed dispatch, loop death.

Each slot samples from its own torch.Generator, seeded from the request's
seed (or from the OS when it has none), so a seeded request gives the same
bytes whatever else shares the batch.

Not ported yet (ROADMAP Queue A): pipelined dispatch and CUDA graphs,
the prefix cache, the paged pool, chunked prefill, grammar, logprobs,
speculative decoding, fork / n>1, LoRA, quantization, tp, deadlines.
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
    ) -> None:
        llama.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        if ecfg.max_slots < 1 or ecfg.max_seq < 2 or ecfg.min_prefill_bucket < 1:
            raise ValueError("max_slots >= 1, max_seq >= 2 and min_prefill_bucket >= 1 required")
        if not ecfg.block_sizes or min(ecfg.block_sizes) < 1:
            raise ValueError("block_sizes must be positive")
        if ecfg.max_pending < 0:
            raise ValueError("max_pending must be >= 0 (0 = unbounded)")
        pdev = params["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine device is {self.device}")
        B, S, V = ecfg.max_slots, ecfg.max_seq, cfg.vocab_size
        dev = self.device
        # Device state, one row per slot.
        self.cache = llama.KVCache.zeros(cfg, B, S, device=dev)
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
        self.m_admissions = 0
        self.m_blocks = 0
        self._decode_tokens = 0
        self._decode_time = 0.0

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
            "admit_wait_ms": float(self._admit_wait_ewma * 1000.0),
            "loop_dead": 1.0 if self._loop_dead is not None else 0.0,
        }

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
            admitted = self._admit_pending()
            if self.h_active.any() and self._has_unscheduled():
                try:
                    self._run_block()
                except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                    self._fail_block(e)
                continue
            if not admitted:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _fail_block(self, e: Exception) -> None:
        """A failed decode block: one error event per active request, and
        its slot released."""
        log.exception("decode block failed")
        for i, slot in enumerate(self.slots):
            if slot is not None:
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
        flight between loop iterations)."""
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.handle.cancelled.is_set():
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
        """Admit pending requests into free slots, one fused admission per
        group of same-bucket prompts at the queue head."""
        admitted = False
        while True:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return admitted
            group: list[tuple[GenRequest, RequestHandle]] = []
            bucket = 0
            with self._pending_lock:
                while self._pending and len(group) < len(free):
                    request, handle = self._pending[0]
                    if handle.cancelled.is_set():
                        self._pending.popleft()
                        handle._q.put(TokenEvent(kind="done", finish_reason="stop"))
                        continue
                    b = self._bucket_for(len(request.prompt_ids))
                    if group and b != bucket:
                        break  # different bucket — next round
                    bucket = b
                    group.append(self._pending.popleft())
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

    def _admit(self, prompt, lens, samp, bias_rows, gens, slot_ids, bucket):
        """The fused admission: prefill M prompts, write their KV, penalty
        counts and bias rows into their slots, sample each first token.
        Returns the first tokens [M] on the device."""
        cfg = self.cfg
        m, V = prompt.shape[0], cfg.vocab_size
        dev = self.device
        logits, ks, vs = llama.prefill(cfg, self.params, prompt, lens)
        valid = (torch.arange(bucket, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        rows = torch.zeros((m, V), dtype=torch.int32, device=dev)
        rows.scatter_add_(1, prompt, valid)
        # Logits may cover more ids than the tokenizer decodes (padded
        # embedding rows): mask those out of sampling for good.
        tok_v = min(getattr(self.tokenizer, "vocab_size", V) or V, V)
        if tok_v < V:
            bias_rows[:, tok_v:] = NEG_INF
        toks = sample(logits, gens, samp, rows, bias_rows)
        rows[torch.arange(m, device=dev), toks] += 1
        sl = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        for j, s in enumerate(slot_ids):
            llama.write_prefill_to_cache(self.cache, ks[:, j:j + 1], vs[:, j:j + 1], s)
        self.counts[sl] = rows
        self.bias[sl] = bias_rows
        self.d_tokens[sl] = toks
        self.d_positions[sl] = lens
        return toks

    def _dispatch_admit(self, group, bucket: int, slot_ids: list[int]) -> None:
        m, V = len(group), self.cfg.vocab_size
        t0 = time.monotonic()
        prompt = np.zeros((m, bucket), np.int64)
        lens = np.zeros((m,), np.int64)
        samp = np.zeros((len(_SAMPLING_FIELDS), m), np.float32)
        bias_rows = np.zeros((m, V), np.float32)
        seeds = []
        for j, (r, _h) in enumerate(group):
            prompt[j, : len(r.prompt_ids)] = r.prompt_ids
            lens[j] = len(r.prompt_ids)
            for fi, k in enumerate(_SAMPLING_FIELDS):
                samp[fi, j] = getattr(r, k)
            for tid, bval in r.logit_bias.items():
                if 0 <= int(tid) < V:
                    bias_rows[j, int(tid)] = bval
            # Unseeded requests draw a random seed (reference default -1).
            seeds.append(r.seed & 0x7FFFFFFF if r.seed is not None
                         else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF)
        dev = self.device
        sp = _sampling_params(torch.from_numpy(samp).to(dev))
        gens = [self._generator(s) for s in seeds]
        toks = self._admit(
            torch.from_numpy(prompt).to(dev), torch.from_numpy(lens).to(dev), sp,
            torch.from_numpy(bias_rows).to(dev),
            [g if r.temperature > 0 else None for g, (r, _h) in zip(gens, group)],
            slot_ids, bucket,
        )
        toks_host = toks.tolist()  # the admission's one device-to-host copy
        self.m_admissions += 1
        # Claim the slots only after a successful admission, so a failed
        # one leaves no slot state behind.
        for j, ((r, handle), s) in enumerate(zip(group, slot_ids)):
            for k in _SAMPLING_FIELDS:
                self.h_sampling[k][s] = getattr(r, k)
            self.generators[s] = gens[j]
            self.slots[s] = _Slot(request=r, handle=handle, prompt_len=int(lens[j]),
                                  scheduled=1, t_admit=t0)
            self.h_active[s] = True
        for j, ((r, handle), s) in enumerate(zip(group, slot_ids)):
            slot = self.slots[s]
            slot.t_first = time.monotonic()
            self.m_prompt_tokens += slot.prompt_len
            self._post_token(s, int(toks_host[j]))

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

    def _run_block(self) -> None:
        """One n-step decode block: dispatch, one host copy, then stream."""
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
        n = self._pick_block_size()
        # Read-side KV window: the smallest power of two (>= 256) covering
        # every active slot's pre-block rows; the cache holds nothing the
        # block reads past it, so decode attention streams less of it.
        maxpos = max(self.slots[i].prompt_len + self.slots[i].scheduled for i in idx)
        win = self._KV_WIN_MIN
        while win < min(maxpos, S):
            win *= 2
        read_cache = self.cache
        if win < S:
            read_cache = llama.KVCache(k=self.cache.k[:, :, :win], v=self.cache.v[:, :, :win])

        pack = np.stack([act.astype(np.float32)] + [hs[k] for k in _SAMPLING_FIELDS])
        d_pack = torch.from_numpy(pack).to(dev)  # the block's one host-to-device copy
        active = d_pack[0] > 0
        act_i32 = active.to(torch.int32)
        sp = _sampling_params(d_pack[1:])
        gens = [self.generators[i] if act[i] and hs["temperature"][i] > 0 else None
                for i in range(B)]
        shape = (cfg.num_layers, B, n, cfg.num_kv_heads, cfg.head_dim_)
        local_k = torch.zeros(shape, dtype=self.cache.k.dtype, device=dev)
        local_v = torch.zeros(shape, dtype=self.cache.v.dtype, device=dev)
        tokens, positions = self.d_tokens, self.d_positions
        start_pos = positions
        out = torch.empty((n, B), dtype=torch.int64, device=dev)
        for step in range(n):
            logits, local_k, local_v = llama.decode_step_windowed(
                cfg, self.params, tokens, positions, read_cache, local_k, local_v, step)
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
        llama.write_block_to_cache(self.cache, local_k, local_v, start_pos)
        self.d_tokens, self.d_positions = tokens, positions
        toks = out.cpu().numpy()  # the block's one device-to-host copy
        self.m_blocks += 1
        for i in idx:
            self.slots[i].scheduled += n
        consumed = 0
        for step in range(n):
            for i in idx:
                if self.slots[i] is None:
                    continue  # finished earlier in this block
                consumed += 1
                self._post_token(int(i), int(toks[step, i]))
        self._decode_tokens += consumed
        self._decode_time += time.monotonic() - t0

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
        self.slots[slot_idx] = None
        self.h_active[slot_idx] = False
