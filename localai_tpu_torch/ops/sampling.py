"""Batched, per-slot parameterized token sampling (localai_tpu/ops/sampling.py).

Every slot carries its own sampling parameters as tensor entries, so one
call serves a batch of heterogeneous requests. The filter chain follows
llama.cpp's order — top-k, then top-p, then min-p on the unscaled logits,
temperature last — over a partial top-`num_candidates` candidate set.

Randomness is counter-based: the noise of row b at column v is a pure
function of (seeds[b], positions[b], v), an integer hash computed with
tensor ops (`gumbel_noise`). The engine keeps one seed per slot on the
device and keys each draw by the position of the token being drawn, so a
request's draws depend only on its seed and on each token's index in its
sequence, never on its neighbours in the batch, the sampler variant, the
block size, chunking or preemption; and a decode block that samples holds
no host state and can be captured in a CUDA graph. A draw is a Gumbel-max
over the tempered logits (categorical sampling without a sort); the
filtered path uses the same noise at its candidates' vocabulary ids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Per-slot sampling parameters; every field has shape [B]."""

    temperature: torch.Tensor  # f32; <= 0 means greedy
    top_k: torch.Tensor  # i32; 0 disables
    top_p: torch.Tensor  # f32; >= 1 disables
    min_p: torch.Tensor  # f32; 0 disables
    repeat_penalty: torch.Tensor  # f32; 1.0 disables (llama.cpp semantics)
    presence_penalty: torch.Tensor  # f32; 0 disables
    frequency_penalty: torch.Tensor  # f32; 0 disables

    @staticmethod
    def make(
        batch: int,
        temperature=0.0,
        top_k=0,
        top_p=1.0,
        min_p=0.0,
        repeat_penalty=1.0,
        presence_penalty=0.0,
        frequency_penalty=0.0,
        device=None,
    ) -> "SamplingParams":
        def full(v, dt):
            return torch.full((batch,), v, dtype=dt, device=device)

        return SamplingParams(
            temperature=full(temperature, torch.float32),
            top_k=full(top_k, torch.int32),
            top_p=full(top_p, torch.float32),
            min_p=full(min_p, torch.float32),
            repeat_penalty=full(repeat_penalty, torch.float32),
            presence_penalty=full(presence_penalty, torch.float32),
            frequency_penalty=full(frequency_penalty, torch.float32),
        )


def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    counts: torch.Tensor,  # [B, V] i32 — occurrences so far (prompt + generated)
    params: SamplingParams,
) -> torch.Tensor:
    seen = counts > 0
    rp = params.repeat_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalized, logits)
    logits = logits - params.presence_penalty[:, None] * seen.float()
    logits = logits - params.frequency_penalty[:, None] * counts.float()
    return logits


def _filter_sorted(sorted_logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Apply top-k, then top-p, then min-p on descending-sorted logits [B, K];
    each stage renormalizes over the survivors of the previous one. top_k
    larger than K is clamped to K."""
    B, V = sorted_logits.shape
    ranks = torch.arange(V, device=sorted_logits.device)[None, :]
    k = torch.where(params.top_k <= 0, V, torch.clamp(params.top_k, max=V))[:, None]
    keep = ranks < k

    probs = torch.softmax(torch.where(keep, sorted_logits, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens until the mass *before* this token reaches top_p.
    keep = keep & ((cum - probs) < params.top_p[:, None])

    probs = torch.softmax(torch.where(keep, sorted_logits, NEG_INF), dim=-1)
    keep = keep & (probs >= params.min_p[:, None] * probs[:, :1])

    keep[:, 0] = True  # never mask everything
    return torch.where(keep, sorted_logits, NEG_INF)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    as two products below 2^48, so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_bits(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] int64 holding 32-bit hashes of (seeds[b], positions[b], v).
    The seed is mixed in alone first, so neighbouring seeds give unrelated
    rows; every step keeps 32 bits, so the bits are the same on every
    device."""
    s = _fmix32((seeds.to(torch.int64) & _M32) ^ 0x9E3779B9)
    row = _fmix32((s + _mul32(positions.to(torch.int64) & _M32, 0x27D4EB2F)) & _M32)
    cols = _mul32(torch.arange(vocab, dtype=torch.int64, device=seeds.device), 0x165667B1)
    return _fmix32(row[:, None] ^ cols[None, :])


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] f32 standard Gumbel noise, a pure function of each row's seed
    [B] and the position [B] of the token it draws: the top 24 bits of
    `noise_bits` give a uniform in (0, 1) (k + 1/2 over 2^23, exact in f32),
    then -log(-log(u))."""
    u = ((noise_bits(seeds, positions, vocab) >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def _prepare(logits, params, counts, logit_bias):
    logits = logits.float()
    if counts is not None:
        logits = apply_penalties(logits, counts, params)
    if logit_bias is not None:
        logits = logits + logit_bias
    return logits


def sample(
    logits: torch.Tensor,  # [B, V] any float dtype
    seeds: torch.Tensor,  # [B] int64 per-row seed
    positions: torch.Tensor,  # [B] int64 position of the token each row draws
    params: SamplingParams,
    counts: torch.Tensor | None = None,  # [B, V] i32
    logit_bias: torch.Tensor | None = None,  # [B, V] f32
    num_candidates: int = 64,
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int64.

    Rows with top-k/top-p/min-p run the filter chain over the partial
    top-`num_candidates` set (top_k clamps to it); rows with none sample
    the exact full distribution; temperature <= 0 is greedy."""
    logits = _prepare(logits, params, counts, logit_bias)
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    noise = gumbel_noise(seeds, positions, logits.shape[-1])

    K = min(num_candidates, logits.shape[-1])
    sorted_logits, sorted_idx = torch.topk(logits, K, dim=-1)
    filtered = _filter_sorted(sorted_logits, params)
    filtered = torch.where(filtered <= NEG_INF, NEG_INF, filtered / temp)
    pos = torch.argmax(filtered + noise.gather(1, sorted_idx), dim=-1)
    cand_tok = sorted_idx.gather(1, pos[:, None])[:, 0]

    free_tok = torch.argmax(logits / temp + noise, dim=-1)
    needs_filter = (params.top_k > 0) | (params.top_p < 1.0) | (params.min_p > 0.0)
    sampled = torch.where(needs_filter, cand_tok, free_tok)
    return torch.where(params.temperature <= 0.0, greedy_tok, sampled)


def sample_simple(
    logits: torch.Tensor,  # [B, V]
    seeds: torch.Tensor,  # [B] int64
    positions: torch.Tensor,  # [B] int64
    params: SamplingParams,
    counts: torch.Tensor | None = None,
    logit_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy + exact unfiltered categorical only — no top-k/top-p/min-p."""
    logits = _prepare(logits, params, counts, logit_bias)
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    noise = gumbel_noise(seeds, positions, logits.shape[-1])
    free_tok = torch.argmax(logits / temp + noise, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy_tok, free_tok)


def sample_greedy(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    counts: torch.Tensor | None = None,
    logit_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pure argmax (with penalties/bias) — the cheapest per-step sampler."""
    return torch.argmax(_prepare(logits, params, counts, logit_bias), dim=-1)


def update_counts(counts: torch.Tensor, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """counts[b, tokens[b]] += 1 for active rows, in place."""
    rows = torch.arange(counts.shape[0], device=counts.device)
    counts[rows, tokens] += active.to(counts.dtype)
    return counts
