"""Batched, per-slot parameterized token sampling (localai_tpu/ops/sampling.py).

Every slot carries its own sampling parameters as tensor entries, so one
call serves a batch of heterogeneous requests. The filter chain follows
llama.cpp's order — top-k, then top-p, then min-p on the unscaled logits,
temperature last — over a partial top-`num_candidates` candidate set.

Randomness comes from one `torch.Generator` per row (None for rows that do
not sample). Each sampled row draws one [V] vector of uniforms per call,
whatever the variant, so a request's stream of random numbers depends only
on its seed and its own step count, never on its neighbours in the batch
or on which sampler variant the batch ran. A draw is a Gumbel-max over the
tempered logits (categorical sampling without a sort); the filtered path
uses the same noise at its candidates' vocabulary ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

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


def gumbel_noise(
    generators: Sequence[Optional[torch.Generator]], vocab: int, device
) -> torch.Tensor:
    """[B, V] standard Gumbel noise, one [V] draw from each row's generator;
    rows without a generator get zeros (they do not sample)."""
    noise = torch.zeros((len(generators), vocab), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b, g in enumerate(generators):
        if g is not None:
            u = torch.rand(vocab, generator=g, device=device).clamp_(min=tiny)
            noise[b] = -torch.log(-torch.log(u))
    return noise


def _prepare(logits, params, counts, logit_bias):
    logits = logits.float()
    if counts is not None:
        logits = apply_penalties(logits, counts, params)
    if logit_bias is not None:
        logits = logits + logit_bias
    return logits


def sample(
    logits: torch.Tensor,  # [B, V] any float dtype
    generators: Sequence[Optional[torch.Generator]],  # [B] per-row RNG or None
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
    noise = gumbel_noise(generators, logits.shape[-1], logits.device)

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
    generators: Sequence[Optional[torch.Generator]],
    params: SamplingParams,
    counts: torch.Tensor | None = None,
    logit_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy + exact unfiltered categorical only — no top-k/top-p/min-p."""
    logits = _prepare(logits, params, counts, logit_bias)
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    noise = gumbel_noise(generators, logits.shape[-1], logits.device)
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
