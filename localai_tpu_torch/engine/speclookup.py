"""Prompt-lookup drafting: per-slot n-gram suffix index (a copy of
localai_tpu/engine/speclookup.py).

Model-free speculative decoding mines draft continuations from the token
stream the host already sees — every slot's prompt plus everything it has
emitted. The observation (prompt-lookup / n-gram speculative decoding,
PAPERS.md) is that serving workloads repeat themselves: RAG answers quote
the context, code edits echo the region being edited, chat turns restate
the question. When the current suffix already occurred earlier in the
stream, the tokens that followed it THEN are a high-acceptance draft NOW,
and the target's verify pass keeps the output exact regardless of how
wrong the guess is.

This module is deliberately pure Python + stdlib: it runs on the engine
loop thread between device dispatches, so it must never touch the device
and stay O(max_ngram) per appended token (keeping this module
import-clean keeps the whole drafting tier host-only by construction).

Index shape: `_index` maps an n-gram tuple to the position where its most
recent COMPLETED occurrence's continuation starts. The map is updated as
tokens append — when token t lands at position p, the n-grams *ending at
p-1* gain t as their continuation, so the terminal suffix itself is never
its own (empty) match. `propose()` probes the longest n-gram first;
recency wins ties automatically because later occurrences overwrite.

The index is bounded by construction: a slot's history never exceeds the
engine's max_seq, and `max_tokens` hard-caps degenerate configs — past
it the index stops absorbing new positions (proposals keep working over
the indexed window; serving restarts the index at the next admission).
"""

from __future__ import annotations

from typing import Optional

# Longest suffix length probed for a match. 3 is the sweet spot from the
# prompt-lookup literature: 1-grams fire constantly but predict poorly,
# 4+ grams rarely match at all on short contexts.
MAX_NGRAM = 3
MIN_NGRAM = 1


class SuffixIndex:
    """Incremental n-gram → continuation-start index over one slot's
    prompt + generated token stream."""

    __slots__ = ("_toks", "_index", "max_ngram", "min_ngram", "max_tokens")

    def __init__(self, max_ngram: int = MAX_NGRAM, min_ngram: int = MIN_NGRAM,
                 max_tokens: int = 1 << 20) -> None:
        self.max_ngram = max(1, int(max_ngram))
        self.min_ngram = max(1, min(int(min_ngram), self.max_ngram))
        self.max_tokens = int(max_tokens)
        self._toks: list[int] = []
        self._index: dict[tuple, int] = {}

    def __len__(self) -> int:
        return len(self._toks)

    def extend(self, tokens) -> None:
        """Append tokens, registering each completed n-gram occurrence."""
        toks = self._toks
        idx = self._index
        for t in tokens:
            p = len(toks)
            if p >= self.max_tokens:
                return  # bounded: stop absorbing, keep serving proposals
            # n-grams ENDING at p-1 now have a continuation (this token):
            # record where that continuation starts.
            for n in range(self.min_ngram, self.max_ngram + 1):
                if p - n < 0:
                    break
                idx[tuple(toks[p - n:p])] = p
            toks.append(int(t))

    def propose(self, k: int) -> list[int]:
        """Up to k tokens that followed the most recent earlier occurrence
        of the current suffix (longest n-gram first). Empty = no match —
        the scheduler then lets this slot decode plainly this round."""
        toks = self._toks
        L = len(toks)
        if L < self.min_ngram or k <= 0:
            return []
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            start = self._index.get(tuple(toks[L - n:]))
            if start is not None and start < L:
                avail = L - start
                if avail >= k:
                    return toks[start:start + k]
                # Match lands inside the last k tokens — the stream is
                # (locally) periodic with period `avail`, and a periodic
                # stream's continuation is periodic: tile the period out to
                # k instead of truncating the draft (a pure "aaaa…" run
                # would otherwise only ever draft 1 token per round).
                return [toks[start + (i % avail)] for i in range(k)]
        return []


def build_index(tokens, max_ngram: int = MAX_NGRAM) -> SuffixIndex:
    """Fresh index over an existing history (admission / resume seed)."""
    ix = SuffixIndex(max_ngram=max_ngram)
    ix.extend(tokens)
    return ix


__all__ = ["SuffixIndex", "build_index", "MAX_NGRAM", "MIN_NGRAM"]
