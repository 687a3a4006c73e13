"""Fast byte-level BPE encode path: exact GPT-2/llama-3 pre-tokenization in
Python (`regex`), merge loop in C++ (csrc/bpe.cpp; localai_tpu/engine/
bpe_fast.py and localai_tpu/native/).

Reference: llama.cpp's C++ tokenizer (llm_tokenizer_bpe) is the encode hot
path behind every request; here the same split — the regex and byte mapping
are cheap and stay in Python, the quadratic merge loop goes native.

Safety: FastBPE SELF-VALIDATES against the HF tokenizer on a canary suite at
construction; a mismatch disables it with a warning (HFTokenizer keeps the
transformers path). A failed build of the C++ library raises: it never
degrades to Python. Nothing switches it off; a tokenizer that is not
byte-level BPE (sentencepiece) simply has no fast path.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
from functools import lru_cache
from typing import Optional

from localai_tpu_torch import native

log = logging.getLogger("localai_tpu_torch.bpe")

# GPT-2's pattern; llama-3 ships its own (read from tokenizer.json when set).
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

_CANARIES = (
    "Hello, world!",
    "  leading spaces and\ttabs\nnewlines",
    "mixedCASE word123 456",
    "unicode: Ωμέγα — 你好, мир! 🙂",
    "code: def f(x): return x*2  # comment",
    "don't can't I'll we've",
    "",
    " ",
)


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _extract_split_pattern(pre_tok: Optional[dict]) -> tuple[str, bool]:
    """(regex pattern, add_prefix_space) from a tokenizer.json pre_tokenizer."""
    pattern = GPT2_PATTERN
    add_prefix_space = False
    if not pre_tok:
        return pattern, add_prefix_space
    nodes = pre_tok.get("pretokenizers", [pre_tok])
    for node in nodes:
        t = node.get("type")
        if t == "Split":
            pat = node.get("pattern") or {}
            pattern = pat.get("Regex") or pat.get("String") or pattern
        elif t == "ByteLevel":
            add_prefix_space = bool(node.get("add_prefix_space", False))
            if not node.get("use_regex", True):
                continue
    return pattern, add_prefix_space


class NativeBPE:
    """ctypes wrapper over the C++ BPE merge engine (built on first use;
    a failed build raises)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self._lib = native.load("bpe")
        # id = line number: emit vocab ordered by id (dense ids expected).
        n = max(vocab.values()) + 1 if vocab else 0
        by_id = [""] * n
        for tok, i in vocab.items():
            if 0 <= i < n:
                by_id[i] = tok
        vocab_blob = "\n".join(by_id).encode("utf-8")
        merges_blob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        self._handle = self._lib.bpe_new(vocab_blob, len(vocab_blob),
                                         merges_blob, len(merges_blob))
        if not self._handle:
            raise RuntimeError("bpe_new failed")

    def encode_piece(self, piece: str) -> list[int]:
        data = piece.encode("utf-8")
        # Per-call buffer: the server tokenizes from many threads and ctypes
        # releases the GIL during the foreign call, so a shared buffer races.
        # Byte-level BPE yields at most one id per input byte (merges only
        # shrink), so len(data) capacity can never be exceeded.
        out = (ctypes.c_int32 * max(64, len(data)))()
        n = self._lib.bpe_encode_piece(self._handle, data, len(data), out, len(out))
        if n < 0:
            raise ValueError(f"native BPE could not encode piece {piece!r}")
        return out[:n]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.bpe_free(handle)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


class FastBPE:
    """Encode-only byte-level BPE mirroring an HF fast tokenizer."""

    def __init__(self, tokenizer_json_path: str):
        import regex

        with open(tokenizer_json_path) as f:
            tj = json.load(f)
        model = tj.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError("not a BPE tokenizer")
        pre = tj.get("pre_tokenizer") or {}
        kinds = {n.get("type") for n in pre.get("pretokenizers", [pre])}
        if "ByteLevel" not in kinds:
            raise ValueError("not byte-level BPE")
        vocab: dict[str, int] = model["vocab"]
        merges_raw = model.get("merges") or []
        merges = [
            tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
            for m in merges_raw
        ]
        self._native = NativeBPE(vocab, merges)  # raises when the build fails
        pattern, self.add_prefix_space = _extract_split_pattern(pre)
        self._split = regex.compile(pattern)
        self._b2u = _bytes_to_unicode()
        # Added/special tokens split the text before BPE runs.
        self._added = {
            t["content"]: int(t["id"])
            for t in tj.get("added_tokens") or []
        }
        self._added_sorted = sorted(self._added, key=len, reverse=True)
        self._piece_cache: dict[str, list[int]] = {}

    # ------------------------------------------------------------------ #

    def _encode_plain(self, text: str) -> list[int]:
        out: list[int] = []
        cache = self._piece_cache
        b2u = self._b2u
        for piece in self._split.findall(text):
            ids = cache.get(piece)
            if ids is None:
                mapped = "".join(b2u[b] for b in piece.encode("utf-8"))
                ids = self._native.encode_piece(mapped)
                if len(cache) < 200_000:
                    cache[piece] = ids
            out.extend(ids)
        return out

    def encode(self, text: str) -> list[int]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        if not self._added:
            return self._encode_plain(text)
        out: list[int] = []
        rest = text
        while rest:
            # Earliest occurrence of any added token wins; longest at a tie.
            best_pos, best_tok = -1, None
            for tok in self._added_sorted:
                pos = rest.find(tok)
                if pos != -1 and (best_pos == -1 or pos < best_pos):
                    best_pos, best_tok = pos, tok
            if best_tok is None:
                out.extend(self._encode_plain(rest))
                break
            if best_pos:
                out.extend(self._encode_plain(rest[:best_pos]))
            out.append(self._added[best_tok])
            rest = rest[best_pos + len(best_tok):]
        return out

    # ------------------------------------------------------------------ #

    @classmethod
    def for_hf_dir(cls, path: str, hf_tokenizer) -> Optional["FastBPE"]:
        """Build + self-validate against the HF tokenizer. None when the
        directory holds no byte-level BPE tokenizer.json, or (with a
        warning) when an encode differs from the HF tokenizer's; a failed
        build of the C++ library raises."""
        tj = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tj):
            return None
        try:
            fast = cls(tj)
        except ValueError as e:  # not byte-level BPE: the HF path serves it
            log.debug("FastBPE not applicable to %s: %s", path, e)
            return None
        canaries = list(_CANARIES) + [
            f"system {t} user" for t in list(fast._added)[:4]
        ]
        for text in canaries:
            want = hf_tokenizer.encode(text, add_special_tokens=False)
            try:
                got = fast.encode(text)
            except ValueError as e:  # a piece the native vocab cannot spell
                got = f"an error ({e})"
            if got != want:
                log.warning(
                    "native BPE disabled for %s (mismatch on %r: %s != %s); "
                    "the HF tokenizer encodes", path, text[:40], got[:8], want[:8],
                )
                return None
        log.info("native BPE encode active for %s", path)
        return fast
