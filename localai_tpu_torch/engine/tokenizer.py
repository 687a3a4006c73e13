"""Tokenizer abstraction (a copy of localai_tpu/engine/tokenizer.py).

Two implementations behind one small interface:

- `HFTokenizer`: wraps a local HuggingFace tokenizer directory (the reference's
  `use_tokenizer_template` path hands templating/tokenization to the backend,
  backend/python/vllm/backend.py chat-template usage; here it is first-class).
  Byte-level BPE vocabularies encode through the native C++ merge engine
  (engine/bpe_fast.py), held to the HF tokenizer on a canary suite first.
- `ByteTokenizer`: dependency-free byte-level tokenizer used for tests and
  synthetic benchmarks — no downloads needed in an egress-free environment.

The engine only sees ids; all text handling (incremental UTF-8-safe decode,
chat templates) flows through this interface.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int | None
    eos_ids: tuple[int, ...]

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def token_strings(self) -> list[str]:
        """Decoded string for every token id (for grammar-mask precompute)."""
        ...


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: id = byte value; specials above 255.

    vocab_size defaults to 512 to match the "tiny" test architectures, leaving
    ids [258, 512) unused.
    """

    PAD = 258

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.bos_id: int | None = 256
        self.eos_ids: tuple[int, ...] = (257,)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def token_strings(self) -> list[str]:
        out = []
        for i in range(self.vocab_size):
            out.append(chr(i) if i < 256 else "")
        return out


class SyntheticByteTokenizer(ByteTokenizer):
    """ByteTokenizer whose ids above the specials decode to printable ASCII
    (`chr(id % 95 + 32)`) instead of nothing.

    Purpose: synthetic-weight benchmarks on real vocab sizes (e.g. 128k).
    A plain ByteTokenizer decodes ids ≥ 256 as empty strings, so a random
    model's stream carries zero content deltas and client-observed TTFT /
    chunk cadence are unmeasurable (BENCH_r03's `p50_first_content_ms_http:
    null`). Every non-special id maps to ONE printable ASCII char (never a
    partial UTF-8 sequence), so the streamer holds nothing back and content
    chunks match generated tokens 1:1. Select with `tokenizer:
    synthetic-bytes` in a model YAML."""

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            chr((i % 95) + 32) for i in ids
            if i >= 0 and i not in (self.bos_id, self.eos_ids[0], self.PAD)
        )

    def token_strings(self) -> list[str]:
        specials = {self.bos_id, self.eos_ids[0], self.PAD}
        return [
            "" if i in specials else chr((i % 95) + 32)
            for i in range(self.vocab_size)
        ]


class HFTokenizer:
    """Local HuggingFace tokenizer (no network access; path must exist)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        # Native C++ BPE encode hot path (self-validated: None on a mismatch
        # or for a tokenizer that is not byte-level BPE; a failed build raises).
        from localai_tpu_torch.engine.bpe_fast import FastBPE

        self._fast = FastBPE.for_hf_dir(path, self._tok)
        self.bos_id = self._tok.bos_token_id
        eos = self._tok.eos_token_id
        eos_ids = [eos] if isinstance(eos, int) else list(eos or [])
        # Llama-3 style <|eot_id|> terminators if present.
        for special in ("<|eot_id|>", "<|im_end|>", "<|end|>"):
            tid = self._tok.convert_tokens_to_ids(special)
            if tid is not None and tid >= 0 and tid not in eos_ids:
                eos_ids.append(tid)
        self.eos_ids = tuple(eos_ids)

    @property
    def native_bpe(self) -> bool:
        """Whether encode() runs the native BPE engine."""
        return self._fast is not None

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        if self._fast is not None:
            ids = self._fast.encode(text)
        else:
            ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        # Guard ids beyond the tokenizer table: the model's vocab (and hence
        # the engine's logits) may be padded past len(tokenizer) — e.g.
        # checkpoints with rounded-up embedding rows. Such ids decode to
        # nothing rather than crashing the stream.
        valid = [i for i in ids if 0 <= i < self.vocab_size]
        return self._tok.decode(valid, skip_special_tokens=True)

    def token_strings(self) -> list[str]:
        """Each token's contribution to a joint decode.

        decode([i]) alone is wrong for SentencePiece ("▁34" → "34", losing
        the space the joint decode emits) and for byte-level BPE ("Ġword").
        Map the raw token pieces instead: "▁"→space for SP; the GPT-2 byte
        decoder for byte-level BPE. Special tokens map to "" so grammar-
        constrained decoding never selects them as text.
        """
        toks = self._tok.convert_ids_to_tokens(list(range(self.vocab_size)))
        specials = set(getattr(self._tok, "all_special_ids", []) or [])
        specials.update(self.eos_ids)
        byte_level = any(t is not None and "Ġ" in t for t in toks[:4096])
        byte_decoder = _gpt2_byte_decoder() if byte_level else None
        out: list[str] = []
        for i, t in enumerate(toks):
            if t is None or i in specials:
                out.append("")
            elif byte_decoder is not None:
                try:
                    out.append(
                        bytes(byte_decoder[c] for c in t).decode("utf-8", "replace")
                    )
                except KeyError:
                    out.append("")  # non-byte-level piece (added token)
            elif "▁" in t:
                out.append(t.replace("▁", " "))
            elif t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                out.append(bytes([int(t[3:5], 16)]).decode("utf-8", "replace"))
            else:
                out.append(t)
        return out

    @property
    def chat_template(self) -> str | None:
        return getattr(self._tok, "chat_template", None)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> str:
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of the GPT-2 bytes→unicode table used by byte-level BPE."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def load_tokenizer(path: str | None, vocab_size: int = 512) -> Tokenizer:
    """Factory: HF tokenizer when a local path is given, byte-level otherwise.
    The sentinel path "synthetic-bytes" selects the benchmark tokenizer whose
    whole vocab decodes to visible text (see SyntheticByteTokenizer)."""
    if path == "synthetic-bytes":
        return SyntheticByteTokenizer(vocab_size=vocab_size)
    if path:
        return HFTokenizer(path)
    return ByteTokenizer(vocab_size=vocab_size)
