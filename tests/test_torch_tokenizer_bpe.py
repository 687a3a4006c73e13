"""The port's native BPE encoder (localai_tpu_torch/engine/bpe_fast.py over
csrc/bpe.cpp, built with g++ into _build/) on the CPU: on a tokenizer.json
synthesized from GGUF metadata (chip_smoke.py's llama-3-layout vocabulary,
through engine/gguf.write_hf_tokenizer) its ids equal the HF tokenizer's
and the JAX package's FastBPE's on the canaries, a chat prompt with control
tokens, a long mixed text and a fuzz of short strings; HFTokenizer runs it
(`native_bpe`); a failed build raises; a canary mismatch warns and keeps
the HF path; a tokenizer that is not byte-level BPE has no fast path."""

import logging
import random
import shutil
import string
import threading

import pytest

import chip_smoke
from localai_tpu.engine.bpe_fast import FastBPE as JaxFastBPE
from localai_tpu_torch import native
from localai_tpu_torch.engine import gguf as pg
from localai_tpu_torch.engine.bpe_fast import _CANARIES, FastBPE
from localai_tpu_torch.engine.tokenizer import HFTokenizer

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A GGUF-synthesized tokenizer dir: 4096 tokens (256 byte symbols,
    3584 synthetic merges, 256 control tokens), llama-bpe split."""
    from localai_tpu_torch.models.config import ArchConfig

    d = tmp_path_factory.mktemp("gguf-tok")
    cfg = ArchConfig(name="tok", vocab_size=4096, hidden_size=256, intermediate_size=256,
                     num_layers=1, num_heads=4, num_kv_heads=4, tie_embeddings=True)
    path = str(d / "m.gguf")
    chip_smoke.write_gguf_model(path, cfg, 1, "q8_0")
    return pg.write_hf_tokenizer(pg.GGUFFile(path), str(d / "tok"))


@pytest.fixture(scope="module")
def hf(tok_dir):
    return HFTokenizer(tok_dir)


def _texts() -> list[str]:
    rnd = random.Random(0)
    alphabet = string.ascii_letters + string.digits + " .,!?'\t\n()#+-*/" + "Ωμ你好м🙂"
    return [*_CANARIES, chip_smoke._gguf_text(5000, 3), "?!" * 3000,
            "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"] + [
        "".join(rnd.choice(alphabet) for _ in range(rnd.randrange(1, 120))) for _ in range(150)]


def test_native_bpe_ids_equal_hf_and_the_jax_fastbpe(tok_dir, hf):
    assert hf.native_bpe and hf.vocab_size == 4096
    jax_fast = JaxFastBPE.for_hf_dir(tok_dir, hf._tok)
    assert jax_fast is not None
    chat = hf.apply_chat_template([{"role": "user", "content": "Hello, world! 123"}])
    for text in [*_texts(), chat]:
        want = hf._tok.encode(text, add_special_tokens=False)
        assert hf.encode(text) == want == jax_fast.encode(text), repr(text[:40])
    assert hf.encode("hi", add_bos=True)[0] == hf.bos_id == 3840


def test_threaded_encodes_do_not_cross(hf):
    texts = [f"thread {i}: the quick brown fox {i} " + "abc" * (10 + i) for i in range(6)]
    want = [hf._tok.encode(t, add_special_tokens=False) for t in texts]
    bad = []

    def worker(i):
        for _ in range(100):
            hf._fast._piece_cache.clear()  # the native call every round
            if hf.encode(texts[i]) != want[i]:
                bad.append(i)
                return

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


def test_a_failed_build_raises(tmp_path, tok_dir, monkeypatch):
    (tmp_path / "bpe.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for bpe"):
        HFTokenizer(tok_dir)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("case", ["lowercasing_normalizer", "not_byte_level",
                                  "no_tokenizer_json"])
def test_the_hf_path_serves_what_the_native_engine_cannot(tmp_path, tok_dir, caplog, case):
    import json

    d = tmp_path / "tok"
    shutil.copytree(tok_dir, d)
    tj = json.loads((d / "tokenizer.json").read_text())
    if case == "lowercasing_normalizer":  # the native engine does not normalize: a
        tj["normalizer"] = {"type": "Lowercase"}  # canary differs, so warn and keep HF
    elif case == "not_byte_level":
        tj["pre_tokenizer"]["pretokenizers"] = tj["pre_tokenizer"]["pretokenizers"][:1]
        tj["decoder"] = None
    (d / "tokenizer.json").write_text(json.dumps(tj))
    from transformers import AutoTokenizer

    ref = AutoTokenizer.from_pretrained(str(d), local_files_only=True)
    if case == "no_tokenizer_json":
        assert FastBPE.for_hf_dir(str(tmp_path), ref) is None
        return
    with caplog.at_level(logging.WARNING, logger="localai_tpu_torch.bpe"):
        t = HFTokenizer(str(d))
    assert not t.native_bpe
    assert ("native BPE disabled" in caplog.text) == (case == "lowercasing_normalizer")
    text = "Hello, world! 123 Ωμέγα"
    assert t.encode(text) == ref.encode(text, add_special_tokens=False)
