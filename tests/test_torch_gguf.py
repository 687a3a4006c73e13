"""The port's GGUF ingestion (localai_tpu_torch/engine/gguf.py) against the
JAX package's (localai_tpu/engine/gguf.py) on the same bytes, on the CPU.

Fixtures are written by tests/test_gguf.py's spec-derived writer (loaded
from its path; it is test code independent of both readers) and by
chip_smoke.py's writer at tiny widths. Every block decoder and grouped
repack is bit-equal to the JAX package's (payloads of random bytes with
sane f16 scales), the bf16 rounding equals ml_dtypes', the arch and the
synthesized tokenizer equal field by field, and each fixture's loaded tree
equals the JAX tree put on the device leaf by leaf. The port's
ModelManager serves a `.gguf` YAML like the JAX manager: at f32, prefill
logits within 1e-4 and the first 8 greedy ids equal; in bf16, ids equal up
to the first near tie (top-2 gap under 2^-6 of the largest |logit|)."""

import dataclasses
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from localai_tpu.config import ApplicationConfig as JaxAppConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.engine import gguf as jg
from localai_tpu.models import llama as jl
from localai_tpu.server import ModelManager as JaxModelManager
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine import gguf as pg
from localai_tpu_torch.engine.engine import GenRequest
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models.config import ArchConfig
from localai_tpu_torch.ops.quant_matmul import qmm_plain
from localai_tpu_torch.server import ModelManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_writer():
    spec = importlib.util.spec_from_file_location(
        "gguf_spec_writer", os.path.join(ROOT, "tests", "test_gguf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # The writer's type table names the types its own tests pack; the rest
    # of the spec's ids (ggml.h), in this copy only.
    mod._GGML_IDS.update({"Q4_1": 3, "Q5_0": 6, "Q5_1": 7, "Q2_K": 10, "Q3_K": 11, "BF16": 30})
    return mod


tg = _load_writer()

# ggml-common.h block layouts and the weights a block holds.
BLOCKS = {
    "Q4_0": ([("d", "<f2"), ("qs", "u1", (16,))], 32),
    "Q4_1": ([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))], 32),
    "Q5_0": ([("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))], 32),
    "Q5_1": ([("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))], 32),
    "Q8_0": ([("d", "<f2"), ("qs", "i1", (32,))], 32),
    "Q4_K": ([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)), ("qs", "u1", (128,))], 256),
    "Q5_K": ([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)), ("qh", "u1", (32,)),
              ("qs", "u1", (128,))], 256),
    "Q6_K": ([("ql", "u1", (128,)), ("qh", "u1", (64,)), ("scales", "i1", (16,)),
              ("d", "<f2")], 256),
}
TYPES = ["F32", "F16", "BF16", *BLOCKS]
LOSSLESS = ("Q4_0", "Q8_0", "Q4_K")  # grouped() keeps their values exactly


def _payload(tname: str, n: int, rng) -> bytes:
    """n weights of tname: float types from a normal draw, block types from
    random bytes with their f16 scale fields set to finite values."""
    if tname == "F32":
        return rng.standard_normal(n).astype("<f4").tobytes()
    if tname == "F16":
        return rng.standard_normal(n).astype("<f2").tobytes()
    if tname == "BF16":
        return (rng.standard_normal(n).astype("<f4").view("<u4") >> 16).astype("<u2").tobytes()
    fields, per_block = BLOCKS[tname]
    dt = np.dtype(fields)
    blocks = np.frombuffer(rng.bytes(n // per_block * dt.itemsize), dt).copy()
    for f in ("d", "m", "dmin"):
        if f in dt.names:
            blocks[f] = rng.uniform(-0.05, 0.05, len(blocks)).astype(np.float16)
    return blocks.tobytes()


def _same(a, b) -> bool:
    """Bitwise equality of two numpy arrays (same dtype and shape)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes())


@pytest.mark.parametrize("tname", TYPES)
def test_block_decoders_and_grouped_repacks_are_the_jax_packages(tmp_path, tname):
    rng = np.random.default_rng(TYPES.index(tname))
    n_out, n_in = 8, 512
    path = str(tmp_path / "t.gguf")
    tg.write_gguf(path, {"general.architecture": "llama"},
                  {"w": (tname, (n_in, n_out), _payload(tname, n_in * n_out, rng))})
    pf, jf = pg.GGUFFile(path), jg.GGUFFile(path)
    got, want = pf.tensor("w"), jf.tensor("w")
    if tname == "BF16":  # the port widens bf16 bits to f32 exactly
        want = want.astype(np.float32)
    assert _same(got, want)
    pgr, jgr = pf.grouped("w"), jf.grouped("w")
    assert (pgr is None) == (jgr is None) == (tname in ("F32", "F16", "BF16"))
    if pgr is None:
        return
    assert sorted(pgr) == sorted(jgr) and all(_same(pgr[k], jgr[k]) for k in pgr)
    if tname in LOSSLESS:
        # B3's plain version on the repacked form is the dense product.
        x = torch.from_numpy(rng.standard_normal((4, n_in)).astype(np.float32))
        y = qmm_plain(x, {k: torch.from_numpy(v) for k, v in pgr.items()})
        ref = x.double() @ torch.from_numpy(got.astype(np.float64)).t()
        assert (y.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_bf16_rounding_is_ml_dtypes():
    rng = np.random.default_rng(0)
    ties = (np.arange(1, 2000, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(
        -40, 38, 4000), ties, -ties, np.float32([0.0, -0.0, np.inf, -np.inf, 1e-45, 3.4e38])])
    got = pg.bf16_round(x)
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert got.dtype == np.float32 and _same(got, want)
    assert np.isnan(pg.bf16_round(np.float32([np.nan]))).all()


# --------------------------------------------------------------------------- #
# Fixture files
# --------------------------------------------------------------------------- #


def _f32(rng, *shape, s=0.05):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _bias_gguf(path: str, arch: str) -> None:
    """A 2-layer f32 file of `arch` with q / k / v biases (qwen2: no q / k
    row permutation; llama: the biases un-permute with the rows)."""
    rng = np.random.default_rng(11)
    D, F, H, HD, V, L = 64, 128, 2, 32, 256, 2
    ones = np.ones(D, np.float32).tobytes()
    tensors = {"token_embd.weight": ("F32", (D, V), _f32(rng, V, D).tobytes()),
               "output_norm.weight": ("F32", (D,), ones)}
    for i in range(L):
        for key, (r, c) in (("attn_q", (H * HD, D)), ("attn_k", (H * HD, D)),
                            ("attn_v", (H * HD, D)), ("attn_output", (D, H * HD)),
                            ("ffn_gate", (F, D)), ("ffn_up", (F, D)), ("ffn_down", (D, F))):
            tensors[f"blk.{i}.{key}.weight"] = ("F32", (c, r), _f32(rng, r, c).tobytes())
        for key in ("attn_q", "attn_k", "attn_v"):
            tensors[f"blk.{i}.{key}.bias"] = ("F32", (H * HD,), _f32(rng, H * HD).tobytes())
        for key in ("attn_norm", "ffn_norm"):
            tensors[f"blk.{i}.{key}.weight"] = ("F32", (D,), ones)
    kv = {"general.architecture": arch, f"{arch}.block_count": L,
          f"{arch}.embedding_length": D, f"{arch}.feed_forward_length": F,
          f"{arch}.attention.head_count": H, f"{arch}.attention.head_count_kv": H,
          f"{arch}.vocab_size": V, f"{arch}.context_length": 512}
    tg.write_gguf(path, kv, tensors)


def _moe_gguf(path: str) -> None:
    """test_gguf.py's mixtral-style file: fused f32 `_exps` tensors, q4_0 /
    q8_0 attention."""
    rng = np.random.default_rng(6)
    D, F, H, HD, V, L, E = 64, 128, 2, 32, 256, 2, 4
    ones = np.ones(D, np.float32).tobytes()
    tensors = {"token_embd.weight": ("F32", (D, V), _f32(rng, V, D).tobytes()),
               "output_norm.weight": ("F32", (D,), ones)}
    for i in range(L):
        tensors.update({
            f"blk.{i}.attn_norm.weight": ("F32", (D,), ones),
            f"blk.{i}.attn_q.weight": ("Q4_0", (D, H * HD), tg.pack_q4_0(_f32(rng, H * HD, D))),
            f"blk.{i}.attn_k.weight": ("Q4_0", (D, H * HD), tg.pack_q4_0(_f32(rng, H * HD, D))),
            f"blk.{i}.attn_v.weight": ("Q8_0", (D, H * HD), tg.pack_q8_0(_f32(rng, H * HD, D))),
            f"blk.{i}.attn_output.weight": ("Q8_0", (H * HD, D),
                                            tg.pack_q8_0(_f32(rng, D, H * HD))),
            f"blk.{i}.ffn_norm.weight": ("F32", (D,), ones),
            f"blk.{i}.ffn_gate_inp.weight": ("F32", (D, E), _f32(rng, E, D).tobytes()),
            f"blk.{i}.ffn_gate_exps.weight": ("F32", (D, F, E), _f32(rng, E, F, D).tobytes()),
            f"blk.{i}.ffn_up_exps.weight": ("F32", (D, F, E), _f32(rng, E, F, D).tobytes()),
            f"blk.{i}.ffn_down_exps.weight": ("F32", (F, D, E), _f32(rng, E, D, F).tobytes()),
        })
    kv = {"general.architecture": "llama", "llama.block_count": L, "llama.embedding_length": D,
          "llama.feed_forward_length": F, "llama.attention.head_count": H,
          "llama.attention.head_count_kv": H, "llama.expert_count": E,
          "llama.expert_used_count": 2, "llama.vocab_size": V}
    tg.write_gguf(path, kv, tensors)


# chip_smoke.py's two layouts at tiny widths (K-quant rows of 256).
CHIP_TINY = ArchConfig(name="chip-tiny", vocab_size=1024, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                       rope_theta=500000.0, rope_scaling="llama3", rope_scaling_factor=32.0,
                       max_position=4096, tie_embeddings=True)


def _chip_gguf(plan: str):
    def write(path: str) -> None:
        cfg = dataclasses.replace(CHIP_TINY, tie_embeddings=plan == "q4_k_m")
        chip_smoke.write_gguf_model(path, cfg, 2, plan, seed=3)
    return write


FIXTURES = {
    "tiny": tg._tiny_gguf,  # q4_0 / q8_0, untied q8_0 head, byte vocab
    "qwen2_bias": lambda p: _bias_gguf(p, "qwen2"),
    "llama_bias": lambda p: _bias_gguf(p, "llama"),
    "moe": _moe_gguf,
    "chip_q4_k_m": _chip_gguf("q4_k_m"),  # q4_K + q6_K mixed per layer, tied
    "chip_q8_0": _chip_gguf("q8_0"),  # q8_0 with an untied head
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = {}
    for name, write in FIXTURES.items():
        d = tmp_path_factory.mktemp(name)
        write(str(d / "m.gguf"))
        out[name] = str(d / "m.gguf")
    return out


def _asdict(arch) -> dict:
    return dataclasses.asdict(arch)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loaded_tree_equals_the_jax_tree_on_the_device(files, name):
    parch, ptree, ptok = pg.load_gguf_checkpoint(files[name])
    jarch, jtree, jtok = jg.load_gguf_checkpoint(files[name])
    assert _asdict(parch) == _asdict(jarch)
    assert ptok == jtok and (ptok is None) == (name in ("qwen2_bias", "llama_bias", "moe"))
    got = params_from_numpy(parch, ptree, device="cpu")
    want = params_from_numpy(parch, jax.tree.map(np.asarray, jtree), device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(got, want, "")
    forms = {k: sorted(v) for k, v in got["layers"].items() if isinstance(v, dict)}
    if name == "chip_q4_k_m":  # q4_K keeps its bits; the mixed keys regrid to gq
        assert forms["wq"] == ["g4", "gs", "gz"] and forms["wv"] == forms["w_down"] == ["gq", "gs"]
    if name in ("tiny", "chip_q8_0"):  # the untied head: per-channel int8 for B4
        assert sorted(got["lm_head"]) == ["q", "s"]


# --------------------------------------------------------------------------- #
# Arch and tokenizer metadata
# --------------------------------------------------------------------------- #


def _meta_gguf(path: str, arch: str, extra: dict, names=()) -> None:
    """Metadata plus a few placeholder f32 tensors (their names matter)."""
    kv = {"general.architecture": arch, f"{arch}.block_count": 2,
          f"{arch}.embedding_length": 64, f"{arch}.feed_forward_length": 128,
          f"{arch}.attention.head_count": 4, f"{arch}.attention.head_count_kv": 2,
          f"{arch}.vocab_size": 256, **extra}
    one = np.zeros(4, np.float32).tobytes()
    tg.write_gguf(path, kv, {n: ("F32", (4,), one) for n in ("token_embd.weight", *names)})


ARCH_CASES = {
    "llama3_scaling": ("llama", {"llama.rope.scaling.factor": 32.0,
                                 "llama.rope.scaling.original_context_length": 8192}, ()),
    "llama3_rope_freqs": ("llama", {}, ("rope_freqs.weight", "output.weight")),
    "yarn": ("qwen2", {"qwen2.rope.scaling.type": "yarn", "qwen2.rope.scaling.factor": 4.0,
                       "qwen2.rope.scaling.original_context_length": 32768}, ()),
    "linear": ("llama", {"llama.rope.scaling.type": "linear",
                         "llama.rope.scaling.factor": 2.0}, ()),
    "gemma": ("gemma", {"gemma.attention.key_length": 32}, ()),
    "unknown_arch": ("starcoder9", {}, ()),
    "mixtral": ("llama", {"llama.expert_count": 8, "llama.expert_used_count": 2}, ()),
    "deepseek2": ("deepseek2", {"deepseek2.expert_count": 8, "deepseek2.expert_used_count": 2,
                                "deepseek2.leading_dense_block_count": 1,
                                "deepseek2.attention.kv_lora_rank": 32,
                                "deepseek2.attention.key_length": 48,
                                "deepseek2.rope.dimension_count": 16,
                                "deepseek2.rope.scaling.type": "yarn",
                                "deepseek2.rope.scaling.factor": 40.0,
                                "deepseek2.rope.scaling.yarn_log_multiplier": 0.1,
                                "deepseek2.expert_gating_func": 2},
                  ("blk.1.exp_probs_b.bias",)),
}


@pytest.mark.parametrize("case", [*ARCH_CASES, "phi3", "gemma2", "gemma3"])
def test_arch_from_gguf_is_the_jax_packages(tmp_path, files, case):
    if case in ARCH_CASES:
        arch, extra, names = ARCH_CASES[case]
        path = str(tmp_path / "m.gguf")
        _meta_gguf(path, arch, extra, names)
        pa, ja = pg.arch_from_gguf(pg.GGUFFile(path)), jg.arch_from_gguf(jg.GGUFFile(path))
        assert _asdict(pa) == _asdict(ja)
        if case == "deepseek2":  # read, and its tree is built (see the deepseek2 tests below)
            assert pa.is_mla and pa.moe_family == "deepseek"
            pg.check_supported(pa)  # the model itself is served
            tree_path = str(tmp_path / "ds.gguf")
            chip_smoke.write_gguf_deepseek(tree_path, dataclasses.replace(
                pg.arch_from_gguf(pg.GGUFFile(path)), vocab_size=256, num_layers=2),
                2, types=lambda key, i: "F32N", vocab=False)
            arch, tree, _tok = pg.load_gguf_checkpoint(tree_path)
            assert arch.is_mla and sorted(tree) == ["dense_layers", "embed", "final_norm",
                                                    "layers"]  # tied: no output.weight
        return
    path = str(tmp_path / "m.gguf")
    _meta_gguf(path, case, {})
    with pytest.raises(ValueError) as want:
        jg.arch_from_gguf(jg.GGUFFile(path))
    with pytest.raises(ValueError) as got:
        pg.arch_from_gguf(pg.GGUFFile(path))
    assert str(got.value) == str(want.value) and f"GGUF arch {case!r}" in str(got.value)


@pytest.mark.parametrize("name,nbytes", [("Q2_K", 84), ("Q3_K", 110)])
def test_unsupported_quant_types_raise_the_reference_error(tmp_path, name, nbytes):
    path = str(tmp_path / "q.gguf")
    tg.write_gguf(path, {"general.architecture": "llama"},
                  {"t": (name, (256,), np.zeros(nbytes, np.uint8).tobytes())})
    with pytest.raises(pg.GGUFReadError, match=f"quant type {name}"):
        pg.GGUFFile(path).tensor("t")
    with pytest.raises(jg.GGUFReadError, match=f"quant type {name}"):
        jg.GGUFFile(path).tensor("t")


@pytest.mark.parametrize("pre", ["llama-bpe", "qwen2", "gpt-2", "unknown-pre", "sentencepiece"])
def test_synthesized_tokenizer_is_the_jax_packages(tmp_path, pre):
    tokens, merges, types = chip_smoke.gguf_vocab(1024)
    kv = {"general.architecture": "llama",
          "tokenizer.ggml.model": "llama" if pre == "sentencepiece" else "gpt2",
          "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
          "tokenizer.ggml.token_type": types, "tokenizer.ggml.bos_token_id": 768,
          "tokenizer.ggml.eos_token_id": 777, "tokenizer.ggml.add_bos_token": True,
          "tokenizer.chat_template": chip_smoke.LLAMA3_CHAT_TEMPLATE}
    if pre != "gpt-2":  # gpt-2 is the reader's default
        kv["tokenizer.ggml.pre"] = pre
    path = str(tmp_path / "m.gguf")
    tg.write_gguf(path, kv, {})
    pf, jf = pg.GGUFFile(path), jg.GGUFFile(path)
    assert pg.tokenizer_json_from_gguf(pf) == jg.tokenizer_json_from_gguf(jf)
    pdir = pg.write_hf_tokenizer(pf, str(tmp_path / "port"))
    jdir = jg.write_hf_tokenizer(jf, str(tmp_path / "jax"))
    assert (pdir is None) == (jdir is None) == (pre == "sentencepiece")
    for f in ("tokenizer.json", "tokenizer_config.json") if pdir else ():
        with open(os.path.join(pdir, f)) as a, open(os.path.join(jdir, f)) as b:
            assert a.read() == b.read(), f


# --------------------------------------------------------------------------- #
# Served through the managers
# --------------------------------------------------------------------------- #

PROMPT = [5, 9, 20, 7, 100, 3, 44, 81, 12, 200]


def _models_dir(root, gguf_path: str) -> str:
    shutil.copy(gguf_path, root / "m.gguf")
    (root / "g.yaml").write_text(yaml.safe_dump({
        "name": "g", "model": "m.gguf", "context_size": 128, "max_slots": 2, "max_tokens": 8,
        "temperature": 0.0}))
    return str(root)


def _ids(handle) -> list[int]:
    return [ev.token_id for ev in handle if ev.kind == "token"]


@pytest.mark.parametrize("name,dtype", [("tiny", "float32"), ("qwen2_bias", "float32"),
                                        ("moe", "float32"), ("tiny", "bfloat16")])
def test_manager_serves_a_gguf_yaml_like_the_jax_manager(tmp_path, monkeypatch, files, name,
                                                         dtype):
    d = _models_dir(tmp_path, files[name])
    for mod in (pg, jg):
        saved = mod.arch_from_gguf
        monkeypatch.setattr(mod, "arch_from_gguf",
                            lambda gf, saved=saved: dataclasses.replace(saved(gf), dtype=dtype))
    if dtype == "float32":
        # The JAX tree keeps its bf16 leaves in bf16 whatever the arch says
        # (the port's params_from_numpy casts to it): widen them, exactly.
        load = jg.load_gguf_checkpoint

        def widened(path):
            arch, tree, tok = load(path)
            return arch, jax.tree.map(
                lambda a: a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a, tree), tok

        monkeypatch.setattr(jg, "load_gguf_checkpoint", widened)
    jm = JaxModelManager(JaxAppConfig(models_dir=d))
    tm = ModelManager(ApplicationConfig(models_dir=d), device="cpu")
    try:
        jlm, tlm = jm.get("g"), tm.get("g")
        cfg = tlm.engine.cfg
        assert cfg.dtype == dtype and _asdict(cfg) == _asdict(jlm.engine.cfg)
        assert tlm.engine.params["embed"].dtype == getattr(torch, dtype)
        toks, lens = np.asarray([PROMPT], np.int32), np.asarray([len(PROMPT)], np.int32)
        jlog = np.asarray(jl.prefill(jlm.engine.cfg, jlm.engine.params, jnp.asarray(toks),
                                     jnp.asarray(lens))[0], np.float32)
        tlog = tl.prefill(cfg, tlm.engine.params, torch.from_numpy(toks).long(),
                          torch.from_numpy(lens).long())[0].float().numpy()
        want = _ids(jlm.engine.submit(JaxGenRequest(prompt_ids=PROMPT, max_new_tokens=8,
                                                    ignore_eos=True)))
        got = _ids(tlm.engine.submit(GenRequest(prompt_ids=PROMPT, max_new_tokens=8,
                                                ignore_eos=True)))
        assert len(got) == len(want) == 8
        if dtype == "float32":
            np.testing.assert_allclose(tlog, jlog, atol=1e-4, rtol=0)
            assert got == want
            return
        p = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if p is not None:  # parted: only where the JAX model is at a near tie
            seq = np.asarray([PROMPT + want[:p]], np.int32)
            logits = np.asarray(jl.prefill(jlm.engine.cfg, jlm.engine.params, jnp.asarray(seq),
                                           jnp.asarray([seq.shape[1]], np.int32))[0][0],
                                np.float32)
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < 2.0 ** -6 * np.abs(logits).max(), (p, want, got)
    finally:
        jm.shutdown()
        tm.shutdown()


@pytest.mark.parametrize("case", ["missing_file", "lora_adapters"])
def test_manager_refusals_name_their_cause(tmp_path, files, case):
    d = _models_dir(tmp_path, files["tiny"])
    doc = {"name": "g", "model": "m.gguf", "context_size": 128}
    if case == "missing_file":
        doc["model"] = "absent.gguf"
    else:
        doc["lora_adapters"] = ["adapters/a"]
    (tmp_path / "g.yaml").write_text(yaml.safe_dump(doc))
    tm = ModelManager(ApplicationConfig(models_dir=d), device="cpu")
    want = "absent.gguf' not found" if case == "missing_file" else "(not GGUF or a synthetic"
    with pytest.raises(RuntimeError, match=want.replace("(", r"\(")):
        tm.get("g")
    tm.shutdown()


# --------------------------------------------------------------------------- #
# DeepSeek (deepseek2) files
# --------------------------------------------------------------------------- #

def _ds_arch(variant: str) -> ArchConfig:
    """tiny-mla (q-lora, sigmoid router with its bias, expert width 48: not
    groupable) or its groupable twin (expert width 64, no q-lora, a softmax
    router without bias), untied, f32."""
    from localai_tpu_torch.models import get_arch

    base = dataclasses.replace(get_arch("tiny-mla"), dtype="float32", tie_embeddings=False)
    if variant == "tiny-mla":
        return base
    return dataclasses.replace(base, moe_intermediate_size=64, q_lora_rank=None,
                               router_bias=False, scoring_func="softmax", n_group=1,
                               topk_group=1)


def _ds_types(variant: str):
    """F32 draws for tiny-mla; for the groupable twin q8_0 where the in
    width allows (its experts then repack from q8_0), F32 draws elsewhere."""
    if variant == "tiny-mla":
        return lambda key, i: "F32N"
    return lambda key, i: "Q8_0" if key.endswith("_exps") or key in (
        "attn_output", "ffn_down", "output", "token_embd") else "F32N"


@pytest.mark.parametrize("variant", ["tiny-mla", "groupable"])
def test_deepseek2_tree_equals_the_jax_tree(tmp_path, variant):
    cfg = _ds_arch(variant)
    path = str(tmp_path / "ds.gguf")
    chip_smoke.write_gguf_deepseek(path, cfg, cfg.num_layers, types=_ds_types(variant), seed=4)
    parch, ptree, ptok = pg.load_gguf_checkpoint(path)
    jarch, jtree, jtok = jg.load_gguf_checkpoint(path)
    assert _asdict(parch) == _asdict(jarch) and ptok == jtok is not None
    assert parch.q_lora_rank == cfg.q_lora_rank and parch.router_bias == cfg.router_bias
    got = params_from_numpy(parch, ptree, device="cpu")
    want = params_from_numpy(parch, jax.tree.map(np.asarray, jtree), device="cpu")
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    grouped = isinstance(got["layers"]["w_gate"], dict)
    assert grouped == (variant == "groupable")
    if grouped:  # B3's expert form: [L, E, G, 32, out] with [L, E, G, 1, out] scales
        L, E = cfg.num_layers - cfg.first_k_dense, cfg.num_experts
        assert tuple(got["layers"]["w_down"]["gq"].shape) == (L, E, 64 // 32, 32, 64)
        assert tuple(got["layers"]["w_down"]["gs"].shape) == (L, E, 2, 1, 64)
    assert sorted(got["lm_head"]) == ["q", "s"]


def test_deepseek2_split_kv_b_is_refused_like_the_jax_loader(tmp_path):
    cfg = _ds_arch("tiny-mla")
    path = str(tmp_path / "ds.gguf")
    chip_smoke.write_gguf_deepseek(path, cfg, cfg.num_layers, types=_ds_types("tiny-mla"))
    gf = pg.GGUFFile(path)
    gf.tensors = {("blk.1.attn_k_b.weight" if k == "blk.1.attn_kv_b.weight" else k): v
                  for k, v in gf.tensors.items()}
    jf = jg.GGUFFile(path)
    jf.tensors = {("blk.1.attn_k_b.weight" if k == "blk.1.attn_kv_b.weight" else k): v
                  for k, v in jf.tensors.items()}
    with pytest.raises(jg.GGUFReadError) as want:
        jg.load_gguf_params(jf, jg.arch_from_gguf(jf))
    with pytest.raises(pg.GGUFReadError) as got:
        pg.load_gguf_params(gf, pg.arch_from_gguf(gf))
    assert str(got.value) == str(want.value)


def test_deepseek2_greedy_ids_equal_the_jax_dense_engine(tmp_path):
    """The f32 tiny-mla file through the port's paged engine and the JAX
    package's dense engine: the same greedy ids."""
    from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
    from localai_tpu.engine import Engine as JaxEngine
    from localai_tpu.engine import EngineConfig as JaxEngineConfig
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = _ds_arch("tiny-mla")
    path = str(tmp_path / "ds.gguf")
    chip_smoke.write_gguf_deepseek(path, cfg, cfg.num_layers, types=_ds_types("tiny-mla"), seed=9)
    parch, ptree, _ = pg.load_gguf_checkpoint(path)
    jarch, jtree, _ = jg.load_gguf_checkpoint(path)
    arch = dataclasses.replace(parch, dtype="float32", max_position=256)
    jtree = jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == ml_dtypes.bfloat16
                         else np.asarray(a), jtree)
    jeng = JaxEngine(dataclasses.replace(jarch, dtype="float32", max_position=256),
                     jax.tree.map(jnp.asarray, jtree), JaxByteTokenizer(arch.vocab_size),
                     engine_cfg=JaxEngineConfig(max_slots=2, max_seq=128,
                                                prefix_admit_async_compile=False,
                                                loop_prepare_ahead=False))
    teng = Engine(arch, params_from_numpy(arch, ptree, device="cpu"),
                  ByteTokenizer(arch.vocab_size), device="cpu",
                  engine_cfg=EngineConfig(max_slots=2, max_seq=128, kv_pages=16,
                                          kv_page_size=16))
    jeng.start()
    teng.start()
    try:
        for prompt in (PROMPT, PROMPT[:3] * 7):
            want = _ids(jeng.submit(JaxGenRequest(prompt_ids=prompt, max_new_tokens=8,
                                                  ignore_eos=True)))
            got = _ids(teng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=8,
                                              ignore_eos=True)))
            assert got == want and len(got) == 8
    finally:
        jeng.stop()
        teng.stop()


@pytest.mark.parametrize("tname", ["Q4_0", "Q8_0", "Q4_K", "Q6_K"])
def test_threaded_dequant_of_a_large_tensor_is_the_jax_packages(tmp_path, tname):
    """A tensor past the threshold where the port splits its blocks over host
    threads (2^22 weights): the same bits as the JAX package's one-pass
    decode, and its grouped repack the same."""
    rng = np.random.default_rng(1)
    n_in, n_out = 4096, 1040  # 4,259,840 weights
    path = str(tmp_path / "big.gguf")
    tg.write_gguf(path, {"general.architecture": "llama"},
                  {"w": (tname, (n_in, n_out), _payload(tname, n_in * n_out, rng))})
    pf, jf = pg.GGUFFile(path), jg.GGUFFile(path)
    assert _same(pf.tensor("w"), jf.tensor("w"))
    pgr, jgr = pf.grouped("w"), jf.grouped("w")
    assert sorted(pgr) == sorted(jgr) and all(_same(pgr[k], jgr[k]) for k in pgr)


def test_threaded_host_quantizers_are_the_one_pass_ones():
    """models/quant's host quantizers past their thread threshold (2^24
    weights) give the one-pass numpy result, and the JAX package's."""
    from localai_tpu.models import quant as jq
    from localai_tpu_torch.models import quant as tq

    w = np.random.default_rng(2).standard_normal((2, 4096, 2056)).astype(np.float32) * 0.02
    got = tq.quantize_tensor_np_g4(w)
    want = tq._quantize_np_g4(w, 32)
    assert all(_same(got[k], want[k]) for k in want)
    assert all(_same(got[k], np.asarray(v)) for k, v in jq.quantize_tensor_np_g4(w).items())
    got8 = tq.quantize_tensor_np(w)
    assert all(_same(got8[k], np.asarray(v)) for k, v in jq.quantize_tensor_np(w).items())
    head = w.reshape(-1, 2056)  # a head [V, D]: one scale a row
    got_h = tq.quantize_tensor_np(head, axis=-1)
    assert all(_same(got_h[k], np.asarray(v))
               for k, v in jq.quantize_tensor_np(head, axis=-1).items())
