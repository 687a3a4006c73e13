"""The port's PEFT LoRA loaders (engine/weights.py) against the JAX
package's on the same adapter dirs: ranks, keys and arrays equal for the
runtime factors and the merge deltas (F32 / F16 / BF16 adapters, fused
phi-3 targets), the same rejections, `apply_lora` on plain and quantized
trees, and `load_hf_checkpoint(lora=, quantize=)` bit-identical."""

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models.quant import quantize_params

from test_torch_lora_engine import make_adapter


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_arch("tiny"), dtype="float32")


def _write(path, tensors, r=4, alpha=8):
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    return str(path)


def _fused_adapter(path, cfg, seed=5, r=4):
    """phi-3-style targets: fused qkv_proj and gate_up_proj, plus an
    ignored lm_head target."""
    rng = np.random.default_rng(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim_
    t = {}
    for i in range(cfg.num_layers):
        for mod, d_in, d_out in (("self_attn.qkv_proj", D, qkv), ("mlp.gate_up_proj", D, 2 * F)):
            pre = f"base_model.model.model.layers.{i}.{mod}"
            t[f"{pre}.lora_A.weight"] = rng.normal(0, 0.05, (r, d_in)).astype(np.float32)
            t[f"{pre}.lora_B.weight"] = rng.normal(0, 0.05, (d_out, r)).astype(np.float32)
    t["base_model.model.lm_head.lora_A.weight"] = np.zeros((r, D), np.float32)
    t["base_model.model.lm_head.lora_B.weight"] = np.zeros((cfg.vocab_size, r), np.float32)
    return _write(path, t, r=r)


def _cast_dir(src, dst, dtype):
    """The same adapter stored in F16 or BF16."""
    from safetensors.numpy import load_file

    t = {k: v.astype(dtype) for k, v in load_file(os.path.join(src, "adapter_model.safetensors")).items()}
    return _write(dst, t)


@pytest.fixture(scope="module")
def dirs(cfg, tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_w")
    plain = make_adapter(root / "plain", cfg, seed=1, mods=("q", "k", "v", "o", "gate", "up",
                                                              "down"))
    return {
        "plain": plain,
        "fused": _fused_adapter(root / "fused", cfg),
        "f16": _cast_dir(plain, root / "f16", np.float16),
    }


def _same_factors(got, want):
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        assert set(got[1][key]) == set(want[1][key])
        for li, (a, b) in want[1][key].items():
            np.testing.assert_array_equal(got[1][key][li][0], a)
            np.testing.assert_array_equal(got[1][key][li][1], b)


@pytest.mark.parametrize("which", ["plain", "fused", "f16"])
def test_load_lora_factors_equal_jax(cfg, dirs, which):
    want = jw.load_lora_factors(dirs[which], 0.5, cfg)
    got = tw.load_lora_factors(dirs[which], 0.5, cfg)
    _same_factors(got, want)
    if which == "fused":
        assert set(got[1]) == {"wq", "wk", "wv", "w_gate", "w_up"}


def test_bf16_adapter_factors_equal_jax(cfg, dirs, tmp_path):
    """A BF16 safetensors adapter: the port's own reader against the JAX
    package's (safetensors + ml_dtypes)."""
    from safetensors.numpy import load_file

    src = load_file(os.path.join(dirs["plain"], "adapter_model.safetensors"))
    bf = {k: v.astype(ml_dtypes.bfloat16) for k, v in src.items()}
    # safetensors.numpy cannot store bf16: write the file by hand (8-byte
    # header length, JSON header, raw little-endian bytes).
    as_bf16 = str(tmp_path / "bf16")
    os.makedirs(as_bf16)
    header, blobs, off = {}, [], 0
    for k, v in bf.items():
        raw = np.ascontiguousarray(v).view(np.uint16).astype("<u2").tobytes()
        header[k] = {"dtype": "BF16", "shape": list(v.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(os.path.join(as_bf16, "adapter_model.safetensors"), "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    with open(os.path.join(as_bf16, "adapter_config.json"), "w") as f:
        json.dump({"r": 4, "lora_alpha": 8}, f)
    _same_factors(tw.load_lora_factors(as_bf16, 1.0, cfg), jw.load_lora_factors(as_bf16, 1.0, cfg))


@pytest.mark.parametrize("which", ["plain", "fused"])
def test_load_lora_deltas_equal_jax(cfg, dirs, which):
    want = jw.load_lora_deltas(dirs[which], 0.7, cfg)
    got = tw.load_lora_deltas(dirs[which], 0.7, cfg)
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key])
        for li, d in want[key].items():
            np.testing.assert_array_equal(got[key][li], d)


def test_rejections_match_jax(cfg, tmp_path):
    D = cfg.hidden_size
    cases = {
        "expert": ({"base_model.model.model.layers.0.block_sparse_moe.experts.0.w1"
                    ".lora_A.weight": np.zeros((4, D), np.float32),
                    "base_model.model.model.layers.0.block_sparse_moe.experts.0.w1"
                    ".lora_B.weight": np.zeros((8, 4), np.float32)}, "expert"),
        "layer": ({f"base_model.model.model.layers.{cfg.num_layers}.self_attn.q_proj"
                   ".lora_A.weight": np.zeros((4, D), np.float32),
                   f"base_model.model.model.layers.{cfg.num_layers}.self_attn.q_proj"
                   ".lora_B.weight": np.zeros((cfg.num_heads * cfg.head_dim_, 4), np.float32)},
                  "target layer"),
        "shape": ({"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
                   np.zeros((4, D + 8), np.float32),
                   "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight":
                   np.zeros((cfg.num_heads * cfg.head_dim_, 4), np.float32)}, "model expects"),
        "nothing": ({"base_model.model.lm_head.lora_A.weight": np.zeros((4, D), np.float32),
                     "base_model.model.lm_head.lora_B.weight":
                     np.zeros((cfg.vocab_size, 4), np.float32)}, "matched no served weight"),
    }
    for name, (tensors, match) in cases.items():
        d = _write(tmp_path / name, tensors)
        for mod in (jw, tw):
            with pytest.raises(ValueError, match=match):
                mod.load_lora_factors(d, cfg=cfg)


def test_apply_lora_equals_jax_and_rejects_quantized(cfg, dirs):
    from localai_tpu.models.quant import quantize_params as jax_quantize_params

    jp = jl.init_params(cfg, jax.random.key(0))
    tp = tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    want = jw.apply_lora(cfg, jp, dirs["plain"], weight=0.8)
    got = tw.apply_lora(cfg, tp, dirs["plain"], weight=0.8)
    for key, leaf in want["layers"].items():
        assert torch.equal(got["layers"][key], torch.from_numpy(np.array(leaf))), key
    # The input tree is left as it was.
    assert torch.equal(tp["layers"]["wq"], torch.from_numpy(np.array(jp["layers"]["wq"])))
    with pytest.raises(ValueError, match="quantized"):
        jw.apply_lora(cfg, jax_quantize_params(cfg, jp, "int8"), dirs["plain"])
    with pytest.raises(ValueError, match="quantized"):
        tw.apply_lora(cfg, quantize_params(cfg, tp, "int8"), dirs["plain"])


@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
def test_load_hf_checkpoint_with_lora_bit_identical(cfg, dirs, tmp_path, quantize):
    jp = jl.init_params(cfg, jax.random.key(3))
    ckpt = str(tmp_path / "ckpt")
    jw.save_hf_checkpoint(cfg, jp, ckpt)
    lora = [(dirs["plain"], 0.6), (dirs["fused"], 1.5)]
    want = jw.load_hf_checkpoint(cfg, ckpt, quantize=quantize, lora=lora)
    got = tw.load_hf_checkpoint(cfg, ckpt, device="cpu", quantize=quantize, lora=lora)
    for key, leaf in want["layers"].items():
        g = got["layers"][key]
        if isinstance(leaf, dict):
            assert set(g) == set(leaf), key
            for k in leaf:
                assert torch.equal(g[k], torch.from_numpy(np.array(leaf[k]))), (key, k)
        else:
            assert torch.equal(g, torch.from_numpy(np.array(leaf))), key
    plain = tw.load_hf_checkpoint(cfg, ckpt, device="cpu")
    assert not torch.equal(plain["layers"]["wq"], tw.load_hf_checkpoint(
        cfg, ckpt, device="cpu", lora=lora)["layers"]["wq"])


def _expert_adapter(path, cfg, experts, seed=7, r=4):
    """A PEFT adapter on Mixtral's expert projections (w1 / w3 / w2 of each
    (layer, expert) in `experts`) and on q_proj / v_proj."""
    rng = np.random.default_rng(seed)
    D, F, Q = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads * cfg.head_dim_
    t = {}
    mods = [(f"block_sparse_moe.experts.{e}.{w}", (D, F) if w != "w2" else (F, D), i)
            for i, e in experts for w in ("w1", "w3", "w2")]
    mods += [(f"self_attn.{m}_proj", (D, Q if m == "q" else cfg.num_kv_heads * cfg.head_dim_),
              i) for i in range(cfg.num_layers) for m in ("q", "v")]
    for mod, (d_in, d_out), i in mods:
        pre = f"base_model.model.model.layers.{i}.{mod}"
        t[f"{pre}.lora_A.weight"] = rng.normal(0, 0.05, (r, d_in)).astype(np.float32)
        t[f"{pre}.lora_B.weight"] = rng.normal(0, 0.05, (d_out, r)).astype(np.float32)
    return _write(path, t, r=r)


@pytest.mark.parametrize("quantize", ["", "int4"])
def test_expert_lora_merges_like_the_jax_loader(tmp_path, quantize):
    """A tiny-moe checkpoint saved by the JAX package and an adapter on
    every layer's experts 0, 2 and 3 (and q / v), merged at load in bf16 or
    int4: the port's tree equals the JAX loader's, leaf for leaf, and the
    merged experts differ from the plain load."""
    cfg = get_arch("tiny-moe")  # bf16
    ckpt = str(tmp_path / "ckpt")
    jw.save_hf_checkpoint(cfg, jl.init_params(dataclasses.replace(cfg, dtype="float32"),
                                              jax.random.key(4)), ckpt)
    experts = [(i, e) for i in range(cfg.num_layers) for e in (0, 2, 3)]
    lora = [(_expert_adapter(tmp_path / "a", cfg, experts), 0.7)]
    want = tw.params_from_numpy(cfg, jax.tree.map(
        np.asarray, jw.load_hf_checkpoint(cfg, ckpt, quantize=quantize, lora=lora)), device="cpu")
    got = tw.load_hf_checkpoint(cfg, ckpt, device="cpu", quantize=quantize, lora=lora)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    plain = tw.load_hf_checkpoint(cfg, ckpt, device="cpu", quantize=quantize)
    key = "g4" if quantize else None
    for e in range(cfg.num_experts):
        a = got["layers"]["w_up"][key][:, e] if key else got["layers"]["w_up"][:, e]
        b = plain["layers"]["w_up"][key][:, e] if key else plain["layers"]["w_up"][:, e]
        assert torch.equal(a, b) == (e == 1), e  # expert 1 has no delta


def test_expert_lora_index_out_of_range_raises_like_the_jax_loader(tmp_path):
    cfg = dataclasses.replace(get_arch("tiny-moe"), dtype="float32")
    ckpt = str(tmp_path / "ckpt")
    jw.save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(4)), ckpt)
    lora = [(_expert_adapter(tmp_path / "a", cfg, [(1, cfg.num_experts)]), 1.0)]
    with pytest.raises(ValueError) as want:
        jw.load_hf_checkpoint(cfg, ckpt, lora=lora)
    with pytest.raises(ValueError) as got:
        tw.load_hf_checkpoint(cfg, ckpt, device="cpu", lora=lora)
    assert str(got.value) == str(want.value) and "out of range" in str(got.value)
    # Runtime tenants on expert targets stay refused in both packages.
    with pytest.raises(ValueError, match="MoE expert projections") as want:
        jw.load_lora_factors(lora[0][0], cfg=cfg)
    with pytest.raises(ValueError, match="MoE expert projections") as got:
        tw.load_lora_factors(lora[0][0], cfg=cfg)
