"""The PyTorch port's checkpoint loader against the JAX package's: the JAX
`save_hf_checkpoint` writes a tiny HF checkpoint, both loaders read it, and
every tensor must be equal. The port parses safetensors itself."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.engine.weights import SafetensorsFile
from localai_tpu_torch.models import get_arch


def _np(x):
    return np.asarray(jax.numpy.asarray(x, jax.numpy.float32))


@pytest.mark.parametrize("kind", ["llama_bf16", "qwen2_f32", "gemma_bf16"])
def test_loader_matches_jax_loader(kind, tmp_path):
    tiny = get_arch("tiny")
    cfg = {
        "llama_bf16": tiny,
        "qwen2_f32": dataclasses.replace(tiny, attn_qkv_bias=True, dtype="float32"),
        "gemma_bf16": dataclasses.replace(tiny, norm_plus_one=True, tie_embeddings=True,
                                          post_norms=True, qk_norm=True),
    }[kind]
    params = jl.init_params(cfg, jax.random.key(4))
    jw.save_hf_checkpoint(cfg, params, str(tmp_path))
    ref = jw.load_hf_checkpoint(cfg, str(tmp_path))
    out = tw.load_hf_checkpoint(cfg, str(tmp_path), device="cpu")
    assert sorted(out) == sorted(ref)
    assert sorted(out["layers"]) == sorted(ref["layers"])
    pairs = [(k, out[k], ref[k]) for k in ref if k != "layers"]
    pairs += [(f"layers/{k}", out["layers"][k], ref["layers"][k]) for k in ref["layers"]]
    for name, t, r in pairs:
        assert t.dtype == getattr(torch, cfg.dtype), name
        assert tuple(t.shape) == tuple(r.shape), name
        np.testing.assert_array_equal(t.float().numpy(), _np(r), err_msg=name)


def test_safetensors_parser_reads_every_float_type(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    tensors = {"f32": base, "f16": base.half(), "bf16": base.bfloat16()}
    path = os.path.join(tmp_path, "x.safetensors")
    save_file({**tensors, "i64": torch.arange(7)}, path, metadata={"format": "pt"})
    f = SafetensorsFile(path)
    assert sorted(f.keys()) == sorted([*tensors, "i64"])
    for name, want in tensors.items():
        got = f.get(name)
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want), name
    with pytest.raises(ValueError, match="unsupported dtype"):
        f.get("i64")


def test_arch_from_hf_config_matches_jax(tmp_path):
    cases = {
        "saved_tiny": None,
        "llama3": {"model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
                   "intermediate_size": 8192, "num_hidden_layers": 16,
                   "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
                   "rope_theta": 500000.0, "max_position_embeddings": 131072,
                   "tie_word_embeddings": True, "rms_norm_eps": 1e-5,
                   "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                                    "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                    "original_max_position_embeddings": 8192}},
        "qwen2_yarn": {"model_type": "qwen2", "vocab_size": 1000, "hidden_size": 64,
                       "intermediate_size": 128, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "num_key_value_heads": 2,
                       "rope_scaling": {"type": "yarn", "factor": 4.0,
                                        "original_max_position_embeddings": 4096}},
        "gemma2": {"model_type": "gemma2", "vocab_size": 1000, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                   "hidden_activation": "gelu_pytorch_tanh", "sliding_window": 32,
                   "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
                   "query_pre_attn_scalar": 16},
    }
    for name, hf in cases.items():
        d = tmp_path / name
        d.mkdir()
        if hf is None:
            cfg = get_arch("tiny")
            jw.save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(d))
        else:
            (d / "config.json").write_text(json.dumps(hf))
        ref = jw.arch_from_hf_config(str(d))
        out = tw.arch_from_hf_config(str(d))
        assert dataclasses.asdict(out) == dataclasses.asdict(ref), name


def test_bridge_rejects_unported_trees():
    """The bridge takes a DeepSeek two-stack tree (the dense-layer prefix
    beside the MoE stack) as it is: both stacks cross leaf for leaf, the
    router's selection bias stays f32."""
    cfg = dataclasses.replace(get_arch("tiny-mla"), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jl.init_params(cfg, jax.random.key(0)))
    out = tw.params_from_numpy(cfg, tree, device="cpu")
    assert set(out) == set(tree) and "dense_layers" in out
    for stack in ("layers", "dense_layers"):
        assert set(out[stack]) == set(tree[stack])
        for k, v in tree[stack].items():
            want = torch.float32 if k == "router_bias" else torch.bfloat16
            assert tuple(out[stack][k].shape) == v.shape and out[stack][k].dtype == want, k
            assert np.array_equal(out[stack][k].float().numpy(), np.asarray(v, np.float32)), k


def _fuse_phi3(src: str, dst: str, cfg) -> None:
    """The Phi-3 layout of an HF checkpoint dir: each layer's q / k / v rows
    in one `qkv_proj`, its gate / up rows in one `gate_up_proj`."""
    import shutil

    from safetensors.torch import save_file

    f = SafetensorsFile(os.path.join(src, "model.safetensors"))
    t = {k: f.get(k) for k in f.keys()}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "self_attn.qkv_proj.weight"] = torch.cat(
            [t.pop(p + f"self_attn.{x}_proj.weight") for x in "qkv"])
        t[p + "mlp.gate_up_proj.weight"] = torch.cat(
            [t.pop(p + "mlp.gate_proj.weight"), t.pop(p + "mlp.up_proj.weight")])
    os.makedirs(dst)
    save_file({k: v.contiguous() for k, v in t.items()}, os.path.join(dst, "model.safetensors"))
    shutil.copy(os.path.join(src, "config.json"), dst)


@pytest.mark.parametrize("mode", ["plain", "int8", "lora"])
def test_phi3_fused_checkpoint_loads_like_its_unfused_twin_and_the_jax_loader(tmp_path, mode):
    cfg = get_arch("tiny")  # 4 heads, 2 kv heads: q / k / v blocks of unequal rows
    jw.save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(5)), str(tmp_path / "twin"))
    _fuse_phi3(str(tmp_path / "twin"), str(tmp_path / "fused"), cfg)
    kw = {}
    if mode == "int8":
        kw["quantize"] = "int8"
    elif mode == "lora":
        adapter = tw.random_lora_adapter(cfg, str(tmp_path / "adapter"), 4, 8, seed=2,
                                         targets=("wq", "wk", "wv", "w_gate", "w_up"))
        kw["lora"] = [(adapter, 0.5)]
    fused = tw.load_hf_checkpoint(cfg, str(tmp_path / "fused"), device="cpu", **kw)
    twin = tw.load_hf_checkpoint(cfg, str(tmp_path / "twin"), device="cpu", **kw)
    ref = jw.load_hf_checkpoint(cfg, str(tmp_path / "fused"), **kw)

    def walk(a, b, r, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b) == sorted(r), path
            for k in a:
                walk(a[k], b[k], r[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
            np.testing.assert_array_equal(a.float().numpy(), _np(r), err_msg=path)

    walk(fused, twin, ref, "")
    assert (mode == "int8") == isinstance(fused["layers"]["wq"], dict)
