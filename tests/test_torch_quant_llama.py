"""The port's Llama forward on quantized weights against the JAX package on
the CPU: `tiny` (its lm_head is untied, so the int8 head is on the path) in
f32 with int8 and int4 weights, prefill logits and 32 greedy decode steps;
and the quantizing HF loader, tensor for tensor against the JAX loader."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu.models import quant as jq
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models import quant as tq

# f32 both sides. The port's decode-shape products run the kernels' plain
# versions (dequantize in f32, then multiply), the JAX package's XLA forms
# (grouped: scale the partial sums); both differ in rounding only.
LOGIT_ATOL = 1e-4


def _cfg():
    return dataclasses.replace(get_arch("tiny"), dtype="float32")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_prefill_and_greedy_decode_match_jax(mode):
    cfg = _cfg()
    assert not cfg.tie_embeddings
    jp = jq.quantize_params(cfg, jl.init_params(cfg, jax.random.key(0)), mode)
    tp = tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tq.is_quantized(tp["lm_head"]) and tq.is_prequantized(tp)
    B, S, MAXS, n = 2, 16, 64, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([5, 16], np.int32)
    jlog, jks, jvs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    before = tq.matmul.dequant_calls, tq.unembed_matmul.dequant_calls
    tlog, tks, tvs = tl.prefill(cfg, tp, torch.from_numpy(toks), torch.from_numpy(lens))
    # 32 prefill rows: every product took the kernels' route (plain on the CPU).
    assert (tq.matmul.dequant_calls, tq.unembed_matmul.dequant_calls) == before
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    jcache = jl.KVCache.zeros(cfg, B, MAXS)
    tcache = tl.KVCache.zeros(cfg, B, MAXS, device="cpu")
    for b in range(B):
        jcache = jl.write_prefill_to_cache(jcache, jks[:, b:b + 1], jvs[:, b:b + 1], b)
        tl.write_prefill_to_cache(tcache, tks[:, b:b + 1], tvs[:, b:b + 1], b)
    jstep = jax.jit(partial(jl.decode_step_windowed, cfg))
    jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), torch.argmax(tlog, -1)
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens).long()
    L, K, Hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    jids, tids = [], []
    for _blk in range(4):
        jlk = jnp.zeros((L, B, n, K, Hd), jnp.float32)
        jlv = jnp.zeros_like(jlk)
        tlk, tlv = torch.zeros((L, B, n, K, Hd)), torch.zeros((L, B, n, K, Hd))
        jstart, tstart = jpos, tpos
        for step in range(n):
            jlogits, jlk, jlv = jstep(jp, jtok, jpos, jcache, jlk, jlv, jnp.int32(step))
            tlogits, tlk, tlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, tcache, tlk, tlv,
                                                        step)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=LOGIT_ATOL, rtol=0)
            jtok, ttok = jnp.argmax(jlogits, -1).astype(jnp.int32), torch.argmax(tlogits, -1)
            jids.append(np.asarray(jtok))
            tids.append(ttok.numpy())
            jpos, tpos = jpos + 1, tpos + 1
        jcache = jl.write_block_to_cache(jcache, jlk, jlv, jstart)
        tl.write_block_to_cache(tcache, tlk, tlv, tstart)
    assert len(tids) == 32 and np.array_equal(np.stack(tids), np.stack(jids))


def test_check_params_rejects_a_dict_that_is_not_a_quantized_weight():
    cfg = _cfg()
    tp = tl.init_params(cfg, device="cpu")
    tp["layers"]["wq"] = {"w": tp["layers"]["wq"]}
    with pytest.raises(ValueError, match="quantized weight"):
        tl.prefill(cfg, tp, torch.zeros((1, 4), dtype=torch.long), torch.tensor([4]))


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantizing_loader_matches_jax_loader(tmp_path, mode):
    cfg = dataclasses.replace(get_arch("tiny"), dtype="bfloat16")
    jw.save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(3)), str(tmp_path))
    want = jw.load_hf_checkpoint(cfg, str(tmp_path), quantize=mode)
    got = tw.load_hf_checkpoint(cfg, str(tmp_path), device="cpu", quantize=mode)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(_leaves(got))
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        leaf = np.asarray(leaf)
        if leaf.dtype.name == "bfloat16":
            assert node.dtype == torch.bfloat16, path
            assert np.array_equal(node.view(torch.uint16).numpy(), leaf.view(np.uint16)), path
        else:
            assert node.dtype == getattr(torch, leaf.dtype.name), path
            assert np.array_equal(node.numpy(), leaf), path
    assert got["layers"]["w_down"]["g4" if mode == "int4" else "q"] is not None
    assert got["lm_head"]["q"].dtype == torch.int8 and got["lm_head"]["s"].shape[-1] == 1
    with pytest.raises(ValueError, match="unsupported quantization"):
        tw.load_hf_checkpoint(cfg, str(tmp_path), device="cpu", quantize="int2")
