"""The port's Engine with quantized weights and fp8 KV against the JAX
package's Engine on the CPU: greedy ids equal on `tiny` f32, dense and paged
+ chunked, int8 / int4 weights (quantized by each engine where they lie),
fp8 e4m3 caches (dense, and paged with kv_scale 1 and 2; e5m2 is held to
the JAX package in test_torch_fp8_kv.py); and the new knobs' validation and
the weight-bytes metric."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _ids(n, mult=7):
    return [(j * mult) % 250 + 1 for j in range(n)]


PROMPTS = [_ids(150), [3, 1, 4], _ids(70, 3), list(range(40, 60))]
BASE = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
PAGED = dict(kv_pages=12, kv_page_size=64, prefill_chunk=64)


def _greedy(eng, Req):
    hs = [eng.submit(Req(prompt_ids=p, max_new_tokens=12, ignore_eos=True)) for p in PROMPTS]
    out = []
    for h in hs:
        evs = list(h)
        assert evs[-1].kind == "done", evs[-1]
        out.append([e.token_id for e in evs if e.kind == "token"])
    return out


@pytest.mark.parametrize("quantization, kw", [
    ("int8", {}),
    ("int4", dict(kv_cache_dtype="fp8")),  # an fp8 dense cache
    ("int4", dict(PAGED, kv_cache_dtype="fp8")),  # the fp8 block-local window
    ("int8", dict(PAGED, kv_cache_dtype="fp8", kv_scale=2.0)),  # a model-dtype window
], ids=["int8-dense", "int4-dense-fp8", "int4-paged-fp8", "int8-paged-fp8-scale2"])
def test_engine_greedy_ids_match_jax_engine(weights, quantization, kw):
    cfg, jp, tp = weights
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), quantization=quantization,
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, **BASE, **kw))
    teng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                  quantization=quantization, engine_cfg=EngineConfig(**BASE, **kw))
    try:
        want = _greedy(jeng, JaxGenRequest)
        got = _greedy(teng, GenRequest)
        assert got == want
        assert teng.cache.k.dtype == teng.ecfg.cache_dtype(torch.float32)
        m = teng.metrics()
        if kw.get("kv_pages"):
            assert m["chunked_admits"] == 2 and m["kv_pages_free"] == PAGED["kv_pages"]
    finally:
        jeng.stop()
        teng.stop()


def test_weight_bytes_and_quantization_where_params_lie(weights):
    cfg, _, tp = weights
    sizes = {}
    for mode in ("", "int8", "int4"):
        eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu", quantization=mode,
                     engine_cfg=EngineConfig(**BASE))
        sizes[mode] = eng.metrics()["weight_bytes"]
        if mode:
            assert eng.params["layers"]["wq"]["q" if mode == "int8" else "g4"].dtype in (
                torch.int8, torch.uint8)
            # An already-quantized tree is served as it is.
            again = Engine(cfg, eng.params, ByteTokenizer(cfg.vocab_size), device="cpu",
                           quantization="int4", engine_cfg=EngineConfig(**BASE))
            assert again.params is eng.params
    expected = sum(t.numel() * 4 for t in [*tp["layers"].values(), tp["embed"],
                                           tp["final_norm"], tp["lm_head"]])
    assert sizes[""] == expected
    assert sizes["int4"] < sizes["int8"] < sizes[""]


@pytest.mark.parametrize("kw, quantization, match", [
    (dict(kv_scale=0.0), "", "kv_scale must be > 0"),
    (dict(kv_scale=2.0, kv_cache_dtype="fp8"), "", "paged pool"),
    (dict(PAGED, kv_scale=2.0), "", "fp8"),
    (dict(kv_cache_dtype="int8"), "", "kv_cache_dtype"),
    ({}, "int3", "unsupported quantization"),
])
def test_bad_quant_and_kv_configs_raise(weights, kw, quantization, match):
    cfg, _, tp = weights
    with pytest.raises(ValueError, match=match):
        Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu", quantization=quantization,
               engine_cfg=EngineConfig(**BASE, **kw))
