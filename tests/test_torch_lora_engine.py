"""The port's multi-tenant LoRA engine against the JAX package's on the CPU
(`tiny` f32): greedy ids per tenant equal the JAX Engine's with the same
adapters (dense and paged, unquantized and int8 bases), a mixed-tenant
batch equals each tenant solo (greedy and seeded), LRU eviction and
re-fetch from disk stay byte-exact and equal a merged-at-load engine,
recompute preemption re-pins an adapter slot with the output unchanged,
adapter prompts never chunk, typed errors, and every pin released at
quiesce."""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
from safetensors.numpy import save_file

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu_torch.engine.engine import AdapterError, Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import apply_lora, params_from_numpy
from localai_tpu_torch.models import get_arch

PROMPT = [(i * 37) % 251 + 1 for i in range(20)]
PROMPT2 = [(i * 13) % 251 + 2 for i in range(33)]
BASE = dict(max_slots=4, max_seq=128, min_prefill_bucket=16, block_sizes=(8,))
PAGED = dict(kv_pages=14, kv_page_size=32)


def make_adapter(path, cfg, r=4, alpha=8, seed=0, scale=0.05, mods=("q", "v")):
    """A PEFT-format adapter dir from a numpy seed (the JAX package's
    tests/test_lora_serving.py layout)."""
    rng = np.random.default_rng(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size
    H = cfg.num_heads * cfg.head_dim_
    K = cfg.num_kv_heads * cfg.head_dim_
    table = {"q": ("self_attn.q_proj", D, H), "k": ("self_attn.k_proj", D, K),
             "v": ("self_attn.v_proj", D, K), "o": ("self_attn.o_proj", H, D),
             "gate": ("mlp.gate_proj", D, F), "up": ("mlp.up_proj", D, F),
             "down": ("mlp.down_proj", F, D)}
    tensors = {}
    for i in range(cfg.num_layers):
        for m in mods:
            mod, d_in, d_out = table[m]
            pre = f"base_model.model.model.layers.{i}.{mod}"
            tensors[f"{pre}.lora_A.weight"] = rng.normal(0, scale, (r, d_in)).astype(np.float32)
            tensors[f"{pre}.lora_B.weight"] = rng.normal(0, scale, (d_out, r)).astype(np.float32)
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    return str(path)


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


@pytest.fixture(scope="module")
def adapters(weights, tmp_path_factory):
    cfg = weights[0]
    root = tmp_path_factory.mktemp("adapters")
    kws = [dict(seed=1, mods=("q", "v", "o", "down", "gate")),  # row + mlp targets
           dict(seed=2), dict(seed=3, r=6), dict(seed=4)]
    return {f"t{i}": make_adapter(root / f"a{i}", cfg, **kw) for i, kw in enumerate(kws)}


def _engine(weights, quantization="", **kw):
    cfg, _, tp = weights
    return Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                  quantization=quantization, engine_cfg=EngineConfig(**{**BASE, **kw}))


def _jax_engine(weights, quantization="", **kw):
    cfg, jp, _ = weights
    return JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), quantization=quantization,
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0,
                                                prefix_admit_async_compile=False,
                                                **{**BASE, **kw}))


def _ids(eng, Req, prompt=PROMPT, adapter=None, **kw):
    kw.setdefault("max_new_tokens", 10)
    out = []
    for ev in eng.submit(Req(prompt_ids=list(prompt), ignore_eos=True, adapter=adapter, **kw)):
        assert ev.kind != "error", ev.error
        if ev.kind == "token":
            out.append(ev.token_id)
    return out


def _quiesced(eng):
    assert all(int(r) == 0 for r in eng._adapter_refs), eng._adapter_refs
    assert not eng.h_adapter.any()


@pytest.mark.parametrize("quantization, kw", [
    ("", {}), ("", PAGED), ("int8", {}), ("int8", PAGED),
], ids=["dense", "paged", "int8-dense", "int8-paged"])
def test_greedy_ids_per_tenant_match_jax_engine(weights, adapters, quantization, kw):
    jeng = _jax_engine(weights, quantization, **kw)
    teng = _engine(weights, quantization, **kw)
    try:
        for name in ("t0", "t1", "t2"):
            jeng.register_adapter(name, adapters[name])
            teng.register_adapter(name, adapters[name])
        for name in (None, "t0", "t1", "t2"):
            want = _ids(jeng, JaxGenRequest, adapter=name)
            got = _ids(teng, GenRequest, adapter=name)
            assert got == want, name
        assert teng.metrics()["adapter_promotes"] == 3
        _quiesced(teng)
    finally:
        jeng.stop()
        teng.stop()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_tenant_batch_matches_solo(weights, adapters, paged):
    eng = _engine(weights, **(PAGED if paged else {}))
    try:
        for name in ("t0", "t1", "t2"):
            eng.register_adapter(name, adapters[name])
        plans = [(PROMPT, None, {}), (PROMPT, "t0", {}), (PROMPT2, "t1", {}),
                 (PROMPT, "t2", dict(seed=11, temperature=0.8, top_k=20))]
        solo = [_ids(eng, GenRequest, p, ad, **kw) for p, ad, kw in plans]
        assert len({tuple(s) for s in solo}) == len(solo), "the adapters changed nothing"
        mixed: dict[int, list] = {}

        def run(i, p, ad, kw):
            mixed[i] = _ids(eng, GenRequest, p, ad, **kw)

        ths = [threading.Thread(target=run, args=(i, *plan)) for i, plan in enumerate(plans)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        assert [mixed[i] for i in range(len(plans))] == solo
        _quiesced(eng)
    finally:
        eng.stop()


def test_lru_eviction_and_refetch_byte_exact_vs_merged(weights, adapters):
    """Device rows cap at max_slots + 1: 4 tenants through 3 rows evict;
    adapter_cache_bytes=1 keeps no host image, so each re-fetch reads the
    disk. Output stays byte-exact and equals a merged-at-load engine."""
    cfg, _, tp = weights
    eng = _engine(weights, max_slots=2, adapter_cache_bytes=1, **PAGED)
    try:
        for name in ("t0", "t1", "t2", "t3"):
            eng.register_adapter(name, adapters[name])
        first = {n: _ids(eng, GenRequest, adapter=n) for n in ("t0", "t1", "t2", "t3")}
        m = eng.metrics()
        assert m["adapter_evictions"] > 0 and m["adapter_host_bytes"] == 0
        assert m["adapter_device_resident"] == 2
        assert _ids(eng, GenRequest, adapter="t0") == first["t0"]
        assert eng.metrics()["adapter_fetches"] == 5
        _quiesced(eng)
    finally:
        eng.stop()
    merged = apply_lora(cfg, tp, adapters["t0"])
    oracle = Engine(cfg, merged, ByteTokenizer(cfg.vocab_size), device="cpu",
                    engine_cfg=EngineConfig(**{**BASE, "max_slots": 2, **PAGED}))
    try:
        assert _ids(oracle, GenRequest) == first["t0"]
    finally:
        oracle.stop()


def test_host_lru_keeps_images_under_the_budget(weights, adapters):
    eng = _engine(weights, max_slots=2)
    try:
        for name in ("t1", "t3"):
            eng.register_adapter(name, adapters[name])
        _ids(eng, GenRequest, adapter="t1", max_new_tokens=2)
        one = eng.metrics()["adapter_host_bytes"]
        assert one > 0
        _ids(eng, GenRequest, adapter="t3", max_new_tokens=2)
        assert eng.metrics()["adapter_host_bytes"] == 2 * one  # both fit in 64 MiB
    finally:
        eng.stop()


def test_preempted_adapter_slot_repins_with_output_unchanged(weights, adapters):
    """A pool too small for two long generations: the youngest slot (a
    tenant) is preempted by recompute and re-admitted, re-pinning its
    adapter; both outputs equal their solo runs."""
    eng = _engine(weights, max_slots=2, kv_pages=5, kv_page_size=32, kv_page_headroom=0)
    try:
        eng.register_adapter("t1", adapters["t1"])
        plans = [(PROMPT, None), (PROMPT2, "t1")]
        solo = [_ids(eng, GenRequest, p, ad, max_new_tokens=60) for p, ad in plans]
        got: dict[int, list] = {}

        def run(i, p, ad):
            got[i] = _ids(eng, GenRequest, p, ad, max_new_tokens=60)

        ths = [threading.Thread(target=run, args=(i, *plan)) for i, plan in enumerate(plans)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        assert eng.metrics()["kv_preemptions"] > 0
        assert [got[0], got[1]] == solo
        _quiesced(eng)
    finally:
        eng.stop()


def test_adapter_prompts_never_chunk(weights, adapters):
    long_prompt = [(i * 7) % 250 + 1 for i in range(80)]
    eng = _engine(weights, kv_pages=14, kv_page_size=32, prefill_chunk=32)
    try:
        eng.register_adapter("t2", adapters["t2"])
        _ids(eng, GenRequest, long_prompt, "t2", max_new_tokens=4)
        m = eng.metrics()
        assert m["chunked_admits"] == 0 and m["admissions"] == 1
        _ids(eng, GenRequest, long_prompt, None, max_new_tokens=4)
        assert eng.metrics()["chunked_admits"] == 1
        _quiesced(eng)
    finally:
        eng.stop()


def test_typed_adapter_errors(weights, adapters):
    eng = _engine(weights)
    try:
        with pytest.raises(AdapterError, match="unknown adapter"):
            eng.submit(GenRequest(prompt_ids=[1, 2], adapter="nope"))
        eng.register_adapter("t0", adapters["t0"])
        eng.register_adapter("t0", adapters["t0"])  # idempotent
        with pytest.raises(AdapterError, match="already registered"):
            eng.register_adapter("t0", adapters["t1"])
        with pytest.raises(AdapterError, match="already registered"):
            eng.register_adapter("t0", adapters["t0"], weight=0.5)
        assert eng.adapter_names() == ["t0"]
        with pytest.raises(ValueError, match="adapter_cache_bytes"):
            _engine(weights, adapter_cache_bytes=-1)
    finally:
        eng.stop()


def test_failed_fetch_errors_only_that_request(weights, adapters, tmp_path):
    """A tenant whose adapter cannot be read fails its own request with an
    error event; the engine keeps serving and no pin leaks."""
    eng = _engine(weights)
    try:
        eng.register_adapter("gone", str(tmp_path / "missing"))
        evs = list(eng.submit(GenRequest(prompt_ids=PROMPT, max_new_tokens=3, adapter="gone")))
        assert evs[-1].kind == "error" and len(evs) == 1
        assert len(_ids(eng, GenRequest, max_new_tokens=3)) == 3
        _quiesced(eng)
    finally:
        eng.stop()
