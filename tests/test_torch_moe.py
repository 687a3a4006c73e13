"""The port's mixtral-family mixture-of-experts serving against the JAX
package on the CPU: B3's expert form (the plain version against the Pallas
kernel in interpret mode and against the XLA forms, both einsum shapes,
flat int8 / grouped int8 / int4), its dispatch, the router (ties
included), the MoE layer's dense and ragged routes, the whole `tiny-moe`
model (prefill logits, greedy decode, the dense and paged engines) in f32
unquantized / int8 / int4, the HF checkpoint loader and the quantized
random init, and the refusal of runtime adapters on an MoE base."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu.models import quant as jq
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.engine.engine import AdapterError, Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models import quant as tq
from localai_tpu_torch.ops import quant_matmul as tqm

SHARED, PER_EXPERT = "...d,edf->...ef", "...ef,efd->...ed"
# f32 x: the JAX package's own kernel-against-oracle tolerance
# (tests/test_quant.py); both sides differ in summation order only.
KERNEL_TOL = 2e-4
# bf16 x: the Pallas kernel and the plain version both sum in f32 and round
# once to bf16, so they may differ by one bf16 step (2^-7 of the value) plus
# an f32 summation-order term.
BF16_REL, BF16_ABS = 2.0**-7, 1e-5
# f32 models: summation order only (the dense tests' tolerance).
LOGIT_ATOL = 1e-4
MODES = ["none", "int8", "int4"]


def _cfg(**kw):
    return dataclasses.replace(get_arch("tiny-moe"), dtype="float32", **kw)


def _np_grouped_int8(w, group=32):
    """Group-wise symmetric int8 over the in (-2) axis of [E, in, out]: the
    JAX quantizers make only the flat and int4 forms."""
    *lead, n_in, n_out = w.shape
    wg = w.reshape(*lead, n_in // group, group, n_out).astype(np.float32)
    s = np.maximum(np.abs(wg).max(axis=-2, keepdims=True) / 127.0, 1e-9).astype(np.float32)
    return {"gq": np.clip(np.round(wg / s), -127, 127).astype(np.int8), "gs": s}


def _expert_weight(form, E, n_in, n_out, seed):
    w = np.random.default_rng(seed).standard_normal((E, n_in, n_out)).astype(np.float32) * 0.1
    if form == "grouped_int8":
        return _np_grouped_int8(w)
    qfn = jq.quantize_tensor if form == "int8" else jq.quantize_tensor_g4
    return {k: np.asarray(v) for k, v in jax.vmap(qfn)(jnp.asarray(w)).items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _moe_x(sub, N, E, n_in, seed, dtype=np.float32):
    shape = (N, n_in) if sub == SHARED else (N, E, n_in)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("sub", [SHARED, PER_EXPERT])
def test_expert_form_plain_matches_jax(sub, form, impl):
    """qmm_moe_plain against JAX _moe_mm: the Pallas kernel in interpret
    mode over its (expert, out tile, k chunk) grid, and the XLA forms."""
    E, n_in, n_out, N = 4, 64, 48, 3
    w = _expert_weight(form, E, n_in, n_out, seed=4)
    x = _moe_x(sub, N, E, n_in, seed=5)
    want = jl._moe_mm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, sub,
                      impl=impl)
    got = tqm.qmm_moe_plain(torch.from_numpy(x), _t(w), sub)
    assert got.shape == (N, E, n_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
@pytest.mark.parametrize("sub", [SHARED, PER_EXPERT])
def test_expert_form_plain_matches_jax_kernel_in_bf16(sub, form):
    E, n_in, n_out, N = 4, 64, 48, 3
    w = _expert_weight(form, E, n_in, n_out, seed=6)
    x = torch.from_numpy(_moe_x(sub, N, E, n_in, seed=7)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jl._moe_mm(xj, {k: jnp.asarray(v) for k, v in w.items()}, sub,
                                 impl="pallas").astype(jnp.float32))
    got = tqm.qmm_moe_plain(x, _t(w), sub)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_REL * np.abs(want) + BF16_ABS * np.abs(want).max()).all(), err.max()


@pytest.mark.parametrize("sub", [SHARED, PER_EXPERT])
def test_moe_dispatch_splits_by_rows_and_dtype(sub):
    """≤ 256 float rows go to the expert form's wrapper (its plain version
    on the CPU, no launch counted), the per-expert shape counting its rows
    without the expert axis; 320 rows, integer x or another einsum do
    not."""
    E, n_in = 3, 64
    w = _t(_expert_weight("int4", E, n_in, 32, seed=8))
    lead = (4, 64)
    tail = (n_in,) if sub == SHARED else (E, n_in)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(lead + tail)
                         .astype(np.float32))
    launches = tqm.qmm_moe.launches
    got = tqm.dispatch_moe_mm(x, w, sub)
    assert got.shape == (4, 64, E, 32)
    assert torch.equal(got, tqm.qmm_moe_plain(x.reshape(256, *tail), w, sub)
                       .reshape(4, 64, E, 32))
    assert tqm.dispatch_moe_mm(torch.cat([x, x[:1]]), w, sub) is None  # 320 rows
    assert tqm.dispatch_moe_mm(x.to(torch.int32), w, sub) is None
    assert tqm.dispatch_moe_mm(x[:0], w, sub) is None
    assert tqm.dispatch_moe_mm(x, w, "...d,edf->...fe") is None
    assert tqm.qmm_moe.launches == launches  # the CPU never launches
    # Above 256 rows the dequantize-then-matmul forms serve, and count.
    before = tq.moe_matmul.dequant_calls
    big = torch.cat([x, x[:1]])
    y = tq.moe_matmul(big, w, sub)
    assert tq.moe_matmul.dequant_calls == before + 1
    np.testing.assert_allclose(y.numpy(), tqm.qmm_moe_plain(big, w, sub).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.qmm_moe(x[0].to("meta"), w, sub)


@pytest.fixture(scope="module")
def layer():
    cfg = _cfg()
    jp = jl.init_params(cfg, jax.random.key(3))
    return cfg, jp


def _layer_of(tree, li=0):
    return {k: ({kk: vv[li] for kk, vv in v.items()} if isinstance(v, dict) else v[li])
            for k, v in tree["layers"].items()}


@pytest.mark.parametrize("ties", [False, True])
def test_router_matches_jax_with_ties(layer, ties):
    """The top-k ids and softmaxed weights equal JAX's: on random logits,
    and on a router whose columns repeat, so logits tie exactly and the
    lower expert id must win, as jax.lax.top_k breaks ties."""
    cfg, jp = layer
    router = np.random.default_rng(10).standard_normal((cfg.hidden_size, cfg.num_experts))
    if ties:
        router[:, 2] = router[:, 0]
        router[:, 3] = router[:, 1]
    router = router.astype(np.float32)
    x = np.random.default_rng(11).standard_normal((6, 5, cfg.hidden_size)).astype(np.float32)
    if ties:
        x[0, 0] = 0.0  # every logit 0: all four experts tie
    jw_, jsel = jl._moe_route(cfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    tw_, tsel = tl._moe_route(cfg, {"router": torch.from_numpy(router)}, torch.from_numpy(x))
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))
    # The logits x @ router sum in another order on each side (f32).
    np.testing.assert_allclose(tw_.numpy(), np.asarray(jw_), rtol=1e-5, atol=1e-6)
    if ties:
        assert tsel[0, 0].tolist() == [0, 1]


@pytest.mark.parametrize("mode", MODES)
def test_moe_layer_matches_jax(layer, mode):
    """One tiny-moe layer in f32: quantized experts through _moe_dense,
    plain ones through _moe_ragged, each against the JAX package's."""
    cfg, jp = layer
    jt = jq.quantize_params(cfg, jp, mode) if mode != "none" else jp
    tt = tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jt), device="cpu")
    jlp = jax.tree.map(lambda a: a[0], jt["layers"])
    tlp = _layer_of(tt)
    x = np.random.default_rng(12).standard_normal((5, 7, cfg.hidden_size)).astype(np.float32)
    jfn = jl._moe_ragged if mode == "none" else jl._moe_dense
    tfn = tl._moe_ragged if mode == "none" else tl._moe_dense
    want = np.asarray(jfn(cfg, jlp, jnp.asarray(x)))
    got = tfn(cfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # The layer takes its route by the weights' form.
    np.testing.assert_allclose(tl._mlp(cfg, tlp, torch.from_numpy(x)).numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_ragged_route_matches_dense_route(layer):
    """Each row through its own top-k experts equals every expert on every
    row combined by routing weight (as the JAX package's own test holds)."""
    cfg, jp = layer
    tlp = _layer_of(tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((5, 7, cfg.hidden_size))
                         .astype(np.float32))
    np.testing.assert_allclose(tl._moe_ragged(cfg, tlp, x).numpy(),
                               tl._moe_dense(cfg, tlp, x).numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jp = jl.init_params(cfg, jax.random.key(0))
    out = {}
    for mode in MODES:
        jt = jq.quantize_params(cfg, jp, mode) if mode != "none" else jp
        out[mode] = (jt, tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jt), device="cpu"))
    return cfg, out


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_greedy_decode_match_jax(models, mode):
    """Prefill logits within the dense tests' tolerance, then 16 greedy
    decode steps (two 8-step blocks) with ids exactly equal."""
    cfg, trees = models
    jp, tp = trees[mode]
    B, S, MAXS, n = 3, 32, 64, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([32, 7, 1], np.int32)
    jlog, jks, jvs = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
    tlog, tks, tvs = tl.prefill(cfg, tp, torch.from_numpy(toks), torch.from_numpy(lens))
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
    for _blk in range(2):
        jlk = jnp.zeros((L, B, n, K, Hd), jnp.float32)
        jlv = jnp.zeros_like(jlk)
        tlk = torch.zeros((L, B, n, K, Hd))
        tlv = torch.zeros_like(tlk)
        jstart, tstart = jpos, tpos
        for step in range(n):
            jlogits, jlk, jlv = jstep(jp, jtok, jpos, jcache, jlk, jlv, jnp.int32(step))
            tlogits, tlk, tlv = tl.decode_step_windowed(cfg, tp, ttok, tpos, tcache, tlk, tlv,
                                                        step)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=LOGIT_ATOL, rtol=0)
            jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
            ttok = torch.argmax(tlogits, -1)
            jids.append(np.asarray(jtok))
            tids.append(ttok.numpy())
            jpos, tpos = jpos + 1, tpos + 1
        jcache = jl.write_block_to_cache(jcache, jlk, jlv, jstart)
        tl.write_block_to_cache(tcache, tlk, tlv, tstart)
    assert np.array_equal(np.stack(tids), np.stack(jids)) and len(tids) == 16


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
        assert sum(e.kind == "token" for e in evs) == 12
        out.append([e.token_id for e in evs if e.kind == "token"])
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_greedy_ids_match_jax_engine(models, mode, paged):
    """The port's Engine (dense cache, or a paged pool with chunked prefill)
    gives the JAX Engine's greedy ids; each engine quantizes where its
    weights lie."""
    cfg, trees = models
    jp, tp = trees["none"]
    quantization = "" if mode == "none" else mode
    kw = dict(BASE, **(PAGED if paged else {}))
    jeng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size), quantization=quantization,
                     engine_cfg=JaxEngineConfig(prefix_cache_entries=0, **kw))
    teng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), device="cpu",
                  quantization=quantization,
                  engine_cfg=EngineConfig(prefix_cache_entries=0, **kw))
    try:
        assert _greedy(teng, GenRequest) == _greedy(jeng, JaxGenRequest)
        m = teng.metrics()
        if paged:
            assert m["chunked_admits"] == 2 and m["kv_pages_free"] == PAGED["kv_pages"]
        # The expert stacks count in the weight bytes.
        layers = teng.params["layers"]
        experts = sum(t.numel() * t.element_size() for k in ("w_gate", "w_up", "w_down")
                      for t in (layers[k].values() if isinstance(layers[k], dict)
                                else [layers[k]]))
        assert m["weight_bytes"] > experts > 0
    finally:
        jeng.stop()
        teng.stop()


def test_register_adapter_refused_on_moe_base(models):
    cfg, trees = models
    eng = Engine(cfg, trees["none"][1], ByteTokenizer(cfg.vocab_size), device="cpu",
                 engine_cfg=EngineConfig(**BASE))
    try:
        with pytest.raises(AdapterError, match="MoE"):
            eng.register_adapter("t0", "/nonexistent")
        assert eng.adapter_names() == []
    finally:
        eng.stop()


@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
def test_hf_checkpoint_loads_like_the_jax_loader(models, tmp_path, quantize):
    """The JAX package's save_hf_checkpoint of a tiny-moe tree (router and
    per-expert w1 / w3 / w2 tensors), read by the port's loader, equals the
    bridge of the JAX loader's tree: unquantized, and quantized on load."""
    cfg, trees = models
    jw.save_hf_checkpoint(cfg, trees["none"][0], str(tmp_path))
    arch = tw.arch_from_hf_config(str(tmp_path))
    assert dataclasses.asdict(arch) == dataclasses.asdict(jw.arch_from_hf_config(str(tmp_path)))
    assert arch.num_experts == cfg.num_experts and arch.is_moe
    arch = dataclasses.replace(arch, dtype="float32")
    got = tw.load_hf_checkpoint(arch, str(tmp_path), device="cpu", quantize=quantize)
    want = tw.params_from_numpy(arch, jax.tree.map(
        np.asarray, jw.load_hf_checkpoint(arch, str(tmp_path), quantize=quantize)),
        device="cpu")
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert tuple(got["layers"]["router"].shape) == (cfg.num_layers, cfg.hidden_size,
                                                    cfg.num_experts)
    if quantize:
        assert tq.is_quantized(got["layers"]["w_down"])


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["tiny-moe", "tiny"])
def test_quantized_init_tree_equals_quantize_params_tree(arch, mode):
    """init_params_quantized gives quantize_params(init_params(cfg))'s tree:
    the same keys, shapes and dtypes, leaf for leaf, and is seeded."""
    cfg = dataclasses.replace(get_arch(arch), dtype="bfloat16")
    want = tq.quantize_params(cfg, tl.init_params(cfg, seed=0, device="cpu"), mode)
    got = tq.init_params_quantized(cfg, seed=0, mode=mode, device="cpu")
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    again = tq.init_params_quantized(cfg, seed=0, mode=mode, device="cpu")
    key = "q" if mode == "int8" else "g4"
    assert torch.equal(got["layers"]["w_up"][key], again["layers"]["w_up"][key])
    assert tq.is_prequantized(got)


def test_unported_moe_families_raise():
    """The deepseek router, shared experts and a dense-layer prefix, each on
    tiny-moe, are ported: each builds the JAX package's tree (keys and
    shapes) and its prefill logits match the JAX package's."""
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 5], np.int32)
    for kw in ({"moe_family": "deepseek"}, {"n_shared_experts": 1}, {"first_k_dense": 1}):
        cfg = _cfg(**kw)
        jp = jl.init_params(cfg, jax.random.key(0))
        tp = tl.init_params(cfg, device="cpu")
        want = jax.tree_util.tree_flatten_with_path(jp)[0]
        got = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in got] == \
            [(jax.tree_util.keystr(p), v.shape) for p, v in want], kw
        bridged = tw.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        jlog, _, _ = jl.prefill(cfg, jp, jnp.asarray(toks), jnp.asarray(lens))
        tlog, _, _ = tl.prefill(cfg, bridged, torch.from_numpy(toks), torch.from_numpy(lens))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    # A tree whose layers lack a router does not serve a MoE config.
    cfg = _cfg()
    dense = tl.init_params(dataclasses.replace(cfg, num_experts=0), device="cpu")
    with pytest.raises(ValueError, match="router"):
        tl.prefill(cfg, dense, torch.zeros((1, 4), dtype=torch.long), torch.tensor([4]))


def test_server_serves_a_mixtral_checkpoint_like_the_jax_server(models, tmp_path):
    """`python -m localai_tpu_torch run`'s server on a tiny-moe HF checkpoint
    (quantized to int4 on load) answers a greedy completion with the JAX
    server's bytes and usage."""
    import json as _json
    import urllib.request

    import yaml

    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from test_torch_server import _serve

    cfg, trees = models
    jw.save_hf_checkpoint(cfg, trees["none"][0], str(tmp_path / "ckpt"))
    (tmp_path / "moe.yaml").write_text(yaml.safe_dump(
        {"name": "moe", "model": "ckpt", "context_size": 128, "max_slots": 2,
         "max_tokens": 8, "temperature": 0.0, "quantization": "int4"}))
    jm = JaxModelManager(JaxAppConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path)))
    jr = JaxRouter()
    JaxOpenAIApi(jm).register(jr)
    js = jax_create_server(JaxAppConfig(address="127.0.0.1", port=0,
                                        models_dir=str(tmp_path)), jr)
    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(tmp_path))
    tm = ModelManager(app, device="cpu")
    tr = Router()
    OpenAIApi(tm).register(tr)
    ts = create_server(app, tr)
    try:
        out = {}
        for name, base in (("jax", _serve(js)), ("port", _serve(ts))):
            req = urllib.request.Request(
                base + "/v1/completions", method="POST",
                headers={"Content-Type": "application/json"},
                data=_json.dumps({"model": "moe", "prompt": "Mixture of", "max_tokens": 8,
                                  "temperature": 0.0, "ignore_eos": True}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                body = _json.loads(r.read())
            out[name] = (body["choices"][0]["text"], body["usage"])
        assert out["port"] == out["jax"]
        assert out["port"][1]["completion_tokens"] == 8
    finally:
        for s in (js, ts):
            s.shutdown()
        jm.shutdown()
        tm.shutdown()
