"""The port's weight quantization against the JAX package on the CPU: the
quantizers (bit for bit), the plain versions of the fused kernels B3 / B4
against the JAX package's Pallas kernels in interpret mode, the
dequantize-then-matmul route against the JAX XLA forms, the quantized
param tree, and the dispatch split by row count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.models import llama as jl
from localai_tpu.models import quant as jq
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import quant as tq
from localai_tpu_torch.ops import quant_matmul as tqm

# f32 on both sides: the plain versions and the Pallas kernels dequantize
# and multiply in f32 and differ in summation order only.
PLAIN_TOL = 1e-5
# The dequant route folds the group scale into the weight where the XLA
# form scales the group partial sums: f32 rounding only.
DEQUANT_TOL = 1e-5


def _jgrouped_int8(w, group=32):
    """Group-wise symmetric int8, as the JAX package's own tests build it."""
    g = w.shape[0] // group
    wg = w.reshape(g, group, w.shape[1])
    s = jnp.maximum(jnp.max(jnp.abs(wg), axis=1, keepdims=True) / 127.0, 1e-9)
    return {"gq": jnp.clip(jnp.round(wg / s), -127, 127).astype(jnp.int8), "gs": s}


def _jquantized(form, w):
    w = jnp.asarray(w)
    if form == "int8":
        return jq.quantize_tensor(w)
    if form == "grouped_int8":
        return _jgrouped_int8(w)
    return jq.quantize_tensor_g4(w)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _weight(seed, n_in, n_out):
    return (np.random.default_rng(seed).standard_normal((n_in, n_out)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 96, 80), (64, 96)])
def test_quantizers_bit_identical_to_jax(shape):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05).astype(np.float32)
    w.flat[5] = 0.0  # a constant group column must not divide by zero
    # The JAX package runs its device quantizers under jit only (Engine,
    # init_params_quantized), where XLA folds "/ 127" and "/ 15" into
    # products: the port gives that result.
    pairs = (
        (jax.jit(jq.quantize_tensor)(w), tq.quantize_tensor(torch.from_numpy(w))),
        (jax.jit(jq.quantize_tensor_g4)(w), tq.quantize_tensor_g4(torch.from_numpy(w))),
        (jq.quantize_tensor_np(w), tq.quantize_tensor_np(w)),
        (jq.quantize_tensor_np(w, axis=-1), tq.quantize_tensor_np(w, axis=-1)),
        (jq.quantize_tensor_np_g4(w), tq.quantize_tensor_np_g4(w)),
    )
    for want, got in pairs:
        assert sorted(want) == sorted(got)
        for k in want:
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            assert g.dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(g, np.asarray(want[k])), k
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize_tensor_g4(torch.zeros(40, 8))


@pytest.mark.parametrize("rows", [1, 5, 256])
@pytest.mark.parametrize("shape", [(64, 96), (96, 80)])
@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
def test_qmm_plain_matches_pallas_kernel(form, shape, rows):
    w = _weight(1, *shape)
    x = np.random.default_rng(2).standard_normal((rows, shape[0])).astype(np.float32)
    jw = _jquantized(form, w)
    want = np.asarray(jq.matmul(jnp.asarray(x), jw, impl="pallas"))
    got = tqm.qmm_plain(torch.from_numpy(x), _t(jw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PLAIN_TOL, rtol=PLAIN_TOL)


@pytest.mark.parametrize("form", ["int8", "grouped_int8", "int4"])
def test_dequant_route_matches_jax_xla_form(form):
    """More than 256 rows take the dequantize-then-matmul form, held against
    the JAX package's XLA form; no kernel (or plain version) is involved."""
    w = _weight(3, 96, 80)
    x = np.random.default_rng(4).standard_normal((2, 150, 96)).astype(np.float32)  # 300 rows
    jw = _jquantized(form, w)
    want = np.asarray(jq.matmul(jnp.asarray(x), jw, impl="xla"))
    before = tq.matmul.dequant_calls, tqm.qmm.launches
    got = tq.matmul(torch.from_numpy(x), _t(jw))
    assert (tq.matmul.dequant_calls, tqm.qmm.launches) == (before[0] + 1, before[1])
    assert got.shape == (2, 150, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=DEQUANT_TOL, rtol=DEQUANT_TOL)


@pytest.mark.parametrize("rows", [1, 5, 256, 300])
def test_unembed_matches_jax(rows):
    """≤ 256 rows: qunembed_plain against the Pallas kernel; more: the
    dequant form against the XLA form."""
    V, D = 200, 64
    head = (np.random.default_rng(5).standard_normal((V, D)) * 0.1).astype(np.float32)
    qw = tq.quantize_tensor_np(head, axis=-1)
    assert qw["s"].shape == (V, 1)
    h = np.random.default_rng(6).standard_normal((rows, D)).astype(np.float32)
    impl = "pallas" if rows <= 256 else "xla"
    want = np.asarray(jq.unembed_matmul(jnp.asarray(h), jax.tree.map(jnp.asarray, qw),
                                        impl=impl))
    before = tq.unembed_matmul.dequant_calls
    got = tq.unembed_matmul(torch.from_numpy(h), _t(qw))
    assert tq.unembed_matmul.dequant_calls == before + (rows > 256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PLAIN_TOL, rtol=PLAIN_TOL)
    if rows <= 256:
        assert torch.equal(got, tqm.qunembed_plain(torch.from_numpy(h), _t(qw)))


def test_dispatch_splits_by_rows_and_dtype():
    """≤ 256 float rows go to the kernel's wrapper (its plain version on the
    CPU, no launch counted); more rows, or integer x, do not."""
    w = _t(jq.quantize_tensor(jnp.asarray(_weight(7, 64, 32))))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 64, 64)).astype(np.float32))
    launches = tqm.qmm.launches
    assert torch.equal(tqm.dispatch_matmul(x, w), tqm.qmm_plain(x.reshape(256, 64), w)
                       .reshape(4, 64, 32))
    assert tqm.dispatch_matmul(torch.cat([x, x[:1]]), w) is None  # 320 rows
    assert tqm.dispatch_matmul(x.to(torch.int32), w) is None
    assert tqm.dispatch_matmul(x[:0], w) is None
    stacked = {k: v[None] for k, v in w.items()}  # an expert axis: the MoE form
    assert tqm.dispatch_matmul(x[0], stacked) is None
    # The MoE dispatch serves the stacked form: its plain version on the CPU.
    assert torch.equal(tqm.dispatch_moe_mm(x, stacked, "...d,edf->...ef"),
                       tqm.qmm_moe_plain(x.reshape(256, 64), stacked, "...d,edf->...ef")
                       .reshape(4, 64, 1, 32))
    assert tqm.qmm.launches == launches  # the CPU never launches
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.qmm(x[0].to("meta"), w)


def _tiny(**kw):
    return dataclasses.replace(get_arch("tiny"), dtype="float32", **kw)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_jax_tree(mode):
    cfg = _tiny()
    jp = jl.init_params(cfg, jax.random.key(0))
    want = jax.jit(lambda p: jq.quantize_params(cfg, p, mode))(jp)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    got = tq.quantize_params(cfg, tp, mode)
    assert tq.is_prequantized(got) and not tq.is_prequantized(tp)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == getattr(torch, str(np.asarray(leaf).dtype)), path
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    assert tq.is_quantized(got["lm_head"]) and got["lm_head"]["s"].shape == (cfg.vocab_size, 1)
    assert tq.is_grouped(got["layers"]["wq"]) == (mode == "int4")
    # dequantize_tensor inverts up to the quantization step.
    w = tp["layers"]["w_up"]
    assert (tq.dequantize_tensor(got["layers"]["w_up"]) - w).abs().max() < 0.1 * w.abs().max()
    # A tied head stays in the model dtype; unknown modes raise.
    tied = tq.quantize_params(_tiny(tie_embeddings=True), {"layers": {}, "embed": w}, mode)
    assert "lm_head" not in tied
    assert tq.quantize_params(cfg, tp, "") is tp
    with pytest.raises(ValueError, match="unsupported"):
        tq.quantize_params(cfg, tp, "int3")


def test_params_from_numpy_keeps_int_payloads_and_f32_scales():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="bfloat16")
    jp = jq.quantize_params(cfg, jl.init_params(cfg, jax.random.key(1)), "int4")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    g4 = tp["layers"]["w_gate"]
    assert g4["g4"].dtype == torch.uint8 and g4["gs"].dtype == torch.float32
    assert g4["gz"].dtype == torch.float32
    assert tp["lm_head"]["q"].dtype == torch.int8 and tp["lm_head"]["s"].dtype == torch.float32
    assert tp["embed"].dtype == torch.bfloat16 and tp["layers"]["attn_norm"].dtype == torch.bfloat16
    assert np.array_equal(g4["g4"].numpy(), np.asarray(jp["layers"]["w_gate"]["g4"]))
