"""The llava-style vision path of the PyTorch port against the JAX package
on the CPU: the tower on the same pixels (f32, 1e-5), its HF checkpoint
written by either package and read by the other, the resize (torch's
antialiased bilinear / bicubic against PIL, the gap stated), prefill and
greedy ids with the image features injected, the PNG decoder the server
falls back to without PIL, and /v1/chat/completions with a PNG data URI on
a `llava` model against the JAX server (content bytes and usage equal).
No module of the port imports PIL at its top level."""

import ast
import base64
import builtins
import dataclasses
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from localai_tpu.engine.weights import save_hf_checkpoint
from localai_tpu.models import get_arch
from localai_tpu.models import llama as jl
from localai_tpu.models import vision as JV
from localai_tpu_torch.engine.weights import params_from_numpy
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models import vision as TV
from localai_tpu_torch.server import images as IM

from test_torch_qwen2_vl import _png_uri, chat_both

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tower():
    """vit-test (2 layers, select_layer -1) and a 3-layer tower that picks
    the penultimate layer, as llava does: the JAX package's draws, carried
    across."""
    out = {}
    rng = np.random.default_rng(0)
    for name, vcfg in (("vit-test", JV.VISION_PRESETS["vit-test"]),
                       ("penultimate", dataclasses.replace(
                           JV.VISION_PRESETS["vit-test"], name="vit-3", layers=3,
                           select_layer=-2))):
        tc = TV.VisionConfig(**dataclasses.asdict(vcfg))
        # Every leaf drawn with numpy (norm weights and biases too), in the
        # tree the port's init builds; the JAX loader's tree is held to it.
        tree = jax.tree.map(lambda t: (rng.standard_normal(t.shape) * 0.1).astype(np.float32),
                            TV.init_params(tc, device="cpu"))
        out[name] = (vcfg, tc, jax.tree.map(jnp.asarray, tree),
                     TV.vision_params_from_numpy(tree, device="cpu"))
    return out


def _pixels(seed, n=2, s=16):
    return np.random.default_rng(seed).random((n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["vit-test", "penultimate"])
def test_encode_image_matches_jax(tower, name):
    jc, tc, jp, tp = tower[name]
    x = _pixels(1)
    want = np.asarray(jax.jit(lambda p, v: JV.encode_image(jc, p, v))(jp, jnp.asarray(x)))
    got = TV.encode_image(tc, tp, torch.from_numpy(x))
    assert got.shape == want.shape == (2, jc.n_patches, jc.llm_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _assert_trees_equal(got, want):
    got, want = jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_hf_checkpoint_both_ways(tower, tmp_path):
    """Each package reads the tower the other wrote (every tensor equal),
    and the port's writer merges into an existing model.safetensors."""
    from safetensors.numpy import load_file

    from localai_tpu_torch.engine.weights import write_safetensors_f32

    jc, tc, jp, tp = tower["penultimate"]
    JV.save_hf_vision(jc, jp, str(tmp_path / "jax"))
    assert TV.vision_config_from_hf(str(tmp_path / "jax")) == tc
    _assert_trees_equal(TV.load_hf_vision(tc, str(tmp_path / "jax"), device="cpu"), jp)
    (tmp_path / "port").mkdir()
    other = np.arange(6, dtype=np.float32).reshape(2, 3)
    write_safetensors_f32(str(tmp_path / "port" / "model.safetensors"), {"model.x": other})
    TV.save_hf_vision(tc, tp, str(tmp_path / "port"))
    assert JV.vision_config_from_hf(str(tmp_path / "port")) == jc
    _assert_trees_equal(JV.load_hf_vision(jc, str(tmp_path / "port")), jp)
    np.testing.assert_array_equal(load_file(str(tmp_path / "port" / "model.safetensors"))
                                  ["model.x"], other)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_resize_against_pil(mode):
    """The gap to PIL: torch's antialiased resize, width pass then height
    pass, each rounded to uint8, is within 2 levels of PIL's 8-bit resize
    on noise, down and up (measured here: bicubic at most 1, on < 0.1 % of
    the values; bilinear at most 2, on ~2 %)."""
    pil = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[mode]
    rng = np.random.default_rng(0)
    worst = 0
    for (H, W), (h, w) in (((37, 21), (40, 24)), ((400, 280), (336, 336)), ((90, 300), (336, 336)),
                           ((24, 16), (32, 16))):
        img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((w, h), pil)).astype(int)
        got = TV.resize_uint8(img, h, w, mode).astype(int)
        worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= (1 if mode == "bicubic" else 2), worst
    same = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    assert (TV.resize_uint8(same, 16, 16, mode) == same).all()


def test_encoder_resizes_then_encodes_as_jax(tower):
    """VisionEncoder.encode on an image of another size: the resize gap
    above moves the features by < 0.05 here; on an image at the tower's
    size they agree within 1e-5."""
    jc, tc, jp, tp = tower["vit-test"]
    rng = np.random.default_rng(3)
    jenc, tenc = JV.VisionEncoder(jc, jp), TV.VisionEncoder(tc, tp)
    exact = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(tenc.encode(exact).numpy(), jenc.encode(exact), atol=1e-5, rtol=0)
    other = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    gap = float(np.abs(tenc.encode(other).numpy() - jenc.encode(other)).max())
    assert gap < 0.05, gap


def test_prefill_with_injection_matches_jax(tower):
    """llava's injection (no m-rope) on `tiny` f32: prefill logits within
    1e-4. (The engine's ids with an image in the batch are held to the JAX
    engine's in tests/test_torch_qwen2_vl.py, and the served bytes below.)"""
    jc, tc, jp, tp = tower["vit-test"]
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jparams = jl.init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    feats = TV.encode_image(tc, tp, torch.from_numpy(_pixels(4, n=1)))[0].numpy()
    prompt = [65] + [0] * feats.shape[0] + [66, 67, 68]
    toks = np.zeros((2, 16), np.int32)
    toks[:, :len(prompt)] = prompt
    lens, offsets = [len(prompt), len(prompt) - 2], [1, 3]
    want, wk, _ = jax.jit(lambda p, t, n, e, o: jl.prefill(cfg, p, t, n, inject=(e, o)))(
        jparams, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(np.stack([feats] * 2)),
        jnp.asarray(offsets))
    got, gk, _ = tl.prefill(cfg, tparams, torch.from_numpy(toks).long(), torch.tensor(lens),
                            inject=(torch.tensor(np.stack([feats] * 2)), torch.tensor(offsets)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for b, n in enumerate(lens):  # the rows each slot keeps
        np.testing.assert_allclose(gk[:, b, :n].numpy(), np.asarray(wk)[:, b, :n], atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decoder_matches_pil(mode):
    rng = np.random.default_rng(5)
    if mode == "P":
        img = Image.fromarray((rng.random((20, 22, 3)) * 255).astype(np.uint8)).quantize(200)
    else:
        ch = {"RGB": 3, "RGBA": 4, "L": 0, "LA": 2}[mode]
        img = Image.fromarray((rng.random((13, 17, ch) if ch else (13, 17)) * 255)
                              .astype(np.uint8), mode)
    for level in (0, 9):  # no filters; PIL's adaptive filters
        buf = io.BytesIO()
        img.save(buf, format="PNG", compress_level=level)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        got = IM.decode_png(buf.getvalue())
        assert got.shape == want.shape and (got == want).all()


def test_images_without_pil(monkeypatch):
    """Without PIL a PNG still decodes, any other format is a decode error
    naming PIL, and a PNG that does not decode is skipped."""
    rng = np.random.default_rng(6)
    img = (rng.random((9, 7, 3)) * 255).astype(np.uint8)
    jpeg = io.BytesIO()
    Image.fromarray(img).save(jpeg, format="JPEG")
    good = _png_uri(img)
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)

    def msg(*urls):
        return [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": u}}
                                             for u in urls]}]

    broken = "data:image/png;base64," + base64.b64encode(b"\x89PNG\r\n\x1a\nxx").decode()
    out = IM.extract_images(msg(broken, "https://example.invalid/x.png", good))
    assert len(out) == 1 and (out[0] == img).all()
    with pytest.raises(IM.ImageDecodeError, match="PIL"):
        IM.extract_images(msg("data:image/jpeg;base64,"
                              + base64.b64encode(jpeg.getvalue()).decode()))


def test_no_port_module_imports_pil_at_top_level():
    bad = []
    for path in sorted((ROOT / "localai_tpu_torch").rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(str(path), n) for n in names if n.split(".")[0] in ("PIL", "torchvision")]
    assert not bad, bad


def test_llava_chat_matches_jax_server(tower, tmp_path):
    """A `llava` model (tiny f32 + the vit-test tower, both written by the
    JAX package into one checkpoint): a text + PNG chat and the chat
    without the image give the JAX server's content bytes and usage."""
    jc, _tc, jp, _tp = tower["vit-test"]
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(tmp_path / "ckpt"))
    JV.save_hf_vision(jc, jp, str(tmp_path / "ckpt"))
    common = {"model": "ckpt", "context_size": 256, "max_slots": 2, "max_tokens": 6,
              "temperature": 0.0}
    (tmp_path / "lv.yaml").write_text(yaml.safe_dump({"name": "lv", "backend": "llava",
                                                      **common}))
    img = (np.random.default_rng(7).random((20, 30, 3)) * 255).astype(np.uint8)
    payloads = [{"messages": [{"role": "user", "content": [
        {"type": "text", "text": "describe"},
        {"type": "image_url", "image_url": {"url": _png_uri(img)}}]}]},
        {"messages": [{"role": "user", "content": "describe"}]}]
    out, _ = chat_both(str(tmp_path), "lv", payloads)
    for (js, jb), (ps, pb) in out:
        assert js == ps == 200, (jb, pb)
        assert pb["choices"][0]["message"] == jb["choices"][0]["message"]
        assert pb["usage"] == jb["usage"]
    span = out[0][1][1]["usage"]["prompt_tokens"] - out[1][1][1]["usage"]["prompt_tokens"]
    assert span == jc.n_patches, span  # the image's 4 patch tokens
