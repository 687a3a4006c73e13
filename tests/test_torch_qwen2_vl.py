"""Qwen2-VL in the PyTorch port against the JAX package on the CPU, on one
tiny checkpoint that transformers writes in its own (nested) layout: the
m-rope position streams and angles, the preprocessing (the port's torch
resize against the JAX package's PIL one, with the gap stated), the
tower on the same patches (f32, 1e-5), the checkpoint read through both
name spellings, prefill with the image injected and m-rope (logits within
1e-4), greedy ids of the engine on the dense cache, on a paged pool whose
chunk size would chunk the image prompt, and under swap preemption; the
prefix cache never serving one image's rows to another; the validation
errors and the speculative refusal; and /v1/chat/completions with a PNG
data URI against the JAX server (content bytes and usage equal)."""

import base64
import dataclasses
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.engine import weights as jw
from localai_tpu.models import llama as jl
from localai_tpu.models import qwen2_vl as JQ
from localai_tpu.ops import rope as jrope
from localai_tpu_torch.engine import weights as tw
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.models import llama as tl
from localai_tpu_torch.models import qwen2_vl as TQ
from localai_tpu_torch.ops import rope as trope

# The JAX package's test geometry (tests/test_qwen2_vl.py).
VOCAB = 300
HIDDEN, LAYERS, HEADS, KV_HEADS, INTER = 64, 2, 4, 2, 128
V_DEPTH, V_DIM, V_HEADS, V_PATCH = 2, 32, 2, 4
MROPE = [2, 3, 3]  # sums to head_dim / 2 = 8
IMG_TOKEN, VSTART, VEND = 299, 297, 298


TINY_HF = {
    "model_type": "qwen2_vl", "architectures": ["Qwen2VLForConditionalGeneration"],
    "vocab_size": VOCAB, "hidden_size": HIDDEN, "intermediate_size": INTER,
    "num_hidden_layers": LAYERS, "num_attention_heads": HEADS, "num_key_value_heads": KV_HEADS,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "rope_scaling": {"type": "mrope", "mrope_section": MROPE},
    "image_token_id": IMG_TOKEN, "vision_start_token_id": VSTART, "vision_end_token_id": VEND,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "vision_config": {"depth": V_DEPTH, "embed_dim": V_DIM, "num_heads": V_HEADS, "mlp_ratio": 2,
                      "in_channels": 3, "patch_size": V_PATCH, "spatial_merge_size": 2,
                      "temporal_patch_size": 2, "hidden_size": HIDDEN},
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny model in Qwen2VLForConditionalGeneration's published layout,
    seeded random f32 tensors (written by the port; transformers' import
    alone takes ~20 s here, so the JAX package's own tests hold the layout
    to transformers')."""
    d = tmp_path_factory.mktemp("tiny-qwen2vl")
    TQ.random_hf_checkpoint(str(d), TINY_HF, seed=0, scale=0.1, device="cpu")
    return str(d)


def _vcfg(mod, ckpt_dir):
    # A pixel budget that leaves the test images' sizes as they are.
    return dataclasses.replace(mod.vision_config_from_hf(ckpt_dir), min_pixels=8 * 8,
                               max_pixels=1 << 28)


@pytest.fixture(scope="module")
def sides(ckpt):
    """Both packages' decoders (f32) and towers read from the checkpoint."""
    jarch = dataclasses.replace(jw.arch_from_hf_config(ckpt), dtype="float32")
    tarch = dataclasses.replace(tw.arch_from_hf_config(ckpt), dtype="float32")
    jvc, tvc = _vcfg(JQ, ckpt), _vcfg(TQ, ckpt)
    return {
        "jarch": jarch, "jparams": jw.load_hf_checkpoint(jarch, ckpt),
        "tarch": tarch, "tparams": tw.load_hf_checkpoint(tarch, ckpt, device="cpu"),
        "jvc": jvc, "jv": JQ.load_hf_qwen2_vl_vision(jvc, ckpt),
        "tvc": tvc, "tv": TQ.load_hf_qwen2_vl_vision(tvc, ckpt, device="cpu"),
    }


def _image(h=24, w=16, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _jax_feats(s, patches, grid):
    fn = s.setdefault("jfwd", jax.jit(lambda p, x, a: JQ.vision_forward(s["jvc"], p, x, a)))
    return np.asarray(fn(s["jv"], jnp.asarray(patches),
                         jnp.asarray(JQ._vision_rope_angles(s["jvc"], grid))))


def _prompt(grid, post=(VEND, 11, 12, 13)):
    n_img = grid[0] * (grid[1] // 2) * (grid[2] // 2)
    pre = [5, 7, VSTART]
    return pre + [0] * n_img + list(post), len(pre)


@pytest.mark.parametrize("total, offset, grid", [
    (20, 3, (1, 6, 4)), (40, 0, (1, 4, 12)), (20, 1, (1, 8, 8)), (9, 2, (2, 4, 2))])
def test_mrope_positions_and_angles_match_jax(total, offset, grid):
    want, wd = JQ.mrope_positions_for_span(total, offset, grid)
    got, gd = TQ.mrope_positions_for_span(total, offset, grid)
    np.testing.assert_array_equal(got, want)
    assert gd == wd and got.dtype == np.int32
    inv = np.random.default_rng(total).random(8).astype(np.float32)
    pos3 = np.stack([got, got[::-1, ::-1]])  # two rows
    ja = np.asarray(jrope.mrope_angles(jnp.asarray(pos3), jnp.asarray(inv), tuple(MROPE)))
    ta = trope.mrope_angles(torch.from_numpy(pos3), torch.from_numpy(inv), tuple(MROPE))
    np.testing.assert_array_equal(ta.numpy(), ja)
    with pytest.raises(ValueError, match="do not sum"):
        trope.mrope_angles(torch.from_numpy(pos3), torch.from_numpy(inv), (2, 3, 2))


def test_preprocess_against_jax_pil_and_the_tower_on_the_same_patches(sides):
    """smart_resize and the grids are exact. The resize (torch's
    antialiased bicubic, width pass then height pass, each rounded to
    uint8, against PIL's BICUBIC) differs by at most one uint8 level here
    (tests/test_torch_vision.py holds the resize itself to PIL), so the
    patches agree within 1 / 255 / std; where no resize runs they are
    equal. Fed the same patches, the towers agree within 1e-5."""
    jvc, tvc = sides["jvc"], sides["tvc"]
    for h, w in ((5, 7), (1000, 700), (28, 2000), (300, 90)):
        for budget in ((56 * 56, 28 * 28 * 1280), (8 * 8, 1 << 28)):
            assert TQ.smart_resize(h, w, 28, *budget) == JQ.smart_resize(h, w, 28, *budget)
    worst = 0.0
    for (h, w), seed in (((24, 16), 0), ((37, 21), 1), ((90, 61), 2)):
        img = _image(h, w, seed)
        jp, jg = JQ.preprocess(jvc, img)
        tp, tg = TQ.preprocess(tvc, img)
        assert tg == jg and tp.shape == jp.shape
        gap = float(np.abs(tp - jp).max())
        if (h, w) == (24, 16):  # already a multiple of 8: no resize on either side
            assert gap < 1e-6, gap
        worst = max(worst, gap)
        feats = _jax_feats(sides, tp, tg)
        got = TQ.Qwen2VLVisionEncoder(tvc, sides["tv"]).encode_patches(tp, tg)
        assert got.shape == feats.shape == (tg[1] * tg[2] // 4, HIDDEN)
        np.testing.assert_allclose(got.numpy(), feats, atol=1e-5, rtol=0)
    assert worst <= 1 / 255 / min(TQ.IMAGE_STD) + 1e-6, worst


def test_checkpoint_reads_both_spellings_and_carries_the_jax_tree(sides, ckpt, tmp_path):
    """A copy of the checkpoint under the nested names transformers' model
    classes use (model.language_model.*, model.visual.*) loads the same
    decoder and tower through the shard reader's aliases as the published
    spelling does. The JAX package's tower tree carries across leaf for
    leaf, bf16 too."""
    import shutil

    from safetensors.numpy import load_file, save_file

    def nested(name):
        if name.startswith("visual."):
            return "model." + name
        if name.startswith("model."):
            return "model.language_model." + name[len("model."):]
        return name

    src = load_file(f"{ckpt}/model.safetensors")
    assert "visual.blocks.0.attn.qkv.weight" in src and "model.norm.weight" in src
    save_file({nested(k): v for k, v in src.items()}, str(tmp_path / "model.safetensors"))
    shutil.copy(f"{ckpt}/config.json", tmp_path / "config.json")
    reader = tw._ShardReader(str(tmp_path))
    assert "model.language_model.norm.weight" in reader and "model.norm.weight" in reader
    tarch = sides["tarch"]
    nested_params = tw.load_hf_checkpoint(tarch, str(tmp_path), device="cpu")
    nested_tower = TQ.load_hf_qwen2_vl_vision(sides["tvc"], str(tmp_path), device="cpu")
    assert all(torch.equal(nested_tower[k], v) for k, v in sides["tv"].items())
    assert all(torch.equal(nested_params["layers"][k], v)
               for k, v in sides["tparams"]["layers"].items())
    assert torch.equal(nested_params["embed"], sides["tparams"]["embed"])
    for k, v in sides["jv"].items():
        assert torch.equal(sides["tv"][k], torch.from_numpy(np.array(v))), k
    carried = TQ.qwen2_vl_vision_params_from_numpy(
        {k: np.asarray(v) for k, v in sides["jv"].items()}, device="cpu")
    assert all(torch.equal(carried[k], sides["tv"][k]) for k in carried)
    jb = {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in sides["jv"].items()}
    cb = TQ.qwen2_vl_vision_params_from_numpy(jb, device="cpu")
    k0 = "blocks.0.attn.qkv.weight"
    assert cb[k0].dtype == torch.bfloat16
    assert torch.equal(cb[k0].float(), torch.from_numpy(jb[k0].astype(np.float32)))
    for k, v in sides["jparams"]["layers"].items():
        np.testing.assert_array_equal(sides["tparams"]["layers"][k].numpy(), np.asarray(v))
    assert TQ.is_qwen2_vl_dir(ckpt) and not TQ.is_qwen2_vl_dir(str(tmp_path / "none"))


def _image_request(sides, seed, h=24, w=16, post=(VEND, 11, 12, 13)):
    patches, grid = TQ.preprocess(sides["tvc"], _image(h, w, seed))
    feats = _jax_feats(sides, patches, grid)
    ids, offset = _prompt(grid, post)
    pos3, delta = TQ.mrope_positions_for_span(len(ids), offset, grid)
    return ids, offset, feats, pos3, delta


def test_prefill_with_image_and_mrope_matches_jax(sides):
    ids, offset, feats, pos3, _ = _image_request(sides, 2)
    S = 32
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(ids)] = ids
    mrope = np.zeros((1, 3, S), np.int32)
    mrope[0, :, :len(ids)] = pos3
    want, wk, _ = jl.prefill(sides["jarch"], sides["jparams"], jnp.asarray(toks),
                             jnp.asarray([len(ids)], jnp.int32),
                             inject=(jnp.asarray(feats[None]), jnp.asarray([offset], jnp.int32)),
                             mrope=jnp.asarray(mrope))
    got, gk, _ = tl.prefill(sides["tarch"], sides["tparams"], torch.from_numpy(toks).long(),
                            torch.tensor([len(ids)]),
                            inject=(torch.from_numpy(feats[None].copy()), torch.tensor([offset])),
                            mrope=torch.from_numpy(mrope).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gk[:, 0, :len(ids)].numpy(), np.asarray(wk)[:, 0, :len(ids)],
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="mrope positions passed but cfg.mrope_section empty"):
        tl.prefill(dataclasses.replace(sides["tarch"], mrope_section=()), sides["tparams"],
                   torch.from_numpy(toks).long(), torch.tensor([len(ids)]),
                   mrope=torch.from_numpy(mrope).long())


N_NEW = 10


def _greedy(eng_cls, req_cls, arch, params, requests, fork=False, **ecfg):
    kw = dict(max_slots=2, max_seq=128, min_prefill_bucket=16, block_sizes=(4,))
    kw.update(ecfg)
    extra = {"device": "cpu"} if eng_cls is Engine else {}
    eng = eng_cls(arch, params, (ByteTokenizer if eng_cls is Engine else JaxByteTokenizer)(VOCAB),
                  engine_cfg=(EngineConfig if eng_cls is Engine else JaxEngineConfig)(**kw),
                  **extra)
    eng.start()
    try:
        reqs = [req_cls(max_new_tokens=N_NEW, ignore_eos=True, **r) for r in requests]
        handles = eng.submit_fork(reqs) if fork else [eng.submit(r) for r in reqs]
        out = []
        for h in handles:
            evs = list(h)
            assert evs[-1].kind == "done", evs[-1]
            out.append([e.token_id for e in evs if e.kind == "token"])
        return out, eng.metrics()
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_ids(sides):
    """The JAX engine's greedy ids (dense) for an image request, a second
    image request and a text one, each alone."""
    reqs = []
    for seed, (h, w) in ((3, (48, 32)), (4, (24, 40))):
        ids, offset, feats, pos3, _ = _image_request(sides, seed, h, w)
        reqs.append(dict(prompt_ids=ids, image_embeds=feats, image_offset=offset,
                         mrope_positions=pos3))
    reqs.append(dict(prompt_ids=[5, 9, 17, 33, 65, 120, 7, 8, 9, 10] * 3))
    ids, _ = _greedy(JaxEngine, JaxGenRequest, sides["jarch"], sides["jparams"], reqs)
    return reqs, ids


def _port_reqs(reqs):
    return [{**r, **({"image_embeds": torch.tensor(r["image_embeds"])}
                     if "image_embeds" in r else {})} for r in reqs]


@pytest.mark.parametrize("path", ["dense", "paged_chunk", "swap"])
def test_engine_greedy_ids_match_jax_engine(sides, jax_ids, path):
    """Dense; a paged pool whose 16-token chunks would chunk the image
    prompts (they admit single-shot); a 4-page pool where the younger
    image request is swapped out and back in. Each slot decodes with rope
    at row + its delta in the same blocks as the others."""
    reqs, want = jax_ids
    kw = {}
    if path == "paged_chunk":
        kw = dict(kv_pages=24, kv_page_size=16, prefill_chunk=16)
    if path == "swap":
        kw = dict(kv_pages=4, kv_page_size=16, kv_preempt="swap", prefix_cache_entries=0,
                  kv_page_headroom=0)
        reqs = [reqs[2], reqs[0]]  # the text request is older: the image one is the victim
        want = [want[2], want[0]]
    got, m = _greedy(Engine, GenRequest, sides["tarch"], sides["tparams"], _port_reqs(reqs),
                     **kw)
    assert got == want
    if path == "paged_chunk":
        assert m["chunked_admits"] == 1  # the text prompt (30 > 16) chunked, the images not
    if path == "swap":
        assert m["kv_preempt_swaps"] >= 1


def test_text_prompt_on_mrope_equals_plain_rope(sides):
    """m-rope over three equal streams is plain rope: a text request gives
    the ids of the same decoder with no m-rope section."""
    prompt = [5, 9, 17, 33, 65, 120, 7, 8, 9, 10]
    a, _ = _greedy(Engine, GenRequest, sides["tarch"], sides["tparams"], [dict(prompt_ids=prompt)])
    plain = dataclasses.replace(sides["tarch"], mrope_section=())
    b, _ = _greedy(Engine, GenRequest, plain, sides["tparams"], [dict(prompt_ids=prompt)])
    assert a == b


def test_image_requests_never_fork_hit_or_save_the_prefix_cache(sides):
    """Two requests with the same ids (the placeholders are zeros) and
    different images: the second neither hits a span of the first (no
    prefix hit, no entry saved) and answers what a fresh engine answers.
    A choice group of two image requests on a paged pool admits as two
    clones, not a fork."""
    ids, offset, fa, pos3, _ = _image_request(sides, 5, 48, 32, post=(VEND,) + tuple(range(20, 60)))
    _, _, fb, _, _ = _image_request(sides, 6, 48, 32)
    a = dict(prompt_ids=ids, image_embeds=torch.tensor(fa), image_offset=offset,
             mrope_positions=pos3)
    b = dict(a, image_embeds=torch.tensor(fb))
    # One slot: b admits after a finished, when a text request would have
    # saved its span.
    kw = dict(kv_pages=24, kv_page_size=16, prefix_cache_entries=8, prefix_cache_min=8,
              max_slots=1)
    both, m = _greedy(Engine, GenRequest, sides["tarch"], sides["tparams"], [a, b], **kw)
    alone, _ = _greedy(Engine, GenRequest, sides["tarch"], sides["tparams"], [b], **kw)
    assert both[1] == alone[0]
    assert m["prefix_hits"] == 0 and m["prefix_entries"] == 0
    pair, mf = _greedy(Engine, GenRequest, sides["tarch"], sides["tparams"], [b, b], fork=True,
                       **dict(kw, max_slots=2))
    assert pair == [alone[0], alone[0]] and mf["fork_branches"] == 0
    # The two images' rows differ, so a hit on a's span would have been wrong.
    toks = torch.tensor([ids + [0] * (128 - len(ids))])
    kv = [tl.prefill(sides["tarch"], sides["tparams"], toks, torch.tensor([len(ids)]),
                     inject=(f[None], torch.tensor([offset])),
                     mrope=torch.from_numpy(np.pad(pos3, ((0, 0), (0, 128 - len(ids))),
                                                   mode="edge"))[None].long())[1]
          for f in (a["image_embeds"], b["image_embeds"])]
    assert float((kv[0] - kv[1]).abs().max()) > 1e-2


def _errors(eng_cls, req_cls, arch, params, requests, **kw):
    out = []
    eng = eng_cls(arch, params, (ByteTokenizer if eng_cls is Engine else JaxByteTokenizer)(VOCAB),
                  engine_cfg=(EngineConfig if eng_cls is Engine else JaxEngineConfig)(
                      max_slots=2, max_seq=128, min_prefill_bucket=16, **kw),
                  **({"device": "cpu"} if eng_cls is Engine else {}),
                  **({"draft_cfg": arch, "draft_params": params} if kw.get("spec_mode")
                     == "draft_model" else {}))
    try:
        for r in requests:
            with pytest.raises(ValueError) as e:
                eng.submit(req_cls(max_new_tokens=2, **r))
            out.append(str(e.value))
    finally:
        eng.stop()
    return out


def test_validation_errors_match_jax_and_speculation_refuses_images(sides):
    ids, offset, feats, pos3, _ = _image_request(sides, 7)
    bad = [dict(prompt_ids=ids[:offset + 2], image_embeds=feats, image_offset=offset),
           dict(prompt_ids=ids, image_embeds=feats, image_offset=-1),
           dict(prompt_ids=ids, mrope_positions=pos3[:, :-1])]
    want = _errors(JaxEngine, JaxGenRequest, sides["jarch"], sides["jparams"], bad)
    got = _errors(Engine, GenRequest, sides["tarch"], sides["tparams"],
                  [{**r, **({"image_embeds": torch.tensor(feats)}
                            if "image_embeds" in r else {})} for r in bad])
    assert got == want and "outside the prompt" in got[0]
    draft = [dict(prompt_ids=ids, image_embeds=feats, image_offset=offset),
             dict(prompt_ids=ids, mrope_positions=pos3)]
    want = _errors(JaxEngine, JaxGenRequest, sides["jarch"], sides["jparams"], draft,
                   spec_mode="draft_model")
    got = _errors(Engine, GenRequest, sides["tarch"], sides["tparams"], draft,
                  spec_mode="draft_model")
    assert got == want == ["multimodal requests are not supported with a draft model",
                           "mrope requests are not supported with a draft model"]
    got = _errors(Engine, GenRequest, sides["tarch"], sides["tparams"], draft,
                  spec_mode="prompt_lookup")
    assert all("speculative decoding (spec_mode=prompt_lookup) on an m-rope model" in g
               for g in got), got


def _png_uri(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _serve_both(models_dir):
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import ModelManager as JaxModelManager
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

    app = dict(address="127.0.0.1", port=0, models_dir=models_dir)
    jm, tm = JaxModelManager(JaxAppConfig(**app)), ModelManager(ApplicationConfig(**app),
                                                                device="cpu")
    jr, tr = JaxRouter(), Router()
    JaxOpenAIApi(jm).register(jr)
    OpenAIApi(tm).register(tr)
    servers = [jax_create_server(JaxAppConfig(**app), jr), create_server(ApplicationConfig(**app),
                                                                         tr)]
    bases = []
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
        bases.append(f"http://127.0.0.1:{s.server_address[1]}")
    return (jm, tm), servers, bases


def chat_both(models_dir, model, payloads):
    """Each payload to both servers → [(jax status, body), (port ...)]."""
    managers, servers, bases = _serve_both(models_dir)
    out = []
    try:
        for payload in payloads:
            pair = []
            for base in bases:
                req = urllib.request.Request(
                    base + "/v1/chat/completions",
                    data=json.dumps({"model": model, **payload}).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=600) as r:
                        pair.append((r.status, json.loads(r.read())))
                except urllib.error.HTTPError as e:
                    pair.append((e.code, json.loads(e.read())))
            out.append(pair)
        return out, managers
    finally:
        for s in servers:
            s.shutdown()
        for m in managers:
            m.shutdown()


def test_chat_with_a_png_image_matches_jax_server(ckpt, tmp_path):
    """The vlm backend on the Qwen2-VL checkpoint (loaded in f32 on both
    sides): a text + PNG chat, the same text with another image, and the
    text alone give the JAX server's content bytes and usage."""
    (tmp_path / "qv.yaml").write_text(yaml.safe_dump({
        "name": "qv", "model": ckpt, "backend": "vlm", "context_size": 256, "max_slots": 2,
        "max_tokens": 8, "temperature": 0.0, "template": {"family": "chatml"}}))
    saved = jw.arch_from_hf_config, tw.arch_from_hf_config
    jw.arch_from_hf_config = lambda d: dataclasses.replace(saved[0](d), dtype="float32")
    tw.arch_from_hf_config = lambda d: dataclasses.replace(saved[1](d), dtype="float32")

    def msg(img):
        parts = [{"type": "text", "text": "what is this?"}]
        if img is not None:
            parts.append({"type": "image_url", "image_url": {"url": _png_uri(img)}})
        return {"messages": [{"role": "user", "content": parts}], "max_tokens": 6}

    try:
        out, _ = chat_both(str(tmp_path), "qv", [msg(_image(56, 56, 8)), msg(_image(56, 84, 9)),
                                                 msg(None)])
    finally:
        jw.arch_from_hf_config, tw.arch_from_hf_config = saved
    for (js, jb), (ps, pb) in out:
        assert js == ps == 200, (jb, pb)
        assert pb["choices"][0]["message"] == jb["choices"][0]["message"]
        assert pb["usage"] == jb["usage"]
    usage = [pair[1][1]["usage"]["prompt_tokens"] for pair in out]
    # The image spans: 56 x 56 and 56 x 80 (84 rounded to a multiple of 8)
    # pixels, patches of 4, merged 2 x 2.
    assert (usage[0] - usage[2], usage[1] - usage[2]) == (49, 70), usage
