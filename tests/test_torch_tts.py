"""The port's TTS models against the JAX package's on the CPU. tts-test
(the JAX weights carried across): `text_to_mel` within 1e-5,
`mel_to_audio` within 1e-4 given the JAX draw of Griffin-Lim's first
phase as `phase0`, `synthesize`'s sample count equal, the checkpoint
layout read by either package. VITS: a small random `VitsModel` saved by
transformers in the HF layout, read by both packages, under the same
noise tensors: waveforms within 1e-4 and `valid_samples` equal, exact
length and a padded token bucket alike; every tensor the synthesis reads
named and shaped as in that checkpoint (`param_shapes`), the port's own
random checkpoint (`save_vits`) read by the JAX loader to the same
waveform, and VitsEngine giving the JAX engine's samples under the JAX
engine's noise."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine.audio_engine import VitsEngine as JaxVitsEngine
from localai_tpu.models import tts as JT
from localai_tpu.models import vits as JV
from localai_tpu_torch.engine.audio_engine import TTSEngine, VitsEngine
from localai_tpu_torch.models import tts as TT
from localai_tpu_torch.models import vits as TV

from test_torch_audio import VITS_CHARS, jax_first_phase, jax_vits_noise, small_vits_cfg

MEL_TOL, AUDIO_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def tts():
    cfg = JT.TTS_PRESETS["tts-test"]
    jp = JT.init_params(cfg, jax.random.key(0), scale=0.2)
    return cfg, jp, TT.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _ids(texts, T):
    ids = np.zeros((len(texts), T), np.int32)
    for i, t in enumerate(texts):
        ids[i, : len(t)] = np.frombuffer(t.encode(), np.uint8)
    return ids, np.asarray([len(t) for t in texts], np.int32)


def test_text_to_mel_and_griffin_lim_match_jax(tts):
    cfg, jp, tp = tts
    assert {k: dataclasses.asdict(v) for k, v in TT.TTS_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JT.TTS_PRESETS.items()}
    ids, lens = _ids(["hello there", "abc", "x" * 32], cfg.max_text)
    voice = np.asarray([0, 1, 1], np.int32)
    jm, jf = JT.text_to_mel(cfg, jp, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(voice))
    tm, tf = TT.text_to_mel(cfg, tp, torch.from_numpy(ids).long(), torch.from_numpy(lens).long(),
                            torch.from_numpy(voice).long())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=MEL_TOL, rtol=0)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    for b in (1,):
        want = np.asarray(JT.mel_to_audio(cfg, jm[b]))
        got = TT.mel_to_audio(cfg, tm[b], phase0=jax_first_phase((tm.shape[1], cfg.n_fft // 2 + 1)))
        np.testing.assert_allclose(got.numpy(), want, atol=AUDIO_TOL, rtol=0)
    ja, jn = JT.synthesize(cfg, jp, jnp.asarray(ids[0]), jnp.int32(lens[0]), jnp.int32(1))
    ta, tn = TT.synthesize(cfg, tp, torch.from_numpy(ids[0]).long(), int(lens[0]), 1,
                           phase0=jax_first_phase((cfg.max_frames, cfg.n_fft // 2 + 1)))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=AUDIO_TOL, rtol=0)
    # Without phase0 the port draws its own first phase: a waveform all the same.
    own, n = TT.synthesize(cfg, tp, torch.from_numpy(ids[0]).long(), int(lens[0]), 1)
    assert int(n) == int(jn) and torch.isfinite(own).all() and own.abs().max() > 0.5


def test_tts_checkpoints_cross_load_and_engine_matches(tts, tmp_path, monkeypatch):
    cfg, jp, tp = tts
    JT.save_tts(cfg, jp, str(tmp_path / "jax"))
    tcfg, got = TT.load_tts(str(tmp_path / "jax"), device="cpu")
    TT.save_tts(cfg, tp, str(tmp_path / "port"))
    jcfg, back = JT.load_tts(str(tmp_path / "port"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for k, v in tp.items():
        for k2, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            a = got[k][k2] if k2 else got[k]
            b = back[k][k2] if k2 else back[k]
            assert torch.equal(a, t) and np.array_equal(np.asarray(b), t.numpy()), (k, k2)
    monkeypatch.setattr(TT, "first_phase", jax_first_phase)
    eng = TTSEngine(cfg, tp, voices=["a", "b"])
    text = "a longer sentence, cut into two chunks of 32 bytes each."
    wav, sr = eng.synthesize(text, voice="b")
    from localai_tpu.engine.audio_engine import TTSEngine as JaxTTSEngine

    want, jsr = JaxTTSEngine(cfg, jp, voices=["a", "b"]).synthesize(text, voice="b")
    assert sr == jsr and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=AUDIO_TOL, rtol=0)
    chunks = list(eng.synthesize_stream(text, voice="b"))
    assert len(chunks) == 2 and np.allclose(np.concatenate(chunks), wav, atol=1e-6)


@pytest.fixture(scope="module")
def hf_vits(tmp_path_factory):
    from transformers import VitsConfig as HFVitsConfig
    from transformers import VitsModel

    d = tmp_path_factory.mktemp("vits")
    c = small_vits_cfg()
    hf = HFVitsConfig(**{k: list(v) if isinstance(v, tuple) else v
                         for k, v in dataclasses.asdict(c).items()
                         if k not in ("resblock_dilation_sizes",)},
                      resblock_dilation_sizes=[list(x) for x in c.resblock_dilation_sizes],
                      spectrogram_bins=9, posterior_encoder_num_wavenet_layers=2)
    torch.manual_seed(0)
    VitsModel(hf).eval().save_pretrained(str(d), safe_serialization=True)
    vocab = {"<pad>": 0, **{ch: i + 1 for i, ch in enumerate(VITS_CHARS)}}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "tokenizer_config.json").write_text(json.dumps({"add_blank": True, "normalize": True}))
    return str(d)


_jax_synthesize = jax.jit(JV.synthesize, static_argnums=(0, 3))  # one program, not eager ops


def _vits_pair(jc, jp, tc, tp, ids, frames, seed, bucket=0):
    T = len(ids)
    Tb = bucket or T
    rng = np.random.default_rng(seed)
    dn = np.zeros((1, 2, Tb), np.float32)
    dn[..., :T] = rng.standard_normal((1, 2, T)) * 0.8
    pn = (rng.standard_normal((1, frames, jc.flow_size)) * 0.667).astype(np.float32)
    pad = np.zeros((1, Tb), np.int32)
    pad[0, :T] = ids
    kw = {"n_tokens": [T]} if bucket else {}
    jw, jn = _jax_synthesize(jc, jp, jnp.asarray(pad), frames, jnp.asarray(dn), jnp.asarray(pn),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    tw, tn = TV.synthesize(tc, tp, torch.from_numpy(pad).long(), frames, torch.from_numpy(dn),
                           torch.from_numpy(pn), **{k: torch.tensor(v) for k, v in kw.items()})
    return (np.asarray(jw), np.asarray(jn)), (tw.numpy(), tn.numpy())


@pytest.mark.parametrize("bucket", [0, 64])
def test_vits_waveform_matches_jax_under_the_same_noise(hf_vits, bucket):
    jc, jp, jt = JV.load_vits(hf_vits)
    tc, tp, tt = TV.load_vits(hf_vits, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for text in ("Hello world!",) if bucket else ("the quick brown fox",):
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        (jw, jn), (tw, tn) = _vits_pair(jc, jp, tc, tp, ids, 96, len(text), bucket)
        assert tn.tolist() == jn.tolist() and 0 < tn[0] <= tw.shape[1]
        np.testing.assert_allclose(tw, jw, atol=AUDIO_TOL, rtol=0)


def test_vits_param_shapes_and_own_checkpoint(hf_vits, tmp_path):
    from localai_tpu_torch.engine.weights import SafetensorsFile

    tc, tp, _ = TV.load_vits(hf_vits, device="cpu")
    shapes = TV.param_shapes(tc)
    assert {k: tuple(tp[k].shape) for k in shapes} == shapes
    assert not any(k.startswith(("text_encoder", "flow.", "decoder.")) and k not in shapes
                   for k in tp)  # the posterior encoder and its flows alone go unread
    cfg = small_vits_cfg()
    params = TV.init_params(cfg, seed=3, device="cpu")
    TV.save_vits(cfg, params, str(tmp_path / "v"), VITS_CHARS)
    assert TV.is_vits_dir(str(tmp_path / "v")) and JV.is_vits_dir(str(tmp_path / "v"))
    assert set(SafetensorsFile(str(tmp_path / "v/model.safetensors")).keys()) == set(shapes)
    jc, jp, jt = JV.load_vits(str(tmp_path / "v"))
    tc, tp, tt = TV.load_vits(str(tmp_path / "v"), device="cpu")
    ids = tt.encode("own voice")
    (jw, jn), (tw, tn) = _vits_pair(jc, jp, tc, tp, ids, 128, 1)
    assert tn.tolist() == jn.tolist()
    np.testing.assert_allclose(tw, jw, atol=AUDIO_TOL, rtol=0)


def test_vits_engine_matches_jax_engine(hf_vits, monkeypatch):
    monkeypatch.setattr(VitsEngine, "noise", jax_vits_noise)
    jc, jp, jt = JV.load_vits(hf_vits)
    eng = VitsEngine(*TV.load_vits(hf_vits, device="cpu"))
    jeng = JaxVitsEngine(jc, jp, jt)
    for text, rate in (("Short one.", None), ("a slower, longer sentence here", 0.8)):
        got, sr = eng.synthesize(text, speaking_rate=rate)
        want, jsr = jeng.synthesize(text, speaking_rate=rate)
        assert sr == jsr == 16000 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=AUDIO_TOL, rtol=0)
    assert eng.buckets(300, 1.0) == (1024, 8192) and eng.buckets(2000, 1.0) == (2048, 32768)
