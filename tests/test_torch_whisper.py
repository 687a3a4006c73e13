"""The port's whisper (localai_tpu_torch/models/whisper.py) against the
JAX package's on the CPU at whisper-test's widths, the same weights
carried across (`params_from_numpy`): the encoder's states and the
decoder step's logits within 1e-4 (f32, summation order only), greedy
transcription's ids and valid counts exact, the HF checkpoint written by
either package loading in the other leaf for leaf, and WhisperEngine's
chunked transcription (three chunks batched) giving the JAX engine's
answer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine.audio_engine import WhisperEngine as JaxWhisperEngine
from localai_tpu.models import whisper as JW
from localai_tpu_torch.engine.audio_engine import WhisperEngine
from localai_tpu_torch.models import whisper as TW

TOL = 1e-4
PROMPT = [1, 6, 4, 3]  # sot, lang, transcribe, no_timestamps of whisper-test


@pytest.fixture(scope="module")
def model():
    cfg = JW.WHISPER_PRESETS["whisper-test"]
    jp = JW.init_params(cfg, jax.random.key(0), scale=0.2)  # wide enough to vary the ids
    tp = TW.params_from_numpy(TW.WHISPER_PRESETS["whisper-test"],
                              jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _mel(seed, B, cfg):
    return np.random.default_rng(seed).standard_normal((B, 2 * cfg.n_audio_ctx, cfg.n_mels)) \
        .astype(np.float32)


def test_config_and_presets_are_the_jax_packages():
    assert {k: dataclasses.asdict(v) for k, v in TW.WHISPER_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JW.WHISPER_PRESETS.items()}
    np.testing.assert_array_equal(TW.sinusoids(64, 32), JW.sinusoids(64, 32))


def test_encode_and_decode_steps_match_jax(model):
    cfg, jp, tp = model
    mel = _mel(0, 2, cfg)
    enc_j = JW.encode(cfg, jp, jnp.asarray(mel))
    enc_t = TW.encode(cfg, tp, torch.from_numpy(mel))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=TOL, rtol=0)
    jxk, jxv = JW.cross_kv(cfg, jp, enc_j)
    txk, txv = TW.cross_kv(cfg, tp, enc_t)
    shape = (cfg.dec_layers, 2, cfg.n_text_ctx, cfg.n_heads, cfg.head_dim)
    jc = JW.SelfCache(k=jnp.zeros(shape), v=jnp.zeros(shape))
    tc = TW.SelfCache.zeros(cfg, 2, "cpu")
    for step, toks in enumerate(([1, 1], [6, 9], [40, 77], [3, 120])):
        pos = [step, step]
        jl, jc = JW.decode_step(cfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc, jxk, jxv)
        tl, tc = TW.decode_step(cfg, tp, torch.tensor(toks), torch.tensor(pos), tc, txk, txv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL, rtol=0)


@pytest.mark.parametrize("B,steps", [(1, 12), (3, 24)])
def test_transcribe_greedy_ids_are_the_jax_programs(model, B, steps):
    cfg, jp, tp = model
    mel = _mel(B, B, cfg)
    jt, jn = JW.transcribe_greedy(cfg, jp, jnp.asarray(mel), jnp.asarray(PROMPT, jnp.int32), steps)
    tt, tn = TW.transcribe_greedy(cfg, tp, torch.from_numpy(mel), PROMPT, steps)
    assert tt.tolist() == np.asarray(jt).tolist() and tn.tolist() == np.asarray(jn).tolist()
    assert len(set(np.asarray(jt).ravel().tolist())) > 1


def test_hf_checkpoints_cross_load(model, tmp_path):
    cfg, jp, tp = model
    JW.save_hf_whisper(cfg, jp, str(tmp_path / "jax"))
    got = TW.load_hf_whisper(TW.whisper_config_from_hf(str(tmp_path / "jax")),
                             str(tmp_path / "jax"), device="cpu")
    TW.save_hf_whisper(cfg, tp, str(tmp_path / "port"))
    back = JW.load_hf_whisper(JW.whisper_config_from_hf(str(tmp_path / "port")),
                              str(tmp_path / "port"))

    def walk(a, b, ref, path=""):
        if isinstance(ref, dict):
            for k in ref:
                walk(a[k], b[k], ref[k], f"{path}/{k}")
            return
        assert torch.equal(a, ref), path
        np.testing.assert_array_equal(np.asarray(b), ref.numpy(), err_msg=path)

    walk(got, back, tp)
    assert dataclasses.asdict(TW.whisper_config_from_hf(str(tmp_path / "port"))) == \
        dataclasses.asdict(JW.whisper_config_from_hf(str(tmp_path / "jax")))
    TW.save_hf_whisper(cfg, tp, str(tmp_path / "bf16"), dtype=torch.bfloat16)
    bcfg = TW.whisper_config_from_hf(str(tmp_path / "bf16"))
    assert bcfg.dtype == "bfloat16"
    bf = TW.load_hf_whisper(bcfg, str(tmp_path / "bf16"), device="cpu")
    assert torch.equal(bf["dec"]["fc1_w"], tp["dec"]["fc1_w"].to(torch.bfloat16))


def test_engine_transcribes_three_chunks_like_the_jax_engine(model):
    cfg, jp, tp = model
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(int(2.5 * 2 * cfg.n_audio_ctx * 160)) * 0.1).astype(np.float32)
    want = JaxWhisperEngine(cfg, jp).transcribe(audio, language="en")
    eng = WhisperEngine(cfg, tp)
    got = eng.transcribe(audio, language="en")
    assert got == want and len(got["segments"]) == 3
    assert eng.metrics()["requests"] == 1.0
    eng.drop_device_state()
    with pytest.raises(RuntimeError, match="unloaded"):
        eng.transcribe(audio)
