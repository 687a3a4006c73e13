"""The port's audio front end and audio routes against the JAX package's on
the CPU: log-mel within 1e-5 (1e-4 in the bins under 1e-6 of their frame's
peak power, where the two FFT libraries' rounding of the peak shows), the
packaged VAD saved and read back, the learned VAD's frame probabilities within
1e-5 with `detect` and `energy_vad` segments equal, the packaged VAD
asset's bytes equal, WAV I/O and resampling equal. Then both servers on
one models dir (a whisper-test checkpoint and a tts-test checkpoint
written by the JAX package, a small VITS voice in the HF layout, the
packaged VAD and the energy VAD): /v1/audio/transcriptions and
translations in every response format give the JAX server's JSON (ids
exact); /v1/audio/speech, /tts, /v1/audio/speech/stream,
/v1/text-to-speech/:voice_id and /v1/sound-generation give its headers
and samples within 2 LSB of pcm16 (the port's Griffin-Lim first phase and
VITS noise are set to the JAX draws, the only deliberate differences);
/v1/vad its segments; every error its status. A MusicGen YAML fails to
load naming its ROADMAP item, and the CLI's `transcribe` / `tts` print
the JAX CLI's answers."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from localai_tpu.audio import features as jfeat
from localai_tpu.audio import learned_vad as JLV
from localai_tpu.audio import vad as jvad
from localai_tpu.audio import wav as jwav
from localai_tpu.audio.formant_speech import synth_utterance
from localai_tpu.config import ApplicationConfig as JaxAppConfig
from localai_tpu.engine.weights import save_hf_checkpoint
from localai_tpu.models import llama as jl
from localai_tpu.models import tts as JT
from localai_tpu.models import whisper as JW
from localai_tpu.server import ModelManager as JaxModelManager
from localai_tpu.server import Router as JaxRouter
from localai_tpu.server import create_server as jax_create_server
from localai_tpu.server.audio_api import AudioApi as JaxAudioApi
from localai_tpu.server.openai_api import OpenAIApi as JaxOpenAIApi
from localai_tpu.server.realtime_api import RealtimeApi as JaxRealtimeApi
from localai_tpu_torch.audio import features as tfeat
from localai_tpu_torch.audio import learned_vad as TLV
from localai_tpu_torch.audio import vad as tvad
from localai_tpu_torch.audio import wav as twav
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.audio_engine import VitsEngine
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models import tts as TT
from localai_tpu_torch.models import vits as TV
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
from localai_tpu_torch.server.audio_api import AudioApi
from localai_tpu_torch.server.realtime_api import RealtimeApi

FEAT_TOL = 1e-5  # log-mel and VAD probabilities: f32 summation order only
# A mel bin far below its frame's peak carries the f32 FFT's rounding of the
# peak (~2^-24 of it, which the two FFT libraries round differently): where
# the bin's power is under 1e-6 of the frame's largest, log10 amplifies that
# to ~1e-5, so those bins are held to 1e-4 instead.
FFT_FLOOR, FLOOR_TOL = 1e-6, 1e-4
PCM_TOL = 2.0 / 32768  # two pcm16 steps: int16 truncation of samples within 1e-4


def _close_log_mel(got: np.ndarray, want: np.ndarray) -> None:
    """Log-mel [.., frames, mels] within FEAT_TOL, or FLOOR_TOL in the bins
    under FFT_FLOOR of their frame's peak power."""
    power = 10.0 ** (want * 4.0 - 4.0)
    floor = power < FFT_FLOOR * power.max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err[~floor].max(initial=0) <= FEAT_TOL, err[~floor].max()
    assert err[floor].max(initial=0) <= FLOOR_TOL, err[floor].max()


def _speech(seed: int, seconds: float, sr: int = 16_000, silence_s: float = 0.5) -> np.ndarray:
    """Formant speech followed by silence, at 16 kHz."""
    sp, _ = synth_utterance(np.random.default_rng(seed), seconds, 16_000)
    x = np.concatenate([sp, np.zeros(int(16_000 * silence_s), np.float32)])
    return jwav.resample(x, 16_000, sr) if sr != 16_000 else x


@pytest.mark.parametrize("n_mels,seconds", [(16, 0.7), (40, 2.0), (80, 1.3), (128, 0.4)])
def test_log_mel_matches_jax(n_mels, seconds):
    x = _speech(n_mels, seconds, silence_s=0.1) * 0.8
    want = np.asarray(jfeat.log_mel_spectrogram(jnp.asarray(x), n_mels=n_mels))
    _close_log_mel(tfeat.log_mel_spectrogram(x, n_mels=n_mels).numpy(), want)
    np.testing.assert_array_equal(tfeat.mel_filterbank(n_mels), jfeat.mel_filterbank(n_mels))


def test_packaged_asset_is_the_jax_packages(tmp_path):
    with open(TLV.packaged_weights(), "rb") as f, open(JLV.packaged_weights(), "rb") as g:
        got, want = f.read(), g.read()
    assert len(got) == 85628 and got == want
    # save_params writes what load_params and the JAX loader read back.
    tp = TLV.load_params(TLV.packaged_weights(), device="cpu")
    TLV.save_params(str(tmp_path / "vad.safetensors"), tp)
    assert TLV.find_weights(str(tmp_path)) == str(tmp_path / "vad.safetensors")
    back = TLV.load_params(str(tmp_path / "vad.safetensors"), device="cpu")
    jback = JLV.load_params(str(tmp_path / "vad.safetensors"))
    for k, v in tp.items():
        assert torch.equal(back[k], v) and np.array_equal(np.asarray(jback[k]), v.numpy()), k


@pytest.mark.parametrize("seed,sr", [(1, 16_000), (2, 24_000), (3, 8_000)])
def test_learned_vad_and_energy_vad_match_jax(seed, sr):
    jp = JLV.load_params(JLV.packaged_weights())
    tp = TLV.load_params(TLV.packaged_weights(), device="cpu")
    cfg = TLV.config_from_params(tp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JLV.config_from_params(jp))
    x = np.concatenate([np.zeros(int(0.4 * sr), np.float32), _speech(seed, 1.2, sr)])
    mel = np.asarray(JLV.features(x, JLV.config_from_params(jp), sr))
    _close_log_mel(TLV.features(x, cfg, sr).numpy(), mel)
    want = np.asarray(JLV.forward(JLV.config_from_params(jp), jp, jnp.asarray(mel)))
    got = TLV.forward(cfg, tp, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=0)
    jsegs = JLV.detect(JLV.config_from_params(jp), jp, x, sr)
    tsegs = TLV.detect(cfg, tp, x, sr)
    assert [(s.start, s.end) for s in tsegs] == [(s.start, s.end) for s in jsegs] and tsegs
    assert [(s.start, s.end) for s in tvad.energy_vad(x, sr)] == \
        [(s.start, s.end) for s in jvad.energy_vad(x, sr)]


@pytest.mark.parametrize("sr,push_ms", [(16_000, 100), (24_000, 100), (44_100, 37)])
def test_streaming_vad_gives_whole_buffer_detect_after_every_push(sr, push_ms):
    """StreamingDetector fed in pushes of push_ms (plus an odd sample): after
    every push its segments equal, exactly, detect() of the whole buffer
    resampled to 16 kHz (the realtime socket's question), and the JAX
    package's detect() agrees at the end. Loud speech after quiet speech
    sets new peaks (each recomputes the GRU state from the first frame)."""
    tp = TLV.load_params(TLV.packaged_weights(), device="cpu")
    cfg = TLV.config_from_params(tp)
    x16 = np.concatenate([np.zeros(3000, np.float32), 0.3 * _speech(5, 1.0, silence_s=0.4),
                          _speech(6, 0.8, silence_s=0.6)])
    x = jwav.resample(x16, 16_000, sr) if sr != 16_000 else x16
    det = TLV.StreamingDetector(sr)
    step = sr * push_ms // 1000 + 1
    peaks = []
    for i in range(0, len(x), step):
        got = det.push(cfg, tp, x[i: i + step])
        whole = twav.resample(x[: i + step], sr, 16_000)
        want = TLV.detect(cfg, tp, whole, 16_000)
        assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want], i
        assert det.seconds == len(whole) / 16_000
        padded = torch.nn.functional.pad(torch.from_numpy(whole)[None, None], (200, 200),
                                         mode="reflect")[0, 0]
        peaks.append(float(tfeat.log10_mel(padded, cfg.n_mels)[:-1].max()))
    assert len(got) == 2
    # The GRU state is recomputed from the first frame exactly when the peak moves.
    assert det.recomputes == 1 + sum(a != b for a, b in zip(peaks, peaks[1:])) < len(peaks)
    jp = JLV.load_params(JLV.packaged_weights())
    jsegs = JLV.detect(JLV.config_from_params(jp), jp, jwav.resample(x, sr, 16_000), 16_000)
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in jsegs]


def test_wav_io_and_resample_match_jax(tmp_path):
    x = _speech(4, 0.5)
    assert twav.write_wav(x, 16_000) == jwav.write_wav(x, 16_000)
    blob = jwav.write_wav(x, 22_050)
    got, want = twav.read_wav(blob), jwav.read_wav(blob)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    np.testing.assert_array_equal(twav.resample(x, 16_000, 24_000),
                                  jwav.resample(x, 16_000, 24_000))


# --------------------------------------------------------------------------- #
# Both servers on one models dir
# --------------------------------------------------------------------------- #

VITS_CHARS = "abcdefghijklmnopqrstuvwxyz ?!.,'-"


def small_vits_cfg():
    return TV.VitsConfig(
        vocab_size=40, hidden_size=16, num_hidden_layers=2, num_attention_heads=2, ffn_dim=32,
        flow_size=16, prior_encoder_num_flows=2, prior_encoder_num_wavenet_layers=2,
        duration_predictor_num_flows=2, duration_predictor_flow_bins=4,
        depth_separable_num_layers=2, duration_predictor_filter_channels=16,
        upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def jax_first_phase(shape, device=None):
    """The JAX package's Griffin-Lim first phase (tts.py: jax.random.key(0))."""
    ph = jax.random.uniform(jax.random.key(0), tuple(shape), jnp.float32, 0, 2 * np.pi)
    return torch.from_numpy(np.array(ph)).to(device)


def jax_vits_noise(self, seed, tokens, frames):
    """The JAX VitsEngine's noise of request `seed`."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    dur = jax.random.normal(k1, (1, 2, tokens)) * self.cfg.noise_scale_duration
    prior = jax.random.normal(k2, (1, frames, self.cfg.flow_size)) * self.cfg.noise_scale
    return torch.from_numpy(np.array(dur)), torch.from_numpy(np.array(prior))


def write_audio_models(root) -> None:
    """The models dir both servers read: whisper-test, tts-test and the f32
    tiny llama as checkpoints of the JAX package's weights, a small VITS
    voice, the packaged and the energy VAD, and YAMLs for each."""
    wcfg = JW.WHISPER_PRESETS["whisper-test"]
    JW.save_hf_whisper(wcfg, JW.init_params(wcfg, jax.random.key(0)), str(root / "stt"))
    tcfg = JT.TTS_PRESETS["tts-test"]
    JT.save_tts(tcfg, JT.init_params(tcfg, jax.random.key(0)), str(root / "voice"))
    vcfg = small_vits_cfg()
    TV.save_vits(vcfg, TV.init_params(vcfg, seed=0, device="cpu"), str(root / "vits"), VITS_CHARS)
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    save_hf_checkpoint(cfg, jl.init_params(cfg, jax.random.key(0)), str(root / "llm"))
    docs = [
        {"name": "chat", "model": "llm", "context_size": 128, "max_slots": 2, "max_tokens": 8,
         "temperature": 0.0, "template": {"family": "chatml"}},
        {"name": "stt", "model": "stt", "backend": "whisper"},
        {"name": "voice", "model": "voice", "backend": "tts"},
        {"name": "mms", "model": "vits", "backend": "tts"},
        {"name": "energy", "model": "energy", "backend": "vad"},
    ]
    for d in docs:
        (root / f"{d['name']}.yaml").write_text(yaml.safe_dump(d))


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def start_servers(root, extra_vad: bool = True):
    """Both servers over `root` with the OpenAI, audio and realtime layers;
    the llama loaders widened to f32 (the JAX checkpoint is f32), the
    port's Griffin-Lim phase and VITS noise set to the JAX draws. Returns
    (info, stop)."""
    import localai_tpu.engine.weights as jw
    import localai_tpu_torch.engine.weights as tw

    mp = pytest.MonkeyPatch()
    for mod in (jw, tw):
        saved = mod.arch_from_hf_config
        mp.setattr(mod, "arch_from_hf_config",
                   lambda d, saved=saved: dataclasses.replace(saved(d), dtype="float32"))
    mp.setattr(TT, "first_phase", jax_first_phase)
    mp.setattr(VitsEngine, "noise", jax_vits_noise)
    if extra_vad:
        (root / "vad.yaml").write_text(yaml.safe_dump({"name": "vad", "backend": "vad"}))
    app = dict(address="127.0.0.1", port=0, models_dir=str(root), max_active_models=8)
    jm = JaxModelManager(JaxAppConfig(**app))
    jr = JaxRouter()
    joai = JaxOpenAIApi(jm)
    joai.register(jr)
    JaxAudioApi(jm, joai).register(jr)
    JaxRealtimeApi(jm, joai).register(jr)
    js = jax_create_server(JaxAppConfig(**app), jr)
    tm = ModelManager(ApplicationConfig(**app), device="cpu")
    tr = Router()
    toai = OpenAIApi(tm)
    toai.register(tr)
    AudioApi(tm, toai).register(tr)
    RealtimeApi(tm, toai).register(tr)
    ts = create_server(ApplicationConfig(**app), tr)
    info = {"jax": _serve(js), "port": _serve(ts), "jax_manager": jm, "port_manager": tm}

    def stop():
        for s in (js, ts):
            s.shutdown()
        jm.shutdown()
        tm.shutdown()
        mp.undo()

    return info, stop


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio-models")
    write_audio_models(root)
    info, stop = start_servers(root)
    yield info
    stop()


def _post(base, path, body=None, form=None):
    """(status, content type, headers, raw bytes) of a POST: JSON `body`,
    or multipart `form` {name: (filename | None, bytes)}."""
    headers = {}
    if form is not None:
        boundary = uuid.uuid4().hex
        parts = []
        for name, (fname, blob) in form.items():
            disp = f'form-data; name="{name}"' + (f'; filename="{fname}"' if fname else "")
            parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode()
                         + blob + b"\r\n")
        data = b"".join(parts) + f"--{boundary}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
    else:
        data = json.dumps(body or {}).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(base + path, data=data, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), dict(e.headers), e.read()


def _both(servers, path, body=None, form=None):
    return _post(servers["jax"], path, body, form), _post(servers["port"], path, body, form)


def _samples(ctype, raw):
    if ctype == "audio/pcm":
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if raw[:4] == b"RIFF" and raw[4:8] == b"\xff\xff\xff\xff":  # the streamed header
        return np.frombuffer(raw[44:], np.int16).astype(np.float32) / 32768.0
    return jwav.read_wav(raw)[0]


WAV_1S = jwav.write_wav(_speech(5, 0.8, silence_s=0.2), 16_000)
WAVS = {"1s": WAV_1S,  # one chunk of whisper-test, three below
        "3chunks": jwav.write_wav(np.tile(_speech(6, 1.0, silence_s=0.0), 3), 16_000)}


@pytest.mark.parametrize("path,fmt,wav", [
    ("/v1/audio/transcriptions", "json", "1s"),
    ("/v1/audio/transcriptions", "text", "1s"),
    ("/v1/audio/transcriptions", "verbose_json", "3chunks"),
    ("/v1/audio/translations", "verbose_json", "1s"),
])
def test_transcription_routes_match_jax_server(servers, path, fmt, wav):
    form = {"file": ("a.wav", WAVS[wav]), "model": (None, b"stt"), "response_format": (None, fmt.encode())}
    (js, jct, _, jraw), (ps, pct, _, praw) = _both(servers, path, form=form)
    assert js == ps == 200 and jct == pct
    if fmt == "text":
        assert praw == jraw
        return
    want, got = json.loads(jraw), json.loads(praw)
    assert got == want, (got, want)


@pytest.mark.parametrize("path,body", [
    ("/v1/audio/speech", {"model": "voice", "input": "hello there", "voice": "voice-1"}),
    ("/tts", {"model": "voice", "input": "hi", "response_format": "pcm"}),
    ("/v1/audio/speech", {"model": "mms", "input": "Hello world. How are you?"}),
    ("/v1/audio/speech/stream", {"model": "voice", "input": "stream me " * 6}),
    ("/v1/audio/speech/stream", {"model": "mms", "input": "One. Two? Three!"}),
    ("/v1/text-to-speech/voice-1", {"model": "voice", "text": "eleven"}),
    ("/v1/sound-generation", {"model_id": "voice", "text": "a bell", "seed": 3}),
])
def test_speech_routes_match_jax_server(servers, path, body):
    (js, jct, jh, jraw), (ps, pct, ph, praw) = _both(servers, path, body)
    assert js == ps == 200 and jct == pct, (js, ps, jct, pct)
    assert jh.get("X-Sample-Rate") == ph.get("X-Sample-Rate")
    if path.endswith("/stream"):
        assert praw[:44] == jraw[:44]  # the streaming WAV header
    want, got = _samples(jct, jraw), _samples(pct, praw)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=PCM_TOL, rtol=0)


@pytest.mark.parametrize("model", ["vad", "energy"])
def test_vad_route_matches_jax_server(servers, model):
    x = np.concatenate([np.zeros(8000, np.float32), _speech(7, 1.0)])
    body = {"model": model, "audio": x.tolist(), "sample_rate": 16_000}
    (js, _, _, jraw), (ps, _, _, praw) = _both(servers, "/v1/vad", body)
    assert js == ps == 200
    assert json.loads(praw) == json.loads(jraw) and json.loads(praw)["segments"]


@pytest.mark.parametrize("path,body,form", [
    ("/v1/audio/transcriptions", None, {"model": (None, b"stt")}),
    ("/v1/audio/transcriptions", None, {"file": ("a.wav", b"not a wav"), "model": (None, b"stt")}),
    ("/v1/audio/speech", {"model": "voice"}, None),
    ("/v1/audio/speech", {"model": "voice", "input": "x", "response_format": "mp3"}, None),
    ("/v1/audio/speech", {"model": "chat", "input": "x"}, None),
    ("/v1/audio/speech/stream", {"model": "voice"}, None),
    ("/v1/sound-generation", {"model": "voice", "text": "x", "seed": "abc"}, None),
    ("/v1/sound-generation", {"model": "voice"}, None),
    ("/v1/vad", {"model": "vad", "audio": []}, None),
    ("/v1/vad", {"model": "stt", "audio": [0.0, 0.1]}, None),
])
def test_audio_errors_match_jax_server(servers, path, body, form):
    (js, _, _, jraw), (ps, _, _, praw) = _both(servers, path, body, form)
    assert ps == js and js >= 400, (js, ps, jraw, praw)
    assert json.loads(praw)["error"]["message"] == json.loads(jraw)["error"]["message"]


def test_musicgen_backend_fails_naming_its_item(tmp_path):
    (tmp_path / "m.yaml").write_text(yaml.safe_dump(
        {"name": "m", "backend": "musicgen", "model": "facebook/musicgen-small"}))
    tm = ModelManager(ApplicationConfig(models_dir=str(tmp_path)), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue A item 13 \(e\)"):
            tm.get("m")
    finally:
        tm.shutdown()


def test_cli_transcribe_and_tts_print_the_jax_clis_answers(tmp_path, capsys, monkeypatch):
    """`transcribe` and `tts` on checkpoints of the JAX package's weights:
    the same transcript, and a WAV within 2 LSB of the JAX CLI's."""
    from localai_tpu.__main__ import main as jax_main
    from localai_tpu_torch.__main__ import main as port_main

    write_audio_models(tmp_path)
    monkeypatch.setattr(TT, "first_phase", jax_first_phase)
    wav = tmp_path / "in.wav"
    wav.write_bytes(WAV_1S)
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        assert main(["transcribe", str(wav), "--model", "stt", "--models-path", str(tmp_path),
                     *extra]) == 0
        text = capsys.readouterr().out
        dst = tmp_path / f"{name}.wav"
        assert main(["tts", "hello cli", "--model", "voice", "--models-path", str(tmp_path),
                     "--output", str(dst), *extra]) == 0
        assert capsys.readouterr().out.strip() == str(dst)
        out[name] = (text, jwav.read_wav(str(dst)))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1][1] == out["jax"][1][1]
    np.testing.assert_allclose(out["port"][1][0], out["jax"][1][0], atol=PCM_TOL, rtol=0)
