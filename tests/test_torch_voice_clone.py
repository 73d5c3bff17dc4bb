"""The port's voice cloner (``models/voice_clone.py``), ONNX vocoder
(``models/tts_onnx.py``) and capture session (``tts/voice_clone_api.py``)
against the JAX package's, on the CPU.

- ``compute_mel`` to atol 1e-4 and rtol 2e-4 (the log-mel tolerance of
  tests/test_torch_mel.py, rtol doubled for frames of 1,024 samples, twice
  the terms of the 512-sample frames there; the log's derivative is large
  in the low bins); ``_time_embedding`` to atol 1e-5.
- ``flow_matching_sample`` with JAX's latent ``x0`` (``jax.random.normal``
  of the seed, which torch cannot draw) on bridged random weights, at a
  small config and at ``CloneConfig()``: the mel to atol 2e-5.  Guidance
  3.0 multiplies the conditional/unconditional difference at each of the
  8 Euler steps, so the float32 differences of the velocity grow; the
  largest difference measured was 3.0e-6 at ``CloneConfig()`` (values up
  to 5.9), and each case prints its own.
- ``vocode`` (the iSTFT head) to atol 1e-5; ``VoiceCloner`` end to end
  (reference clip, transcript through the port's G2P, the same ``x0``):
  the same length and the waveform to atol 1e-4 (5.0e-5 measured at
  ``CloneConfig()``: the prompt's log-mel differs by up to 2e-4).
- ``OnnxVocoder`` over the vocoder exports of tests/test_tts_onnx.py
  (torch.onnx as that file exports them): the port's output against
  JAX's and torch's to atol 2e-4, and ``VoiceCloner(vocoder_onnx=...)``.
- ``compress_long_pauses``: equal arrays.
- ``VoiceClone``'s capture and finalize contract of
  tests/test_alphanumeric.py, then its ``say`` through a port cloner
  against JAX's with the same reference audio and words.
- ``weights``' bridge round-trips the JAX tree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import test_tts_onnx as onnx_cases
from moonshine_tpu.core.types import TranscriptWord as JaxWord
from moonshine_tpu.models import tts_onnx as jto
from moonshine_tpu.models import voice_clone as jvc
from moonshine_tpu.tts import voice_clone_api as japi
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.types import TranscriptWord
from moonshine_tpu_torch.models import tts_onnx as tto
from moonshine_tpu_torch.models import voice_clone as tvc
from moonshine_tpu_torch.tts import voice_clone_api as tapi

SMALL = jvc.CloneConfig(dim=64, text_layers=1, fm_layers=1, heads=4)
MEL_TOL = dict(atol=1e-4, rtol=2e-4)
SAMPLE_TOL = dict(atol=2e-5, rtol=0)
VOCODE_TOL = dict(atol=1e-5, rtol=0)
WAV_TOL = dict(atol=1e-4, rtol=0)
ONNX_TOL = dict(atol=2e-4, rtol=1e-3)


def _tree(p):
    return jax.tree.map(np.asarray, p)


def make_reference(seconds=2.0, sr=jvc.SAMPLE_RATE):
    t = np.arange(int(sr * seconds)) / sr
    return (0.2 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def model_sets():
    out = {}
    for width, cfg in (("small", SMALL), ("full", jvc.CloneConfig())):
        jparams = jvc.init_params(cfg, jax.random.PRNGKey(0))
        out[width] = cfg, jparams, weights.voice_clone_params_from_jax_numpy(_tree(jparams),
                                                                             "cpu")
    return out


@pytest.fixture(params=["small", "full"])
def models(request, model_sets):
    return model_sets[request.param]


def _x0(seed: int) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (jvc.MAX_FRAMES, jvc.N_MELS)))


def test_compute_mel_and_time_embedding_match_jax():
    audio = make_reference(1.3)[None]
    ref = np.asarray(jvc.compute_mel(jnp.asarray(audio)))
    ours = tvc.compute_mel(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape and ref.shape[2] == 100
    np.testing.assert_allclose(ours, ref, **MEL_TOL)
    t = np.array([0.0, 0.0625, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(tvc._time_embedding(torch.from_numpy(t)).numpy(),
                               np.asarray(jvc._time_embedding(jnp.asarray(t))), atol=1e-5)


def _conditions(cfg, seed=0):
    rng = np.random.default_rng(seed)
    text = (rng.standard_normal((jvc.MAX_FRAMES, cfg.dim)) * 0.5).astype(np.float32)
    prompt = np.zeros((jvc.MAX_FRAMES, jvc.N_MELS), np.float32)
    prompt[:200] = rng.standard_normal((200, jvc.N_MELS)).astype(np.float32) * 0.3
    fmask = np.arange(jvc.MAX_FRAMES) < 700
    return text, prompt, fmask


def test_flow_matching_sample_matches_jax(models):
    cfg, jparams, model = models
    text, prompt, fmask = _conditions(cfg)
    ref = np.asarray(jvc.flow_matching_sample(jparams, cfg, jnp.asarray(text),
                                              jnp.asarray(prompt), jnp.asarray(fmask),
                                              jnp.asarray(5, jnp.uint32)))
    ours = tvc.flow_matching_sample(model, tvc.CloneConfig(*cfg), torch.from_numpy(text),
                                    torch.from_numpy(prompt), torch.from_numpy(fmask), 5,
                                    x0=torch.from_numpy(_x0(5))).numpy()
    print(f"{cfg.dim} wide: mel max_abs_err {np.abs(ours - ref).max():.3e} "
          f"(values up to {np.abs(ref).max():.3f})")
    np.testing.assert_allclose(ours, ref, **SAMPLE_TOL)
    assert not ours[700:].any()


def test_seeded_latent_is_the_same_on_every_call():
    a, b = tvc.initial_latent(7, 16), tvc.initial_latent(7, 16)
    assert torch.equal(a, b) and not torch.equal(a, tvc.initial_latent(8, 16))


def test_vocode_matches_jax(models):
    cfg, jparams, model = models
    mel = np.random.default_rng(1).standard_normal((40, jvc.N_MELS)).astype(np.float32)
    ref = np.asarray(jvc.vocode(jparams, jnp.asarray(mel)))
    ours = tvc.vocode(model, torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape == (40 * jvc.HOP,)
    np.testing.assert_allclose(ours, ref, **VOCODE_TOL)


def test_istft_is_jax_istft_24k():
    rng = np.random.default_rng(2)
    re, im = (rng.standard_normal((9, jvc.N_FFT // 2 + 1)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tvc._istft_24k(torch.from_numpy(re), torch.from_numpy(im)).numpy(),
                               np.asarray(jvc._istft_24k(jnp.asarray(re), jnp.asarray(im))),
                               atol=1e-6)


def _cloners(cfg, jparams, model, **kw):
    j = jvc.VoiceCloner(jparams, cfg, **{k: v for k, v in kw.items() if k != "device"})
    t = tvc.VoiceCloner(model, tvc.CloneConfig(*cfg), device="cpu",
                        **{k: v for k, v in kw.items() if k != "device"})
    return j, t


@pytest.mark.parametrize("width,text", [("small", "hello world"),
                                        ("small", "this is a much longer sentence"),
                                        ("full", "hello world")])
def test_voice_cloner_matches_jax(model_sets, width, text):
    cfg, jparams, model = model_sets[width]
    j, t = _cloners(cfg, jparams, model)
    for c in (j, t):
        c.set_reference(make_reference(), "testing one two")
    np.testing.assert_allclose(t._prompt_mel, j._prompt_mel, **MEL_TOL)
    assert t._prompt_ipa == j._prompt_ipa
    ref = j.synthesize(text)
    ours = t.synthesize(text, x0=torch.from_numpy(_x0(j.seed)))
    print(f"{cfg.dim} wide {text!r}: {len(ours)} samples, max_abs_err "
          f"{np.abs(ours - ref).max() if len(ours) == len(ref) else float('nan'):.3e}")
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **WAV_TOL)


def test_voice_cloner_contract():
    t = tvc.VoiceCloner(cfg=tvc.CloneConfig(*SMALL), device="cpu")
    with pytest.raises(RuntimeError):
        t.synthesize("hello")
    t.set_reference(make_reference(1.0, 16000), "testing", sample_rate=16000)
    w1, w2 = t.synthesize("hello world"), t.synthesize("hello world")
    np.testing.assert_array_equal(w1, w2)  # the seeded latent
    t.seed = 123
    assert not np.array_equal(w1, t.synthesize("hello world"))
    assert np.isfinite(w1).all() and np.abs(w1).max() <= 1.0


def test_compress_long_pauses_matches_jax():
    sr = 24000
    speech = 0.3 * np.sin(2 * np.pi * 300 * np.arange(sr // 2) / sr).astype(np.float32)
    cases = [np.concatenate([speech, np.zeros(sr, np.float32), speech]),
             np.concatenate([speech, speech]), np.zeros(0, np.float32),
             np.ones(100, np.float32) * 0.1,
             np.concatenate([np.zeros(sr // 3, np.float32), speech, np.zeros(sr, np.float32)])]
    for wav in cases:
        np.testing.assert_array_equal(tvc.compress_long_pauses(wav, sr),
                                      jvc.compress_long_pauses(wav, sr))


def test_bridge_round_trip(models):
    _, jparams, model = models
    back = weights.flatten_tree(weights.voice_clone_params_to_numpy(model))
    ref = weights.flatten_tree(_tree(jparams))
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_init_params_shapes_match_jax():
    jtree = weights.flatten_tree(_tree(jvc.init_params(SMALL, jax.random.PRNGKey(0))))
    model = tvc.init_params(tvc.CloneConfig(*SMALL), torch.Generator().manual_seed(0), "cpu")
    ours = weights.flatten_tree(weights.voice_clone_params_to_numpy(model))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in jtree.items()}
    attn = model.fm_layers[0].attn
    assert all(torch.equal(attn.q.weight, getattr(attn, n).weight) for n in "kvo")


# -- the ONNX vocoder --------------------------------------------------------

def _vocos():
    class Vocoder(torch.nn.Module):  # Vocos backbone and a linear head to samples
        def __init__(self):
            super().__init__()
            self.body = torch.nn.Sequential(onnx_cases.VocosBlock(), onnx_cases.VocosBlock())
            self.head = torch.nn.Linear(24, 8)

        def forward(self, mel):  # [B, 24, T] -> [B, 8 T]
            return self.head(self.body(mel).transpose(1, 2)).flatten(1)

    return Vocoder(), 24, 8


VOCODERS = {
    "mini_hifigan": lambda: (onnx_cases.MiniHiFiGAN(), 20, 16),
    "hifigan_hop256": lambda: (onnx_cases.MiniHiFiGAN(n_mels=100, ch=16, ups=(4, 4, 4, 4)),
                               100, 256),
    "vocos": _vocos,
}


def _export(name, tmp_path):
    torch.manual_seed(5)
    module, n_mels, hop = VOCODERS[name]()
    module.eval()
    path = str(tmp_path / f"{name}.onnx")
    torch.onnx.export(module, (torch.randn(1, n_mels, 32),), path, opset_version=17,
                      dynamo=False, input_names=["mel"], dynamic_axes={"mel": {2: "frames"}})
    return module, n_mels, hop, path


@pytest.mark.parametrize("name", list(VOCODERS))
def test_onnx_vocoder_matches_jax_and_torch(name, tmp_path):
    module, n_mels, hop, path = _export(name, tmp_path)
    mel = np.random.default_rng(3).standard_normal((n_mels, 25)).astype(np.float32)
    ours = tto.OnnxVocoder.from_onnx(path, device="cpu")(mel)
    ref = jto.OnnxVocoder.from_onnx(path)(mel)
    with torch.no_grad():
        expected = module(torch.from_numpy(mel)[None]).numpy().reshape(-1)
    assert ours.shape == ref.shape == expected.shape == (25 * hop,)
    np.testing.assert_allclose(ours, ref, **ONNX_TOL)
    np.testing.assert_allclose(ours, expected, **ONNX_TOL)
    batch = np.stack([mel, mel[:, ::-1].copy()])
    np.testing.assert_allclose(tto.OnnxVocoder.from_onnx(path, device="cpu")(batch),
                               jto.OnnxVocoder.from_onnx(path)(batch), **ONNX_TOL)


def test_voice_cloner_with_onnx_vocoder_matches_jax(tmp_path):
    _, _, _, path = _export("hifigan_hop256", tmp_path)
    jparams = jvc.init_params(SMALL, jax.random.PRNGKey(0))
    model = weights.voice_clone_params_from_jax_numpy(_tree(jparams), "cpu")
    j, t = _cloners(SMALL, jparams, model, vocoder_onnx=path)
    rng = np.random.RandomState(0)
    ref_audio = rng.randn(jvc.SAMPLE_RATE).astype(np.float32) * 0.1
    for c in (j, t):
        c.set_reference(ref_audio, "reference clip")
    ref = j.synthesize("hello there")
    ours = t.synthesize("hello there", x0=torch.from_numpy(_x0(j.seed)))
    assert ours.shape == ref.shape and len(ours) > 0 and np.abs(ours).max() <= 1.0
    np.testing.assert_allclose(ours, ref, **ONNX_TOL)


# -- the capture session ---------------------------------------------------

class AlwaysSpeech:
    def __call__(self, hops):
        return np.ones(hops.shape[0], np.float32)


WORDS = [("hello", 0.3, 0.9), ("there", 1.0, 1.6), ("friend", 3.8, 4.4)]


def test_voice_clone_capture_and_finalize():
    progress = []
    vc = tapi.VoiceClone(AlwaysSpeech(), on_progress=progress.append)
    with pytest.raises(RuntimeError):
        vc.finalize()
    p = vc.add_audio(np.full(16000 * 6, 0.1, np.float32))
    assert p.ready
    assert progress and progress[-1].ready
    clip = vc.finalize(words=[TranscriptWord(*w) for w in WORDS])
    assert clip.is_complete
    assert vc.transcript == "hello there friend"
    assert clip.audio.size > 0
    with pytest.raises(RuntimeError, match="No cloner"):
        vc.say("hi")


def test_voice_clone_session_matches_jax():
    jparams = jvc.init_params(SMALL, jax.random.PRNGKey(0))
    model = weights.voice_clone_params_from_jax_numpy(_tree(jparams), "cpu")
    j, t = _cloners(SMALL, jparams, model)
    audio = make_reference(7.0, 16000) + np.float32(0.05)
    sessions = []
    for api, cloner in ((japi, j), (tapi, t)):
        s = api.VoiceClone(AlwaysSpeech(), cloner)
        progress = [s.add_audio(audio[i:i + 8000]) for i in range(0, len(audio), 8000)]
        sessions.append((s, progress))
    (js, jp), (ts, tp) = sessions
    assert [(p.speech_seconds, p.ready) for p in tp] == [(p.speech_seconds, p.ready) for p in jp]
    jclip = js.finalize(words=[JaxWord(*w) for w in WORDS])
    tclip = ts.finalize(words=[TranscriptWord(*w) for w in WORDS])
    assert ts.transcript == js.transcript
    np.testing.assert_array_equal(tclip.audio, jclip.audio)
    ref = js.say("good morning")
    ours = t.synthesize("good morning", x0=torch.from_numpy(_x0(j.seed)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **WAV_TOL)
