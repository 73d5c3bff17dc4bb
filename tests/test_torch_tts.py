"""The port's neural TTS (acoustic model, iSTFT, facade) and the
intelligibility eval against the JAX package's, on the CPU.

- ``istft`` against JAX's ``_istft`` on spectra whose DC and Nyquist bins
  have nonzero imaginary parts (JAX's CPU ``irfft`` ignores them; the port
  zeroes them), to atol 1e-6.
- ``synthesize`` with JAX's weights through the bridge, at a small config
  and at ``TTSConfig()``, on sentences through the port's G2P: ``n_frames``
  equal, durations to atol 1e-5 (float32 through a four-layer encoder), the
  waveform to atol 1e-4 (eight transformer layers, an FFT and an
  overlap-add summed in other orders; the values are at most about 0.1).  A
  last-bit difference in ``cumsum(durations)`` could move ``n_frames`` by
  one where ``ends[-1]`` sits at a half: each case prints that margin.
- The facade contracts of tests/test_tts.py on the port: the say queue's
  order, beeps, speed, voice packs (written by either package, loaded in
  the other), and the ``AlphanumericListener`` contract; the ``klatt`` and
  ``neural-pack`` voices route as JAX's facade routes them
  (tests/test_torch_klatt.py holds the Klatt waveforms).
- ``eval/tts_intelligibility.evaluate`` with stubs gives JAX's CER.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.eval import tts_intelligibility as jti
from moonshine_tpu.models import tts as jtm
from moonshine_tpu.tts import facade as jfacade
from moonshine_tpu.tts.g2p import GraphemeToPhonemizer as JaxG2P
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.eval import tts_intelligibility as tti
from moonshine_tpu_torch.models import tts as ttm
from moonshine_tpu_torch.tts import facade as tfacade

SMALL = jtm.TTSConfig(dim=64, encoder_layers=1, decoder_layers=1, heads=4)
DUR_TOL = dict(atol=1e-5, rtol=0)
WAV_TOL = dict(atol=1e-4, rtol=0)
SENTENCES = ["the quick brown fox jumps over the lazy dog", "hello world",
             "pack my box with five dozen liquor jugs"]



def _tree(p):
    return jax.tree.map(np.asarray, p)


def _small_tts(**kw):
    return tfacade.TextToSpeech(cfg=ttm.TTSConfig(*SMALL), device="cpu", **kw)


@pytest.fixture(scope="module", params=["small", "full"])
def models(request):
    cfg = SMALL if request.param == "small" else jtm.TTSConfig()
    jparams = jtm.init_params(cfg, jax.random.PRNGKey(0))
    style = np.array(jtm.make_voice(jax.random.PRNGKey(1)))
    return cfg, jparams, weights.tts_params_from_jax_numpy(_tree(jparams), "cpu"), style


def test_ipa_to_ids_matches_jax():
    for ipa in ["kæt", "tʃaɪ", "hɛloʊ wɝld", "ðˈə kwˈɪk", "?!", "x" * 400]:
        assert ttm.ipa_to_ids(ipa) == jtm.ipa_to_ids(ipa)
    assert ttm.VOCAB == jtm.VOCAB and ttm.PHONEME_TO_ID == jtm.PHONEME_TO_ID


def test_istft_matches_jax_with_imaginary_dc_and_nyquist():
    rng = np.random.default_rng(0)
    t, n_bins = 12, ttm.N_FFT // 2 + 1
    re = rng.standard_normal((t, n_bins)).astype(np.float32)
    im = rng.standard_normal((t, n_bins)).astype(np.float32)
    assert np.abs(im[:, 0]).min() > 0 and np.abs(im[:, -1]).min() > 0
    ref = np.asarray(jtm._istft(jnp.asarray(re), jnp.asarray(im)))
    ours = ttm.istft(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    assert ours.shape == ref.shape == (t * ttm.HOP,)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    # JAX ignores the two imaginary parts: zeroing them changes nothing.
    im0 = im.copy()
    im0[:, [0, -1]] = 0.0
    np.testing.assert_array_equal(np.asarray(jtm._istft(jnp.asarray(re), jnp.asarray(im0))), ref)


def test_overlap_add_is_the_scatter_sum():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((7, ttm.N_FFT)).astype(np.float32)
    idx = (np.arange(7)[:, None] * ttm.HOP + np.arange(ttm.N_FFT)[None, :]).reshape(-1)
    ref = np.zeros(7 * ttm.HOP + ttm.N_FFT, np.float32)
    np.add.at(ref, idx, frames.reshape(-1))
    ours = ttm.overlap_add(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(ours, ref[: ours.shape[0]], atol=1e-6, rtol=0)
    assert not ref[ours.shape[0]:].any()


def test_softplus_is_jax_softplus():
    x = np.array([-100.0, -30.0, -1.0, 0.0, 1e-3, 1.0, 19.0, 20.0, 21.0, 40.0, 100.0], np.float32)
    np.testing.assert_allclose(ttm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), atol=1e-6, rtol=0)


def _phonemes(text: str):
    ids = ttm.ipa_to_ids(JaxG2P("en").text_to_ipa(text).replace(" ", ""))
    phon = np.zeros(ttm.MAX_PHONEMES, np.int32)
    phon[: len(ids)] = ids
    return phon, len(ids)


@pytest.mark.parametrize("speed", [1.0, 1.7])
def test_synthesize_matches_jax(models, speed):
    cfg, jparams, model, style = models
    for text in SENTENCES[: 1 if cfg.dim == 256 else 3]:
        phon, n = _phonemes(text)
        ref = jtm.synthesize(jparams, cfg, jnp.asarray(phon), n, jnp.asarray(style), speed=speed)
        ours = ttm.synthesize(model, ttm.TTSConfig(*cfg), torch.from_numpy(phon), n,
                              torch.from_numpy(style), speed=speed)
        ends = np.cumsum(np.asarray(ref.durations))[-1]
        print(f"{cfg.dim} wide, speed {speed}, {text!r}: ends[-1] {ends:.6f}, "
              f"{abs(ends - (np.floor(ends) + 0.5)):.6f} from the nearest half")
        assert int(ours.n_frames) == int(ref.n_frames)
        np.testing.assert_allclose(ours.durations.numpy(), np.asarray(ref.durations), **DUR_TOL)
        k = int(ref.n_frames) * ttm.HOP
        np.testing.assert_allclose(ours.waveform.numpy()[:k], np.asarray(ref.waveform)[:k],
                                   **WAV_TOL)
        np.testing.assert_allclose(ours.waveform.numpy(), np.asarray(ref.waveform), **WAV_TOL)


def test_init_params_shapes_match_jax():
    """The port's initializer builds JAX's tree (names and shapes), with
    q, k, v and o equal in every layer as JAX draws them."""
    jtree = _tree(jtm.init_params(SMALL, jax.random.PRNGKey(0)))
    ours = weights.tts_params_to_numpy(
        ttm.init_params(ttm.TTSConfig(*SMALL), torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(np.shape, jtree) == jax.tree.map(np.shape, ours)
    for tree in (jtree, ours):
        attn = tree["encoder"]["layers"]["attn"]
        for k in ("k", "v", "o"):
            np.testing.assert_array_equal(attn[k]["w"], attn["q"]["w"])


def test_facade_synthesize_matches_jax():
    """Through both facades (G2P, ids, normalisation, volume) at the small
    config; the full width runs through the facade in chip_smoke.py."""
    cfg = SMALL
    jparams = jtm.init_params(cfg, jax.random.PRNGKey(0))
    style = np.asarray(jtm.make_voice(jax.random.PRNGKey(1)))
    model = weights.tts_params_from_jax_numpy(_tree(jparams), "cpu")
    ref = jfacade.TextToSpeech(params=jparams, cfg=cfg).voice("v").load({"v": style})
    ours = tfacade.TextToSpeech(params=model, cfg=ttm.TTSConfig(*cfg), device="cpu").voice(
        "v").load({"v": style})
    for text in SENTENCES:
        for opts in (None, tfacade.TTSOptions(speed=1.3, volume=0.5, normalize=False)):
            w1, sr1 = ours.synthesize(text, opts)
            w2, sr2 = ref.synthesize(
                text, None if opts is None else jfacade.TTSOptions(**opts.__dict__))
            assert sr1 == sr2 == 24000 and w1.shape == w2.shape
            np.testing.assert_allclose(w1, w2, **WAV_TOL)


# -- facade contracts (tests/test_tts.py) -------------------------------------

def test_facade_synthesize_and_queue():
    played = []
    tts = _small_tts().voice("test_voice").play_with(
        lambda wav, sr: played.append((len(wav), sr))).load()
    wav, sr = tts.synthesize("hi there")
    assert sr == tfacade.SAMPLE_RATE and wav.size > 0
    assert np.max(np.abs(wav)) <= 1.0 + 1e-5  # normalized
    tts.say("one")
    tts.say("two")
    tts.wait_for_all()
    tts.stop()
    assert len(played) == 2 and all(sr == tfacade.SAMPLE_RATE for _, sr in played)


def test_facade_requires_load():
    with pytest.raises(RuntimeError, match="load"):
        _small_tts().synthesize("x")


def test_facade_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfacade.TextToSpeech()


def test_facade_speed_option():
    tts = _small_tts().load()
    w1, _ = tts.synthesize("a longer sentence to say", tfacade.TTSOptions(speed=1.0))
    w2, _ = tts.synthesize("a longer sentence to say", tfacade.TTSOptions(speed=2.0))
    assert len(w2) < len(w1)


@pytest.mark.parametrize("voice", ["klatt", "klatt_fast", "neural-pack", "neural-pack-en"])
def test_klatt_and_pack_voices_route_as_jax(voice):
    """The voices that raised until ROADMAP item 12 was ported now route as
    JAX's facade routes them: each call gives JAX's sample rate and length,
    or raises what JAX's raises (the missing voice pack's
    FileNotFoundError), never NotImplementedError and never another voice."""
    tts = _small_tts().voice(voice).load()
    jtts = jfacade.TextToSpeech().voice(voice).load()
    for name, arg in (("synthesize", "hello"), ("synthesize_from_phonemes", "hɛloʊ")):
        try:
            ref, ref_sr = getattr(jtts, name)(arg)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                getattr(tts, name)(arg)
            continue
        wav, sr = getattr(tts, name)(arg)
        assert sr == ref_sr == (22050 if voice.startswith("klatt") else 16000)
        assert wav.shape == ref.shape and wav.dtype == np.float32


def test_split_say_utterances_matches_jax():
    for text in ["One. Two! Three? Four: five", "pi is 3.14 okay", "   ", "plain",
                 "Trailing space. ", "a.b. c"]:
        assert tfacade.split_say_utterances(text) == jfacade.split_say_utterances(text)


def test_say_pipeline_splits_and_overlaps():
    played = []
    gate = threading.Event()

    def slow_play(wav, sr):
        played.append(len(wav))
        gate.set()

    tts = _small_tts().play_with(slow_play).load()
    tts.say("First clause. Second clause! Third?")
    tts.wait()
    tts.stop()
    assert len(played) == 3 and gate.is_set() and not tts.is_talking()


def test_play_error_and_success_beeps_ordered():
    played = []
    tts = _small_tts().play_with(lambda wav, sr: played.append(np.asarray(wav))).load()
    tts.say("hello")
    tts.play_error()
    tts.play_success()
    tts.wait()
    tts.stop()
    assert len(played) == 3
    for kind, wav in (("error", played[1]), ("success", played[2])):
        np.testing.assert_array_equal(wav, tfacade._make_beep(kind))
        np.testing.assert_array_equal(wav, jfacade._make_beep(kind))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_voice_pack_across_packages(tmp_path, writer):
    jparams = jtm.init_params(SMALL, jax.random.PRNGKey(7))
    voices = {"af_custom": np.asarray(jtm.make_voice(jax.random.PRNGKey(8))),
              "am_other": np.asarray(jtm.make_voice(jax.random.PRNGKey(9)))}
    path = tmp_path / "pack.safetensors"
    if writer == "jax":
        jfacade.save_voice_pack(path, voices, params=jparams)
    else:
        tfacade.save_voice_pack(path, voices,
                                params=weights.tts_params_from_jax_numpy(_tree(jparams), "cpu"))
    tparams, tvoices = tfacade.load_voice_pack(path, ttm.TTSConfig(*SMALL), device="cpu")
    jp2, jvoices = jfacade.load_voice_pack(path, SMALL)
    assert set(tvoices) == set(jvoices) == set(voices)
    for name in voices:
        np.testing.assert_array_equal(tvoices[name], voices[name])
        np.testing.assert_array_equal(jvoices[name], voices[name])
    for a, b in zip(jax.tree.leaves(_tree(jparams)),
                    jax.tree.leaves(weights.tts_params_to_numpy(tparams))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(_tree(jparams)), jax.tree.leaves(_tree(jp2))):
        np.testing.assert_array_equal(a, b)
    ours = _small_tts().voice("af_custom").load(str(path))
    ref = jfacade.TextToSpeech(cfg=SMALL).voice("af_custom").load(str(path))
    w1, sr = ours.synthesize("hello")
    np.testing.assert_allclose(w1, ref.synthesize("hello")[0], **WAV_TOL)
    assert sr == 24000 and len(w1) > 0
    # A voices-only pack leaves the model random.
    path2 = tmp_path / "voices_only.safetensors"
    tfacade.save_voice_pack(path2, voices)
    p3, v3 = tfacade.load_voice_pack(path2, device="cpu")
    assert p3 is None and set(v3) == set(voices)
    assert set(jfacade.load_voice_pack(path2)[1]) == set(voices)


def test_tts_backend_works_with_alphanumeric_listener():
    """The facade satisfies the AlphanumericListener tts contract."""
    from moonshine_tpu_torch.agent.alphanumeric import AlphanumericListener
    from moonshine_tpu_torch.core.types import TranscriptLine
    from moonshine_tpu_torch.pipeline.transcriber import LineCompleted

    played = []
    tts = _small_tts().play_with(lambda wav, sr: played.append(len(wav))).load()
    lst = AlphanumericListener(lambda e: None, tts=tts)
    lst(LineCompleted(line=TranscriptLine(id=0, text="bravo"), stream_id=0))
    lst(LineCompleted(line=TranscriptLine(id=1, text="xyzzy"), stream_id=0))
    tts.wait()
    tts.stop()
    assert lst.text == "b"
    assert len(played) == 2  # "bee" echo + error beep


# -- eval/tts_intelligibility ----------------------------------------------

def _stub_synth(text):
    return np.full(len(text) * 10, 0.1, np.float32), 24000


def _stub_asr(wav, sr):
    n = len(wav) // 10
    return "the quick brown fax jumps over the lazy dog"[: n] if n > 20 else "shee sells"


def test_intelligibility_matches_jax():
    ours = tti.evaluate(_stub_synth, _stub_asr)
    ref = jti.evaluate(_stub_synth, _stub_asr)
    assert ours.cer == ref.cer and ours.per_sentence == ref.per_sentence
    assert ours.summary() == ref.summary()
    assert tti.DEFAULT_SENTENCES == jti.DEFAULT_SENTENCES
    exact = tti.evaluate(lambda t: (np.zeros(4, np.float32), 16000), lambda w, sr: "a b",
                         sentences=["A b.", "ab"])
    assert exact.cer == 0.0
