"""The port's diarization models and pipelines (segmentation, speaker
embedding, ``SpeakerDiarizer``, VBx, speech clips, DER and speaker-ID
evals, the pipeline ``Transcriber`` with speakers) against the JAX
package's, on the CPU, on seeded numpy inputs.

- Models at their only width (segmentation 128 wide, 2 layers, 4 heads;
  embedding 256 wide, 192-d) with JAX's weights through the bridge, on two
  10 s windows: activities, powerset logits and embeddings to atol 1e-4
  (a float32 log-mel, stride-2 and dilated convolutions summed in another
  order, a transformer; the values seen differ by about 1e-6).
- ``SpeakerDiarizer`` over the port's models against JAX's over JAX's, on a
  30 s synthetic two-speaker conversation (``chip_smoke.
  two_speaker_conversation``): every activity and embedding batch to 1e-4
  and the same turns, with the default threshold and with 0.005.  The
  random-weight embedding puts all speech within a few hundredths in
  cosine distance, so 0.7 joins everything; 0.005 splits it into two
  speakers, with the closest linkage decision 5.6e-4 from the threshold.
- The numpy pipelines (clustering, the oracle streams of
  tests/test_diarization.py, VBx of tests/test_vbx.py, speech clips of
  tests/test_speech_clip.py, DER, EER): the same inputs through both
  copies give equal results.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import Recorder, linkage_margin, two_speaker_conversation
from moonshine_tpu.core.config import TranscriberOptions as JaxOptions
from moonshine_tpu.core.config import VadOptions as JaxVadOptions
from moonshine_tpu.core.types import TranscriptLine as JaxLine
from moonshine_tpu.core.types import TranscriptWord as JaxWord
from moonshine_tpu.eval import der as jder
from moonshine_tpu.eval import speaker_id as jsid
from moonshine_tpu.models import diarization as jd
from moonshine_tpu.pipeline import diarization as jpd
from moonshine_tpu.pipeline import speech_clip as jclip
from moonshine_tpu.pipeline import transcriber as jtr
from moonshine_tpu.pipeline import vbx as jvbx
from moonshine_tpu.pipeline.backends import FakeBackend
from moonshine_tpu.pipeline.transcript_output import TranscriptOutput as JaxOutput
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import TranscriberOptions, VadOptions
from moonshine_tpu_torch.core.types import TranscriptLine, TranscriptWord
from moonshine_tpu_torch.eval import der as tder
from moonshine_tpu_torch.eval import speaker_id as tsid
from moonshine_tpu_torch.models import diarization as td
from moonshine_tpu_torch.pipeline import diarization as tpd
from moonshine_tpu_torch.pipeline import speech_clip as tclip
from moonshine_tpu_torch.pipeline import transcriber as ttr
from moonshine_tpu_torch.pipeline import vbx as tvbx
from moonshine_tpu_torch.pipeline.transcript_output import TranscriptOutput

TOL = dict(atol=1e-4, rtol=0)
SR = 16000


def _audio(*shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def models():
    """JAX's random models (the JAX API's seeds 2 and 3) and the port's
    copies of them."""
    jseg = jd.init_segmentation_params(jax.random.PRNGKey(2))
    jemb = jd.init_embedding_params(jax.random.PRNGKey(3))
    return (jseg, jemb, weights.segmentation_params_from_jax_numpy(_tree(jseg), "cpu"),
            weights.embedding_params_from_jax_numpy(_tree(jemb), "cpu"))


@pytest.fixture(scope="module")
def windows():
    audio, _ = two_speaker_conversation(20.0, seed=1)
    return np.stack([audio[:td.WINDOW_SAMPLES], audio[-td.WINDOW_SAMPLES:]])


# -- the bridge ------------------------------------------------------------

@pytest.mark.parametrize("which", ["segmentation", "embedding"])
def test_params_round_trip(models, which):
    jseg, jemb, tseg, temb = models
    ref, back = {"segmentation": (_tree(jseg), weights.segmentation_params_to_numpy(tseg)),
                 "embedding": (_tree(jemb), weights.embedding_params_to_numpy(temb))}[which]
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["segmentation", "embedding"])
def test_init_params_shapes_match_jax(which):
    gen = torch.Generator().manual_seed(0)
    if which == "segmentation":
        tree = weights.segmentation_params_to_numpy(td.init_segmentation_params(gen, device="cpu"))
        ref = _tree(jd.init_segmentation_params(jax.random.PRNGKey(0)))
        # JAX draws a layer's q, k, v and o from one key; the port keeps that.
        for name in "kvo":
            np.testing.assert_array_equal(tree["layers"]["attn"][name]["w"],
                                          tree["layers"]["attn"]["q"]["w"])
    else:
        tree = weights.embedding_params_to_numpy(td.init_embedding_params(gen, device="cpu"))
        ref = _tree(jd.init_embedding_params(jax.random.PRNGKey(0)))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, ref)


# -- the models ------------------------------------------------------------

def test_segmentation_matches_jax(models, windows):
    jseg, _, tseg, _ = models
    x = torch.from_numpy(windows)
    logits = td.segmentation_forward(tseg, x)
    assert logits.shape == (2, 251, len(td.POWERSET))
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        jd.segmentation_forward(jseg, jnp.asarray(windows))), **TOL)
    acts = td.segmentation_activations(tseg, x).numpy()
    ref = np.asarray(jd.segmentation_activations(jseg, jnp.asarray(windows)))
    assert acts.shape == (2, 251, td.MAX_LOCAL_SPEAKERS)
    np.testing.assert_allclose(acts, ref, **TOL)
    assert (acts > tpd.ACTIVITY_THRESHOLD).any(), "the window should carry some activity"


@pytest.mark.parametrize("weighting", ["none", "half", "zero_row"])
def test_embedding_matches_jax(models, windows, weighting):
    """Without frame weights, with half the frames, and with one row of
    zeros (it pools nothing: mean 0, std at its floor)."""
    _, jemb, _, temb = models
    n_mel = td.WINDOW_SAMPLES // td.MEL_HOP + 1
    w = None
    if weighting != "none":
        w = np.zeros((2, n_mel), np.float32)
        w[0, : n_mel // 2] = 1.0
        if weighting == "half":
            w[1, n_mel // 2:] = 0.5
    ref = np.asarray(jd.embedding_forward(jemb, jnp.asarray(windows),
                                          None if w is None else jnp.asarray(w)))
    out = td.embedding_forward(temb, torch.from_numpy(windows),
                               None if w is None else torch.from_numpy(w)).numpy()
    assert out.shape == (2, td.EMBED_DIM)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_powerset_tables_are_copies():
    assert td.POWERSET == jd.POWERSET
    np.testing.assert_array_equal(td.powerset_to_multilabel(), jd.powerset_to_multilabel())
    assert (td.WINDOW_SAMPLES, td.FRAMES_PER_SECOND, td.EMBED_DIM) == (
        jd.WINDOW_SAMPLES, jd.FRAMES_PER_SECOND, jd.EMBED_DIM)


# -- the diarizer with the real models -------------------------------------

def _diarizers(models, threshold):
    jseg, jemb, tseg, temb = models
    j = (Recorder(lambda b: np.asarray(jd.segmentation_activations(jseg, jnp.asarray(b)))),
         Recorder(lambda b, w: np.asarray(jd.embedding_forward(jemb, jnp.asarray(b),
                                                                jnp.asarray(w)))))
    t = (Recorder(lambda b: td.segmentation_activations(tseg, torch.from_numpy(b)).numpy()),
         Recorder(lambda b, w: td.embedding_forward(temb, torch.from_numpy(b),
                                                     torch.from_numpy(w)).numpy()))
    return (jpd.SpeakerDiarizer(*j, cluster_threshold=threshold), j,
            tpd.SpeakerDiarizer(*t, cluster_threshold=threshold), t)


def _turns(turns):
    return [(t.speaker_id, t.speaker_index, t.start_time, t.duration) for t in turns]


@pytest.mark.parametrize("threshold", [0.7, 0.005])
def test_diarizer_with_models_matches_jax(models, threshold):
    audio, _ = two_speaker_conversation(30.0, seed=0)
    jdz, jrec, tdz, trec = _diarizers(models, threshold)
    sid_j, sid_t = jdz.create_stream(), tdz.create_stream()
    history = []
    for i in range(0, len(audio), 2 * SR):
        jdz.add_audio(sid_j, audio[i:i + 2 * SR])
        tdz.add_audio(sid_t, audio[i:i + 2 * SR])
        history.append((_turns(tdz.get_turns(sid_t)), _turns(jdz.get_turns(sid_j))))
    out, ref = _turns(tdz.finish_stream(sid_t)), _turns(jdz.finish_stream(sid_j))
    for t_calls, j_calls in zip(trec, jrec):
        assert len(t_calls.calls) == len(j_calls.calls) > 0
        for (_, a), (_, b) in zip(t_calls.calls, j_calls.calls):
            np.testing.assert_allclose(a, b, **TOL)
    assert all(a == b for a, b in history)
    assert out == ref and out
    if threshold < 0.7:
        embs = np.concatenate([e for _, e in trec[1].calls])
        assert len({t[0] for t in out}) == 2
        assert linkage_margin(embs, threshold) > 1e-4


# -- clustering and the oracle streams: tests/test_diarization.py ----------

@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7, 1.5])
def test_cluster_embeddings_matches_jax(threshold):
    rng = np.random.default_rng(0)
    embs = np.concatenate([rng.normal(0, 0.3, (6, 16)) + np.eye(16)[0],
                           rng.normal(0, 0.3, (5, 16)) + np.eye(16)[1]])
    out = tpd.cluster_embeddings(embs, threshold)
    np.testing.assert_array_equal(out, jpd.cluster_embeddings(embs, threshold))
    assert tpd.cluster_embeddings(np.zeros((0, 8))).size == 0


class TwoSpeakerOracle:
    """tests/test_diarization.py's oracle: one local speaker per window;
    the embedding keyed to the sign of the window's audio."""

    def activities(self, batch):
        out = np.zeros((len(batch), 250, 3), np.float32)
        out[:, :, 0] = 0.9
        return out

    def embeddings(self, batch, weights):
        out = np.zeros((len(batch), 16), np.float32)
        for i, clip in enumerate(batch):
            out[i, 0 if clip.mean() > 0 else 1] = 1.0
        return out


def _oracle_audio():
    return np.concatenate([np.full(12 * SR, 0.5, np.float32), np.full(12 * SR, -0.5, np.float32)])


@pytest.mark.parametrize("mode", ["stream_2s", "stream_1s_cadence_1", "one_shot", "finish_twice"])
def test_oracle_diarizer_matches_jax(mode):
    runs = []
    for pd in (tpd, jpd):
        o = TwoSpeakerOracle()
        kw = {"cluster_cadence": 1.0} if mode == "stream_1s_cadence_1" else {}
        d = pd.SpeakerDiarizer(o.activities, o.embeddings, cluster_threshold=0.5, **kw)
        audio = _oracle_audio()
        if mode == "one_shot":
            runs.append(_turns(d.diarize(audio)))
            continue
        sid = d.create_stream()
        step = SR if mode == "stream_1s_cadence_1" else 2 * SR
        seen = []
        for i in range(0, len(audio), step):
            d.add_audio(sid, audio[i:i + step])
            seen.append(_turns(d.get_turns(sid)))
        seen.append(_turns(d.finish_stream(sid)))
        if mode == "finish_twice":
            seen.append(_turns(d.finish_stream(sid)))
        runs.append(seen)
    assert runs[0] == runs[1]
    final = runs[0] if mode == "one_shot" else runs[0][-1]
    assert len({t[0] for t in final}) == 2


def test_apply_speaker_turns_matches_jax():
    results = []
    for pd, out_cls, line_cls, word_cls in ((tpd, TranscriptOutput, TranscriptLine, TranscriptWord),
                                            (jpd, JaxOutput, JaxLine, JaxWord)):
        out = out_cls()
        out.ordered_line_ids = [0]
        out.add_or_update_line(line_cls(id=0, text="hello world", start_time=0.0, duration=4.0,
                                        words=[word_cls("hello", 0.5, 1.5),
                                               word_cls("world", 2.5, 3.5)]))
        turns = [pd.SpeakerTurn(0.0, 2.0, 7, 0), pd.SpeakerTurn(2.0, 5.0, 9, 1)]
        changed = pd.apply_speaker_turns_to_lines(turns, out)
        out.clear_update_flags()
        again = pd.apply_speaker_turns_to_lines(turns, out)
        spans = [(s.start_time, s.duration, s.speaker_id, s.start_char, s.end_char)
                 for s in out.get_line(0).speaker_spans]
        results.append((changed, again, spans))
    assert results[0] == results[1]
    assert results[0][2][1][3:] == (6, 11)


# -- VBx: tests/test_vbx.py ------------------------------------------------

def _plda(mod, dim, phi_scale=10.0):
    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(dim, dim))
    psi = phi_scale * np.exp(-np.arange(dim) / max(dim / 2, 1))
    return mod.PldaModel.from_arrays(mean1=np.zeros(dim), mean2=np.zeros(dim), lda=np.eye(dim),
                                     mu=np.zeros(dim), tr=q, psi=psi, lda_dim=dim)


def _speakers(seed, n_spk, per, dim, sep=3.0, noise=1.0):
    rng = np.random.RandomState(seed)
    means = rng.randn(n_spk, dim) * sep
    return np.concatenate([means[s] + rng.randn(per, dim) * noise for s in range(n_spk)])


def _vbx_case(mod, case):
    if case == "plda_transform":
        plda = _plda(mod, 16)
        return plda(np.random.RandomState(1).randn(10, 16)), plda.phi_between
    if case == "labels":
        return mod.vbx_labels(_speakers(2, 3, 20, 16), _plda(mod, 16),
                              mod.VbxParams(threshold=0.6, fa=0.5))
    if case == "oversplit_merge":
        plda = _plda(mod, 12, phi_scale=20.0)
        x = _speakers(3, 2, 30, 12, sep=4.0, noise=1.2)
        ahc = mod.ahc_centroid_init(x / np.linalg.norm(x, axis=1, keepdims=True), 0.15)
        fea = plda(x)
        gamma, pi, iters = mod.cluster_vbx(ahc, fea, plda.phi_between[:fea.shape[1]], fa=0.5)
        return ahc, gamma, pi, iters
    # the driver: a silent local speaker and the constrained assignment
    rng = np.random.RandomState(5)
    means = rng.randn(2, 10) * 4.0
    emb = np.zeros((6, 3, 10), np.float32)
    binarized = np.zeros((6, 20, 3), np.float32)
    for c in range(6):
        emb[c, 0] = means[0] + rng.randn(10)
        emb[c, 1] = means[1] + rng.randn(10)
        emb[c, 2] = rng.randn(10) * 0.01
        binarized[c, :10, 0] = binarized[c, 10:, 1] = 1.0
    return mod.vbx_clustering_hard(_plda(mod, 10), emb, binarized, mod.VbxParams(threshold=0.6))


@pytest.mark.parametrize("case", ["plda_transform", "labels", "oversplit_merge", "driver"])
def test_vbx_matches_jax(case):
    out, ref = _vbx_case(tvbx, case), _vbx_case(jvbx, case)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if case == "driver":
        assert np.all(out[:, 2] == -2) and np.all(out[:, 0] != out[:, 1])


def test_diarizer_plda_backend_matches_jax():
    runs = []
    for pd, vbx in ((tpd, tvbx), (jpd, jvbx)):
        rng = np.random.RandomState(7)
        means = rng.randn(2, 8) * 8.0

        def activities(batch):
            acts = np.zeros((len(batch), 50, 3), np.float32)
            acts[:, :25, 0] = acts[:, 25:, 1] = 1.0
            return acts

        def embeddings(batch, weights, rng=rng, means=means):
            return np.stack([means[0 if w[:len(w) // 2].sum() > w[len(w) // 2:].sum() else 1]
                             + rng.randn(8) * 0.3 for w in weights])

        d = pd.SpeakerDiarizer(activities, embeddings, plda=_plda(vbx, 8),
                               vbx_params=vbx.VbxParams(threshold=0.6, fa=1.0))
        runs.append(_turns(d.diarize(rng.randn(SR * 14).astype(np.float32) * 0.1)))
    assert runs[0] == runs[1] and len({t[0] for t in runs[0]}) == 2


# -- speech clips: tests/test_speech_clip.py -------------------------------

class HopOracle:
    def __init__(self, ranges):
        self.ranges, self.i = ranges, 0

    def __call__(self, hops):
        out = []
        for _ in range(hops.shape[0]):
            t = self.i * 512 / SR
            out.append(1.0 if any(a <= t < b for a, b in self.ranges) else 0.0)
            self.i += 1
        return np.asarray(out, np.float32)


@pytest.mark.parametrize("seconds,ranges,tail", [(12, [(5.0, 10.0)], None), (2, [(0.0, 2.0)], None),
                                                 (12, [(5.0, 6.0)], None),
                                                 (12, [(5.0, 10.0)], 0.5)])
def test_speech_clip_matches_jax(seconds, ranges, tail):
    runs = []
    for mod in (tclip, jclip):
        opts = () if tail is None else (mod.SpeechClipOptions(tail_pad_seconds=tail),)
        c = mod.extract_speech_clip(np.zeros(seconds * SR, np.float32), HopOracle(ranges), *opts)
        runs.append((c.is_complete, c.start_time_seconds, c.speech_seconds, c.audio.size))
    assert runs[0] == runs[1]


CLONE_CASES = [
    (0.0, 4.0, [("hello", 0.2, 0.8), ("world", 3.5, 4.6)], {}),
    (0.0, 4.0, [("hello", 0.2, 0.8), ("interminable", 3.9, 6.2)], {"max_extension_seconds": 1.5}),
    (2.0, 4.0, [], {}),
    (0.0, 4.0, [("early", -0.5, 0.3), ("kept", 0.5, 1.0)], {}),
    (0.0, 0.0, [("x", 0.1, 0.2)], {}),
]


@pytest.mark.parametrize("start,dur,words,kw", CLONE_CASES)
def test_clone_clip_bounds_match_jax(start, dur, words, kw):
    out = tclip.refine_clone_clip_bounds(start, dur, [TranscriptWord(*w) for w in words], **kw)
    ref = jclip.refine_clone_clip_bounds(start, dur, [JaxWord(*w) for w in words], **kw)
    assert (out.start_seconds, out.end_seconds, out.transcript) == (
        ref.start_seconds, ref.end_seconds, ref.transcript)


# -- the evals ---------------------------------------------------------------

@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_der_matches_jax(collar):
    _, truth = two_speaker_conversation(30.0, seed=0)
    hyp = [(7, s + 0.3, e - 0.2) for _, s, e in truth[::2]] + [(8, 10.0, 30.0)]
    out, ref = tder.der(truth, hyp, collar=collar), jder.der(truth, hyp, collar=collar)
    assert out == ref and 0.0 < out["der"] < 1.0


def test_speaker_id_eer_with_models_matches_jax(models):
    """The speaker-verification eval over the two embedding models, on
    trial pairs of the synthetic voices."""
    from chip_smoke import synthetic_voice

    _, jemb, _, temb = models
    voices = [synthetic_voice(2.0, f0, tilt, seed) for f0, tilt, seed in
              ((120, 1.0, 0), (120, 1.0, 1), (230, 1.8, 2), (230, 1.8, 3))]
    pairs = [(voices[0], voices[1], True), (voices[2], voices[3], True),
             (voices[0], voices[2], False), (voices[1], voices[3], False)]
    out = tsid.evaluate_pairs(
        lambda a: td.embedding_forward(temb, torch.from_numpy(a)[None])[0].numpy(), pairs)
    ref = jsid.evaluate_pairs(
        lambda a: np.asarray(jd.embedding_forward(jemb, jnp.asarray(a)[None]))[0], pairs)
    assert out["trials"] == ref["trials"] == 4
    np.testing.assert_allclose(out["scores"], ref["scores"], **TOL)
    assert out["eer"] == ref["eer"]


# -- the pipeline Transcriber with speakers --------------------------------

def _speaker_stream(tr_mod, options, vad_options, diarizer, audio):
    t = tr_mod.Transcriber(
        FakeBackend(lambda a, i, f: "hello there"),
        options(transcription_interval=0.2, identify_speakers=True,
                vad=vad_options(threshold=0.5, window_size=1, max_segment_duration=8.0)),
        diarizer=diarizer, hop_prob_fn=lambda hops: np.ones(hops.shape[0], np.float32))
    # Updates at fixed points: with a short interval the cadence would
    # follow how long each pass took (the pipeline's backoff), and JAX's
    # first passes compile.
    stream = t.create_stream(update_interval=1e9)
    stream.start()
    events = []
    stream.add_listener(lambda e: events.append(type(e).__name__))
    for i in range(0, len(audio), 2 * SR):
        stream.add_audio(audio[i:i + 2 * SR])
        stream.update_transcription(tr_mod.FLAG_FORCE_UPDATE)
    lines = [(l.text, l.start_time, l.duration, l.is_complete,
              [(s.speaker_id, s.speaker_index, s.start_time, s.duration) for s in l.speaker_spans])
             for l in stream.stop().lines]
    return lines, events


@pytest.mark.parametrize("diarizer", ["oracle", "models"])
def test_transcriber_with_speakers_matches_jax(models, diarizer):
    """tests/test_diarization.py's pipeline case (the oracle), and the same
    stream diarized by the two packages' models (threshold 0.005, as above)."""
    if diarizer == "oracle":
        audio = _oracle_audio()
        o = TwoSpeakerOracle()
        dz = [pd.SpeakerDiarizer(o.activities, o.embeddings, cluster_threshold=0.5)
              for pd in (tpd, jpd)]
    else:
        audio, _ = two_speaker_conversation(24.0, seed=0)
        jdz, _, tdz, _ = _diarizers(models, 0.005)
        dz = [tdz, jdz]
    out = _speaker_stream(ttr, TranscriberOptions, VadOptions, dz[0], audio)
    ref = _speaker_stream(jtr, JaxOptions, JaxVadOptions, dz[1], audio)
    assert out == ref
    lines = out[0]
    assert len(lines) >= 2 and all(text == "hello there" for text, *_ in lines)
    assert "LineSpeakersChanged" in out[1]
    speakers = {s[0] for *_, spans in lines for s in spans}
    assert len(speakers) == 2


# -- the API: Transcriber(...).with_options(identify_speakers=True) --------

def test_api_identify_speakers_matches_jax(models, tmp_path, monkeypatch):
    """Both packages' ``Transcriber`` with speakers over the same small
    Moonshine and the same diarization weights (the JAX API's seeds 2 and
    3, bridged into the port's loader): lines, texts and speaker spans
    equal."""
    from moonshine_tpu import api as japi
    from moonshine_tpu.core.config import MoonshineArchConfig
    from moonshine_tpu.core.tokenizer import BinTokenizer
    from moonshine_tpu.models import moonshine as jm
    from moonshine_tpu_torch import api as tapi
    from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig

    cfg = MoonshineArchConfig(
        name="torch-speakers-test", vocab_size=64, hidden_size=64, intermediate_size=96,
        encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
        encoder_kv_heads=4, decoder_kv_heads=4)
    tcfg = TorchArchConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tok = tmp_path / "tokenizer.bin"
    tok.write_bytes(BinTokenizer([b"<unk>", b"<s>", b"</s>"] + [
        f"▁w{i}".encode() for i in range(3, 64)]).to_bytes())
    params = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                          jm.init_params(cfg, jax.random.PRNGKey(7)))
    _, _, tseg, temb = models
    monkeypatch.setattr(td, "init_segmentation_params", lambda gen, device=None: tseg)
    monkeypatch.setattr(td, "init_embedding_params", lambda gen, device=None: temb)
    audio, _ = two_speaker_conversation(20.0, seed=2)
    jt = japi.Transcriber(model=cfg, tokenizer_path=str(tok), options=JaxOptions(model=cfg.name))
    jt.with_params(params).with_options(identify_speakers=True, vad_threshold=0).load()
    tt = tapi.Transcriber(model=tcfg, tokenizer_path=str(tok),
                          options=TranscriberOptions(model=cfg.name), device="cpu")
    tt.with_params(weights.params_from_jax_numpy(_tree(params), tcfg, "cpu"))
    tt.with_options(identify_speakers=True, vad_threshold=0).load()

    def rows(transcript):
        return [(l.text, l.start_time, l.duration, [(s.speaker_id, s.start_time, s.duration)
                                                    for s in l.speaker_spans])
                for l in transcript.lines]

    out, ref = rows(tt.transcribe(audio)), rows(jt.transcribe(audio))
    assert out == ref
    assert out and all(spans for *_, spans in out)
