"""The port's spelling models, spelling pipeline and alphanumeric agent
against the JAX package's, on the CPU, on seeded numpy inputs.

- XLA's SAME padding (``models.layers.same_pads``/``conv_same``) against
  ``jax.lax.conv_general_dilated`` at odd and even lengths, where the pads
  are uneven, to atol 1e-5 (float32 products of at most 5 x 4 terms).
- The spelling CNN with JAX's weights through the bridge: logits to atol
  1e-4 (a float32 log-mel, then four convolutions summed in another order),
  the same top-1 class, probabilities to 1e-5.
- ``SpellingOnnx`` over the in-memory graph of SpellingCNN's contract
  (``chip_smoke.spelling_graph``; the real export is not in the
  repository) against JAX's ``SpellingOnnx`` on the same graph, to 1e-4.
- The matcher, the fusion, the alphanumeric session and listener, and the
  pipeline's spelling mode: the contracts of tests/test_spelling.py,
  tests/test_alphanumeric.py and tests/test_alphanumeric_listener.py run
  on the port's copies, and their results equal JAX's exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import spelling_graph
from moonshine_tpu.agent import alphanumeric as jagent
from moonshine_tpu.core.config import TranscriberOptions as JaxOptions
from moonshine_tpu.core.config import VadOptions as JaxVadOptions
from moonshine_tpu.core.types import TranscriptLine as JaxLine
from moonshine_tpu.models import spelling as js
from moonshine_tpu.pipeline import spelling as jpipe
from moonshine_tpu.pipeline import transcriber as jtr
from moonshine_tpu.pipeline.backends import FakeBackend
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.agent import alphanumeric as tagent
from moonshine_tpu_torch.core.config import TranscriberOptions, VadOptions
from moonshine_tpu_torch.core.types import TranscriptLine
from moonshine_tpu_torch.models import spelling as ts
from moonshine_tpu_torch.models.layers import Conv1d, Conv2d, conv_same, same_pads
from moonshine_tpu_torch.pipeline import spelling as tpipe
from moonshine_tpu_torch.pipeline import transcriber as ttr

LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _audio(*shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- XLA's SAME padding ----------------------------------------------------

@pytest.mark.parametrize("n", [9, 10, 200, 1001])
@pytest.mark.parametrize("dilation", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_conv_same_matches_xla(k, stride, dilation, n):
    x = _audio(2, 4, n, seed=k + n)
    w = _audio(k, 4, 6, seed=stride + dilation, scale=0.5)  # WIO
    b = _audio(6, seed=3)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(w), window_strides=(stride,),
        padding="SAME", rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC")) + b
    pads = jax.lax.padtype_to_pads((n,), ((k - 1) * dilation + 1,), (stride,), "SAME")
    assert same_pads(n, k, stride, dilation) == tuple(pads[0])
    conv = Conv1d(torch.from_numpy(w.transpose(2, 1, 0).copy()), torch.from_numpy(b))
    out = conv_same(torch.from_numpy(x), conv, stride, dilation).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,stride", [((200, 80), 2), ((100, 40), 2), ((25, 10), 1)])
def test_conv_same_2d_matches_xla(hw, stride):
    """The spelling CNN's shapes: at 200 x 80 with stride 2 XLA pads (0, 1)
    on each axis, where ``padding=1`` would pad (1, 1)."""
    x = _audio(2, 3, *hw, seed=hw[0])
    w = _audio(3, 3, 3, 5, seed=1, scale=0.5)  # HWIO
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), window_strides=(stride, stride),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = Conv2d(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    out = conv_same(torch.from_numpy(x), conv, stride).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)
    if hw == (200, 80):
        assert same_pads(200, 3, 2) == (0, 1) and same_pads(80, 3, 2) == (0, 1)


# -- the spelling CNN ------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    jp = js.init_params(jax.random.PRNGKey(0))
    return jp, weights.spelling_params_from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_spelling_params_round_trip(cnn):
    jp, model = cnn
    assert all(p.device.type == "cpu" for p in model.parameters())
    back = weights.spelling_params_to_numpy(model)
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_spelling_forward_matches_jax(cnn):
    jp, model = cnn
    audio = _audio(3, ts.TARGET_SAMPLES, seed=4)
    ref = np.asarray(js.forward(jp, jnp.asarray(audio)))
    out = ts.forward(model, torch.from_numpy(audio))
    assert out.shape == (3, len(ts.CLASSES))
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


@pytest.mark.parametrize("length", [4000, 16000, 40000])
def test_spelling_predict_matches_jax(cnn, length):
    jp, model = cnn
    audio = _audio(length, seed=length, scale=0.2)
    ref = js.predict(jp, audio)
    out = ts.predict(model, audio)
    assert (out.raw_class, out.character) == (ref.raw_class, ref.character)
    assert out.probability == pytest.approx(ref.probability, abs=1e-5)


def test_spelling_init_params_shapes():
    model = ts.init_params(torch.Generator().manual_seed(0), device="cpu")
    tree = weights.spelling_params_to_numpy(model)
    ref = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(0)))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, ref)
    p = ts.predict(model, _audio(16000, seed=5))
    assert p.raw_class in ts.CLASSES and 0.0 <= p.probability <= 1.0


def test_class_tables_are_copies():
    assert ts.CLASSES == js.CLASSES and ts.CLASS_TO_CHAR == js.CLASS_TO_CHAR
    assert ts.CLASSES_51 == js.CLASSES_51
    assert [ts.class_to_char_51(c) for c in ts.CLASSES_51] == [
        js.class_to_char_51(c) for c in js.CLASSES_51]


# -- SpellingOnnx ----------------------------------------------------------

def test_spelling_onnx_logits_match_jax():
    graph = spelling_graph(0)
    audio = _audio(4, 16000, seed=6)
    ref = np.asarray(js.SpellingOnnx(graph).logits(jnp.asarray(audio)))
    out = ts.SpellingOnnx(graph, device="cpu").logits(torch.from_numpy(audio))
    assert out.shape == (4, 51)
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


@pytest.mark.parametrize("length", [8000, 16000, 24000])
def test_spelling_onnx_predict_matches_jax(length):
    graph = spelling_graph(1)
    audio = _audio(length, seed=length + 1, scale=0.2)
    ref = js.SpellingOnnx(graph).predict(audio)
    out = ts.SpellingOnnx(graph, device="cpu").predict(audio)
    assert (out.raw_class, out.character) == (ref.raw_class, ref.character)
    assert out.probability == pytest.approx(ref.probability, abs=1e-5)


# -- matcher and fusion: tests/test_spelling.py's contract -----------------

def _match(m):
    return (m.type.name, m.character)


CHARACTERS = [("a", "a"), ("Bee", "b"), ("sea", "c"), ("Charlie", "c"), ("x-ray", "x"),
              ("zed", "z"), ("niner", "9"), ("for", "4"), ("dollar sign", "$"),
              ("underscore", "_"), ("space", " "), ("at", "@"), ("star", "*"),
              ("capital b", "B"), ("upper case delta", "D"), ("capital five", "5"),
              ("b as in bravo", "b"), ("e is for elephant", "e"), ("m like mountain", "m"),
              ("d for dog", "d"), ("forty two", "42"), ("1944", "1944"), ("%", "%")]
OTHERS = [("stop", "STOPPED"), ("I'm done", "STOPPED"), ("that's it!", "STOPPED"),
          ("clear", "CLEAR"), ("start over", "CLEAR"), ("undo", "UNDO"),
          ("scratch that", "UNDO"), ("capital", "NONE"), ("b as in zebra", "NONE"),
          ("b as in big dog", "NONE"), ("hello world", "NONE")]


@pytest.mark.parametrize("text,char", CHARACTERS)
def test_matcher_characters(text, char):
    m = tpipe.SpellingMatcher().classify(text)
    assert (m.type, m.character) == (tpipe.SpellingMatchType.CHARACTER, char)
    assert _match(m) == _match(jpipe.SpellingMatcher().classify(text))


@pytest.mark.parametrize("text,kind", OTHERS)
def test_matcher_commands_and_misses(text, kind):
    m = tpipe.SpellingMatcher().classify(text)
    assert m.type.name == kind
    assert _match(m) == _match(jpipe.SpellingMatcher().classify(text))


@pytest.mark.parametrize("text", ["ten", "twenty one", "twenty-one", "one hundred", "hundred",
                                  "one hundred and five", "nine hundred ninety nine",
                                  "one thousand", "five", "zillion", "two thousand"])
def test_number_words_match_jax(text):
    assert tpipe.parse_number_words(text) == jpipe.parse_number_words(text)
    assert tpipe.spelling_normalize(f"  {text.title()}!  ") == jpipe.spelling_normalize(
        f"  {text.title()}!  ")


FUSIONS = [("stop", ("a", 0.99)), ("bee", None), ("hello world", None),
           ("hello world", ("c", 0.9)), ("capital b", ("b", 0.9)), ("five", ("s", 0.9)),
           ("bee", ("3", 0.9)), ("bee", ("d", 0.8)), ("bee", ("d", 0.3)), ("okay", ("a", 0.5)),
           ("okay", ("a", 0.2)), ("okay", None), ("dollar sign", ("s", 0.99))]


@pytest.mark.parametrize("text,pred", FUSIONS)
def test_fusion_matches_jax(text, pred):
    results = []
    for pipe, model in ((tpipe, ts), (jpipe, js)):
        p = None if pred is None else model.SpellingPrediction(pred[0], pred[1], pred[0])
        m = pipe.SpellingMatcher()
        results.append(_match(pipe.fuse_default(text, m.classify(text), p, m)))
    assert results[0] == results[1]


# -- the alphanumeric agent: tests/test_alphanumeric*.py's contracts -------

SESSIONS = [
    ({}, ["bravo", "Oscar", "bee", "stop"]),
    ({}, ["a", "bee", "undo", "sea", "clear"]),
    ({}, ["the weather is nice"]),
    ({"mode": "digits"}, ["five", "bravo", "forty two"]),
]


@pytest.mark.parametrize("kw,utterances", SESSIONS)
def test_alphanumeric_session_matches_jax(kw, utterances):
    runs = []
    for agent in (tagent, jagent):
        s = agent.AlphanumericSession(**kw)
        events = [s.handle_utterance(u) for u in utterances]
        runs.append(([(e.action, e.buffer) for e in events], s.value, s.stopped))
    assert runs[0] == runs[1]


def test_alphanumeric_session_fuses_prediction():
    s = tagent.AlphanumericSession(predict_fn=lambda a: ts.SpellingPrediction("d", 0.9, "d"))
    assert s.handle_utterance("bee", np.ones(16000, np.float32)).buffer == "d"


LISTENER_LINES = [
    ({}, ["bravo", "Oscar", "bee"]),
    ({}, ["a", "bee", "undo", "sea", "clear", "x", "done", "y"]),
    ({}, ["forty two", "."]),
    ({"matcher": "digits"}, ["bravo", "nine", "stop"]),
    ({"custom_words": {"smiley": ":)", "Bee": "8"}}, ["smiley", "bee", "sea"]),
]


@pytest.mark.parametrize("kw,texts", LISTENER_LINES)
def test_alphanumeric_listener_matches_jax(kw, texts):
    runs = []
    for agent, pipe, line_cls, tr in ((tagent, tpipe, TranscriptLine, ttr),
                                      (jagent, jpipe, JaxLine, jtr)):
        kwargs = dict(kw)
        if kwargs.get("matcher") == "digits":
            kwargs["matcher"] = pipe.digits_only_matcher()
        events = []
        lst = agent.AlphanumericListener(events.append, **kwargs)
        for i, text in enumerate(texts):
            lst(tr.LineCompleted(line=line_cls(id=i, text=text, is_complete=True), stream_id=0))
        lst(tr.LineCompleted(line=line_cls(id=0, text=texts[0], is_complete=True), stream_id=0))
        runs.append(([(e.action, e.buffer) for e in events], lst.text, lst.stopped))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("text", ["h o m e", "forty two", "a stop b", "flurble"])
def test_classify_sequence_matches_jax(text):
    assert [_match(m) for m in tpipe.SpellingMatcher().classify_sequence(text)] == [
        _match(m) for m in jpipe.SpellingMatcher().classify_sequence(text)]


@pytest.mark.parametrize("ch", ["h", "H", "w", "1", "#", " ", "é", "42"])
def test_spoken_form_matches_jax(ch):
    assert tpipe.spoken_form(ch) == jpipe.spoken_form(ch)


@pytest.mark.parametrize("text", ["bravo", "seven", "hash", "stop", "forty two", "comma"])
def test_filtered_matchers_match_jax(text):
    for name in ("letters_only_matcher", "digits_only_matcher"):
        assert _match(getattr(tpipe, name)().classify(text)) == _match(
            getattr(jpipe, name)().classify(text))


# -- spelling mode in the pipeline Transcriber -----------------------------

def _spelling_stream(tr_mod, options, vad_options, backend, spelling_params=None):
    t = tr_mod.Transcriber(
        backend, options(transcription_interval=0.1,
                         vad=vad_options(threshold=0.0, max_segment_duration=1.0)),
        spelling_params=spelling_params)
    # Updates at fixed points (the pipeline's backoff would otherwise
    # follow how long each pass took, and JAX's first passes compile).
    stream = t.create_stream(update_interval=1e9, flags=tr_mod.FLAG_SPELLING_MODE)
    stream.start()
    audio = _audio(40000, seed=9, scale=0.2)
    for i in range(0, len(audio), 8000):
        stream.add_audio(audio[i:i + 8000])
        stream.update_transcription(tr_mod.FLAG_SPELLING_MODE | tr_mod.FLAG_FORCE_UPDATE)
    return [(line.text, line.start_time, line.duration, line.is_complete)
            for line in stream.stop().lines]


@pytest.mark.parametrize("with_cnn", [False, True])
def test_spelling_mode_stream_matches_jax(cnn, with_cnn):
    """Matcher only ("bee" -> "b"), and with the CNN, whose prediction
    decides where the ASR text matches nothing."""
    jp, model = cnn
    script = (lambda a, i, f: "bee" if i % 2 else "hello world")
    ref = _spelling_stream(jtr, JaxOptions, JaxVadOptions, FakeBackend(script),
                           jp if with_cnn else None)
    out = _spelling_stream(ttr, TranscriberOptions, VadOptions, FakeBackend(script),
                           model if with_cnn else None)
    assert out == ref
    completed = [text for text, *_, done in out if done]
    assert len(completed) >= 3
    if with_cnn:  # every completed line became a character
        assert all(len(text) == 1 for text in completed)
    else:
        assert "b" in completed and "hello world" in completed
