"""The port's VAD, offline backend and ``Transcriber`` against the JAX
package's, on the CPU, with the same weights and a synthetic tokenizer.

Tolerances: VAD probabilities and state to 1e-5 (float32, summation order
only); transcripts must be identical, text and timing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import api as japi
from moonshine_tpu.core.config import MoonshineArchConfig, TranscriberOptions
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.models import vad as jvad
from moonshine_tpu.pipeline.backends import OfflineBackend as JaxOfflineBackend
from moonshine_tpu_torch import api as tapi
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.config import TranscriberOptions as TorchOptions
from moonshine_tpu_torch.core.tokenizer import BinTokenizer as TorchTokenizer
from moonshine_tpu_torch.models import vad as tvad
from moonshine_tpu_torch.pipeline.backends import OfflineBackend

CFG = MoonshineArchConfig(
    name="torch-pipeline-test", vocab_size=64, hidden_size=64, intermediate_size=96,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _tokens(vocab: int) -> list[bytes]:
    return [b"<unk>", b"<s>", b"</s>"] + [f"▁w{i}".encode() for i in range(3, vocab)]


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "tokenizer.bin"
    path.write_bytes(BinTokenizer(_tokens(CFG.vocab_size)).to_bytes())
    return str(path)


@pytest.fixture(scope="module")
def params():
    # Larger weights than the initializer's make the random model emit a
    # few tokens before EOS, so the transcripts carry text.
    p = jm.init_params(CFG, jax.random.PRNGKey(7))
    return jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, p)


def _speechy_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    tone = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.3 * tone + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def test_vad_predict_hops_matches_jax():
    jp = jvad.init_params(jax.random.PRNGKey(1))
    tp = weights.vad_params_from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(jax.tree.leaves(weights.vad_params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a, b)
    hops = _speechy_audio(5 * 512 * 2 / 16000, 0).reshape(2, 5, 512)
    js, ts = jvad.init_state(2), tvad.init_state(2, device="cpu")
    for chunk in (hops[:, :3], hops[:, 3:]):  # state carries across calls
        jprob, js = jvad.predict_hops_jit(jp, jnp.asarray(chunk), js)
        tprob, ts = tvad.predict_hops(tp, torch.from_numpy(np.ascontiguousarray(chunk)), ts)
        np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-5, rtol=1e-5)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    # The single-hop form agrees with the batched one.
    s0 = tvad.init_state(2, device="cpu")
    p1, _ = tvad.predict_hop(tp, torch.from_numpy(hops[:, 0].copy()), s0)
    pn, _ = tvad.predict_hops(tp, torch.from_numpy(hops[:, :1].copy()), s0)
    np.testing.assert_allclose(p1.numpy(), pn[:, 0].numpy(), atol=1e-6)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_offline_backend_text_matches_jax(params, tokenizer_path, kv_int8):
    jb = JaxOfflineBackend(params, CFG, BinTokenizer.from_file(tokenizer_path), kv_int8=kv_int8)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    tb = OfflineBackend(model, TCFG, TorchTokenizer.from_file(tokenizer_path), kv_int8=kv_int8)
    texts = []
    for seconds, seed in ((1.3, 1), (2.7, 2)):
        audio = _speechy_audio(seconds, seed)
        ref = jb.transcribe_segment(audio, 0, True)
        out = tb.transcribe_segment(audio, 0, True)
        assert out.text == ref.text
        texts.append(out.text)
    assert any(texts), "the random model should emit some text"


def test_transcriber_matches_jax(params, tokenizer_path):
    audio = np.concatenate([_speechy_audio(2.2, 3), np.zeros(8000, np.float32),
                            _speechy_audio(1.5, 4)])
    jt = japi.Transcriber(model=CFG, tokenizer_path=tokenizer_path,
                          options=TranscriberOptions(model=CFG.name)).with_params(params)
    jt.with_options(vad_threshold=0).load()
    tt = tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path,
                          options=TorchOptions(model=CFG.name), device="cpu")
    tt.with_params(weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu"))
    tt.with_options(vad_threshold=0).load()
    assert all(p.device.type == "cpu" for p in tt.model.parameters())
    ref = jt.transcribe(audio)
    out = tt.transcribe(audio)
    assert len(out.lines) == len(ref.lines) >= 1
    for a, b in zip(out.lines, ref.lines):
        assert (a.text, a.start_time, a.duration, a.is_complete) == (
            b.text, b.start_time, b.duration, b.is_complete)
    assert any(line.text for line in out.lines)


def test_transcriber_default_vad_runs_on_cpu(tokenizer_path):
    """The default options load the port's random-weight VAD; the pipeline
    runs end to end whatever it hears."""
    tt = tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path, device="cpu").load()
    transcript = tt.transcribe(_speechy_audio(2.0, 5))
    assert all(isinstance(line.text, str) for line in transcript.lines)


def test_transcriber_refuses_what_is_not_ported(tokenizer_path, tmp_path, monkeypatch):
    """Nothing of the JAX ``Transcriber`` is refused any more: speaker
    identification and spelling mode load on the CPU, and a transcribed
    two-speaker clip carries speakers.  A missing ``vad_weights=`` file
    still raises (no random VAD stands in), and so does a missing
    tokenizer."""
    with pytest.raises(FileNotFoundError):
        tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path,
                         vad_weights=str(tmp_path / "vad.onnx"), device="cpu").load()
    from chip_smoke import two_speaker_conversation

    audio, _ = two_speaker_conversation(20.0, seed=0)
    t = tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path, device="cpu")
    t.with_options(identify_speakers=True, vad_threshold=0).load()
    assert t._pipeline.diarizer is not None
    lines = t.transcribe(audio).lines
    assert lines and all(line.speaker_spans for line in lines)
    t = tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path, device="cpu")
    t.with_options(spelling_mode=True, vad_threshold=0).load()
    assert t.options.spelling_mode and t._pipeline.spelling_matcher is not None
    assert all(line.is_complete for line in t.transcribe(audio[:3 * 16000]).lines)
    # No tokenizer anywhere: neither a path, nor the catalog, nor its default.
    from moonshine_tpu_torch import catalog

    monkeypatch.setenv(catalog.DEFAULT_CACHE_ENV, str(tmp_path / "empty-cache"))
    monkeypatch.setattr(catalog, "_REFERENCE_TOKENIZER", str(tmp_path / "absent.bin"))
    with pytest.raises(FileNotFoundError):
        tapi.Transcriber(model=TCFG, device="cpu").load()


def _frame_seconds(n_samples: int) -> float:
    """One encoder frame's duration for a segment of ``n_samples``, as
    ``OfflineBackend._align`` computes it."""
    from moonshine_tpu_torch.models.moonshine import frames_for_samples

    return n_samples / 16000 / max(frames_for_samples(TCFG, n_samples), 1)


def _assert_words_match(out, ref, frame_s: float):
    assert [w.text for w in out] == [w.text for w in ref]
    for a, b in zip(out, ref):
        assert abs(a.start - b.start) <= frame_s + 1e-6, (a, b)
        assert abs(a.end - b.end) <= frame_s + 1e-6, (a, b)


def test_offline_backend_word_timestamps_match_jax(params, tokenizer_path):
    jb = JaxOfflineBackend(params, CFG, BinTokenizer.from_file(tokenizer_path),
                           word_timestamps=True)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    tb = OfflineBackend(model, TCFG, TorchTokenizer.from_file(tokenizer_path),
                        word_timestamps=True)
    n_words = 0
    for seconds, seed in ((1.3, 1), (2.7, 2)):
        audio = _speechy_audio(seconds, seed)
        ref = jb.transcribe_segment(audio, 0, True)
        out = tb.transcribe_segment(audio, 0, True)
        assert out.text == ref.text
        _assert_words_match(out.words, ref.words, _frame_seconds(audio.size))
        n_words += len(out.words)
        # An incomplete segment is not aligned.
        assert tb.transcribe_segment(audio, 0, False).words == []
    assert n_words > 0, "the random model should emit some words"


def test_transcriber_word_timestamps_match_jax(params, tokenizer_path):
    audio = np.concatenate([_speechy_audio(2.2, 3), np.zeros(8000, np.float32),
                            _speechy_audio(1.5, 4)])
    jt = japi.Transcriber(model=CFG, tokenizer_path=tokenizer_path,
                          options=TranscriberOptions(model=CFG.name)).with_params(params)
    jt.with_options(vad_threshold=0, word_timestamps=True).load()
    tt = tapi.Transcriber(model=TCFG, tokenizer_path=tokenizer_path,
                          options=TorchOptions(model=CFG.name), device="cpu")
    tt.with_params(weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu"))
    tt.with_options(vad_threshold=0, word_timestamps=True).load()
    ref = jt.transcribe(audio)
    out = tt.transcribe(audio)
    assert len(out.lines) == len(ref.lines) >= 1
    for a, b in zip(out.lines, ref.lines):
        assert a.text == b.text
        n = int(round(b.duration * 16000))
        _assert_words_match(a.words, b.words, _frame_seconds(n))
    assert sum(len(line.words) for line in out.lines) > 0
