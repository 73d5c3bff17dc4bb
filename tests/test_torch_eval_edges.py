"""The port's FLEURS and latency harnesses (``eval/fleurs.py``,
``eval/latency.py``) against the JAX package's, on the CPU, with the same
weights (carried across with ``weights.params_from_jax_numpy``, or one HF
checkpoint in a catalog cache that both packages resolve), a synthetic
tokenizer and synthetic wav + txt corpora.

CER numbers, per-language tables and hypotheses must be identical (the
decodes they score are the greedy decodes that test_torch_eval.py holds
token for token), and so must the latency harness's transcript text: the
stream's update passes follow the host's clock, but a line's final text
comes from its completed segment alone.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from test_torch_api import _speechy_audio, catalog_cache  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.audio.wav import save_wav
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.eval import fleurs as jfleurs
from moonshine_tpu.eval import latency as jlatency
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.tokenizer import BinTokenizer as TorchTokenizer
from moonshine_tpu_torch.eval import fleurs as tfleurs
from moonshine_tpu_torch.eval import latency as tlatency

CFG = MoonshineArchConfig(
    name="torch-fleurs-test", vocab_size=64, hidden_size=64, intermediate_size=96,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})

CER_CASES = [
    (["abc"], ["abd"]),
    (["ab cd"], ["abcd"]),
    (["今日は 良い天気", "数学"], ["今日は良い天気です", ""]),
    (["Hello World"], ["hello  world"]),
    (["", "x"], ["abc", "y"]),
]


@pytest.mark.parametrize("case", range(len(CER_CASES)))
def test_corpus_cer_matches_jax(case):
    refs, hyps = CER_CASES[case]
    assert tfleurs.corpus_cer(refs, hyps) == jfleurs.corpus_cer(refs, hyps)
    assert tfleurs.CER_LANGUAGES == jfleurs.CER_LANGUAGES


def _tokens() -> list[bytes]:
    return [b"<unk>", b"<s>", b"</s>"] + [f"▁w{i}".encode() for i in range(3, CFG.vocab_size)]


def _language_corpus(root, seed: int = 0) -> None:
    """One CER language (ja, LibriSpeech layout) and one WER language (en,
    wav + txt pairs); a third directory holds no audio and is skipped."""
    rng = np.random.default_rng(seed)
    for lang, layout in (("ja", "librispeech"), ("en", "wav_txt")):
        d = root / lang / "1" / "2" if layout == "librispeech" else root / lang
        d.mkdir(parents=True)
        trans = []
        for i in range(3):
            n = int(16000 * (0.8 + 0.5 * i))
            tone = np.sin(2 * np.pi * (150 + 40 * i) * np.arange(n) / 16000)
            audio = (0.3 * tone + 0.05 * rng.standard_normal(n)).astype(np.float32)
            text = f"W{3 + i} W{5 + 2 * i} 言葉 {i}"
            if layout == "librispeech":
                utt = f"1-2-{i:04d}"
                save_wav(str(d / f"{utt}.wav"), audio, 16000)
                trans.append(f"{utt} {text}\n")
            else:
                save_wav(str(d / f"clip{i}.wav"), audio, 16000)
                (d / f"clip{i}.txt").write_text(text + "\n")
        if trans:
            (d / "1-2.trans.txt").write_text("".join(trans))
    (root / "empty").mkdir()


@pytest.fixture(scope="module")
def fleurs_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleurs")
    _language_corpus(root)
    tok = tmp_path_factory.mktemp("tok") / "tokenizer.bin"
    tok.write_bytes(BinTokenizer(_tokens()).to_bytes())
    # Larger weights than the initializer's make the random model emit a
    # few tokens before EOS, so the hypotheses carry words.
    params = jm.init_params(CFG, jax.random.PRNGKey(11))
    params = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, params)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    return root, str(tok), params, model


def _recording(module, monkeypatch) -> list:
    """Record each ``evaluate`` call's hypotheses (evaluate_languages pops
    them from the table)."""
    seen = []
    real = module.evaluate

    def evaluate(*args, **kw):
        out = real(*args, **kw)
        seen.append(list(out["hyps"]))
        return out

    monkeypatch.setattr(module, "evaluate", evaluate)
    return seen


def test_evaluate_languages_matches_jax(fleurs_setup, monkeypatch):
    root, tok, params, model = fleurs_setup
    jhyps, thyps = _recording(jfleurs, monkeypatch), _recording(tfleurs, monkeypatch)
    ref = jfleurs.evaluate_languages(lambda lang: (params, CFG, BinTokenizer.from_file(tok)),
                                     root, batch_size=2)
    out = tfleurs.evaluate_languages(
        lambda lang: (model, TCFG, TorchTokenizer.from_file(tok)), root, batch_size=2)
    assert thyps == jhyps and any(h for hyps in thyps for h in hyps)
    assert set(out) == set(ref) == {"en", "ja"}
    assert out["ja"]["metric"] == "cer" and out["en"]["metric"] == "wer"
    for lang in out:
        for key in ("metric", "cer", "wer", "errors", "words", "utterances", "audio_seconds"):
            assert out[lang].get(key) == ref[lang].get(key), (lang, key)
    # A language list and a limit are honoured as in JAX.
    out = tfleurs.evaluate_languages(lambda lang: (model, TCFG, TorchTokenizer.from_file(tok)),
                                     root, languages=["ja"], batch_size=2, limit=2)
    assert list(out) == ["ja"] and out["ja"]["utterances"] == 2


def test_fleurs_main_runs_on_the_port(fleurs_setup, catalog_cache, capsys):  # noqa: F811
    """main() loads --weights (an HF checkpoint) and prints the table."""
    root, tok, _, _ = fleurs_setup
    checkpoint = str(catalog_cache / "base-en" / "model.safetensors")
    tfleurs.main([str(root), "--arch", "base", "--weights", checkpoint, "--tokenizer",
                  str(catalog_cache / "base-en" / "tokenizer.bin"), "--device", "cpu"])
    table = json.loads(capsys.readouterr().out)
    assert set(table) == {"en", "ja"} and table["ja"]["metric"] == "cer"


class _FakeBackend:
    """The JAX package's FakeBackend (a canned text per segment span),
    returning the port's SegmentResult."""

    def reset(self) -> None:
        pass

    def transcribe_segment(self, audio, segment_id, is_final):
        from moonshine_tpu_torch.pipeline.backends import SegmentResult

        return SegmentResult(f"seg{segment_id}:{len(audio)}", [])


def test_latency_bench_fake_backend_matches_jax(tmp_path):
    """tests/test_eval.py's latency case, on both pipelines."""
    from moonshine_tpu.core.config import TranscriberOptions as JaxOptions
    from moonshine_tpu.core.config import VadOptions as JaxVad
    from moonshine_tpu.pipeline.backends import FakeBackend
    from moonshine_tpu.pipeline.transcriber import Transcriber as JaxPipeline
    from moonshine_tpu_torch.core.config import TranscriberOptions, VadOptions
    from moonshine_tpu_torch.pipeline.transcriber import Transcriber

    rng = np.random.default_rng(2)
    wav = tmp_path / "x.wav"
    save_wav(str(wav), rng.standard_normal(32000).astype(np.float32) * 0.1, 16000)
    jt = JaxPipeline(FakeBackend(), JaxOptions(vad=JaxVad(threshold=0.0,
                                                          max_segment_duration=1.0)))
    tt = Transcriber(_FakeBackend(), TranscriberOptions(
        vad=VadOptions(threshold=0.0, max_segment_duration=1.0)))
    ref = jlatency.run_latency_bench(jt, str(wav), update_interval=0.25)
    out = tlatency.run_latency_bench(tt, str(wav), update_interval=0.25)
    assert out["text"] == ref["text"] and out["text"]
    for key in ("audio_seconds", "completed_lines"):
        assert out[key] == ref[key]
    assert out["completed_lines"] >= 1 and out["compute_seconds"] > 0
    assert out["audio_seconds"] == pytest.approx(2.0)


def test_latency_bench_transcriber_matches_jax(catalog_cache, tmp_path):  # noqa: F811
    """The harness over both packages' Transcriber (one checkpoint)."""
    from moonshine_tpu import api as japi
    from moonshine_tpu_torch import api as tapi

    audio = np.concatenate([_speechy_audio(1.6, 12), np.zeros(8000, np.float32),
                            _speechy_audio(1.4, 13)])
    wav = str(tmp_path / "clip.wav")
    save_wav(wav, audio, 16000)
    opts = dict(vad_threshold=0, vad_max_segment_duration=1.5)
    jt = japi.Transcriber("base", "en").with_options(**opts).load()
    tt = tapi.Transcriber("base", "en", device="cpu").with_options(**opts).load()
    ref = jlatency.run_latency_bench(jt, wav, update_interval=0.25)
    out = tlatency.run_latency_bench(tt, wav, update_interval=0.25)
    assert out["text"] == ref["text"] and out["text"].strip()
    assert out["completed_lines"] == ref["completed_lines"] >= 2
    assert out["avg_post_phrase_latency_ms"] >= 0.0


def test_latency_main_runs_on_the_port(catalog_cache, tmp_path, capsys):  # noqa: F811
    wav = str(tmp_path / "clip.wav")
    save_wav(wav, _speechy_audio(1.5, 14), 16000)
    tlatency.main([wav, "--model", "base", "--vad-threshold", "0", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["audio_seconds"] == pytest.approx(1.5)
    assert out["completed_lines"] == 1 and "text" not in out
