"""The port's eval harness (``eval/wer.py``, ``eval/librispeech.py``)
against the JAX package's, on the CPU, with the same weights, a synthetic
tokenizer and synthetic wav + txt corpora.

WER numbers, dataset iteration, hypotheses and transcripts must be
identical: the WER code is a copy, and the decodes it scores are the
greedy and beam decodes that ``test_torch_moonshine.py`` and
``test_torch_beam.py`` hold token for token.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.audio.wav import save_wav
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.eval import librispeech as jls
from moonshine_tpu.eval import wer as jwer
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.tokenizer import BinTokenizer as TorchTokenizer
from moonshine_tpu_torch.eval import librispeech as tls
from moonshine_tpu_torch.eval import wer as twer

CFG = MoonshineArchConfig(
    name="torch-eval-test", vocab_size=64, hidden_size=64, intermediate_size=96,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})

# (refs, hyps) of tests/test_eval.py, and a few more.
WER_CASES = [
    (["the cat sat", "on the mat"], ["the cat sat", "on a mat"]),
    (["IT WAS THE BEST OF TIMES"], ["It was the best of times."]),
    (["Hello, World!"], ["hello world"]),
    (["kitten"], ["sitting"]),
    (["a b c", ""], ["a x c", "extra words"]),
    (["Mr. Smith paid $20 (approx.) for it"], ["mister smith paid twenty dollars for it"]),
]


@pytest.mark.parametrize("use_normalizer", [False, True])
@pytest.mark.parametrize("case", range(len(WER_CASES)))
def test_corpus_wer_matches_jax(case, use_normalizer):
    refs, hyps = WER_CASES[case]
    assert twer.corpus_wer(refs, hyps, use_normalizer) == jwer.corpus_wer(refs, hyps,
                                                                          use_normalizer)
    for r, h in zip(refs, hyps):
        assert twer.normalize(r) == jwer.normalize(r)
        assert twer.edit_distance(r.split(), h.split()) == jwer.edit_distance(r.split(),
                                                                              h.split())


def test_edit_distance_basics():
    for ref, hyp, want in ((["a"], [], 1), ([], ["a", "b"], 2), (["a", "b"], ["b", "a"], 2),
                           (["a", "b", "c"], ["a", "x", "c"], 1), ([], [], 0)):
        assert twer.edit_distance(ref, hyp) == want == jwer.edit_distance(ref, hyp)


def _write_corpus(root, layout: str, seconds, seed: int = 0):
    rng = np.random.default_rng(seed)
    t = None
    if layout == "librispeech":
        d = root / "19" / "198"
        d.mkdir(parents=True)
        t = open(d / "19-198.trans.txt", "w")
    for i, s in enumerate(seconds):
        n = int(16000 * s)
        tone = np.sin(2 * np.pi * (150 + 40 * i) * np.arange(n) / 16000)
        audio = (0.3 * tone + 0.05 * rng.standard_normal(n)).astype(np.float32)
        text = f"W{3 + i} W{5 + 2 * i} SOME WORDS {i}"
        if layout == "librispeech":
            utt = f"19-198-{i:04d}"
            save_wav(str(d / f"{utt}.wav"), audio, 16000)
            t.write(f"{utt} {text}\n")
        else:
            save_wav(str(root / f"clip{i}.wav"), audio, 16000)
            (root / f"clip{i}.txt").write_text(text + "\n")
    if t is not None:
        t.close()


@pytest.mark.parametrize("layout", ["librispeech", "wav_txt"])
def test_iter_librispeech_matches_jax(tmp_path, layout):
    _write_corpus(tmp_path, layout, [0.5, 0.7, 0.6])
    for limit in (None, 2):
        ours = list(tls.iter_librispeech(tmp_path, limit))
        ref = list(jls.iter_librispeech(tmp_path, limit))
        assert [(u.id, u.audio_path, u.text) for u in ours] == [
            (u.id, u.audio_path, u.text) for u in ref]
        assert len(ours) == (limit or 3)
    np.testing.assert_array_equal(ours[0].load_audio(), ref[0].load_audio())


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    # Two 128-frame buckets: clips under 3.07 s fall in the first, the
    # rest in the second.
    _write_corpus(root, "wav_txt", [1.2, 2.0, 3.6, 4.4], seed=1)
    tok = tmp_path_factory.mktemp("tok") / "tokenizer.bin"
    tok.write_bytes(BinTokenizer([b"<unk>", b"<s>", b"</s>"] + [
        f"▁w{i}".encode() for i in range(3, CFG.vocab_size)]).to_bytes())
    # Larger weights than the initializer's make the random model emit a
    # few tokens before EOS, so the hypotheses carry words.
    params = jm.init_params(CFG, jax.random.PRNGKey(7))
    params = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, params)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    return root, str(tok), params, model


@pytest.mark.parametrize("beam_size", [1, 3])
def test_evaluate_matches_jax(eval_setup, beam_size):
    root, tok, params, model = eval_setup
    ref = jls.evaluate(params, CFG, BinTokenizer.from_file(tok), str(root), batch_size=3,
                       beam_size=beam_size, return_texts=True)
    out = tls.evaluate(model, TCFG, TorchTokenizer.from_file(tok), str(root), batch_size=3,
                       beam_size=beam_size, return_texts=True)
    for key in ("wer", "errors", "words", "utterances", "refs", "hyps", "audio_seconds",
                "beam_size"):
        assert out[key] == ref[key], key
    assert out["utterances"] == 4 and any(out["hyps"])
    assert out["audio_seconds_per_second"] > 0


def test_buckets_match_jax():
    utts = [(i, np.zeros(n, np.float32)) for i, n in
            enumerate((8000, 49000, 50000, 90000, 200000, 600000))]
    ours = [(n, [u for u, _ in items]) for n, items in tls._buckets(TCFG, utts, 2)]
    ref = [(n, [u for u, _ in items]) for n, items in jls._buckets(CFG, utts, 2)]
    assert ours == ref and len(ours) >= 4


def test_main_refuses_weights(tmp_path):
    """--weights loads through weights.import_hf_moonshine (the loading is
    held against JAX in tests/test_torch_api.py), so a checkpoint that is
    not there is refused, with no random weights in its place."""
    tok = tmp_path / "tokenizer.bin"
    tok.write_bytes(TorchTokenizer([b"<unk>", b"<s>", b"</s>", b"w"]).to_bytes())
    with pytest.raises(FileNotFoundError, match="x.safetensors"):
        tls.main([str(tmp_path), "--tokenizer", str(tok), "--weights",
                  str(tmp_path / "x.safetensors"), "--device", "cpu"])
