"""The port's G2P chain (text normalisation, number words, the sixteen
languages' engines, the G2P transformer) against the JAX package's, on the
CPU.

- Text to IPA: every language of ``SUPPORTED_LANGUAGES`` through both
  packages' ``GraphemeToPhonemizer``, on the first lines of
  ``tests/data/g2p_ref/<lang>.txt`` (Spanish and Portuguese read their
  engines' default dialects, ``es_mx`` and ``pt_br``; Japanese and Chinese
  have no such file and take fixed sentences from their JAX tests and
  goldens).  Exact strings, against JAX's function and not the goldens:
  six JAX golden tests fail on the reference itself.
- ``number_words`` and ``text_normalize``: exact strings.
- ``G2PTransformer`` on bridged random weights: ``decoder_logits`` to atol
  1e-5 (float32 products of at most 512 terms), ``greedy`` the same ids
  (ties in argmax go to the first index on both sides), artifacts written
  by either package load in the other with their metadata, and the OOV
  routing of tests/test_g2p_transformer.py.
"""

from __future__ import annotations

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.eval import g2p_reference_agreement as jagree
from moonshine_tpu.tts import g2p as jg2p
from moonshine_tpu.tts import g2p_transformer as jgt
from moonshine_tpu.tts import lang_rules as jlr
from moonshine_tpu.tts import number_words as jnw
from moonshine_tpu.tts import text_normalize as jtn
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.eval import g2p_reference_agreement as tagree
from moonshine_tpu_torch.tts import g2p as tg2p
from moonshine_tpu_torch.tts import g2p_transformer as tgt
from moonshine_tpu_torch.tts import lang_rules as tlr
from moonshine_tpu_torch.tts import number_words as tnw
from moonshine_tpu_torch.tts import text_normalize as ttn

DATA = pathlib.Path(__file__).resolve().parent / "data" / "g2p_ref"
LINES = 8
# The engines' default dialects where the language has no <lang>.txt.
TEXT_FILE = {"es": "es_mx", "pt": "pt_br"}
FIXED = {
    "ja": ["学校", "ひらがな", "山川", "今日は良い天気です。", "東京に行きます", "カタカナ",
           "アンパサンド（&,）は、並立助詞「…と…」を意味する記号である。"],
    "zh": ["ni3hao3", "nǐhǎo", "xie4xie5", "zhong1guo2", "wo3men5", "你好", "中国",
           "数学，是研究數量、结构以及空间等概念及其变化的一門学科。"],
}
LOGIT_TOL = dict(atol=1e-5, rtol=0)



def _sentences(lang: str) -> list[str]:
    if lang in FIXED:
        return FIXED[lang]
    path = DATA / f"{TEXT_FILE.get(lang, lang)}.txt"
    return [l for l in path.read_text(encoding="utf-8").splitlines() if l.strip()][:LINES]


def test_supported_languages_match():
    assert tg2p.SUPPORTED_LANGUAGES == jg2p.SUPPORTED_LANGUAGES
    assert len(tg2p.SUPPORTED_LANGUAGES) == 16


@pytest.mark.parametrize("lang", jg2p.SUPPORTED_LANGUAGES)
def test_text_to_ipa_matches_jax(lang):
    ours, ref = tg2p.GraphemeToPhonemizer(lang), jg2p.GraphemeToPhonemizer(lang)
    for text in _sentences(lang):
        for pauses in (True, False):
            assert ours.text_to_ipa(text, with_pauses=pauses) == \
                ref.text_to_ipa(text, with_pauses=pauses), (lang, text)


@pytest.mark.parametrize("lang", ["pt_pt", "es_es", "es_419", "en_us"])
def test_dialects_match_jax(lang):
    ours, ref = tg2p.GraphemeToPhonemizer(lang), jg2p.GraphemeToPhonemizer(lang)
    for text in _sentences(lang.split("_")[0]):
        assert ours.text_to_ipa(text) == ref.text_to_ipa(text), (lang, text)


def test_unknown_language_raises():
    with pytest.raises(ValueError):
        tg2p.GraphemeToPhonemizer("xx")


def test_engines_are_the_ports_own():
    """The copied ``__import__`` strings name the port's ``lang_rules``."""
    for lang in tg2p.SUPPORTED_LANGUAGES:
        engine = tg2p.GraphemeToPhonemizer(lang).engine
        assert type(engine).__module__.startswith("moonshine_tpu_torch."), lang


@pytest.mark.parametrize("lang", jnw.supported_number_languages())
def test_number_words_match_jax(lang):
    assert tnw.supported_number_languages() == jnw.supported_number_languages()
    for n in [0, 1, 7, 11, 15, 21, 42, 99, 100, 101, 345, 999, 1000, 1001, 2023, 10_000,
              123_456, 1_000_000, 2_000_000, -5]:
        assert tnw.number_to_words_lang(n, lang) == jnw.number_to_words_lang(n, lang), (lang, n)


NORMALIZE_CASES = [
    "I have 3 cats", "$5", "$1.50", "50%", "the 2nd time", "Dr. Smith", "meet at 3:30",
    "in 1984 there", "A&B", "£2.05 and €3", "the 21st of May", "St. James vs. Mr. Brown",
    "pi is 3.14", "1,000,000 people", "-7 degrees",
]


@pytest.mark.parametrize("lang", ["en", "es", "fr", "de", "it", "pt", "ru", "ja", "zh", "ko"])
def test_normalize_text_matches_jax(lang):
    for text in NORMALIZE_CASES:
        assert ttn.normalize_text(text, lang) == jtn.normalize_text(text, lang), (lang, text)


def test_english_number_helpers_match_jax():
    for n in [0, 7, 13, 21, 100, 345, 1000, 1_000_000, -5, 1984, 1900, 2005, 12, 20, 3]:
        assert ttn.number_to_words(n) == jtn.number_to_words(n)
        assert ttn.ordinal_to_words(abs(n) or 1) == jtn.ordinal_to_words(abs(n) or 1)
    for y in [1984, 1900, 2005, 1066, 2100]:
        assert ttn.year_to_words(y) == jtn.year_to_words(y)
    for s in ["3.14", "0.5", "12.05"]:
        assert ttn.decimal_to_words(s) == jtn.decimal_to_words(s)


def test_reference_agreement_scores_match_jax():
    """``eval/g2p_reference_agreement`` over the port's engines scores as
    JAX's over JAX's (a slice of the goldens)."""
    for dialect in ("de", "ko"):
        ours = tagree.score_language(dialect, line_range=(0, 10))
        ref = jagree.score_language(dialect, line_range=(0, 10))
        assert ours.__dict__ == ref.__dict__


# -- the G2P transformer ----------------------------------------------------

CFG = jgt.G2PModelConfig(dim=32, layers=2, heads=4, max_word=12, max_ipa=10)
WORDS = ["zorblax", "cat", "through", "quizzical", "x", "abcdefghijklmnop", "o'neil", "re-do"]


def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def g2p_models():
    out_vocab = jgt.G2PTransformer.build_out_vocab(["kæt", "θɹu", "zɔɹblæks", "ʃɪp"])
    jparams = jgt.init_params(CFG, jax.random.PRNGKey(3), len(out_vocab))
    jmodel = jgt.G2PTransformer(CFG, jparams, out_vocab)
    tmodel = tgt.G2PTransformer(CFG, weights.g2p_params_from_jax_numpy(_tree(jparams), "cpu"),
                                out_vocab, device="cpu")
    return jmodel, tmodel


def test_g2p_bridge_round_trips(g2p_models):
    jmodel, tmodel = g2p_models
    back = weights.g2p_params_to_numpy(tmodel.params)
    for a, b in zip(jax.tree.leaves(_tree(jmodel.params)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert {k: v.shape for k, v in weights.flatten_tree(back).items()} == \
        tgt.artifact_shapes(CFG, len(jmodel.out_vocab))


def test_decoder_logits_match_jax(g2p_models):
    jmodel, tmodel = g2p_models
    src = np.stack([tmodel.encode_src(w) for w in WORDS])
    tgt_ids = np.stack([tmodel.encode_ipa(s) for s in ["kæt", "θɹu", "", "ʃɪpʃɪpʃɪp", "k", "æ",
                                                      "zz", "kk"]])
    memory, valid = jgt.encode(jmodel.params, CFG, jnp.asarray(src))
    ref = jgt.decoder_logits(jmodel.params, CFG, memory, valid, jnp.asarray(tgt_ids))
    tmem, tvalid = tgt.encode(tmodel.params, CFG, torch.from_numpy(src))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(memory), **LOGIT_TOL)
    ours = tgt.decoder_logits(tmodel.params, CFG, tmem, tvalid, torch.from_numpy(tgt_ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_greedy_matches_jax(g2p_models):
    jmodel, tmodel = g2p_models
    src = np.stack([tmodel.encode_src(w) for w in WORDS])
    ref = np.asarray(jgt.greedy(jmodel.params, CFG, jnp.asarray(src)))
    ours = tgt.greedy(tmodel.params, CFG, torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert tmodel.predict_batch(WORDS) == jmodel.predict_batch(WORDS)
    assert [tmodel.predict(w) for w in WORDS[:3]] == tmodel.predict_batch(WORDS[:3])


def test_encode_helpers_match_jax(g2p_models):
    jmodel, tmodel = g2p_models
    for w in WORDS + ["X" * 100]:
        np.testing.assert_array_equal(tgt.encode_word(w, 28), jgt.encode_word(w, 28))
        np.testing.assert_array_equal(tmodel.encode_src(w), jmodel.encode_src(w))
    for s in ["kæt", "ʒʒʒ", ""]:
        np.testing.assert_array_equal(tmodel.encode_ipa(s), jmodel.encode_ipa(s))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifact_loads_across_packages(g2p_models, tmp_path, writer):
    jmodel, tmodel = g2p_models
    path = tmp_path / f"{writer}.safetensors"
    (jmodel if writer == "jax" else tmodel).save(path)
    jl, tl = jgt.G2PTransformer.load(path), tgt.G2PTransformer.load(path, device="cpu")
    for loaded in (jl, tl):
        assert loaded.cfg._asdict() == CFG._asdict()
        assert loaded.out_vocab == jmodel.out_vocab
        assert loaded.in_vocab is None
    for a, b in zip(jax.tree.leaves(_tree(jl.params)),
                    jax.tree.leaves(weights.g2p_params_to_numpy(tl.params))):
        np.testing.assert_array_equal(a, b)
    _, meta = weights.load_safetensors_with_metadata(path)
    assert json.loads(meta["config"]) == CFG._asdict()
    assert jl.predict_batch(WORDS) == tl.predict_batch(WORDS) == jmodel.predict_batch(WORDS)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_custom_in_vocab_artifact_across_packages(tmp_path, writer):
    """A model with its own input alphabet (the ja reading tier's form):
    ``in_vocab`` rides in the metadata, non-ASCII included."""
    in_vocab = tgt.G2PTransformer.build_in_vocab(["学校", "山川", "ひらがな"])
    out_vocab = tgt.G2PTransformer.build_out_vocab(["gakkoɯ", "jamakawa"])
    jparams = jgt.init_params(CFG, jax.random.PRNGKey(5), len(out_vocab), len(in_vocab) + 4)
    if writer == "jax":
        jgt.G2PTransformer(CFG, jparams, out_vocab, in_vocab).save(tmp_path / "m.safetensors")
    else:
        tgt.G2PTransformer(CFG, weights.g2p_params_from_jax_numpy(_tree(jparams), "cpu"),
                           out_vocab, in_vocab, device="cpu").save(tmp_path / "m.safetensors")
    jl = jgt.G2PTransformer.load(tmp_path / "m.safetensors")
    tl = tgt.G2PTransformer.load(tmp_path / "m.safetensors", device="cpu")
    assert jl.in_vocab == tl.in_vocab == in_vocab
    words = ["山川", "学校学校", "ひら"]
    assert tl.predict_batch(words) == jl.predict_batch(words)
    # The ja engine's neural backstop, as in tests/test_ja_reader.py.
    ours = tlr.JapaneseG2P(lexicon={"学校": "gakkoɯ"}, use_harvested=False, neural=tl)
    ref = jlr.JapaneseG2P(lexicon={"学校": "gakkoɯ"}, use_harvested=False, neural=jl)
    for w in ["学校", "ひらがな", "山川"]:
        assert ours.word_to_ipa(w) == ref.word_to_ipa(w)


def test_load_rejects_foreign_safetensors(tmp_path):
    p = tmp_path / "other.safetensors"
    weights.save_safetensors(p, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not a G2PTransformer artifact"):
        tgt.G2PTransformer.load(p, device="cpu")


def test_phonemizer_oov_routing_matches_jax(g2p_models, tmp_path):
    """tests/test_g2p_transformer.py's routing: lexicon words never reach
    the network, OOV words get the model's output with the English stress
    pass, and a path builds the same phonemizer."""
    jmodel, tmodel = g2p_models
    ours = tg2p.GraphemeToPhonemizer("en", oov_model=tmodel)
    ref = jg2p.GraphemeToPhonemizer("en", oov_model=jmodel)
    for w in ["through", "people", "cat", "zorblax", "quizzical", "blorf"]:
        assert ours.word_to_ipa(w) == ref.word_to_ipa(w), w
    assert ours.word_to_ipa("zorblax") == tlr.en_add_primary_stress(tmodel.predict("zorblax"))
    assert ours.text_to_ipa("the zorblax ate a blorf") == ref.text_to_ipa("the zorblax ate a blorf")
    p = tmp_path / "m.safetensors"
    tmodel.save(p)
    loaded = tg2p.GraphemeToPhonemizer("en", oov_model=tgt.G2PTransformer.load(p, device="cpu"))
    assert loaded.word_to_ipa("zorblax") == ours.word_to_ipa("zorblax")
    if not torch.cuda.is_available():  # a path loads the model on the default device, the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tg2p.GraphemeToPhonemizer("en", oov_model=str(p))
    plain = tg2p.GraphemeToPhonemizer("en")
    assert plain.oov_model is None
    assert plain.word_to_ipa("cat") == jg2p.GraphemeToPhonemizer("en").word_to_ipa("cat")


def test_oov_model_defaults_to_the_card(g2p_models):
    _, tmodel = g2p_models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgt.G2PTransformer(CFG, tmodel.params, tmodel.out_vocab)
