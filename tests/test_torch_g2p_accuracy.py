"""The port's G2P accuracy harness (``eval/g2p_accuracy.py``) against the
JAX package's, on the CPU, exactly: ``phone_tokens``, ``_edit_distance``,
``evaluate`` and ``rules_predictor``, and ``main``'s ``rules`` and ``oov``
branches.

The baked dictionary ``main`` scores against is not in the repository, so
the ``main`` tests monkeypatch both packages' ``tts.g2p_dict.
load_baked_dict`` with a small synthetic one: the words of
``tests/data/g2p_ref/en.golden.tsv`` beside their golden IPA.  The ``oov``
branch trains both packages' ``distill`` (6 steps, with the default
config patched to 32 wide and one layer each way, so that the greedy
predictions over the ~300 training words stay cheap on one CPU thread)
from the same initial weights: the port's ``init_params`` is patched to
return JAX's (``PRNGKey(0)``, the seed ``main`` trains with).  Its printed
report must be the same, line for line; the per-step loss lines are held to
rtol 1e-4 (they print 4 decimals of float32 losses summed in another
order).
"""

from __future__ import annotations

import functools
import pathlib
import re

import jax
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_train_reference import jax_tree
from moonshine_tpu.eval import g2p_accuracy as jacc
from moonshine_tpu.train import g2p as jg
from moonshine_tpu.tts import g2p_dict as jdict
from moonshine_tpu.tts import g2p_transformer as jgt
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.eval import g2p_accuracy as tacc
from moonshine_tpu_torch.train import g2p as tg
from moonshine_tpu_torch.tts import g2p_dict as tdict
from moonshine_tpu_torch.tts import g2p_transformer as tgm

DATA = pathlib.Path(__file__).resolve().parent / "data" / "g2p_ref"
OOV_STEPS = 6


def golden_dictionary() -> dict[str, str]:
    """{word: IPA} from the English goldens, where a line's words and IPA
    words pair up one to one."""
    out = {}
    for line in (DATA / "en.golden.tsv").read_text(encoding="utf-8").splitlines():
        text, _, ipa = line.partition("\t")
        words = [re.sub(r"[^a-z']", "", w.lower()) for w in text.split()]
        ipas = ipa.split()
        if len(words) == len(ipas):
            out.update((w, p) for w, p in zip(words, ipas) if w)
    return out


def ipa_strings() -> list[str]:
    lines = (DATA / "en.golden.tsv").read_text(encoding="utf-8").splitlines()
    return [l.partition("\t")[2] for l in lines] + list(golden_dictionary().values()) + [
        "", " ", "ˈˌ", "aɪaʊeɪoʊɔɪtʃdʒ", "tɹˌɪpəlˈeɪ", "a ɪ", "ʧ"]


def test_golden_dictionary_is_usable():
    assert len(golden_dictionary()) > 40


@pytest.mark.parametrize("strip", [True, False])
def test_phone_tokens_match_jax(strip):
    for s in ipa_strings():
        assert tacc.phone_tokens(s, strip) == jacc.phone_tokens(s, strip), s


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(0)
    units = ["a", "b", "tʃ", "aɪ", "ə"]
    for _ in range(300):
        a = [units[i] for i in rng.integers(0, len(units), rng.integers(0, 9))]
        b = [units[i] for i in rng.integers(0, len(units), rng.integers(0, 9))]
        assert tacc._edit_distance(a, b) == jacc._edit_distance(a, b)
    assert tacc._edit_distance(list("kitten"), list("sitting")) == 3


@pytest.mark.parametrize("strip", [True, False])
def test_evaluate_matches_jax(strip):
    pairs = sorted(golden_dictionary().items())
    ours = tacc.evaluate(tacc.rules_predictor("en"), pairs, strip)
    ref = jacc.evaluate(jacc.rules_predictor("en"), pairs, strip)
    assert ours == ref
    assert 0 < ours["word_acc"] < 1 and ours["errors"]


@pytest.mark.parametrize("language", ["en", "de", "es", "fr", "it", "nl", "pt", "ru"])
def test_rules_predictor_matches_jax(language):
    text = (DATA / f"{language}.txt") if (DATA / f"{language}.txt").is_file() else \
        DATA / {"es": "es_mx.txt", "pt": "pt_br.txt"}[language]
    words = sorted({re.sub(r"[^\w'-]", "", w.lower())
                    for w in text.read_text(encoding="utf-8").split()} - {""})[:80]
    ours, ref = tacc.rules_predictor(language), jacc.rules_predictor(language)
    assert [ours(w) for w in words] == [ref(w) for w in words]


@pytest.fixture
def dictionary(monkeypatch):
    d = golden_dictionary()
    for mod in (jdict, tdict):
        monkeypatch.setattr(mod, "load_baked_dict", lambda path=None: dict(d))
    return d


def _run(main, argv, capsys) -> tuple[int, list[str]]:
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


def test_main_without_dictionary_matches_jax(capsys):
    assert _run(tacc.main, ["--device", "cpu"], capsys) == _run(jacc.main, [], capsys)


@pytest.mark.parametrize("argv", [[], ["--limit", "20", "--show-errors", "3"]])
def test_main_rules_matches_jax(dictionary, capsys, argv):
    rc, ours = _run(tacc.main, argv, capsys)
    assert (rc, ours) == _run(jacc.main, argv, capsys)
    words = min(len(dictionary), 20) if argv else len(dictionary)
    assert rc == 0 and ours[0].startswith(f"rules: {words} words")


def test_main_oov_matches_jax(dictionary, capsys, monkeypatch):
    def jax_init(cfg, generator, out_vocab_size, in_vocab_size=tgm.IN_VOCAB_SIZE, device=None):
        del generator
        tree = jax_tree(jgt.init_params(jgt.G2PModelConfig(*cfg), jax.random.PRNGKey(0),
                                        out_vocab_size, in_vocab_size))
        return weights.g2p_params_from_jax_numpy(tree, device)

    monkeypatch.setattr(tgm, "init_params", jax_init)
    for mod, cls in ((jg, jgt.G2PModelConfig), (tg, tgm.G2PModelConfig)):
        monkeypatch.setattr(mod, "G2PModelConfig", functools.partial(cls, dim=32, layers=1))
    argv = ["--predictor", "oov", "--steps", str(OOV_STEPS), "--show-errors", "100"]
    rc, ours = _run(tacc.main, argv + ["--device", "cpu"], capsys)
    ref_rc, ref = _run(jacc.main, argv, capsys)
    assert rc == ref_rc == 0
    step = re.compile(r"step (\d+)/(\d+) loss ([0-9.]+)")
    steps = [(step.match(a), step.match(b)) for a, b in zip(ours, ref) if step.match(b)]
    assert len(steps) == OOV_STEPS
    for a, b in steps:
        assert a and a.group(1, 2) == b.group(1, 2)
        np.testing.assert_allclose(float(a.group(3)), float(b.group(3)), rtol=1e-4)
    report = [l for l in ours if not step.match(l)]
    assert report == [l for l in ref if not step.match(l)]
    assert report[0].startswith("train exact-match") and report[1].startswith("oov: ")
