"""The port's tokenizer-POS tagger (``tts/tok_pos.py``, inference) against
the JAX package's, on the CPU.

- ``forward`` on bridged random weights (``TokPosConfig()``, 128 wide, two
  blocks): both heads' logits to atol 1e-5 (float32 products of at most 512
  terms through two blocks).
- ``annotate`` and ``segment`` on zh and ja lines (and an empty one, one
  past ``max_len`` and one with unknown characters): the same words and
  tags, exactly.  Each case prints the smallest margin between the two
  best logits of a decision, where a last-bit difference could flip it.
- Artifacts written by either package load in the other, with their
  vocabulary, tags and config; a foreign safetensors file is refused.
- ``weights``' bridge round-trips the JAX tree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.tts import tok_pos as jtp
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.tts import tok_pos as ttp

LOGIT_TOL = dict(atol=1e-5, rtol=0)
LINES = ["数学是研究数量、结构以及空间等概念的一门学科。", "我们明天去北京。",
         "今日は良い天気です。", "東京に行きます", "アンパサンドは記号である。", "",
         "天" * 200, "𝔘𝔫𝔨𝔫𝔬𝔴𝔫 字"]
TAGS = ["NOUN", "VERB", "ADJ", "ADP", "PUNCT", "PRON", "ADV", "AUX", "PART", "PROPN", "NUM"]


def _vocab() -> list[str]:
    chars = sorted({c for line in LINES[:5] for c in line})
    return chars[:-3]  # leave a few characters unknown (UNK)


@pytest.fixture(scope="module")
def taggers():
    cfg = jtp.TokPosConfig()
    vocab = _vocab()
    jparams = jtp.init_params(cfg, jax.random.PRNGKey(3), len(vocab) + 2, len(TAGS))
    tree = jax.tree.map(np.asarray, jparams)
    jtag = jtp.TokPosTagger(cfg, jparams, vocab, TAGS)
    ttag = ttp.TokPosTagger(ttp.TokPosConfig(*cfg),
                            weights.tok_pos_params_from_jax_numpy(tree, "cpu"), vocab, TAGS,
                            device="cpu")
    return jtag, ttag, tree


def _margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("line", LINES)
def test_logits_and_annotate_match_jax(taggers, line):
    jtag, ttag, _ = taggers
    assert ttag.encode(line).tolist() == jtag.encode(line).tolist()
    src = jtag.encode(line.strip())[None, :]
    jbio, jpos = (np.asarray(a) for a in jtp.forward(jtag.params, jtag.cfg, jnp.asarray(src)))
    tbio, tpos = (a.numpy() for a in ttag.logits(line))
    np.testing.assert_allclose(tbio, jbio, **LOGIT_TOL)
    np.testing.assert_allclose(tpos, jpos, **LOGIT_TOL)
    n = min(len(line.strip()), jtag.cfg.max_len)
    if n:
        print(f"{line[:12]!r}: bio margin {_margin(jbio[0, :n]):.3e}, "
              f"pos margin {_margin(jpos[0, :n]):.3e}")
    assert ttag.annotate(line) == jtag.annotate(line)
    assert ttag.segment(line) == jtag.segment(line)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_artifact_loads_across_packages(taggers, tmp_path, writer):
    jtag, ttag, _ = taggers
    path = tmp_path / "tok_pos.safetensors"
    (jtag if writer == "jax" else ttag).save(path)
    jl, tl = jtp.TokPosTagger.load(path), ttp.TokPosTagger.load(path, device="cpu")
    for loaded in (jl, tl):
        assert loaded.cfg._asdict() == jtag.cfg._asdict()
        assert loaded.char_vocab == jtag.char_vocab and loaded.tags == TAGS
    for line in LINES[:5]:
        assert tl.annotate(line) == jl.annotate(line) == jtag.annotate(line)


def test_load_rejects_foreign_safetensors(tmp_path):
    p = tmp_path / "x.safetensors"
    weights.save_safetensors(p, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not a TokPosTagger artifact"):
        ttp.TokPosTagger.load(p, device="cpu")


def test_bridge_round_trip(taggers):
    _, ttag, tree = taggers
    back = weights.tok_pos_params_to_numpy(ttag.params)
    flat, ref = weights.flatten_tree(back), weights.flatten_tree(tree)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)


def test_init_params_shapes_match_jax():
    cfg = jtp.TokPosConfig(dim=64, layers=1, heads=4, max_len=32)
    jtree = jax.tree.map(np.asarray, jtp.init_params(cfg, jax.random.PRNGKey(0), 50, 7))
    model = ttp.init_params(ttp.TokPosConfig(*cfg), torch.Generator().manual_seed(0), 50, 7,
                            "cpu")
    ours = weights.flatten_tree(weights.tok_pos_params_to_numpy(model))
    assert {k: v.shape for k, v in ours.items()} == {
        k: v.shape for k, v in weights.flatten_tree(jtree).items()}
