"""The port's tagger and Japanese-reader trainers (``train/tok_pos.py``,
``train/ja_reader.py``) against the JAX package's, on the CPU.

The reference corpora they train on are not in the repository, so both
packages read ``chip_smoke.write_reference_corpora``'s synthetic ones
(kanji words of the in-repo ja tables with kana particles, zh words of
``tts/data/zh_pinyin.tsv``, in the corpora's own formats): the tests
monkeypatch ``tts/ja_align.REF_JA_DIR`` and ``train/tok_pos.CORPORA`` in
both packages.

- ``load_corpus``, ``make_labels`` and ``build_ja_dataset``: exactly.
- The BIO+UPOS loss: rtol 1e-5; its gradients: each leaf within 1e-4 of
  its largest |g| (float32 sums in another order).
- Twelve tagger steps against JAX's step (its ``_loss`` under
  ``optax.adamw`` over the same schedule) on the same batches, with a
  warm-up of 2: every loss to rtol 1e-4.
- ``train_tok_pos`` and ``train_ja_reader`` from JAX's initial weights
  (90 and 110 steps: their warm-ups are 80 and 100, and optax refuses a
  run no longer than its warm-up): the same annotations, ``word_f1`` and
  predictions, exactly; the parameters to atol 1e-4 but the attention key
  biases (their exact gradient is 0, and both packages step them by
  rounding noise of up to lr a step; over ~100 steps that difference feeds
  the other parameters' gradients, and moved some by 1.4e-5).  The reader
  drives both packages' ``JapaneseG2P(neural=...)`` to the same IPA.
- ``word_f1`` exactly, on one tagger's weights in both packages.
"""

from __future__ import annotations

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_reference import assert_grads_close, assert_params_close, grad_tree, jax_tree
from moonshine_tpu.train import ja_reader as jjr
from moonshine_tpu.train import tok_pos as jtt
from moonshine_tpu.tts import g2p_transformer as jgt
from moonshine_tpu.tts import ja_align as jja
from moonshine_tpu.tts import lang_rules as jlr
from moonshine_tpu.tts import tok_pos as jtp
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.train import ja_reader as tjr
from moonshine_tpu_torch.train import step as ts
from moonshine_tpu_torch.train import tok_pos as ttt
from moonshine_tpu_torch.tts import g2p_transformer as tgm
from moonshine_tpu_torch.tts import ja_align as tja
from moonshine_tpu_torch.tts import lang_rules as tlr
from moonshine_tpu_torch.tts import tok_pos as ttp

TCFG = jtp.TokPosConfig(dim=32, layers=1, heads=4, max_len=32)
RCFG = jgt.G2PModelConfig(dim=32, layers=1, heads=4, max_word=10, max_ipa=32)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_LOSS_RTOL = 1e-4
TAGGER_STEPS = 90
READER_STEPS = 110
READER_LINES = 60
LONG_RUN_PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def corpora(tmp_path_factory):
    paths = chip_smoke.write_reference_corpora(str(tmp_path_factory.mktemp("reference")))
    ja_dir, zh = pathlib.Path(paths["ja"]), pathlib.Path(paths["zh"])
    files = {"zh": zh, "ja": ja_dir / "tok_pos_wiki_100.txt"}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jja, tja):
            mp.setattr(mod, "REF_JA_DIR", ja_dir)
        for mod in (jtt, ttt):
            mp.setattr(mod, "CORPORA", dict(files))
        yield paths


def _vocab(lang: str):
    rows = jtt.load_corpus(lang)
    train = rows[:int(len(rows) * 0.8)]
    chars = sorted({c for text, _ in train for c in text})
    tags = sorted({t for _, toks in train for _, t in toks})
    return rows, train, chars, tags


@pytest.mark.parametrize("lang", ["zh", "ja"])
def test_load_corpus_matches_jax(lang):
    rows = ttt.load_corpus(lang)
    assert rows == jtt.load_corpus(lang)
    assert len(rows) == {"zh": chip_smoke.CORPUS_ZH_LINES, "ja": chip_smoke.CORPUS_JA_LINES}[lang]


@pytest.mark.parametrize("lang", ["zh", "ja"])
def test_make_labels_matches_jax(lang):
    _, train, chars, tags = _vocab(lang)
    jparams = jtp.init_params(TCFG, jax.random.PRNGKey(0), len(chars) + 2, len(tags))
    jtag = jtp.TokPosTagger(TCFG, jparams, chars, tags)
    ttag = ttp.TokPosTagger(ttp.TokPosConfig(*TCFG), weights.tok_pos_params_from_jax_numpy(
        jax_tree(jparams), "cpu"), chars, tags, device="cpu")
    for ours, ref in zip(ttt.make_labels(train, TCFG, ttag), jtt.make_labels(train, TCFG, jtag)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_build_ja_dataset_matches_jax():
    for lines in (READER_LINES, 80):
        pairs, readings = tjr.build_ja_dataset(lines)
        ref_pairs, ref_readings = jjr.build_ja_dataset(lines)
        assert pairs == ref_pairs
        assert readings == ref_readings
        assert len(readings) > 10 and len(set(pairs)) > 30


def _tagger_data():
    _, train, chars, tags = _vocab("zh")
    jparams = jtp.init_params(TCFG, jax.random.PRNGKey(4), len(chars) + 2, len(tags))
    jtag = jtp.TokPosTagger(TCFG, jparams, chars, tags)
    return jparams, jtt.make_labels(train, TCFG, jtag)


def test_tagger_loss_and_grads_match_jax():
    jparams, data = _tagger_data()
    batch = tuple(a[:16] for a in data)
    loss, grads = jax.jit(jax.value_and_grad(jtt._loss), static_argnums=(1,))(
        jparams, TCFG, tuple(jnp.asarray(a) for a in batch))
    model = weights.tok_pos_params_from_jax_numpy(jax_tree(jparams), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    ours = ttt._loss(model, ttp.TokPosConfig(*TCFG), tuple(torch.from_numpy(a) for a in batch))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=LOSS_RTOL)
    assert_grads_close(grad_tree(model, weights.tok_pos_params_to_numpy),
                       weights.flatten_tree(jax_tree(grads)), GRAD_REL)


def test_tagger_steps_match_jax():
    jparams, data = _tagger_data()
    steps, warmup, peak = 12, 2, ttt.LR
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps))

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jtt._loss)(params, TCFG, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    sched = ts.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    state = ttt.train_state(weights.tok_pos_params_from_jax_numpy(jax_tree(jparams), "cpu"), peak)
    tstep = ttt.make_train_step(sched)
    params, opt_state = jparams, tx.init(jparams)
    rng = np.random.RandomState(0)
    for i in range(steps):
        idx = rng.randint(0, len(data[0]), size=16)
        params, opt_state, jloss = jstep(params, opt_state, tuple(jnp.asarray(a[idx]) for a in data))
        state, loss = tstep(state, tuple(torch.from_numpy(a[idx]) for a in data),
                            ttp.TokPosConfig(*TCFG))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL, err_msg=str(i))
    assert_params_close(weights.flatten_tree(weights.tok_pos_params_to_numpy(state.params)),
                        weights.flatten_tree(jax_tree(params)), TCFG.dim,
                        sum(sched(i) for i in range(steps)))


@pytest.fixture(scope="module")
def taggers(corpora):
    _, _, chars, tags = _vocab("zh")
    seed = 5
    init = weights.tok_pos_params_from_jax_numpy(jax_tree(jtp.init_params(
        TCFG, jax.random.PRNGKey(seed), len(chars) + 2, len(tags))), "cpu")
    jres = jtt.train_tok_pos("zh", TCFG, steps=TAGGER_STEPS, seed=seed)
    tres = ttt.train_tok_pos("zh", ttp.TokPosConfig(*TCFG), steps=TAGGER_STEPS, seed=seed,
                             init_params=init)
    return jres, tres


def test_train_tok_pos_matches_jax(taggers):
    (jtag, jtrain, jheld), (ttag, ttrain, theld) = taggers
    assert (ttrain, theld) == (jtrain, jheld)
    assert (ttag.char_vocab, ttag.tags) == (jtag.char_vocab, jtag.tags)
    for text, _ in jtrain + jheld:
        assert ttag.annotate(text) == jtag.annotate(text)
    for rows in (jtrain, jheld):
        for with_pos in (False, True):
            assert ttt.word_f1(ttag, rows, with_pos) == jtt.word_f1(jtag, rows, with_pos)
    assert_params_close(weights.flatten_tree(weights.tok_pos_params_to_numpy(ttag.params)),
                        weights.flatten_tree(jax_tree(jtag.params)), TCFG.dim,
                        TAGGER_STEPS * ttt.LR, LONG_RUN_PARAM_ATOL)


def test_word_f1_matches_jax_on_one_taggers_weights(taggers):
    (jtag, jtrain, jheld), _ = taggers
    ours = ttp.TokPosTagger(ttp.TokPosConfig(*TCFG), weights.tok_pos_params_from_jax_numpy(
        jax_tree(jtag.params), "cpu"), jtag.char_vocab, jtag.tags, device="cpu")
    scores = []
    for rows in (jtrain, jheld, jtrain[:5]):
        for with_pos in (False, True):
            f1 = ttt.word_f1(ours, rows, with_pos)
            assert f1 == jtt.word_f1(jtag, rows, with_pos)
            scores.append(f1)
    assert 0 < min(scores) and max(scores) <= 1


def test_tok_pos_main_runs_on_cpu(capsys, monkeypatch):
    """``main``'s flags and report, on ``TCFG`` (its own config is the
    published width)."""
    monkeypatch.setattr(ttt, "train_tok_pos", functools.partial(
        ttt.train_tok_pos, cfg=ttp.TokPosConfig(*TCFG)))
    ttt.main(["--lang", "ja", "--steps", "81", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ja: train-fit seg F1" in out and "held-out seg+UPOS F1" in out


@pytest.fixture(scope="module")
def readers(corpora):
    data, _ = jjr.build_ja_dataset(READER_LINES)
    in_vocab = jgt.G2PTransformer.build_in_vocab(s for s, _ in data)
    out_vocab = jgt.G2PTransformer.build_out_vocab(p for _, p in data)
    seed = 6
    init = weights.g2p_params_from_jax_numpy(jax_tree(jgt.init_params(
        RCFG, jax.random.PRNGKey(seed), len(out_vocab), len(in_vocab) + 4)), "cpu")
    jreader = jjr.train_ja_reader(READER_LINES, RCFG, steps=READER_STEPS, seed=seed)
    treader = tjr.train_ja_reader(READER_LINES, tgm.G2PModelConfig(*RCFG), steps=READER_STEPS,
                                  seed=seed, init_params=init)
    return data, jreader, treader


def test_train_ja_reader_matches_jax(readers):
    data, jreader, treader = readers
    assert (treader.in_vocab, treader.out_vocab) == (jreader.in_vocab, jreader.out_vocab)
    spans = sorted({s for s, _ in data}) + ["山川", "学校"]
    assert treader.predict_batch(spans) == jreader.predict_batch(spans)
    assert_params_close(weights.flatten_tree(weights.g2p_params_to_numpy(treader.params)),
                        weights.flatten_tree(jax_tree(jreader.params)), RCFG.dim,
                        READER_STEPS * tjr.LR, LONG_RUN_PARAM_ATOL)


@pytest.mark.parametrize("line", [chip_smoke.JA_NEURAL_LINE, "山川", "東京の人"])
def test_reader_drives_japanese_g2p_as_jax(readers, line):
    _, jreader, treader = readers
    kw = dict(lexicon={"学校": "gakkoɯ"}, use_harvested=False, use_onyomi=False)
    ours = tlr.JapaneseG2P(neural=treader, **kw).word_to_ipa(line)
    assert ours == jlr.JapaneseG2P(neural=jreader, **kw).word_to_ipa(line)
    assert ours


def test_tagger_forward_trains_and_inference_records_no_graph():
    _, train, chars, tags = _vocab("zh")
    cfg = ttp.TokPosConfig(*TCFG)
    model = ttp.init_params(cfg, torch.Generator().manual_seed(0), len(chars) + 2, len(tags),
                            "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    tagger = ttp.TokPosTagger(cfg, model, chars, tags, device="cpu")
    bio, pos = ttp.forward(model, cfg, torch.from_numpy(tagger.encode(train[0][0])[None]))
    (bio.sum() + pos.sum()).backward()
    assert model.embed.grad is not None and model.head_pos.weight.grad is not None
    model.zero_grad(set_to_none=True)
    out = tagger.logits(train[0][0])
    assert all(torch.is_inference(t) and not t.requires_grad for t in out)
    assert tagger.annotate(train[0][0]) and all(p.grad is None for p in model.parameters())
