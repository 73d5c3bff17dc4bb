"""The port's G2P distillation trainer (``train/g2p.py``, ``train.step``'s
schedule) against the JAX package's, on the CPU, from JAX's initial
weights (``weights.g2p_params_from_jax_numpy``) and on the same numpy
batches.

- ``build_dataset``: the same (word, IPA) pairs, exactly, for several
  languages.
- ``warmup_cosine_decay_schedule`` against optax's at every count of the
  three trainers' schedules (the default lengths and short ones): rtol 1e-6.
  optax computes in float32 and the port follows its order; the cosine is
  rounded once, where XLA's differs by one ulp at a few counts.
- The masked loss: rtol 1e-5 (float32 sums over at most 64 x 39 targets in
  another order); its gradients: each leaf within 1e-4 of its largest |g|.
- Twelve steps of ``make_train_step`` against JAX's on the same batches,
  with a warm-up of 2, so that ten steps have lr > 0: every loss to rtol
  1e-4.  The parameters after them to atol 1e-5, except the attention key
  biases (the k third of ``qkv/b``, the k half of ``x_kv/b``): softmax is
  invariant to them, so their exact gradient is 0 and both packages'
  gradients are rounding noise, which Adam scales to a step of up to lr of
  either sign; they are held to twice the summed lr.
- ``distill`` with ``limit`` and ``steps`` small: the same accuracy and the
  same predictions, exactly.
- A port-trained model saved with ``save`` loads in JAX's
  ``G2PTransformer.load`` and predicts the same.
- The repaired forwards: a gradient of ``decoder_logits``' output reaches
  a parameter; the inference entry points record no graph.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from torch_train_reference import assert_grads_close, assert_params_close, grad_tree, jax_tree
from moonshine_tpu.train import g2p as jg
from moonshine_tpu.tts import g2p_transformer as jgt
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.train import g2p as tg
from moonshine_tpu_torch.train import step as ts
from moonshine_tpu_torch.tts import g2p_transformer as tgm

CFG = jgt.G2PModelConfig(dim=32, layers=1, heads=4, max_word=16, max_ipa=24)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_LOSS_RTOL = 1e-4
# (peak lr, warm-up, steps): distill's, ja_reader's and tok_pos's defaults,
# and short runs of each.
SCHEDULES = [(3e-3, 100, 2000), (3e-3, 100, 1200), (2e-3, 80, 800), (3e-3, 2, 40),
             (5e-3, 1, 20), (3e-3, 100, 300), (2e-3, 80, 300)]


def bridged(params, device="cpu"):
    return weights.g2p_params_from_jax_numpy(jax_tree(params), device)


# Without the baked dictionary, English's engine gives 212 pairs, the
# Japanese and Chinese lexicons theirs, the rule-only engines none.
@pytest.mark.parametrize("language,count", [("en", 212), ("ja", 712), ("zh", 23), ("de", 0)])
def test_build_dataset_matches_jax(language, count):
    _, ours = tg.build_dataset(language)
    _, ref = jg.build_dataset(language)
    assert ours == ref
    assert len(ours) == count


def test_build_dataset_extra_and_exclude_match_jax():
    extra, exclude = ["zebra", "quokka", "xylophone"], {"cat", "dog"}
    assert tg.build_dataset("en", extra, exclude=exclude)[1] == \
        jg.build_dataset("en", extra, exclude=exclude)[1]


@pytest.mark.parametrize("peak,warmup,steps", SCHEDULES)
def test_schedule_matches_optax(peak, warmup, steps):
    ref = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    ours = ts.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    counts = range(steps + 3)
    expect = np.asarray(jax.vmap(ref)(jnp.arange(steps + 3)), np.float64)
    got = np.array([ours(i) for i in counts])
    assert got[0] == expect[0] == 0.0  # the first update is zero: lr 0 at count 0
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=0)


def _data(n: int = 40):
    _, pairs = jg.build_dataset("en")
    pairs = pairs[:n]
    vocab = jgt.G2PTransformer.build_out_vocab(ipa for _, ipa in pairs)
    holder = jgt.G2PTransformer(CFG, {}, vocab)
    src = np.stack([jgt.encode_word(w, CFG.max_word) for w, _ in pairs])
    tgt = np.stack([holder.encode_ipa(ipa) for _, ipa in pairs])
    return pairs, vocab, src, tgt


def test_loss_and_grads_match_jax():
    _, vocab, src, tgt = _data()
    jparams = jgt.init_params(CFG, jax.random.PRNGKey(1), len(vocab))
    tin, tout = tgt[:, :-1], tgt[:, 1:]
    mask = (tout != jgt.PAD).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(jg._loss_fn), static_argnums=(1,))(
        jparams, CFG, jnp.asarray(src), jnp.asarray(tin), jnp.asarray(tout), jnp.asarray(mask))
    model = bridged(jparams)
    for p in model.parameters():
        p.requires_grad_(True)
    ours = tg._loss_fn(model, tgm.G2PModelConfig(*CFG), torch.from_numpy(src),
                       torch.from_numpy(tin), torch.from_numpy(tout), torch.from_numpy(mask))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=LOSS_RTOL)
    assert_grads_close(grad_tree(model, weights.g2p_params_to_numpy),
                       weights.flatten_tree(jax_tree(grads)), GRAD_REL)


def test_train_steps_match_jax():
    pairs, vocab, src, tgt = _data()
    steps, warmup, peak = 12, 2, 3e-3
    jparams = jgt.init_params(CFG, jax.random.PRNGKey(2), len(vocab))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps))
    opt_state, jstep = tx.init(jparams), jg.make_train_step(tx)
    sched = ts.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    state, tstep = tg.train_state(bridged(jparams), peak), tg.make_train_step(sched)
    rng = np.random.default_rng(0)
    params = jparams
    for i in range(steps):
        idx = rng.integers(0, len(pairs), 16)
        params, opt_state, jloss = jstep(params, opt_state,
                                         (jnp.asarray(src[idx]), jnp.asarray(tgt[idx])), CFG)
        state, loss = tstep(state, (torch.from_numpy(src[idx]), torch.from_numpy(tgt[idx])),
                            tgm.G2PModelConfig(*CFG))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL, err_msg=str(i))
    assert state.step == steps
    assert_params_close(weights.flatten_tree(weights.g2p_params_to_numpy(state.params)),
                        weights.flatten_tree(jax_tree(params)), CFG.dim,
                        sum(sched(i) for i in range(steps)))


@pytest.fixture(scope="module")
def distilled():
    """JAX's and the port's ``distill`` on the first 24 pairs, 30 steps of
    batch 16, from JAX's initial weights."""
    limit, seed = 24, 3
    _, pairs = jg.build_dataset("en")
    vocab = jgt.G2PTransformer.build_out_vocab(ipa for _, ipa in pairs[:limit])
    init = bridged(jgt.init_params(CFG, jax.random.PRNGKey(seed), len(vocab)))
    kw = dict(steps=30, batch_size=16, lr=5e-3, limit=limit, seed=seed)
    jmodel, jacc = jg.distill("en", CFG, **kw)
    tmodel, tacc = tg.distill("en", tgm.G2PModelConfig(*CFG), init_params=init, **kw)
    return pairs[:limit], jmodel, jacc, tmodel, tacc


def test_distill_matches_jax(distilled):
    pairs, jmodel, jacc, tmodel, tacc = distilled
    assert tacc == jacc
    words = [w for w, _ in pairs] + ["zebra", "quokka"]
    assert tmodel.predict_batch(words) == jmodel.predict_batch(words)
    assert tmodel.out_vocab == jmodel.out_vocab
    assert not any(p.requires_grad for p in tmodel.params.parameters())  # frozen
    assert_params_close(weights.flatten_tree(weights.g2p_params_to_numpy(tmodel.params)),
                        weights.flatten_tree(jax_tree(jmodel.params)), CFG.dim, 30 * 5e-3)


def test_port_trained_model_loads_in_jax(distilled, tmp_path):
    pairs, _, _, tmodel, _ = distilled
    path = tmp_path / "oov.safetensors"
    tmodel.save(path)
    loaded = jgt.G2PTransformer.load(path)
    words = [w for w, _ in pairs[:12]] + ["xylophone"]
    assert loaded.out_vocab == tmodel.out_vocab
    assert loaded.predict_batch(words) == tmodel.predict_batch(words)


def test_main_writes_a_model_jax_loads(tmp_path, capsys):
    path = tmp_path / "en_oov.safetensors"
    tg.main(["--out", str(path), "--steps", "3", "--dim", "32", "--layers", "1",
             "--device", "cpu"])
    assert "distillation exact-match" in capsys.readouterr().out
    ours, ref = tgm.G2PTransformer.load(path, device="cpu"), jgt.G2PTransformer.load(path)
    assert ours.cfg._asdict() == ref.cfg._asdict() and ours.cfg.dim == 32
    assert ours.predict_batch(["cat", "zebra"]) == ref.predict_batch(["cat", "zebra"])


def test_decoder_logits_gradient_reaches_parameters():
    _, vocab, src, tgt_ids = _data(8)
    cfg = tgm.G2PModelConfig(*CFG)
    model = tgm.init_params(cfg, torch.Generator().manual_seed(0), len(vocab), device="cpu")
    head = model.head.weight
    head.requires_grad_(True)
    memory, valid = tgm.encode(model, cfg, torch.from_numpy(src))
    tgm.decoder_logits(model, cfg, memory, valid, torch.from_numpy(tgt_ids[:, :-1])).sum().backward()
    assert head.grad is not None and float(head.grad.abs().sum()) > 0


def test_inference_entry_points_record_no_graph():
    _, vocab, src, _ = _data(8)
    cfg = tgm.G2PModelConfig(*CFG)
    model = tgm.init_params(cfg, torch.Generator().manual_seed(0), len(vocab), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    out = tgm.greedy(model, cfg, torch.from_numpy(src))
    assert torch.is_inference(out) and not out.requires_grad
    holder = tgm.G2PTransformer(cfg, model, vocab, device="cpu")
    assert holder.predict_batch(["cat"]) == holder.predict_batch(["cat"])
    assert all(p.grad is None for p in model.parameters())
