"""The port's spelling and diarization trainers against the JAX package's,
on the CPU, on synthetic voices (the reference's recordings are not here).

Spelling (``train/spelling.py``):
- ``load_directory_dataset`` and ``augment`` (one numpy generator) give
  JAX's arrays exactly;
- ``_loss_fn`` and its gradients against ``jax.value_and_grad`` of JAX's:
  the loss to rtol 1e-5, every gradient leaf within 1e-3 of its largest
  |g| (``SPELLING_GRAD_REL``: the first biases sum about 2.4e4 terms of
  both signs);
- ``train`` from JAX's initial weights sees JAX's batches: its first loss
  equals JAX's to rtol 1e-5 (later ones are not held to float32, since
  Adam's first update amplifies rounding).

Diarization (``train/diarization.py``):
- the numpy data building (``voiced_crops``, ``make_training_windows``,
  ``_embedding_examples``, ``_powerset_class_table``) equals JAX's exactly;
- the permutation-invariant powerset loss and its gradients, on windows
  where two speakers talk at the same frames so that two permutations tie
  (``torch.amin`` spreads the gradient over the tie as ``jnp.min`` does),
  and the pairwise contrastive loss and its gradients: the losses to rtol
  1e-5, the gradients within 1e-4 of each leaf's largest |g| (or 1e-7 of
  the model's largest, for the pooling scores' bias, whose gradient is zero
  in exact arithmetic);
- ``train_segmentation`` and ``train_embedding`` from JAX's initial
  weights: one step's loss equals JAX's to rtol 1e-5;
- ``fit_plda`` gives JAX's PLDA to 1e-10 (float64 numpy and scipy both);
- ``train_diarization_models`` runs end to end on the CPU.
"""

from __future__ import annotations

import copy
from itertools import permutations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.audio.wav import save_wav
from moonshine_tpu.models import diarization as jdm
from moonshine_tpu.models import spelling as jsp
from moonshine_tpu.train import diarization as jtd
from moonshine_tpu.train import spelling as jts
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.train import diarization as ttd
from moonshine_tpu_torch.train import spelling as tts

GRAD_REL = 1e-4
# The spelling CNN's first biases sum about 2.4e4 terms of both signs (one
# per position of its 100 x 40 map, per clip), so the summation order moves
# them by up to 2.4e-4 of the leaf's largest |g|.
SPELLING_GRAD_REL = 1e-3
# A leaf whose gradient is zero in exact arithmetic (the pooling scores'
# bias, under a softmax) holds only rounding: held to 1e-7 of the model's
# largest |g| instead.
ZERO_LEAF_REL = 1e-7
SEG_DIM, EMB_DIM = 8, 8
SEG_FRAMES = 251  # the segmentation net's output frames for a 10 s window
MEL_FRAMES = 1001


def assert_grads_close(ours: dict, theirs: dict, rel: float = GRAD_REL) -> None:
    assert set(ours) == set(theirs)
    top = max(float(np.abs(np.asarray(v)).max()) for v in theirs.values())
    for k, v in theirs.items():
        v = np.asarray(v)
        bound = max(rel * float(np.abs(v).max()), ZERO_LEAF_REL * top)
        err = float(np.abs(ours[k] - v).max())
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


def grads_of(model, to_numpy) -> dict:
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.detach().clone()
    return weights.flatten_tree(to_numpy(g))


def trainable(model):
    for p in model.parameters():
        p.requires_grad_(True)
    return model


# -- spelling ----------------------------------------------------------------

def _clip(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(12000) / 16000
    f0 = 120 + 40 * seed % 200
    return (0.3 * np.sin(2 * np.pi * f0 * t) * np.hanning(len(t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def spelling_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spelling")
    for i, cls in enumerate(["a", "b", "seven"]):
        (root / cls).mkdir()
        for j in range(3):
            save_wav(str(root / cls / f"{j}.wav"), _clip(3 * i + j), 16000)
    (root / "notaclass").mkdir()
    return str(root)


def test_spelling_dataset_and_augment_equal_jax_s(spelling_dir):
    ours, theirs = tts.load_directory_dataset(spelling_dir), jts.load_directory_dataset(
        spelling_dir)
    np.testing.assert_array_equal(ours.audio, theirs.audio)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.names == theirs.names and len(ours.names) == 9
    np.testing.assert_array_equal(tts.augment(np.random.default_rng(4), ours.audio),
                                  jts.augment(np.random.default_rng(4), theirs.audio))


def test_spelling_loss_and_gradients_match_jax(spelling_dir):
    data = jts.load_directory_dataset(spelling_dir)
    params = jsp.init_params(jax.random.PRNGKey(1))
    audio, labels = data.audio[:6], data.labels[:6]
    loss, grads = jax.value_and_grad(jts._loss_fn)(params, jnp.asarray(audio),
                                                   jnp.asarray(labels))
    model = trainable(weights.spelling_params_from_jax_numpy(jax.tree.map(np.asarray, params),
                                                            "cpu"))
    with torch.enable_grad():
        tloss = tts._loss_fn(model, torch.from_numpy(audio), torch.from_numpy(labels))
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert_grads_close(grads_of(model, weights.spelling_params_to_numpy),
                       weights.flatten_tree(jax.tree.map(np.asarray, grads)), SPELLING_GRAD_REL)


def test_spelling_train_sees_jax_s_batches(spelling_dir):
    data = jts.load_directory_dataset(spelling_dir)
    ref = jts.train(data, epochs=1, batch_size=4, lr=3e-3, seed=2)
    init = weights.spelling_params_from_jax_numpy(
        jax.tree.map(np.asarray, jsp.init_params(jax.random.PRNGKey(2))), "cpu")
    out = tts.train(tts.load_directory_dataset(spelling_dir), epochs=1, batch_size=4, lr=3e-3,
                    seed=2, init_params=init)
    assert len(out.losses) == len(ref.losses) == 2
    np.testing.assert_allclose(out.losses[0], ref.losses[0], rtol=1e-5)
    assert 0.0 <= out.train_accuracy <= 1.0
    assert not any(p.requires_grad for p in out.params.parameters())
    assert not any(p.requires_grad for p in init.parameters())


# -- diarization -----------------------------------------------------------

def _voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A voiced signal with pauses: harmonics of ``f0`` under a syllable
    envelope, and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    env = np.clip(np.sin(2 * np.pi * 2.1 * t + seed), 0, None) ** 2
    wave = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 5))
    return (0.2 * env * wave + 0.003 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def crops():
    return [jtd.voiced_crops(_voice(6.0, f0, s)) for s, f0 in ((0, 110.0), (1, 210.0))]


def test_diarization_data_equals_jax_s(crops):
    assert ttd._seg_frames("cpu") == SEG_FRAMES
    for seed, f0 in ((0, 110.0), (1, 210.0)):
        np.testing.assert_array_equal(ttd.voiced_crops(_voice(6.0, f0, seed)),
                                      jtd.voiced_crops(_voice(6.0, f0, seed)))
    np.testing.assert_array_equal(ttd._powerset_class_table(), jtd._powerset_class_table())
    for a, b in zip(ttd.make_training_windows(np.random.default_rng(3), crops, 3, SEG_FRAMES),
                    jtd.make_training_windows(np.random.default_rng(3), crops, 3, SEG_FRAMES)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttd._embedding_examples(np.random.default_rng(5), crops, 3, MEL_FRAMES, SEG_FRAMES),
                    jtd._embedding_examples(np.random.default_rng(5), crops, 3, MEL_FRAMES, SEG_FRAMES)):
        np.testing.assert_array_equal(a, b)


def _tied_activity(b: int, frames: int) -> np.ndarray:
    """Speakers 0 and 1 active at the same frames, speaker 2 silent: the
    permutations that swap 0 and 1 give equal losses."""
    act = np.zeros((b, frames, 3), np.float32)
    act[:, frames // 4:frames // 2, :2] = 1.0
    act[1:, 3 * frames // 4:, 2] = 1.0
    return act


def test_powerset_loss_and_gradients_match_jax_at_a_tie(crops):
    params = jdm.init_segmentation_params(jax.random.PRNGKey(4), dim=SEG_DIM, depth=1)
    windows, _ = jtd.make_training_windows(np.random.default_rng(0), crops, 2, SEG_FRAMES)
    activity = _tied_activity(2, SEG_FRAMES)
    table = jtd._powerset_class_table()
    perms = [jnp.asarray(p, jnp.int32) for p in permutations(range(3))]
    loss, grads = jax.value_and_grad(jtd._pit_powerset_loss)(
        params, jnp.asarray(windows), jnp.asarray(activity), jnp.asarray(table), perms)
    model = trainable(weights.segmentation_params_from_jax_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    with torch.enable_grad():
        tloss = ttd._pit_powerset_loss(model, torch.from_numpy(windows),
                                       torch.from_numpy(activity), torch.from_numpy(table),
                                       ttd._speaker_permutations("cpu"))
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert_grads_close(grads_of(model, weights.segmentation_params_to_numpy),
                       weights.flatten_tree(jax.tree.map(np.asarray, grads)))


def test_powerset_loss_spreads_the_gradient_over_a_tie():
    """At a tie the gradient goes half to each tied permutation, as
    ``jax.grad`` of ``jnp.min`` gives it (``torch.min(dim=)`` would give
    all of it to one)."""
    logits = torch.zeros((1, 4, 7), requires_grad=True)
    activity = torch.from_numpy(_tied_activity(1, 4))
    table = torch.from_numpy(ttd._powerset_class_table())
    with torch.enable_grad():
        ttd.pit_powerset_loss_from_logits(logits, activity, table,
                                          ttd._speaker_permutations("cpu")).backward()

    def jax_loss(lg):
        logp = jax.nn.log_softmax(lg, -1)
        tbl = jnp.asarray(jtd._powerset_class_table())
        losses = []
        for p in permutations(range(3)):
            bits = (jnp.asarray(activity.numpy())[:, :, list(p)].astype(jnp.int32)
                    * 2 ** jnp.arange(3)).sum(-1)
            losses.append(-jnp.take_along_axis(logp, tbl[bits][..., None], -1)[..., 0].mean(1))
        return jnp.min(jnp.stack(losses), axis=0).mean()

    ref = jax.grad(jax_loss)(jnp.zeros((1, 4, 7)))
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(ref), atol=1e-7)


def test_contrastive_loss_and_gradients_match_jax(crops):
    params = jdm.init_embedding_params(jax.random.PRNGKey(5), dim=EMB_DIM)
    xs, ws, ys = jtd._embedding_examples(np.random.default_rng(2), crops, 3, MEL_FRAMES, SEG_FRAMES)
    xs, ws, ys = xs[:4], ws[:4], ys[:4]
    loss, grads = jax.value_and_grad(jtd._contrastive_loss)(
        {"emb": params}, jnp.asarray(xs), jnp.asarray(ws), jnp.asarray(ys))
    model = trainable(weights.embedding_params_from_jax_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    with torch.enable_grad():
        tloss = ttd._contrastive_loss(model, *(torch.from_numpy(v) for v in (xs, ws, ys)))
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert_grads_close(grads_of(model, weights.embedding_params_to_numpy),
                       weights.flatten_tree(jax.tree.map(np.asarray, grads["emb"])))


def test_trainers_first_step_matches_jax(crops):
    key = jax.random.PRNGKey(6)
    ref = jtd.train_segmentation(key, crops, dim=SEG_DIM, steps=1, batch=2, pool_windows=3)
    init = weights.segmentation_params_from_jax_numpy(jax.tree.map(
        np.asarray, jdm.init_segmentation_params(key, dim=SEG_DIM, depth=1)), "cpu")
    out = ttd.train_segmentation(None, crops, dim=SEG_DIM, steps=1, batch=2, pool_windows=3,
                                 init_params=init)
    np.testing.assert_allclose(out["final_loss"], ref["final_loss"], rtol=1e-5)

    ref = jtd.train_embedding(key, crops, dim=EMB_DIM, steps=1, batch=4, pool_windows=3)
    kp, _ = jax.random.split(key)
    init = weights.embedding_params_from_jax_numpy(jax.tree.map(
        np.asarray, jdm.init_embedding_params(kp, dim=EMB_DIM)), "cpu")
    out = ttd.train_embedding(None, crops, dim=EMB_DIM, steps=1, batch=4, pool_windows=3,
                              init_params=init)
    np.testing.assert_allclose(out["final_loss"], ref["final_loss"], rtol=1e-5)
    for a, b in zip(out["examples"], ref["examples"]):
        np.testing.assert_array_equal(a, b)


def test_fit_plda_equals_jax_s():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((3, 12))
    labels = np.repeat(np.arange(3), 10)
    emb = centers[labels] + 0.3 * rng.standard_normal((30, 12))
    ours, theirs = ttd.fit_plda(emb, labels), jtd.fit_plda(emb, labels)
    for field in ("mean1", "mean2", "lda", "plda_mu", "plda_tr", "phi_between"):
        np.testing.assert_allclose(getattr(ours, field), getattr(theirs, field), atol=1e-10,
                                   err_msg=field)
    assert ours.lda_dimension == theirs.lda_dimension


def test_train_diarization_models_runs_on_the_cpu():
    waves = [_voice(6.0, 110.0, 0), _voice(6.0, 210.0, 1)]
    out = ttd.train_diarization_models(torch.Generator().manual_seed(0), waves,
                                       seg_dim=SEG_DIM, emb_dim=EMB_DIM, seg_steps=2,
                                       emb_steps=2, device="cpu")
    assert np.isfinite(out["seg_loss"]) and np.isfinite(out["emb_loss"])
    assert out["plda"].plda_tr.shape == (192, 192)
    assert not any(p.requires_grad for p in out["embedding"].parameters())
