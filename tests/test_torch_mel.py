"""The port's log-mel frontends and its real-weight TinyVad against the JAX
package's, on the CPU, on seeded numpy inputs.

TinyVad runs an in-memory graph of TinyVadCNN's contract
(``chip_smoke.tinyvad_graph``; the real export is not in the repository): the
masked batched path against the per-stream unmasked one (the contract of
tests/test_serving.py), and both against JAX's ``TinyVad(graph)``.

Tolerances: log-mel values to atol = rtol = 1e-4: float32 products of 400
or 512 samples summed in another order, then a log, whose derivative
1/mel is large in the low bins whose energy is near eps (there the
values are large and negative, and one seen case differs by 2.9e-4 at
-11.6, which the rtol covers); standardised features the same; TinyVad
probabilities and column rings to atol 1e-5.  A window of exact silence
is ill-conditioned in TinyVad itself: its 16 columns are all log(eps),
so its std is about one float32 step of that log and is clamped to 1e-3,
which multiplies a one-step difference between two log implementations
by a thousand.  The test graph's dead zone (``chip_smoke.tinyvad_graph``)
maps every such window to its bias, so silence too is held to 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import tinyvad_graph
from moonshine_tpu.models.vad import TinyVad as JaxTinyVad
from moonshine_tpu.ops import mel as jmel
from moonshine_tpu_torch.models.vad import TinyVad
from moonshine_tpu_torch.ops import mel as tmel

MEL_TOL = dict(atol=1e-4, rtol=1e-4)
VAD_TOL = dict(atol=1e-5, rtol=0)


def _audio(*shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_numpy_tables_are_copies():
    for name, args in (("mel_filterbank", (80, 400, 16000)), ("_dft_basis", (400,)),
                       ("mel_filterbank_slaney", (32, 512, 16000, 20.0, 8000.0)),
                       ("_dft_basis_periodic", (512,))):
        np.testing.assert_array_equal(getattr(tmel, name)(*args), getattr(jmel, name)(*args))


@pytest.mark.parametrize("n_mels,fmax", [(32, 8000.0), (64, None)])
def test_mel_columns_matches_jax(n_mels, fmax):
    hops = _audio(3, 7, 512, seed=1)
    ref = jmel.mel_columns(jnp.asarray(hops), n_mels=n_mels, fmax=fmax)
    out = tmel.mel_columns(torch.from_numpy(hops), n_mels=n_mels, fmax=fmax)
    assert out.shape == (3, 7, n_mels) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MEL_TOL)


@pytest.mark.parametrize("center", [True, False])
def test_log_mel_matches_jax(center):
    audio = _audio(2, 5000, seed=2)
    ref = jmel.log_mel(jnp.asarray(audio), center=center)
    out = tmel.log_mel(torch.from_numpy(audio), center=center)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MEL_TOL)


@pytest.mark.parametrize("samples", [6000, 20000])  # padded to, and cropped at, 128 frames
def test_log_mel_clip_matches_jax(samples):
    audio = _audio(2, samples, seed=3)
    ref = jmel.log_mel_clip(jnp.asarray(audio))
    out = tmel.log_mel_clip(torch.from_numpy(audio))
    assert out.shape == ref.shape == (2, 1, 64, 128)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MEL_TOL)


@pytest.fixture(scope="module")
def graph():
    return tinyvad_graph(0)


def test_tinyvad_masked_matches_unmasked(graph):
    """Masked batched path == per-stream unmasked path: probabilities of
    the valid hops and each stream's ring advanced by its valid count."""
    vad = TinyVad(graph, device="cpu")
    a = _audio(2, 12, 512)
    n_valid = np.asarray([12, 5], np.int32)
    hops = a.copy()
    hops[1, 5:] = 0.0
    probs_m, st_m = vad.predict_hops_masked(torch.from_numpy(hops), n_valid,
                                            vad.init_state(2))
    p0, s0 = vad.predict_hops(torch.from_numpy(a[:1]), vad.init_state(1))
    p1, s1 = vad.predict_hops(torch.from_numpy(a[1:2, :5]), vad.init_state(1))
    np.testing.assert_allclose(_np(probs_m[0]), _np(p0[0]), **VAD_TOL)
    np.testing.assert_allclose(_np(probs_m[1, :5]), _np(p1[0]), **VAD_TOL)
    np.testing.assert_allclose(_np(st_m.cols[0]), _np(s0.cols[0]), **VAD_TOL)
    np.testing.assert_allclose(_np(st_m.cols[1]), _np(s1.cols[0]), **VAD_TOL)


def test_tinyvad_matches_jax(graph):
    """Three updates through both TinyVads: unmasked, then masked with
    uneven valid counts (one of them 0), the states carried across."""
    jvad, tvad = JaxTinyVad(graph), TinyVad(graph, device="cpu")
    js, ts = jvad.init_state(3), tvad.init_state(3)
    loud = _audio(3, 20, 512, seed=4)
    loud[1] = 0.0  # a silent stream
    jp, js = jvad.predict_hops(jnp.asarray(loud), js)
    tp, ts = tvad.predict_hops(torch.from_numpy(loud), ts)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **VAD_TOL)
    np.testing.assert_allclose(_np(ts.cols), np.asarray(js.cols), **VAD_TOL)
    assert float(tp[1, 15:].max()) < 0.1 < 0.9 < float(tp[0].min())  # silence low, sound high
    for seed, n_valid in ((5, [8, 3, 0]), (6, [2, 8, 5])):
        hops = _audio(3, 8, 512, seed=seed)
        nv = np.asarray(n_valid, np.int32)
        jp, js = jvad.predict_hops_masked(jnp.asarray(hops), jnp.asarray(nv), js)
        tp, ts = tvad.predict_hops_masked(torch.from_numpy(hops), nv, ts)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), **VAD_TOL)
        np.testing.assert_allclose(_np(ts.cols), np.asarray(js.cols), **VAD_TOL)


def test_tinyvad_hop_prob_fn_matches_jax(graph):
    """The stateful closure the pipeline's segmenter calls."""
    jfn, tfn = JaxTinyVad(graph).hop_prob_fn(), TinyVad(graph, device="cpu").hop_prob_fn()
    for seed, n in ((7, 5), (8, 3)):
        hops = _audio(n, 512, seed=seed)
        np.testing.assert_allclose(tfn(hops), np.asarray(jfn(hops)), **VAD_TOL)
