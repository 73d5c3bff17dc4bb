"""The port's WORLD-lite vocoder (``tts/worldlite.py``) against the JAX
package's, on the CPU.

- ``expand_matrices`` and ``pulse_plan`` (numpy copies): equal arrays.
- ``_min_phase`` on seeded log-amplitudes: atol 5e-5 and rtol 1e-5 (an
  inverse and a forward FFT of 1,024 points, then an exp that turns the
  FFTs' absolute rounding into relative error: 1.3e-6 relative measured on
  outputs up to about 1,400).
- ``render`` with JAX's noise injected (``jax.random.normal`` of the seed
  at JAX's bucketed pulse count, which torch cannot draw) on f0 contours
  with voiced and unvoiced runs, high pitch (many overlapping pulses) and
  all-unvoiced frames: the same length and PCM within 2 int16 steps (the
  overlap-add sums in another order; the float PCM is truncated to int16).
- The overlap-add's sets never overlap; a seed gives the same PCM on every
  call and another seed other PCM; a short noise draw is refused.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.tts import worldlite as jw
from moonshine_tpu_torch.tts import worldlite as tw

MIN_PHASE_TOL = dict(atol=5e-5, rtol=1e-5)
PCM_STEPS = 2


def _frames(kind: str, t: int = 240, seed: int = 0):
    rng = np.random.default_rng(seed)
    benv = (np.exp(rng.standard_normal((t, jw.N_BENV)) * 0.5) * 0.01).astype(np.float32)
    bap = rng.uniform(0, 1, (t, jw.N_BAP)).astype(np.float32)
    n = np.arange(t)
    if kind == "speech":
        f0 = np.where(n % 97 < 70, 110 + 50 * np.sin(n / 15), 0)
    elif kind == "high":
        f0 = 380 + 40 * np.sin(n / 9)
    elif kind == "unvoiced":
        f0 = np.zeros(t)
    else:  # a rising glide with a dip under the f0 floor
        f0 = np.where((n > 100) & (n < 110), 20.0, 70 + n)
    return benv, bap, f0.astype(np.float32)


def test_tables_and_plan_match_jax():
    for ours, ref in zip(tw.expand_matrices(), jw.expand_matrices()):
        np.testing.assert_array_equal(ours, ref)
    for kind in ("speech", "high", "unvoiced", "glide"):
        f0 = _frames(kind)[2]
        ours, ref = tw.pulse_plan(f0), jw.pulse_plan(f0)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_min_phase_matches_jax():
    x = np.random.default_rng(1).standard_normal((6, jw.SPEC_BINS)).astype(np.float32) * 2.0
    ref = np.asarray(jax.jit(jw._min_phase)(x))
    ours = tw._min_phase(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, **MIN_PHASE_TOL)


def _jax_noise(f0: np.ndarray, seed: int) -> np.ndarray:
    p = len(jw.pulse_plan(f0)["pulse_index"])
    pb = 1 << max(p - 1, 1).bit_length()
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (pb, jw.MAX_NOISE)))


@pytest.mark.parametrize("kind", ["speech", "high", "unvoiced", "glide"])
def test_render_with_jax_noise_matches_jax(kind):
    benv, bap, f0 = _frames(kind, seed=len(kind))
    ref = jw.render(benv, bap, f0, 0.8, seed=3)
    ours = tw.render(benv, bap, f0, 0.8, seed=3, noise=_jax_noise(f0, 3), device="cpu")
    assert ours.dtype == np.int16 and ours.shape == ref.shape == (len(f0) * jw.FRAME_SAMPLES,)
    steps = np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max()
    print(f"{kind}: {len(jw.pulse_plan(f0)['pulse_index'])} pulses, "
          f"{tw.overlap_sets(jw.pulse_plan(f0)['pulse_index'])} overlap sets, "
          f"max {steps} int16 steps, peak {np.abs(ref).max()}")
    assert steps <= PCM_STEPS
    assert np.abs(ref).max() > 100


def test_overlap_sets_never_overlap():
    for kind in ("speech", "high", "unvoiced", "glide"):
        idx = jw.pulse_plan(_frames(kind)[2])["pulse_index"]
        g = tw.overlap_sets(idx)
        for j in range(g):
            assert np.all(np.diff(idx[j::g]) >= tw.FFT_SIZE)
        assert g == 1 or np.any(idx[g - 1:] - idx[:1 - g] < tw.FFT_SIZE)  # the least such G


def test_seeded_noise_and_its_checks():
    benv, bap, f0 = _frames("speech", t=80)
    a = tw.render(benv, bap, f0, 0.5, seed=1, device="cpu")
    b = tw.render(benv, bap, f0, 0.5, seed=1, device="cpu")
    c = tw.render(benv, bap, f0, 0.5, seed=2, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    p = len(jw.pulse_plan(f0)["pulse_index"])
    with pytest.raises(ValueError, match="noise must be"):
        tw.render(benv, bap, f0, 0.5, noise=np.zeros((p - 1, jw.MAX_NOISE)), device="cpu")
    empty = tw.render(benv[:0], bap[:0], f0[:0], 0.5, device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.int16
