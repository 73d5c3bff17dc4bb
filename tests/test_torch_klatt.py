"""The port's Klatt formant voice (``tts/klatt.py``) against the JAX
package's, on the CPU.

- The control plane and the stochastic source (numpy copies): tokens,
  segments, frame tracks and the per-sample source arrays equal.
- The scan: ``associative_scan`` against ``lax.associative_scan`` with
  the JAX module's combine, bit for bit, at lengths 1 to 17, 33 and 3,001
  where the values are normal floats (XLA's CPU code flushes subnormal
  results to zero and torch keeps them: the long scan's matrix products
  decay into that range, and differ there by less than 5e-38);
  ``_linrec2``, ``_gated_shift2`` and ``_gated_linrec2`` bit for bit on the
  same coefficients (the port follows lax's tree and rounds each 2x2
  product as XLA's CPU code does, a fused multiply-add).
- The coefficients: resonators (a constant bandwidth, as the nasal pole's
  100 Hz, and per-sample ones) and the band-pass within a few float32
  steps of JAX's, atol 2.4e-7 and rtol 4e-7 (XLA's cos and sin are not
  always the rounded float64 ones, and it folds constants and divisions
  its own way; ``a = 1 - b - c`` keeps b's absolute error).
- ``synthesize_ipa`` and ``synthesize`` on the non-oracle inputs of
  tests/test_klatt.py (the deterministic and the default voice, speeds
  0.5, 1.5 and 2.0, a question, /i/, the text "seven"): sample counts
  equal, and the waveform's RMS difference under 2e-3 of JAX's RMS (the
  bound tests/test_klatt.py holds JAX itself to against the reference
  engine).  The JAX package's elementwise code is fused by XLA, whose
  roundings (fused multiply-adds, folded constants, its own cos) the port
  does not follow everywhere, and the antiresonator's coefficients divide
  by 1 - b - c, about 2e-4: a one-step difference there moves the nasal
  branch by about 1e-3 relative.  Each case prints its error.
- The basic properties of tests/test_klatt.py on the port, and the
  ``TextToSpeech`` facade's ``klatt`` voice against JAX's, with speed and
  volume.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import rel_rms
from moonshine_tpu.tts import facade as jfacade
from moonshine_tpu.tts import klatt as jk
from moonshine_tpu_torch.tts import facade as tfacade
from moonshine_tpu_torch.tts import klatt as tk

REL_RMS = 2e-3
SR = 22050.0
IPAS = ["sˈɛvən", "hɛlˈoʊ wˈɝld", "i", "mˈuːn ʃˈaɪn", "tʃiːz"]


def _source(ipa: str, vp_j, vp_t):
    out = []
    for mod, vp in ((jk, vp_j), (tk, vp_t)):
        segs = mod.build_segments(mod.tokenize_ipa(ipa), vp)
        tracks = mod.fill_param_tracks(segs, vp, vp.duration_scale, False)
        s = mod._interp_tracks(tracks, 110)
        out.append((segs, tracks, s, mod._compute_source(vp, s, SR)))
    return out


@pytest.mark.parametrize("voice", ["deterministic", "default"])
def test_control_plane_and_source_match_jax(voice):
    vp_j = jk.deterministic_voice() if voice == "deterministic" else jk.KlattVoice()
    vp_t = tk.deterministic_voice() if voice == "deterministic" else tk.KlattVoice()
    assert dataclasses.asdict(vp_t) == dataclasses.asdict(vp_j)
    for ipa in IPAS:
        assert tk.tokenize_ipa(ipa) == jk.tokenize_ipa(ipa)
        (jsegs, jtr, js, jsrc), (tsegs, ttr, ts, tsrc) = _source(ipa, vp_j, vp_t)
        assert [dataclasses.asdict(s) for s in tsegs] == [dataclasses.asdict(s) for s in jsegs]
        for a, b in ((ttr, jtr), (ts, js), (tsrc, jsrc)):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_comb(l, r):
    A1, v1 = l
    A2, v2 = r
    return (jnp.einsum("...ij,...jk->...ik", A2, A1),
            jnp.einsum("...ij,...j->...i", A2, v1) + v2)


SUBNORMAL = dict(atol=4 * float(np.finfo(np.float32).tiny), rtol=0)
COEF_TOL = dict(atol=2.4e-7, rtol=4e-7)


def test_associative_scan_is_lax_scan_bit_for_bit():
    scan = jax.jit(lambda A, v: jax.lax.associative_scan(_jax_comb, (A, v), axis=0))
    rng = np.random.default_rng(0)
    for n in [*range(1, 18), 33, 3001]:
        A = (rng.standard_normal((n, 2, 2)) * 0.7).astype(np.float32)
        v = rng.standard_normal((n, 2)).astype(np.float32)
        rA, rv = scan(A, v)
        tA, tv = tk.associative_scan(torch.from_numpy(A), torch.from_numpy(v))
        for ours, ref in ((tA, rA), (tv, rv)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=str(n),
                                       **SUBNORMAL)


def test_recurrences_are_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    n = 6000
    f = np.linspace(200, 3000, n).astype(np.float32)
    bw = rng.uniform(50, 120, n).astype(np.float32)
    a, b, c = (np.asarray(x) for x in jax.jit(
        lambda f, bw: jk._resonator_coefs(f, bw, SR))(f, bw))
    d = rng.standard_normal(n).astype(np.float32)
    active = rng.uniform(size=n) > 0.3
    dd = np.where(active, d, 0).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_array_equal(tk._linrec2(T(d), T(b), T(c)).numpy(),
                                  np.asarray(jax.jit(jk._linrec2)(d, b, c)))
    for ours, ref in zip(tk._gated_shift2(T(d), T(active)),
                         jax.jit(jk._gated_shift2)(d, active)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tk._gated_linrec2(T(dd), T(b), T(c), T(active)).numpy(),
                                  np.asarray(jax.jit(jk._gated_linrec2)(dd, b, c, active)))


def test_frication_scan_against_a_serial_recurrence():
    """The frication branch of 'm ɑ n ʃ i ŋ z' (deterministic voice): the
    port's scan is JAX's bit for bit, and both differ from the recurrence
    run serially in float64; the test prints by how much (the scan's own
    rounding, which the JAX package has too)."""
    vp = jk.deterministic_voice()
    segs = jk.build_segments(jk.tokenize_ipa("m ɑ n ʃ i ŋ z"), vp)
    s = jk._interp_tracks(jk.fill_param_tracks(segs, vp, vp.duration_scale, False), 110)
    noise, active = jk._compute_source(vp, s, SR)["fric_noise"], s["af"] > 0
    b0, b2c, a1, a2 = (np.asarray(x) for x in jax.jit(
        lambda f: jk._bandpass_coefs(f, vp.fric_q, SR))(s["fric_cf"]))
    x2 = np.asarray(jax.jit(jk._gated_shift2)(noise, active)[1])
    d = np.where(active, b0 * noise + b2c * x2, 0).astype(np.float32)
    ref = np.asarray(jax.jit(jk._gated_linrec2)(d, -a1, -a2, active))
    T = torch.from_numpy
    ours = tk._gated_linrec2(T(d), T(-a1), T(-a2), T(active)).numpy()
    np.testing.assert_allclose(ours, ref, **SUBNORMAL)
    y, y1, y2 = np.zeros(len(d)), 0.0, 0.0  # the state, frozen while inactive
    for i in range(len(d)):
        if active[i]:
            y1, y2 = float(d[i]) - float(a1[i]) * y1 - float(a2[i]) * y2, y1
        y[i] = y1
    err = np.abs(ref - y).max()
    print(f"frication branch: {int(active.sum())} active samples, peak {np.abs(y).max():.3f}, "
          f"scan against serial float64 {err:.3e} ({err / np.abs(y).max():.2%} of the peak)")


def test_coefficients_match_jax():
    rng = np.random.default_rng(2)
    f = rng.uniform(150, 5000, 4000).astype(np.float32)
    bw = rng.uniform(40, 300, 4000).astype(np.float32)
    ref = jax.jit(lambda f: jk._resonator_coefs(f, 100.0, SR))(f)
    for ours, r in zip(tk._resonator_coefs(torch.from_numpy(f), 100.0, SR), ref):
        np.testing.assert_allclose(ours.numpy(), np.broadcast_to(np.asarray(r), f.shape),
                                   **COEF_TOL)
    ref = jax.jit(lambda f, bw: jk._resonator_coefs(f, bw, SR))(f, bw)
    for ours, r in zip(tk._resonator_coefs(torch.from_numpy(f), torch.from_numpy(bw), SR), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), **COEF_TOL)
    ref = jax.jit(lambda f: jk._bandpass_coefs(f, 1.269, SR))(f)
    for ours, r in zip(tk._bandpass_coefs(torch.from_numpy(f), 1.269, SR), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), **COEF_TOL)


CASES = [  # (ipa, speed, question, deterministic voice)
    ("sˈɛvən", 1.0, False, True), ("sˈɛvən", 0.5, False, True), ("sˈɛvən", 2.0, False, True),
    ("sˈɛvən", 1.5, True, True), ("i", 1.0, False, True), ("hɛlˈoʊ wˈɝld", 1.0, False, False),
]


@pytest.mark.parametrize("ipa,speed,question,det", CASES)
def test_synthesize_ipa_matches_jax(ipa, speed, question, det):
    jt = jk.KlattTTS(jk.deterministic_voice() if det else None)
    tt = tk.KlattTTS(tk.deterministic_voice() if det else None, device="cpu")
    ref = jt.synthesize_ipa(ipa, speed=speed, question=question)
    ours = tt.synthesize_ipa(ipa, speed=speed, question=question)
    assert ours.dtype == np.float32 and len(ours) == len(ref)
    err = rel_rms(ours, ref)
    print(f"{ipa!r} speed {speed} question {question}: {len(ours)} samples, relative RMS "
          f"error {err:.3e}, max {np.abs(ours - ref).max():.3e}")
    assert err < REL_RMS


def test_text_frontend_matches_jax():
    ref = jk.KlattTTS().synthesize("seven")
    ours = tk.KlattTTS(device="cpu").synthesize("seven")
    assert len(ours) == len(ref) > 8000
    assert rel_rms(ours, ref) < REL_RMS
    assert float(np.abs(ours).max()) <= 1.0


def test_basic_properties():
    t = tk.KlattTTS(voice=tk.deterministic_voice(), device="cpu")
    pcm = t.synthesize_ipa("sˈɛvən")
    assert len(pcm) > 10000 and 0.05 < float(np.abs(pcm).max()) <= 1.0
    assert abs(pcm[0]) < 1e-6 and abs(pcm[-1]) < 1e-6
    assert len(t.synthesize_ipa("sˈɛvən", speed=0.5)) > 1.7 * len(
        t.synthesize_ipa("sˈɛvən", speed=2.0))
    assert len(t.synthesize_phones([])) == len(
        jk.KlattTTS(jk.deterministic_voice()).synthesize_phones([]))


@pytest.mark.parametrize("voice,opts", [("klatt", {}),
                                        ("klatt_fast", {"speed": 1.4, "volume": 0.5})])
def test_facade_klatt_voice_matches_jax(voice, opts):
    jtts = jfacade.TextToSpeech().voice(voice).load()
    ttts = tfacade.TextToSpeech(device="cpu").voice(voice).load()
    jo, to = jfacade.TTSOptions(**opts), tfacade.TTSOptions(**opts)
    (ref, jsr), (ours, tsr) = jtts.synthesize("hello there", jo), ttts.synthesize("hello there",
                                                                                  to)
    assert tsr == jsr == 22050 and len(ours) == len(ref) and ours.dtype == np.float32
    assert rel_rms(ours, ref) < REL_RMS
    (ref, _), (ours, _) = (jtts.synthesize_from_phonemes("sˈɛvən", jo),
                           ttts.synthesize_from_phonemes("sˈɛvən", to))
    assert len(ours) == len(ref) and rel_rms(ours, ref) < REL_RMS
