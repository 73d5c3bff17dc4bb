"""The port's published-pack voice (``tts/neural_pack.py``) against the
JAX package's, on the CPU.

The reference's voice pack is not in the repository.  Without it:

- the host planning's pieces that need no pack (the pack-token IPA
  tokenizer, the f0 side-stream decoder on seeded byte streams, the f0
  code table, the unit warps and length blend): equal results;
- the decoder step (``decode_tiles``: every tile in one batch through the
  port's ``TfliteExecutor``) on the pack decoder's contract graph
  (``chip_smoke.pack_decoder_graph``) against JAX's executor, to atol =
  rtol = 1e-5;
- a missing pack raises ``FileNotFoundError`` in both packages.

With the pack (under the same ``skipif`` as tests/test_neural_pack.py):
the parsed pack, the unit plan's tracks (float32 host numpy around the
decoder: atol 1e-4 on log10 amplitudes) and the synthesized length equal
JAX's; the PCM is not compared, since the vocoder's noise is drawn from
another generator (tests/test_torch_worldlite.py holds ``render`` with
JAX's noise injected).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import PACK_LATENT_DIM, PACK_TILE, pack_decoder_graph
from moonshine_tpu.ops.tflite_graph import TfliteExecutor as JaxExecutor
from moonshine_tpu.tts import neural_pack as jnp_pack
from moonshine_tpu_torch.ops.tflite_graph import TfliteExecutor
from moonshine_tpu_torch.tts import neural_pack as tnp

TOL = dict(atol=1e-5, rtol=1e-5)
TRACK_TOL = dict(atol=1e-4, rtol=0)
pack_present = pytest.mark.skipif(
    not jnp_pack.REFERENCE_PACK.exists(), reason="reference voice pack not mounted")


def test_tokenize_ipa_matches_jax():
    for ipa in ["haɪ", "tʃiːz", "ˈoʊld ɡɚl", "ɹˈɛdɪŋ", "ðə kwɪk bɹaʊn fɑks", "x?!", ""]:
        assert tnp.tokenize_ipa(ipa) == jnp_pack.tokenize_ipa(ipa)


def test_f0_codes_and_streams_match_jax():
    assert [tnp.f0_from_code(q) for q in range(256)] == [
        jnp_pack.f0_from_code(q) for q in range(256)]
    rng = np.random.default_rng(0)
    for n_frames in (1, 17, 60, 200):
        for _ in range(5):
            runs = int(rng.integers(0, 4))
            head = [runs] + [int(v) for r in range(runs) for v in (rng.integers(0, 6),
                                                                   rng.integers(0, 40))]
            buf = bytes(head) + rng.integers(0, 256, 80, dtype=np.uint8).tobytes()
            np.testing.assert_array_equal(tnp.decode_f0_stream(buf, n_frames),
                                          jnp_pack.decode_f0_stream(buf, n_frames))


def test_warps_and_length_blend_match_jax():
    for m in range(0, 12):
        for n in range(1, 12):
            np.testing.assert_array_equal(tnp._warp_positions(max(m, 1), n),
                                          jnp_pack._warp_positions(max(m, 1), n))
            for end in (False, True):
                np.testing.assert_array_equal(tnp._warp_anchored(m, n, end),
                                              jnp_pack._warp_anchored(m, n, end))
            assert tnp._blend_len_unit(n, m) == jnp_pack._blend_len_unit(n, m)


def test_decode_tiles_on_the_contract_graph_matches_jax():
    model = pack_decoder_graph()
    tiles = (np.random.default_rng(1).standard_normal((12, PACK_TILE, PACK_LATENT_DIM))
             * 0.5).astype(np.float32)
    ours = tnp.decode_tiles(TfliteExecutor(model, "cpu"), tiles)
    ref = np.asarray(jax.jit(JaxExecutor(model).run)(jnp.asarray(tiles)))
    assert ours.shape == ref.shape == (12, 4 * PACK_TILE, 60)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_missing_pack_raises_what_jax_raises(tmp_path):
    missing = str(tmp_path / "neural_tts_pack.bin")
    with pytest.raises(FileNotFoundError):
        jnp_pack.NeuralPackTTS(pack_path=missing)
    with pytest.raises(FileNotFoundError):
        tnp.NeuralPackTTS(pack_path=missing, device="cpu")


@pytest.fixture(scope="module")
def engines():
    path = str(jnp_pack.REFERENCE_PACK)
    return jnp_pack.NeuralPackTTS(path), tnp.NeuralPackTTS(path, device="cpu")


@pack_present
def test_pack_parse_matches_jax(engines):
    j, t = engines
    for name in ("median_f0", "default_gain", "n_phones", "k", "latent_dim", "tile_latents",
                 "tile_hop", "phones"):
        assert getattr(t.pk, name) == getattr(j.pk, name), name
    for a, b in zip(t.pk.codebooks, j.pk.codebooks):
        np.testing.assert_array_equal(a, b)


@pack_present
@pytest.mark.parametrize("text", ["zero", "reading", "say wifi to set up a network"])
def test_plan_and_length_match_jax(engines, text):
    j, t = engines
    tokens = t.text_to_tokens(text)
    assert tokens == j.text_to_tokens(text)
    runs = tnp.build_runs(t.pk, tokens)
    assert runs == jnp_pack.build_runs(j.pk, tokens)
    for e in (j, t):
        e._used, e._prev_tail_f0 = {}, 0.0
    jt, jf0, jl = j._plan_and_materialize(runs)
    tt, tf0, tl = t._plan_and_materialize(runs)
    np.testing.assert_allclose(tt, jt, **TRACK_TOL)
    np.testing.assert_allclose(tf0, jf0, **TRACK_TOL)
    np.testing.assert_allclose(tl, jl, **TRACK_TOL)
    pcm = t.synthesize(text)
    assert pcm.dtype == np.int16 and len(pcm) == len(j.synthesize(text))
    assert len(pcm) == t.estimate_samples(text) and np.abs(pcm).max() > 1000
