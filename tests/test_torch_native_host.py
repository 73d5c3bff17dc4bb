"""The port's native host runtime (``runtime/native_host.py`` over its own
copy of ``runtime/native/moonshine_host.cpp``, built with g++ into the
port's ``runtime/native/build/``) against the JAX package's Python paths,
on the CPU.  Mirrors tests/test_native_host.py case for case: the
resampler against JAX's ``resample_audio``, the ring buffer, the segmenter
state machine against JAX's ``VadSegmenter``, and the native segmenter
inside the port's pipeline ``Transcriber``, whose lines must equal those
of JAX's pipeline with its Python segmenter.

Tolerances (tests/test_native_host.py's): resampled audio atol 1e-5;
segment times 1e-6 s; segment audio atol 1e-6; byte counts, flags and
pipeline lines identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.audio.resample import resample_audio as jax_resample
from moonshine_tpu.pipeline.vad_segmenter import VadSegmenter as JaxVadSegmenter
from moonshine_tpu_torch.runtime import native_host

HOP = 512


@pytest.fixture(scope="module")
def lib():
    lib = native_host.load()
    if lib is None:
        pytest.skip("g++ unavailable: the native host library did not build")
    return lib


def test_builds_into_the_port_and_reports_its_version(lib):
    path = native_host.build_native()
    assert path is not None and path.parent == native_host._BUILD_DIR
    assert native_host._BUILD_DIR.parent.parent.name == "runtime"
    assert native_host._BUILD_DIR.parents[2].name == "moonshine_tpu_torch"
    assert lib.mt_host_version().decode() == "0.1.0"


@pytest.mark.parametrize("in_rate,out_rate", [(44100, 16000), (8000, 16000), (16000, 16000)])
def test_native_resample_matches_jax_python(lib, in_rate, out_rate, rng):
    from moonshine_tpu_torch.audio.resample import resample_audio

    audio = rng.standard_normal(in_rate // 7).astype(np.float32)
    ours = native_host.native_resample(audio, in_rate, out_rate)
    ref = jax_resample(audio, in_rate, out_rate)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_array_equal(resample_audio(audio, in_rate, out_rate), ref)


def test_ring_buffer_roundtrip(lib):
    ring = native_host.NativeRing(1024)
    assert ring.capacity == 1024
    data = np.arange(600, dtype=np.float32)
    assert ring.write(data) == 600
    assert ring.available == 600
    np.testing.assert_array_equal(ring.read(600), data)
    assert ring.available == 0


def test_ring_buffer_wraparound_and_overflow(lib):
    ring = native_host.NativeRing(100)
    a = np.arange(80, dtype=np.float32)
    assert ring.write(a) == 80
    np.testing.assert_array_equal(ring.read(50), a[:50])
    b = np.arange(100, 170, dtype=np.float32)
    assert ring.write(b) == 70  # 30 left + 50 freed
    np.testing.assert_array_equal(ring.read(200), np.concatenate([a[50:], b]))
    assert ring.write(np.ones(200, np.float32)) == 100  # overflow drops the excess


class OracleProbs:
    def __init__(self, probs):
        self.probs = list(probs)
        self.i = 0

    def __call__(self, hops):
        out = []
        for _ in range(hops.shape[0]):
            out.append(self.probs[self.i] if self.i < len(self.probs) else 0.0)
            self.i += 1
        return np.asarray(out, np.float32)


@pytest.mark.parametrize(
    "probs,kwargs",
    [
        ([0.0, 0.9, 0.9, 0.9, 0.9, 0.0, 0.0], {}),
        ([0.9] * 5, {"max_segment_sample_count": 0}),
        ([1.0] * 40, {"max_segment_sample_count": 10 * HOP}),
        ([1.0] * 40, {"max_segment_sample_count": 10 * HOP, "threshold": 0.0}),
        ([0.0, 0.9, 0.9, 0.0] * 3, {}),
    ],
)
def test_native_segmenter_matches_jax_python(lib, probs, kwargs, rng):
    audio = rng.standard_normal(len(probs) * HOP).astype(np.float32) * 0.1

    py = JaxVadSegmenter(OracleProbs(probs), window_size=1, **kwargs)
    py.start()
    py.process_audio(audio)
    py.stop()

    nat = native_host.NativeSegmenter(OracleProbs(probs), window_size=1, **kwargs)
    nat.start()
    nat.process_audio(audio)
    nat.stop()

    ps, ns = py.segments, nat.segments
    assert len(ps) == len(ns) > 0
    for a, b in zip(ps, ns):
        assert a.is_complete == b.is_complete
        assert a.start_time == pytest.approx(b.start_time, abs=1e-6)
        assert a.end_time == pytest.approx(b.end_time, abs=1e-6)
        np.testing.assert_allclose(a.audio_data, b.audio_data, atol=1e-6)
    assert py.retained_segment_audio_byte_count() == nat.retained_segment_audio_byte_count()
    assert py.completed_segment_audio_byte_count() == nat.completed_segment_audio_byte_count()


class _FakeBackend:
    """The JAX package's FakeBackend (a canned text per segment span),
    returning the port's SegmentResult."""

    def reset(self) -> None:
        pass

    def transcribe_segment(self, audio, segment_id, is_final):
        from moonshine_tpu_torch.pipeline.backends import SegmentResult

        return SegmentResult(f"seg{segment_id}:{len(audio)}", [])


PIPELINE_PROBS = [0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.9, 0.9, 0.0] + [0.0] * 100


def _lines(transcript) -> list:
    return [(line.text, line.start_time, line.duration, line.is_complete)
            for line in transcript.lines]


def test_native_segmenter_in_the_port_pipeline_matches_jax(lib):
    """The native segmenter slots into the port's pipeline Transcriber
    unchanged, and its lines are those of JAX's pipeline with its Python
    segmenter."""
    from moonshine_tpu.core.config import TranscriberOptions as JaxOptions
    from moonshine_tpu.core.config import VadOptions as JaxVad
    from moonshine_tpu.pipeline.backends import FakeBackend
    from moonshine_tpu.pipeline.transcriber import Transcriber as JaxPipeline
    from moonshine_tpu_torch.core.config import TranscriberOptions, VadOptions
    from moonshine_tpu_torch.pipeline.transcriber import Transcriber

    audio = np.full(9 * HOP, 0.05, np.float32)
    jt = JaxPipeline(FakeBackend(), JaxOptions(transcription_interval=0.1,
                                               vad=JaxVad(threshold=0.5, window_size=1)),
                     hop_prob_fn=OracleProbs(PIPELINE_PROBS))
    stream = jt.create_stream(update_interval=0.1)
    stream.start()
    stream.add_audio(audio)
    ref = _lines(stream.stop())

    tt = Transcriber(_FakeBackend(), TranscriberOptions(
        transcription_interval=0.1, vad=VadOptions(threshold=0.5, window_size=1)),
        hop_prob_fn=OracleProbs(PIPELINE_PROBS))
    stream = tt.create_stream(update_interval=0.1)
    stream.segmenter = native_host.NativeSegmenter(tt.hop_prob_fn, threshold=0.5,
                                                   window_size=1)
    stream.start()
    stream.add_audio(audio)
    ours = _lines(stream.stop())
    assert ours == ref
    assert len(ours) == 2 and all(complete for *_, complete in ours)
