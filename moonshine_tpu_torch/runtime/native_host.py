"""ctypes binding for the native host runtime (libmoonshine_host).

A copy of the JAX package's ``runtime/native_host.py`` (host code, no JAX),
over the port's own copy of the C++ sources in ``runtime/native/``.  The
library builds with ``g++`` into ``runtime/native/build/`` of this package
at first use; every entry point has a pure-Python fallback, so the package
works without a compiler and the native path is an opt-in acceleration for
many-stream servers.  Mirrors the reference's binding pattern of a C ABI +
ctypes (reference: language-bindings/python/src/moonshine_voice/
moonshine_api.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_BUILD_DIR = _NATIVE_DIR / "build"
_LIB_NAMES = ["libmoonshine_host.so", "libmoonshine_host.dylib"]

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_native(force: bool = False) -> Path | None:
    """Compile the shared library with g++ (no cmake needed).

    Rebuilds when the source is newer than the library.  The library is
    written under a temporary name and renamed into place, so a process
    that loads it never sees half a file.  Returns None when the build
    fails (the message goes to stderr)."""
    out = _BUILD_DIR / "libmoonshine_host.so"
    src = _NATIVE_DIR / "moonshine_host.cpp"
    if (
        out.exists()
        and not force
        and out.stat().st_mtime >= src.stat().st_mtime
    ):
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared",
        "-fvisibility=hidden", str(src), "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        os.unlink(tmp)
        print(f"native build failed: {e}", file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or (_load_attempted and not auto_build):
        return _lib
    _load_attempted = True
    if auto_build:
        build_native()  # mtime-aware: rebuilds when the source is newer
    for name in _LIB_NAMES:
        p = _BUILD_DIR / name
        if p.exists():
            _lib = _bind(ctypes.CDLL(str(p)))
            return _lib
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mt_resample_output_size.restype = ctypes.c_size_t
    lib.mt_resample_output_size.argtypes = [ctypes.c_size_t, ctypes.c_float, ctypes.c_float]
    lib.mt_resample.restype = ctypes.c_size_t
    lib.mt_resample.argtypes = [f32p, ctypes.c_size_t, ctypes.c_float, ctypes.c_float, f32p]

    lib.mt_ring_create.restype = ctypes.c_void_p
    lib.mt_ring_create.argtypes = [ctypes.c_size_t]
    lib.mt_ring_free.argtypes = [ctypes.c_void_p]
    lib.mt_ring_write.restype = ctypes.c_size_t
    lib.mt_ring_write.argtypes = [ctypes.c_void_p, f32p, ctypes.c_size_t]
    lib.mt_ring_read.restype = ctypes.c_size_t
    lib.mt_ring_read.argtypes = [ctypes.c_void_p, f32p, ctypes.c_size_t]
    lib.mt_ring_available.restype = ctypes.c_size_t
    lib.mt_ring_available.argtypes = [ctypes.c_void_p]
    lib.mt_ring_capacity.restype = ctypes.c_size_t
    lib.mt_ring_capacity.argtypes = [ctypes.c_void_p]

    lib.mt_segmenter_create.restype = ctypes.c_void_p
    lib.mt_segmenter_create.argtypes = [
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_size_t, ctypes.c_size_t,
    ]
    lib.mt_segmenter_free.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_start.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_stop.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_is_active.restype = ctypes.c_int32
    lib.mt_segmenter_is_active.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_begin_update.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_process_hop.argtypes = [ctypes.c_void_p, f32p, ctypes.c_float]
    lib.mt_segmenter_segment_count.restype = ctypes.c_size_t
    lib.mt_segmenter_segment_count.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_segment_info.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.mt_segmenter_copy_audio.restype = ctypes.c_size_t
    lib.mt_segmenter_copy_audio.argtypes = [ctypes.c_void_p, ctypes.c_size_t, f32p, ctypes.c_size_t]
    lib.mt_segmenter_retained_bytes.restype = ctypes.c_size_t
    lib.mt_segmenter_retained_bytes.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_completed_bytes.restype = ctypes.c_size_t
    lib.mt_segmenter_completed_bytes.argtypes = [ctypes.c_void_p]
    lib.mt_segmenter_clear_completed_audio.argtypes = [ctypes.c_void_p]
    lib.mt_host_version.restype = ctypes.c_char_p
    return lib


class _SegmentInfo(ctypes.Structure):
    _fields_ = [
        ("start_time", ctypes.c_double),
        ("end_time", ctypes.c_double),
        ("is_complete", ctypes.c_int32),
        ("just_updated", ctypes.c_int32),
        ("audio_sample_count", ctypes.c_size_t),
    ]


def _as_f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def native_resample(audio: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    n_out = lib.mt_resample_output_size(audio.size, in_rate, out_rate)
    out = np.empty(n_out, np.float32)
    written = lib.mt_resample(_as_f32p(audio), audio.size, in_rate, out_rate, _as_f32p(out))
    return out[:written]


class NativeRing:
    """SPSC audio ring buffer backed by the C++ runtime."""

    def __init__(self, capacity_samples: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native host library unavailable")
        self._lib = lib
        self._h = lib.mt_ring_create(capacity_samples)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mt_ring_free(self._h)
            self._h = None

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        return self._lib.mt_ring_write(self._h, _as_f32p(data), data.size)

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.mt_ring_read(self._h, _as_f32p(out), n)
        return out[:got]

    @property
    def available(self) -> int:
        return self._lib.mt_ring_available(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.mt_ring_capacity(self._h)


class NativeSegmenter:
    """Drop-in VadSegmenter core backed by the C++ state machine.

    Same constructor/semantics as the port's pipeline.vad_segmenter.
    VadSegmenter but per-hop processing happens in native code; the hop
    probability function still runs the batched device VAD.
    """

    def __init__(
        self,
        hop_prob_fn,
        threshold: float = 0.5,
        window_size: int = 32,
        hop_size: int = 512,
        look_behind_sample_count: int = 4096,
        max_segment_sample_count: int = 15 * 16000,
    ):
        lib = load()
        if lib is None:
            raise RuntimeError("native host library unavailable")
        self._lib = lib
        self.hop_prob_fn = hop_prob_fn
        self.hop_size = hop_size
        self.threshold = threshold
        self._h = lib.mt_segmenter_create(
            threshold, window_size, hop_size, look_behind_sample_count,
            max_segment_sample_count,
        )
        self._remainder = np.zeros(0, np.float32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mt_segmenter_free(self._h)
            self._h = None

    @property
    def is_active(self) -> bool:
        return bool(self._lib.mt_segmenter_is_active(self._h))

    def start(self) -> None:
        self._remainder = np.zeros(0, np.float32)
        self._lib.mt_segmenter_start(self._h)

    def stop(self) -> None:
        self._lib.mt_segmenter_stop(self._h)

    def process_audio(self, audio: np.ndarray, sample_rate: int = 16000) -> None:
        if not self.is_active:
            return
        from ..audio.resample import resample_audio

        self._lib.mt_segmenter_begin_update(self._h)
        audio = resample_audio(np.asarray(audio, np.float32), sample_rate, 16000)
        buf = np.concatenate([self._remainder, audio])
        n_hops = len(buf) // self.hop_size
        if n_hops == 0:
            self._remainder = buf
            return
        hops = np.ascontiguousarray(
            buf[: n_hops * self.hop_size].reshape(n_hops, self.hop_size)
        )
        self._remainder = buf[n_hops * self.hop_size :]
        if self.threshold > 0.0:
            probs = np.asarray(self.hop_prob_fn(hops), np.float32)
        else:
            probs = np.ones(n_hops, np.float32)
        for i in range(n_hops):
            self._lib.mt_segmenter_process_hop(self._h, _as_f32p(hops[i]), float(probs[i]))

    @property
    def segments(self):
        from ..pipeline.vad_segmenter import VoiceSegment

        out = []
        n = self._lib.mt_segmenter_segment_count(self._h)
        for i in range(n):
            info = _SegmentInfo()
            self._lib.mt_segmenter_segment_info(self._h, i, ctypes.byref(info))
            audio = np.empty(info.audio_sample_count, np.float32)
            if info.audio_sample_count:
                self._lib.mt_segmenter_copy_audio(
                    self._h, i, _as_f32p(audio), info.audio_sample_count
                )
            out.append(
                VoiceSegment(
                    audio_data=audio,
                    start_time=info.start_time,
                    end_time=info.end_time,
                    is_complete=bool(info.is_complete),
                    just_updated=bool(info.just_updated),
                )
            )
        return out

    def retained_segment_audio_byte_count(self) -> int:
        return self._lib.mt_segmenter_retained_bytes(self._h)

    def completed_segment_audio_byte_count(self) -> int:
        return self._lib.mt_segmenter_completed_bytes(self._h)

    def clear_completed_segment_audio_data(self) -> None:
        self._lib.mt_segmenter_clear_completed_audio(self._h)
