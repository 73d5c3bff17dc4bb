"""ctypes binding for the native transcription client (libmoonshine_client).

A copy of the JAX package's ``runtime/native_client.py`` (host code, no
JAX), over the port's own copy of the C/C++ sources in ``runtime/native/``.
The native-caller side of the serving boundary: a dependency-free C/C++
WebSocket client (runtime/native/moonshine_client.{h,cpp}) that streams PCM
to the port's TranscriptionServer (``server.py``, the same wire protocol as
the JAX package's) and polls transcript events.  This module builds it with
``g++`` into ``runtime/native/build/`` the same way native_host.py does
(``build_selftest`` builds the component selftest binary beside it), and
wraps the C ABI in a small Pythonic ``NativeClientStream`` so the loopback
tests exercise the exact library a C/C++ application would link (reference
analog: the ctypes pattern of language-bindings/python/src/moonshine_voice/
moonshine_api.py, here pointed at the native CLIENT instead of an
in-process core).  The platform bindings in ``runtime/bindings/`` (JNI,
Embind, Swift, Android, TypeScript) are clients of the same C ABI.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_BUILD_DIR = _NATIVE_DIR / "build"
_LIB = "libmoonshine_client.so"

MT_EVENT_PARTIAL = 0
MT_EVENT_FINAL = 1
MT_EVENT_STOPPED = 2
MT_EVENT_ERROR = 3
# Regularized line lifecycle (reference: moonshine-c-api.h:165-196),
# derived client-side when set_line_events(True) is active.
MT_EVENT_LINE_STARTED = 4
MT_EVENT_LINE_UPDATED = 5
MT_EVENT_LINE_TEXT_CHANGED = 6
MT_EVENT_LINE_SPEAKERS_CHANGED = 7
MT_EVENT_LINE_COMPLETED = 8

_lib: Optional[ctypes.CDLL] = None


class _Event(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int32),
        ("segment", ctypes.c_int32),
        ("start_s", ctypes.c_double),
        ("end_s", ctypes.c_double),
        ("latency_ms", ctypes.c_double),
        ("text", ctypes.c_char * 4096),
        ("line_id", ctypes.c_int32),
        ("n_speakers", ctypes.c_int32),
        ("speakers", ctypes.c_int32 * 8),
    ]


class _ClipResult(ctypes.Structure):
    _fields_ = [
        ("found", ctypes.c_int32),
        ("start_s", ctypes.c_double),
        ("end_s", ctypes.c_double),
        ("speech_s", ctypes.c_double),
    ]


def _compile(cmd_head: list[str], src: Path, out: Path, what: str) -> Path | None:
    """Run ``g++`` into a temporary file and rename it into place, so a
    process that loads or runs ``out`` never sees half a file."""
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([*cmd_head, str(src), "-o", tmp], check=True,
                       capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        os.unlink(tmp)
        print(f"{what} build failed: {e}", file=sys.stderr)
        return None
    os.chmod(tmp, 0o755)  # mkstemp's 0600 would leave the binary unrunnable
    os.replace(tmp, out)
    return out


def _fresh(out: Path, *sources: Path) -> bool:
    return out.exists() and out.stat().st_mtime >= max(s.stat().st_mtime for s in sources)


def build_native(force: bool = False) -> Path | None:
    """Compile libmoonshine_client.so with g++; None when the build fails."""
    out = _BUILD_DIR / _LIB
    src = _NATIVE_DIR / "moonshine_client.cpp"
    hdr = _NATIVE_DIR / "moonshine_client.h"
    if not force and _fresh(out, src, hdr):
        return out
    return _compile(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
         "-fvisibility=hidden"], src, out, "native client")


def build_selftest(force: bool = False) -> Path | None:
    """Compile the ``client_selftest`` binary (SHA-1, base64, JSON and the
    frame codec, no socket); run it with an iteration count, it prints
    ``client_selftest OK``.  None when the build fails."""
    out = _BUILD_DIR / "client_selftest"
    src = _NATIVE_DIR / "client_selftest.cpp"
    if not force and _fresh(out, src, _NATIVE_DIR / "moonshine_client.cpp",
                            _NATIVE_DIR / "moonshine_client.h"):
        return out
    return _compile(["g++", "-O1", "-std=c++17", "-pthread"], src, out,
                    "client selftest")


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if auto_build:
        build_native()
    p = _BUILD_DIR / _LIB
    if not p.exists():
        return None
    lib = ctypes.CDLL(str(p))
    lib.mt_client_version.restype = ctypes.c_char_p
    lib.mt_client_connect.restype = ctypes.c_int32
    lib.mt_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.mt_client_start.restype = ctypes.c_int32
    lib.mt_client_start.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.mt_client_add_audio.restype = ctypes.c_int32
    lib.mt_client_add_audio.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.mt_client_stop.restype = ctypes.c_int32
    lib.mt_client_stop.argtypes = [ctypes.c_int32]
    lib.mt_client_set_line_events.restype = ctypes.c_int32
    lib.mt_client_set_line_events.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.mt_client_poll_event.restype = ctypes.c_int32
    lib.mt_client_poll_event.argtypes = [
        ctypes.c_int32, ctypes.POINTER(_Event), ctypes.c_int32,
    ]
    lib.mt_client_free.restype = ctypes.c_int32
    lib.mt_client_free.argtypes = [ctypes.c_int32]
    lib.mt_client_tts.restype = ctypes.c_int32
    lib.mt_client_tts.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mt_client_g2p.restype = ctypes.c_int32
    lib.mt_client_g2p.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.mt_client_embed.restype = ctypes.c_int32
    lib.mt_client_embed.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mt_client_speech_clip.restype = ctypes.c_int32
    lib.mt_client_speech_clip.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(_ClipResult),
    ]
    lib.mt_client_catalog_json.restype = ctypes.c_int32
    lib.mt_client_catalog_json.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


@dataclass
class ClientEvent:
    type: int
    text: str
    segment: int
    start_s: float
    end_s: float
    latency_ms: float
    line_id: int = -1
    speakers: tuple = ()

    @property
    def is_final(self) -> bool:
        return self.type == MT_EVENT_FINAL


class NativeClientStream:
    """One live stream to a TranscriptionServer, through the C library."""

    def __init__(self, host: str, port: int, sample_rate: int = 16000):
        lib = load()
        if lib is None:
            raise RuntimeError("native client library unavailable")
        self._lib = lib
        self._h = lib.mt_client_connect(host.encode(), port)
        if self._h < 0:
            raise ConnectionError(f"mt_client_connect -> {self._h}")
        rc = lib.mt_client_start(self._h, sample_rate)
        if rc < 0:
            raise ConnectionError(f"mt_client_start -> {rc}")

    def add_audio(self, pcm: np.ndarray) -> None:
        pcm = np.ascontiguousarray(pcm, np.float32)
        rc = self._lib.mt_client_add_audio(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pcm.size,
        )
        if rc < 0:
            raise ConnectionError(f"mt_client_add_audio -> {rc}")

    def stop(self) -> None:
        rc = self._lib.mt_client_stop(self._h)
        if rc < 0:
            raise ConnectionError(f"mt_client_stop -> {rc}")

    def set_line_events(self, enabled: bool = True) -> None:
        """Switch poll() to the regularized MT_EVENT_LINE_* stream
        (exactly-once started/completed per line, frozen completed
        lines, only the last line incomplete)."""
        rc = self._lib.mt_client_set_line_events(self._h, 1 if enabled else 0)
        if rc < 0:
            raise ConnectionError(f"mt_client_set_line_events -> {rc}")

    def poll(self, timeout_ms: int) -> ClientEvent | None:
        ev = _Event()
        rc = self._lib.mt_client_poll_event(self._h, ctypes.byref(ev), timeout_ms)
        if rc == 0:
            return None
        if rc < 0:
            raise ConnectionError(f"mt_client_poll_event -> {rc}")
        return ClientEvent(
            type=ev.type, text=ev.text.decode("utf-8", "replace"),
            segment=ev.segment, start_s=ev.start_s, end_s=ev.end_s,
            latency_ms=ev.latency_ms, line_id=ev.line_id,
            speakers=tuple(ev.speakers[i] for i in range(ev.n_speakers)),
        )

    def close(self) -> None:
        if self._h >= 0:
            self._lib.mt_client_free(self._h)
            self._h = -1

    def __enter__(self) -> "NativeClientStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- one-shot RPC wrappers (the native ABI's non-transcription surface) ------


def native_tts(
    host: str, port: int, text: str | None = None, *,
    ipa: str | None = None, voice: str | None = None, max_samples: int = 16000 * 60,
) -> tuple[np.ndarray, int]:
    """Synthesize via mt_client_tts -> (float32 PCM, sample_rate)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native client library unavailable")
    buf = np.zeros(max_samples, np.float32)
    sr = ctypes.c_int32(0)
    n = lib.mt_client_tts(
        host.encode(), port,
        text.encode() if text is not None else None,
        ipa.encode() if ipa is not None else None,
        voice.encode() if voice is not None else None,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
        ctypes.byref(sr),
    )
    if n < 0:
        raise ConnectionError(f"mt_client_tts -> {n}")
    return buf[: min(n, max_samples)].copy(), int(sr.value)


def native_g2p(host: str, port: int, text: str, language: str = "en_us") -> str:
    lib = load()
    if lib is None:
        raise RuntimeError("native client library unavailable")
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.mt_client_g2p(
        host.encode(), port, text.encode(), language.encode(), buf, len(buf)
    )
    if n < 0:
        raise ConnectionError(f"mt_client_g2p -> {n}")
    return buf.value.decode("utf-8", "replace")


def native_embed(host: str, port: int, texts: list[str]) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("native client library unavailable")
    arr = (ctypes.c_char_p * len(texts))(*[t.encode() for t in texts])
    cap = 1 << 22
    buf = np.zeros(cap, np.float32)
    dim = ctypes.c_int32(0)
    total = lib.mt_client_embed(
        host.encode(), port, arr, len(texts),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(dim),
    )
    if total < 0:
        raise ConnectionError(f"mt_client_embed -> {total}")
    d = int(dim.value)
    return buf[:total].reshape(len(texts), d).copy() if total else np.zeros((0, 0))


def native_speech_clip(
    host: str, port: int, pcm: np.ndarray, sample_rate: int = 16000
) -> dict:
    lib = load()
    if lib is None:
        raise RuntimeError("native client library unavailable")
    pcm = np.ascontiguousarray(pcm, np.float32)
    out = _ClipResult()
    rc = lib.mt_client_speech_clip(
        host.encode(), port,
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pcm.size,
        sample_rate, ctypes.byref(out),
    )
    if rc < 0:
        raise ConnectionError(f"mt_client_speech_clip -> {rc}")
    return {
        "found": bool(out.found), "start_s": out.start_s,
        "end_s": out.end_s, "speech_s": out.speech_s,
    }


def native_catalog_json(host: str, port: int, kind: str,
                        arg: str | None = None,
                        options: dict | None = None) -> str:
    """Catalog/dependency JSON over the C ABI (mt_client_catalog_json —
    the reference's moonshine_get_* family, moonshine-c-api.h:910-1074)."""
    import json as _json

    lib = load()
    if lib is None:
        raise RuntimeError("native client library unavailable")
    # mt_client_catalog_json returns the full byte length of the document
    # (which may exceed the buffer); re-issue with a right-sized buffer
    # rather than silently returning a truncated, invalid JSON string.
    cap = 1 << 20
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        n = lib.mt_client_catalog_json(
            host.encode(), port, kind.encode(),
            arg.encode() if arg is not None else None,
            _json.dumps(options).encode() if options else None,
            buf, len(buf),
        )
        if n < 0:
            raise ConnectionError(f"mt_client_catalog_json -> {n}")
        if n < cap:
            return buf.value.decode("utf-8", "replace")
        cap = n + 1
    raise ConnectionError(
        f"mt_client_catalog_json document still exceeds {cap} bytes")
