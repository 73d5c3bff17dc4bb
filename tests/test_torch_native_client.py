"""The port's native C/C++ transcription client (``runtime/native_client.py``
over its own copy of ``runtime/native/``, built with g++ into the port's
``runtime/native/build/``) against the port's ``TranscriptionServer``, on
the CPU.  Mirrors tests/test_native_client.py case for case:
  1. the pure-component selftest binary (SHA-1/base64/JSON/frame codec),
     built by ``native_client.build_selftest``;
  2. the C ABI driven via ctypes against the port's server over the port's
     ``StreamingService`` (JAX's weights carried across with
     ``weights.import_streaming``): streams, line events and the one-shot
     RPCs;
  3. the header-only C++ wrapper (moonshine_client.hpp), compiled and run
     as an external program against the same server;
  4. the five checks of the platform bindings, on the port's copies.
The RPCs are also held against JAX's server with JAX's engines, through
the same client library (``test_rpc_results_match_jax``): IPA and speech
clip bounds equal, embeddings to atol 1e-5 and TTS audio to atol 1e-4
(the bounds of tests/test_torch_gemma.py and tests/test_torch_tts.py for
the same engines).  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import subprocess
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from chip_smoke import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import StreamingConfig
from moonshine_tpu.models import streaming as ms
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.runtime import native_client
from moonshine_tpu_torch.serving import StreamingService

NATIVE_DIR = Path(native_client._NATIVE_DIR)

lib = native_client.load()
pytestmark = pytest.mark.skipif(lib is None, reason="native client unavailable")

CFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16,
    vocab_size=96, d_model_frontend=32, c1=48, c2=64, max_seq_len=64,
    encoder_depth=2,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def test_version():
    assert lib.mt_client_version().decode() == "0.2.0"


def test_selftest_binary():
    exe = native_client.build_selftest()
    assert exe is not None and exe.parent == native_client._BUILD_DIR
    assert native_client._BUILD_DIR.parents[2].name == "moonshine_tpu_torch"
    out = subprocess.run([str(exe), "500"], check=True, capture_output=True,
                         text=True, timeout=120)
    assert "client_selftest OK" in out.stdout


def test_bad_handle_errors():
    ev = native_client._Event()
    import ctypes

    assert lib.mt_client_start(99999, 16000) == -2
    assert lib.mt_client_poll_event(99999, ctypes.byref(ev), 0) == -2
    assert lib.mt_client_free(99999) == -2


def test_connect_refused():
    # A port nothing listens on: connect must fail cleanly, not hang.
    assert lib.mt_client_connect(b"127.0.0.1", 1) == -1


_PARAMS: list = []


def _port_params():
    """JAX's weights (PRNGKey(1), as tests/test_native_client.py draws
    them), carried across once per module."""
    if not _PARAMS:
        params = ms.init_params(CFG, jax.random.PRNGKey(1))
        _PARAMS.append(weights.import_streaming(jax_export(params, CFG), TCFG, device="cpu"))
    return _PARAMS[0]


class _ServerHarness:
    """Runs the port's TranscriptionServer (or ``server``, JAX's) in a
    thread with its own event loop."""

    def __init__(self, n_streams: int = 4, server=None):
        pytest.importorskip("websockets")
        from moonshine_tpu_torch.server import TranscriptionServer

        if server is None:
            svc = StreamingService(
                _port_params(), TCFG, tokenizer=None, n_streams=n_streams,
                update_frames=64, mem_bucket=512, draft_cap=32,
                max_segment_seconds=1.0, device="cpu",
            )
            server = TranscriptionServer(svc, tick_seconds=0.05, port=0)
        self.server = server
        self._ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._task = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        ready = asyncio.Event()

        async def main():
            self._task = asyncio.current_task()
            await self.server.serve(ready=ready)

        async def wait_ready():
            await ready.wait()
            self._ready.set()

        self._loop.create_task(wait_ready())
        try:
            self._loop.run_until_complete(main())
        finally:
            self._loop.close()

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(timeout=120.0), "server failed to start"
        return self

    def __exit__(self, *exc):
        if self._loop is not None and self._task is not None:
            self._loop.call_soon_threadsafe(self._task.cancel)
        self._thread.join(timeout=30.0)
        assert not self._thread.is_alive(), "server thread did not stop"


def _stream_audio(port: int, seed: int, seconds: float = 2.4) -> list:
    rng = np.random.RandomState(seed)
    events = []
    with native_client.NativeClientStream("127.0.0.1", port) as stream:
        n_chunks = int(seconds / 0.4)
        for _ in range(n_chunks):
            stream.add_audio((rng.randn(6400) * 0.1).astype(np.float32))
            time.sleep(0.08)
        stream.stop()
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            ev = stream.poll(timeout_ms=1000)
            if ev is None:
                continue
            events.append(ev)
            if ev.type == native_client.MT_EVENT_STOPPED:
                break
    return events


def test_native_loopback_single_stream():
    with _ServerHarness() as h:
        events = _stream_audio(h.server.port, seed=0)
    types = [e.type for e in events]
    assert types[-1] == native_client.MT_EVENT_STOPPED
    finals = [e for e in events if e.type == native_client.MT_EVENT_FINAL]
    # 2.4 s at a 1 s segment cap -> at least 2 final segments.
    assert len(finals) >= 2
    segs = [e.segment for e in finals]
    assert segs == sorted(segs)
    for e in finals:
        assert e.end_s > e.start_s >= 0.0
        assert e.latency_ms >= 0.0
        # Random weights still produce token text through the fallback
        # tokenizer; the wire must carry it intact.
        assert isinstance(e.text, str)


def test_native_loopback_concurrent_streams():
    with _ServerHarness(n_streams=4) as h:
        results = [None, None]

        def run(i):
            results[i] = _stream_audio(h.server.port, seed=10 + i, seconds=1.6)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    for evs in results:
        assert evs is not None
        assert evs[-1].type == native_client.MT_EVENT_STOPPED
        assert any(e.type == native_client.MT_EVENT_FINAL for e in evs)


def test_server_full_reports_error():
    with _ServerHarness(n_streams=1) as h:
        with native_client.NativeClientStream("127.0.0.1", h.server.port) as s1:
            s2 = native_client.NativeClientStream("127.0.0.1", h.server.port)
            try:
                ev = s2.poll(timeout_ms=10000)
                assert ev is not None and ev.type == native_client.MT_EVENT_ERROR
                assert "full" in ev.text
            finally:
                s2.close()
            s1.stop()


CPP_DEMO = r"""
#include "moonshine_client.hpp"
#include <cstdio>
#include <random>
#include <thread>
int main(int argc, char** argv) {
  int port = atoi(argv[1]);
  moonshine::Stream stream("127.0.0.1", port);
  std::mt19937 rng(7);
  std::normal_distribution<float> dist(0.f, 0.1f);
  std::vector<float> pcm(16000 * 2);
  for (auto& x : pcm) x = dist(rng);
  int n_final = 0;
  auto finals = stream.transcribe(pcm, 6400, 120000,
      [&](const moonshine::Event& ev) {
        if (ev.type == moonshine::Event::Type::Final) ++n_final;
      });
  if (finals.size() != size_t(n_final) || n_final < 1) return 1;
  printf("cpp_demo OK finals=%d\n", n_final);
  return 0;
}
"""


def test_cpp_wrapper_end_to_end(tmp_path):
    src = tmp_path / "demo.cpp"
    src.write_text(CPP_DEMO)
    exe = tmp_path / "demo"
    libpath = native_client.build_native()
    assert libpath is not None
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-pthread", f"-I{NATIVE_DIR}",
         str(src), str(libpath), f"-Wl,-rpath,{libpath.parent}",
         "-o", str(exe)],
        check=True, capture_output=True, text=True,
    )
    with _ServerHarness() as h:
        out = subprocess.run(
            [str(exe), str(h.server.port)], check=True, capture_output=True,
            text=True, timeout=180,
        )
    assert "cpp_demo OK" in out.stdout


# -- one-shot RPC surface (TTS / G2P / embeddings / speech-clip) -------------


class _StubTts:
    def synthesize(self, text, options=None):
        n = 1600 + 100 * len(text)
        t = np.arange(n, dtype=np.float32)
        return np.sin(2 * np.pi * 220.0 * t / 16000.0).astype(np.float32), 16000

    def synthesize_from_phonemes(self, ipa, options=None):
        return self.synthesize(ipa)


class _StubEmbedder:
    def get_embeddings(self, text):
        v = np.zeros(8, np.float32)
        v[0] = float(len(text))
        v[1] = float(sum(map(ord, text)) % 97)
        return v


def _rpc_harness():
    """Server harness with RPC engines injected (stub TTS/embedder, real
    G2P rules engine, stub VAD prob fn for speech-clip)."""
    h = _ServerHarness()

    def hop_prob(hops):
        # voiced where the hop has energy (the stub "VAD")
        return (np.abs(hops).mean(axis=1) > 0.05).astype(np.float32)

    from moonshine_tpu_torch.tts.g2p import GraphemeToPhonemizer

    h.server._tts = _StubTts()
    h.server._g2p = GraphemeToPhonemizer(language="en_us", use_baked_dict=False)
    h.server._embedder = _StubEmbedder()
    h.server._vad_hop_prob_fn = hop_prob
    return h


def test_rpc_tts_roundtrip():
    with _rpc_harness() as h:
        pcm, sr = native_client.native_tts(
            "127.0.0.1", h.server.port, "hello world"
        )
        assert sr == 16000
        assert len(pcm) == 1600 + 100 * len("hello world")
        # The sine survived the float32 wire round trip bit-exactly.
        ref, _ = _StubTts().synthesize("hello world")
        np.testing.assert_array_equal(pcm, ref)


def test_rpc_g2p_roundtrip():
    with _rpc_harness() as h:
        ipa = native_client.native_g2p("127.0.0.1", h.server.port, "hello")
        from moonshine_tpu.tts.g2p import GraphemeToPhonemizer

        want = GraphemeToPhonemizer(
            language="en_us", use_baked_dict=False
        ).text_to_ipa("hello")
        assert ipa == want and ipa  # non-empty UTF-8 IPA through the C ABI


def test_rpc_embed_roundtrip():
    with _rpc_harness() as h:
        emb = native_client.native_embed(
            "127.0.0.1", h.server.port, ["alpha", "beta bee"]
        )
        assert emb.shape == (2, 8)
        np.testing.assert_array_equal(emb[0], _StubEmbedder().get_embeddings("alpha"))
        np.testing.assert_array_equal(
            emb[1], _StubEmbedder().get_embeddings("beta bee")
        )


def test_rpc_speech_clip():
    with _rpc_harness() as h:
        rng = np.random.RandomState(0)
        audio = np.zeros(16000 * 8, np.float32)
        audio[16000 * 2 : 16000 * 7] = (rng.randn(16000 * 5) * 0.3).astype(
            np.float32
        )
        res = native_client.native_speech_clip(
            "127.0.0.1", h.server.port, audio
        )
        assert res["found"]
        # The chosen ~4 s window lies inside the voiced span.
        assert 1.5 <= res["start_s"] <= 3.5
        assert res["speech_s"] >= 2.0


def test_rpc_error_reported_not_hung():
    """An unconfigured embedder turns into a clean protocol error, not a
    hang or crash."""
    with _ServerHarness() as h:  # no engines injected
        with pytest.raises(ConnectionError):
            native_client.native_embed("127.0.0.1", h.server.port, ["x"])


def test_rpc_and_streaming_share_one_server():
    """RPC connections must not consume stream slots: a full RPC workload
    runs while a live stream transcribes on the same server."""
    with _rpc_harness() as h:
        events = []
        t = threading.Thread(
            target=lambda: events.extend(_stream_audio(h.server.port, seed=3)),
        )
        t.start()
        for _ in range(3):
            ipa = native_client.native_g2p("127.0.0.1", h.server.port, "mix")
            assert ipa
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert any(e.type == native_client.MT_EVENT_STOPPED for e in events)


# -- JNI consumer compile check ----------------------------------------------


def test_jni_shim_compiles_and_links(tmp_path):
    """The Android JNI shim is a thin wrapper over moonshine_client.h:
    prove it by compiling + linking it into a shared object exposing the
    Java_* symbols (jni_compat.h declares the JNI subset; a JDK build
    uses the real <jni.h> unchanged)."""
    jni_dir = NATIVE_DIR.parent / "bindings" / "jni"
    out = tmp_path / "libmoonshine_jni.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-pthread",
         str(jni_dir / "moonshine_jni.cpp"),
         str(NATIVE_DIR / "moonshine_client.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    syms = subprocess.run(
        ["nm", "-D", str(out)], check=True, capture_output=True, text=True
    ).stdout
    for fn in ("connect", "addAudio", "pollEventText", "tts", "g2p"):
        assert f"Java_ai_moonshine_tpu_MoonshineClient_{fn}" in syms


def test_rpc_catalog_json():
    """Native catalog/dependency JSON family (reference:
    moonshine-c-api.h:910-1074) over the loopback service boundary."""
    import json as _json

    with _rpc_harness() as h:
        port = h.server.port
        cat = _json.loads(native_client.native_catalog_json(
            "127.0.0.1", port, "stt_catalog"))
        assert any(l["code"] == "en" for l in cat["languages"])
        deps = _json.loads(native_client.native_catalog_json(
            "127.0.0.1", port, "stt_dependencies", "en",
            {"include_spelling": True}))
        assert len(deps["groups"]) == 2
        voices = _json.loads(native_client.native_catalog_json(
            "127.0.0.1", port, "tts_voices", "en"))
        assert voices["en"]
        dia = _json.loads(native_client.native_catalog_json(
            "127.0.0.1", port, "diarization_dependencies"))
        assert dia["groups"][0]["files"]
        # The port's catalog answers as the JAX package's.
        from moonshine_tpu.catalog import catalog_request_json

        assert cat == _json.loads(catalog_request_json("stt_catalog"))
        assert deps == _json.loads(catalog_request_json(
            "stt_dependencies", "en", {"include_spelling": True}))
        # unknown kind surfaces as a server error -> protocol error code
        with pytest.raises(ConnectionError):
            native_client.native_catalog_json("127.0.0.1", port, "nope")


def test_embind_shim_compiles_and_links(tmp_path):
    """The WASM Embind shim is a thin wrapper over moonshine_client.h:
    prove it by compiling + linking it into a shared object against the
    declared-subset embind_compat.h (the WASM analog of the JNI proof;
    an Emscripten SDK build uses the real <emscripten/bind.h> via
    -DMOONSHINE_EMBIND_REAL_HEADER with the same source unchanged)."""
    wasm_dir = NATIVE_DIR.parent / "bindings" / "wasm"
    out = tmp_path / "libmoonshine_embind.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-pthread",
         str(wasm_dir / "moonshine_embind.cpp"),
         str(NATIVE_DIR / "moonshine_client.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    assert out.exists()


def test_java_api_matches_jni_symbols(tmp_path):
    """Every native method declared by the Java API class has a
    matching Java_ai_moonshine_tpu_MoonshineClient_* symbol in the
    compiled JNI shim — the Java surface and the C++ shim cannot
    drift apart silently."""
    import re

    java = (NATIVE_DIR.parent / "bindings" / "android" / "java" / "ai"
            / "moonshine" / "tpu" / "MoonshineClient.java").read_text()
    natives = re.findall(
        r"native\s+[\w\[\]<>]+\s+(\w+)\s*\(", java)
    assert sorted(natives) == sorted(
        ["connect", "start", "addAudio", "stop", "setLineEvents",
         "pollEventText", "free", "tts", "g2p"])
    jni_dir = NATIVE_DIR.parent / "bindings" / "jni"
    out = tmp_path / "libmoonshine_jni_check.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-pthread",
         str(jni_dir / "moonshine_jni.cpp"),
         str(NATIVE_DIR / "moonshine_client.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    syms = subprocess.run(
        ["nm", "-D", str(out)], check=True, capture_output=True, text=True
    ).stdout
    for fn in natives:
        assert f"Java_ai_moonshine_tpu_MoonshineClient_{fn}" in syms, fn


def test_swift_api_matches_c_header():
    """The Swift shim calls only symbols moonshine_client.h declares
    (no swiftc on this image — the ABI consistency is checked
    textually; a Swift toolchain builds the package unchanged via its
    systemLibrary modulemap)."""
    import re

    swift = (NATIVE_DIR.parent / "bindings" / "swift" / "Sources"
             / "MoonshineTpu" / "MoonshineClient.swift").read_text()
    header = (NATIVE_DIR / "moonshine_client.h").read_text()
    calls = set(re.findall(r"\bmt_client_\w+", swift))
    assert calls  # the shim actually binds the ABI
    declared = set(re.findall(r"\bmt_client_\w+", header))
    missing = calls - declared
    assert not missing, f"Swift shim references undeclared symbols: {missing}"
    # the struct layout the Swift side reads must exist
    for field in ("type;", "segment;", "start_s;", "end_s;",
                  "latency_ms;"):
        assert field in header


# ---------------------------------------------------------------------------
# Regularized 5-event line lifecycle over the native wire (VERDICT r4
# item 7; reference: moonshine-c-api.h:165-196, README.md:379-397).
# ---------------------------------------------------------------------------


def _collect_line_events(port: int, seed: int, seconds: float = 2.4) -> list:
    rng = np.random.RandomState(seed)
    events = []
    with native_client.NativeClientStream("127.0.0.1", port) as stream:
        stream.set_line_events(True)
        for _ in range(int(seconds / 0.4)):
            stream.add_audio((rng.randn(6400) * 0.1).astype(np.float32))
            time.sleep(0.08)
        stream.stop()
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            ev = stream.poll(timeout_ms=1000)
            if ev is None:
                continue
            events.append(ev)
            if ev.type == native_client.MT_EVENT_STOPPED:
                break
    return events


def _assert_line_contract(events) -> None:
    """The reference's delivery guarantees: exactly-once started/completed
    per line, frozen completed lines, only the last line incomplete."""
    nc = native_client
    line_kinds = (nc.MT_EVENT_LINE_STARTED, nc.MT_EVENT_LINE_UPDATED,
                  nc.MT_EVENT_LINE_TEXT_CHANGED,
                  nc.MT_EVENT_LINE_SPEAKERS_CHANGED,
                  nc.MT_EVENT_LINE_COMPLETED)
    # raw partial/final never leak through in line mode
    assert all(e.type not in (nc.MT_EVENT_PARTIAL, nc.MT_EVENT_FINAL)
               for e in events)
    started: dict[int, int] = {}
    completed: dict[int, int] = {}
    open_lines: set[int] = set()
    for e in events:
        if e.type not in line_kinds:
            continue
        lid = e.line_id
        assert lid == e.segment  # line id rides the segment field too
        if e.type == nc.MT_EVENT_LINE_STARTED:
            started[lid] = started.get(lid, 0) + 1
            # only-last-line-incomplete: starting a new line means every
            # earlier line is already completed
            assert not open_lines, (lid, open_lines)
            open_lines.add(lid)
        else:
            # frozen-completed-lines: nothing after COMPLETED; everything
            # else requires a prior STARTED
            assert lid in started and lid not in completed, (e.type, lid)
            if e.type == nc.MT_EVENT_LINE_COMPLETED:
                completed[lid] = completed.get(lid, 0) + 1
                open_lines.discard(lid)
    assert all(v == 1 for v in started.values()), started
    assert all(v == 1 for v in completed.values()), completed
    # the stream end (STOPPED) drains every line
    assert set(started) == set(completed)
    assert not open_lines


def test_line_events_loopback_contract():
    with _ServerHarness() as h:
        events = _collect_line_events(h.server.port, seed=3)
    assert events and events[-1].type == native_client.MT_EVENT_STOPPED
    nc = native_client
    n_started = sum(e.type == nc.MT_EVENT_LINE_STARTED for e in events)
    n_completed = sum(e.type == nc.MT_EVENT_LINE_COMPLETED for e in events)
    # 2.4 s at a 1 s segment cap -> at least 2 lines, each exactly once
    assert n_started >= 2 and n_started == n_completed
    assert any(e.type == nc.MT_EVENT_LINE_UPDATED for e in events)
    _assert_line_contract(events)


class _ScriptedServer:
    """Minimal websockets stub that ignores audio and replays a scripted
    event sequence after the start message — lets the test pin the exact
    client-side regularization, including speaker changes the live
    service doesn't emit."""

    def __init__(self, script: list[dict]):
        pytest.importorskip("websockets")
        self.script = script
        self.port = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import json

        import websockets

        async def handler(ws):
            async for message in ws:
                if isinstance(message, bytes):
                    continue
                msg = json.loads(message)
                if msg.get("type") == "start":
                    for ev in self.script:
                        await ws.send(json.dumps(ev))
                elif msg.get("type") == "stop":
                    await ws.send(json.dumps({"type": "stopped"}))
                    return

        async def main():
            async with websockets.serve(handler, "127.0.0.1", 0) as server:
                self.port = server.sockets[0].getsockname()[1]
                self._ready.set()
                await asyncio.Future()

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main())
        except Exception:
            pass
        finally:
            loop.close()

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(timeout=30.0)
        return self

    def __exit__(self, *exc):
        pass  # daemon thread; the client closing ends the handler


def test_line_events_regularization_scripted():
    nc = native_client
    script = [
        {"type": "partial", "segment": 0, "text": "a"},
        {"type": "partial", "segment": 0, "text": "a"},     # no text change
        {"type": "partial", "segment": 0, "text": "ab",
         "speakers": [1]},                                   # text + speakers
        {"type": "partial", "segment": 1, "text": "x"},      # forces 0 done
        {"type": "final", "segment": 1, "text": "xy"},
        {"type": "partial", "segment": 1, "text": "zz"},     # frozen: dropped
    ]
    with _ScriptedServer(script) as srv:
        events = []
        with native_client.NativeClientStream("127.0.0.1", srv.port) as s:
            s.set_line_events(True)
            s.stop()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                ev = s.poll(timeout_ms=500)
                if ev is None:
                    continue
                events.append(ev)
                if ev.type == nc.MT_EVENT_STOPPED:
                    break
    kinds = [(e.type, e.line_id) for e in events]
    assert kinds == [
        (nc.MT_EVENT_LINE_STARTED, 0),
        (nc.MT_EVENT_LINE_UPDATED, 0),
        (nc.MT_EVENT_LINE_TEXT_CHANGED, 0),    # "" -> "a"
        (nc.MT_EVENT_LINE_UPDATED, 0),         # same text: update only
        (nc.MT_EVENT_LINE_UPDATED, 0),
        (nc.MT_EVENT_LINE_TEXT_CHANGED, 0),    # "a" -> "ab"
        (nc.MT_EVENT_LINE_SPEAKERS_CHANGED, 0),
        (nc.MT_EVENT_LINE_COMPLETED, 0),       # regularized before line 1
        (nc.MT_EVENT_LINE_STARTED, 1),
        (nc.MT_EVENT_LINE_UPDATED, 1),
        (nc.MT_EVENT_LINE_TEXT_CHANGED, 1),    # "" -> "x"
        (nc.MT_EVENT_LINE_UPDATED, 1),
        (nc.MT_EVENT_LINE_TEXT_CHANGED, 1),    # "x" -> "xy"
        (nc.MT_EVENT_LINE_COMPLETED, 1),
        (nc.MT_EVENT_STOPPED, -1),             # frozen-line update dropped
    ], kinds
    # the dropped frozen-line update produced NOTHING between COMPLETED(1)
    # and STOPPED
    sp = [e for e in events
          if e.type == nc.MT_EVENT_LINE_SPEAKERS_CHANGED]
    assert sp and sp[0].speakers == (1,)
    _assert_line_contract(events)


def test_idiomatic_binding_surfaces_consistent():
    """The round-5 idiomatic API classes (MicTranscriber / TextToSpeech /
    listener surfaces per platform, VERDICT r4 missing #5) must only
    reference shim symbols that actually exist — the same textual
    consistency contract as the shims themselves (no javac/tsc/swiftc on
    the image; the JNI/embind shims ARE compiled in the tests above)."""
    import re

    b = NATIVE_DIR.parent / "bindings"

    # Java: every MoonshineClient.X(...) call resolves to a declared
    # native method; every TranscriptEvent.Y constant exists.
    client = (b / "android/java/ai/moonshine/tpu/MoonshineClient.java").read_text()
    event = (b / "android/java/ai/moonshine/tpu/TranscriptEvent.java").read_text()
    natives = set(re.findall(r"native\s+[\w\[\]<>]+\s+(\w+)\s*\(", client))
    consts = set(re.findall(r"public static final int (\w+)", event))
    for f in ("MicTranscriber.java", "TextToSpeech.java",
              "TranscriptEventListener.java"):
        src = (b / "android/java/ai/moonshine/tpu" / f).read_text()
        for m in re.findall(r"MoonshineClient\.(\w+)\(", src):
            assert m in natives, (f, m)
        for c in re.findall(r"TranscriptEvent\.([A-Z_]+)\b", src):
            assert c in consts, (f, c)

    # TS: every shim method the MicTranscriber calls is registered in
    # the embind shim.
    embind = (b / "wasm/moonshine_embind.cpp").read_text()
    registered = set(re.findall(r'\.function\("(\w+)"', embind))
    ts = (b / "wasm/ts/mic-transcriber.ts").read_text()
    for m in re.findall(r"ShimStream\b", ts):
        pass  # interface presence
    iface = re.search(r"interface ShimStream \{(.*?)\}", ts, re.S).group(1)
    for m in re.findall(r"^\s*(\w+)\(", iface, re.M):
        assert m in registered, m

    # Swift: every mt_client_* call in the new classes is declared in
    # the C header; the Kind cases used exist in MoonshineClient.swift.
    header = (NATIVE_DIR / "moonshine_client.h").read_text()
    decls = set(re.findall(r"mt_client_\w+", header))
    # Kind cases may be grouped (case a = 0, b = 1): collect every
    # `name = <int>` enum member.
    kinds = set(re.findall(
        r"(\w+)\s*=\s*\d",
        (b / "swift/Sources/MoonshineTpu/MoonshineClient.swift").read_text()))
    for f in ("MicTranscriber.swift", "TextToSpeech.swift"):
        src = (b / "swift/Sources/MoonshineTpu" / f).read_text()
        for sym in re.findall(r"mt_client_\w+", src):
            assert sym in decls, (f, sym)
        for k in re.findall(r"case \.(\w+):", src):
            assert k in kinds, (f, k)


# ---------------------------------------------------------------------------
# The RPCs' results against JAX's server with JAX's engines.
# ---------------------------------------------------------------------------


def _clip_audio() -> np.ndarray:
    rng = np.random.RandomState(0)
    audio = np.zeros(16000 * 8, np.float32)
    audio[16000 * 2 : 16000 * 7] = (rng.randn(16000 * 5) * 0.3).astype(np.float32)
    return audio


def _hop_prob(hops):
    return (np.abs(hops).mean(axis=1) > 0.05).astype(np.float32)


def _rpc_results(server) -> dict:
    texts = ["alpha", "beta bee", "the quick brown fox"]
    with _ServerHarness(server=server) as h:
        port = h.server.port
        return {
            "tts": native_client.native_tts("127.0.0.1", port, "hello world"),
            "tts_ipa": native_client.native_tts("127.0.0.1", port, ipa="hɛloʊ wɜːld"),
            "g2p": [native_client.native_g2p("127.0.0.1", port, t) for t in
                    ("hello", "read the 2nd chapter", "naïve café")],
            "embed": native_client.native_embed("127.0.0.1", port, texts),
            "clip": native_client.native_speech_clip("127.0.0.1", port, _clip_audio()),
            "clip_8k": native_client.native_speech_clip(
                "127.0.0.1", port, _clip_audio()[::2].copy(), sample_rate=8000),
        }


def test_rpc_results_match_jax():
    """The same requests through the C ABI to JAX's server (JAX's TTS,
    G2P, embedder) and to the port's (the port's, with JAX's weights)."""
    from moonshine_tpu.models import gemma as jg
    from moonshine_tpu.models import tts as jtm
    from moonshine_tpu.server import TranscriptionServer as JaxServer
    from moonshine_tpu.serving import StreamingService as JaxService
    from moonshine_tpu.tts import facade as jfacade
    from moonshine_tpu.tts.g2p import GraphemeToPhonemizer as JaxG2P
    from moonshine_tpu_torch.models import gemma as tg
    from moonshine_tpu_torch.models import tts as ttm
    from moonshine_tpu_torch.server import TranscriptionServer
    from moonshine_tpu_torch.tts import facade as tfacade
    from moonshine_tpu_torch.tts.g2p import GraphemeToPhonemizer

    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    tts_cfg = jtm.TTSConfig(dim=64, encoder_layers=1, decoder_layers=1, heads=4)
    tts_params = jtm.init_params(tts_cfg, jax.random.PRNGKey(0))
    style = np.asarray(jtm.make_voice(jax.random.PRNGKey(1)))
    gemma_cfg = jg.GemmaTextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=16, sliding_window=8, global_layer_interval=2,
        query_pre_attn_scalar=16.0, projection_hidden=96, embedding_dim=48,
        max_seq_length=64)
    gemma_params = jg.init_params(gemma_cfg, jax.random.PRNGKey(0))

    jparams = ms.init_params(CFG, jax.random.PRNGKey(1))
    jax_server = JaxServer(
        JaxService(jparams, CFG, tokenizer=None, n_streams=2, update_frames=64,
                   mem_bucket=512, draft_cap=32),
        tick_seconds=0.05, port=0,
        tts_engine=jfacade.TextToSpeech(params=tts_params, cfg=tts_cfg).voice("v").load(
            {"v": style}),
        g2p_engine=JaxG2P(language="en_us", use_baked_dict=False),
        embedder=jg.GemmaEmbedder(gemma_params, gemma_cfg, ByteTokenizer()),
        vad_hop_prob_fn=_hop_prob)
    server = TranscriptionServer(
        StreamingService(_port_params(), TCFG, tokenizer=None, n_streams=2, update_frames=64,
                         mem_bucket=512, draft_cap=32, device="cpu"),
        tick_seconds=0.05, port=0,
        tts_engine=tfacade.TextToSpeech(
            params=weights.tts_params_from_jax_numpy(tree(tts_params), "cpu"),
            cfg=ttm.TTSConfig(*tts_cfg), device="cpu").voice("v").load({"v": style}),
        g2p_engine=GraphemeToPhonemizer(language="en_us", use_baked_dict=False),
        embedder=tg.GemmaEmbedder(
            weights.gemma_params_from_jax_numpy(tree(gemma_params), "cpu"),
            tg.GemmaTextConfig(**gemma_cfg.__dict__), ByteTokenizer(), device="cpu"),
        vad_hop_prob_fn=_hop_prob)
    ref, out = _rpc_results(jax_server), _rpc_results(server)
    for key in ("tts", "tts_ipa"):
        (wav, sr), (jwav, jsr) = out[key], ref[key]
        assert sr == jsr == 24000 and wav.shape == jwav.shape and wav.size > 0
        np.testing.assert_allclose(wav, jwav, atol=1e-4, rtol=0)
    assert out["g2p"] == ref["g2p"] and all(out["g2p"])
    assert out["embed"].shape == ref["embed"].shape == (3, 48)
    np.testing.assert_allclose(out["embed"], ref["embed"], atol=1e-5, rtol=0)
    assert out["clip"] == ref["clip"] and out["clip"]["found"]
    assert out["clip_8k"] == ref["clip_8k"] and out["clip_8k"]["found"]
