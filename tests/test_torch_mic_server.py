"""The port's ``mic.MicTranscriber`` and WebSocket ``TranscriptionServer``
against the JAX package's, on the CPU.  Mirrors tests/test_mic_server.py:

- a ``WavSource`` into ``MicTranscriber`` over both packages'
  ``Transcriber`` (one HF checkpoint in a catalog cache that both resolve),
  through the port's native ring;
- mute and unmute;
- the WebSocket loopback at (clients, cohorts) = (1, 1), (3, 1), (3, 2):
  the same client audio into JAX's server over JAX's service and into the
  port's server over the port's service, with JAX's weights carried across
  (``weights.import_streaming``, as tests/test_torch_serving.py does);
- a full server's rejection (``slow``, as in JAX).

Tolerances: transcript lines (text, start, duration, completion) must
equal JAX's, and so must every server event but ``latency_ms``.  The
mic's update passes follow the host's clock, so its partial texts are
checked for their contract only; a completed line's text depends on its
segment's audio alone.  The service's texts do depend on which updates
saw which audio (JAX's own server gave segment 1 of client 10 two
different final texts on its first, compiling, run and on the runs after
it), so the loopback holds every update back until each client's audio
and stop are in: the same updates then see the same audio in both
packages.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_api import _speechy_audio, catalog_cache  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import serving as jserving
from moonshine_tpu.core.config import StreamingConfig
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.audio.wav import save_wav
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.serving import ShardedStreamingService, StreamingService

# tests/test_mic_server.py's CFG.
CFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16,
    vocab_size=96, d_model_frontend=32, c1=48, c2=64, max_seq_len=64,
    encoder_depth=2,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
KW = dict(update_frames=64, mem_bucket=512, draft_cap=32, max_segment_seconds=1.0)


def _lines(transcript) -> list:
    return [(line.text, line.start_time, line.duration, line.is_complete)
            for line in transcript.lines]


def _mic_run(mic_module, transcriber, path):
    texts: list[str] = []
    mic = (
        mic_module.MicTranscriber()
        .use_transcriber(transcriber)
        .update_interval(0.25)
        .audio_source(mic_module.WavSource(path, pace=False))
        .on_text(texts.append)
    )
    mic.load()
    mic.start()
    # The source is finite: wait for the pump thread to drain it.
    mic._thread.join(timeout=120.0)
    assert not mic._thread.is_alive()
    ring = mic._ring
    transcript = mic.stop()
    return transcript, texts, ring


def test_mic_transcriber_with_wav_source_matches_jax(catalog_cache, tmp_path):  # noqa: F811
    from moonshine_tpu import api as japi
    from moonshine_tpu import mic as jmic
    from moonshine_tpu_torch import api as tapi
    from moonshine_tpu_torch import mic as tmic
    from moonshine_tpu_torch.runtime.native_host import NativeRing

    audio = np.concatenate([_speechy_audio(1.4, 31), np.zeros(4000, np.float32),
                            _speechy_audio(1.3, 32)])
    path = str(tmp_path / "in.wav")
    save_wav(path, audio, 16000)
    opts = dict(vad_threshold=0, vad_max_segment_duration=1.0)
    jt = japi.Transcriber("base", "en").with_options(**opts)
    tt = tapi.Transcriber("base", "en", device="cpu").with_options(**opts)
    ref, _, _ = _mic_run(jmic, jt, path)
    out, texts, ring = _mic_run(tmic, tt, path)
    assert isinstance(ring, NativeRing)
    assert _lines(out) == _lines(ref)
    assert len(out.lines) >= 2 and all(line.is_complete for line in out.lines)
    # on_text fired, and each line's last text is its final text.
    assert texts and out.lines[-1].text == texts[-1]
    assert {line.text for line in out.lines} <= set(texts)


def test_mic_load_builds_a_cuda_transcriber_by_default(monkeypatch):
    """Without use_transcriber, load() builds the port's Transcriber on
    the default device (CUDA): on a host without CUDA it refuses; the
    .device(...) setter names the sound device and is not a torch device."""
    from moonshine_tpu_torch import mic as tmic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mic = tmic.MicTranscriber().device("hw:1")
    assert mic._device == "hw:1"
    with pytest.raises(RuntimeError, match="CUDA"):
        mic.load()


def test_mic_mute_and_unmute():
    from moonshine_tpu_torch.mic import MicTranscriber

    mic = MicTranscriber()
    mic.mute()
    assert mic._muted
    mic.unmute()
    assert not mic._muted


def test_muted_mic_zeroes_the_audio():
    """A muted mic feeds silence of the same length to the stream."""
    from moonshine_tpu_torch.mic import MicTranscriber

    class Stream:
        fed: list = []

        def add_audio(self, audio, sr):
            self.fed.append((audio.copy(), sr))

    blocks = [np.full(1600, 0.5, np.float32), np.full(800, -0.25, np.float32)]
    mic = MicTranscriber().audio_source(blocks)
    mic._stream, mic._running = Stream(), True
    mic.mute()
    mic._pump()
    fed = Stream.fed
    assert [len(a) for a, _ in fed] == [1600, 800] and all(sr == 16000 for _, sr in fed)
    assert all(not a.any() for a, _ in fed)


@pytest.fixture(scope="module")
def service_params():
    params = jms.init_params(CFG, jax.random.PRNGKey(1))
    return params, weights.import_streaming(jax_export(params, CFG), TCFG, device="cpu")


def _servers(service_params, n_streams: int, cohorts: int):
    from moonshine_tpu.server import TranscriptionServer as JaxServer
    from moonshine_tpu_torch.server import TranscriptionServer

    jp, tp = service_params
    if cohorts > 1:
        jsvc = jserving.ShardedStreamingService(jp, CFG, tokenizer=None, n_streams=n_streams,
                                                n_cohorts=cohorts, **KW)
        tsvc = ShardedStreamingService(tp, TCFG, tokenizer=None, n_streams=n_streams,
                                       n_cohorts=cohorts, device="cpu", **KW)
    else:
        jsvc = jserving.StreamingService(jp, CFG, tokenizer=None, n_streams=n_streams, **KW)
        tsvc = StreamingService(tp, TCFG, tokenizer=None, n_streams=n_streams, device="cpu",
                                **KW)
    return (JaxServer(jsvc, tick_seconds=0.05, port=0),
            TranscriptionServer(tsvc, tick_seconds=0.05, port=0))


async def _client(websockets, uri: str, seed: int) -> list[dict]:
    rng = np.random.RandomState(seed)
    events = []
    async with websockets.connect(uri) as ws:
        await ws.send(json.dumps({"type": "start", "sample_rate": 16000}))
        for _ in range(6):  # 6 x 0.4 s = 2.4 s -> >= 2 segments at 1 s cap
            chunk = (rng.randn(6400) * 0.1).astype(np.float32)
            await ws.send(chunk.tobytes())
            await asyncio.sleep(0.08)
        await ws.send(json.dumps({"type": "stop"}))
        while True:
            msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=60.0))
            events.append(msg)
            if msg["type"] == "stopped":
                break
    return events


def _gate_updates(server, n_clients: int) -> None:
    """The service's updates return nothing, and run nothing, until all
    ``n_clients`` streams have connected and stopped; from then on they
    run as usual."""
    svc = server.service
    opened = []
    for name in ("update", "update_live"):
        real = getattr(svc, name, None)
        if real is None:
            continue

        def gated(*args, real=real, **kw):
            if not opened:
                conns = list(server._conns)
                if len(conns) < n_clients or any(svc.slots[s].active for s in conns):
                    return []
                opened.append(True)
            return real(*args, **kw)

        setattr(svc, name, gated)


def _loopback(websockets, server, n_clients: int, gate: bool = True) -> list:
    if gate:
        _gate_updates(server, n_clients)

    async def run():
        ready = asyncio.Event()
        serve_task = asyncio.create_task(server.serve(ready))
        await asyncio.wait_for(ready.wait(), timeout=30.0)
        uri = f"ws://{server.host}:{server.port}"
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(_client(websockets, uri, 10 + i) for i in range(n_clients))),
                timeout=240.0)
        finally:
            serve_task.cancel()
            try:
                await serve_task
            except asyncio.CancelledError:
                pass

    events = asyncio.run(run())
    assert server._update_thread is not None and not server._update_thread.is_alive()
    return events


def _check_protocol(events) -> None:
    kinds = [e["type"] for e in events]
    assert kinds[-1] == "stopped" and kinds.count("stopped") == 1
    finals = [e for e in events if e["type"] == "final"]
    # 2.4 s at a 1 s force-split -> at least 2 finalized segments.
    assert len(finals) >= 2
    segs = [e["segment"] for e in finals]
    assert segs == sorted(segs)
    assert all("latency_ms" in e for e in finals)


@pytest.mark.parametrize("n_clients,cohorts", [(1, 1), (3, 1), (3, 2)])
def test_websocket_loopback_matches_jax(service_params, n_clients, cohorts):
    websockets = pytest.importorskip("websockets")
    jax_server, server = _servers(service_params, 4, cohorts)
    ref = _loopback(websockets, jax_server, n_clients)
    out = _loopback(websockets, server, n_clients)
    for events, jax_events in zip(out, ref):
        _check_protocol(events)
        drop = lambda evs: [{k: v for k, v in e.items() if k != "latency_ms"} for e in evs]
        assert drop(events) == drop(jax_events)


@pytest.mark.parametrize("n_clients,cohorts", [(3, 1), (3, 2)])
def test_websocket_loopback_ticks_while_audio_arrives(service_params, n_clients, cohorts):
    """The port's server alone, its updates not held back: the device
    loop ticks while the clients' audio and stops arrive, as in serving.
    The texts then follow the clock, so only the protocol is checked,
    and every slot must come back free."""
    websockets = pytest.importorskip("websockets")
    _, server = _servers(service_params, 4, cohorts)
    for events in _loopback(websockets, server, n_clients, gate=False):
        _check_protocol(events)
    assert not server._conns and sorted(server._free) == list(range(server.service.S))


@pytest.mark.slow
def test_server_full_rejects(service_params):
    websockets = pytest.importorskip("websockets")
    from moonshine_tpu_torch.server import TranscriptionServer

    svc = StreamingService(service_params[1], TCFG, tokenizer=None, n_streams=1,
                           update_frames=64, mem_bucket=512, draft_cap=32, device="cpu")
    server = TranscriptionServer(svc, tick_seconds=0.05, port=0)

    async def run():
        ready = asyncio.Event()
        serve_task = asyncio.create_task(server.serve(ready))
        await asyncio.wait_for(ready.wait(), timeout=10.0)
        uri = f"ws://{server.host}:{server.port}"
        try:
            async with websockets.connect(uri) as ws1:
                await ws1.send(json.dumps({"type": "start"}))
                async with websockets.connect(uri) as ws2:
                    # Mode select happens on the first message (RPC calls
                    # don't consume stream slots), so the full rejection
                    # arrives after the client declares streaming intent.
                    await ws2.send(json.dumps({"type": "start"}))
                    msg = json.loads(await asyncio.wait_for(ws2.recv(), timeout=10.0))
                    assert msg["type"] == "error"
        finally:
            serve_task.cancel()
            try:
                await serve_task
            except asyncio.CancelledError:
                pass

    asyncio.run(run())


def test_make_server_builds_main_s_service(monkeypatch):
    """server.main's service: --streams slots of --model, cohorts behind
    ShardedStreamingService, seeded weights on the named device."""
    from moonshine_tpu_torch import server as tserver
    from moonshine_tpu_torch.core import config as tconfig

    monkeypatch.setitem(tconfig.STREAMING_ARCHS, "tiny_streaming", TCFG)
    one = tserver.make_server(["--streams", "4", "--device", "cpu", "--port", "0"])
    assert isinstance(one.service, StreamingService) and one.service.S == 4
    assert one.device.type == "cpu" and one.port == 0 and one.tick == 0.25
    two = tserver.make_server(["--streams", "4", "--cohorts", "2", "--device", "cpu",
                               "--tick", "0.1"])
    assert isinstance(two.service, ShardedStreamingService) and two.service.K == 2
    assert two.device.type == "cpu" and two.tick == 0.1
    for a, b in zip(one.service.params.parameters(), two.service.cohorts[0].params.parameters()):
        assert torch.equal(a, b)
