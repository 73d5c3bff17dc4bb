"""WebSocket streaming transcription server, in PyTorch.

Counterpart of the JAX package's ``server.py``, over the port's
``serving.StreamingService`` / ``ShardedStreamingService``, with the same
wire protocol (so the native client and the platform bindings in
``runtime/`` talk to either).  The serving analog of the reference's
on-device bindings (the repo's PARITY.md names a remote client API as the
pod-service replacement for Swift/Android/WASM): remote clients hold one
live stream each; the server multiplexes every connected stream onto ONE
batched device program per update tick.

Protocol (one WebSocket per stream):
  client -> server:  {"type": "start", "sample_rate": 16000}   (JSON)
                      <binary frames: float32 little-endian PCM>
                      {"type": "stop"}
  server -> client:  {"type": "partial"|"final", "text": ..., "segment": N,
                      "start": s, "end": s, "latency_ms": f}
                     {"type": "stopped"}   after the final flush

One-shot RPC (first message selects the mode; the connection carries one
request and closes) — the service-boundary analogs of the reference's
non-transcription C ABI entry points (reference: moonshine-c-api.h
:849-890/:1087-1111 TTS, :1140-1184 G2P, :703-758 embeddings, :812
speech-clip extraction):
  {"type": "tts", "text": ...}            -> {"type":"tts_audio",
                                              "sample_rate":sr,"n":N}
                                             + one binary float32 frame
  {"type": "g2p", "text": ...}            -> {"type":"g2p_result","ipa":...}
  {"type": "embed", "texts": [...]}       -> {"type":"embedding","n":N,
                                              "dim":D} + binary float32 [N,D]
  {"type": "speech_clip", "sample_rate":r}
      then binary PCM frames, then {"type":"end"}
                                          -> {"type":"clip","start_s":...,
                                              "end_s":...,"found":bool}

The device loop runs in one thread at the service cadence; asyncio
handlers only move bytes — audio into slots, events out to sockets.
RPC work runs on a thread-pool executor so it never blocks the stream
event loop.  Every thread that touches the service or an engine first
makes the service's device its current CUDA device (``device_scope``):
a thread's current device is its own, not its creator's.  ``websockets``
is imported by ``serve`` only.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from dataclasses import dataclass

import numpy as np

import torch

from .core.device import device_scope
from .serving import StreamingService


@dataclass
class _Conn:
    slot: int
    sample_rate: int
    queue: "asyncio.Queue"
    stopping: bool = False
    last_segment_final: int = -1


class TranscriptionServer:
    """Bridges WebSocket connections to StreamingService slots."""

    def __init__(
        self,
        service: StreamingService,
        tick_seconds: float = 0.25,
        host: str = "127.0.0.1",
        port: int = 8765,
        tts_engine=None,  # tts.facade.TextToSpeech (loaded) or None -> lazy
        g2p_engine=None,  # tts.g2p.GraphemeToPhonemizer or None -> lazy
        embedder=None,  # models.gemma.GemmaEmbedder-like or None -> refused
        vad_hop_prob_fn=None,  # for speech_clip RPC; None -> refused
    ):
        self.service = service
        self.device = _service_device(service)
        self.tick = tick_seconds
        self.host = host
        self.port = port
        self._tts = tts_engine
        self._g2p = g2p_engine
        self._embedder = embedder
        self._vad_hop_prob_fn = vad_hop_prob_fn
        self._free = list(range(service.S))[::-1]
        self._conns: dict[int, _Conn] = {}
        self._lock = threading.Lock()
        self._running = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._update_thread: threading.Thread | None = None

    # -- slot management ------------------------------------------------------

    def _acquire_slot(self) -> int | None:
        with self._lock:
            if not self._free:
                return None
            if hasattr(self.service, "cohort_of"):
                # Sharded service: place the client in the least-loaded
                # cohort so load spreads instead of packing cohort 0
                # (update ticks skip cohorts with no connections).
                load: dict[int, int] = {}
                for s in self._conns:
                    c = self.service.cohort_of(s)
                    load[c] = load.get(c, 0) + 1
                slot = min(
                    self._free,
                    key=lambda s: load.get(self.service.cohort_of(s), 0),
                )
                self._free.remove(slot)
            else:
                slot = self._free.pop()
            self.service.open_slot(slot)
            return slot

    def _release_slot(self, slot: int) -> None:
        with self._lock:
            self._conns.pop(slot, None)
            self._free.append(slot)

    # -- device update loop -----------------------------------------------------

    def _update_loop(self) -> None:
        with device_scope(self.device):
            while self._running:
                t0 = time.monotonic()
                with self._lock:
                    if not self._conns:
                        events = []
                    elif hasattr(self.service, "update_live"):
                        # Sharded service: tick the next cohort that holds a
                        # connection — an empty cohort's device program is
                        # pure burnt chip time.
                        events = self.service.update_live(self._conns.keys())
                    else:
                        events = self.service.update()
                    conns = dict(self._conns)
                for ev in events:
                    conn = conns.get(ev.slot)
                    if conn is None:
                        continue
                    payload = {
                        "type": "final" if ev.is_final else "partial",
                        "text": ev.text,
                        "segment": ev.segment_id,
                        "start": round(ev.start_time, 3),
                        "end": round(ev.end_time, 3),
                        "latency_ms": round(ev.latency_ms, 1),
                    }
                    # Speaker annotations ride along when the service carries
                    # them (diarization-attached deployments); the native
                    # client's line-event mode diffs them into
                    # LINE_SPEAKERS_CHANGED events.
                    speakers = getattr(ev, "speakers", None)
                    if speakers:
                        payload["speakers"] = [int(s) for s in speakers]
                    if ev.is_final:
                        conn.last_segment_final = ev.segment_id
                    if self._loop is not None:
                        self._loop.call_soon_threadsafe(conn.queue.put_nowait, payload)
                # Stopping conns flush once their final segment lands.
                for slot, conn in conns.items():
                    if conn.stopping and not self._slot_busy(slot):
                        if self._loop is not None:
                            self._loop.call_soon_threadsafe(
                                conn.queue.put_nowait, {"type": "stopped"}
                            )
                        conn.stopping = False
                elapsed = time.monotonic() - t0
                time.sleep(max(self.tick - elapsed, 0.0))

    def _slot_busy(self, slot: int) -> bool:
        s = self.service.slots[slot]
        return (
            s.fed_samples > 0
            or len(s.pending) > 0
            or len(s.raw_buffer) > 0
            or s.seg_final_queued
        )

    # -- one-shot RPC surface ---------------------------------------------------

    _RPC_TYPES = ("tts", "g2p", "embed", "speech_clip", "catalog")

    def _rpc_tts(self, msg: dict):
        if self._tts is None:
            from .tts.facade import TextToSpeech

            voice = msg.get("voice")
            t = TextToSpeech(device=self.device)
            if voice:
                t = t.voice(voice)
            self._tts = t.load()
        if msg.get("ipa"):
            wav, sr = self._tts.synthesize_from_phonemes(msg["ipa"])
        else:
            wav, sr = self._tts.synthesize(str(msg.get("text", "")))
        return wav.astype(np.float32), sr

    def _rpc_g2p(self, msg: dict) -> str:
        if self._g2p is None:
            from .tts.g2p import GraphemeToPhonemizer

            self._g2p = GraphemeToPhonemizer(
                language=str(msg.get("language", "en_us"))
            )
        return self._g2p.text_to_ipa(str(msg.get("text", "")))

    def _rpc_embed(self, texts: list[str]) -> np.ndarray:
        if self._embedder is None:
            raise RuntimeError("embedding model not configured")
        return np.stack([
            np.asarray(self._embedder.get_embeddings(t), np.float32)
            for t in texts
        ])

    def _on_device(self, fn, *args):
        """``fn(*args)`` with the service's device current (executor
        threads are shared and start on the default device)."""
        with device_scope(self.device):
            return fn(*args)

    async def _handle_rpc(self, websocket, msg: dict) -> None:
        loop = asyncio.get_running_loop()
        kind = msg.get("type")
        try:
            if kind == "tts":
                wav, sr = await loop.run_in_executor(None, self._on_device, self._rpc_tts, msg)
                await websocket.send(json.dumps(
                    {"type": "tts_audio", "sample_rate": sr, "n": int(len(wav))}
                ))
                await websocket.send(wav.astype("<f4").tobytes())
            elif kind == "g2p":
                ipa = await loop.run_in_executor(None, self._on_device, self._rpc_g2p, msg)
                await websocket.send(json.dumps({"type": "g2p_result", "ipa": ipa}))
            elif kind == "catalog":
                # catalog/dependency JSON surface (reference:
                # moonshine-c-api.h:910-1074 moonshine_get_* family)
                from .catalog import catalog_request_json

                payload = await loop.run_in_executor(
                    None, catalog_request_json, str(msg.get("kind", "")),
                    msg.get("arg"), msg.get("options"))
                data = payload.encode("utf-8")
                # JSON rides a binary frame (header carries the byte
                # count) so native mini-parsers never see nested escapes
                await websocket.send(json.dumps(
                    {"type": "catalog_json", "n": len(data)}))
                await websocket.send(data)
            elif kind == "embed":
                texts = [str(t) for t in msg.get("texts", [])]
                emb = await loop.run_in_executor(None, self._on_device, self._rpc_embed, texts)
                await websocket.send(json.dumps({
                    "type": "embedding", "n": int(emb.shape[0]),
                    "dim": int(emb.shape[1]) if emb.size else 0,
                }))
                await websocket.send(emb.astype("<f4").tobytes())
            elif kind == "speech_clip":
                if self._vad_hop_prob_fn is None:
                    raise RuntimeError("speech-clip VAD not configured")
                sr = int(msg.get("sample_rate", 16000))
                chunks: list[np.ndarray] = []
                async for message in websocket:
                    if isinstance(message, (bytes, bytearray)):
                        chunks.append(np.frombuffer(message, np.float32))
                    else:
                        if json.loads(message).get("type") == "end":
                            break
                audio = (
                    np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
                )
                if sr != 16000:
                    from .audio.resample import resample_audio

                    audio = resample_audio(audio, sr, 16000)
                from .pipeline.speech_clip import extract_speech_clip

                clip = await loop.run_in_executor(
                    None, self._on_device, extract_speech_clip, audio,
                    self._vad_hop_prob_fn,
                )
                await websocket.send(json.dumps({
                    "type": "clip",
                    "found": bool(clip.is_complete),
                    "start_s": round(float(clip.start_time_seconds), 3),
                    "end_s": round(
                        float(clip.start_time_seconds) + len(clip.audio) / 16000.0, 3
                    ),
                    "speech_s": round(float(clip.speech_seconds), 3),
                }))
        except Exception as e:
            await websocket.send(json.dumps({"type": "error", "error": repr(e)}))
        finally:
            await websocket.close()

    # -- websocket handler ------------------------------------------------------

    async def _handle(self, websocket) -> None:
        # Mode select on the first message: a known RPC type handles one
        # request without consuming a stream slot; anything else is the
        # streaming protocol with the first message replayed.
        try:
            first = await websocket.recv()
        except Exception:
            return
        if isinstance(first, str):
            try:
                head = json.loads(first)
            except ValueError:
                head = {}
            if head.get("type") in self._RPC_TYPES:
                await self._handle_rpc(websocket, head)
                return
        await self._handle_stream(websocket, first)

    async def _handle_stream(self, websocket, first) -> None:
        slot = self._acquire_slot()
        if slot is None:
            await websocket.send(json.dumps({"type": "error", "error": "server full"}))
            await websocket.close()
            return
        conn = _Conn(slot=slot, sample_rate=16000, queue=asyncio.Queue())
        with self._lock:
            self._conns[slot] = conn

        async def sender():
            while True:
                msg = await conn.queue.get()
                await websocket.send(json.dumps(msg))
                if msg.get("type") == "stopped":
                    return

        send_task = asyncio.create_task(sender())

        def process(message) -> None:
            if isinstance(message, (bytes, bytearray)):
                audio = np.frombuffer(message, np.float32)
                if conn.sample_rate != 16000:
                    from .audio.resample import resample_audio

                    audio = resample_audio(audio, conn.sample_rate, 16000)
                with self._lock, device_scope(self.device):
                    self.service.add_audio(slot, audio)
            else:
                msg = json.loads(message)
                if msg.get("type") == "start":
                    conn.sample_rate = int(msg.get("sample_rate", 16000))
                elif msg.get("type") == "stop":
                    with self._lock, device_scope(self.device):
                        self.service.close_slot(slot)
                    conn.stopping = True

        try:
            process(first)
            async for message in websocket:
                process(message)
            await asyncio.wait_for(send_task, timeout=30.0)
        except Exception:
            send_task.cancel()
        finally:
            if not send_task.done():
                send_task.cancel()
            with self._lock, device_scope(self.device):
                if self.service.slots[slot].active:
                    self.service.close_slot(slot)
            self._release_slot(slot)

    # -- lifecycle ----------------------------------------------------------------

    async def serve(self, ready: asyncio.Event | None = None) -> None:
        """Run until cancelled (asyncio entry point)."""
        import websockets

        self._loop = asyncio.get_running_loop()
        self._running = True
        self._update_thread = threading.Thread(target=self._update_loop, daemon=True)
        self._update_thread.start()
        try:
            async with websockets.serve(self._handle, self.host, self.port) as server:
                self.port = server.sockets[0].getsockname()[1] if server.sockets else self.port
                if ready is not None:
                    ready.set()
                await asyncio.Future()  # until cancelled
        except asyncio.CancelledError:
            pass
        finally:
            self._running = False
            if self._update_thread is not None:
                self._update_thread.join(timeout=10.0)


def _service_device(service) -> torch.device:
    """The device of a service, or of a sharded service's first cohort."""
    cohorts = getattr(service, "cohorts", None)
    return cohorts[0].device if cohorts else service.device


def make_server(argv=None) -> TranscriptionServer:
    """The server that ``main`` runs: random weights from
    ``torch.Generator().manual_seed(0)`` (not the JAX package's draws from
    ``PRNGKey(0)``) unless ``--weights`` names a streaming checkpoint."""
    import argparse

    from .core.config import STREAMING_ARCHS
    from .core.device import resolve_device
    from .core.tokenizer import BinTokenizer
    from .models import streaming as ms

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="tiny_streaming")
    p.add_argument("--weights", default=None, help="streaming checkpoint dir")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--streams", type=int, default=16)
    p.add_argument("--cohorts", type=int, default=1,
                   help="shard slots into K staggered cohorts; each update "
                   "tick runs one S/K-stream device program, so per-stream "
                   "update latency stays at the S/K level (streams update "
                   "every K ticks — scale --tick down accordingly)")
    p.add_argument("--tick", type=float, default=0.25,
                   help="device update cadence in seconds")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = STREAMING_ARCHS[args.model]
    if args.weights:
        from .weights import load_streaming_checkpoint

        params, cfg = load_streaming_checkpoint(args.weights, device=device)
    else:
        params = ms.init_params(cfg, torch.Generator().manual_seed(0), device)
    tok = BinTokenizer.from_file(args.tokenizer) if args.tokenizer else None
    if args.cohorts > 1:
        from .serving import ShardedStreamingService

        svc = ShardedStreamingService(
            params, cfg, tok, n_streams=args.streams, n_cohorts=args.cohorts,
            device=device,
        )
    else:
        svc = StreamingService(params, cfg, tok, n_streams=args.streams, device=device)
    return TranscriptionServer(
        svc, tick_seconds=args.tick, host=args.host, port=args.port
    )


def main(argv=None) -> None:  # pragma: no cover - CLI
    server = make_server(argv)
    print(f"warmup: {server.service.warmup():.1f}s; "
          f"serving ws://{server.host}:{server.port}")
    asyncio.run(server.serve())


if __name__ == "__main__":  # pragma: no cover
    main()
