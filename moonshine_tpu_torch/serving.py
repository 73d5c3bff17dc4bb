"""Multi-stream streaming service: N live streams on one card.

Counterpart of the JAX package's ``serving.py``: host-side orchestration
over ``models/streaming_batch.service_update_meta``.  Every update is one
batched pass over all slots: masked frontend ingest, windowed encode,
speculative verify and greedy continuation.  Optional voice-activity
detection runs the real-weight TinyVad batched over all slots in one call,
feeding per-slot hysteresis segmenters.

Flow per slot:
  add_audio() -> [VAD segmenter ->] current segment's pending samples
  update()    -> feed whole frames (cap per update), decode with the
                 previous hypothesis as speculative draft, emit
                 partial/final StreamEvents with per-update latency.

Segments are bounded by the VAD's force-split (15 s) or by the same cap
in always-voice mode (``vad=None``, the reference's vad_threshold=0
contract).

Where JAX dispatches an update asynchronously, a PyTorch update runs its
greedy loop on the host, reading the device once a step: ``update_begin``
returns once the device work is queued after the last of those reads, so
``update_end`` waits only for the last step's copy of the tokens.  A
snapshot holds the state's tensors as CPU copies (numpy has no bfloat16).
Each update records a ``service.update`` span in ``profiling``, opened by
``update_begin`` and closed by ``update_end``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from . import profiling
from .core.config import StreamingConfig
from .core.device import resolve_device
from .core.tokenizer import BinTokenizer
from .models import streaming_batch as sb

FRAME_LEN = 80
HOP = 512


@dataclass
class StreamEvent:
    slot: int
    segment_id: int
    text: str
    is_final: bool
    start_time: float
    end_time: float
    latency_ms: float  # wall time of the device update that produced this


@dataclass
class _PendingUpdate:
    """An update whose tokens have not been read yet (update_begin/update_end)."""

    out: object  # sb.ServiceUpdateOut
    span: profiling.Span  # the update's service.update span, closed by update_end
    is_final: np.ndarray
    decode_mask: np.ndarray
    draft: np.ndarray  # [S, draft_cap] the drafts the verify was given
    draft_len: np.ndarray


@dataclass
class _Slot:
    active: bool = False
    eos: bool = False  # end-of-stream: finalize every remaining segment
    segment_id: int = 0
    # Current segment feed state
    pending: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    fed_samples: int = 0
    seg_start_time: float = 0.0
    seg_final_queued: bool = False  # all segment audio known; flush + finalize
    needs_reset: bool = True
    # Host mirror of the device's stable-frame arithmetic (the exact
    # integer twin of service_update's n_new): update() runs as many
    # encoder passes as the backlog needs, one in steady state.
    feat_total: int = 0
    enc_emitted_host: int = 0
    # Hypothesis
    tokens: list = field(default_factory=list)
    last_text: str = ""
    # Always-voice bookkeeping
    stream_samples: int = 0
    # Audio not yet routed into a segment
    raw_buffer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    """The number of leading elements ``a`` and ``b`` share."""
    n = min(len(a), len(b))
    differ = np.flatnonzero(a[:n] != b[:n])
    return int(differ[0]) if len(differ) else n


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and device.index in (None, t.device.index)


def _model_on(model, device: torch.device):
    """``model`` itself when its tensors are on ``device``, else a copy there
    (so services on one device share one weight copy)."""
    if all(_on(p, device) for p in model.parameters()):
        return model
    return copy.deepcopy(model).to(device)


class StreamingService:
    """Batched streaming transcription over a fixed number of slots.

    ``device``: the device this service's weights, state and updates live
    on (CUDA unless named).  K services on K devices serve K*S streams with
    no collective on the hot path: each stream's state is private.
    """

    def __init__(
        self,
        params,  # a models.streaming.StreamingMoonshine
        cfg: StreamingConfig,
        tokenizer: BinTokenizer | None,
        n_streams: int,
        update_frames: int = 128,  # frames ingested per slot per update (0.64 s)
        mem_bucket: int = 2048,
        draft_cap: int = sb.DRAFT_CAP,
        max_tokens_per_second: float = 6.5,
        max_segment_seconds: float = 15.0,
        vad=None,  # models.vad.TinyVad or None (always-voice)
        vad_threshold: float = 0.5,
        compute_dtype: torch.dtype | None = None,  # e.g. torch.bfloat16
        kv_int8: bool = False,  # int8 KV caches with folded dequantization
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        if self.compute_dtype != torch.float32:
            params = sb.cast_params(params, self.compute_dtype)
        self.params = _model_on(params, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.S = n_streams
        self.F = update_frames
        self.mem_bucket = mem_bucket
        self.draft_cap = draft_cap
        self.kv_int8 = kv_int8
        # Verify-length buckets: the verify pass costs 1 + draft_len decoder
        # tokens per stream, and early in a segment the hypotheses are
        # short, so each update takes the smallest bucket covering its
        # longest draft (a power-of-2 ladder from 32).
        self.draft_buckets: list[int] = []
        b = 32
        while b < draft_cap:
            self.draft_buckets.append(b)
            b *= 2
        self.draft_buckets.append(draft_cap)
        # Memory-length ladder for the decode phases: their cross-attention
        # reads the first bucket columns of the cross caches.
        self.mem_buckets: list[int] = sorted({
            b for b in (1024, 2048, mem_bucket)
            if sb.ENC_STEP * 2 <= b <= mem_bucket
        } | {mem_bucket})
        self.max_tps = max_tokens_per_second
        self.max_segment_samples = int(max_segment_seconds * 16000)
        self.state = self._init_state()
        self.slots = [_Slot() for _ in range(n_streams)]
        self.vad = vad
        self.vad_threshold = vad_threshold
        if vad is not None:
            self._reset_vad()

    def _init_state(self) -> sb.BatchedStreamingState:
        return sb.init_batch_state(self.cfg, self.S, dtype=self.compute_dtype,
                                   mem_cap=self.mem_bucket, kv_int8=self.kv_int8,
                                   device=self.device)

    def _reset_vad(self) -> None:
        from .pipeline.vad_segmenter import VadSegmenter

        self._vad_state = self.vad.init_state(self.S)
        self._vad_probs: dict[int, np.ndarray] = {}
        self._segmenters = [VadSegmenter(self._prob_reader(i), threshold=self.vad_threshold)
                            for i in range(self.S)]
        for seg in self._segmenters:
            seg.start()
        self._seg_consumed = [0] * self.S

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- public API ---------------------------------------------------------

    def open_slot(self, slot: int) -> None:
        self.slots[slot] = _Slot(active=True)
        self.slots[slot].needs_reset = True

    def close_slot(self, slot: int) -> None:
        """Mark end-of-stream: every remaining segment (including audio still
        queued in raw_buffer behind an in-flight force-split) finalizes on
        subsequent updates."""
        s = self.slots[slot]
        if s.active:
            s.eos = True
            if self.vad is None:
                self._fill_segment(slot)
                if s.fed_samples > 0 or len(s.pending) > 0:
                    s.seg_final_queued = True
            else:
                self._segmenters[slot].stop()
                self._drain_segments(slot)
        s.active = False

    def add_audio(self, slot: int, audio: np.ndarray) -> None:
        s = self.slots[slot]
        if not s.active:
            raise ValueError(f"slot {slot} is not open")
        audio = np.asarray(audio, np.float32)
        if self.vad is None:
            self._ingest_always_voice(slot, audio)
        else:
            s.raw_buffer = np.concatenate([s.raw_buffer, audio])

    def update(self, decode_tick: bool = True) -> list[StreamEvent]:
        """One batched update of all slots; returns transcript events."""
        return self.update_end(self.update_begin(decode_tick=decode_tick))

    def update_begin(self, decode_tick: bool = True) -> _PendingUpdate:
        """Run this update's device work; return a handle for update_end.

        The greedy loop reads the device once a step, so this returns only
        after the last step has been queued (JAX's returns at dispatch).

        ``decode_tick=False`` runs an ingest-only update: frontend and
        windowed encode keep up with the incoming audio, the verify and
        greedy decode are skipped and no events come out (segment finals
        wait for the next decode update); the unit of ServiceGovernor's
        overload backoff.

        Opens the update's coarse ``service.update`` span, which
        ``update_end`` closes; with fine spans on, ``service.plan`` covers
        the slot loop, the mirror and the uploads.
        """
        sp = profiling.begin("service.update", streams=self.S, decode=int(decode_tick),
                             decoder_calls=0, read_ns=0, q8_launches=0, kv_write_launches=0)
        if self.vad is not None:
            self._run_vad_batched()

        plan = profiling.child("service.plan", sp)
        S, F = self.S, self.F
        chunk = np.zeros((S, F * FRAME_LEN), np.float32)
        n_frames = np.zeros(S, np.int32)
        reset = np.zeros(S, bool)
        is_final = np.zeros(S, bool)
        draft = np.full((S, self.draft_cap), self.cfg.eos_id, np.int32)
        draft_len = np.zeros(S, np.int32)
        budget = np.zeros(S, np.int32)
        decode_mask = np.zeros(S, bool)

        for i, s in enumerate(self.slots):
            if len(s.pending) == 0 and not s.seg_final_queued and s.fed_samples == 0:
                continue
            nf = min(len(s.pending) // FRAME_LEN, F)
            if s.needs_reset and (nf > 0 or s.seg_final_queued):
                reset[i] = True
                s.needs_reset = False
                s.tokens = []
                s.last_text = ""
                s.feat_total = 0
                s.enc_emitted_host = 0
            if nf > 0:
                chunk[i, : nf * FRAME_LEN] = s.pending[: nf * FRAME_LEN]
                s.pending = s.pending[nf * FRAME_LEN:]
                s.fed_samples += nf * FRAME_LEN
                s.feat_total += nf
                n_frames[i] = nf
            flushed = len(s.pending) < FRAME_LEN
            if s.seg_final_queued and flushed and decode_tick:
                is_final[i] = True
            if decode_tick and s.fed_samples > 0 and (nf > 0 or is_final[i]):
                decode_mask[i] = True
                dl = min(len(s.tokens), self.draft_cap)
                if dl:
                    draft[i, :dl] = s.tokens[:dl]
                draft_len[i] = dl
                budget[i] = min(int(self.max_tps * (s.fed_samples / 16000.0)) + 1,
                                self.cfg.max_seq_len - 2)

        # Exact host mirror of the device's stable-frame arithmetic: how
        # many ENC_STEP passes does the worst backlog need?  Steady state
        # needs one; prefill bursts and drains catch up with encode-only
        # calls.  The device applies the arithmetic to every stream each
        # pass, so the mirror does too.
        lookahead = self.cfg.total_lookahead
        passes = 1
        for i, s in enumerate(self.slots):
            la = 0 if is_final[i] else lookahead
            backlog = max(s.feat_total - la - s.enc_emitted_host, 0)
            passes = max(passes, -(-backlog // sb.ENC_STEP))

        def mirror_pass() -> None:
            for i, s in enumerate(self.slots):
                la = 0 if is_final[i] else lookahead
                stable = max(s.feat_total - la, 0)
                s.enc_emitted_host += min(max(stable - s.enc_emitted_host, 0), sb.ENC_STEP)

        # One-tensor control plane: rows (n_frames, reset, is_final,
        # draft_len, budget, decode_mask).
        def pack_meta(nf, rs):
            return np.stack([nf, rs.astype(np.int32), is_final.astype(np.int32), draft_len,
                             budget, decode_mask.astype(np.int32)]).astype(np.int32)

        # Smallest verify bucket covering this update's longest draft
        # (ingest-only updates carry no draft: the smallest bucket).
        max_dl = int(draft_len.max()) if (S and decode_tick) else 0
        cap = next(b for b in self.draft_buckets if b >= max_dl)
        # Smallest memory bucket covering every slot's segment: mem_len
        # never exceeds feat_total, so the host mirror bounds the decode's
        # cross-cache read exactly.
        max_mem = max((s2.feat_total for s2 in self.slots), default=0)
        dmb = next((b for b in self.mem_buckets if b >= max_mem), self.mem_bucket)
        # Inputs copied to the device once: the catch-up passes of a burst
        # reuse the same zero chunk and follow-up control plane.
        chunk_dev = self._upload(chunk)
        meta_dev = self._upload(pack_meta(n_frames, reset))
        if passes > 1:
            zeros_chunk_dev = self._upload(np.zeros_like(chunk))
            zeros_s = np.zeros(S, np.int32)
            meta_follow_dev = self._upload(pack_meta(zeros_s, zeros_s.astype(bool)))
            draft0_dev = self._upload(draft[:, : self.draft_buckets[0]])
        profiling.end(plan)
        sp.attrs.update(passes=passes, draft_bucket=cap, mem_bucket=dmb,
                        draft_tokens=int(draft_len.sum()))
        first = True
        for _ in range(passes - 1):  # encode-only catch-up calls
            out = sb.service_update_meta(
                self.params, self.cfg, self.state,
                chunk_dev if first else zeros_chunk_dev,
                meta_dev if first else meta_follow_dev,
                draft0_dev,
                mem_bucket=self.mem_bucket, draft_cap=self.draft_buckets[0],
                enc_passes=1, decode=False, span=sp,
            )
            self.state = out.state
            mirror_pass()
            first = False
        out = sb.service_update_meta(
            self.params, self.cfg, self.state,
            chunk_dev if first else zeros_chunk_dev,
            meta_dev if first else meta_follow_dev,
            self._upload(draft[:, :cap]),
            mem_bucket=self.mem_bucket, draft_cap=cap,
            enc_passes=1, decode=decode_tick,
            decode_mem_bucket=dmb if decode_tick else None, span=sp,
        )
        mirror_pass()
        self.state = out.state
        return _PendingUpdate(out=out, span=sp, is_final=is_final, decode_mask=decode_mask,
                              draft=draft, draft_len=draft_len)

    def update_end(self, pending: _PendingUpdate) -> list[StreamEvent]:
        """Read an update's tokens and turn them into events; closes the
        update's span (with fine spans on, ``service.finish`` covers this)
        with its ``accepted_tokens``: each slot's draft tokens that its new
        hypothesis begins with, which is the count the verify accepted."""
        out, sp = pending.out, pending.span
        is_final, decode_mask = pending.is_final, pending.decode_mask
        finish = profiling.child("service.finish", sp)
        t0 = time.perf_counter_ns()
        # One device-to-host copy fetches tokens || count.
        packed = out.packed.cpu().numpy()
        t1 = time.perf_counter_ns()
        sp.attrs["read_ns"] += t1 - t0
        profiling.record("service.read", finish, t0, t1)
        tokens, counts = packed[:, :-1], packed[:, -1]
        latency_ms = (t1 - sp.start_ns) / 1e6

        events: list[StreamEvent] = []
        accepted = 0
        for i, s in enumerate(self.slots):
            if not decode_mask[i]:
                continue
            new = tokens[i, : int(counts[i])]
            accepted += _common_prefix(pending.draft[i, : pending.draft_len[i]], new)
            toks = [int(t) for t in new]
            s.tokens = toks
            text = self.tokenizer.tokens_to_text(toks) if self.tokenizer else str(toks)
            final = bool(is_final[i])
            if final or text != s.last_text:
                events.append(StreamEvent(
                    slot=i, segment_id=s.segment_id, text=text, is_final=final,
                    start_time=s.seg_start_time,
                    end_time=s.seg_start_time + s.fed_samples / 16000.0,
                    latency_ms=latency_ms,
                ))
                s.last_text = text
            if final:
                self._finish_segment(i)
        profiling.end(finish)
        profiling.end(sp, accepted_tokens=accepted)
        return events

    def warmup(self) -> float:
        """Run every update variant once (the ingest-only and decode
        updates, each verify and memory bucket, the VAD's hop buckets) so
        that the first live updates pay no one-time cost (allocator growth,
        library handles).  Returns its wall seconds; the service is reset
        afterwards."""
        t0 = time.monotonic()
        for i in range(self.S):
            if not self.slots[i].active:
                self.open_slot(i)
        # 2F of audio + close: the flush update carries new frames AND the
        # lookahead release, so its backlog needs an encode-only catch-up
        # call: both variants (decode=False and =True) run.
        silence = np.zeros(2 * self.F * FRAME_LEN, np.float32)
        for i in range(self.S):
            self.add_audio(i, silence)
            self.close_slot(i)
        self.update()
        self.update()
        self.update()
        zeros_chunk = torch.zeros((self.S, self.F * FRAME_LEN), dtype=torch.float32,
                                  device=self.device)
        zeros_meta = torch.zeros((6, self.S), dtype=torch.int32, device=self.device)
        for cap in self.draft_buckets:
            for dmb in self.mem_buckets:
                out = sb.service_update_meta(
                    self.params, self.cfg, self.state, zeros_chunk, zeros_meta,
                    torch.full((self.S, cap), self.cfg.eos_id, dtype=torch.int32,
                               device=self.device),
                    mem_bucket=self.mem_bucket, draft_cap=cap, enc_passes=1, decode=True,
                    decode_mem_bucket=dmb,
                )
                self.state = out.state
        if self.vad is not None:
            # With VAD, silence produces no voiced segments, so the updates
            # above never ran the VAD's hop buckets or the encode-only
            # catch-up of a voiced prefill burst: run both.
            tick_hops = max(self.F * FRAME_LEN // HOP, 1)
            hb = 1
            while hb < tick_hops:
                hb *= 2
            state = self.vad.init_state(self.S)
            for h in sorted({hb, 2 * hb}):
                self.vad.predict_hops_masked(
                    torch.zeros((self.S, h, HOP), dtype=torch.float32, device=self.vad.device),
                    np.zeros(self.S, np.int32), state)
            out = sb.service_update_meta(
                self.params, self.cfg, self.state, zeros_chunk, zeros_meta,
                torch.full((self.S, self.draft_buckets[0]), self.cfg.eos_id, dtype=torch.int32,
                           device=self.device),
                mem_bucket=self.mem_bucket, draft_cap=self.draft_buckets[0], enc_passes=1,
                decode=False,
            )
            self.state = out.state
        # Reset everything after the warm pass.
        self.state = self._init_state()
        for i in range(self.S):
            self.slots[i] = _Slot(active=True)
        if self.vad is not None:
            self._reset_vad()
        return time.monotonic() - t0

    # -- failover snapshot/restore -------------------------------------------

    def snapshot(self) -> dict:
        """Snapshot of every live stream: the device state (frontend
        carries, memory, cross and self KV, cursors) as CPU copies, and
        each slot's host feed state.  Restoring it into a fresh service
        resumes mid-segment with identical transcripts.  VAD-mode services
        snapshot between segments only (the segmenter's hysteresis state is
        host-transient); always-voice mode snapshots anywhere.

        The copies keep every bit, bfloat16 included (numpy has no
        bfloat16), and are taken now: updates write the state in place.
        """
        if self.vad is not None:
            for i, s in enumerate(self.slots):
                if (s.fed_samples or len(s.pending) or len(s.raw_buffer)
                        or self._seg_consumed[i] < len(self._segmenters[i].segments)):
                    raise ValueError(
                        f"slot {i} mid-segment: VAD-mode snapshots require "
                        "quiescent slots (the segmenter's hysteresis state "
                        "is host-transient and is reset on restore)")
        return {
            "device_state": sb.BatchedStreamingState(*[
                None if x is None else x.detach().to("cpu", copy=True) for x in self.state]),
            "slots": copy.deepcopy(self.slots),
        }

    def restore(self, snap: dict) -> None:
        """Install a :meth:`snapshot` into this (same-config) service.

        Any prior state of this service is discarded, VAD machinery
        included: a warm standby that served other traffic must not leak
        its old segment audio into the restored streams.  The snapshot's
        tensors are copied again, so that updates (which write the state in
        place) leave the snapshot intact for a second restore."""
        if len(snap["slots"]) != self.S:
            raise ValueError(f"snapshot has {len(snap['slots'])} slots, service has {self.S}")
        self.state = sb.BatchedStreamingState(*[
            None if x is None else x.to(self.device, copy=True) for x in snap["device_state"]])
        self.slots = copy.deepcopy(snap["slots"])
        if self.vad is not None:
            self._reset_vad()

    # -- always-voice segmentation (reference vad_threshold=0 contract) -----

    def _ingest_always_voice(self, slot: int, audio: np.ndarray) -> None:
        s = self.slots[slot]
        s.raw_buffer = np.concatenate([s.raw_buffer, audio])
        self._fill_segment(slot)

    def _fill_segment(self, slot: int) -> None:
        """Route buffered raw audio into the current segment up to the
        force-split cap (always-voice mode)."""
        s = self.slots[slot]
        if s.seg_final_queued or len(s.raw_buffer) == 0:
            return
        if s.fed_samples == 0 and len(s.pending) == 0:
            s.seg_start_time = s.stream_samples / 16000.0
        room = self.max_segment_samples - (s.fed_samples + len(s.pending))
        take = min(len(s.raw_buffer), max(room, 0))
        s.pending = np.concatenate([s.pending, s.raw_buffer[:take]])
        s.stream_samples += take
        s.raw_buffer = s.raw_buffer[take:]
        if len(s.raw_buffer) > 0:  # segment full: force-split
            s.seg_final_queued = True
        elif s.eos and (s.fed_samples > 0 or len(s.pending) > 0):
            # Stream closed: nothing more is coming, flush this segment too.
            s.seg_final_queued = True

    def _finish_segment(self, slot: int) -> None:
        s = self.slots[slot]
        s.segment_id += 1
        s.fed_samples = 0
        s.seg_final_queued = False
        s.needs_reset = True
        s.tokens = []
        s.last_text = ""
        if self.vad is None:
            self._fill_segment(slot)

    # -- VAD path ------------------------------------------------------------

    def _prob_reader(self, slot: int):
        def fn(hops: np.ndarray) -> np.ndarray:
            probs = self._vad_probs.pop(slot)
            assert len(probs) == len(hops), (len(probs), len(hops))
            return probs

        return fn

    def _run_vad_batched(self) -> None:
        """One batched TinyVad call for all slots' new audio, then advance
        each slot's segmenter and pull out fresh segment samples."""
        counts = [len(self.slots[i].raw_buffer) // HOP for i in range(self.S)]
        H = max(counts, default=0)
        if H == 0:
            return
        # Bucket the hop axis to powers of two, as the JAX package does.
        Hb = 1
        while Hb < H:
            Hb *= 2
        hops = np.zeros((self.S, Hb, HOP), np.float32)
        for i, c in enumerate(counts):
            if c:
                hops[i, :c] = self.slots[i].raw_buffer[: c * HOP].reshape(c, HOP)
        probs, self._vad_state = self.vad.predict_hops_masked(
            torch.from_numpy(hops).to(self.vad.device), np.asarray(counts, np.int32),
            self._vad_state)
        probs = probs.cpu().numpy()
        for i, c in enumerate(counts):
            if c == 0:
                continue
            s = self.slots[i]
            audio = s.raw_buffer[: c * HOP]
            s.raw_buffer = s.raw_buffer[c * HOP:]
            self._vad_probs[i] = probs[i, :c]
            self._segmenters[i].process_audio(audio)
            s.stream_samples += len(audio)
            self._drain_segments(i)

    def _drain_segments(self, slot: int) -> None:
        """Move new/updated segmenter output into the slot's feed state."""
        s = self.slots[slot]
        segs = self._segmenters[slot].segments
        k = self._seg_consumed[slot]
        if k >= len(segs):
            return
        seg = segs[k]
        new_total = len(seg.audio_data)
        already = s.fed_samples + len(s.pending)
        if new_total > already:
            s.pending = np.concatenate([s.pending, seg.audio_data[already:new_total]])
            if already == 0:
                s.seg_start_time = seg.start_time
        if seg.is_complete:
            s.seg_final_queued = True
            self._seg_consumed[slot] += 1
            seg.clear_audio()


class ShardedStreamingService:
    """``n_streams`` live streams as ``n_cohorts`` staggered cohorts.

    One update's wall time grows with its stream count (the verify pass and
    the greedy continuation are per-stream serial token work), so the slots
    are split into K cohorts and :meth:`update` ticks one cohort a call:
    every stream keeps the S/K-stream update latency while the card serves
    all ``n_streams`` (the caller ticks cohorts round-robin at ``period /
    n_cohorts`` intervals).

    All cohorts share one weight copy per device (the model is cast once
    here; each cohort's own cast is then a no-op returning the same
    model); only the per-cohort KV state is distinct, so the memory cost
    equals one ``n_streams``-slot service.

    API mirrors :class:`StreamingService` with GLOBAL slot ids in
    [0, n_streams); cohort ``c`` owns ``[c*S/K, (c+1)*S/K)``.

    ``devices=``: cohort ``c`` lives on ``devices[c % len(devices)]`` (its
    weights, state and updates).  Streams never exchange state, so the hot
    path has no collective.  Without ``devices=`` every cohort runs on
    ``device`` (CUDA unless named).
    """

    def __init__(
        self,
        params,
        cfg: StreamingConfig,
        tokenizer: BinTokenizer | None,
        n_streams: int,
        n_cohorts: int = 2,
        compute_dtype: torch.dtype | None = None,
        devices=None,  # list of devices: cohort c -> devices[c % len]
        device: str | torch.device | None = None,
        **kw,
    ):
        if n_streams % n_cohorts != 0:
            raise ValueError(f"n_streams={n_streams} not divisible by n_cohorts={n_cohorts}")
        dtype = compute_dtype or torch.float32
        if dtype != torch.float32:
            # Cast once, so that the cohorts share one weight copy.
            params = sb.cast_params(params, dtype)
        self.S = n_streams
        self.K = n_cohorts
        self.per_cohort = n_streams // n_cohorts
        self.devices = [resolve_device(d) for d in devices] if devices is not None else None
        if self.devices:
            # One weight copy per distinct device.
            per_dev = {d: _model_on(params, d) for d in dict.fromkeys(self.devices)}
            cohort_dev = [self.devices[c % len(self.devices)] for c in range(n_cohorts)]
        else:
            dev = resolve_device(device)
            per_dev = {dev: _model_on(params, dev)}
            cohort_dev = [dev] * n_cohorts
        self.cohorts = [
            StreamingService(per_dev[cohort_dev[c]], cfg, tokenizer, self.per_cohort,
                             compute_dtype=dtype, device=cohort_dev[c], **kw)
            for c in range(n_cohorts)
        ]
        self._next = 0

    def _route(self, slot: int) -> tuple[StreamingService, int]:
        if not 0 <= slot < self.S:
            raise ValueError(f"slot {slot} out of range [0, {self.S})")
        return self.cohorts[slot // self.per_cohort], slot % self.per_cohort

    @property
    def slots(self) -> list[_Slot]:
        """Flat global-slot-indexed view over the cohorts' slot states."""
        return [s for svc in self.cohorts for s in svc.slots]

    def open_slot(self, slot: int) -> None:
        svc, local = self._route(slot)
        svc.open_slot(local)

    def close_slot(self, slot: int) -> None:
        svc, local = self._route(slot)
        svc.close_slot(local)

    def add_audio(self, slot: int, audio: np.ndarray) -> None:
        svc, local = self._route(slot)
        svc.add_audio(local, audio)

    def cohort_of(self, slot: int) -> int:
        return slot // self.per_cohort

    def update(self, cohort: int | None = None, decode_tick: bool = True) -> list[StreamEvent]:
        """Tick ONE cohort (round-robin unless ``cohort`` is given)."""
        c = self._next if cohort is None else cohort
        if cohort is None:
            self._next = (c + 1) % self.K
        base = c * self.per_cohort
        return [replace(e, slot=e.slot + base)
                for e in self.cohorts[c].update(decode_tick=decode_tick)]

    def update_all(self) -> list[StreamEvent]:
        """Tick every cohort once (one full update period)."""
        events: list[StreamEvent] = []
        for c in range(self.K):
            events.extend(self.update(cohort=c))
        return events

    def update_all_parallel(self, decode_tick: bool = True) -> list[StreamEvent]:
        """Tick every cohort once: each cohort's update_begin first, then
        every update_end.  With JAX's asynchronous dispatch the cohorts'
        programs overlap; here each update_begin runs its greedy loop to
        the end, so only the last copies of the tokens overlap.  Event
        order matches :meth:`update_all` (cohort-major)."""
        pendings = [svc.update_begin(decode_tick=decode_tick) for svc in self.cohorts]
        events: list[StreamEvent] = []
        for c, (svc, p) in enumerate(zip(self.cohorts, pendings)):
            base = c * self.per_cohort
            events.extend(replace(e, slot=e.slot + base) for e in svc.update_end(p))
        return events

    def update_live(self, live_slots) -> list[StreamEvent]:
        """Tick the next round-robin cohort that owns a slot in
        ``live_slots``; skip (and run no device work for) cohorts with no
        live slots.  Returns [] when none are live."""
        live = {self.cohort_of(s) for s in live_slots}
        for _ in range(self.K):
            c = self._next
            self._next = (c + 1) % self.K
            if c in live:
                return self.update(cohort=c)
        return []

    def warmup(self) -> float:
        return sum(svc.warmup() for svc in self.cohorts)

    def snapshot(self) -> dict:
        """Per-cohort :meth:`StreamingService.snapshot` bundle (plus the
        round-robin cursor so restored ticking resumes where it left off)."""
        return {"cohorts": [svc.snapshot() for svc in self.cohorts], "next_cohort": self._next}

    def restore(self, snap: dict) -> None:
        if len(snap["cohorts"]) != self.K:
            raise ValueError(f"snapshot has {len(snap['cohorts'])} cohorts, service has {self.K}")
        for svc, s in zip(self.cohorts, snap["cohorts"]):
            svc.restore(s)
        self._next = snap.get("next_cohort", 0) % self.K


class ServiceGovernor:
    """Service-tier overload policy: decode backoff + admission control.

    The reference handles an overloaded machine by stretching a stream's
    update interval up to 10x.  At the service tier the same policy is
    applied to the DECODE cadence: ingestion (frontend + windowed encode)
    must stay realtime, but the speculative-verify/greedy decode (the
    dominant per-update cost) can run every b-th period at the price of
    transcript latency.

    Protocol: call :meth:`decode_this_tick` once per update period and
    pass its answer as ``decode_tick`` to the service's update; report the
    observed tick wall time back via :meth:`record`.  The governor keeps an
    EWMA of decode-tick cost and picks the smallest backoff ``b`` such that
    the per-period budget covers one decode tick plus (b-1) ingest ticks:

        ingest_ewma + (decode_ewma - ingest_ewma) / b  <=  margin * budget

    b rises instantly under overload and decays one step per recovered
    period.  :meth:`admit` refuses new streams when even ``max_backoff``
    cannot fit the budget (shed offered load, never the live streams).
    """

    def __init__(
        self,
        update_period_s: float,
        n_cohorts: int = 1,
        max_backoff: int = 10,
        margin: float = 0.85,
        alpha: float = 0.25,
    ):
        if max_backoff < 1:
            raise ValueError("max_backoff must be >= 1")
        self.budget_ms = update_period_s * 1000.0 / max(n_cohorts, 1)
        self.max_backoff = max_backoff
        self.margin = margin
        self.alpha = alpha
        self.backoff = 1
        self._tick = 0
        self._decode_ewma: float | None = None
        self._ingest_ewma: float | None = None
        self._last_was_decode = True

    # -- per-period protocol -------------------------------------------------

    def decode_this_tick(self) -> bool:
        """True when this period's tick should decode (every b-th)."""
        decode = self._tick % self.backoff == 0
        self._tick += 1
        self._last_was_decode = decode
        return decode

    def record(self, wall_ms: float) -> None:
        """Report the wall time of the tick just executed; adapts b."""
        if self._last_was_decode:
            e = self._decode_ewma
            self._decode_ewma = wall_ms if e is None else e + self.alpha * (wall_ms - e)
        else:
            e = self._ingest_ewma
            self._ingest_ewma = wall_ms if e is None else e + self.alpha * (wall_ms - e)
        self.backoff = self._pick_backoff()

    # -- queries --------------------------------------------------------------

    def projected_tick_ms(self, b: int | None = None) -> float:
        """Average per-period cost at backoff ``b`` under current EWMAs."""
        b = self.backoff if b is None else b
        dec = self._decode_ewma
        if dec is None:
            return 0.0
        ing = self._ingest_ewma if self._ingest_ewma is not None else dec * 0.3
        ing = min(ing, dec)
        return ing + (dec - ing) / b

    def overloaded(self) -> bool:
        return self.projected_tick_ms(1) > self.margin * self.budget_ms

    def admit(self) -> bool:
        """False when even max_backoff cannot keep the service realtime:
        refuse NEW streams rather than degrade live ones further."""
        return self.projected_tick_ms(self.max_backoff) <= self.margin * self.budget_ms

    def _pick_backoff(self) -> int:
        if self._decode_ewma is None:
            return 1
        target = self.margin * self.budget_ms
        for b in range(1, self.max_backoff + 1):
            if self.projected_tick_ms(b) <= target:
                # Decay: recover at most one step per period.
                return min(b, max(self.backoff - 1, 1)) if b < self.backoff else b
        return self.max_backoff

    def stats(self) -> dict:
        return {
            "backoff": self.backoff,
            "decode_ewma_ms": self._decode_ewma,
            "ingest_ewma_ms": self._ingest_ewma,
            "budget_ms": self.budget_ms,
            "overloaded": self.overloaded(),
            "admitting": self.admit(),
        }
