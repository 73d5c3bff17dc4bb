"""ASR backends: the model-facing seam of the transcription pipeline.

Counterpart of the JAX package's ``pipeline/backends.py``.
``OfflineBackend`` (the non-streaming models: Moonshine, and Canary of
``models/canary.py``) re-transcribes each just-updated segment whole,
through the model's own ``encode`` and ``greedy_decode``.  Audio is padded
to exponential duration buckets, as in the JAX package (there so that XLA
compiles few shapes; here it keeps the two packages' inputs, and so their
outputs, the same).
``StreamingBackend`` (the streaming family) keeps one incremental state per
segment and feeds only new samples through it.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from .. import profiling
from ..core.config import MoonshineArchConfig, StreamingConfig
from ..core.tokenizer import BinTokenizer
from ..decoding.greedy import greedy_decode
from ..models import moonshine as mm
from ..models import streaming as ms
from ..models.canary import Canary, CanaryArchConfig

INTERNAL_SAMPLE_RATE = 16000


class SegmentResult(NamedTuple):
    """Output of one segment transcription pass."""

    text: str | None
    words: list  # list[TranscriptWord]; empty unless word timestamps ran


class AsrBackend(Protocol):
    def transcribe_segment(
        self, audio: np.ndarray, segment_id: int, is_final: bool
    ) -> SegmentResult:
        """Transcribe one VAD segment (16 kHz float32). May keep per-segment
        incremental state keyed by ``segment_id``."""
        ...

    def reset(self) -> None:
        ...


class OfflineBackend:
    """Whole-segment greedy transcription with duration bucketing.

    Runs on the device that holds ``model`` (a ``models.moonshine.Moonshine``
    or a ``models.canary.Canary``, with its configuration).  With
    ``word_timestamps`` a final segment of a Moonshine model also gets
    per-word times from the decoder's cross-attention
    (``pipeline/alignment.py``).
    """

    def __init__(
        self,
        model: mm.Moonshine | Canary,
        cfg: MoonshineArchConfig | CanaryArchConfig,
        tokenizer: BinTokenizer,
        max_tokens_per_second: float = 6.5,
        min_bucket_seconds: float = 2.0,
        max_bucket_seconds: float = 64.0,
        word_timestamps: bool = False,
        kv_int8: bool = False,
    ):
        if word_timestamps and isinstance(cfg, CanaryArchConfig):
            raise ValueError("word timestamps need the decoder's cross-attention weights, "
                             "which the Canary decoder does not return")
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_tokens_per_second = max_tokens_per_second
        self.min_bucket = min_bucket_seconds
        self.max_bucket = max_bucket_seconds
        self.word_timestamps = word_timestamps
        self.kv_int8 = kv_int8

    def reset(self) -> None:
        pass

    def _align(self, memory, mask, ids: np.ndarray, duration: float) -> list:
        """A second, teacher-forced decoder pass over ``[BOS] + ids`` that
        collects the cross-attention, then DTW (``alignment.align_words``)."""
        from .alignment import align_words

        dec = self.model.decoder
        seq = np.concatenate([[self.cfg.decoder_start_token_id], ids]).astype(np.int64)
        k_cross, v_cross = mm.compute_cross_kv(dec, self.cfg, memory)
        cache = mm.init_cache(self.cfg, 1, len(seq), k_cross, v_cross, mask)
        seq_t = torch.from_numpy(seq)[None].to(self.device)
        _, _, cross_w = mm.decoder_apply(dec, self.cfg, seq_t, cache,
                                         collect_cross_attention=True)
        # cross_w: [L, B, H, steps, frames] -> [L*H, steps, frames(valid)]
        w = cross_w[:, 0].cpu().numpy()
        n_frames = int(mask[0].sum())
        att = w.reshape(-1, w.shape[2], w.shape[3])[:, :, :n_frames]
        tokens = [int(seq[0])] + [int(t) for t in ids] + [self.cfg.eos_token_id]
        return align_words(att, tokens, duration / max(n_frames, 1), self.tokenizer)

    def _bucket_samples(self, n: int) -> int:
        seconds = max(n / INTERNAL_SAMPLE_RATE, 1e-3)
        bucket = self.min_bucket
        while bucket < seconds and bucket < self.max_bucket:
            bucket *= 2
        return int(min(bucket, self.max_bucket) * INTERNAL_SAMPLE_RATE)

    @torch.inference_mode()
    def transcribe_segment(
        self, audio: np.ndarray, segment_id: int, is_final: bool
    ) -> SegmentResult:
        del segment_id  # stateless: every pass redecodes fully
        audio = np.asarray(audio, np.float32)
        if audio.size < self.cfg.min_samples():
            return SegmentResult("", [])
        n_bucket = self._bucket_samples(audio.size)
        n_real = min(audio.size, n_bucket)
        padded = np.zeros(n_bucket, np.float32)
        padded[:n_real] = audio[:n_real]
        lengths = torch.tensor([n_real], device=self.device)
        # On CUDA the encode span ends once its kernels are enqueued; the
        # decode span's host read of the lengths waits for both.
        with profiling.span("backend.encode", bucket_samples=n_bucket) as sp:
            memory, mask = self.model.encode(
                self.cfg, torch.from_numpy(padded)[None].to(self.device), lengths,
                span_parent=sp)
            sp.enqueued = self.device.type == "cuda"
        duration = n_real / INTERNAL_SAMPLE_RATE
        cap = max(int(duration * self.max_tokens_per_second), 1)
        max_tokens = max(int(n_bucket / INTERNAL_SAMPLE_RATE * self.max_tokens_per_second), 8)
        with profiling.span("backend.decode", bucket_samples=n_bucket) as sp:
            res = greedy_decode(self.model, self.cfg, memory, mask, max_tokens=max_tokens,
                                token_caps=torch.tensor([cap]), kv_int8=self.kv_int8,
                                span_parent=sp)
            n = int(res.lengths[0])
        ids = res.tokens[0, :n].cpu().numpy()
        words = []
        if self.word_timestamps and is_final and n > 0:
            # Only a complete segment is aligned: an incomplete one is
            # transcribed whole again at its next update.
            words = self._align(memory, mask, ids, duration)
        return SegmentResult(self.tokenizer.tokens_to_text(ids), words)


class StreamingBackend:
    """Incremental transcription with the streaming model family.

    Per segment it keeps a ``StreamingState`` on the model's device, feeds
    only new samples through the stateful frontend, emits newly stable
    encoder frames, and re-decodes with the previous hypothesis as a
    speculative draft (``models.streaming.decode_full_fused``).
    """

    # Frame-count buckets for frontend chunks, the JAX package's (there so
    # that few programs compile); kept so that both packages see the same
    # chunks, and so the same features.
    _BUCKETS = [512, 400, 256, 200, 128, 100, 64, 50, 32, 25, 16, 8, 4, 2, 1]

    def __init__(
        self,
        model: ms.StreamingMoonshine,
        cfg: StreamingConfig,
        tokenizer: BinTokenizer,
        use_speculative_decoding: bool = True,
        max_tokens_per_second: float = 6.5,
        word_timestamps: bool = False,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.use_speculative = use_speculative_decoding
        self.max_tokens_per_second = max_tokens_per_second
        self.word_timestamps = word_timestamps
        self.reset()

    def reset(self) -> None:
        self._segment_id: int | None = None
        self._state = None
        self._samples_processed = 0
        self._last_tokens: list[int] = []
        self._last_text = ""
        # Host mirrors of the state's feat_count / enc_emitted cursors, as
        # in the JAX package (where the cursors live on the device): an
        # update needs no read of the state to know what is stable.
        self._feat_host = 0
        self._emitted_host = 0

    def _begin_segment(self, segment_id: int) -> None:
        self.reset()
        self._segment_id = segment_id
        self._state = ms.init_state(self.cfg, device=self.device)

    @torch.inference_mode()
    def transcribe_segment(
        self, audio: np.ndarray, segment_id: int, is_final: bool
    ) -> SegmentResult:
        if segment_id != self._segment_id:
            self._begin_segment(segment_id)
        result = self._transcribe(np.asarray(audio, np.float32), is_final)
        words = []
        if self.word_timestamps and is_final and self._last_tokens:
            words = self._align_streaming()
        return SegmentResult(result, words)

    def _transcribe(self, audio: np.ndarray, is_final: bool) -> str:
        cfg = self.cfg
        new = audio[self._samples_processed:]
        frame_len = cfg.frame_len
        n_frames = len(new) // frame_len
        if is_final and len(new) % frame_len and len(new) > 0:
            # Zero-pad the trailing partial frame on segment close.
            pad = frame_len - (len(new) % frame_len)
            new = np.concatenate([new, np.zeros(pad, np.float32)])
            n_frames = len(new) // frame_len
        # Respect the state's capacity (the VAD's force-split keeps real
        # segments far below it).
        n_frames = min(n_frames, ms.SEG_CAP - self._feat_host)

        offset = 0
        remaining = n_frames
        with profiling.span("backend.frontend", frames=n_frames) as sp:
            sp.enqueued = self.device.type == "cuda"
            samples = torch.from_numpy(np.ascontiguousarray(new[:n_frames * frame_len]))
            samples = samples.to(self.device)  # one copy per update
            for bucket in self._BUCKETS:
                while remaining >= bucket:
                    chunk = samples[offset:offset + bucket * frame_len]
                    self._state = ms.frontend_step(self.model, cfg, chunk, self._state)
                    offset += bucket * frame_len
                    remaining -= bucket
                    self._feat_host += bucket
        self._samples_processed += offset

        # Stable-frame arithmetic on the host mirrors.
        stable = self._feat_host if is_final else max(0, self._feat_host - cfg.total_lookahead)
        n_new = max(stable - self._emitted_host, 0)
        with profiling.span("backend.encode_step", frames=n_new) as sp:
            sp.enqueued = self.device.type == "cuda"
            emitted = 0
            while emitted < n_new:
                step = min(n_new - emitted, ms.ENC_STEP)
                self._state = ms.encode_step(self.model, cfg, self._state, step)
                emitted += step
            self._emitted_host += n_new
        if self._emitted_host == 0:
            return ""
        if n_new == 0 and not is_final and self._last_text:
            # Nothing newly stable: the previous hypothesis still holds.
            return self._last_text

        duration = self._samples_processed / INTERNAL_SAMPLE_RATE
        cap = min(max(int(duration * self.max_tokens_per_second), 1), cfg.max_seq_len - 2)
        draft = (self._last_tokens if self.use_speculative else [])[:cfg.max_seq_len]
        with profiling.span("backend.decode_full", draft=len(draft)):
            tokens, self._state = ms.decode_full_fused(
                self.model, cfg, self._state, draft, cap,
                mem_bucket=ms.mem_bucket_for(self._emitted_host))
        self._last_tokens = tokens
        self._last_text = self.tokenizer.tokens_to_text(tokens)
        return self._last_text

    def _align_streaming(self) -> list:
        """A teacher-forced pass over the final tokens that collects the
        cross-attention, then DTW (``alignment.align_words``)."""
        from .alignment import align_words

        cfg = self.cfg
        seq_list = [cfg.bos_id] + self._last_tokens
        seq = torch.tensor(seq_list, device=self.device)
        state = ms.decoder_reset(self._state)
        _, _, cross_w = ms.decode_tokens(self.model, cfg, seq, state, collect_attention=True)
        mem_len = self._emitted_host
        # [L, H, s, MEM_CAP] -> [L*H, steps, valid frames]
        w = cross_w.cpu().numpy()
        att = w.reshape(-1, w.shape[2], w.shape[3])[:, :, :mem_len]
        tokens = seq_list + [cfg.eos_id]
        duration = self._samples_processed / INTERNAL_SAMPLE_RATE
        return align_words(att, tokens, duration / max(mem_len, 1), self.tokenizer)
