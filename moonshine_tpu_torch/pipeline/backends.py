"""ASR backends: the model-facing seam of the transcription pipeline.

Counterpart of the JAX package's ``pipeline/backends.py`` for the offline
(non-streaming) model family.  ``OfflineBackend`` re-transcribes each
just-updated segment whole.  Audio is padded to exponential duration
buckets, as in the JAX package (there so that XLA compiles few shapes; here
it keeps the two packages' inputs, and so their outputs, the same).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from ..core.config import MoonshineArchConfig
from ..core.tokenizer import BinTokenizer
from ..decoding.greedy import greedy_decode
from ..models import moonshine as mm

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

    Runs on the device that holds ``model``.  With ``word_timestamps`` a
    final segment also gets per-word times from the decoder's
    cross-attention (``pipeline/alignment.py``).
    """

    def __init__(
        self,
        model: mm.Moonshine,
        cfg: MoonshineArchConfig,
        tokenizer: BinTokenizer,
        max_tokens_per_second: float = 6.5,
        min_bucket_seconds: float = 2.0,
        max_bucket_seconds: float = 64.0,
        word_timestamps: bool = False,
        kv_int8: bool = False,
    ):
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
        memory, mask = mm.encode(
            self.model, self.cfg, torch.from_numpy(padded)[None].to(self.device), lengths,
            attn_impl="auto")
        duration = n_real / INTERNAL_SAMPLE_RATE
        cap = max(int(duration * self.max_tokens_per_second), 1)
        max_tokens = max(int(n_bucket / INTERNAL_SAMPLE_RATE * self.max_tokens_per_second), 8)
        res = greedy_decode(self.model, self.cfg, memory, mask, max_tokens=max_tokens,
                            token_caps=torch.tensor([cap]), kv_int8=self.kv_int8)
        n = int(res.lengths[0])
        ids = res.tokens[0, :n].cpu().numpy()
        words = []
        if self.word_timestamps and is_final and n > 0:
            # Only a complete segment is aligned: an incomplete one is
            # transcribed whole again at its next update.
            words = self._align(memory, mask, ids, duration)
        return SegmentResult(self.tokenizer.tokens_to_text(ids), words)
