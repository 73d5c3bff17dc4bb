"""TTS/G2P intelligibility: ASR-round-trip character error rate.

The reference's G2P quality metric (reference: README.md:705-727,
scripts/tts_g2p_intelligibility.py): synthesize a sentence set with the
TTS engine under test, transcribe the audio back with a reference ASR,
and report the corpus CER between the input text and the round-trip
transcript (en_us published number: 12.6 %, espeak baseline 9.8 %).

Engine and ASR are injected so the harness runs with any combination —
the in-repo TTS + a trained/imported Moonshine, or stubs in tests.  With
zero egress (no published TTS voices or ASR weights), the harness's
mechanics are validated by tests; a real number drops out the moment
checkpoints are present.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .wer import edit_distance, normalize

# A small pangram-flavored default set, mirroring the reference's short
# English sentence list style.
DEFAULT_SENTENCES = (
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore",
    "pack my box with five dozen liquor jugs",
    "how vexingly quick daft zebras jump",
    "the five boxing wizards jump quickly",
)


@dataclass
class IntelligibilityResult:
    cer: float
    per_sentence: list[tuple[str, str, float]]  # (ref, hyp, cer)

    def summary(self) -> str:
        return f"G2P intelligibility CER: {self.cer * 100:.1f}% over {len(self.per_sentence)} sentences"


def _chars(text: str) -> list[str]:
    return list(normalize(text).replace(" ", ""))


def evaluate(
    synthesize: Callable[[str], tuple[np.ndarray, int]],
    transcribe: Callable[[np.ndarray, int], str],
    sentences: Sequence[str] = DEFAULT_SENTENCES,
) -> IntelligibilityResult:
    """Round-trip each sentence: text -> TTS audio -> ASR -> CER.

    synthesize: text -> (waveform float32, sample_rate)
    transcribe: (waveform, sample_rate) -> text
    """
    rows = []
    total_edits = 0
    total_chars = 0
    for ref in sentences:
        wav, sr = synthesize(ref)
        hyp = transcribe(np.asarray(wav, np.float32), sr)
        r, h = _chars(ref), _chars(hyp)
        edits = edit_distance(r, h)
        total_edits += edits
        total_chars += max(len(r), 1)
        rows.append((ref, hyp, edits / max(len(r), 1)))
    return IntelligibilityResult(
        cer=total_edits / max(total_chars, 1), per_sentence=rows
    )


def main() -> None:  # pragma: no cover - needs real checkpoints
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--voice", default="af_default")
    p.add_argument("--language", default="en")
    p.add_argument("--asr-model", default="tiny")
    p.add_argument("--asr-weights", default=None)
    p.add_argument("--tokenizer", default=None)
    args = p.parse_args()

    from ..api import Transcriber
    from ..tts.facade import TextToSpeech

    tts = TextToSpeech(language=args.language).voice(args.voice).load()
    asr = Transcriber(
        model=args.asr_model, weights=args.asr_weights,
        tokenizer_path=args.tokenizer,
    ).load()

    def transcribe(wav: np.ndarray, sr: int) -> str:
        t = asr.transcribe(wav, sr)
        return " ".join(l.text or "" for l in t.lines)

    res = evaluate(tts.synthesize, transcribe)
    print(res.summary())
    for ref, hyp, cer in res.per_sentence:
        print(f"  {cer * 100:5.1f}%  {ref!r} -> {hyp!r}")


if __name__ == "__main__":  # pragma: no cover
    main()
