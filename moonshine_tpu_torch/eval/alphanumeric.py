"""Alphanumeric spelling-recognition eval.

Mirror of the reference's eval-alphanumeric.py (reference: scripts/
eval-alphanumeric.py against test-assets/alphanumeric/<class>/*.wav):
per-class accuracy of the ASR-text matcher, the spelling CNN, and their
fusion over a directory of labeled one-character clips.

A copy of the JAX package's ``eval/alphanumeric.py``, over the port's spelling models.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..audio.wav import load_wav
from ..pipeline.spelling import SpellingMatcher, fuse_default


def iter_clips(root: str | Path):
    """<root>/<class>/*.wav -> (class_label, audio) pairs."""
    root = Path(root)
    for class_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for wav in sorted(class_dir.glob("*.wav")):
            audio, sr = load_wav(str(wav))
            if sr != 16000:
                from ..audio.resample import resample_audio

                audio = resample_audio(audio, sr, 16000)
            yield class_dir.name, audio


def evaluate(
    clips_root: str | Path,
    transcribe_fn,  # audio -> ASR text
    predict_fn=None,  # audio -> SpellingPrediction (None = matcher only)
    class_to_char=None,  # label -> expected char; default: identity / word map
) -> dict:
    from ..models.spelling import CLASS_TO_CHAR

    matcher = SpellingMatcher()
    mapping = class_to_char or CLASS_TO_CHAR
    per_class: dict[str, dict] = {}
    correct = total = 0
    for label, audio in iter_clips(clips_root):
        expected = mapping.get(label, label)
        text = transcribe_fn(audio) or ""
        match = matcher.classify(text)
        prediction = predict_fn(audio) if predict_fn else None
        fused = fuse_default(text, match, prediction, matcher)
        got = fused.character if fused.is_character else None
        stats = per_class.setdefault(label, {"correct": 0, "total": 0})
        stats["total"] += 1
        total += 1
        if got is not None and got.lower() == expected.lower():
            stats["correct"] += 1
            correct += 1
    for stats in per_class.values():
        stats["accuracy"] = stats["correct"] / max(stats["total"], 1)
    return {
        "accuracy": correct / max(total, 1),
        "correct": correct,
        "total": total,
        "per_class": per_class,
    }


def evaluate_cnn(clips_root: str | Path, onnx_path: str, device=None) -> dict:
    """CNN-only accuracy with the real in-tree SpellingCNN weights
    (reference: micro/models/spelling_cnn_mel.onnx; published captured-set
    score 90.91% top-1 — micro/models/README.md)."""
    from ..models.spelling import SpellingOnnx

    model = SpellingOnnx.from_onnx(onnx_path, device=device)
    per_class: dict[str, dict] = {}
    confusions: dict[str, int] = {}
    correct = total = 0
    for label, audio in iter_clips(clips_root):
        pred = model.predict(audio)
        stats = per_class.setdefault(label, {"correct": 0, "total": 0})
        stats["total"] += 1
        total += 1
        if pred.raw_class == label:
            stats["correct"] += 1
            correct += 1
        else:
            key = f"{label}->{pred.raw_class}"
            confusions[key] = confusions.get(key, 0) + 1
    for stats in per_class.values():
        stats["accuracy"] = stats["correct"] / max(stats["total"], 1)
    return {
        "accuracy": correct / max(total, 1),
        "correct": correct,
        "total": total,
        "per_class": per_class,
        "confusions": dict(sorted(confusions.items(), key=lambda kv: -kv[1])),
    }


def main() -> None:  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("clips_root", help="directory of <class>/*.wav clips")
    p.add_argument("--onnx", required=True, help="SpellingCNN ONNX weights (CNN-only eval)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args()
    report = evaluate_cnn(args.clips_root, args.onnx, args.device)
    print(json.dumps({k: report[k] for k in ("accuracy", "correct", "total")}, indent=2))
    print(json.dumps(report["confusions"], indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
