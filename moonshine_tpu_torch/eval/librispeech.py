"""LibriSpeech WER + throughput harness, in PyTorch.

Counterpart of the JAX package's ``eval/librispeech.py`` (a mirror of the
reference's eval-librispeech.py: corpus WER with the Whisper normalizer
and VAD disabled, reference: scripts/eval-librispeech.py:87-155).
Utterances are bucketed by encoder frame count, padded, batched, and
decoded greedily or with beam search on the device that holds the model.
The JAX package's ``mesh=`` is not ported yet (ROADMAP.md queue 1, item
14.2): it shards the parameters (``shard_params``), which is weight tensor
parallelism, and the port's parallel layer (``parallel/``) splits only
the batch and the encoder attention's heads.

Dataset layout: standard LibriSpeech extraction
(``<root>/<split>/<spk>/<chap>/<spk>-<chap>-<utt>.flac`` + ``*.trans.txt``)
or any directory of ``.wav`` + ``.txt`` pairs.  FLAC decode uses
``soundfile`` when present; WAV needs nothing.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..audio.wav import load_wav
from .wer import corpus_wer


@dataclass
class Utterance:
    id: str
    audio_path: Path
    text: str

    def load_audio(self) -> np.ndarray:
        if self.audio_path.suffix == ".wav":
            audio, sr = load_wav(str(self.audio_path))
        else:
            import soundfile as sf  # optional dependency

            audio, sr = sf.read(str(self.audio_path), dtype="float32")
        if sr != 16000:
            from ..audio.resample import resample_audio

            audio = resample_audio(audio, sr, 16000)
        return np.asarray(audio, np.float32)


def iter_librispeech(root: str | Path, limit: int | None = None) -> Iterator[Utterance]:
    root = Path(root)
    count = 0
    for trans in sorted(root.rglob("*.trans.txt")):
        with open(trans) as f:
            for line in f:
                utt_id, _, text = line.strip().partition(" ")
                for ext in (".flac", ".wav"):
                    p = trans.parent / f"{utt_id}{ext}"
                    if p.exists():
                        yield Utterance(utt_id, p, text)
                        count += 1
                        break
                if limit and count >= limit:
                    return
    if count == 0:
        # wav+txt fallback layout
        for wav in sorted(root.rglob("*.wav")):
            txt = wav.with_suffix(".txt")
            if txt.exists():
                yield Utterance(wav.stem, wav, txt.read_text().strip())
                count += 1
                if limit and count >= limit:
                    return


def _buckets(cfg, utts, batch_size: int, max_frames: int = 1408):
    """Group utterances into frame buckets of 128-frame steps.

    Yields (n_samples, items) with n_samples the smallest sample count
    reaching the bucket's frame count: the JAX package's buckets, so that
    the two packages decode the same padded batches.
    """
    from ..models.moonshine import frames_for_samples, lane_aligned_samples

    ladder = list(range(128, max_frames + 1, 128))
    groups: dict[int, list] = {}
    for u, audio in utts:
        f = frames_for_samples(cfg, len(audio))
        b = next((b for b in ladder if f <= b), ladder[-1])
        groups.setdefault(b, []).append((u, audio))
    for b, items in sorted(groups.items()):
        n = lane_aligned_samples(cfg, 1)  # smallest 128-frame count
        # Scale to this bucket: smallest sample count with >= b frames.
        n = lane_aligned_samples(cfg, n + (b - 128) * _hop(cfg))
        for i in range(0, len(items), batch_size):
            yield n, items[i : i + batch_size]


def _hop(cfg) -> int:
    h = 1
    for s in cfg.conv_strides:
        h *= s
    return h


def evaluate(
    model,
    cfg,
    tokenizer,
    dataset_root: str,
    batch_size: int = 16,
    limit: int | None = None,
    beam_size: int = 1,
    return_texts: bool = False,
) -> dict:
    """Batched offline decode -> corpus WER + audio-seconds/s, on the
    device that holds ``model``."""
    from ..decoding.beam import beam_decode
    from ..decoding.greedy import greedy_decode
    from ..models import moonshine as mm

    device = next(model.parameters()).device
    utts = []
    for u in iter_librispeech(dataset_root, limit):
        utts.append((u, u.load_audio()))
    if not utts:
        raise FileNotFoundError(f"No utterances under {dataset_root}")

    refs, hyps = [], []
    audio_seconds = 0.0
    t0 = time.perf_counter()
    for n, items in _buckets(cfg, utts, batch_size):
        b = len(items)
        batch = np.zeros((b, n), np.float32)
        lengths = np.zeros((b,), np.int32)
        for i, (u, audio) in enumerate(items):
            k = min(len(audio), n)
            batch[i, :k] = audio[:k]
            lengths[i] = k
        with torch.inference_mode():
            # The JAX harness encodes with encode's default, the XLA
            # attention; the port's default is the packed kernel, so the
            # split-head path is named here to run the same program.
            memory, mask = mm.encode(model, cfg, torch.from_numpy(batch).to(device),
                                     torch.from_numpy(lengths).to(device), attn_impl="xla")
        caps = np.maximum((lengths / 16000 * cfg.max_tokens_per_second).astype(np.int32), 1)
        caps = torch.from_numpy(caps).to(device)
        max_tokens = max(int(n / 16000 * cfg.max_tokens_per_second), 8)
        if beam_size > 1:
            res = beam_decode(model, cfg, memory, mask, beam_size=beam_size,
                              max_tokens=max_tokens, token_caps=caps)
        else:
            res = greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens,
                                token_caps=caps)
        tokens = res.tokens.cpu().numpy()
        lengths_out = res.lengths.cpu().numpy()
        for i, (u, audio) in enumerate(items):
            ids = tokens[i, : lengths_out[i]]
            hyps.append(tokenizer.tokens_to_text(ids))
            refs.append(u.text)
            audio_seconds += len(audio) / 16000
    elapsed = time.perf_counter() - t0

    result = corpus_wer(refs, hyps)
    if return_texts:
        result["refs"] = refs
        result["hyps"] = hyps
    result["audio_seconds"] = audio_seconds
    result["wall_seconds"] = elapsed
    result["audio_seconds_per_second"] = audio_seconds / max(elapsed, 1e-9)
    result["beam_size"] = beam_size
    return result


def main(argv=None) -> None:  # pragma: no cover - needs dataset
    import argparse

    from ..core.config import ARCHS
    from ..core.device import resolve_device
    from ..core.tokenizer import BinTokenizer
    from ..models import moonshine as mm

    p = argparse.ArgumentParser()
    p.add_argument("dataset_root")
    p.add_argument("--arch", default="base")
    p.add_argument("--weights", default=None, help="an HF Moonshine .safetensors checkpoint")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    cfg = ARCHS[args.arch]
    tok = BinTokenizer.from_file(args.tokenizer)
    device = resolve_device(args.device)
    if args.weights:
        from ..weights import import_hf_moonshine

        model = import_hf_moonshine(args.weights, cfg, device=device)
    else:
        model = mm.init_params(cfg, torch.Generator().manual_seed(0), device)
    out = evaluate(
        model, cfg, tok, args.dataset_root,
        batch_size=args.batch, limit=args.limit, beam_size=args.beam,
    )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
