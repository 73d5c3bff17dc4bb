"""Multilingual eval harness (FLEURS-style per-language WER/CER).

Counterpart of the JAX package's ``eval/fleurs.py``, over the port's
``eval/librispeech.evaluate`` (greedy decode on the device that holds the
model).

Mirror of the reference's eval-model-accuracy.py (reference: scripts/
eval-model-accuracy.py — FLEURS per-language WER/CER table,
README.md:1159-1165).  Dataset layout: ``<root>/<lang>/`` directories of
audio+transcript pairs in the same formats ``eval.librispeech`` accepts;
CER is used for the space-free scripts (zh, ja, ...), WER elsewhere —
the reference's convention.
"""

from __future__ import annotations

import json
from pathlib import Path

from .librispeech import evaluate, iter_librispeech
from .wer import edit_distance

CER_LANGUAGES = {"zh", "ja", "th", "yue", "cmn"}


def corpus_cer(references: list[str], hypotheses: list[str]) -> float:
    errors = 0
    chars = 0
    for ref, hyp in zip(references, hypotheses):
        r = list(ref.replace(" ", "").lower())
        h = list(hyp.replace(" ", "").lower())
        errors += edit_distance(r, h)
        chars += len(r)
    return errors / max(chars, 1)


def evaluate_languages(
    make_model,  # lang -> (model, cfg, tokenizer); a models.moonshine.Moonshine
    dataset_root: str | Path,
    languages: list[str] | None = None,
    batch_size: int = 16,
    limit: int | None = None,
) -> dict:
    """Per-language metric table.

    ``make_model`` resolves the per-language model (the reference uses the
    Base multilingual arch for most languages, Tiny for ko).
    """
    root = Path(dataset_root)
    if languages is None:
        languages = sorted(
            d.name for d in root.iterdir() if d.is_dir()
        )
    table = {}
    for lang in languages:
        lang_dir = root / lang
        if not any(iter_librispeech(lang_dir, limit=1)):
            continue
        params, cfg, tokenizer = make_model(lang)
        out = evaluate(
            params, cfg, tokenizer, str(lang_dir),
            batch_size=batch_size, limit=limit, return_texts=True,
        )
        refs = out.pop("refs")
        hyps = out.pop("hyps")
        if lang.split("_")[0] in CER_LANGUAGES:
            out["metric"] = "cer"
            out["cer"] = corpus_cer(refs, hyps)
        else:
            out["metric"] = "wer"
        table[lang] = out
    return table


def main(argv=None) -> None:  # pragma: no cover - needs dataset
    import argparse

    import torch

    from ..core.config import ARCHS
    from ..core.device import resolve_device
    from ..core.tokenizer import BinTokenizer
    from ..models import moonshine as mm

    p = argparse.ArgumentParser()
    p.add_argument("dataset_root")
    p.add_argument("--arch", default="base")
    p.add_argument("--weights", default=None, help="an HF Moonshine .safetensors checkpoint")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = ARCHS[args.arch]
    tok = BinTokenizer.from_file(args.tokenizer)
    device = resolve_device(args.device)
    if args.weights:
        from ..weights import import_hf_moonshine

        model = import_hf_moonshine(args.weights, cfg, device=device)
    else:
        model = mm.init_params(cfg, torch.Generator().manual_seed(0), device)

    table = evaluate_languages(
        lambda lang: (model, cfg, tok), args.dataset_root, limit=args.limit
    )
    print(json.dumps(table, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
