"""G2P accuracy against real pronunciations (word accuracy + PER).

Counterpart of the JAX package's ``eval/g2p_accuracy.py``.  The reference
evaluates its G2P helpers as agreement with the source dictionary
(reference: micro/g2p/tools/build_g2p_dict.py filters CMUdict by
rule-engine disagreement; core helpers report dictionary agreement).  This
harness measures any word->IPA function against the shipped
10,855-entry real-pronunciation dictionary (tts/g2p_dict.py):

- **word accuracy**: exact IPA match (optionally ignoring stress marks,
  which the rule engines don't model);
- **PER**: phone error rate — Levenshtein distance over phone tokens /
  total reference phones, the standard G2P metric.

The ``oov`` predictor trains the port's OOV transformer
(``train.g2p.distill``) on ``--device`` (CUDA unless named).

Usage:
    python -m moonshine_tpu_torch.eval.g2p_accuracy --predictor rules
    python -m moonshine_tpu_torch.eval.g2p_accuracy --predictor oov --steps 6000
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterable

_STRESS = {"ˈ", "ˌ"}
# Multi-codepoint phone units (diphthongs/affricates the inventory treats
# as one phone); greedy longest-match tokenization.
_UNITS = ("aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "tʃ", "dʒ")


def phone_tokens(ipa: str, strip_stress: bool = True) -> list[str]:
    toks: list[str] = []
    i = 0
    while i < len(ipa):
        if ipa[i : i + 2] in _UNITS:
            toks.append(ipa[i : i + 2])
            i += 2
            continue
        c = ipa[i]
        i += 1
        if strip_stress and c in _STRESS:
            continue
        if not c.isspace():
            toks.append(c)
    return toks


def _edit_distance(a: list[str], b: list[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def evaluate(
    predict: Callable[[str], str],
    pairs: Iterable[tuple[str, str]],
    strip_stress: bool = True,
) -> dict:
    """-> {words, word_acc, per, errors: [(word, hyp, ref) worst-first]}."""
    n = 0
    exact = 0
    dist = 0
    total = 0
    errors: list[tuple[str, str, str]] = []
    for word, ref_ipa in pairs:
        hyp_ipa = predict(word) or ""
        ref = phone_tokens(ref_ipa, strip_stress)
        hyp = phone_tokens(hyp_ipa, strip_stress)
        d = _edit_distance(hyp, ref)
        n += 1
        exact += int(d == 0)
        dist += d
        total += len(ref)
        if d:
            errors.append((word, hyp_ipa, ref_ipa))
    return {
        "words": n,
        "word_acc": exact / max(n, 1),
        "per": dist / max(total, 1),
        "errors": errors,
    }


def rules_predictor(language: str = "en") -> Callable[[str], str]:
    """The bare lexicon+rules engine (no dict, no neural helper)."""
    from ..tts.g2p import _make_engine

    engine = _make_engine(language)
    return engine.word_to_ipa


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--predictor", choices=("rules", "oov"), default="rules")
    ap.add_argument("--language", default="en")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--steps", type=int, default=6000, help="oov training steps")
    ap.add_argument("--holdout", type=float, default=0.1,
                    help="oov: fraction of dict held out of training for the eval")
    ap.add_argument("--show-errors", type=int, default=10)
    ap.add_argument("--device", default=None, help="oov: torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..tts.g2p_dict import load_baked_dict

    full = sorted(load_baked_dict().items())
    if not full:
        print("baked dictionary not available")
        return 2
    if args.limit:
        full = full[: args.limit]

    if args.predictor == "rules":
        predict = rules_predictor(args.language)
        pairs = full
    else:
        # Train on a split, evaluate on the held-out words: measures
        # generalization to unseen real pronunciations, not memorization.
        import numpy as np

        from ..train.g2p import distill

        rng = np.random.default_rng(0)
        idx = rng.permutation(len(full))
        k = int(len(full) * args.holdout)
        held = [full[i] for i in idx[:k]]
        model, train_acc = distill(
            args.language, steps=args.steps,
            log_every=max(args.steps // 10, 1),
            exclude={w for w, _ in held}, device=args.device,
        )
        # Score only the held-out set (the model saw everything else).
        print(f"train exact-match {train_acc:.4f}; scoring {len(held)} held-out words")
        predict = model.predict
        pairs = held

    res = evaluate(predict, pairs)
    print(f"{args.predictor}: {res['words']} words  "
          f"word_acc {res['word_acc']:.4f}  PER {res['per']:.4f}")
    for word, hyp, ref in res["errors"][: args.show_errors]:
        print(f"  {word:20s} hyp {hyp:24s} ref {ref}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
