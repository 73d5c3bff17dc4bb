"""Train the Japanese kanji-reading neural tier from in-tree data.

Counterpart of the JAX package's ``train/ja_reader.py``, in PyTorch.  The
reference reads kanji with an ONNX LUW tokenizer-POS model plus a CDN
dictionary (reference: core/moonshine-tts/src/lang-specific/
japanese-tok-pos-onnx.h, japanese-onnx-g2p.cpp); what is in-tree is
the reference's own 100-line wiki corpus with full-pipeline IPA goldens,
and kana-anchored alignment over it (``tts/ja_align.py``) yields
(surface, reading) pairs.

This module distills those pairs — kanji/okurigana spans AND the
deterministic kana spans — into the small char->IPA transformer
(``tts/g2p_transformer.py``) with a kana+kanji input alphabet.  The result
is the lexicon's neural backstop (``JapaneseG2P(neural=...)``): unseen
kanji compounds get a composed reading instead of being dropped.

Honest-split protocol: train on lines 1..N (default 80), score on the
held-out remainder with ``eval/g2p_reference_agreement.py``.  The corpus
is read from ``ja_align.REF_JA_DIR`` (under ``$MOONSHINE_REFERENCE_ROOT``,
default ``~/reference``).  The batches are numpy draws from
``np.random.RandomState(seed)``, as JAX's are; ``init_params=`` takes given
initial weights (JAX's through ``weights.g2p_params_from_jax_numpy``).

Usage:
    python -m moonshine_tpu_torch.train.ja_reader --out ja_reader.safetensors
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from ..tts import ja_align
from ..tts import g2p_transformer as g2pt
from ..tts.g2p_transformer import G2PModel, G2PModelConfig, G2PTransformer
from .g2p import initial_weights, make_train_step, run_steps, train_state
from .step import freeze, warmup_cosine_decay_schedule

DEFAULT_CFG = G2PModelConfig(dim=128, layers=2, heads=4, max_word=10, max_ipa=32)
LR = 3e-3
WARMUP = 100


def build_ja_dataset(train_lines: int = 80):
    """-> (pairs [(surface, ipa)], readings dict) from the first
    *train_lines* corpus lines only (the held-out tail never leaks).

    Pairs mix the EM-harvested kanji/okurigana readings with the
    corpus's kana runs (whose kana-table IPA is exact supervision) so
    the model learns both the kanji readings and the deterministic kana
    map it must not disturb in mixed spans.
    """
    corpus = ja_align.load_corpus()[:train_lines]
    readings, _ = ja_align.em_harvest(corpus)
    pairs: Counter = Counter()
    for span, ipa in readings.items():
        if len(span) < DEFAULT_CFG.max_word - 1 and len(ipa) < DEFAULT_CFG.max_ipa - 1:
            pairs[(span, ipa)] += 3  # weight real kanji pairs up
    for (span, ipa), n in ja_align.kana_spans(corpus).items():
        if len(span) < DEFAULT_CFG.max_word - 1 and len(ipa) < DEFAULT_CFG.max_ipa - 1:
            pairs[(span, ipa)] += 1
    return list(pairs.elements()), readings


def train_ja_reader(
    train_lines: int = 80,
    cfg: G2PModelConfig = DEFAULT_CFG,
    steps: int = 1200,
    batch_size: int = 128,
    seed: int = 0,
    log_every: int = 0,
    init_params: G2PModel | None = None,
    device: str | torch.device | None = None,
) -> G2PTransformer:
    """Train and return the reading model (deterministic given args), from
    ``init_params`` if given (a copy), else from weights seeded with
    ``seed``, on ``device`` (CUDA unless named; ``init_params``' own device
    when given)."""
    data, _ = build_ja_dataset(train_lines)
    surfaces = [s for s, _ in data]
    ipas = [p for _, p in data]
    in_vocab = G2PTransformer.build_in_vocab(surfaces)
    out_vocab = G2PTransformer.build_out_vocab(ipas)
    model = initial_weights(init_params, lambda dev: g2pt.init_params(
        cfg, torch.Generator().manual_seed(seed), len(out_vocab), len(in_vocab) + 4, dev),
        device)
    reader = G2PTransformer(cfg, model, out_vocab, in_vocab,
                            device=next(model.parameters()).device)
    src = np.stack([reader.encode_src(s) for s in surfaces])
    tgt = np.stack([reader.encode_ipa(p) for p in ipas])

    sched = warmup_cosine_decay_schedule(0.0, LR, WARMUP, steps)
    rng = np.random.RandomState(seed)
    n = len(src)
    state = run_steps(make_train_step(sched), train_state(model, LR), cfg, (src, tgt),
                      lambda: rng.randint(0, n, size=min(batch_size, n)), steps, log_every)
    reader.params = freeze(state.params)
    return reader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-lines", type=int, default=80)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--out", default="ja_reader.safetensors")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    model = train_ja_reader(args.train_lines, steps=args.steps, log_every=200,
                            device=args.device)
    # training-fit diagnostic
    data, _ = build_ja_dataset(args.train_lines)
    uniq = sorted(set(data))
    preds = model.predict_batch([s for s, _ in uniq])
    acc = sum(p == ipa for p, (_, ipa) in zip(preds, uniq)) / len(uniq)
    print(f"fit exact-match on {len(uniq)} training spans: {acc:.2%}")
    model.save(args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
