"""Train the zh/ja tokenizer-POS tagger on the reference's own corpora.

Counterpart of the JAX package's ``train/tok_pos.py``, in PyTorch.  The
reference's zh/ja text frontends run ONNX tokenizer-POS helpers
(chinese-tok-pos-onnx.h, japanese-tok-pos-onnx.h) whose CDN weights are
absent here; its shipped test corpora
(tests/data/{zh_hans,ja}/tok_pos_wiki*.txt) carry per-word UPOS
annotations from those very models — exact supervision for a distilled
in-repo tier.  The corpora are read under ``$MOONSHINE_REFERENCE_ROOT``
(default ``~/reference``), as ``tts/ja_align.REF_JA_DIR`` is.

Honest-split protocol: train on the first 80% of lines, report
word-boundary F1 / word+POS F1 on the held-out 20%.  The batches are numpy
draws from ``np.random.RandomState(seed)``, as JAX's are; ``init_params=``
takes given initial weights (JAX's through
``weights.tok_pos_params_from_jax_numpy``).

Usage:
    python -m moonshine_tpu_torch.train.tok_pos --lang zh
    python -m moonshine_tpu_torch.train.tok_pos --lang ja
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..tts import tok_pos as tpos
from ..tts.tok_pos import TokPosConfig, TokPosModel, TokPosTagger, forward
from .g2p import initial_weights, run_steps, train_state
from .step import TrainState, freeze, scheduled_step, warmup_cosine_decay_schedule

REF_DATA = Path(os.environ.get(
    "MOONSHINE_REFERENCE_ROOT",
    Path.home() / "reference")) / "core" / "moonshine-tts" / "tests" / "data"
CORPORA = {
    "zh": REF_DATA / "zh_hans" / "tok_pos_wiki_filtered.txt",
    "ja": REF_DATA / "ja" / "tok_pos_wiki_100.txt",
}
LR = 2e-3
WARMUP = 80


def load_corpus(lang: str):
    """-> [(source_text, [(surface, upos), ...])]"""
    rows = []
    for line in CORPORA[lang].read_text(encoding="utf-8").splitlines():
        toks = []
        for t in line.split(" "):
            if not t:
                continue
            surf, _, tag = t.rpartition("/")
            if surf:
                toks.append((surf, tag))
        if toks:
            rows.append(("".join(s for s, _ in toks), toks))
    return rows


def make_labels(rows, cfg: TokPosConfig, tagger: TokPosTagger):
    """-> (src [N, L], bio [N, L], pos [N, L], mask [N, L])"""
    tag_id = {t: i for i, t in enumerate(tagger.tags)}
    src = np.stack([tagger.encode(text) for text, _ in rows])
    bio = np.zeros_like(src)
    pos = np.zeros_like(src)
    mask = np.zeros(src.shape, np.float32)
    for r, (text, toks) in enumerate(rows):
        i = 0
        for surf, tag in toks:
            for j, _ in enumerate(surf):
                if i >= cfg.max_len:
                    break
                bio[r, i] = 1 if j == 0 else 0
                pos[r, i] = tag_id.get(tag, 0)
                mask[r, i] = 1.0
                i += 1
    return src, bio, pos, mask


def _loss(model: TokPosModel, cfg: TokPosConfig, batch) -> torch.Tensor:
    """Boundary plus UPOS cross-entropy, its mean over the masked chars."""
    src, bio, pos, mask = batch
    lb, lp = forward(model, cfg, src)
    ce_b = F.cross_entropy(lb.flatten(0, 1), bio.flatten().long(), reduction="none")
    ce_p = F.cross_entropy(lp.flatten(0, 1), pos.flatten().long(), reduction="none")
    return ((ce_b + ce_p).view(mask.shape) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(schedule):
    """``step(state, batch, cfg) -> (state, loss)``: one AdamW step of a
    ``TrainState`` on ``batch = (src, bio, pos, mask)`` at the learning
    rate ``schedule(state.step)``."""

    def step(state: TrainState, batch, cfg: TokPosConfig):
        return scheduled_step(state, schedule, lambda m: _loss(m, cfg, batch))

    return step


def train_tok_pos(lang: str, cfg: TokPosConfig = TokPosConfig(),
                  train_frac: float = 0.8, steps: int = 800,
                  batch_size: int = 16, seed: int = 0, log_every: int = 0,
                  init_params: TokPosModel | None = None,
                  device: str | torch.device | None = None):
    """-> (tagger trained on the first train_frac lines, train_rows,
    held_rows), from ``init_params`` if given (a copy), else from weights
    seeded with ``seed``, on ``device`` (CUDA unless named;
    ``init_params``' own device when given)."""
    rows = load_corpus(lang)
    n_train = int(len(rows) * train_frac)
    train_rows, held_rows = rows[:n_train], rows[n_train:]
    chars = sorted({c for text, _ in train_rows for c in text})
    tags = sorted({t for _, toks in train_rows for _, t in toks})
    model = initial_weights(init_params, lambda dev: tpos.init_params(
        cfg, torch.Generator().manual_seed(seed), len(chars) + 2, len(tags), dev), device)
    tagger = TokPosTagger(cfg, model, chars, tags, device=next(model.parameters()).device)
    data = make_labels(train_rows, cfg, tagger)

    sched = warmup_cosine_decay_schedule(0.0, LR, WARMUP, steps)
    rng = np.random.RandomState(seed)
    n = len(data[0])
    state = run_steps(make_train_step(sched), train_state(model, LR), cfg, data,
                      lambda: rng.randint(0, n, size=min(batch_size, n)), steps, log_every)
    tagger.params = freeze(state.params)
    return tagger, train_rows, held_rows


def word_f1(tagger: TokPosTagger, rows, with_pos: bool = False):
    """Word-span F1 vs the annotated tokens (span = (start, end[, tag]))."""
    tp = fp = fn = 0
    for text, toks in rows:
        gold = set()
        i = 0
        for surf, tag in toks:
            span = (i, i + len(surf), tag) if with_pos else (i, i + len(surf))
            if i + len(surf) <= tagger.cfg.max_len:
                gold.add(span)
            i += len(surf)
        pred = set()
        i = 0
        for surf, tag in tagger.annotate(text):
            span = (i, i + len(surf), tag) if with_pos else (i, i + len(surf))
            pred.add(span)
            i += len(surf)
        tp += len(gold & pred)
        fp += len(pred - gold)
        fn += len(gold - pred)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lang", choices=("zh", "ja"), default="zh")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    tagger, train_rows, held_rows = train_tok_pos(
        args.lang, steps=args.steps, log_every=100, device=args.device)
    f1_train = word_f1(tagger, train_rows)
    f1_seg = word_f1(tagger, held_rows)
    f1_pos = word_f1(tagger, held_rows, with_pos=True)
    print(f"{args.lang}: train-fit seg F1 {f1_train:.3f} | "
          f"held-out seg F1 {f1_seg:.3f} | held-out seg+UPOS F1 {f1_pos:.3f}")
    if args.out:
        tagger.save(args.out)
        print(f"saved {args.out}")


if __name__ == "__main__":
    main()
