"""Domain-customization finetuning: (wav, text) pairs -> adapted weights.

Counterpart of the JAX package's ``train/finetune.py``: the teacher-forced
ASR loss of ``train/step.py`` over the same data layouts the LibriSpeech
harness reads, on one device or on a (data, model) mesh, with batches
bucketed as the eval path buckets them.

    python -m moonshine_tpu_torch.train.finetune \\
        --data /path/to/wav+txt --model tiny --steps 200 \\
        --tokenizer tokenizer.bin --init hf_checkpoint_dir --out adapted.safetensors

Data layout: LibriSpeech (``*.trans.txt`` + flac/wav) or flat ``name.wav`` +
``name.txt`` pairs, anything ``eval.librispeech.iter_librispeech`` accepts.
The adapted model drops into ``Transcriber(...).with_params(...)`` or
exports to safetensors in the JAX package's layout.  Random initial
weights come from a ``torch.Generator`` seeded with ``seed``, so one seed
gives other weights than JAX's ``PRNGKey``; pass ``init_params`` to start
from given weights.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tokenizer import BinTokenizer


@dataclass
class FinetuneResult:
    params: object  # the adapted models.moonshine.Moonshine
    losses: list[float]
    steps: int
    examples: int


def _batches(cfg, examples, tokenizer, batch_size: int, device=None):
    """Yield train Batches on ``device``, lane-aligned-bucketed by audio
    length."""
    from ..eval.librispeech import _buckets
    from .step import Batch

    dev = resolve_device(device)
    utts = [((text,), audio) for audio, text in examples]
    for n, items in _buckets(cfg, utts, batch_size):
        b = len(items)
        toks = [tokenizer.text_to_tokens(u[0]) for u, _ in items]
        s_max = max(len(t) for t in toks) + 1
        audio = np.zeros((b, n), np.float32)
        lengths = np.zeros((b,), np.int64)
        for i, (_, a) in enumerate(items):
            k = min(len(a), n)
            audio[i, :k] = a[:k]
            lengths[i] = k
        tokens_in = np.stack([np.pad([cfg.decoder_start_token_id] + list(t),
                                     (0, s_max - len(t) - 1)) for t in toks])
        tokens_out = np.stack([np.pad(list(t) + [cfg.eos_token_id], (0, s_max - len(t) - 1))
                               for t in toks])
        mask = np.stack([np.arange(s_max) <= len(t) for t in toks])
        yield Batch(*(torch.from_numpy(np.asarray(x)).to(dev) for x in (
            audio, lengths, tokens_in.astype(np.int64), tokens_out.astype(np.int64), mask)))


def finetune(
    cfg,
    tokenizer: BinTokenizer,
    examples,  # iterable of (audio float32 @16k, text)
    init_params=None,  # adapt this model (e.g. an imported HF checkpoint);
    # None = train from random init (the overfit-test mode)
    steps: int = 200,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    mesh=None,  # a (data, model) DeviceMesh: this rank's share of the step
    seed: int = 0,
    log_every: int = 25,
    device: str | torch.device | None = None,
) -> FinetuneResult:
    """Adapt ``init_params`` (or a model seeded from ``seed``) to
    ``examples`` with AdamW (``train.step.adamw``) for ``steps`` steps,
    cycling over the buckets.  ``device`` defaults to ``init_params``'
    device, else CUDA.  The caller's model is not changed.  On a mesh the
    result is this rank's share of the model."""
    from ..models import moonshine as mm
    from ..parallel.sharding import shard_batch
    from . import step as ts

    examples = list(examples)
    if not examples:
        raise ValueError("no training examples")
    opt = ts.adamw(learning_rate)
    if init_params is None:
        model = mm.init_params(cfg, torch.Generator().manual_seed(seed), device)
        state = ts.make_train_state(model, opt, copy_params=False)
    else:
        state = ts.make_train_state(init_params, opt, cfg=cfg)
    dev = state.params.decoder.embed.device
    if mesh is not None:
        state = ts.shard_train_state(mesh, state)
    train_step = ts.make_train_step(cfg, opt, mesh)

    batches = list(_batches(cfg, examples, tokenizer, batch_size, dev))
    losses: list[float] = []
    i = 0
    while i < steps:
        for batch in batches:
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            state, metrics = train_step(state, batch)
            i += 1
            if i % log_every == 0 or i >= steps:
                losses.append(float(metrics["loss"]))
            if i >= steps:
                break
    return FinetuneResult(params=ts.freeze(state.params), losses=losses, steps=i,
                          examples=len(examples))


def main(argv=None) -> None:  # pragma: no cover - CLI
    import argparse

    from ..core.config import ARCHS
    from ..eval.librispeech import iter_librispeech
    from .checkpoint import export_safetensors

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="LibriSpeech-style dir")
    p.add_argument("--model", default="tiny")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--init", default=None,
                   help="HF checkpoint dir to adapt (default: random init)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default="adapted.safetensors")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    cfg = ARCHS[args.model]
    tok = BinTokenizer.from_file(args.tokenizer)
    init = None
    if args.init:
        from ..weights import import_hf_moonshine

        init = import_hf_moonshine(args.init, cfg, device=resolve_device(args.device))
    examples = ((u.load_audio(), u.text) for u in iter_librispeech(args.data, limit=args.limit))
    res = finetune(cfg, tok, examples, init_params=init, steps=args.steps,
                   batch_size=args.batch_size, learning_rate=args.lr, device=args.device)
    export_safetensors(args.out, res.params)
    print(json.dumps({
        "steps": res.steps, "examples": res.examples,
        "final_loss": res.losses[-1] if res.losses else None,
        "out": args.out,
    }))


if __name__ == "__main__":  # pragma: no cover
    main()
