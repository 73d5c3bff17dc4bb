"""G2P transformer training: distill a lexicon+rules engine into the
neural OOV helper, in PyTorch.

Counterpart of the JAX package's ``train/g2p.py``.  The reference ships
neural G2P helper models as ONNX artifacts trained offline (reference:
core/moonshine-tts/src/lang-specific/g2p-transformer-model.{h,cpp}).  The
in-repo equivalent trains the char->IPA transformer
(``tts/g2p_transformer.py``) against the language's own lexicon+rules
engine: lexicon entries provide the irregular forms, and the rules engine
labels any extra word list, so the network learns both and generalizes to
unseen words the way the reference's helper does.
``python -m moonshine_tpu_torch.train.g2p --language en --out en_oov.safetensors``

Word sources: the engine's lexicon keys, plus ``--wordlist`` files, plus
a built-in set of common English forms exercising the rule engine.

The batches are numpy draws from ``np.random.default_rng(seed)``, as
JAX's are, so both packages see the same batches from one seed.  The
initial weights come from a ``torch.Generator`` (``init_params=`` takes
given ones, e.g. JAX's through ``weights.g2p_params_from_jax_numpy``).
``optax.adamw`` over ``optax.warmup_cosine_decay_schedule`` becomes
``train.step.adamw`` (optax's decay, 1e-4) with the learning rate set from
``train.step.warmup_cosine_decay_schedule`` before each step.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..tts.g2p import _make_engine
from ..tts import g2p_transformer as g2pt
from ..tts.g2p_transformer import (
    PAD,
    G2PModel,
    G2PModelConfig,
    G2PTransformer,
    decoder_logits,
    encode,
    encode_word,
)
from .step import (
    TrainState,
    adamw,
    freeze,
    make_train_state,
    scheduled_step,
    warmup_cosine_decay_schedule,
)

# A compact generalization set: regular forms that exercise the English
# rule engine's pattern families (digraphs, vowel teams, magic-e, soft
# c/g, r-colored vowels).  Targets come from the engine, so this list is
# training *input* coverage, not pronunciation data.
_EN_RULE_WORDS = """
cat dog fish bird tree stone plate grape smile flute cube theme
chat chip shop ship thin thick that bath path moth cloth
rain paint play stay see keep team beach food moon book look cook
house mouse cloud shout now cow show snow boat coat road soap
coin join toy enjoy law saw cause autumn
car card start far for north corn her term first burn turn hurt
face race city cycle ice mice page gem giant magic
make take time line home bone tune mute note gate kite
back deck kick lock duck sock quick queen quiet
king ring song long bring think thank bank
jump just land hand stand plant print strong
batch catch match pitch watch fetch
knife knee knock wrote wrap wrist
dodge badge bridge judge fudge
nation station motion action section vision mission
nature picture future capture
able table little middle simple puzzle
happy funny silly berry carry penny
farmer winter summer corner number under
sister brother mister doctor actor mirror
window yellow pillow borrow narrow
train brain chain plain spain drain
sleep sweep green three wheel steel
dream clean speak treat cream steam
light fight sight tight bright flight
found round ground sound count mount
point voice noise choice avoid
burst church hurry purple turtle
"""


def build_dataset(
    language: str,
    extra_words=(),
    use_baked_dict: bool = True,
    exclude: frozenset[str] | set[str] = frozenset(),
):
    """-> (engine, [(word, ipa)]).

    Labels, in priority order: REAL pronunciations from the shipped
    10,855-word baked dictionary (tts/g2p_dict.py; English only — the
    reference's helpers train on CMUdict the same way), then the engine's
    lexicon+rules outputs for everything else.  With the dictionary
    present the English model trains mostly on real data rather than
    pure self-distillation.
    """
    engine = _make_engine(language)
    words = set(engine.lexicon)
    # English's dict-first engine keeps its irregulars in the baked
    # dictionary rather than a hand lexicon; seed from there.
    words.update(getattr(engine, "baked_dict", {}))
    real: dict[str, str] = {}
    if language.split("_")[0] == "en":
        words.update(_EN_RULE_WORDS.split())
        if use_baked_dict:
            from ..tts.g2p_dict import load_baked_dict

            real = load_baked_dict()
            if hasattr(engine, "baked_dict"):
                engine.baked_dict = real
    words.update(extra_words)
    pairs = []
    for w in sorted((words | set(real)) - set(exclude)):
        ipa = real.get(w) or engine.word_to_ipa(w)
        if ipa:
            pairs.append((w, ipa))
    return engine, pairs


def _loss_fn(model: G2PModel, cfg: G2PModelConfig, src: torch.Tensor, tgt_in: torch.Tensor,
             tgt_out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced cross-entropy, its mean over the ``mask``ed targets."""
    memory, mem_valid = encode(model, cfg, src)
    logits = decoder_logits(model, cfg, memory, mem_valid, tgt_in)
    ce = F.cross_entropy(logits.flatten(0, 1), tgt_out.flatten().long(),
                         reduction="none").view(tgt_out.shape)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(schedule):
    """``step(state, batch, cfg) -> (state, loss)``: one AdamW step of a
    ``TrainState`` (the model and its optimizer) on ``batch = (src, tgt)``
    ([B, max_word] and [B, max_ipa] ids on the model's device), at the
    learning rate ``schedule(state.step)``."""

    def step(state: TrainState, batch, cfg: G2PModelConfig):
        src, tgt = batch
        tgt_in, tgt_out = tgt[:, :-1], tgt[:, 1:]
        mask = (tgt_out != PAD).float()
        return scheduled_step(state, schedule,
                              lambda m: _loss_fn(m, cfg, src, tgt_in, tgt_out, mask))

    return step


def train_state(model: G2PModel, peak_lr: float) -> TrainState:
    """A step-0 state over ``model`` (trained in place) with optax's AdamW."""
    return make_train_state(model, adamw(peak_lr), copy_params=False)


def initial_weights(init_params: nn.Module | None, fresh, device) -> nn.Module:
    """A copy of ``init_params`` (on ``device`` if named, else on its own
    device), or ``fresh(device)`` when none is given."""
    if init_params is None:
        return fresh(device)
    dev = (resolve_device(device) if device is not None
           else next(init_params.parameters()).device)
    return copy.deepcopy(init_params).to(dev)


def run_steps(step, state: TrainState, cfg, data: tuple[np.ndarray, ...], draw, steps: int,
              log_every: int = 0) -> TrainState:
    """``steps`` calls of ``step(state, batch, cfg)``, each on the rows
    ``draw()`` picks (a numpy index array) of every array of ``data``.
    The data and every step's draw go to the model's device once, before
    the first step: a copy from pageable host memory would wait for the
    device each step."""
    dev = next(state.params.parameters()).device
    on_dev = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in data]
    rows = torch.from_numpy(np.asarray([draw() for _ in range(steps)])).to(dev)
    for i in range(steps):
        state, loss = step(state, tuple(a[rows[i]] for a in on_dev), cfg)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {float(loss):.4f}", flush=True)
    return state


def distill(
    language: str = "en",
    cfg: G2PModelConfig | None = None,
    steps: int = 2000,
    batch_size: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    extra_words=(),
    log_every: int = 0,
    limit: int | None = None,
    exclude: frozenset[str] | set[str] = frozenset(),
    init_params: G2PModel | None = None,
    device: str | torch.device | None = None,
) -> tuple[G2PTransformer, float]:
    """Train the OOV model on the engine's outputs, from ``init_params``
    if given (a copy), else from weights seeded with ``seed``, on
    ``device`` (CUDA unless named; ``init_params``' own device when given).

    Returns (model, exact-match accuracy over the training pairs) — the
    accuracy is the distillation fidelity, the number the reference's
    helper models report as "agreement with the dictionary".
    """
    cfg = cfg or G2PModelConfig()
    _, pairs = build_dataset(language, extra_words, exclude=exclude)
    if limit is not None:
        pairs = pairs[:limit]
    vocab = G2PTransformer.build_out_vocab(ipa for _, ipa in pairs)
    model = initial_weights(init_params, lambda dev: g2pt.init_params(
        cfg, torch.Generator().manual_seed(seed), len(vocab), device=dev), device)
    holder = G2PTransformer(cfg, model, vocab, device=next(model.parameters()).device)

    src = np.stack([encode_word(w, cfg.max_word) for w, _ in pairs])
    tgt = np.stack([holder.encode_ipa(ipa) for _, ipa in pairs])

    # Warmup + cosine decay: the late-training LR drop is what converts
    # "mostly right" into exact-match on the long irregular tail.
    sched = warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps)
    rng = np.random.default_rng(seed)
    n = len(pairs)
    state = run_steps(make_train_step(sched), train_state(model, lr), cfg, (src, tgt),
                      lambda: rng.integers(0, n, size=min(batch_size, n)), steps, log_every)
    holder.params = freeze(state.params)

    preds = []
    for i in range(0, n, 256):
        preds.extend(holder.predict_batch([w for w, _ in pairs[i : i + 256]]))
    acc = float(np.mean([p == ipa for p, (_, ipa) in zip(preds, pairs)]))
    return holder, acc


def main(argv=None):
    ap = argparse.ArgumentParser(description="Distill a G2P engine into the OOV transformer")
    ap.add_argument("--language", default="en")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--wordlist", action="append", default=[],
                    help="extra newline-separated word files labeled by the rules engine")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    extra = []
    for path in args.wordlist:
        with open(path, encoding="utf-8") as f:
            extra.extend(w.strip() for w in f if w.strip())
    cfg = G2PModelConfig(dim=args.dim, layers=args.layers)
    model, acc = distill(args.language, cfg, steps=args.steps, extra_words=extra, log_every=200,
                         device=args.device)
    model.save(args.out)
    print(f"saved {args.out}; distillation exact-match {acc:.2%}")


if __name__ == "__main__":
    main()
