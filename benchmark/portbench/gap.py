"""The comparison that decides ``correct`` for a served model.

For each sampled request the plain reference runs once over the start
token and the tokens the program served, and reads at every position how
far the served token's logit lies below the reference's best there (the
end-of-text token is the last served token where the program stopped
before its cap).  The number compared is the widest such gap.  It is valid
for greedy tokens, which are all this benchmark serves.

The control, the reference computed one precision below the
configuration's, is read the same way with the token that the lower
precision puts first in place of the served one (``control_gap``).
"""

from __future__ import annotations

import torch


def served_gap(ref_logits: torch.Tensor, targets: torch.Tensor) -> float:
    """Widest gap, over the rows of ``ref_logits`` [S, V], between the
    row's best logit and that of its target token."""
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(1, targets[:, None].long())[:, 0]
    return float((best - chosen).max()) if targets.numel() else 0.0


def not_best(ref_logits: torch.Tensor, targets: torch.Tensor, tie: float) -> int:
    """Served tokens that are not the reference's best at a position where
    its best leads the runner-up by more than ``tie`` (an exact count: a
    near-tie within rounding may go either way)."""
    if not targets.numel():
        return 0
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tie
    return int(((targets != ref_logits.argmax(dim=-1)) & clear).sum())


def control_gap(ref_logits: torch.Tensor, low_logits: torch.Tensor) -> float:
    """Widest gap of the tokens the lower precision puts first."""
    return served_gap(ref_logits, low_logits.argmax(dim=-1))


def forced_inputs(start: int, tokens: list[int], eos: int, stopped: bool):
    """(decoder input, targets): the start token and the served tokens,
    and the served tokens followed by end-of-text where the program
    stopped on it."""
    inputs = [start] + list(tokens)
    targets = list(tokens) + ([eos] if stopped else [])
    return inputs[:len(targets)], targets


def sample(rng, n_items: int, k: int, longest: int) -> list[int]:
    """``k`` indices drawn from ``rng`` out of ``n_items``, the index
    ``longest`` among them."""
    if n_items == 0:
        return []
    rest = [i for i in range(n_items) if i != longest]
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return sorted([longest] + [rest[int(i)] for i in picked])


def rel_rms(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of the difference over the RMS of the reference."""
    ref = ref.float()
    return float((ours.float() - ref).norm() / ref.norm().clamp(min=1e-30))


class Reservoir:
    """A uniform sample of ``k`` items, drawn from ``rng``, of a stream of
    finished requests, and the longest of them apart: ``offer`` decides on
    the host, and calls ``take()`` (which copies what the check needs)
    only for an item it keeps."""

    def __init__(self, rng, k: int):
        self.rng, self.k, self.seen = rng, k, 0
        self.items: list = []
        self.longest = None  # (length, key, value)

    def offer(self, key, length: int, take) -> None:
        value = None
        if self.longest is None or length > self.longest[0]:
            value = take()
            self.longest = (length, key, value)
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, take() if value is None else value))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = (key, take() if value is None else value)

    def sample(self) -> list:
        """(key, value) of the sample with the longest among it."""
        keys = {key for key, _ in self.items}
        extra = [] if self.longest is None or self.longest[1] in keys else [self.longest[1:]]
        return self.items + extra
