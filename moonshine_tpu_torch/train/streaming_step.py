"""Teacher-forced training for the streaming model family, in PyTorch.

Counterpart of the JAX package's ``train/streaming_step.py``.  The loss runs
the real streaming forward, the stateful frontend (``frontend_step``), the
windowed re-encode (``encode_step`` over ENC_STEP blocks, final semantics:
every frame emitted) and the incremental adapter and cross K/V, then one
teacher-forced decoder pass, so the gradients flow through the code path
the streaming service runs.

JAX's ``jax.checkpoint`` of each stage becomes ``torch.utils.checkpoint``
(non-reentrant): a stage's activations are recomputed in the backward.
JAX's ``vmap`` over same-length clips becomes a loop whose per-clip losses
are averaged, the same mean.  A step updates the model in place through a
``torch.optim`` optimizer (``train.step.adam`` / ``adamw`` build optax's
defaults).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import StreamingConfig
from ..models import streaming as ms
from .step import trainable_parameters


def streaming_forward(model: ms.StreamingMoonshine, cfg: StreamingConfig, audio: torch.Tensor,
                      n_frames: int, remat: bool = True) -> ms.StreamingState:
    """Frontend + final-semantics encode over a whole utterance.

    audio: [n_frames * frame_len] float32 on the model's device (trimmed to
    a frame multiple: the host buffers sub-frame remainders and a final
    flush drops them).  Returns the state with memory and cross K/V filled.
    ``remat`` recomputes each stage in the backward.
    """
    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    state = ms.init_state(cfg, device=audio.device)
    state = run(ms.frontend_step, model, cfg, audio, state)
    for off in range(0, n_frames, ms.ENC_STEP):
        state = run(ms.encode_step, model, cfg, state, min(n_frames - off, ms.ENC_STEP))
    return state


def streaming_asr_loss(
    model: ms.StreamingMoonshine,
    cfg: StreamingConfig,
    audio: torch.Tensor,  # [n_frames * frame_len]
    tokens_in: torch.Tensor,  # [s] BOS-prefixed
    tokens_out: torch.Tensor,  # [s] EOS-suffixed targets
    token_mask: torch.Tensor,  # [s]
    n_frames: int,
    mem_bucket: int = 512,
) -> torch.Tensor:
    """Mean masked cross-entropy of one clip's teacher-forced decode."""
    state = ms.decoder_reset(streaming_forward(model, cfg, audio, n_frames))
    logits, _, _ = ms.decode_tokens(model, cfg, tokens_in, state, mem_bucket=mem_bucket)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens_out.long()[:, None])[:, 0]
    mask = token_mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _trainable(model) -> list[torch.nn.Parameter]:
    params = [p for _, p in trainable_parameters(model)]
    for p in params:
        p.requires_grad_(True)
    return params


def _example_tensors(example, device) -> tuple:
    return tuple(torch.as_tensor(np.asarray(x)).to(device) for x in example)


def make_overfit_step(cfg: StreamingConfig, optimizer: Callable, examples,
                      mem_bucket: int = 512):
    """A full-batch step over a fixed example list, the gradients of the
    clips (of any lengths) accumulated in order and averaged.

    examples: list of (audio [n * frame_len], tokens_in, tokens_out, mask).
    Returns ``step(model, opt_state=None) -> (model, opt_state, loss)``;
    ``opt_state`` is a torch optimizer over the model (``optimizer`` makes
    one on the first call)."""
    def step(model, opt_state=None):
        dev = model.decoder.embed.device
        params = _trainable(model)
        if opt_state is None:
            opt_state = optimizer(params)
        opt_state.zero_grad(set_to_none=True)
        total = 0.0
        with torch.enable_grad():
            for ex in examples:
                a, ti, to, m = _example_tensors(ex, dev)
                loss = streaming_asr_loss(model, cfg, a.float(), ti, to, m,
                                          len(a) // cfg.frame_len, mem_bucket)
                loss.backward()
                total += float(loss.detach())
        for p in params:
            if p.grad is not None:
                p.grad.div_(len(examples))
        opt_state.step()
        return model, opt_state, total / len(examples)

    return step


def make_batched_overfit_step(cfg: StreamingConfig, optimizer: Callable, examples,
                              mem_bucket: int = 512):
    """:func:`make_overfit_step` for same-length clips as one loss: tokens
    pad to one width and the step's loss is the mean of the clips' losses,
    as JAX's vmapped step takes it."""
    n_frames = len(examples[0][0]) // cfg.frame_len
    if not all(len(a) == n_frames * cfg.frame_len for a, *_ in examples):
        raise ValueError("the batched step needs clips of one length")
    width = max(len(ti) for _, ti, _, _ in examples)

    def pad(x):
        out = np.zeros((width,), np.int64)
        out[:len(x)] = np.asarray(x)
        return out

    audio = np.stack([np.asarray(a, np.float32) for a, *_ in examples])
    ti = np.stack([pad(t) for _, t, _, _ in examples])
    to = np.stack([pad(t) for _, _, t, _ in examples])
    mask = np.stack([pad(np.asarray(m, np.int64)) for _, _, _, m in examples]).astype(bool)

    def step(model, opt_state=None):
        dev = model.decoder.embed.device
        params = _trainable(model)
        if opt_state is None:
            opt_state = optimizer(params)
        opt_state.zero_grad(set_to_none=True)
        a, x, y, m = (torch.from_numpy(v).to(dev) for v in (audio, ti, to, mask))
        with torch.enable_grad():
            loss = torch.stack([
                streaming_asr_loss(model, cfg, a[i], x[i], y[i], m[i], n_frames, mem_bucket)
                for i in range(len(examples))]).mean()
            loss.backward()
        opt_state.step()
        return model, opt_state, loss.detach()

    return step
