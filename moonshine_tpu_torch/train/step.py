"""Training step for the Moonshine family, in PyTorch.

Counterpart of the JAX package's ``train/step.py``: the teacher-forced ASR
loss and a train step, on one device or on a (data, model) mesh (data
parallelism over utterances, Megatron tensor parallelism over ``model``,
``parallel/sharding.py``).

Where JAX's ``optax`` optimizers are pure functions of an optimizer state,
the port's ``TrainState.opt_state`` is a ``torch.optim`` optimizer that
holds its moments and updates the parameters in place; ``adamw`` and
``adam`` build optax's defaults (optax's ``adamw`` decays by 1e-4, where
PyTorch's ``AdamW`` would take 1e-2).  The parameters are held with
``requires_grad=False`` for inference (``models/layers.py``); a train
state switches it on for every trainable parameter (all but the encoder's
pair-swapped rotary copies, which the forward derives from q and k while
training and which each step refreshes).

On a mesh the step computes what JAX's GSPMD program does: the loss is the
*global* masked mean (each ``data`` rank all-reduces the token count and
divides its own sum by it), the gradients are summed over ``data``, and
the replicated parameters' gradients are averaged over ``model``, so those
parameters stay bit-identical across the ranks of a model group.  AdamW's
moments live with their parameter's block.
"""

from __future__ import annotations

import copy
import functools
import inspect
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..core.config import MoonshineArchConfig
from ..models import moonshine as mm
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import batch_pspec, model_parallel, param_pspec, shard_params, shard_tensor

# The encoder's pair-swapped rotary copies of q and k: derived, not trained.
DERIVED = ("q_swapped", "k_swapped")


class Batch(NamedTuple):
    """One teacher-forced ASR batch (padded, masked)."""

    audio: torch.Tensor  # [B, N] float32
    audio_lengths: torch.Tensor  # [B] int
    tokens_in: torch.Tensor  # [B, S] int, BOS-prefixed
    tokens_out: torch.Tensor  # [B, S] int, EOS-suffixed targets
    token_mask: torch.Tensor  # [B, S] bool


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> Callable:
    """``optax.adamw(learning_rate)``: an optimizer factory over parameters."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def adam(learning_rate: float) -> Callable:
    """``optax.adam(learning_rate)``: an optimizer factory over parameters."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps)``: count -> learning rate, a linear warm-up
    over ``warmup_steps`` then a cosine decay to 0 at ``decay_steps``
    (which counts the warm-up).  optax computes in float32; so does this,
    in optax's order, with a correctly rounded cosine (XLA's differs from
    it by one float32 ulp at a few counts).  Like optax's optimizers, a
    step reads the schedule at the count of steps taken before it, so the
    first step of a warm-up from 0 updates nothing."""
    f32 = np.float32
    span = decay_steps - warmup_steps
    if warmup_steps <= 0 or span <= 0:
        raise ValueError(f"need 0 < warmup_steps < decay_steps, got {warmup_steps}, "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        x = f32(math.pi) * f32(min(count - warmup_steps, span)) / f32(span)
        return float(f32(peak_value) * (f32(0.5) * (f32(1) + f32(math.cos(float(x))))))

    return schedule


def optimizer_like(opt: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    """A fresh optimizer of ``opt``'s kind and settings over ``params``."""
    accepted = inspect.signature(type(opt).__init__).parameters
    return type(opt)(params, **{k: v for k, v in opt.defaults.items() if k in accepted})


def trainable_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(name, parameter) of every trained parameter: all float parameters
    but the derived rotary copies."""
    return [(n, p) for n, p in model.named_parameters()
            if p.is_floating_point() and not any(k in n.split(".") for k in DERIVED)]


def freeze(model: nn.Module) -> nn.Module:
    """Back to inference: ``requires_grad`` off on every parameter."""
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def _loss_terms(model: mm.Moonshine, cfg: MoonshineArchConfig, batch: Batch):
    """(sum of masked NLL, correct tokens, real tokens) of a batch."""
    memory, frame_mask = mm.encode(model, cfg, batch.audio, batch.audio_lengths,
                                   attn_impl="xla")
    dec = model.decoder
    b, s = batch.tokens_in.shape
    k_cross, v_cross = mm.compute_cross_kv(dec, cfg, memory)
    cache = mm.init_cache(cfg, b, s, k_cross, v_cross, frame_mask, dtype=memory.dtype)
    logits, _, _ = mm.decoder_apply(dec, cfg, batch.tokens_in, cache,
                                    token_mask=batch.token_mask)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = batch.tokens_out.long()
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.token_mask.float()
    correct = ((logits.argmax(-1) == targets) * mask).sum()
    return (nll * mask).sum(), correct, mask.sum()


def asr_loss(model: mm.Moonshine, cfg: MoonshineArchConfig,
             batch: Batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean masked cross-entropy of teacher-forced decoding, and its
    metrics (loss, token accuracy).  The encoder runs the split-head
    attention (``attn_impl="xla"``), as JAX's does: the encoder attention
    kernels have no backward."""
    nll, correct, count = _loss_terms(model, cfg, batch)
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    return loss, {"loss": loss.detach(), "token_accuracy": (correct / denom).detach()}


class TrainState(NamedTuple):
    params: Any  # the model, trained in place
    opt_state: Any  # a torch.optim optimizer over its trainable parameters
    step: int


def scheduled_step(state: TrainState, schedule: Callable[[int], float],
                   loss_fn: Callable[[nn.Module], torch.Tensor]) -> tuple[TrainState, torch.Tensor]:
    """One step of ``state``'s optimizer on ``loss_fn(model)`` at the
    learning rate ``schedule(state.step)``, as an optax transform over a
    schedule takes it; -> (the next state, the loss before the step)."""
    model, opt = state.params, state.opt_state
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn(model)
        loss.backward()
    for group in opt.param_groups:
        group["lr"] = schedule(state.step)
    opt.step()
    return TrainState(model, opt, state.step + 1), loss.detach()


def make_train_state(model: nn.Module, optimizer: Callable, copy_params: bool = True,
                     cfg: MoonshineArchConfig | None = None) -> TrainState:
    """A step-0 state over ``model`` (a copy unless ``copy_params`` is
    False: the step updates in place), its trainable parameters switched to
    ``requires_grad``.  ``cfg`` brings the rotary copies up to date first."""
    if copy_params:
        model = copy.deepcopy(model)
    if cfg is not None:
        mm.prepare_rotary_params(model, cfg, refresh=True)
    params = []
    for _, p in trainable_parameters(model):
        p.requires_grad_(True)
        params.append(p)
    return TrainState(model, optimizer(params), 0)


def init_train_state(cfg: MoonshineArchConfig, optimizer: Callable, generator: torch.Generator,
                     device: str | torch.device | None = None) -> TrainState:
    """Random weights from ``generator`` (``mm.init_params``) on ``device``
    (CUDA unless named), and a fresh optimizer."""
    return make_train_state(mm.init_params(cfg, generator, device), optimizer,
                            copy_params=False)


def state_pspecs(state: TrainState) -> TrainState:
    """The layouts of a TrainState: every parameter's (``param_pspec``),
    and each optimizer moment beside its parameter's; scalars replicate."""
    specs = {n: param_pspec(n, p.dim()) for n, p in state.params.named_parameters()}
    names = {id(p): n for n, p in state.params.named_parameters()}
    opt = {names[id(p)]: {k: specs[names[id(p)]] if torch.is_tensor(v) and v.dim() else ()
                          for k, v in st.items()}
           for p, st in state.opt_state.state.items()}
    return TrainState(specs, opt, ())


def batch_pspecs() -> Batch:
    return Batch(audio=batch_pspec(2), audio_lengths=batch_pspec(1), tokens_in=batch_pspec(2),
                 tokens_out=batch_pspec(2), token_mask=batch_pspec(2))


def shard_train_state(mesh, state: TrainState) -> TrainState:
    """This rank's share of ``state``: its parameter blocks
    (``shard_params``) and, beside each, the same blocks of the optimizer's
    moments, in a new optimizer of the same kind and settings."""
    tp = model_parallel(mesh)
    model = shard_params(mesh, state.params)
    old = dict(state.params.named_parameters())
    opt = state.opt_state
    new = optimizer_like(opt, [p for _, p in trainable_parameters(model)])
    for name, p in trainable_parameters(model):
        st = opt.state.get(old[name])
        if st:
            spec = param_pspec(name, p.dim())
            new.state[p] = {k: shard_tensor(name, v, spec, tp.rank, tp.size)
                            if torch.is_tensor(v) and v.dim() else
                            (v.clone() if torch.is_tensor(v) else v) for k, v in st.items()}
    return TrainState(model, new, state.step)


def _all_reduce_flat(tensors: list[torch.Tensor], group, divide: int = 1) -> None:
    """All-reduce ``tensors`` in one flat buffer, then divide by ``divide``."""
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat.div_(divide)
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


def _reduce_grads(model: nn.Module, mesh) -> None:
    """Gradients summed over ``data``; the replicated parameters' averaged
    over ``model``."""
    named = [(n, p) for n, p in trainable_parameters(model) if p.grad is not None]
    _all_reduce_flat([p.grad for _, p in named], mesh.get_group(DATA_AXIS))
    group = mesh.get_group(MODEL_AXIS)
    replicated = [p.grad for n, p in named if MODEL_AXIS not in param_pspec(n, p.dim())]
    _all_reduce_flat(replicated, group, dist.get_world_size(group))


def _mesh_loss(model, cfg: MoonshineArchConfig, batch: Batch, mesh):
    """The global masked mean from this ``data`` rank's rows: its own NLL
    sum over the token count of every rank, so that the gradients summed
    over ``data`` are the gradients of JAX's loss."""
    nll, correct, count = _loss_terms(model, cfg, batch)
    totals = torch.stack([nll.detach(), correct, count])
    dist.all_reduce(totals, group=mesh.get_group(DATA_AXIS))
    denom = torch.clamp(totals[2], min=1.0)
    return nll / denom, {"loss": totals[0] / denom, "token_accuracy": totals[1] / denom}


def make_train_step(cfg: MoonshineArchConfig, optimizer: Callable | None = None, mesh=None):
    """A train step ``step(state, batch) -> (state, metrics)``.  The
    optimizer is the state's own (``optimizer`` is taken for the JAX
    signature).  With a mesh, ``state`` is this rank's share
    (``shard_train_state``) and ``batch`` its ``data`` rows
    (``parallel.sharding.shard_batch``)."""
    del optimizer

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        model, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if mesh is None:
                loss, metrics = asr_loss(model, cfg, batch)
            else:
                loss, metrics = _mesh_loss(model, cfg, batch, mesh)
            loss.backward()
        if mesh is not None:
            _reduce_grads(model, mesh)
        opt.step()
        mm.prepare_rotary_params(model, cfg, refresh=True)
        return TrainState(model, opt, state.step + 1), metrics

    return step
