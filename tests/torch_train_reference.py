"""Helpers of the trainer tests (``tests/test_torch_*_train.py``): JAX
trees as numpy, the port's gradients in the JAX layout, and the
comparisons of gradients and trained parameters."""

from __future__ import annotations

import copy

import jax
import numpy as np
import torch

from moonshine_tpu_torch import weights

# The trained parameters after a short run, but the attention key biases.
PARAM_ATOL = 1e-5


def jax_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def grad_tree(model, to_numpy) -> dict:
    """The gradients of ``model``'s parameters in the JAX tree's layout."""
    holder = copy.deepcopy(model)
    for p, q in zip(holder.parameters(), model.parameters()):
        p.data = q.grad.detach().clone() if q.grad is not None else torch.zeros_like(q)
    return weights.flatten_tree(to_numpy(holder))


def assert_grads_close(ours: dict, ref: dict, rel: float) -> None:
    assert ours.keys() == ref.keys()
    for k, g in ref.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(ours[k] - g).max()) <= rel * scale, k


def key_bias_mask(name: str, shape, dim: int) -> np.ndarray:
    """True on the attention key biases (the k third of ``qkv/b``, the k
    half of ``x_kv/b``).  Softmax is invariant to them, so their exact
    gradient is 0 and each package's is rounding noise, which Adam scales to
    a step of up to lr of either sign."""
    mask = np.zeros(shape, bool)
    if name.endswith("/qkv/b"):
        mask[dim:2 * dim] = True
    elif name.endswith("/x_kv/b"):
        mask[:dim] = True
    return mask


def assert_params_close(ours: dict, ref: dict, dim: int, lr_sum: float,
                        atol: float = PARAM_ATOL) -> None:
    assert ours.keys() == ref.keys()
    for k, r in ref.items():
        d = np.abs(ours[k] - r)
        noise = key_bias_mask(k, r.shape, dim)
        assert float(d[~noise].max(initial=0)) <= atol, k
        assert float(d[noise].max(initial=0)) <= 2 * lr_sum, k
