"""Device choice for the port's entry points.

Every entry point runs on CUDA unless the caller names another device
(the tests pass ``device="cpu"``).  Asking for the default device on a
machine without CUDA raises: the port never falls back to the CPU on its
own.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the chosen device is CUDA and absent.

    On CUDA it also turns TF32 off for products and convolutions, so that a
    float32 model computes in full float32 as the JAX reference does
    (cuDNN otherwise runs float32 convolutions in TF32 by default).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "moonshine_tpu_torch runs on CUDA by default, but no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_scope(device: str | torch.device | None):
    """A context that makes ``device`` the current CUDA device of the
    calling thread (nothing for a CPU device).  Each thread has its own
    current device, so a thread that works for a model on ``cuda:1`` enters
    this first rather than relying on the thread that started it."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
