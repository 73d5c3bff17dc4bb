"""The port's beam-reorder gather (K3 ``gather_kv_rows``, K4
``gather_scale_rows``) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, and the CUDA kernel against its plain version on
the card.  A gather is a copy, so every comparison is exact.

On the card, without JAX:
    python -m pytest --noconftest tests/test_torch_beam_gather.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch.ops import beam_gather as bg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _parents(kind: str, n: int, seed: int) -> np.ndarray:
    """Source rows of a beam reorder: random parents with duplicates and
    drops (block-local per group of 4 beams, as beam search gives them),
    the identity, or the reverse."""
    if kind == "identity":
        return np.arange(n, dtype=np.int32)
    if kind == "reverse":
        return np.arange(n, dtype=np.int32)[::-1].copy()
    rng = np.random.default_rng(seed)
    k = 4 if n % 4 == 0 else 1
    return (np.arange(n) // k * k + rng.integers(0, k, n)).astype(np.int32)


def _arrays(shape, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return [rng.integers(-128, 128, shape, dtype=np.int8) for _ in range(2)]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _jax_ref(fn_name: str, a, b, idx, dtype: str):
    # JAX is imported here, not at the top, so that the card's tests run
    # where JAX is not installed.
    import jax.numpy as jnp

    from moonshine_tpu.ops import beam_gather as jbg

    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    ka, kb = getattr(jbg, fn_name)(jnp.asarray(a).astype(jt), jnp.asarray(b).astype(jt),
                                   jnp.asarray(idx), interpret=True)
    return np.asarray(ka.astype(jnp.float32)), np.asarray(kb.astype(jnp.float32))


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to({"float32": torch.float32, "bfloat16": torch.bfloat16,
                                   "int8": torch.int8}[dtype])


@pytest.mark.parametrize("kind", ["random", "identity", "reverse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_plain_matches_pallas(dtype, kind):
    shape = (3, 8, 4, 16, 24)  # [L, N, H, hd, S]
    a, b = _arrays(shape, dtype, seed=0)
    idx = _parents(kind, shape[1], seed=1)
    ref_a, ref_b = _jax_ref("gather_kv_rows", a, b, idx, dtype)
    out_a, out_b = bg.gather_kv_rows(_torch(a, dtype), _torch(b, dtype), torch.from_numpy(idx))
    assert out_a.dtype == _torch(a, dtype).dtype and out_a.shape == shape
    np.testing.assert_array_equal(out_a.float().numpy(), ref_a)
    np.testing.assert_array_equal(out_b.float().numpy(), ref_b)


@pytest.mark.parametrize("kind", ["random", "identity", "reverse"])
def test_scale_plain_matches_pallas(kind):
    shape = (2, 12, 4, 16)  # [L, N, H, S]
    a, b = _arrays(shape, "float32", seed=2)
    idx = _parents(kind, shape[1], seed=3)
    ref_a, ref_b = _jax_ref("gather_scale_rows", a, b, idx, "float32")
    out_a, out_b = bg.gather_scale_rows(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(idx).long())
    np.testing.assert_array_equal(out_a.numpy(), ref_a)
    np.testing.assert_array_equal(out_b.numpy(), ref_b)


def test_outputs_are_fresh_tensors():
    """The decoder writes the caches in place after the reorder, so an
    output must never share storage with an input, even for the identity."""
    a, b = (torch.zeros(2, 4, 1, 2, 3) for _ in range(2))
    out_a, out_b = bg.gather_kv_rows(a, b, torch.arange(4, dtype=torch.int32))
    out_a += 1
    out_b += 1
    assert a.abs().sum() == 0 and b.abs().sum() == 0


def test_cpu_path_leaves_launch_counters():
    a, b = (torch.zeros(2, 4, 1, 2, 3) for _ in range(2))
    sa, sb = (torch.zeros(2, 4, 1, 3) for _ in range(2))
    idx = torch.tensor([1, 1, 0, 3], dtype=torch.int32)
    before = (bg.gather_kv_rows.launches, bg.gather_scale_rows.launches)
    bg.gather_kv_rows(a, b, idx)
    bg.gather_scale_rows(sa, sb, idx)
    assert (bg.gather_kv_rows.launches, bg.gather_scale_rows.launches) == before


@pytest.mark.parametrize("bad", ["ndim", "shape", "dtype", "scale_dtype", "mixed_dtype",
                                 "idx_len", "idx_dtype", "idx_2d", "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    a, b = (torch.zeros(2, 4, 1, 2, 3) for _ in range(2))
    idx = torch.arange(4, dtype=torch.int32)
    fn = bg.gather_kv_rows
    if bad == "ndim":
        fn = bg.gather_scale_rows  # wants 4-D
    elif bad == "shape":
        b = torch.zeros(2, 4, 1, 2, 4)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "scale_dtype":  # the scales are float32 only
        fn = bg.gather_scale_rows
        a, b = (torch.zeros(2, 4, 1, 3, dtype=torch.bfloat16) for _ in range(2))
    elif bad == "mixed_dtype":
        b = b.to(torch.int8)
    elif bad == "idx_len":
        idx = torch.arange(3, dtype=torch.int32)
    elif bad == "idx_dtype":
        idx = idx.float()
    elif bad == "idx_2d":
        idx = idx[None]
    else:  # two devices: the meta device stands in for a card here
        idx = idx.to("meta")
    with pytest.raises((ValueError, TypeError)):
        fn(a, b, idx)


# Shapes on the card: the bench's beam shape (Base, 128 x beam 4, S=61),
# a float32 case, the scales, and rows whose byte count is not a multiple
# of 16 (the kernel's narrow-word path).
CUDA_CASES = [
    ("kv", (8, 512, 8, 52, 61), torch.int8),
    ("kv", (8, 512, 8, 52, 61), torch.bfloat16),
    ("kv", (8, 64, 8, 52, 61), torch.float32),
    ("kv", (2, 12, 3, 5, 7), torch.int8),
    ("kv", (2, 12, 3, 5, 7), torch.bfloat16),
    ("scale", (8, 512, 8, 61), torch.float32),
    ("scale", (2, 12, 3, 7), torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "identity", "reverse"])
@pytest.mark.parametrize("which,shape,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, which, shape, dtype, kind):
    g = torch.Generator().manual_seed(0)
    if dtype == torch.int8:
        a, b = (torch.randint(-128, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
    else:
        a, b = (torch.randn(shape, generator=g).to(dtype) for _ in range(2))
    a, b = a.to(cuda_device), b.to(cuda_device)
    idx = torch.from_numpy(_parents(kind, shape[1], seed=5)).to(cuda_device)
    fn = bg.gather_kv_rows if which == "kv" else bg.gather_scale_rows
    for ix in (idx, idx.long()):
        before = fn.launches
        out_a, out_b = fn(a, b, ix)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref_a, ref_b = bg._gather_rows_torch(a, b, ix)
        assert torch.equal(out_a, ref_a) and torch.equal(out_b, ref_b)
        assert out_a.data_ptr() != a.data_ptr()
