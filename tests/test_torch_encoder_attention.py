"""The port's packed encoder attention against the JAX package's Pallas
kernel (run in interpret mode on the CPU), and the CUDA kernel against its
plain version on the card.

Tolerances: float32 atol 2e-5 / rtol 1e-4, as the JAX kernel tests use
(the two sides differ only in summation order); bf16 atol = rtol = 0.02,
one bf16 rounding step of outputs of order one, as the JAX bf16 test uses.
The CUDA kernel against the plain version, which round at the same points
and differ only in float32 summation order: bf16 atol 4e-3 / rtol 8e-3,
about one bf16 rounding step (as chip_smoke.py holds it).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.ops import encoder_attention as ea

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.02, rtol=0.02)
BF16_KERNEL = dict(atol=4e-3, rtol=8e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    q, kt, v = (rng.standard_normal(s).astype(np.float32)
                for s in ((b, t, h * hd), (b, h * hd, t), (b, t, h * hd)))
    return q, kt, v


def _run_both(q, kt, v, mask, heads, dtype):
    # JAX is imported here, not at the top, so that the card's tests run
    # where JAX is not installed:
    #   python -m pytest --noconftest tests/test_torch_encoder_attention.py -m cuda
    import jax.numpy as jnp

    from moonshine_tpu.ops.encoder_attention import encoder_attention_packed as jax_packed

    jt, tt = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jax_packed(*(jnp.asarray(x).astype(jt) for x in (q, kt, v)),
                     None if mask is None else jnp.asarray(mask), heads=heads, interpret=True)
    out = ea.encoder_attention_packed(
        *(torch.from_numpy(x).to(tt) for x in (q, kt, v)),
        None if mask is None else torch.from_numpy(mask), heads)
    assert out.dtype == tt and out.shape == q.shape
    return out.float().numpy(), np.array(ref, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_unmasked(dtype):
    q, kt, v = _inputs(0, 2, 31, 3, 20)  # odd T and hd
    out, ref = _run_both(q, kt, v, None, 3, dtype)
    np.testing.assert_allclose(out, ref, **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_masked(dtype):
    b, t = 3, 31
    q, kt, v = _inputs(1, b, t, 4, 20)
    mask = np.arange(t)[None, :] < np.array([t, 12, 1])[:, None]
    out, ref = _run_both(q, kt, v, mask, 4, dtype)
    # Every row is compared: padded query rows carry the same values in
    # both versions (they attend to the valid keys like any other row).
    np.testing.assert_allclose(out, ref, **(F32 if dtype == "float32" else BF16))


def test_plain_matches_pallas_row_without_valid_key():
    """A batch row with no valid key gets uniform weights (-1e9, not -inf,
    so no NaN): the output is the mean of its values, as on the TPU."""
    b, t = 2, 31
    q, kt, v = _inputs(2, b, t, 2, 20)
    mask = np.arange(t)[None, :] < np.array([7, 0])[:, None]
    out, ref = _run_both(q, kt, v, mask, 2, "float32")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape), **F32)


def test_cpu_path_leaves_launch_counter():
    q, kt, v = _inputs(3, 1, 9, 2, 8)
    before = ea.encoder_attention_packed.launches
    ea.encoder_attention_packed(*(torch.from_numpy(x) for x in (q, kt, v)), None, 2)
    assert ea.encoder_attention_packed.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "heads", "mask"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, kt, v = (torch.from_numpy(x) for x in _inputs(4, 2, 9, 2, 8))
    mask = torch.ones(2, 9, dtype=torch.bool)
    heads = 2
    if bad == "shape":
        kt = kt.transpose(1, 2)
    elif bad == "dtype":
        v = v.double()
    elif bad == "heads":
        heads = 3
    else:
        mask = mask.float()
    with pytest.raises((ValueError, TypeError)):
        ea.encoder_attention_packed(q, kt, v, mask, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", [(4, 384, 8, 52), (3, 415, 8, 52), (2, 97, 8, 36)])
def test_cuda_kernel_matches_plain(cuda_device, b, t, h, hd, dtype):
    """The CUDA kernel against the plain version on the same card tensors,
    masked with ragged lengths (one row with no valid key)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    q, kt, v = (torch.randn(s, generator=g).to(cuda_device, dtype)
                for s in ((b, t, h * hd), (b, h * hd, t), (b, t, h * hd)))
    lengths = torch.tensor([t] + [max(t // (i + 2), 1) for i in range(b - 2)] + [0])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(cuda_device)
    for m in (None, mask):
        before = ea.encoder_attention_packed.launches
        out = ea.encoder_attention_packed(q, kt, v, m, h)
        torch.cuda.synchronize()
        assert ea.encoder_attention_packed.launches == before + 1
        ref = ea._encoder_attention_packed_torch(q, kt, v, m, h)
        tol = F32 if dtype == torch.float32 else BF16_KERNEL
        torch.testing.assert_close(out.float(), ref.float(), **tol)


# -- K2: head-major attention (the Pallas _attn_kernel) ---------------------

def _run_both_hm(q, k, v, mask, dtype):
    import jax.numpy as jnp

    from moonshine_tpu.ops.encoder_attention import encoder_attention as jax_hm

    jt, tt = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jax_hm(*(jnp.asarray(x).astype(jt) for x in (q, k, v)),
                 None if mask is None else jnp.asarray(mask), interpret=True)
    out = ea.encoder_attention(*(torch.from_numpy(x).to(tt) for x in (q, k, v)),
                               None if mask is None else torch.from_numpy(mask))
    assert out.dtype == tt and out.shape == q.shape and out.is_contiguous()
    return out.float().numpy(), np.array(ref, np.float32)


def _hm_inputs(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, hd)).astype(np.float32) for _ in range(3))


# The cases of tests/test_encoder_attention.py: unaligned T and hd unmasked,
# masked with ragged lengths (one row of a single valid key), bf16 I/O.
@pytest.mark.parametrize("case", ["unmasked", "masked", "bf16"])
def test_plain_hm_matches_pallas(case):
    if case == "unmasked":
        q, k, v = _hm_inputs(0, 2, 37, 4, 20)
        out, ref = _run_both_hm(q, k, v, None, "float32")
    elif case == "masked":
        q, k, v = _hm_inputs(1, 3, 29, 2, 16)
        mask = np.arange(29)[None, :] < np.array([29, 11, 1])[:, None]
        out, ref = _run_both_hm(q, k, v, mask, "float32")
    else:
        q, k, v = _hm_inputs(2, 2, 33, 2, 24)
        out, ref = _run_both_hm(q, k, v, None, "bfloat16")
    np.testing.assert_allclose(out, ref, **(BF16 if case == "bf16" else F32))


def test_plain_hm_row_without_valid_key_and_f32_weights():
    """A row with no valid key is uniform; and K2 keeps the weights in
    float32, so in float32 it equals K1 on the same values (in bf16 the two
    differ by design: K1 rounds the weights)."""
    b, t, h, hd = 2, 31, 2, 20
    q, k, v = _hm_inputs(3, b, t, h, hd)
    mask = np.arange(t)[None, :] < np.array([7, 0])[:, None]
    out, ref = _run_both_hm(q, k, v, mask, "float32")
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape), **F32)
    packed = ea.encoder_attention_packed(
        torch.from_numpy(q.reshape(b, t, h * hd)),
        torch.from_numpy(k.reshape(b, t, h * hd)).transpose(1, 2).contiguous(),
        torch.from_numpy(v.reshape(b, t, h * hd)), torch.from_numpy(mask), h)
    np.testing.assert_allclose(out, packed.numpy().reshape(b, t, h, hd), **F32)


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank", "mask"])
def test_hm_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _hm_inputs(4, 2, 9, 2, 8))
    mask = torch.ones(2, 9, dtype=torch.bool)
    if bad == "shape":
        k = k.transpose(1, 2)
    elif bad == "dtype":
        v = v.double()
    elif bad == "rank":
        q, k, v = (x.flatten(2) for x in (q, k, v))
    else:
        mask = mask[:, :8]
    before = ea.encoder_attention.launches
    with pytest.raises((ValueError, TypeError)):
        ea.encoder_attention(q, k, v, mask)
    assert ea.encoder_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", [(4, 384, 8, 52), (3, 415, 8, 52), (2, 97, 8, 36),
                                      (4, 384, 4, 52)])
def test_cuda_hm_kernel_matches_plain(cuda_device, b, t, h, hd, dtype):
    """K2 against its plain version on the same card tensors, masked with
    ragged lengths (one row with no valid key) and unmasked; the last shape
    is one rank's share of a 4x2 mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((b, t, h, hd), generator=g).to(cuda_device, dtype) for _ in range(3))
    lengths = torch.tensor([t] + [max(t // (i + 2), 1) for i in range(b - 2)] + [0])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(cuda_device)
    for m in (None, mask):
        before = ea.encoder_attention.launches
        out = ea.encoder_attention(q, k, v, m)
        torch.cuda.synchronize()
        assert ea.encoder_attention.launches == before + 1
        ref = ea._encoder_attention_torch(q, k, v, m)
        tol = F32 if dtype == torch.float32 else BF16_KERNEL
        torch.testing.assert_close(out.float(), ref.float(), **tol)


# -- The longest T, and the kernels at the shapes of the port's paths -------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_frames_covers_the_longest_bucket(dtype):
    """The Transcriber's largest bucket (64 s) encodes to T frames within
    the kernels' limit, for Base and Tiny heads, in both I/O dtypes."""
    from moonshine_tpu_torch.core.config import BASE, TINY

    for cfg in (BASE, TINY):
        t = cfg.frames_for_samples(64 * 16000)
        assert t == 2665
        assert t <= ea.max_frames(cfg.head_dim, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["packed", "head_major"])
def test_wrapper_refuses_t_beyond_max_frames(kernel, dtype):
    """One frame past the limit raises ValueError before any launch, on
    every device; the limit itself is taken."""
    hd, h = 52, 1
    limit = ea.max_frames(hd, dtype)
    counter = ea.encoder_attention_packed if kernel == "packed" else ea.encoder_attention
    before = counter.launches
    for t in (limit, limit + 1):
        q, v = (torch.zeros(1, t, h * hd, dtype=dtype) for _ in range(2))
        if kernel == "packed":
            call = lambda: ea.encoder_attention_packed(q, q.transpose(1, 2).contiguous(), v, None, h)
        else:
            call = lambda: ea.encoder_attention(*(x.view(1, t, h, hd) for x in (q, q, v)), None)
        if t > limit:
            with pytest.raises(ValueError, match="exceeds"):
                call()
        else:
            assert call().shape[1] == t
    assert counter.launches == before


def _card_inputs(kernel, b, t, h, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if kernel == "packed":
        shapes = ((b, t, h * hd), (b, h * hd, t), (b, t, h * hd))
    else:
        shapes = ((b, t, h, hd),) * 3
    return tuple(torch.randn(s, generator=g).to("cuda", dtype) for s in shapes)


def _card_call(kernel, q, k, v, mask, h):
    if kernel == "packed":
        return ea.encoder_attention_packed(q, k, v, mask, h)
    return ea.encoder_attention(q, k, v, mask)


def _card_plain(kernel, q, k, v, mask, h):
    if kernel == "packed":
        return ea._encoder_attention_packed_torch(q, k, v, mask, h)
    return ea._encoder_attention_torch(q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["packed", "head_major"])
@pytest.mark.parametrize("b,t,h,hd", [(1, 83, 8, 52), (2, 415, 8, 52), (1, 665, 8, 52),
                                      (1, 2665, 8, 52), (2, 415, 8, 36)])
def test_cuda_kernels_at_path_shapes(cuda_device, kernel, b, t, h, hd, dtype):
    """K1 and K2 against their plain versions at odd T (kt rows 2-byte
    aligned), the Transcriber's buckets at B=1 (a segment shorter than its
    bucket) up to the 64 s one, and Tiny's hd=36; unmasked and masked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _card_inputs(kernel, b, t, h, hd, dtype, seed=t + hd)
    lengths = torch.tensor([t * 3 // 4] + [t // (i + 2) for i in range(b - 1)])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(cuda_device)
    for m in (None, mask):
        out = _card_call(kernel, q, k, v, m, h)
        torch.cuda.synchronize()
        ref = _card_plain(kernel, q, k, v, m, h)
        tol = F32 if dtype == torch.float32 else BF16_KERNEL
        torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["packed", "head_major"])
def test_cuda_row_without_valid_key(cuda_device, kernel, dtype):
    """A batch row with no valid key gets uniform weights on the card too:
    finite, and equal to its plain version."""
    b, t, h, hd = 2, 384, 8, 52
    q, k, v = _card_inputs(kernel, b, t, h, hd, dtype, seed=5)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 0])[:, None]).to(cuda_device)
    out = _card_call(kernel, q, k, v, mask, h)
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    ref = _card_plain(kernel, q, k, v, mask, h)
    tol = F32 if dtype == torch.float32 else BF16_KERNEL
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["packed", "head_major"])
def test_cuda_batch_independence(cuda_device, kernel, dtype):
    """Each batch row of a B=16 call equals that row run alone, bit for bit:
    a row's arithmetic does not depend on B or its place in the grid."""
    b, t, h, hd = 16, 384, 8, 52
    q, k, v = _card_inputs(kernel, b, t, h, hd, dtype, seed=6)
    lengths = torch.tensor([max(t - 23 * i, 0) for i in range(b)])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(cuda_device)
    out = _card_call(kernel, q, k, v, mask, h)
    for i in range(b):
        alone = _card_call(kernel, *(x[i:i + 1].contiguous() for x in (q, k, v)),
                           mask[i:i + 1].contiguous(), h)
        assert torch.equal(out[i:i + 1], alone), f"row {i} differs when run alone"
