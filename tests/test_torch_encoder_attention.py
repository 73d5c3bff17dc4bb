"""The port's packed encoder attention against the JAX package's Pallas
kernel (run in interpret mode on the CPU), and the CUDA kernel against its
plain version on the card.

Tolerances: float32 atol 2e-5 / rtol 1e-4, as the JAX kernel tests use
(the two sides differ only in summation order); bf16 atol = rtol = 0.02,
one bf16 rounding step of outputs of order one, as the JAX bf16 test uses.
The CUDA kernel against the plain version, which round at the same points
and differ only in float32 summation order: bf16 atol 4e-3 / rtol 8e-3,
about one bf16 rounding step; float32 atol 2e-6 / rtol 1e-5 (as
chip_smoke.py holds them).  The float32 kernels form each product from bf16
parts of its operands (six passes); an emulation of that arithmetic is held
here against the plain versions at the same float32 tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch.ops import encoder_attention as ea

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.02, rtol=0.02)
BF16_KERNEL = dict(atol=4e-3, rtol=8e-3)
F32_KERNEL = dict(atol=2e-6, rtol=1e-5)


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
        tol = F32_KERNEL if dtype == torch.float32 else BF16_KERNEL
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
        tol = F32_KERNEL if dtype == torch.float32 else BF16_KERNEL
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
    every device; the limit itself passes the wrapper's checks, and runs
    where the plain version can hold its T x T logits (bf16's 3,136 frames;
    the float32 kernel's limit, 2^29 - 64, comes from the 32-bit int that
    holds a kt row's 4T bytes).  The operands are broadcast views, so no T allocates them."""
    hd, h = 52, 1
    limit = ea.max_frames(hd, dtype)
    if kernel == "packed":
        counter, check = ea.encoder_attention_packed, ea._check
    else:
        counter, check = ea.encoder_attention, ea._check_hm
    before = counter.launches
    for t in (limit, limit + 1):
        if kernel == "packed":
            q = torch.zeros(1, 1, h * hd, dtype=dtype).expand(1, t, h * hd)
            args = (q, q.transpose(1, 2), q, None, h)
        else:
            q = torch.zeros(1, 1, h, hd, dtype=dtype).expand(1, t, h, hd)
            args = (q, q, q, None)
        if t > limit:
            with pytest.raises(ValueError, match="exceeds"):
                counter(*args)
        else:
            check(*args)
            if t * t <= 2**24:
                assert counter(*args).shape[1] == t
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
@pytest.mark.parametrize("b,t,h,hd", [(1, 83, 8, 52), (2, 415, 8, 52), (2, 415, 8, 36)] + [
    (1, t, 8, 52) for t in (82, 165, 332, 665, 1332, 2665)])
def test_cuda_kernels_at_path_shapes(cuda_device, kernel, b, t, h, hd, dtype):
    """K1 and K2 against their plain versions at odd T (kt rows 2-byte
    aligned), every one of the Transcriber's buckets (2-64 s) at B=1 (a
    segment shorter than its bucket), and Tiny's hd=36; unmasked and masked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _card_inputs(kernel, b, t, h, hd, dtype, seed=t + hd)
    lengths = torch.tensor([t * 3 // 4] + [t // (i + 2) for i in range(b - 1)])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(cuda_device)
    for m in (None, mask):
        out = _card_call(kernel, q, k, v, m, h)
        torch.cuda.synchronize()
        ref = _card_plain(kernel, q, k, v, m, h)
        tol = F32_KERNEL if dtype == torch.float32 else BF16_KERNEL
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
    tol = F32_KERNEL if dtype == torch.float32 else BF16_KERNEL
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


# -- The float32 kernels' arithmetic, emulated step by step ------------------
#
# encoder_attention_f32_kernel in plain torch: both products as six bf16
# passes per 16-wide k-step (mma_f32x6), the statistics pass's running max
# and rescaled sum per lane of a row (four lanes, combined as
# combine_stats does), the weights exp(l - max) / sum, and P.V summed per
# 64-key tile and the tiles added in float32.  Only the tensor cores'
# own accumulation order inside one pass is torch's here.

_TILE = 64  # keys per tile of the kernel's ring
_PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))  # parts (a, b), smallest first


def _split3(x: torch.Tensor):
    """float32 x as bf16 hi, mid, lo (held in float32): x - hi and
    x - hi - mid are exact, so hi + mid + lo is x to about 2^-27 |x|."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


def _six_pass_steps(acc, a_parts, b_parts, k0, k1, passes=_PASSES):
    """acc + a[:, k0:k1] @ b[k0:k1] as the kernel forms it: for each 16-wide
    k-step, six passes of part products (lo.hi, hi.lo, mid.mid, mid.hi,
    hi.mid, hi.hi; each exact in float32) into the one accumulator."""
    for s in range(k0, k1, 16):
        for pa, pb in passes:
            acc = acc + a_parts[pa][:, s:s + 16] @ b_parts[pb][s:s + 16]
    return acc


def _row_stats(logits: torch.Tensor):
    """Each row's max and sum of exp(l - max) as the statistics pass takes
    them from logits [R, n*64] (-inf past T): lane qd of a row holds keys
    n*8 + 2*qd + e of every tile and keeps a running max over the tiles,
    rescaling its sum when the max grows; then lanes 1 apart and 2 apart
    combine their (max, sum) pairs."""
    r = logits.shape[0]
    lanes = logits.view(r, -1, 8, 4, 2).permute(0, 3, 1, 2, 4).reshape(r, 4, -1, 16)
    m, s = torch.full((r, 4), -float("inf")), torch.zeros(r, 4)
    for j in range(lanes.shape[2]):
        x = lanes[:, :, j]
        xm = x.amax(-1)
        grow = xm > m
        s = torch.where(grow, s * torch.exp(m - xm), s)
        m = torch.where(grow, xm, m)
        for e in range(16):
            s = s + torch.where(x[..., e] > -float("inf"), torch.exp(x[..., e] - m), 0.0)
    for step in (1, 2):
        other = [lane ^ step for lane in range(4)]
        mo, so = m[:, other], s[:, other]
        mm = torch.maximum(m, mo)
        s = (torch.where(m == mm, s, s * torch.exp(m - mm))
             + torch.where(mo == mm, so, so * torch.exp(mo - mm)))
        m = mm
    return m[:, :1], s[:, :1]


def _attention_f32_kernel(q, k, v, mask, passes=_PASSES):
    """One head of the float32 kernel, emulated: q, k, v [T, hd], mask [T]
    bool key validity (masked keys -1e9, keys past T none).  ``passes``
    replaces the six passes of both products."""
    t, hd = q.shape
    kd, padded = -(-hd // 16) * 16, -(-t // _TILE) * _TILE
    acc = _six_pass_steps(torch.zeros(t, t), _split3(q), _split3(k.T.contiguous()), 0, kd,
                          passes)
    logits = torch.where(mask[None, :], acc * (float(hd) ** -0.5), ea.NEG_INF)
    logits = torch.nn.functional.pad(logits, (0, padded - t), value=-float("inf"))
    m, s = _row_stats(logits)
    w = torch.exp(logits - m) / s  # 0 past T
    w_parts = _split3(w)
    v_parts = _split3(torch.nn.functional.pad(v, (0, 0, 0, padded - t)))
    out = torch.zeros(t, hd)
    for j in range(0, padded, _TILE):
        out = out + _six_pass_steps(torch.zeros(t, hd), w_parts, v_parts, j, j + _TILE, passes)
    return out


@pytest.mark.parametrize("kernel", ["packed", "head_major"])
@pytest.mark.parametrize("t,hd", [(82, 52), (665, 52), (2665, 52), (97, 36)])
def test_six_pass_products_within_chip_tolerance(kernel, t, hd):
    """The float32 kernel's arithmetic, emulated head by head, against the
    float32 plain versions of K1 and K2 at the Transcriber's path shapes
    (one segment, a quarter of it padding; Base at its 2, 16 and 64 s
    buckets, Tiny's hd=36): within the tolerance chip_smoke.py holds the
    kernels to (float32 atol 2e-6, rtol 1e-5)."""
    b, h = 1, 8
    rng = np.random.default_rng(t + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, hd)).astype(np.float32))
               for _ in range(3))
    mask = torch.arange(t)[None, :] < t * 3 // 4
    for i in range(h):
        qh, kh, vh = (x[:, :, i] for x in (q, k, v))  # [B, T, hd]
        if kernel == "packed":
            ref = ea._encoder_attention_packed_torch(
                qh.contiguous(), kh.transpose(1, 2).contiguous(), vh.contiguous(), mask, 1)
        else:
            ref = ea._encoder_attention_torch(*(x[:, :, i:i + 1] for x in (q, k, v)), mask)[:, :, 0]
        torch.testing.assert_close(_attention_f32_kernel(qh[0], kh[0], vh[0], mask[0]), ref[0],
                                   **F32_KERNEL)


@pytest.mark.parametrize("t,passes", [(82, _PASSES[2:]), (665, _PASSES[2:]), (665, _PASSES[5:])])
def test_chip_tolerance_catches_dropped_passes(t, passes):
    """The float32 tolerance has room for the six-pass arithmetic but not
    for less: the emulated kernel without its two lo passes (four passes)
    or with hi.hi alone (one bf16 product) falls outside it against the
    plain version, on some head of Base at the 2 or 16 s bucket."""
    hd, h = 52, 8
    rng = np.random.default_rng(t + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, h, hd)).astype(np.float32))
               for _ in range(3))
    mask = torch.arange(t)[None, :] < t * 3 // 4
    ref = ea._encoder_attention_torch(q, k, v, mask)[0]
    out = torch.stack([_attention_f32_kernel(q[0, :, i], k[0, :, i], v[0, :, i], mask[0], passes)
                       for i in range(h)], dim=1)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(out, ref, **F32_KERNEL)
