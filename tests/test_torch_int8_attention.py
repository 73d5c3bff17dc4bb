"""K5, the fused int8-KV decode attention (``ops/int8_kv.attention_dm_q8``
on CUDA tensors, ``csrc/int8_attention.cu``), against the plain einsums on
the same card tensors; and, on the CPU, the wrapper's argument checks and
its counters.  The plain version itself is held against the JAX package in
``tests/test_torch_layers.py::test_attention_dm_q8``.

On the card, without JAX:
    python -m pytest --noconftest tests/test_torch_int8_attention.py -m cuda

Tolerance.  The kernel rounds where the plain version does (the weights
times ``v_s`` to q's dtype, the output to q's dtype) and both sum in
float32; only the order of the sums differs.  So a bf16 output may differ
by about one bf16 step where a sum lands near a rounding boundary: the
relative RMS error over the output is held to 2^-8 (one bf16 step is 2^-8
relative at most, and only a few elements take one), and every element to
2^-7 of the output's largest magnitude.  float32: no rounding to a narrower
type anywhere, so the order of the sums is all that differs; 1e-5 relative
RMS and 1e-5 of the largest magnitude, far above float32's 6e-8 but far
below any wrong weight or column.
"""

from __future__ import annotations

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.ops import int8_kv as q8

TOL = {torch.bfloat16: (2.0**-8, 2.0**-7), torch.float32: (1e-5, 1e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, s, h, hd, t, dtype, device, seed=0, cache_t=None):
    """q [B, s, H, hd] and int8 caches [B, H, hd, T] quantized from normal
    values; with ``cache_t`` the caches are the first T columns of a
    ``cache_t``-column buffer (a memory bucket's slice)."""
    g = torch.Generator().manual_seed(seed)
    ct = t if cache_t is None else cache_t
    q = torch.randn((b, s, h, hd), generator=g)
    k = torch.randn((b, h, hd, ct), generator=g) * 3
    v = torch.randn((b, h, hd, ct), generator=g)
    (kq, ks), (vq, vs) = q8.quantize_kv(k), q8.quantize_kv(v)
    kq, ks, vq, vs = (x.to(device)[..., :t] for x in (kq, ks, vq, vs))
    return q.to(device, dtype), kq, ks, vq, vs


def _assert_close(out: torch.Tensor, ref: torch.Tensor, dtype) -> None:
    rms_tol, elem_tol = TOL[dtype]
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    rel_rms = float((o - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
    worst = float((o - r).abs().max() / r.abs().max())
    assert rel_rms <= rms_tol and worst <= elem_tol, (rel_rms, worst)


def _masks(kind: str, b, h, s, t, device):
    """None; a decode step's causal mask [1, 1, s, T]; a token-masked
    prefill mask [B, 1, s, T] (padded query rows and their keys hidden,
    so the last row of element 1 sees no key); a memory mask [B, 1, 1, T]
    with one element fully masked."""
    if kind == "none":
        return None
    key = torch.arange(t, device=device)
    if kind == "causal":
        pos = t - s + torch.arange(s, device=device)
        return (key[None, :] <= pos[:, None])[None, None]
    if kind == "memory":
        lengths = torch.tensor([t] + [max(t // (i + 2), 1) for i in range(b - 2)] + [0],
                               device=device)[:b]
        return (key[None, :] < lengths[:, None])[:, None, None, :]
    # token-masked prefill: element i has s - i real tokens.
    valid = torch.arange(s, device=device)[None, :] < (s - torch.arange(b, device=device))[:, None]
    causal = key[None, :] <= torch.arange(s, device=device)[:, None]
    key_ok = torch.where(key[None, :] < s, valid[:, key.clamp(max=s - 1)], True)
    return causal[None, None] & valid[:, None, :, None] & key_ok[:, None, None, :]


# (b, s, h, hd, t, cache_t): the offline b64 decode (self T=41, cross T=256:
# the kernel's narrow set), the service's decode and verify (self T=448;
# cross a 2,048 and a 3,200 slice of a 3,200-column buffer: the wide set at
# s=1), single rows of too many blocks for the wide set over a longer
# cache, the speculative gamma+1, a beam's folded queries (4 beams x s=1 on
# shared cross caches), hd 36, and Canary's head dim 128 at B=128: its self
# attention over a 170-column cache at s=1 and over the 5-token prompt's
# prefill, and its cross attention over the 513 frames of a 40.96 s bucket
# at s=1 and s=5.
SHAPES = [
    (64, 1, 8, 52, 41, None),
    (64, 1, 8, 52, 256, None),
    (32, 1, 11, 64, 448, None),
    (32, 33, 11, 64, 448, None),
    (32, 1, 11, 64, 2048, 3200),
    (32, 1, 11, 64, 3200, 3200),
    (32, 33, 11, 64, 2048, 3200),
    (8, 129, 11, 64, 3200, 3200),
    (64, 1, 8, 64, 1024, None),
    (16, 5, 8, 52, 384, None),
    (16, 4, 8, 52, 384, None),
    (8, 1, 6, 36, 97, None),
    (128, 1, 8, 128, 170, None),
    (128, 5, 8, 128, 170, None),
    (128, 1, 8, 128, 513, None),
    (128, 5, 8, 128, 513, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "memory"])
@pytest.mark.parametrize("b,s,h,hd,t,cache_t", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, b, s, h, hd, t, cache_t, mask_kind, dtype):
    q, kq, ks, vq, vs = _inputs(b, s, h, hd, t, dtype, cuda_device, cache_t=cache_t)
    mask = _masks(mask_kind, b, h, s, t, cuda_device)
    before = profiling.counter(q8.Q8_LAUNCHES)
    out = q8.attention_dm_q8(q, kq, ks, vq, vs, mask)
    torch.cuda.synchronize()
    assert profiling.counter(q8.Q8_LAUNCHES) == before + 1
    assert out.dtype == dtype and out.shape == (b, s, h, hd)
    ref = q8.attention_dm_q8_with_weights(q, kq, ks, vq, vs, mask)[0]
    _assert_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_token_masked_prefill_and_fully_masked_rows(cuda_device, dtype):
    """A token-masked prefill (padded rows see no key: uniform weights) and
    a memory mask with one element masked everywhere: finite, and each
    fully masked row is the mean of its dequantized, weight-scaled values,
    as in the plain version."""
    b, s, h, hd, t = 4, 6, 8, 52, 6
    q, kq, ks, vq, vs = _inputs(b, s, h, hd, t, dtype, cuda_device, seed=3)
    for mask in (_masks("prefill", b, h, s, t, cuda_device),
                 torch.zeros((b, 1, 1, t), dtype=torch.bool, device=cuda_device)):
        out = q8.attention_dm_q8(q, kq, ks, vq, vs, mask)
        ref = q8.attention_dm_q8_with_weights(q, kq, ks, vq, vs, mask)[0]
        _assert_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 2048])
def test_cuda_strided_query_and_batch_independence(cuda_device, t):
    """q read through its strides (a transposed view); and a batch row run
    alone (8 blocks: the kernel's wide parameter set) gives the bits it gets
    in a batch of 64 (512 blocks: the narrow set)."""
    b, h, hd = 64, 8, 52
    q, kq, ks, vq, vs = _inputs(b, 3, h, hd, t, torch.bfloat16, cuda_device, seed=5)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    assert not qt.is_contiguous()
    assert torch.equal(q8.attention_dm_q8(qt, kq, ks, vq, vs, None),
                       q8.attention_dm_q8(q, kq, ks, vq, vs, None))
    q1 = q[:, :1]
    out = q8.attention_dm_q8(q1, kq, ks, vq, vs, None)
    one = q8.attention_dm_q8(q1[2:3], kq[2:3], ks[2:3], vq[2:3], vs[2:3], None)
    assert torch.equal(one, out[2:3])


@pytest.mark.cuda
def test_cuda_greedy_decode_launches_per_decoder_call(cuda_device):
    """Every int8-KV attention of the decode runs K5: two launches a layer
    a decoder call, counted in the greedy.decode span's q8_launches."""
    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.models import moonshine as mm

    model = mm.init_params(TINY, torch.Generator().manual_seed(0), cuda_device)
    memory = torch.randn((2, 40, TINY.hidden_size), generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    mask = torch.ones((2, 40), dtype=torch.bool, device=cuda_device)
    before = profiling.counter(q8.Q8_LAUNCHES)
    greedy_decode(model, TINY, memory, mask, max_tokens=6, kv_int8=True)
    sp = profiling.spans("greedy.decode")[-1]
    launched = profiling.counter(q8.Q8_LAUNCHES) - before
    assert launched == sp.attrs["q8_launches"] == 2 * TINY.decoder_layers * sp.attrs[
        "decoder_calls"]


# -- on the CPU --------------------------------------------------------------------------


def _cpu_args(**change):
    q, kq, ks, vq, vs = _inputs(2, 3, 4, 16, 13, torch.float32, "cpu", seed=7)
    args = dict(q=q, k_q=kq, k_s=ks, v_q=vq, v_s=vs,
                mask=torch.ones((2, 1, 3, 13), dtype=torch.bool))
    args.update(change)
    return args


@pytest.mark.parametrize("bad", [
    "q_rank", "cache_shape", "v_shape", "scale_shape", "cache_dtype", "scale_dtype", "q_dtype",
    "mask_dtype", "mask_shape"])
def test_wrapper_rejects_bad_arguments(bad):
    a = _cpu_args()
    change = {
        "q_rank": {"q": a["q"][0]},
        "cache_shape": {"k_q": a["k_q"][..., :12]},
        "v_shape": {"v_q": a["v_q"].transpose(2, 3)},
        "scale_shape": {"k_s": a["k_s"][:, :2]},
        "cache_dtype": {"v_q": a["v_q"].float()},
        "scale_dtype": {"v_s": a["v_s"].double()},
        "q_dtype": {"q": a["q"].to(torch.int32)},
        "mask_dtype": {"mask": a["mask"].float()},
        "mask_shape": {"mask": torch.ones((2, 1, 2, 13), dtype=torch.bool)},
    }[bad]
    with pytest.raises((ValueError, TypeError)):
        q8.attention_dm_q8(**_cpu_args(**change))


@pytest.mark.parametrize("bad", ["device", "q_dtype", "head_dim", "columns", "strides"])
def test_kernel_route_refuses_what_it_does_not_take(bad):
    """What only the kernel refuses, each raised before any launch: a device
    with no kernel, a q dtype other than float32 and bf16, a head size past
    128, a cache longer than one row's logits fit in shared memory, and
    caches whose columns are not contiguous."""
    a = list(_cpu_args().values())
    match = "no kernel for device"
    if bad == "q_dtype":
        a[0], match = a[0].double(), "the kernel takes q"
    elif bad == "head_dim":
        a = list(_inputs(1, 1, 1, 130, 8, torch.float32, "cpu")) + [None]
        match = "head_dim"
    elif bad == "columns":
        t = q8.max_columns(4) + 4
        a = list(_inputs(1, 1, 1, 4, t, torch.float32, "cpu")) + [None]
        match = "head_dim"
    elif bad == "strides":
        a[1] = a[1].transpose(2, 3).contiguous().transpose(2, 3)
        match = "T stride 1"
    with pytest.raises((ValueError, TypeError), match=match):
        q8._launch(*a)
    assert q8.max_columns(64) == 58032 and q8.max_columns(128) == 57968


@pytest.mark.parametrize("shape", [(1, 1, 3, 7), (2, 1, 1, 7), (3, 7), (7,), (2, 4, 3, 7),
                                   (2, 1, 3, 1), "transposed"])
def test_mask_strides_are_the_broadcast_views(shape):
    """The kernel's mask strides are those of ``mask.expand(B, H, s, T)``."""
    target = (2, 4, 3, 7)
    if shape == "transposed":
        mask = torch.ones((2, 1, 7, 3), dtype=torch.bool).transpose(2, 3)
    else:
        mask = torch.ones(shape, dtype=torch.bool)
    assert q8._broadcasts(mask.shape, target)
    assert q8._mask_strides(mask, target) == mask.expand(*target).stride()
    assert not q8._broadcasts((3, 4, 3, 7), target) and not q8._broadcasts((1,) + target, target)


def test_cpu_path_is_plain_and_leaves_launch_counter():
    a = _cpu_args()
    before = profiling.counter(q8.Q8_LAUNCHES)
    out = q8.attention_dm_q8(**a)
    assert profiling.counter(q8.Q8_LAUNCHES) == before
    assert torch.equal(out, q8.attention_dm_q8_with_weights(*a.values())[0])


def test_cpu_greedy_span_counts_no_launch():
    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.models import moonshine as mm

    model = mm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    memory = torch.randn((2, 12, TINY.hidden_size), generator=torch.Generator().manual_seed(1))
    mask = torch.ones((2, 12), dtype=torch.bool)
    greedy_decode(model, TINY, memory, mask, max_tokens=3, kv_int8=True)
    sp = profiling.spans("greedy.decode")[-1]
    assert sp.attrs["q8_launches"] == 0 and sp.attrs["decoder_calls"] >= 1
