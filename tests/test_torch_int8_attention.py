"""K5, the fused int8-KV decode attention (``ops/int8_kv.attention_dm_q8``
on CUDA tensors, ``csrc/int8_attention.cu``), against the plain einsums on
the same card tensors; and, on the CPU, the wrapper's argument checks, its
counters, and ``write_kv`` / ``attend_kv`` under each column rule
(``int8_kv.Cursor``, ``int8_kv.RowStarts``) against the write-then-attend
sequences the decoders ran themselves.  The plain version itself is held
against the JAX package in ``tests/test_torch_layers.py::test_attention_dm_q8``.

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
from moonshine_tpu_torch.models import streaming_batch as sb
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
    """None; a decode step's causal mask [1, 1, s, T]; the same from each
    row's first column [B, 1, s, T] (``rows``: rows left-padded by 0 to 63
    columns, as Canary-Qwen's prompts are); a token-masked prefill mask
    [B, 1, s, T] (padded query rows and their keys hidden, so the last row
    of element 1 sees no key); a memory mask [B, 1, 1, T] with one element
    fully masked."""
    if kind == "none":
        return None
    key = torch.arange(t, device=device)
    if kind in ("causal", "rows"):
        pos = t - s + torch.arange(s, device=device)
        causal = key[None, :] <= pos[:, None]
        if kind == "causal":
            return causal[None, None]
        first = torch.arange(b, device=device) * min(64, t) // b
        return (causal[None] & (key[None, None, :] >= first[:, None, None]))[:, None]
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


def _grouped_inputs(b, s, h, hk, hd, t, dtype, device, seed=0):
    """q [B, s, H, hd] and int8 caches of H_kv heads [B, H_kv, hd, T]."""
    q, kq, ks, vq, vs = _inputs(b, s, hk, hd, t, dtype, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((b, s, h, hd), generator=g).to(device, dtype)
    return q, kq, ks, vq, vs


def _repeated(x: torch.Tensor, group: int) -> torch.Tensor:
    """Cache heads repeated so that head h of the result is head h // group."""
    return x.repeat_interleave(group, dim=1)


# (b, s, h, h_kv, hd, t): grouped-query attention.  Canary-Qwen's LLM (16 q
# heads over 8 K/V heads of 128) at B=128, s=1, over 300 and 700 columns
# (the 20.48 s and 40.96 s buckets' prompts and tokens); a few query rows; a
# tiny form; one K/V head for every q head (MQA).
GROUPED_SHAPES = [
    (128, 1, 16, 8, 128, 300),
    (128, 1, 16, 8, 128, 700),
    (4, 3, 16, 8, 128, 64),
    (8, 1, 4, 2, 16, 33),
    (8, 1, 6, 1, 64, 97),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "rows", "memory"])
@pytest.mark.parametrize("b,s,h,hk,hd,t", GROUPED_SHAPES)
def test_cuda_grouped_kernel_matches_plain(cuda_device, b, s, h, hk, hd, t, mask_kind, dtype):
    q, kq, ks, vq, vs = _grouped_inputs(b, s, h, hk, hd, t, dtype, cuda_device)
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
@pytest.mark.parametrize("b,s,h,hk,hd,t", GROUPED_SHAPES)
def test_cuda_grouped_kernel_is_the_kernel_over_repeated_caches(cuda_device, b, s, h, hk, hd, t,
                                                                dtype):
    """Grouped heads read each cache head in place as the MHA kernel reads
    a copy repeated to q's heads: the same sums, bit for bit."""
    q, kq, ks, vq, vs = _grouped_inputs(b, s, h, hk, hd, t, dtype, cuda_device, seed=5)
    mask = _masks("causal", b, h, s, t, cuda_device)
    out = q8.attention_dm_q8(q, kq, ks, vq, vs, mask)
    g = h // hk
    full = q8.attention_dm_q8(q, *(_repeated(x, g) for x in (kq, ks, vq, vs)), mask)
    assert torch.equal(out, full)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
@pytest.mark.parametrize("b,s,h,hk,hd,t", [(3, 2, 4, 2, 16, 9), (2, 1, 6, 1, 8, 5)])
def test_cpu_grouped_attention_is_attention_over_repeated_caches(int8, b, s, h, hk, hd, t):
    """The plain versions (int8 and float caches) with grouped heads: q head
    h attends to cache head h // (H / H_kv), as over caches repeated to H."""
    q, kq, ks, vq, vs = _grouped_inputs(b, s, h, hk, hd, t, torch.float32, "cpu", seed=3)
    mask = _masks("causal", b, h, s, t, "cpu")
    g = h // hk
    if int8:
        kv = q8.LayerKV(kq, vq, ks, vs)
        full = q8.LayerKV(*(_repeated(x, g) for x in kv))
    else:
        kv = q8.LayerKV(q8.dequantize_kv(kq, ks), q8.dequantize_kv(vq, vs))
        full = q8.LayerKV(_repeated(kv.k, g), _repeated(kv.v, g))
    out, w = q8.attend_kv(q, kv, mask, with_weights=True)
    ref, ref_w = q8.attend_kv(q, full, mask, with_weights=True)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(w, ref_w, atol=1e-6, rtol=1e-6)


def _attention_dm_q8_mha_before(q, k_q, k_s, v_q, v_s, mask):
    """K5's plain version as it was before grouped heads: one cache head a
    q head, in the MHA einsums."""
    logits = torch.einsum("bshd,bhdt->bhst", q.float(), k_q.float())
    logits = logits * (k_s * q.shape[-1] ** -0.5)[:, :, None, :]
    if mask is not None:
        logits = logits.masked_fill(~mask, q8.NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    wv = (weights * v_s[:, :, None, :]).to(q.dtype)
    return torch.einsum("bhst,bhdt->bshd", wv, v_q.to(q.dtype)), weights


def _plain_mha_is_the_expression_it_was(b, s, h, hd, t, mask_kind, dtype, device):
    q, kq, ks, vq, vs = _inputs(b, s, h, hd, t, dtype, device, seed=b + s + t)
    mask = _masks(mask_kind, b, h, s, t, device)
    for got, expect in zip(q8.attention_dm_q8_with_weights(q, kq, ks, vq, vs, mask),
                           _attention_dm_q8_mha_before(q, kq, ks, vq, vs, mask)):
        assert got.dtype == expect.dtype and torch.equal(got, expect)
    k, v = q8.dequantize_kv(kq, ks, dtype), q8.dequantize_kv(vq, vs, dtype)
    full = torch.ones((b, 1, s, t), dtype=torch.bool, device=device) if mask is None else mask
    for got, expect in zip(q8.attention_dm(q, k, v, full, with_weights=True),
                           _attention_dm_before(q, k, v, full, with_weights=True)):
        assert got.dtype == expect.dtype and torch.equal(got, expect)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "memory", "prefill"])
@pytest.mark.parametrize("b,s,h,hd,t", [(3, 1, 4, 16, 9), (2, 5, 8, 52, 41)])
def test_cpu_plain_mha_is_the_expression_it_was(b, s, h, hd, t, mask_kind, dtype):
    """With one cache head a q head, the grouped plain versions (int8 and
    float caches) are the MHA einsums they replaced, bit for bit: the
    grouped contraction at a group of 1 is the same product."""
    _plain_mha_is_the_expression_it_was(b, s, h, hd, t, mask_kind, dtype, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["causal", "memory"])
@pytest.mark.parametrize("b,s,h,hd,t", [(64, 1, 8, 52, 41), (128, 5, 8, 128, 513)])
def test_cuda_plain_mha_is_the_expression_it_was(cuda_device, b, s, h, hd, t, mask_kind, dtype):
    """The same on the card (the word timestamps' plain version runs there)."""
    _plain_mha_is_the_expression_it_was(b, s, h, hd, t, mask_kind, dtype, cuda_device)


def test_grouped_heads_must_divide_q_heads():
    q, kq, ks, vq, vs = _grouped_inputs(1, 1, 6, 4, 8, 5, torch.float32, "cpu")
    with pytest.raises(ValueError, match="H_kv dividing"):
        q8.attention_dm_q8(q, kq, ks, vq, vs, None)


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


def _attention_dm_before(q, k, v, mask, with_weights):
    """The float dim-major attention as the Moonshine module held it."""
    logits = torch.einsum("bshd,bhdt->bhst", q.float(), k.float()) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits.masked_fill(~mask, -1e9), dim=-1)
    out = torch.einsum("bhst,bhdt->bshd", weights.to(q.dtype), v)
    return (out, weights) if with_weights else out


def _write_before(kv, k_new, v_new, put):
    """A decoder's K/V write before the format moved behind
    ``ops/int8_kv.py``: quantize K, then V, write K, V and their scales; or
    the float write."""
    if kv.k_scale is None:
        return q8.LayerKV(put(kv.k, k_new.to(kv.k.dtype)), put(kv.v, v_new.to(kv.v.dtype)))
    (kq, ks), (vq, vs) = q8.quantize_kv(k_new), q8.quantize_kv(v_new)
    return q8.LayerKV(put(kv.k, kq), put(kv.v, vq), put(kv.k_scale, ks), put(kv.v_scale, vs))


def _write_attend_before(q, kv, k_new, v_new, put, mask, with_weights):
    """A decoder's self-attention block before the format moved behind
    ``ops/int8_kv.py``: the write, then K5's plain version or the float
    attention."""
    k, v, k_s, v_s = _write_before(kv, k_new, v_new, put)
    if k_s is None:
        return _attention_dm_before(q, k.to(q.dtype), v.to(q.dtype), mask, with_weights)
    fn = q8.attention_dm_q8_with_weights if with_weights else q8.attention_dm_q8
    return fn(q, k, k_s, v, v_s, mask)


def _write_cols_before(buf, new, start):
    """``moonshine._write_cols`` as the Moonshine decoders held it: in place,
    or into a copy where autograd records ``new``."""
    if torch.is_grad_enabled() and new.requires_grad:
        return torch.slice_scatter(buf, new, dim=-1, start=start, end=start + new.shape[-1])
    buf[..., start:start + new.shape[-1]] = new
    return buf


def _canary_put_before(buf, new, start):
    """Canary's decoder's own column write."""
    buf[..., start:start + new.shape[-1]] = new
    return buf


def _put_at_before(buf, new, start):
    """``streaming_batch._put_at``'s write: each row's columns from ``start``."""
    return sb._write(buf, start, new, buf.dim() - 1)


# (starts [B], the rule, the write the decoders ran before ``int8_kv`` owned
# the rule): a host cursor (``moonshine._write_cols``, the offline decoders;
# Canary's own write) and per-row starts (the service's ``_put_at``: int64
# cursors, and int32 ones past both ends, which clamp).
RULES = {
    "cursor": (torch.tensor([5, 5, 5]), q8.Cursor(5), _write_cols_before),
    "canary_cursor": (torch.tensor([5, 5, 5]), q8.Cursor(5), _canary_put_before),
    "per_row": (torch.tensor([0, 5, 10]), None, _put_at_before),
    "per_row_int32_clamped": (torch.tensor([-3, 5, 11], dtype=torch.int32), None,
                              _put_at_before),
}


@pytest.mark.parametrize("with_weights", [False, True], ids=["out", "weights"])
@pytest.mark.parametrize("put_kind", list(RULES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_write_and_attend_are_the_sequences_they_replace(int8, dtype, put_kind, with_weights):
    """``write_kv`` then ``attend_kv`` leave the same caches and give the
    same output (and weights), bit for bit, as the sequence each decoder
    ran, under each column rule of ``RULES``: a host cursor
    (:class:`int8_kv.Cursor`) where the offline decoders wrote at
    ``cur_len``, per-row starts (:class:`int8_kv.RowStarts`) where the
    service wrote at each stream's cursor."""
    b, s, h, hd, t = 3, 2, 2, 8, 12
    g = torch.Generator().manual_seed(11)
    q = torch.randn((b, s, h, hd), generator=g).to(dtype)
    k_new, v_new = (torch.randn((b, h, hd, s), generator=g).to(dtype) for _ in range(2))
    old_k, old_v = torch.randn((b, h, hd, t), generator=g), torch.randn((b, h, hd, t), generator=g)
    if int8:
        (kq, ks), (vq, vs) = q8.quantize_kv(old_k), q8.quantize_kv(old_v)
        caches = q8.LayerKV(kq, vq, ks, vs)
    else:
        caches = q8.LayerKV(old_k.to(dtype), old_v.to(dtype))
    start, rule, before = RULES[put_kind]
    rule = rule or q8.RowStarts(start)
    at = rule.start if isinstance(rule, q8.Cursor) else start
    put = lambda buf, new: before(buf, new, at)  # noqa: E731
    first = start.long().clamp(0, t - s)  # the columns each row's write starts at
    mask = (torch.arange(t) <= (first[:, None] + torch.arange(s))[..., None])[:, None]
    mask[1, ..., 7] = False  # a key hidden from every query of row 1

    ref_kv = q8.LayerKV(*(None if x is None else x.clone() for x in caches))
    expect = _write_attend_before(q, ref_kv, k_new, v_new, put, mask, with_weights)
    written = q8.write_kv(caches, k_new, v_new, rule)
    got = q8.attend_kv(q, written, mask, with_weights)
    for x, y in zip(written, ref_kv):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(got if with_weights else [got], expect if with_weights else [expect]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # The writes landed in place, at the rows' columns.
    cols = first[:, None] + torch.arange(s)
    new_k = written.k.gather(-1, cols[:, None, None, :].expand(b, h, hd, s))
    assert written.k.data_ptr() == caches.k.data_ptr()
    assert torch.equal(new_k, q8.quantize_kv(k_new)[0] if int8 else k_new)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cursor_under_autograd_writes_what_write_cols_wrote(int8):
    """Where autograd records the new K/V (a trainer's decoder), the host
    cursor writes what ``moonshine._write_cols`` wrote, values and
    gradients: copies of what carries a gradient (float caches' K and V, int8
    caches' scales), so the caches handed in keep those untouched."""
    b, s, h, hd, t = 2, 3, 2, 4, 9
    g = torch.Generator().manual_seed(5)
    k_new, v_new = (torch.randn((b, h, hd, s), generator=g).requires_grad_() for _ in range(2))
    old_k, old_v = torch.randn((b, h, hd, t), generator=g), torch.randn((b, h, hd, t), generator=g)
    if int8:
        (kq, ks), (vq, vs) = q8.quantize_kv(old_k), q8.quantize_kv(old_v)
        caches = q8.LayerKV(kq, vq, ks, vs)
    else:
        caches = q8.LayerKV(old_k, old_v)
    ref_kv = q8.LayerKV(*(None if x is None else x.clone() for x in caches))
    kept = q8.LayerKV(*(None if x is None else x.clone() for x in caches))
    got = q8.write_kv(caches, k_new, v_new, q8.Cursor(4))
    expect = _write_before(ref_kv, k_new, v_new, lambda buf, new: _write_cols_before(buf, new, 4))

    def grads(written):
        loss = sum((x * (i + 1)).sum() for i, x in enumerate(written)
                   if x is not None and x.requires_grad)
        return torch.autograd.grad(loss, (k_new, v_new), allow_unused=True)

    for x, y in zip(got, expect):
        assert (x is None and y is None) or (torch.equal(x, y)
                                             and x.requires_grad == y.requires_grad)
    for x, y in zip(grads(got), grads(expect)):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y, w in zip(caches, kept, got):
        if w is not None and w.requires_grad:
            assert torch.equal(x, y) and w.data_ptr() != x.data_ptr()
