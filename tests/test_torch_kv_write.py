"""K7, the quantize-and-write of a layer's new int8 K/V (``ops/int8_kv.write_kv``
into int8 caches on CUDA tensors, ``csrc/kv_write.cu``), against the plain
chain on the same card tensors: ``quantize_kv`` of K and of V, then the
column rule's four writes.  On the card the two must agree exactly, values
and scales, and leave every other column of the caches as it was.  And its
launch counts: one a layer, in the ``kv_write_launches`` of the
``greedy.decode`` and ``service.update`` spans.  On the CPU: the dispatch
(the plain chain for CPU tensors, no launch counted), the refusal of a
column rule K7 cannot take, and the wrapper's checks.  The column rules
themselves are held against the writes the decoders ran before in
``tests/test_torch_int8_attention.py``.

On the card, without JAX:
    python -m pytest --noconftest tests/test_torch_kv_write.py -m cuda
"""

from __future__ import annotations

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import kvw_plain
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.ops import int8_kv as q8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _new_kv(b, s, h, hd, dtype, device, seed, valid=None):
    """New K and V as the decoders hand them: ``[B, s, H, hd]`` projections
    permuted to dim-major ``[B, H, hd, s]`` views; with ``valid`` [B] the
    columns at or past each row's count are zero (the service's ingest of a
    128-frame block, masked by its new frames)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for spread in (3.0, 1.0):
        x = torch.randn((b, s, h, hd), generator=g) * spread
        if valid is not None:
            x = torch.where((torch.arange(s)[None, :] < valid[:, None])[..., None, None], x, 0.0)
        out.append(x.to(device, dtype).permute(0, 2, 3, 1))
    return out


def _caches(b, h, hd, t, device, seed):
    """Int8 caches and scales holding earlier columns (none of them 0), so a
    write in the wrong place or a column left unwritten shows."""
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randint(-127, 128, (b, h, hd, t), generator=g, dtype=torch.int8)
            for _ in range(2))
    ks, vs = (torch.rand((b, h, t), generator=g) + 0.5 for _ in range(2))
    return q8.LayerKV(*(x.to(device) for x in (k, v, ks, vs)))


def _plain(kv: q8.LayerKV, k_new, v_new, cols) -> q8.LayerKV:
    """``write_kv``'s plain chain into copies of the caches, on whatever
    device the tensors lie on."""
    return kvw_plain(q8, q8.LayerKV(*(x.clone() for x in kv)), k_new, v_new, cols)


def _rule(kind: str, b: int, s: int, t: int, device):
    """A host cursor three columns before the end, or per-row starts in
    int32 or int64 that run from below 0 to past T - s (each clamps)."""
    if kind == "cursor":
        return q8.Cursor(max(t - s - 3, 0))
    starts = torch.linspace(-2, t - s + 2, b).round()
    return q8.RowStarts(starts.to(device, torch.int32 if kind == "rows_int32" else torch.int64))


def _columns(cols, b: int, s: int, t: int) -> torch.Tensor:
    """[B, T] bool: the columns each row's write covers."""
    if isinstance(cols, q8.Cursor):
        first = torch.full((b,), cols.start)
    else:
        first = cols.start.cpu().long().clamp(0, t - s)
    key = torch.arange(t)
    return (key[None, :] >= first[:, None]) & (key[None, :] < first[:, None] + s)


# (label, B, H, hd, s, T, valid): the cells' shapes.  Base b64's decode step
# (its prompt is one token, so its prefill is the same shape) over a cache
# of 41 columns; the service's decode step and its verify at the draft cap
# (128 + 1 tokens) over the 448-column self cache, and its ingest of a
# 128-frame block into the 3,200-column cross cache, with a row's new
# frames from 0 to 128 (the rest zero, quantized to scale 1); Canary's
# decode at B=128, 8 heads of 128, at s=1 and at the 5-token prompt;
# Canary-Qwen's prompt's call (8 K/V heads of 128 at B=128): 271 columns into
# the 20.48 s bucket's cache of 353, 527 into the 40.96 s bucket's of 691;
# beside them the widest head K7 takes, an odd head size and two tiles of a
# 33-token prefill.
SHAPES = [
    ("b64", 64, 8, 52, 1, 41, None),
    ("serve", 32, 11, 64, 1, 448, None),
    ("verify", 32, 11, 64, 129, 448, None),
    ("ingest", 32, 11, 64, 128, 3200, "masked"),
    ("canary", 128, 8, 128, 1, 170, None),
    ("canary prefill", 128, 8, 128, 5, 170, None),
    ("canary-qwen prefill 20.48 s", 128, 8, 128, 271, 353, None),
    ("canary-qwen prefill 40.96 s", 128, 8, 128, 527, 691, None),
    ("hd 256", 4, 2, 256, 3, 20, None),
    ("hd 36", 8, 6, 36, 33, 97, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cursor", "rows_int32", "rows_int64"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("label,b,h,hd,s,t,valid", SHAPES, ids=[x[0] for x in SHAPES])
def test_cuda_kernel_is_the_plain_chain(cuda_device, label, b, h, hd, s, t, valid, dtype, kind):
    """One launch; the caches' values and scales equal the plain chain's
    exactly, the written columns and every other one."""
    counts = None if valid is None else torch.linspace(0, s, b).round().long()
    k_new, v_new = _new_kv(b, s, h, hd, dtype, cuda_device, seed=b + s + hd, valid=counts)
    kv = _caches(b, h, hd, t, cuda_device, seed=t)
    before_kv = q8.LayerKV(*(x.clone() for x in kv))
    cols = _rule(kind, b, s, t, cuda_device)
    expect = _plain(kv, k_new, v_new, cols)
    before = profiling.counter(q8.KV_WRITE_LAUNCHES)
    got = q8.write_kv(kv, k_new, v_new, cols)
    torch.cuda.synchronize()
    assert profiling.counter(q8.KV_WRITE_LAUNCHES) == before + 1
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(got, kv))  # in place
    for x, y in zip(got, expect):
        assert torch.equal(x, y)
    written = _columns(cols, b, s, t).to(cuda_device)[:, None]  # [B, 1, T]
    for x, y in zip(got, before_kv):
        m = written if x.dim() == 3 else written[:, :, None]
        assert torch.equal(torch.where(m, 0, x), torch.where(m, 0, y))


def _ties(dtype, device):
    """K and V [2, 2, 8, 3] (hd 8, 3 columns), each column built on a power
    of two 2^m: its largest magnitude 127 * 2^m, so its scale is exactly
    2^m (by a division or by the reciprocal's product), and the rest odd
    multiples of 2^(m-1), so each value over its scale lies exactly on a
    half; and one column all zero."""
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5])
    cols = []
    for m in (0, 1, -2):
        cols.append(torch.cat([torch.tensor([127.0]), halves]) * 2.0**m)
    cols[1][0] = -cols[1][0]  # the largest magnitude negative
    x = torch.stack(cols, dim=-1)  # [8, 3]
    k = x.expand(2, 2, 8, 3).clone()
    k[1, 1, :, 2] = 0.0
    return k.to(device, dtype), (-k).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_cuda_zero_columns_and_ties(cuda_device, dtype):
    """An all-zero column takes scale 1 and zeros; values that lie exactly
    on a half round to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 125.5 -> 126),
    as ``torch.round`` rounds, in K7 and in the plain chain alike."""
    k_new, v_new = _ties(dtype, cuda_device)
    kv = _caches(2, 2, 8, 6, cuda_device, seed=1)
    cols = q8.Cursor(2)
    expect = _plain(kv, k_new, v_new, cols)
    got = q8.write_kv(kv, k_new, v_new, cols)
    for x, y in zip(got, expect):
        assert torch.equal(x, y)
    assert torch.equal(got.k[0, 0, :, 2], torch.tensor([127, 0, 2, 2, 0, -2, -2, 126],
                                                        dtype=torch.int8, device=cuda_device))
    assert got.k_scale[0, 0, 2:5].tolist() == [1.0, 2.0, 0.25]
    assert got.k_scale[1, 1, 4].item() == 1.0 and not got.k[1, 1, :, 4].any()


@pytest.mark.cuda
def test_cuda_refuses_what_it_does_not_take(cuda_device):
    """On the card an int8 cache raises, before any launch, for a rule K7
    cannot take, a dtype or a shape it does not take, or K/V that autograd
    records."""
    k_new, v_new = _new_kv(2, 1, 2, 8, torch.bfloat16, cuda_device, seed=0)
    kv = _caches(2, 2, 8, 5, cuda_device, seed=0)
    before = profiling.counter(q8.KV_WRITE_LAUNCHES)
    with pytest.raises(TypeError, match="Cursor or RowStarts"):
        q8.write_kv(kv, k_new, v_new, lambda buf, new: buf)
    with pytest.raises(TypeError, match="the kernel takes K and V"):
        q8.write_kv(kv, k_new.double(), v_new.double(), q8.Cursor(0))
    with pytest.raises(ValueError, match="head_dim"):
        q8.write_kv(_caches(2, 2, 264, 5, cuda_device, seed=0),
                    *_new_kv(2, 1, 2, 264, torch.bfloat16, cuda_device, seed=0), q8.Cursor(0))
    with pytest.raises(ValueError, match="outside"):
        q8.write_kv(kv, k_new, v_new, q8.Cursor(5))
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        q8.write_kv(kv, k_new.float().requires_grad_(), v_new.float(), q8.Cursor(0))
    assert profiling.counter(q8.KV_WRITE_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["base", "medium_streaming", "canary"])
def test_cuda_launches_per_decoder_call(cuda_device, model):
    """One K7 launch a decoder layer a decoder call, in the recorder's
    counter and in the span's ``kv_write_launches``: 8 a Base decoder call,
    4 a Canary call (its published decoder depth, at a small width), and in
    the service 10 a decoder call plus 10 a pass of the ingest (the new
    cross K/V)."""
    before = profiling.counter(q8.KV_WRITE_LAUNCHES)
    g = torch.Generator().manual_seed(0)
    if model == "medium_streaming":
        import numpy as np

        from moonshine_tpu_torch.core.config import STREAMING_ARCHS
        from moonshine_tpu_torch.models import streaming as ms
        from moonshine_tpu_torch.serving import StreamingService

        cfg = STREAMING_ARCHS[model]
        svc = StreamingService(ms.init_params(cfg, g, cuda_device), cfg, None, 2,
                               compute_dtype=torch.bfloat16, kv_int8=True, device=cuda_device)
        audio = (np.random.default_rng(0).standard_normal(16000 * 4) * 0.1).astype(np.float32)
        start = len(profiling.spans("service.update"))
        for slot in range(2):
            svc.open_slot(slot)
        for i in range(4):
            for slot in range(2):
                svc.add_audio(slot, audio[i * 16000:(i + 1) * 16000])
            svc.update()
        spans = profiling.spans("service.update")[start:]
        per = [sp.attrs["kv_write_launches"] for sp in spans]
        assert per == [cfg.depth * (sp.attrs["decoder_calls"] + sp.attrs["passes"])
                       for sp in spans]
        assert sum(sp.attrs["decoder_calls"] for sp in spans) > 0
    else:
        if model == "base":
            from moonshine_tpu_torch.core.config import BASE as cfg
            from moonshine_tpu_torch.models import moonshine as mm

            net, layers, width = mm.init_params(cfg, g, cuda_device), 8, cfg.hidden_size
            memory = torch.randn((2, 40, width), generator=g).to(cuda_device)
            mask = torch.ones((2, 40), dtype=torch.bool, device=cuda_device)
        else:
            from moonshine_tpu_torch.models import canary as cm

            cfg = cm.CanaryArchConfig(d_model=128, encoder_layers=2, decoder_layers=4, n_heads=4,
                                      ff_dim=256, subsampling_channels=16, vocab_size=300,
                                      max_positions=128)
            net, layers = cm.init_params(cfg, g, cuda_device), 4
            audio = (torch.randn((2, 24000), generator=g) * 0.1).to(cuda_device)
            with torch.inference_mode():
                memory, mask = cm.encode(net, cfg, audio,
                                         torch.tensor([24000, 16000], device=cuda_device))
        greedy_decode(net, cfg, memory, mask, max_tokens=5, kv_int8=True)
        spans = [profiling.spans("greedy.decode")[-1]]
        assert spans[0].attrs["kv_write_launches"] == layers * spans[0].attrs["decoder_calls"]
    assert profiling.counter(q8.KV_WRITE_LAUNCHES) - before == sum(
        sp.attrs["kv_write_launches"] for sp in spans)


# -- on the CPU --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cursor", "rows_int32", "rows_int64"])
def test_cpu_path_is_plain_and_leaves_launch_counter(kind):
    """Int8 caches on CPU tensors take the plain chain: the same caches,
    written in place, and no launch counted."""
    b, h, hd, s, t = 3, 2, 8, 2, 7
    k_new, v_new = _new_kv(b, s, h, hd, torch.bfloat16, "cpu", seed=2)
    kv = _caches(b, h, hd, t, "cpu", seed=2)
    cols = _rule(kind, b, s, t, "cpu")
    expect = _plain(kv, k_new, v_new, cols)
    before = profiling.counter(q8.KV_WRITE_LAUNCHES)
    got = q8.write_kv(kv, k_new, v_new, cols)
    assert profiling.counter(q8.KV_WRITE_LAUNCHES) == before
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(got, kv))
    for x, y in zip(got, expect):
        assert torch.equal(x, y)


def test_int8_caches_refuse_a_rule_the_kernel_cannot_take():
    """An opaque column rule writes float caches and raises for int8 ones,
    on every device: the int8 write is never left to a rule K7 cannot read."""
    k_new, v_new = _new_kv(2, 1, 2, 8, torch.float32, "cpu", seed=3)
    put = q8.Cursor(1)
    floats = q8.LayerKV(torch.zeros((2, 2, 8, 4)), torch.zeros((2, 2, 8, 4)))
    got = q8.write_kv(floats, k_new, v_new, lambda buf, new: put(buf, new))
    assert torch.equal(got.k[..., 1:2], k_new)
    with pytest.raises(TypeError, match="Cursor or RowStarts"):
        q8.write_kv(_caches(2, 2, 8, 4, "cpu", seed=3), k_new, v_new,
                    lambda buf, new: put(buf, new))


@pytest.mark.parametrize("bad", [
    "device", "rank", "v_shape", "scale_shape", "dtype", "v_dtype", "cache_dtype",
    "scale_dtype", "head_dim", "too_many_columns", "strides", "cursor_low", "cursor_high",
    "starts_dtype", "starts_shape", "grad"])
def test_kernel_route_refuses_what_it_does_not_take(bad):
    """Each raised before any launch: a device with no kernel, shapes that
    do not match, dtypes K7 does not take (K and V in float32, bf16 or fp16,
    int8 caches, float32 scales), a head past 256, more new columns than
    the cache has, caches whose columns are not contiguous, a cursor whose
    columns leave the cache, per-row starts not int32 or int64 [B], and
    K/V that autograd records."""
    b, h, hd, s, t = 2, 2, 8, 2, 6
    k_new, v_new = _new_kv(b, s, h, hd, torch.bfloat16, "cpu", seed=4)
    kv = _caches(b, h, hd, t, "cpu", seed=4)
    cols = q8.Cursor(1)
    match = "no kernel for device"
    if bad == "rank":
        k_new, match = k_new[0], "the kernel takes K/V"
    elif bad == "v_shape":
        v_new, match = v_new[..., :1], "K/V must be"
    elif bad == "scale_shape":
        kv, match = kv._replace(v_scale=kv.v_scale[:, :1]), "scales must be"
    elif bad == "dtype":
        k_new, v_new, match = k_new.double(), v_new.double(), "the kernel takes K and V"
    elif bad == "v_dtype":
        v_new, match = v_new.float(), "the kernel takes K and V"
    elif bad == "cache_dtype":
        kv, match = kv._replace(v=kv.v.float()), "caches must be int8"
    elif bad == "scale_dtype":
        kv, match = kv._replace(k_scale=kv.k_scale.double()), "scales must be float32"
    elif bad == "head_dim":
        k_new, v_new = _new_kv(b, s, h, 264, torch.bfloat16, "cpu", seed=4)
        kv, match = _caches(b, h, 264, t, "cpu", seed=4), "head_dim"
    elif bad == "too_many_columns":
        k_new, v_new = _new_kv(b, t + 1, h, hd, torch.bfloat16, "cpu", seed=4)
        match = "s <= T"
    elif bad == "strides":
        kv = kv._replace(k=kv.k.transpose(2, 3).contiguous().transpose(2, 3))
        match = "T stride 1"
    elif bad in ("cursor_low", "cursor_high"):
        cols, match = q8.Cursor(-1 if bad == "cursor_low" else t - s + 1), "outside"
    elif bad == "starts_dtype":
        cols, match = q8.RowStarts(torch.zeros((b,))), "int32 or int64"
    elif bad == "starts_shape":
        cols, match = q8.RowStarts(torch.zeros((b, 1), dtype=torch.int32)), "int32 or int64"
    elif bad == "grad":
        k_new, v_new = k_new.float().requires_grad_(), v_new.float()
        with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
            q8._launch_write(kv, k_new, v_new, cols)
        return
    with pytest.raises((ValueError, TypeError), match=match):
        q8._launch_write(kv, k_new, v_new, cols)
