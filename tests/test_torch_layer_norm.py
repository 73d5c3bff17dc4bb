"""K6, the LayerNorm kernel (``ops/layer_norm.layer_norm`` on CUDA tensors,
``csrc/layer_norm.cu``), against the plain version on the same card
tensors, forward and backward; and, on the CPU, the dispatch (the plain
version for CPU tensors alone), the backward's gradients, the wrapper's
checks and its row strides.
The plain version itself is held against the JAX package through
``models/layers.layer_norm`` in ``tests/test_torch_layers.py``.

On the card, without JAX:
    python -m pytest --noconftest tests/test_torch_layer_norm.py -m cuda

Tolerance.  K6 rounds where the plain version rounds (the mean, the
variance, rsqrt, the product by the weight, the bias, the cast to x's
dtype) and computes everything in float32; only the order of the float32
sums differs (a lane's running sum and a warp's shuffle tree against
PyTorch's reductions).  A different order moves the mean by a few float32
ulps of the mean of |x|, at most |mean| + std: so a normalised value
(x - mean) / std moves by a few ulps of 1 + |mean| / std, and the output by
that times |w|; the variance, rsqrt and the products move the output by a
few ulps of itself, and the bias add by an ulp of |b|.  So in float32 each
element is held to ``chip_smoke.LN_F32_ULPS`` ulps (2^-23 each) of |plain| + (1 + |mean| /
std) * |w| + |b|.  A bf16 or fp16 output is each float32 result rounded once
to that dtype, so the two may also part by one unit in the last place of the
output's dtype: the float32 bound plus one ulp at the larger magnitude.
``chip_smoke.ln_excess`` measures an output against that bound, for these
tests and for the smoke run's K6 phase.
"""

from __future__ import annotations

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import LN_EPS as EPS
from chip_smoke import ln_excess
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.models import layers
from moonshine_tpu_torch.ops import layer_norm as ln


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(rows, width, dtype, w_dtype, bias, device, seed=0):
    """x [rows, width] of normal values of std 2 around a per-row offset of
    std 1; a weight near 1 and a small bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, width), generator=g, device=device) * 2
    x = x + torch.randn((rows, 1), generator=g, device=device)
    w = 1 + 0.5 * torch.randn((width,), generator=g, device=device)
    b = 0.1 * torch.randn((width,), generator=g, device=device) if bias else None
    return x.to(dtype), w.to(w_dtype), None if b is None else b.to(w_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 12_000])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("width", [288, 416, 704, 1024, 1000, 997, 4096])
def test_cuda_kernel_matches_plain(cuda_device, width, dtype, w_dtype, bias, rows):
    """Moonshine's widths (288 Tiny, 416 Base, 704 the streaming service),
    the widest row a warp holds, a width off the 16-byte vectors (997: one
    value a load) and one past a warp (4096: a block a row)."""
    x, w, b = _inputs(rows, width, dtype, w_dtype, bias, cuda_device, seed=width + rows)
    before = profiling.counter(ln.LN_LAUNCHES)
    y = ln.layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert profiling.counter(ln.LN_LAUNCHES) == before + 1
    assert ln_excess(y, ln.layer_norm_plain(x, w, b, EPS), x, w, b) <= 1


def _views(device):
    """Non-contiguous inputs, each with the contiguous tensor of its values:
    the last token of each sequence (rows one stride apart, read in place),
    a transposed last axis (made contiguous first), a row that starts off
    the 16-byte boundary (one value a load) and a broadcast batch (stride
    0 between rows)."""
    g = torch.Generator(device=device).manual_seed(11)
    seq = torch.randn((8, 5, 416), generator=g, device=device).to(torch.bfloat16)
    last = seq[:, -1:]
    t = torch.randn((4, 704, 6), generator=g, device=device).to(torch.bfloat16).transpose(1, 2)
    wide = torch.randn((6, 417), generator=g, device=device).to(torch.bfloat16)
    shifted = wide[:, 1:]
    one = torch.randn((1, 1, 416), generator=g, device=device).to(torch.bfloat16)
    spread = one.expand(4, 1, 416)
    return [("last token", last), ("transposed", t), ("shifted", shifted), ("broadcast", spread)]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["last token", "transposed", "shifted", "broadcast"])
def test_cuda_non_contiguous_inputs(cuda_device, which):
    """Each view gives the plain version's values within the tolerance, and
    the bits K6 gives for the contiguous copy of its values."""
    x = dict(_views(cuda_device))[which]
    assert not x.is_contiguous()
    w = (1 + 0.5 * torch.randn(x.shape[-1], device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(x.shape[-1], device=cuda_device)).to(torch.bfloat16)
    y = ln.layer_norm(x, w, b, EPS)
    assert y.is_contiguous() and y.shape == x.shape
    assert ln_excess(y, ln.layer_norm_plain(x, w, b, EPS), x, w, b) <= 1
    if which != "shifted":  # the contiguous copy takes the vector path: another sum order
        assert torch.equal(y, ln.layer_norm(x.contiguous(), w, b, EPS))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [416, 4096])
def test_cuda_row_alone_gives_its_bits_in_a_batch(cuda_device, width):
    """A row's sums run in one order wherever the row lies in the grid."""
    x, w, b = _inputs(257, width, torch.bfloat16, torch.bfloat16, True, cuda_device, seed=3)
    y = ln.layer_norm(x, w, b, EPS)
    assert torch.equal(ln.layer_norm(x[130:131], w, b, EPS), y[130:131])


@pytest.mark.cuda
def test_cuda_launch_counter_and_norm_holder(cuda_device):
    """One launch a call, through ``layers.layer_norm`` too, and a decoder
    call of Moonshine makes three a layer and one for the final norm."""
    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.models import moonshine as mm

    x, w, b = _inputs(64, 416, torch.bfloat16, torch.bfloat16, False, cuda_device)
    before = profiling.counter(ln.LN_LAUNCHES)
    y = layers.layer_norm(layers.Norm(w), x, EPS)
    assert profiling.counter(ln.LN_LAUNCHES) == before + 1
    assert torch.equal(y, ln.layer_norm(x, w, None, EPS))

    model = mm.init_params(TINY, torch.Generator().manual_seed(0), cuda_device)
    memory = torch.randn((2, 40, TINY.hidden_size), device=cuda_device)
    mask = torch.ones((2, 40), dtype=torch.bool, device=cuda_device)
    before = profiling.counter(ln.LN_LAUNCHES)
    with torch.inference_mode():
        greedy_decode(model, TINY, memory, mask, max_tokens=6, kv_int8=True)
    calls = profiling.spans("greedy.decode")[-1].attrs["decoder_calls"]
    assert profiling.counter(ln.LN_LAUNCHES) - before == (3 * TINY.decoder_layers + 1) * calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs_grad", ["x", "weight", "bias", "all"])
def test_cuda_call_autograd_records_launches_k6(cuda_device, needs_grad, dtype):
    """A call autograd records launches K6 once, gives the bits K6 gives
    under no_grad, and its gradients are the plain version's, bit for bit:
    the backward differentiates the plain forward recomputed from the same
    inputs, for the same output gradient."""
    x, w, b = _inputs(16, 416, dtype, dtype, True, cuda_device)
    names = ("x", "weight", "bias") if needs_grad == "all" else (needs_grad,)
    tensors = {"x": x, "weight": w, "bias": b}
    for name in names:
        tensors[name].requires_grad_(True)
    grad = torch.randn(x.shape, device=cuda_device).to(dtype)
    before = profiling.counter(ln.LN_LAUNCHES)
    y = ln.layer_norm(x, w, b, EPS)
    assert profiling.counter(ln.LN_LAUNCHES) == before + 1 and y.requires_grad
    with torch.no_grad():
        assert torch.equal(y, ln.layer_norm(x, w, b, EPS))
    got = torch.autograd.grad(y, [tensors[n] for n in names], grad)
    want = torch.autograd.grad(ln.layer_norm_plain(x, w, b, EPS), [tensors[n] for n in names],
                               grad)
    assert profiling.counter(ln.LN_LAUNCHES) == before + 2
    for name, g, r in zip(names, got, want):
        assert g.dtype == tensors[name].dtype and torch.equal(g, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["x float64", "x int", "weight float64", "bias dtype",
                                 "weight shape", "weight device"])
def test_cuda_refuses_what_it_does_not_take(cuda_device, bad):
    x, w, b = _inputs(4, 416, torch.bfloat16, torch.bfloat16, True, cuda_device)
    if bad == "x float64":
        x = x.double()
    elif bad == "x int":
        x = x.to(torch.int32)
    elif bad == "weight float64":
        w, b = w.double(), b.double()
    elif bad == "bias dtype":
        b = b.float()
    elif bad == "weight shape":
        w = w[None]
    else:
        w = w.cpu()
    with pytest.raises((TypeError, ValueError)):
        ln.layer_norm(x, w, b, EPS)


# -- on the CPU --------------------------------------------------------------------------


def _old_layer_norm(p, x, eps=1e-5):
    """``layers.layer_norm`` as it was before K6: the plain composite."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.weight
    if p.bias is not None:
        y = y + p.bias
    return y.to(x.dtype)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_cpu_dispatch_is_plain_and_bit_equal(dtype, w_dtype, bias):
    """CPU tensors run the plain version, launch nothing, and
    ``layers.layer_norm`` keeps its values bit for bit."""
    x, w, b = _inputs(6, 40, dtype, w_dtype, bias, "cpu")
    x = x.reshape(2, 3, 40)
    p = layers.Norm(w, b)
    before = profiling.counter(ln.LN_LAUNCHES)
    y = layers.layer_norm(p, x, 1e-6)
    assert profiling.counter(ln.LN_LAUNCHES) == before
    assert y.dtype == dtype
    assert torch.equal(y, _old_layer_norm(p, x, 1e-6))
    assert torch.equal(y, ln.layer_norm_plain(x, w, b, 1e-6))


def test_cpu_gradient_flows_through_plain():
    x, w, b = _inputs(3, 24, torch.float32, torch.float32, True, "cpu")
    x.requires_grad_(True)
    ln.layer_norm(x, w, b).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _meta(dtype=torch.bfloat16, w_dtype=torch.bfloat16, width=32, bias=True):
    x = torch.empty((4, width), dtype=dtype, device="meta")
    w = torch.empty((width,), dtype=w_dtype, device="meta")
    return x, w, torch.empty((width,), dtype=w_dtype, device="meta") if bias else None


@pytest.mark.parametrize("bad", ["device", "x dtype", "weight dtype", "bias dtype",
                                 "weight shape", "weight strides", "too wide", "no axis"])
def test_kernel_route_refuses_what_it_does_not_take(bad):
    """Off the CPU every call launches K6 or raises,
    before any launch: a device with no kernel (meta tensors here), a dtype
    other than float32, bf16 and fp16, a bias in another dtype than the
    weight, parameters that are not a contiguous [width], a row wider than
    one block's shared memory holds, a tensor with no axis."""
    x, w, b = _meta()
    match = "no kernel for device"
    if bad == "x dtype":
        x, match = x.double(), "takes x"
    elif bad == "weight dtype":
        w, b, match = w.double(), b.double(), "takes the weight"
    elif bad == "bias dtype":
        b, match = b.float(), "the bias in the weight's dtype"
    elif bad == "weight shape":
        w, match = w[None], "contiguous"
    elif bad == "weight strides":
        w, match = torch.empty((64,), dtype=w.dtype, device="meta")[::2], "contiguous"
    elif bad == "too wide":
        x, w, b = _meta(width=ln.MAX_WIDTH + 1)
        match = "widths"
    elif bad == "no axis":
        x, match = x[0, 0], "last axis"
    with pytest.raises((ValueError, TypeError), match=match):
        ln.layer_norm(x, w, b)
    assert ln.MAX_WIDTH == 57_856


def test_call_autograd_records_launches_or_raises_off_the_cpu():
    """With grad enabled and a parameter that requires it, a meta tensor
    goes the kernel's way too, and raises for want of a kernel, as it does
    under no_grad."""
    x, w, b = _meta()
    w.requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel for device"):
        ln.layer_norm(x, w, b)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        ln.layer_norm(x, w, b)


@pytest.mark.parametrize("needs_grad", [("x",), ("weight", "bias"), ("x", "weight", "bias"),
                                        ("x", "weight")])
def test_backward_is_the_plain_gradient(monkeypatch, needs_grad):
    """LayerNormK6's backward, with the launch replaced by the plain
    version: its gradients are the plain version's, bit for bit, for the
    inputs that require one (no bias where ``needs_grad`` leaves it out)."""
    monkeypatch.setattr(ln, "_launch", ln.layer_norm_plain)
    x, w, b = _inputs(5, 48, torch.bfloat16, torch.float32, True, "cpu", seed=4)
    if "bias" not in needs_grad and len(needs_grad) > 1:
        b = None
    tensors = {"x": x, "weight": w, "bias": b}
    for name in needs_grad:
        tensors[name].requires_grad_(True)
    grad = torch.randn(x.shape).to(x.dtype)
    got = torch.autograd.grad(ln.LayerNormK6.apply(x, w, b, 1e-6),
                              [tensors[n] for n in needs_grad], grad)
    want = torch.autograd.grad(ln.layer_norm_plain(x, w, b, 1e-6),
                               [tensors[n] for n in needs_grad], grad)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("view,expected", [
    ("contiguous", 416), ("last token", 5 * 416), ("one row", 416), ("vector", 416),
    ("broadcast", 0), ("two strides", None), ("middle slice", 3 * 416)])
def test_row_stride(view, expected):
    """The stride between rows, or None where the leading axes do not
    flatten to one (the wrapper then makes x contiguous)."""
    seq = torch.empty((8, 5, 416))
    x = {
        "contiguous": seq,
        "last token": seq[:, -1:],
        "one row": seq[:1, :1],
        "vector": seq[0, 0],
        "broadcast": seq[:1].expand(3, 1, 5, 416)[:, :, 0],
        "two strides": seq[:, :2],
        "middle slice": torch.empty((8, 5, 3, 416))[:, :, 1],
    }[view]
    assert ln.row_stride(x) == expected


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_tolerance_separates_one_ulp_from_a_wrong_value(dtype):
    """The card tests' bound: the plain output itself reads 0; one element
    moved by one ulp of its dtype passes in bf16 and fp16 (float32: by 4
    ulps); by three ulps (float32: by 64, past F32_ULPS of the scale) it
    fails, as does a wrong dtype."""
    x, w, b = _inputs(8, 64, dtype, torch.float32, True, "cpu", seed=2)
    ref = ln.layer_norm_plain(x, w, b, EPS)
    assert ln_excess(ref, ref, x, w, b) == 0
    i = int(ref.float().abs().argmax())
    v = ref.view(-1)[i].float()
    mantissa = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    ulp = 2.0 ** (torch.frexp(v)[1].item() - 1 - mantissa)
    near, far = (4, 64) if dtype == torch.float32 else (1, 3)
    for moved, ok in ((near, True), (far, False)):
        y = ref.clone()
        y.view(-1)[i] = (v - moved * ulp * torch.sign(v)).to(dtype)
        assert (ln_excess(y, ref, x, w, b) <= 1) == ok, moved
    assert ln_excess(ref.double(), ref, x, w, b) > 1
