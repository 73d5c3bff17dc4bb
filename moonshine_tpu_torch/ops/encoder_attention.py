"""Encoder self-attention: hand-written CUDA kernels, their plain PyTorch
versions, and the per-rank form of each for a (data, model) mesh.

Counterparts of the JAX package's ``ops/encoder_attention.py``:

- ``encoder_attention_packed`` (K1, the Pallas ``_packed_kernel``): ``q``
  and ``v`` are ``[B, T, H*hd]`` with the heads packed along the last axis,
  ``kt`` is dim-major ``[B, H*hd, T]``;
- ``encoder_attention`` (K2, the Pallas ``_attn_kernel``): ``q``, ``k`` and
  ``v`` are head-split ``[B, T, H, hd]``.

Per batch row and head both compute

    logits = q_h k_h^T * hd^-0.5       (float32 accumulation)
    masked keys -> -1e9                (a row with no valid key is uniform)
    w = softmax(logits) in float32     (K1 then casts w to the I/O dtype;
                                        K2 keeps it in float32)
    out_h = w v_h                      (float32 accumulation, cast to I/O dtype)

Each wrapper runs its plain version on CPU tensors and its kernel
(``csrc/encoder_attention.cu``) on CUDA tensors.  It never falls back from
one to the other.  Neither kernel has a backward (the Pallas kernels have
no transpose rule either), so every wrapper refuses, on both devices, an
input that requires grad while grad mode is on: the plain version would
train on the CPU where the kernel's output on the card would cut the
graph.  ``attn_impl="xla"`` is the differentiable encoder attention.

``encoder_attention_sharded`` and ``encoder_attention_packed_sharded`` are
the counterparts of the JAX ``shard_map`` wrappers: batch over the mesh's
``data`` axis, whole heads over its ``model`` axis, no collective inside the
attention.  PyTorch runs one process per rank, so each is a per-rank body
(a plain function of the rank's coordinate and the mesh shape, which a
single process can run for every coordinate) and a wrapper that runs the
body for its own rank and all-gathers the head blocks over the ``model``
group.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from .. import profiling
from ..parallel.mesh import MODEL_AXIS
from . import _build

# The recorder's launch counters of K1 and K2 (profiling.counter).
K1_LAUNCHES = "launches.encoder_attention_packed"
K2_LAUNCHES = "launches.encoder_attention"

NEG_INF = -1e9
MAX_HEAD_DIM = 128  # the kernels' k16 steps of Q.K^T, ceil(head_dim / 16), are at most 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_PER_BLOCK = 232_448  # shared memory one Hopper block may opt into
_TILE_KEYS, _STAGES = 64, 3  # the kernels' rings: 3 buffers of 64-key tiles


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def max_frames(head_dim: int, dtype: torch.dtype) -> int:
    """The longest T (frames) the kernels take at ``head_dim`` and ``dtype``.

    float32 (``encoder_attention_f32_kernel``): no logits are stored (each
    warp computes Q.K^T twice, once for the row max and sum and once for the
    weights), so shared memory holds only the ring of 64-key tiles and does
    not grow with T.  The launch takes the bytes of one of K1's kt rows, 4T,
    as a 32-bit int (``copy_width``), so 4T < 2^31: T <= 2^29 - 64 (whole
    64-key tiles), at any head_dim.
    bf16 (``encoder_attention_mma_kernel``): each block keeps float32 logits
    rows over every key in shared memory, at least one warp's 16 rows, of T
    rounded up to 64 plus 8 floats, beside three ring buffers of 64-key
    tiles, each the largest of K1's [kd][72], K2's [64][kd + 8] and the
    values' [64][vs] in bf16 (kd = hd rounded up to 16; vs = hd rounded up
    to 8, + 8 when that is an even number of 16-byte words); both kernels
    are held to the smaller limit.  The same arithmetic as
    ``csrc/encoder_attention.cu`` (``make_f32_layout``, ``make_layout``).
    """
    if dtype == torch.float32:
        return (2**31 - 1) // 4 // _TILE_KEYS * _TILE_KEYS
    kd, nv = _round_up(head_dim, 16), _round_up(head_dim, 8)
    vs = nv if (nv // 8) % 2 else nv + 8
    ring = max(kd * (_TILE_KEYS + 8), _TILE_KEYS * (kd + 8), _TILE_KEYS * vs) * 2
    rows_floats = (_SMEM_PER_BLOCK - _STAGES * ring) // (16 * 4)  # one warp's logits row stride
    return (rows_floats - 8) // _TILE_KEYS * _TILE_KEYS


def _encoder_attention_packed_torch(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
    frame_mask: torch.Tensor | None, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same rounding points.

    bf16 products are exact in float32, so the float32 products here are
    the kernel's "bf16 operands, float32 accumulation".
    """
    b, t, d = q.shape
    hd = d // heads
    qh = q.reshape(b, t, heads, hd).transpose(1, 2).float()  # [B, H, T, hd]
    kh = kt.reshape(b, heads, hd, t).float()                  # [B, H, hd, T]
    vh = v.reshape(b, t, heads, hd).transpose(1, 2).float()
    logits = torch.matmul(qh, kh) * (float(hd) ** -0.5)
    if frame_mask is not None:
        logits = logits.masked_fill(~frame_mask[:, None, None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    w = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.matmul(w.float(), vh).to(q.dtype)  # [B, H, T, hd]
    return out.transpose(1, 2).reshape(b, t, d)


def _encoder_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Plain PyTorch version of K2, with its rounding points: q, k, v, the
    logits and the weights all float32, the output cast to q's dtype."""
    hd = q.shape[-1]
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, T, hd]
    logits = torch.matmul(qh, kh.transpose(2, 3)) * (float(hd) ** -0.5)
    if frame_mask is not None:
        logits = logits.masked_fill(~frame_mask[:, None, None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(w, vh).to(q.dtype).transpose(1, 2).contiguous()  # [B, T, H, hd]


def _check_io(tensors: dict, frame_mask, b: int, t: int) -> None:
    """dtype and device of the operands, and the [B, T] bool mask."""
    q = next(iter(tensors.values()))
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors.values()):
        raise TypeError(
            f"{', '.join(tensors)} must share one dtype of {list(_DTYPE_CODES)}; got "
            f"{', '.join(str(x.dtype) for x in tensors.values())}")
    if any(x.device != q.device for x in tensors.values()):
        raise ValueError(f"{', '.join(tensors)} must lie on one device")
    if frame_mask is not None:
        if frame_mask.dtype != torch.bool or tuple(frame_mask.shape) != (b, t):
            raise ValueError(f"frame_mask must be bool [B, T] = {(b, t)}")
        if frame_mask.device != q.device:
            raise ValueError("frame_mask must lie on the device of q")


def _check_frames(t: int, hd: int, dtype: torch.dtype) -> None:
    """Refuse, on every device, a T or head_dim the kernel does not take."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM}; got {hd}")
    if t > max_frames(hd, dtype):
        raise ValueError(
            f"T={t} frames exceeds the kernel's longest, {max_frames(hd, dtype)} at "
            f"head_dim={hd} in {dtype}")


def _check(q, kt, v, frame_mask, heads) -> None:
    if q.dim() != 3 or kt.dim() != 3 or v.dim() != 3:
        raise ValueError("q, kt and v must be [B, T, D], [B, D, T] and [B, T, D]")
    b, t, d = q.shape
    if heads <= 0 or d % heads:
        raise ValueError(f"packed width {d} is not a multiple of heads={heads}")
    if tuple(kt.shape) != (b, d, t) or tuple(v.shape) != (b, t, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, kt {tuple(kt.shape)} "
            f"(want {(b, d, t)}), v {tuple(v.shape)}")
    _check_io({"q": q, "kt": kt, "v": v}, frame_mask, b, t)
    _check_frames(t, d // heads, q.dtype)


def _check_hm(q, k, v, frame_mask) -> None:
    if q.dim() != 4:
        raise ValueError(f"q, k and v must be [B, T, H, hd]; got q {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_io({"q": q, "k": k, "v": v}, frame_mask, q.shape[0], q.shape[1])
    _check_frames(q.shape[1], q.shape[3], q.dtype)


def _refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through ``name``."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad. Encode with "
            f"attn_impl=\"xla\", the differentiable attention, to train through it")


@functools.cache
def _kernel(name: str):
    """The C entry point ``name`` (``encoder_attention_packed`` or
    ``encoder_attention_hm``), built at first use, with its signature
    declared (without ``argtypes`` ctypes would pass each pointer as a
    32-bit int)."""
    fn = getattr(_build.load("encoder_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, q, k, v, frame_mask, b: int, t: int, heads: int, hd: int) -> torch.Tensor:
    """Check what the kernel takes, launch it on q's stream, raise on a
    launch error; returns the output, shaped like q."""
    for arg, x in (("q", q), ("k", k), ("v", v), ("frame_mask", frame_mask)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if b > 65535 or heads > 65535:
        raise ValueError(f"kernel takes B, heads <= 65535; got B={b}, heads={heads}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if frame_mask is None else frame_mask.data_ptr(), out.data_ptr(),
            b, t, heads, hd, _DTYPE_CODES[q.dtype], float(hd) ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed with CUDA error {rc} (B={b}, T={t}, heads={heads}, "
            f"head_dim={hd}, {q.dtype})")
    return out


def encoder_attention_packed(
    q: torch.Tensor,   # [B, T, H*hd]: heads packed (not split)
    kt: torch.Tensor,  # [B, H*hd, T]: keys dim-major
    v: torch.Tensor,   # [B, T, H*hd]
    frame_mask: torch.Tensor | None,  # [B, T] bool key validity (None = all valid)
    heads: int,
) -> torch.Tensor:
    """Packed-layout encoder attention; returns [B, T, H*hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    count the launch in the recorder's ``launches.encoder_attention_packed``.
    """
    _check(q, kt, v, frame_mask, heads)
    _refuse_grad("encoder_attention_packed", q, kt, v)
    if q.device.type == "cpu":
        return _encoder_attention_packed_torch(q, kt, v, frame_mask, heads)
    if q.device.type != "cuda":
        raise ValueError(f"no encoder attention for device {q.device}")
    b, t, d = q.shape
    out = _launch("encoder_attention_packed", q, kt, v, frame_mask, b, t, heads, d // heads)
    profiling.count(K1_LAUNCHES)
    return out


def encoder_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, T, H, hd]
    v: torch.Tensor,  # [B, T, H, hd]
    frame_mask: torch.Tensor | None,  # [B, T] bool key validity (None = all valid)
) -> torch.Tensor:
    """Head-major encoder attention (K2); returns [B, T, H, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    reads [B, T, H, hd] in place, and count the launch in the recorder's
    ``launches.encoder_attention``.
    """
    _check_hm(q, k, v, frame_mask)
    _refuse_grad("encoder_attention", q, k, v)
    if q.device.type == "cpu":
        return _encoder_attention_torch(q, k, v, frame_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no encoder attention for device {q.device}")
    b, t, h, hd = q.shape
    out = _launch("encoder_attention_hm", q, k, v, frame_mask, b, t, h, hd)
    profiling.count(K2_LAUNCHES)
    return out


# -------------------------------------------------------------------------
# Per-rank bodies and their wrappers for a (data, model) mesh
# -------------------------------------------------------------------------

def _block(n: int, index: int, parts: int, what: str) -> slice:
    """Block ``index`` of ``parts`` equal blocks of ``range(n)``."""
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by {parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def encoder_attention_sharded_body(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_mask: torch.Tensor | None,
    coord: tuple[int, int], mesh_shape: tuple[int, int],
) -> torch.Tensor:
    """One rank's share of ``encoder_attention`` on a (data, model) mesh of
    ``mesh_shape``: of q, k, v [B, T, H, hd] it takes the rows of data block
    ``coord[0]`` and the heads of model block ``coord[1]`` and runs K2 on
    them.  Returns [B / data, T, H / model, hd]."""
    (d_i, m_i), (n_data, n_model) = coord, mesh_shape
    b, _, heads, _ = q.shape
    if heads % n_model:
        raise ValueError(f"heads {heads} not divisible by model axis {n_model}")
    rows = _block(b, d_i, n_data, "batch")
    hs = _block(heads, m_i, n_model, "heads")
    q, k, v = (x[rows, :, hs].contiguous() for x in (q, k, v))
    return encoder_attention(q, k, v, None if frame_mask is None else frame_mask[rows])


def encoder_attention_packed_sharded_body(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, frame_mask: torch.Tensor | None,
    heads: int, coord: tuple[int, int], mesh_shape: tuple[int, int],
) -> torch.Tensor:
    """One rank's share of ``encoder_attention_packed`` on a (data, model)
    mesh of ``mesh_shape``: the rows of data block ``coord[0]``, and of
    model block ``coord[1]`` the lanes ``[m*D/M, (m+1)*D/M)`` of q and v and
    the same rows of kt, which hold ``heads / model`` whole heads; it runs K1
    on them.  Returns [B / data, T, D / model]."""
    (d_i, m_i), (n_data, n_model) = coord, mesh_shape
    if heads % n_model:
        raise ValueError(f"heads {heads} not divisible by model axis {n_model}")
    b, _, d = q.shape
    rows = _block(b, d_i, n_data, "batch")
    lanes = _block(d, m_i, n_model, "packed width")
    return encoder_attention_packed(
        q[rows, :, lanes].contiguous(), kt[rows, lanes].contiguous(),
        v[rows, :, lanes].contiguous(),
        None if frame_mask is None else frame_mask[rows], heads // n_model)


def _gather_heads(block: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather the head blocks [.., H/model, ..] (axis 2) over the mesh's
    ``model`` group: every rank of the group gets every head, in order."""
    group = mesh.get_group(MODEL_AXIS)
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts, dim=2)


def _model_coord(mesh) -> tuple[tuple[int, int], tuple[int, int]]:
    """(coord, mesh_shape) of this rank's body: the rows the caller holds
    are already its data shard, so they are block 0 of 1."""
    n_model = mesh.shape[mesh.mesh_dim_names.index(MODEL_AXIS)]
    return (0, mesh.get_local_rank(MODEL_AXIS)), (1, n_model)


def encoder_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_mask: torch.Tensor | None, mesh,
) -> torch.Tensor:
    """``encoder_attention`` on a (data, model) ``DeviceMesh`` (from
    ``parallel.mesh.make_mesh``).  q, k, v [B, T, H, hd] are the rows this
    rank holds (its data shard, as ``parallel.sharding.shard_batch`` gives
    it) with every head; this rank computes heads block ``m`` of ``model``
    and the ``model`` group all-gathers the blocks, so the caller gets its
    rows with every head.  Raises if ``H % model != 0``."""
    _refuse_grad("encoder_attention_sharded", q, k, v)
    coord, shape = _model_coord(mesh)
    return _gather_heads(encoder_attention_sharded_body(q, k, v, frame_mask, coord, shape), mesh)


def encoder_attention_packed_sharded(
    q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, frame_mask: torch.Tensor | None,
    heads: int, mesh,
) -> torch.Tensor:
    """``encoder_attention_packed`` on a (data, model) ``DeviceMesh``, as
    ``encoder_attention_sharded``: whole-head lane blocks over ``model``,
    all-gathered so the caller gets its rows [B, T, H*hd] with every head."""
    _refuse_grad("encoder_attention_packed_sharded", q, kt, v)
    coord, shape = _model_coord(mesh)
    return _gather_heads(
        encoder_attention_packed_sharded_body(q, kt, v, frame_mask, heads, coord, shape), mesh)
