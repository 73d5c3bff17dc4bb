"""Operations and bytes from shapes: the model FLOPs of the work a window
did, and the least time of one encoder attention (K1) call.

Model FLOPs count the model's own products (2 operations a
multiply-accumulate) for the frames and tokens a request needs, not the
padding a batch adds and not the port's extra products (the pair-swapped
rotary projections, a window re-encoded around its new frames).
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def attention_bound(b: int, t, h: int, hd: int, elt_bytes: int, peak: float) -> dict:
    """The least time of one encoder attention call over ``b`` rows whose
    valid lengths are ``t`` (an int for all rows, or a list): q, k, v read
    and out written once, against its two products of 2*H*T^2*hd
    operations each (a copy of ``chip_smoke.attention_bound``, with each
    row's own length, both products at ``peak``)."""
    lengths = [t] * b if isinstance(t, int) else list(t)
    bytes_moved = sum(4 * n * h * hd * elt_bytes for n in lengths)
    flops = sum(2 * 2 * h * n * n * hd for n in lengths)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_flops = flops / peak
    return {"bytes": bytes_moved, "flops": flops, "bound_s": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


# -- Moonshine (non-streaming) -------------------------------------------------

def moonshine_frames(arch: dict, n_samples: int) -> list[int]:
    """Frames after each frontend stage for ``n_samples`` samples."""
    out, n = [], n_samples
    for k, s in zip(arch["conv_kernels"], arch["conv_strides"]):
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def moonshine_encode_flops(arch: dict, n_samples: int) -> int:
    """Frontend and encoder of one clip of ``n_samples`` valid samples."""
    d, ff, layers = arch["hidden_size"], arch["intermediate_size"], arch["encoder_layers"]
    k1, k2, k3 = arch["conv_kernels"]
    f1, f2, t = moonshine_frames(arch, n_samples)
    front = 2 * f1 * k1 * d + 2 * f2 * k2 * d * 2 * d + 2 * t * k3 * 2 * d * d
    per_layer = t * (2 * 4 * d * d + 2 * 2 * d * ff) + 2 * 2 * t * t * d
    return front + layers * per_layer


def moonshine_decode_flops(arch: dict, memory_frames: int, tokens: int) -> int:
    """The cross K/V of ``memory_frames`` frames and ``tokens`` decoder
    positions (position p attends to p + 1 keys of its own and to the
    memory), with the tied logits."""
    d, ff, layers, vocab = (arch["hidden_size"], arch["intermediate_size"],
                            arch["decoder_layers"], arch["vocab_size"])
    cross_kv = layers * memory_frames * 2 * 2 * d * d
    dense = tokens * (layers * (2 * 6 * d * d + 2 * 3 * d * ff) + 2 * d * vocab)
    attn_keys = tokens * (tokens + 1) // 2 + tokens * memory_frames
    return cross_kv + dense + layers * 2 * 2 * d * attn_keys


# -- Moonshine streaming -------------------------------------------------------

def streaming_ingest_flops(arch: dict, frames: int, window: int = 256) -> int:
    """Frontend, encoder (each frame once, attending over a window of
    ``window`` keys), adapter and cross K/V of ``frames`` new frames."""
    d, c1, c2 = arch["d_model_frontend"], arch["c1"], arch["c2"]
    e, dd, layers = arch["encoder_dim"], arch["decoder_dim"], arch["depth"]
    width = arch["nheads"] * arch["head_dim"]
    ctx = 79 + arch["frame_len"]
    front = 2 * ctx * d + 2 * 5 * d * c1 + 2 * 5 * c1 * c2
    enc = 2 * c2 * e + layers * (2 * 4 * e * width + 2 * 2 * e * 4 * e + 2 * 2 * window * width)
    adapter = 2 * e * dd
    cross_kv = layers * 2 * 2 * dd * width
    return frames * (front + enc + adapter + cross_kv)


def streaming_decode_flops(arch: dict, memory_frames: int, tokens: int) -> int:
    """``tokens`` decoder positions over ``memory_frames`` of memory."""
    dd, layers, vocab = arch["decoder_dim"], arch["depth"], arch["vocab_size"]
    width = arch["nheads"] * arch["head_dim"]
    dense = tokens * (layers * (2 * 6 * dd * width + 2 * 3 * dd * 4 * dd) + 2 * dd * vocab)
    attn_keys = tokens * (tokens + 1) // 2 + tokens * memory_frames
    return dense + layers * 2 * 2 * width * attn_keys


def peak_flops(precision: dict) -> float:
    """The data-sheet peak of the cell's stated precision."""
    return PEAK_FLOPS["bfloat16" if precision["weights"] == "bfloat16" else "float32"]
