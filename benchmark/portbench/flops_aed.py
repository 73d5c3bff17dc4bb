"""Operations and bytes from shapes for Canary's attention-encoder-decoder
(``configs/canary_1b_flash.json``): the model FLOPs of a clip, and the
least time of the encoder's relative-position attention.

Model FLOPs count the model's own products (2 operations a
multiply-accumulate) for a clip's valid samples and the decoder positions
it needed, not the padding a batch adds: the features' DFT and mel
products, the subsampling stem, every conformer layer and the decoder.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def frames(arch: dict, n_samples: int) -> list[int]:
    """Feature frames, then the frames after each stride-2 stage."""
    out = [n_samples // arch["hop_length"] + 1]
    for _ in range(arch["subsampling_stages"]):
        out.append((out[-1] - 1) // 2 + 1)
    return out


def encode_flops(arch: dict, n_samples: int) -> int:
    """Features, stem and encoder of one clip of ``n_samples`` samples."""
    d, ff, k = arch["d_model"], arch["ff_dim"], arch["conv_kernel_size"]
    ch, mels, bins = arch["subsampling_channels"], arch["n_mels"], arch["n_fft"] // 2 + 1
    f = frames(arch, n_samples)
    total = f[0] * (2 * arch["n_fft"] * 2 * bins + 2 * bins * mels)
    width = mels
    for i, n in enumerate(f[1:]):
        width = (width - 1) // 2 + 1
        total += 2 * 9 * ch * n * width  # the 3x3 convolution (depthwise after the first)
        if i:
            total += 2 * ch * ch * n * width  # the pointwise one
    t = f[-1]
    total += 2 * ch * width * d * t
    per_layer = (2 * 2 * 2 * t * d * ff  # two feed-forwards
                 + 2 * 4 * t * d * d + 2 * (2 * t - 1) * d * d  # q, k, v, o; the positions
                 + 2 * t * t * d + 2 * t * (2 * t - 1) * d + 2 * t * t * d  # AC, BD, P.V
                 + 2 * t * d * 2 * d + 2 * t * d * k + 2 * t * d * d)  # the conv module
    return total + arch["encoder_layers"] * per_layer


def decode_flops(arch: dict, memory_frames: int, prompt: int, forwards: int) -> int:
    """The cross K/V of ``memory_frames`` frames and the decoder positions
    of a prompt of ``prompt`` tokens and ``forwards`` - 1 tokens fed back
    (position p attends to p + 1 keys of its own and to the memory), with
    the tied logits."""
    d, ff, layers, vocab = arch["d_model"], arch["ff_dim"], arch["decoder_layers"], arch["vocab_size"]
    positions = prompt + forwards - 1
    cross_kv = layers * memory_frames * 2 * 2 * d * d
    dense = positions * layers * (2 * 6 * d * d + 2 * 2 * d * ff)
    logits = forwards * 2 * d * vocab  # the prompt's other rows are not scored
    attn_keys = positions * (positions + 1) // 2 + positions * memory_frames
    return cross_kv + dense + logits + layers * 2 * 2 * d * attn_keys


def relpos_attention_bound(d: int, lengths: list[int], elt_bytes: int) -> dict:
    """The least time of one layer's relative-position attention over clips
    of ``lengths`` valid frames: per clip 2*H*T^2*dk (AC), 2*H*T*(2T-1)*dk
    (BD) and 2*H*T^2*dk (P.V) operations at the bf16 peak, against q, k, v
    and the position term p (2T-1 rows) read once and the output written
    once, at the HBM rate; ``d`` is the width, H*dk."""
    flops = sum(2 * d * (2 * t * t + t * (2 * t - 1)) for t in lengths)
    bytes_moved = sum((4 * t + 2 * t - 1) * d * elt_bytes for t in lengths)
    t_flops, t_bytes = flops / PEAK_FLOPS["bfloat16"], bytes_moved / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": bytes_moved, "bound_s": max(t_flops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
