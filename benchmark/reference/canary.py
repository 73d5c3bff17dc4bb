"""Plain reference of Canary (NVIDIA's FastConformer encoder and Transformer
decoder, https://huggingface.co/nvidia/canary-1b-flash), one clip at a
time, in float32 with TF32 off.

Written from NeMo's modules, not from the program: the features of
``AudioToMelSpectrogramPreprocessor`` (pre-emphasis 0.97, ``torch.stft``
of 512 points over a symmetric 400-sample Hann window every 160 samples,
centred with zero padding, the power spectrum, 128 Slaney mel filters as
librosa makes them, ``log(x + 2^-24)``, each bin normalised by its mean and
unbiased std (+1e-5) over the clip); ``ConvSubsampling(dw_striding)``
(3x3 stride-2 convolutions with padding 1: one of 1 -> C channels and ReLU,
then twice a depthwise one, a pointwise one and ReLU; the C x n_mels/8
features of each frame projected to d and scaled by sqrt(d)); each
``ConformerLayer``: half a feed-forward (swish), ``RelPositionMultiHead
Attention`` (AC = (q + u) k^T, BD = NeMo's ``rel_shift`` of (q + v) p^T
over the 2T-1 relative positions of ``RelPositionalEncoding``, softmax of
(AC + BD) / sqrt(dk)), ``ConformerConvolution`` (pointwise 2d, GLU,
depthwise 'same', BatchNorm with its running statistics, swish,
pointwise), the second half feed-forward and a LayerNorm; and the pre-LN
``TransformerDecoder``: token embeddings plus ``FixedPositionalEncoding``
(sinusoids over sqrt(d)) and a LayerNorm, self attention, cross attention,
a ReLU feed-forward, a final LayerNorm and the head tied to the embedding
with its own bias.  The clip runs alone at its own length, so nothing is
masked or padded.

``kv_int8``: the configurations that cache keys and values in int8 see
them so here too (``numerics.int8_columns``).  Weights come as a dict of
tensors under the state-dict names the benchmark draws
(``portbench/weights.py``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Products, attention, int8_columns, layer_norm


@contextlib.contextmanager
def float32_products():
    """TF32 off for products and convolutions inside (restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# -- features ----------------------------------------------------------------

def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """librosa's Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    with np.errstate(divide="ignore"):
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                    (200.0 / 3) * m)


def mel_filters(n_mels: int, n_fft: int, sample_rate: int) -> torch.Tensor:
    """[n_mels, n_fft//2 + 1]: ``librosa.filters.mel(norm="slaney")`` from
    0 Hz to Nyquist."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return torch.from_numpy(w.astype(np.float32))


@torch.no_grad()
def features(audio: torch.Tensor, arch: dict, p: Products) -> torch.Tensor:
    """audio [N] (the clip's samples) -> normalised log-mel [T, n_mels]."""
    x = audio.float()
    x = torch.cat([x[:1], x[1:] - arch["preemph"] * x[:-1]])
    window = torch.hann_window(arch["win_length"], periodic=False, device=x.device)
    spec = torch.stft(x, arch["n_fft"], arch["hop_length"], arch["win_length"], window,
                      center=True, pad_mode="constant", return_complex=True)  # [bins, T]
    power = spec.real.square() + spec.imag.square()
    fb = mel_filters(arch["n_mels"], arch["n_fft"], arch["sample_rate"]).to(x.device)
    mel = torch.log(p.matmul(fb, power) + 2.0**-24)  # [M, T]
    mean = mel.mean(dim=1, keepdim=True)
    std = mel.std(dim=1, keepdim=True).nan_to_num(0.0) + 1e-5
    return ((mel - mean) / std).t()


# -- encoder -----------------------------------------------------------------

def _conv2d(p: Products, x, w, b, stride=1, padding=0, groups=1):
    return F.conv2d(p.r(x), p.r(w), b, stride=stride, padding=padding, groups=groups)


def _subsample(w: dict, arch: dict, feats: torch.Tensor, p: Products) -> torch.Tensor:
    pre = "encoder.subsample."
    x = torch.relu(_conv2d(p, feats[None, None], w[pre + "conv0.weight"], w[pre + "conv0.bias"],
                           2, 1))
    for i in range(arch["subsampling_stages"] - 1):
        x = _conv2d(p, x, w[f"{pre}dw.{i}.weight"], w[f"{pre}dw.{i}.bias"], 2, 1, x.shape[1])
        x = torch.relu(_conv2d(p, x, w[f"{pre}pw.{i}.weight"], w[f"{pre}pw.{i}.bias"]))
    _, c, t, f = x.shape
    x = p.linear(x[0].permute(1, 0, 2).reshape(t, c * f), w[pre + "out.weight"],
                 w[pre + "out.bias"])
    return x * math.sqrt(arch["d_model"]) if arch["xscaling"] else x


def relative_encoding(t: int, d: int, device) -> torch.Tensor:
    """[2t - 1, d]: sin (even channels) and cos (odd) of the relative
    positions t-1, t-2, ..., -(t-1)."""
    pe = torch.zeros(2 * t - 1, d, device=device)
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's ``rel_shift`` of [H, T, 2T-1]: pad a zero column in front,
    view as [H, 2T, T], drop the first row, view back."""
    h, t, w = x.shape
    x = F.pad(x, (1, 0)).view(h, w + 1, t)
    return x[:, 1:].reshape(h, t, w)


def _ffn(w, pre, x, p):
    y = F.silu(p.linear(x, w[pre + "fc1.weight"], w[pre + "fc1.bias"]))
    return p.linear(y, w[pre + "fc2.weight"], w[pre + "fc2.bias"])


def _rel_attention(w, pre, x, arch, p):
    t, d = x.shape
    h = arch["n_heads"]
    dk = d // h

    def proj(name):
        return p.linear(x, w[f"{pre}{name}.weight"], w[f"{pre}{name}.bias"]).view(t, h, dk)

    q, k, v = proj("q"), proj("k"), proj("v")
    pos = p.linear(relative_encoding(t, d, x.device), w[pre + "pos.weight"]).view(2 * t - 1, h, dk)
    ac = p.matmul((q + w[pre + "pos_bias_u"]).transpose(0, 1), k.permute(1, 2, 0))  # [H, T, T]
    bd = p.matmul((q + w[pre + "pos_bias_v"]).transpose(0, 1), pos.permute(1, 2, 0))
    bd = rel_shift(bd)[:, :, :t]
    weights = torch.softmax((ac + bd) / math.sqrt(dk), dim=-1)
    o = p.matmul(weights, v.transpose(0, 1)).transpose(0, 1).reshape(t, d)
    return p.linear(o, w[pre + "o.weight"], w[pre + "o.bias"])


def _conv_module(w, pre, x, arch, p):
    y = F.glu(p.linear(x, w[pre + "pw1.weight"], w[pre + "pw1.bias"]), dim=-1)  # [T, D]
    k = arch["conv_kernel_size"]
    y = F.conv1d(p.r(y.t()[None]), p.r(w[pre + "dw.weight"]), w[pre + "dw.bias"],
                 padding=k // 2, groups=y.shape[1])[0].t()
    y = ((y - w[pre + "bn.running_mean"]) * torch.rsqrt(w[pre + "bn.running_var"]
                                                         + arch["batch_norm_eps"])
         * w[pre + "bn.weight"] + w[pre + "bn.bias"])
    return p.linear(F.silu(y), w[pre + "pw2.weight"], w[pre + "pw2.bias"])


@torch.no_grad()
def encode(w: dict, arch: dict, audio: torch.Tensor, p: Products) -> torch.Tensor:
    """audio [N] float32 (the clip's samples) -> memory [T, D]."""
    eps = arch["layer_norm_eps"]

    def ln(name, x):
        return layer_norm(x, w[name + ".weight"], w[name + ".bias"], eps)

    with float32_products():
        x = _subsample(w, arch, features(audio, arch, p), p)
        for i in range(arch["encoder_layers"]):
            pre = f"encoder.layers.{i}."
            x = x + 0.5 * _ffn(w, pre + "ff1.", ln(pre + "ff1_norm", x), p)
            x = x + _rel_attention(w, pre + "attn.", ln(pre + "attn_norm", x), arch, p)
            x = x + _conv_module(w, pre + "conv.", ln(pre + "conv_norm", x), arch, p)
            x = x + 0.5 * _ffn(w, pre + "ff2.", ln(pre + "ff2_norm", x), p)
            x = ln(pre + "out_norm", x)
    return x


@torch.no_grad()
def attention_probe(w: dict, arch: dict, audio: torch.Tensor, p: Products,
                    pos_scale: float) -> torch.Tensor:
    """The first encoder layer's relative-position attention [T, D] over its
    own input (the stem, then half the first feed-forward), its position
    projection scaled by ``pos_scale``."""
    eps = arch["layer_norm_eps"]
    pre = "encoder.layers.0."
    w = dict(w, **{pre + "attn.pos.weight": w[pre + "attn.pos.weight"] * pos_scale})

    def ln(name, x):
        return layer_norm(x, w[name + ".weight"], w[name + ".bias"], eps)

    with float32_products():
        x = _subsample(w, arch, features(audio, arch, p), p)
        x = x + 0.5 * _ffn(w, pre + "ff1.", ln(pre + "ff1_norm", x), p)
        return _rel_attention(w, pre + "attn.", ln(pre + "attn_norm", x), arch, p)


# -- decoder -----------------------------------------------------------------

def absolute_encoding(n: int, d: int, device) -> torch.Tensor:
    """[n, d]: sin (even channels) and cos (odd) of positions 0 .. n-1,
    over sqrt(d)."""
    pe = torch.zeros(n, d, device=device)
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe / math.sqrt(d)


@torch.no_grad()
def forced_logits(w: dict, arch: dict, memory: torch.Tensor, tokens: torch.Tensor,
                  p: Products, kv_int8: bool) -> torch.Tensor:
    """Decoder logits [S, V] over ``tokens`` [S] (the prompt first)
    attending to ``memory`` [T, D]: row i scores the token after
    ``tokens[i]``."""
    eps, h = arch["layer_norm_eps"], arch["n_heads"]
    d = memory.shape[1]
    hd = d // h
    s, t = tokens.shape[0], memory.shape[0]
    kv = int8_columns if kv_int8 else (lambda x: x)

    def ln(name, x):
        return layer_norm(x, w[name + ".weight"], w[name + ".bias"], eps)

    def proj(name, x, n):
        return p.linear(x, w[name + ".weight"], w[name + ".bias"]).view(n, h, hd)

    with float32_products():
        x = w["decoder.embed"][tokens] + absolute_encoding(s, d, memory.device)
        x = ln("decoder.embed_norm", x)
        for i in range(arch["decoder_layers"]):
            pre = f"decoder.layers.{i}."
            y = ln(pre + "ln1", x)
            a = pre + "self_attn."
            o = attention(p, proj(a + "q", y, s), kv(proj(a + "k", y, s)),
                          kv(proj(a + "v", y, s)), causal=True).reshape(s, d)
            x = x + p.linear(o, w[a + "o.weight"], w[a + "o.bias"])
            a = pre + "cross_attn."
            o = attention(p, proj(a + "q", ln(pre + "ln2", x), s), kv(proj(a + "k", memory, t)),
                          kv(proj(a + "v", memory, t))).reshape(s, d)
            x = x + p.linear(o, w[a + "o.weight"], w[a + "o.bias"])
            y = torch.relu(p.linear(ln(pre + "ln3", x), w[pre + "mlp.fc1.weight"],
                                    w[pre + "mlp.fc1.bias"]))
            x = x + p.linear(y, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"])
        x = ln("decoder.norm", x)
        return p.linear(x, w["decoder.embed"], w["decoder.head.bias"])
