"""Silero-style voice-activity model, in PyTorch.

Counterpart of the JAX package's ``models/vad.py``.  Two models:

- the random-weight model that ``Transcriber`` loads by default:
  512-sample hops at 16 kHz with 64 samples of leading context, an
  STFT-magnitude frontend (a DFT-basis convolution), four strided conv
  blocks, a 128-wide LSTM cell and a sigmoid head, one speech probability
  per hop.  The conv stack runs batched over every hop of an update; the
  LSTM recurrence is a Python loop over hops where JAX uses ``lax.scan``;
- ``TinyVad``, the real-weight TinyVadCNN of an ONNX export (a binary
  speech classifier over a ``[B, 1, 32, 16]`` streaming log-mel window,
  one 512-sample hop per frame), run by the port's ONNX interpreter
  (``ops/onnx_graph.py``), batched over hops and streams.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.mel import mel_columns
from ..ops.onnx_graph import execute
from .layers import Conv1d, Dense, conv_same, dense, dense_init

SAMPLE_RATE = 16000
HOP_SIZE = 512
CONTEXT_SAMPLES = 64
STATE_WIDTH = 128

_N_FFT = 256
_STFT_HOP = 128
_N_BINS = _N_FFT // 2 + 1
_CHANNELS = [(_N_BINS, 128), (128, 64), (64, 64), (64, 128)]


class VadState(NamedTuple):
    """Recurrent state: LSTM (h, c) plus the 64-sample audio context."""

    h: torch.Tensor  # [B, 128]
    c: torch.Tensor  # [B, 128]
    context: torch.Tensor  # [B, 64] trailing samples of the previous hop


class Lstm(nn.Module):
    def __init__(self, wi: Dense, wh: Dense):
        super().__init__()
        self.wi, self.wh = wi, wh


class Vad(nn.Module):
    """Parameters: the fixed ``stft`` basis ``[2*bins, 1, n_fft]``, four
    ``enc`` convolutions, the ``lstm`` cell and the ``head``."""

    def __init__(self, stft: Conv1d, enc: list[Conv1d], lstm: Lstm, head: Dense):
        super().__init__()
        self.stft = stft
        self.enc = nn.ModuleList(enc)
        self.lstm = lstm
        self.head = head


def init_state(batch: int = 1, dtype=torch.float32, device=None) -> VadState:
    device = resolve_device(device)
    z = lambda n: torch.zeros((batch, n), dtype=dtype, device=device)  # noqa: E731
    return VadState(h=z(STATE_WIDTH), c=z(STATE_WIDTH), context=z(CONTEXT_SAMPLES))


def _dft_basis() -> np.ndarray:
    """Real-DFT magnitude basis as a JAX conv kernel [n_fft, 1, 2*n_bins]."""
    n = _N_FFT
    t = np.arange(n)
    k = np.arange(_N_BINS)
    cos = np.cos(2 * np.pi * np.outer(t, k) / n)
    sin = -np.sin(2 * np.pi * np.outer(t, k) / n)
    basis = np.concatenate([cos, sin], axis=1)  # [n, 2*bins]
    window = np.hanning(n)[:, None]
    return (basis * window)[:, None, :].astype(np.float32)


def init_params(generator: torch.Generator, device=None) -> Vad:
    """Random weights from ``generator``, on ``device`` (CUDA unless named)."""
    def conv_init(k, cin, cout):
        scale = (1.0 / (cin * k)) ** 0.5
        w = torch.empty((cout, cin, k)).uniform_(-scale, scale, generator=generator)
        return Conv1d(w, torch.zeros(cout))

    stft = Conv1d(torch.from_numpy(_dft_basis()).permute(2, 1, 0).contiguous())
    model = Vad(
        stft,
        [conv_init(3, cin, cout) for cin, cout in _CHANNELS],
        Lstm(dense_init(generator, 128, 4 * STATE_WIDTH),
             dense_init(generator, STATE_WIDTH, 4 * STATE_WIDTH, bias=False)),
        dense_init(generator, STATE_WIDTH, 1),
    )
    return model.to(resolve_device(device))


def _features(p: Vad, frames: torch.Tensor) -> torch.Tensor:
    """[B, 576] windowed hop -> [B, T', bins] log-magnitude STFT."""
    y = F.conv1d(frames[:, None, :], p.stft.weight, stride=_STFT_HOP).transpose(1, 2)
    re, im = torch.chunk(y, 2, dim=-1)
    return torch.log1p(torch.sqrt(re * re + im * im + 1e-9))


def _encoder(p: Vad, feats: torch.Tensor) -> torch.Tensor:
    """Conv stack collapsing the frame axis -> [B, 128]."""
    h = feats.transpose(1, 2)  # [B, C, T']
    for i, conv in enumerate(p.enc):
        h = torch.relu(conv_same(h, conv, 2 if i < 2 else 1))
    return h.mean(dim=-1)


def _lstm_cell(p: Lstm, x, h, c):
    gates = dense(p.wi, x) + dense(p.wh, h)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


@torch.inference_mode()
def predict_hop(p: Vad, hop: torch.Tensor, state: VadState) -> tuple[torch.Tensor, VadState]:
    """One 512-sample hop [B, 512] -> (probability [B], new state)."""
    frames = torch.cat([state.context, hop], dim=-1)  # [B, 576]
    enc = _encoder(p, _features(p, frames))
    h, c = _lstm_cell(p.lstm, enc, state.h, state.c)
    prob = torch.sigmoid(dense(p.head, h))[..., 0]
    return prob, VadState(h=h, c=c, context=hop[..., -CONTEXT_SAMPLES:])


@torch.inference_mode()
def predict_hops(p: Vad, hops: torch.Tensor, state: VadState) -> tuple[torch.Tensor, VadState]:
    """All hops of an update in one call: [B, H, 512] -> ([B, H], state)."""
    b, n_hops, _ = hops.shape
    # Per-hop context comes from the previous hop's tail (first hop: state).
    prev_tails = torch.cat([state.context[:, None, :], hops[:, :-1, -CONTEXT_SAMPLES:]], dim=1)
    frames = torch.cat([prev_tails, hops], dim=-1)  # [B, H, 576]
    enc = _encoder(p, _features(p, frames.reshape(b * n_hops, -1)))
    enc = enc.reshape(b, n_hops, STATE_WIDTH)
    h, c = state.h, state.c
    probs = []
    for i in range(n_hops):
        h, c = _lstm_cell(p.lstm, enc[:, i], h, c)
        probs.append(torch.sigmoid(dense(p.head, h))[..., 0])
    return torch.stack(probs, dim=1), VadState(h=h, c=c, context=hops[:, -1, -CONTEXT_SAMPLES:])


# =========================================================================
# Real-weight path: TinyVadCNN from an ONNX export (the reference's
# micro/models/tinyvad_cnn_speech_mel.onnx: input ``log_mel`` [B, 1, 32,
# 16], output one speech logit per window; run once per 32 ms hop).
# =========================================================================

TINYVAD_N_MELS = 32
TINYVAD_WINDOW_FRAMES = 16


class TinyVadState(NamedTuple):
    """Ring of the previous window_frames-1 log-mel columns, initialised to
    log(eps) silence."""

    cols: torch.Tensor  # [B, 15, 32]


class TinyVad:
    """TinyVadCNN with real weights, batched over hops AND streams: mel
    columns for every hop (one product), sliding 16-frame windows (a
    strided view), per-window standardisation, one batched CNN pass."""

    def __init__(self, graph, device: str | torch.device | None = None):
        self.graph = graph
        self.device = resolve_device(device)
        (self._input_name, _), = graph.inputs

    @classmethod
    def from_onnx(cls, path: str, device: str | torch.device | None = None) -> "TinyVad":
        from ..core.onnx_io import load_onnx

        return cls(load_onnx(path), device)

    def init_state(self, batch: int = 1) -> TinyVadState:
        log_eps = float(np.log(1e-6))
        return TinyVadState(cols=torch.full(
            (batch, TINYVAD_WINDOW_FRAMES - 1, TINYVAD_N_MELS), log_eps,
            dtype=torch.float32, device=self.device))

    def _run(self, hops: torch.Tensor, cols: torch.Tensor):
        """(probs [B, H], the column ring extended by every hop [B, 15+H, 32])."""
        b, n_hops, _ = hops.shape
        full = torch.cat([cols, mel_columns(hops)], dim=1)  # [B, 15+H, 32]
        win = TINYVAD_WINDOW_FRAMES
        x = full.unfold(1, win, 1)  # [B, H, 32 mels, 16 frames]
        mean = x.mean(dim=(2, 3), keepdim=True)
        std = x.std(dim=(2, 3), keepdim=True, correction=1)
        x = (x - mean) / torch.clamp(std, min=1e-3)
        x = x.reshape(b * n_hops, 1, TINYVAD_N_MELS, win)
        logit = execute(self.graph, {self._input_name: x})[0]  # [B*H, 1]
        return torch.sigmoid(logit).reshape(b, n_hops), full

    @torch.inference_mode()
    def predict_hops(self, hops: torch.Tensor,
                     state: TinyVadState) -> tuple[torch.Tensor, TinyVadState]:
        """[B, H, 512] hops -> ([B, H] speech probabilities, new state)."""
        probs, full = self._run(hops, state.cols)
        return probs, TinyVadState(cols=full[:, -(TINYVAD_WINDOW_FRAMES - 1):].contiguous())

    @torch.inference_mode()
    def predict_hops_masked(self, hops: torch.Tensor, n_valid,
                            state: TinyVadState) -> tuple[torch.Tensor, TinyVadState]:
        """[B, H, 512] padded hops with per-stream valid counts [B].

        probs[b, i] is meaningful for i < n_valid[b]; each stream's ring
        advances by exactly its valid count: the 15 columns from row
        n_valid of the extended ring, the start clamped to [0, H] as JAX's
        ``dynamic_slice`` clamps it."""
        probs, full = self._run(hops, state.cols)
        n_hops = hops.shape[1]
        keep = TINYVAD_WINDOW_FRAMES - 1
        start = torch.as_tensor(n_valid, device=full.device).long().clamp(0, n_hops)
        rows = start[:, None] + torch.arange(keep, device=full.device)[None, :]
        cols = full.gather(1, rows[..., None].expand(-1, -1, TINYVAD_N_MELS))
        return probs, TinyVadState(cols=cols)

    def hop_prob_fn(self):
        """Stateful [H, 512] -> [H] closure for pipeline.VadSegmenter."""
        state = self.init_state(1)

        def fn(hops: np.ndarray) -> np.ndarray:
            nonlocal state
            x = torch.from_numpy(np.asarray(hops, np.float32))[None].to(self.device)
            probs, state = self.predict_hops(x, state)
            return probs[0].cpu().numpy()

        return fn
