"""Plain reference of the Moonshine streaming model and of the always-voice
service schedule that feeds it.

The model, as the reference's ``MoonshineStreamingModel`` defines it
(``core/moonshine-streaming-model.{h,cpp}``):

- frontend, strictly causal: each 80-sample frame and the 79 samples
  before it (zeros before the segment) through a dense layer and GELU, two
  causal convolutions of 5 taps with GELU, a layer norm;
- encoder, a sliding-window re-encode: each pass takes the window of 256
  feature frames from ``enc_emitted - 16 * depth`` (at least 0), its keys
  masked past the features received, a dense input projection, pre-LN
  layers of rotary self-attention (positions relative to the window) and a
  GELU MLP (4x), a final norm; the pass emits up to 128 rows from window
  row ``min(enc_emitted - window start, 128)``;
- adapter: a dense projection plus an absolute sinusoidal position (sines
  then cosines) and a layer norm, appended to the memory;
- decoder: that of ``reference/moonshine.py`` over the memory.

The schedule (``ServiceSchedule``) follows the always-voice service
contract: a stream's audio fills segments of at most
``max_segment_seconds``; each update takes up to ``update_frames`` whole
frames of the current segment into the model, and a segment whose audio
is complete finalizes at the first decoding update that leaves less than
a frame pending; every update runs as many encoder passes as the largest
backlog of its slots needs, each pass emitting up to 128 stable frames of
every slot (all frames on its final update, else all but 16).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from .numerics import Products, attention, int8_columns, layer_norm, rotary

SAMPLE_CTX = 79
ENC_WIN = 256
ENC_STEP = 128
LOOKAHEAD_KEY = "total_lookahead"


@torch.no_grad()
def features(w: dict, arch: dict, audio: torch.Tensor, p: Products) -> torch.Tensor:
    """Feature frames [n, c2] of one segment's samples ``audio`` [N]."""
    fl = arch["frame_len"]
    n = audio.shape[0] // fl
    x = torch.cat([audio.new_zeros(SAMPLE_CTX), audio[:n * fl].float()])
    windows = x.unfold(0, SAMPLE_CTX + fl, fl)[:n]  # [n, 159]
    h = F.gelu(p.linear(windows, w["frontend.proj.weight"], w["frontend.proj.bias"]))
    for conv in ("conv1", "conv2"):
        wt = w[f"frontend.{conv}.weight"]
        padded = F.pad(h.t()[None], (wt.shape[-1] - 1, 0))  # causal: 4 frames of zeros
        h = F.gelu(p.conv1d(padded, wt, w[f"frontend.{conv}.bias"], 1))[0].t()
    return layer_norm(h, w["frontend.norm.weight"])


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, device=pos.device))
                      * torch.arange(half, device=pos.device) / half)
    ang = pos.float()[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@torch.no_grad()
def encode_pass(w: dict, arch: dict, feats: torch.Tensor, feat_count: int, enc_emitted: int,
                mem_len: int, n_new: int, p: Products) -> torch.Tensor:
    """The ``n_new`` memory rows [n_new, decoder_dim] one pass appends."""
    left = 16 * arch["depth"]
    start = max(enc_emitted - left, 0)
    valid = min(feat_count - start, ENC_WIN)
    rel = min(max(enc_emitted - start, 0), ENC_WIN - ENC_STEP)
    if rel + n_new > valid:
        raise ValueError("a pass would emit rows past the window's valid frames")
    heads, hd = arch["nheads"], arch["head_dim"]
    h = p.linear(feats[start:start + valid], w["encoder.in_proj.weight"],
                 w["encoder.in_proj.bias"])
    pos = torch.arange(valid, device=feats.device)
    for i in range(arch["depth"]):
        pre = f"encoder.layers.{i}."
        x = layer_norm(h, w[pre + "ln1.weight"])
        q = rotary(p.linear(x, w[pre + "attn.q.weight"]).view(valid, heads, hd), pos, hd,
                   arch["rope_theta"])
        k = rotary(p.linear(x, w[pre + "attn.k.weight"]).view(valid, heads, hd), pos, hd,
                   arch["rope_theta"])
        v = p.linear(x, w[pre + "attn.v.weight"]).view(valid, heads, hd)
        h = h + p.linear(attention(p, q, k, v).reshape(valid, -1), w[pre + "attn.o.weight"])
        x = layer_norm(h, w[pre + "ln2.weight"])
        x = F.gelu(p.linear(x, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"]))
        h = h + p.linear(x, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"])
    h = layer_norm(h, w["encoder.norm.weight"])
    block = h[rel:rel + n_new]
    mem = p.linear(block, w["adapter.proj.weight"], w["adapter.proj.bias"])
    mem = mem + _sinusoid(mem_len + torch.arange(n_new, device=h.device), mem.shape[-1])
    return layer_norm(mem, w["adapter.norm.weight"])


def decoder_dims(arch: dict) -> dict:
    hd = arch["head_dim"]
    return {"layers": arch["depth"], "heads": arch["nheads"], "head_dim": hd,
            "rotary_dim": hd - hd % 2, "theta": arch["rope_theta"], "eps": 1e-5}


@torch.no_grad()
def segment_memory(w: dict, arch: dict, audio: torch.Tensor, passes: list,
                   p: Products) -> torch.Tensor:
    """The memory [mem_len, decoder_dim] a segment's ``passes`` ((feat_count,
    enc_emitted, mem_len, n_new) of each pass that emitted frames) build
    from its samples ``audio``."""
    feats = features(w, arch, audio, p)
    rows = [encode_pass(w, arch, feats, fc, ee, ml, n, p) for fc, ee, ml, n in passes]
    return torch.cat(rows) if rows else feats.new_zeros((0, arch["decoder_dim"]))


# -- the service's always-voice schedule --------------------------------------------

@dataclass
class Segment:
    slot: int
    segment_id: int
    start_sample: int  # in the slot's stream
    samples: int = 0  # fed into the model so far
    passes: list = field(default_factory=list)  # (feat_count, enc_emitted, mem_len, n_new)
    final: bool = False
    final_update: int | None = None  # index of the update that finalized it
    # update index -> (memory rows, token cap) of each update that decoded it
    decoded_at: dict = field(default_factory=dict)


@dataclass
class _SlotSim:
    stream_samples: int = 0  # routed into segments so far
    raw: int = 0  # received, not yet routed
    pending: int = 0  # routed into the current segment, not yet fed
    final_queued: bool = False
    needs_reset: bool = True
    feat: int = 0
    enc: int = 0
    mem: int = 0
    segment: Segment | None = None
    next_id: int = 0


class ServiceSchedule:
    """The schedule of every slot of an always-voice service, from the
    audio each slot receives and the updates each cohort runs."""

    def __init__(self, arch: dict, n_slots: int, update_frames: int,
                 max_segment_seconds: float, tokens_per_second: float):
        self.arch = arch
        self.fl = arch["frame_len"]
        self.F = update_frames
        self.cap = int(max_segment_seconds * 16000)
        self.tps = tokens_per_second
        self.slots = [_SlotSim() for _ in range(n_slots)]
        self.segments: list[Segment] = []
        self.updates = 0

    def _fill(self, i: int) -> None:
        s = self.slots[i]
        if s.final_queued or s.raw == 0:
            return
        if s.segment is None:
            s.segment = Segment(i, s.next_id, s.stream_samples)
            s.next_id += 1
            self.segments.append(s.segment)
        room = self.cap - (s.segment.samples + s.pending)
        take = min(s.raw, max(room, 0))
        s.pending += take
        s.stream_samples += take
        s.raw -= take
        if s.raw > 0:
            s.final_queued = True

    def add_audio(self, i: int, n: int) -> None:
        self.slots[i].raw += n
        self._fill(i)

    def update(self, cohort: list[int], decode_tick: bool = True) -> list[Segment]:
        """One update of the slots ``cohort``; returns the segments it
        finalized."""
        fl = self.fl
        is_final, decoding = {}, {}
        for i in cohort:
            s = self.slots[i]
            seg = s.segment
            is_final[i] = False
            if seg is None or (s.pending == 0 and not s.final_queued and seg.samples == 0):
                continue
            nf = min(s.pending // fl, self.F)
            if s.needs_reset and (nf > 0 or s.final_queued):
                s.needs_reset, s.feat, s.enc, s.mem = False, 0, 0, 0
            if nf:
                s.pending -= nf * fl
                seg.samples += nf * fl
                s.feat += nf
            is_final[i] = s.final_queued and s.pending < fl and decode_tick
            if decode_tick and seg.samples > 0 and (nf > 0 or is_final[i]):
                decoding[i] = min(int(self.tps * seg.samples / 16000.0) + 1,
                                  self.arch["max_seq_len"] - 2)
        la = self.arch[LOOKAHEAD_KEY]
        passes = max([1] + [-(-max(self.slots[i].feat - (0 if is_final[i] else la)
                                   - self.slots[i].enc, 0) // ENC_STEP) for i in cohort])
        for _ in range(passes):
            for i in cohort:
                s = self.slots[i]
                stable = max(s.feat - (0 if is_final[i] else la), 0)
                n_new = min(max(stable - s.enc, 0), ENC_STEP)
                if n_new and s.segment is not None:
                    s.segment.passes.append((s.feat, s.enc, s.mem, n_new))
                s.enc += n_new
                s.mem += n_new
        for i, budget in decoding.items():
            self.slots[i].segment.decoded_at[self.updates] = (self.slots[i].mem, budget)
        done = []
        for i in cohort:
            if is_final[i]:
                s = self.slots[i]
                s.segment.final, s.segment.final_update = True, self.updates
                done.append(s.segment)
                s.segment, s.final_queued, s.needs_reset = None, False, True
                self._fill(i)
        self.updates += 1
        return done


@torch.no_grad()
def forced_logits(w: dict, arch: dict, memory: torch.Tensor, tokens: torch.Tensor,
                  p: Products, kv_int8: bool) -> torch.Tensor:
    from .moonshine import forced_logits as decoder_logits

    return decoder_logits(w, decoder_dims(arch), memory, tokens, p, kv_int8)


__all__ = ["ServiceSchedule", "Segment", "features", "encode_pass", "segment_memory",
           "forced_logits", "int8_columns"]
