"""Neural diphone/word-unit TTS from the reference's shipped voice pack.

The reference ships REAL trained neural-TTS weights in-tree as a flash
voice pack — 1.9 MB of diphone/word RVQ code streams, int8 codebooks, an
s16x8 TFLite decoder and WORLD-lite prosody metadata (reference pack
format: micro/neural-tts/include/neural_tts/pack_format.h:46-196; engine:
micro/neural-tts/src/neural_tts.cc; the pack artifact:
micro/examples/rp2350/generated/neural_tts_pack.bin).  This module runs
that published voice on the GPU (counterpart of the JAX package's
``tts/neural_pack.py``; the host planning is a copy of its numpy code):

- the pack is parsed with numpy (data reuse of the shipped artifact,
  like core/tokenizer.py for tokenizer.bin);
- the RVQ decoder graph is executed dequantized-to-float on ``device`` in
  ONE batched call over all tiles (ops/tflite_graph.py) instead of the
  MCU's lazy per-tile TFLM invokes;
- unit selection / prosody / track assembly are host-side planning math
  (Viterbi over ≤8 candidates — control logic, not FLOPs);
- rendering is the batched-pulse WORLD-lite vocoder (tts/worldlite.py).

Divergences from the reference MCU engine, all documented where they
occur: no 400-frame chunking (no 340 KiB arena here — one whole-utterance
plan), float instead of s16x8 quantized arithmetic (closer to the
originally trained model), and torch.Generator vocoder noise (other
samples than the JAX package's PRNG, tts/worldlite.py).

The pack is not in this repository: ``REFERENCE_PACK`` lies under
``$MOONSHINE_REFERENCE_ROOT`` (default ``~/reference``), and without it
``NeuralPackTTS()`` raises ``FileNotFoundError``.

Front end: IPA tokens come from the same baked artifacts the rest of the
repo uses (tts/g2p_dict.py + the rules engine); the pack-token rewrite
table and Klatt-rule durations are re-derived from
micro/g2p/src/ipa_tokens.cc:24-76 and micro/klatt-tts/src/
{phonemes.cc:22-74, synth_internal.cc:75-174, config.h defaults}
(linguistic/timing constants, declared reference data).
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from . import worldlite

REFERENCE_PACK = (Path(os.environ.get("MOONSHINE_REFERENCE_ROOT", Path.home() / "reference"))
                  / "micro" / "examples" / "rp2350" / "generated" / "neural_tts_pack.bin")

LN10 = math.log(10.0)
F0_BASE_HZ = 55.0
F0_STEPS_PER_OCTAVE = 48.0
UNIT_GAIN_STEP = 1.0 / 64.0
LOUD_KNOTS = 8
EDGE_BANDS = 8
MAX_UNIT_FRAMES = 272

# Host-reference selection weights (neural_tts.cc:64-71).
W_JOIN, W_DUR, W_CTX = 5.0, 0.3, 0.3
XFADE_HW = 3
TIMBRE_NORM = 0.3
W_WORD_DUR, W_WORD_F0, WORD_REUSE = 2.0, 1.0, 0.5
CAP = 8

# Loudness plan constants (neural_tts.cc:109-115).
LOUD_FLOOR_DROP, LOUD_GATE_DROP, LOUD_MAX_BOOST = 0.6, 3.5, 2.0
LOUD_SMOOTH_HW, LOUD_REF_HW, LOUD_SILENT = 12, 2, -1000.0


# ---------------------------------------------------------------------------
# Pack parsing (pack_format.h wire layout, version 3)


@dataclass
class Pack:
    raw: bytes
    # header
    median_f0: float
    default_gain: float
    n_phones: int
    sil_id: int
    dot_id: int
    gap_id: int
    k: tuple[int, int, int]
    latent_dim: int
    tile_latents: int
    tile_hop: int
    input_scale: float
    output_scale: float
    model: bytes
    codebooks: list[np.ndarray]  # float [k, dim] (int8 * per-dim scale)
    dtypes: np.ndarray  # structured DiphoneTypeRec
    dunits: np.ndarray  # structured DiphoneUnitRec
    wunits: np.ndarray  # structured WordUnitRec
    wkeys: bytes
    centroids: np.ndarray  # [n_dtypes, 48] float ln(benv)
    edge_scale: float
    codes_base: int
    f0_base: int
    phones: list[str]
    dur_ratio: np.ndarray
    phone_class: np.ndarray
    func_keys: set[bytes]
    prosody_dur: np.ndarray  # [8]
    prosody_f0: np.ndarray
    prosody_energy: np.ndarray
    energy_base: float
    loud_scale: float

    @property
    def phone_id(self) -> dict[str, int]:
        return {p: i for i, p in enumerate(self.phones)}


_DTYPE_REC = np.dtype([
    ("a", "u1"), ("b", "u1"), ("n_units", "u1"), ("pad", "u1"),
    ("first_unit", "<u2"), ("pad2", "<u2"),
])
_DUNIT_REC = np.dtype([
    ("n_frames", "<u2"), ("cut", "<u2"), ("prev", "i1"), ("next", "i1"),
    ("f0med_q", "u1"), ("gain_q", "i1"), ("score", "<f4"),
    ("codes_off", "<u4"), ("f0_off", "<u4"),
    ("edge_head", "i1", (EDGE_BANDS,)), ("edge_tail", "i1", (EDGE_BANDS,)),
    ("loud", "i1", (LOUD_KNOTS,)),
])
_WUNIT_REC = np.dtype([
    ("key_off", "<u4"), ("codes_off", "<u4"), ("f0_off", "<u4"),
    ("n_frames", "<u2"), ("f0med_q", "u1"), ("gain_q", "i1"),
    ("loud", "i1", (LOUD_KNOTS,)),
])


@lru_cache(maxsize=2)
def load_pack(path: str | None = None) -> Pack:
    p = Path(path) if path else REFERENCE_PACK
    b = p.read_bytes()
    off = [0]

    def u32():
        v = struct.unpack_from("<I", b, off[0])[0]
        off[0] += 4
        return v

    def f32():
        v = struct.unpack_from("<f", b, off[0])[0]
        off[0] += 4
        return v

    magic, version, total = u32(), u32(), u32()
    if magic != 0x3150544E or version != 3:
        raise ValueError(f"bad pack magic/version {magic:#x}/{version}")
    median_f0, default_gain = f32(), f32()
    n_phones, sil_id, dot_id, gap_id, n_stages = (u32() for _ in range(5))
    k = tuple(u32() for _ in range(3))
    latent_dim, tile_latents, tile_hop = u32(), u32(), u32()
    input_scale, output_scale = f32(), f32()
    model_off, model_size = u32(), u32()
    cb_off = [u32() for _ in range(3)]
    cb_scale_off = [u32() for _ in range(3)]
    n_dtypes, dtype_off, n_dunits, dunit_off = u32(), u32(), u32(), u32()
    n_words, wunit_off, wkeys_off, centroid_off = u32(), u32(), u32(), u32()
    edge_scale, centroid_scale = f32(), f32()
    codes_off, f0_off, phones_off, dur_ratio_off, phone_class_off = (
        u32(), u32(), u32(), u32(), u32(),
    )
    n_func, func_idx_off, func_blob_off = u32(), u32(), u32()
    prosody_dur = np.frombuffer(b, "<f4", 8, off[0]).copy(); off[0] += 32
    prosody_f0 = np.frombuffer(b, "<f4", 8, off[0]).copy(); off[0] += 32
    prosody_energy = np.frombuffer(b, "<f4", 8, off[0]).copy(); off[0] += 32
    energy_base, loud_scale = f32(), f32()

    codebooks = []
    for s in range(n_stages):
        cb = np.frombuffer(b, np.int8, k[s] * latent_dim, cb_off[s])
        sc = np.frombuffer(b, "<f4", latent_dim, cb_scale_off[s])
        codebooks.append(
            cb.reshape(k[s], latent_dim).astype(np.float32) * sc[None, :]
        )
    dtypes = np.frombuffer(b, _DTYPE_REC, n_dtypes, dtype_off)
    dunits = np.frombuffer(b, _DUNIT_REC, n_dunits, dunit_off)
    wunits = np.frombuffer(b, _WUNIT_REC, n_words, wunit_off)
    centroids = (
        np.frombuffer(b, np.int8, n_dtypes * 48, centroid_off)
        .reshape(n_dtypes, 48).astype(np.float32) * centroid_scale
    )
    phones = [
        b[phones_off + i * 8 : phones_off + i * 8 + 8].split(b"\0")[0].decode()
        for i in range(n_phones)
    ]
    dur_ratio = np.frombuffer(b, "<f4", n_phones, dur_ratio_off).copy()
    phone_class = np.frombuffer(b, np.uint8, n_phones, phone_class_off).copy()
    func_idx = np.frombuffer(b, "<u2", n_func, func_idx_off)
    func_keys = set()
    for fi in func_idx:
        fk = b[func_blob_off + fi :]
        func_keys.add(bytes(fk[1 : 1 + fk[0]]))

    return Pack(
        raw=b, median_f0=median_f0, default_gain=default_gain,
        n_phones=n_phones, sil_id=sil_id, dot_id=dot_id, gap_id=gap_id,
        k=k, latent_dim=latent_dim, tile_latents=tile_latents,
        tile_hop=tile_hop, input_scale=input_scale, output_scale=output_scale,
        model=b[model_off : model_off + model_size],
        codebooks=codebooks, dtypes=dtypes, dunits=dunits, wunits=wunits,
        wkeys=b[wkeys_off:], centroids=centroids, edge_scale=edge_scale,
        codes_base=codes_off, f0_base=f0_off, phones=phones,
        dur_ratio=dur_ratio, phone_class=phone_class, func_keys=func_keys,
        prosody_dur=prosody_dur, prosody_f0=prosody_f0,
        prosody_energy=prosody_energy, energy_base=energy_base,
        loud_scale=loud_scale,
    )


def f0_from_code(q: int) -> float:
    return 0.0 if q == 0 else F0_BASE_HZ * 2.0 ** (q / F0_STEPS_PER_OCTAVE)


def decode_f0_stream(buf: bytes, n_frames: int) -> np.ndarray:
    """Per-unit f0 side stream -> per-frame Hz (0 = unvoiced).

    Stream format per pack_format.h:131-138: u8 n_runs; per run varu8
    gap, varu8 len-1; per run u8 first knot code then signed 4-bit deltas
    (low nibble first, byte-padded), knots at run-local frames 0,4,8,...
    plus the off-grid last frame; piecewise-linear in code space.
    """
    out = np.zeros(n_frames, np.float32)
    pos_b = 0

    def varu8():
        nonlocal pos_b
        v = 0
        while buf[pos_b] == 255:
            v += 255
            pos_b += 1
        v += buf[pos_b]
        pos_b += 1
        return v

    n_runs = buf[pos_b]; pos_b += 1
    runs = []
    fpos = 0
    for _ in range(n_runs):
        fpos += varu8()
        length = varu8() + 1
        runs.append((fpos, length))
        fpos += length
    for start, length in runs:
        n_knots = (length - 1) // 4 + 1
        if (length - 1) % 4 != 0:
            n_knots += 1
        n_knots = min(n_knots, 80)
        cur = buf[pos_b]; pos_b += 1
        codes = [float(cur)]
        nib = buf[pos_b :]
        for kk in range(1, n_knots):
            d = (nib[(kk - 1) >> 1] >> (((kk - 1) & 1) * 4)) & 0xF
            if d >= 8:
                d -= 16
            cur += d
            codes.append(float(cur))
        pos_b += (n_knots - 1 + 1) // 2
        for kk in range(max(n_knots - 1, 1)):
            f0i = 4 * kk
            if kk + 1 < n_knots:
                f1i = min(4 * (kk + 1), length - 1)
            else:
                f1i = f0i
            c0 = codes[kk]
            c1 = codes[kk + 1] if kk + 1 < n_knots else codes[kk]
            span = f1i - f0i
            for f in range(f0i, min(f1i, length - 1) + 1):
                a = (f - f0i) / span if span > 0 else 0.0
                code = c0 + (c1 - c0) * a
                if start + f < n_frames:
                    out[start + f] = F0_BASE_HZ * 2.0 ** (
                        code / F0_STEPS_PER_OCTAVE
                    )
            if kk + 1 >= n_knots:
                break
    return out


def unpack_codes(pk: Pack, codes_off: int, n_latents: int) -> np.ndarray:
    """Bit-packed RVQ code stream -> [n_latents, 3] uint16 (11+10+10 bits)."""
    bits = [max(int(x - 1).bit_length(), 1) for x in pk.k]
    total_bits = n_latents * sum(bits)
    nbytes = (total_bits + 7) // 8
    raw = np.frombuffer(
        pk.raw, np.uint8, nbytes, pk.codes_base + codes_off
    ).astype(np.uint64)
    # little-endian bit stream
    bitarr = ((raw[:, None] >> np.arange(8, dtype=np.uint64)) & 1).reshape(-1)
    out = np.zeros((n_latents, 3), np.uint16)
    pos = 0
    for l in range(n_latents):
        for s in range(3):
            w = bits[s]
            v = 0
            for i in range(w):
                v |= int(bitarr[pos + i]) << i
            pos += w
            out[l, s] = v
    return out


# ---------------------------------------------------------------------------
# IPA tokenizer (re-derivation of micro/g2p/src/ipa_tokens.cc:24-106)

_REWRITES: list[tuple[str, tuple[str, ...]]] = [
    ("eɪ", ("e", "ɪ")), ("ɑɪ", ("ɑ", "ɪ")),
    ("aɪ", ("ɑ", "ɪ")), ("ɑʊ", ("ɑ", "ʊ")),
    ("aʊ", ("ɑ", "ʊ")), ("ɔɪ", ("ɔ", "ɪ")),
    ("oʊ", ("o", "ʊ")), ("əʊ", ("o", "ʊ")),
    ("tʃ", ("t", "ʃ")), ("dʒ", ("d", "ʒ")),
    ("ː", ()), ("ˈ", ("ˈ",)), ("ˌ", ("ˌ",)),
    ("ɡ", ("g",)), ("ɚ", ("ɝ",)), ("ɘ", ("ə",)),
    ("ɐ", ("ʌ",)), ("ɜ", ("ɝ",)), ("ɒ", ("ɔ",)),
    ("ɾ", ("d",)),
    ("ɪ", ("ɪ",)), ("ɛ", ("ɛ",)), ("æ", ("æ",)),
    ("ɑ", ("ɑ",)), ("ɔ", ("ɔ",)), ("ʊ", ("ʊ",)),
    ("ʌ", ("ʌ",)), ("ɝ", ("ɝ",)), ("ə", ("ə",)),
    ("ŋ", ("ŋ",)), ("θ", ("θ",)), ("ð", ("ð",)),
    ("ʃ", ("ʃ",)), ("ʒ", ("ʒ",)), ("ɹ", ("ɹ",)),
    ("a", ("ɑ",)), ("r", ("ɹ",)), ("y", ("j",)), ("g", ("g",)),
    (" ", (" ",)), ("\t", (" ",)), ("\n", (" ",)),
]
_DIRECT_ASCII = set("ieouptbdkmnfvszhwjl")


def tokenize_ipa(ipa: str) -> list[str]:
    out: list[str] = []
    i = 0
    n = len(ipa)
    while i < n:
        matched = False
        for pat, emit in _REWRITES:
            if ipa.startswith(pat, i):
                out.extend(emit)
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        c = ipa[i]
        if c in _DIRECT_ASCII:
            out.append(c)
        i += 1  # unknown codepoints skipped
    return out


# ---------------------------------------------------------------------------
# Duration rules (re-derivation of klatt-tts BuildSegments for the neural
# front end: phone base durations from phonemes.cc:22-74; stop expansion +
# lead/tail from synth_internal.cc:38-174 with the config.h defaults —
# stress/prepausal scales default to 1.0, so only base durations, stop
# sub-segments, and the lead/tail pads matter here)

# ipa -> (class, dur_ms, voiced); classes: v vowel, s stop, n nasal,
# f fricative, a approximant/lateral, sil silence
_PHONE_DUR: dict[str, tuple[str, float, bool]] = {
    "i": ("v", 130, True), "ɪ": ("v", 90, True), "e": ("v", 120, True),
    "ɛ": ("v", 110, True), "æ": ("v", 150, True),
    "ɑ": ("v", 150, True), "ɔ": ("v", 140, True),
    "o": ("v", 120, True), "ʊ": ("v", 90, True), "u": ("v", 130, True),
    "ʌ": ("v", 110, True), "ɝ": ("v", 150, True),
    "ə": ("v", 70, True),
    "p": ("s", 90, False), "b": ("s", 80, True), "t": ("s", 90, False),
    "d": ("s", 80, True), "k": ("s", 90, False), "g": ("s", 80, True),
    "m": ("n", 80, True), "n": ("n", 80, True), "ŋ": ("n", 80, True),
    "f": ("f", 110, False), "v": ("f", 80, True), "θ": ("f", 100, False),
    "ð": ("f", 70, True), "s": ("f", 120, False), "z": ("f", 90, True),
    "ʃ": ("f", 120, False), "ʒ": ("f", 90, True),
    "h": ("f", 70, False),
    "ɹ": ("a", 80, True), "j": ("a", 70, True), "w": ("a", 80, True),
    "l": ("a", 80, True),
    " ": ("sil", 60, False), ".": ("sil", 220, False),
}
_STOP_CLOSURE_VOICED_MS = 61.96
_STOP_CLOSURE_VOICELESS_MS = 55.0
_STOP_BURST_MS = 14.50
_STOP_ASP_MS = 35.17
_LEAD_MS, _TAIL_MS = 40.0, 70.0
_FRAME_MS = 5.0


def build_runs(pk: Pack, tokens: list[str]) -> list[tuple[int, int]]:
    """IPA tokens -> [(pack phone id, rule frames)], merged consecutive.

    Mirrors neural_tts.cc BuildRunsFromPtrs: Klatt segments (with stop
    closure/burst/aspiration expansion) per source token, mapped to pack
    ids, canonicalized ('.' -> sil), merged when consecutive ids match.
    """
    pid_of = pk.phone_id
    segs: list[tuple[int, float]] = [(-1, _LEAD_MS)]  # (token idx, dur_ms)
    for ti, tok in enumerate(tokens):
        if tok in ("ˈ", "ˌ"):
            continue  # stress marks: no segment
        info = _PHONE_DUR.get(tok)
        if info is None:
            continue
        cls, dur, voiced = info
        if cls == "s":
            closure = (
                _STOP_CLOSURE_VOICED_MS if voiced else _STOP_CLOSURE_VOICELESS_MS
            )
            segs.append((ti, closure))
            segs.append((ti, _STOP_BURST_MS))
            if not voiced:
                segs.append((ti, _STOP_ASP_MS))
        else:
            segs.append((ti, dur))
    segs.append((-1, _TAIL_MS))

    runs: list[tuple[int, int]] = []
    for ti, dur_ms in segs:
        if ti < 0:
            pid = pk.sil_id
        else:
            tok = tokens[ti]
            tok = "_" if tok == " " else tok
            pid = pid_of.get(tok, -1)
            if pid < 0:
                continue
            if pid == pk.dot_id:
                pid = pk.sil_id
        frames = int(dur_ms / _FRAME_MS + 0.5)
        if frames <= 0 and pid != pk.sil_id:
            continue
        if runs and runs[-1][0] == pid:
            runs[-1] = (pid, runs[-1][1] + frames)
        else:
            runs.append((pid, max(frames, 0)))
    return runs


# ---------------------------------------------------------------------------
# Utterance plan (one whole-utterance chunk; the reference chunks at 400
# frames only because of its 340 KiB MCU arena, neural_tts.cc:73-82)


@dataclass
class Part:
    kind: str  # "sil" | "diphone" | "word"
    unit: int
    h2: int = 0
    h1: int = 0
    out_frames: int = 0
    cut: int = 0
    f0_scale_a: float = 1.0
    f0_scale_b: float = 1.0
    e_off_a: float = 0.0
    e_off_b: float = 0.0
    centroid_type: int = -1


def _blend_len_unit(rule_n: int, nat_n: int) -> int:
    lo = max(int(0.6 * rule_n + 0.5), 1)
    hi = max(int(1.6 * rule_n + 0.5), 1)
    return min(max(nat_n, lo), hi)


def _warp_positions(m: int, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros(1, np.float32)
    return np.arange(n, dtype=np.float32) * ((m - 1) / (n - 1))


def _warp_anchored(m: int, n: int, anchor_end: bool) -> np.ndarray:
    if m <= 0:
        return np.zeros(n, np.float32)
    if n >= m:
        return _warp_positions(m, n)
    keep = min(max(n // 2, 1), m)
    nw = n - keep
    pos = np.zeros(n, np.float32)
    if anchor_end:
        if nw > 0:
            pos[:nw] = _warp_positions(m - keep, nw)
        pos[nw:] = np.arange(m - keep, m, dtype=np.float32)
    else:
        pos[:keep] = np.arange(keep, dtype=np.float32)
        if nw > 0:
            pos[keep:] = _warp_positions(m - keep, nw) + keep
    return pos


# English letter/digit names in IPA (spelling fallback for OOV words).
_LETTER_IPA = {
    "a": "eɪ", "b": "bi", "c": "si", "d": "di", "e": "i", "f": "ɛf",
    "g": "dʒi", "h": "eɪtʃ", "i": "aɪ", "j": "dʒeɪ", "k": "keɪ",
    "l": "ɛl", "m": "ɛm", "n": "ɛn", "o": "oʊ", "p": "pi", "q": "kju",
    "r": "ɑɹ", "s": "ɛs", "t": "ti", "u": "ju", "v": "vi",
    "w": "dʌbəlju", "x": "ɛks", "y": "waɪ", "z": "zi",
    "0": "ziɹoʊ", "1": "wʌn", "2": "tu", "3": "θɹi", "4": "fɔɹ",
    "5": "faɪv", "6": "sɪks", "7": "sɛvən", "8": "eɪt", "9": "naɪn",
}


def decode_tiles(executor, tiles: np.ndarray) -> np.ndarray:
    """The decoder graph over every tile at once: ``[n_tiles,
    tile_latents, latent_dim]`` latents -> its float output as numpy."""
    x = torch.from_numpy(np.ascontiguousarray(tiles, np.float32)).to(executor.device)
    return executor.run(x).cpu().numpy()


class NeuralPackTTS:
    """Synthesize English text/IPA with the reference's published voice."""

    def __init__(self, pack_path: str | None = None, lexicon=None, *, device=None):
        self.pk = load_pack(pack_path)
        from ..core.tflite_io import parse_tflite
        from ..ops.tflite_graph import TfliteExecutor

        self.executor = TfliteExecutor(parse_tflite(self.pk.model), device)
        self.device = self.executor.device
        if lexicon is None:
            from .g2p import GraphemeToPhonemizer

            lexicon = GraphemeToPhonemizer(language="en_us")
        self.g2p = lexicon
        # word reuse penalty state (reset per synthesize call)
        self._used: dict[int, int] = {}
        self._prev_tail_f0 = 0.0

    # -- front end ----------------------------------------------------------

    #: micro-engine function-word readings (the micro G2P reads these
    #: with full vowels; the moonshine-tts tier uses reduced forms —
    #: reference: micro/g2p rules vs english-hand-oov.cpp kFunctionWords)
    _MICRO_WORDS = {"to": "tu", "into": "ɪntu", "onto": "ɑntu"}

    def text_to_tokens(self, text: str) -> list[str]:
        """Plain English text -> pack IPA tokens via the G2P engine
        (baked 10,855-word real-pronunciation dict + rules; single
        letters speak their names).  Stress marks are stripped: the
        micro pack models prosody with its own duration/f0 streams, not
        IPA stress tokens (micro/g2p/src/ipa_tokens.cc)."""
        parts: list[str] = []
        for word in text.lower().split():
            word = word.strip(".,!?;:")
            if not word:
                continue
            if len(word) == 1 and word in _LETTER_IPA:
                parts.append(_LETTER_IPA[word])
            elif word in self._MICRO_WORDS:
                parts.append(self._MICRO_WORDS[word])
            else:
                ipa = self.g2p.word_to_ipa(word)
                parts.append(ipa.replace("ˈ", "").replace("ˌ", ""))
        return tokenize_ipa(" ".join(parts))

    def synthesize(self, text: str, seed: int = 0) -> np.ndarray:
        """Text -> int16 PCM at 16 kHz."""
        return self.synthesize_tokens(self.text_to_tokens(text), seed=seed)

    def synthesize_ipa(self, ipa: str, seed: int = 0) -> np.ndarray:
        return self.synthesize_tokens(tokenize_ipa(ipa), seed=seed)

    def synthesize_tokens(self, tokens: list[str], seed: int = 0) -> np.ndarray:
        pk = self.pk
        self._used = {}
        self._prev_tail_f0 = 0.0
        runs = build_runs(pk, tokens)
        if not runs:
            return np.zeros(0, np.int16)
        track, f0, loud = self._plan_and_materialize(runs)
        T = len(f0)
        decl = (0.10 - 0.20 * np.arange(T) / max(T - 1, 1)) / LN10
        benv = np.power(10.0, track[:, :48] + decl[:, None] + loud[:, None])
        bap = np.clip(track[:, 48:], 0.0, 1.0)
        return worldlite.render(benv, bap, f0, pk.default_gain, seed=seed, device=self.device)

    def estimate_samples(self, text: str) -> int:
        self._used = {}
        self._prev_tail_f0 = 0.0
        runs = build_runs(self.pk, self.text_to_tokens(text))
        if not runs:
            return 0
        c, D = self._chunk_segments(runs)
        _parts, T, _joins = self._build_parts(c, D)
        return T * worldlite.FRAME_SAMPLES

    # -- planning -----------------------------------------------------------

    def _is_sil(self, pid: int) -> bool:
        return pid in (self.pk.sil_id, self.pk.dot_id)

    def _is_gap(self, pid: int) -> bool:
        return pid == self.pk.gap_id

    def _chunk_segments(self, runs):
        """Whole utterance as one chunk: enforce sil at both ends, scale
        durations by dur_ratio with the reference floors/pads
        (neural_tts.cc:1729-1778, first=last=True)."""
        pk = self.pk
        c = list(runs)
        if not self._is_sil(c[0][0]):
            c.insert(0, (pk.sil_id, 0))
        if not self._is_sil(c[-1][0]):
            c.append((pk.sil_id, 0))
        D = []
        for pid, rule_frames in c:
            s = self._is_sil(pid)
            base = max(rule_frames, 4 if s else 2)
            D.append(max(int(base * pk.dur_ratio[pid] + 0.5), 2))
        D[0] = max(D[0], 12)   # trimmed lead (first chunk)
        D[-1] = max(D[-1], 60)  # tail (last chunk)
        return c, D

    def _prosody_buckets(self, c):
        """(seg_chunk, chunk_func, chunk_pos) per segment
        (neural_tts.cc:622-696)."""
        pk = self.pk
        n = len(c)
        seg_chunk = [-1] * n
        chunk_func = [0] * n
        chunk_pos = [1] * n
        chunks = []
        i = 0
        while i < n:
            if self._is_sil(c[i][0]) or self._is_gap(c[i][0]):
                i += 1
                continue
            j = i
            while j < n and not self._is_sil(c[j][0]) and not self._is_gap(c[j][0]):
                j += 1
            chunks.append((i, j))
            i = j
        k = 0
        while k < len(chunks):
            pe = k
            while pe + 1 < len(chunks):
                sil_between = any(
                    self._is_sil(c[s][0])
                    for s in range(chunks[pe][1], chunks[pe + 1][0])
                )
                if sil_between:
                    break
                pe += 1
            length = pe - k + 1
            for ci in range(k, pe + 1):
                cs, ce = chunks[ci]
                if length == 1:
                    pos = 3
                elif ci == k:
                    pos = 0
                elif ci == pe:
                    pos = 2
                else:
                    pos = 1
                key = bytes(c[s][0] for s in range(cs, min(ce, cs + 24)))
                chunk_func[cs] = 1 if key in pk.func_keys else 0
                chunk_pos[cs] = pos
                for s in range(cs, ce):
                    seg_chunk[s] = cs
            k = pe + 1
        return seg_chunk, chunk_func, chunk_pos

    def _pros_off(self, table, seg_chunk, chunk_func, chunk_pos, seg):
        cs = seg_chunk[seg] if seg < len(seg_chunk) else -1
        if cs < 0:
            return 0.0
        return float(table[chunk_func[cs] * 4 + chunk_pos[cs]])

    def _find_word_first(self, key: bytes) -> int:
        """First word unit whose key == key (binary search over the
        sorted-by-key word records, neural_tts.cc:524-543)."""
        pk = self.pk
        lo, hi, found = 0, len(pk.wunits) - 1, -1
        while lo <= hi:
            mid = (lo + hi) // 2
            ko = int(pk.wunits[mid]["key_off"])
            L = pk.wkeys[ko]
            k = bytes(pk.wkeys[ko + 1 : ko + 1 + L])
            if k == key:
                found = mid
                hi = mid - 1
            elif k < key:
                lo = mid + 1
            else:
                hi = mid - 1
        return found

    def _word_key(self, idx: int) -> bytes:
        ko = int(self.pk.wunits[idx]["key_off"])
        L = self.pk.wkeys[ko]
        return bytes(self.pk.wkeys[ko + 1 : ko + 1 + L])

    def _match_words(self, c, D):
        """Greedy longest-phrase-first word-unit coverage with duration/
        f0/reuse candidate costs (neural_tts.cc:707-805)."""
        pk = self.pk
        n = len(c)
        n_bound = n - 1
        word_at = [-1] * (n_bound + 1)
        word_end = [-1] * (n_bound + 1)
        covered = [False] * (n_bound + 1)
        i = 0
        while i < n:
            if self._is_sil(c[i][0]) or self._is_gap(c[i][0]):
                i += 1
                continue
            j = i
            while j < n and not self._is_sil(c[j][0]) and not self._is_gap(c[j][0]):
                j += 1
            ends = [j]
            j2 = j
            while (
                len(ends) < 8 and j2 < n - 1 and self._is_gap(c[j2][0])
                and not self._is_sil(c[j2 + 1][0]) and not self._is_gap(c[j2 + 1][0])
            ):
                j2 += 1
                while j2 < n and not self._is_sil(c[j2][0]) and not self._is_gap(c[j2][0]):
                    j2 += 1
                if j2 <= n - 1:
                    ends.append(j2)
            match, jend = -1, j
            for je in reversed(ends):
                if je - i > 24:
                    continue
                key = bytes(c[s][0] for s in range(i, je))
                m = self._find_word_first(key)
                if m >= 0:
                    match, jend = m, je
                    break
            if match >= 0 and i >= 1 and jend <= n - 1:
                need = D[i - 1] - D[i - 1] // 2
                for s in range(i, jend):
                    need += D[s]
                need += D[jend] // 2
                mk = self._word_key(match)
                best, best_c = match, 1e30
                m2 = match
                while m2 < len(pk.wunits) and self._word_key(m2) == mk:
                    r = pk.wunits[m2]
                    cost = W_WORD_DUR * abs(
                        math.log(max(int(r["n_frames"]), 1) / max(need, 1))
                    )
                    f0m = f0_from_code(int(r["f0med_q"]))
                    if self._prev_tail_f0 > 0.0 and f0m > 0.0:
                        cost += W_WORD_F0 * abs(math.log(f0m / self._prev_tail_f0))
                    cost += WORD_REUSE * self._used.get(m2, 0)
                    if cost < best_c:
                        best_c, best = cost, m2
                    m2 += 1
                self._used[best] = self._used.get(best, 0) + 1
                f0m = f0_from_code(int(pk.wunits[best]["f0med_q"]))
                if f0m > 0.0:
                    self._prev_tail_f0 = f0m
                word_at[i - 1] = best
                word_end[i - 1] = jend - 1
                for bdy in range(i - 1, jend):
                    covered[bdy] = True
            i = max(jend, j)
        return word_at, word_end, covered

    def _find_diphone_type(self, a: int, bb: int) -> int:
        pk = self.pk
        keys = (pk.dtypes["a"].astype(np.int32) << 8) | pk.dtypes["b"]
        idx = np.searchsorted(keys, (a << 8) | bb)
        if idx < len(keys) and keys[idx] == ((a << 8) | bb):
            return int(idx)
        return -1

    def _select_diphones(self, c, D, covered):
        """Candidate sets + Viterbi (neural_tts.cc:807-926)."""
        pk = self.pk
        n = len(c)
        n_bound = n - 1
        cands: list[list[int]] = [[] for _ in range(n_bound)]
        chosen = [-1] * n_bound
        cls = pk.phone_class
        for j in range(n_bound):
            if covered[j]:
                continue
            a, bb = c[j][0], c[j + 1][0]
            t = self._find_diphone_type(a, bb)
            if t >= 0:
                rec = pk.dtypes[t]
                first, nn = int(rec["first_unit"]), min(int(rec["n_units"]), CAP)
                cands[j] = list(range(first, first + nn))
                continue
            for pass_ in range(2):
                if cands[j]:
                    break
                pool: list[tuple[float, int]] = []
                for ti in range(len(pk.dtypes)):
                    tr = pk.dtypes[ti]
                    if int(tr["b"]) != bb:
                        continue
                    if pass_ == 0 and cls[int(tr["a"])] != cls[a]:
                        continue
                    for u in range(int(tr["n_units"])):
                        cand = int(tr["first_unit"]) + u
                        pool.append((float(pk.dunits[cand]["score"]), cand))
                pool.sort()
                cands[j] = [cand for _, cand in pool[:CAP]]

        canon = lambda pid: self.pk.sil_id if pid == self.pk.dot_id else pid

        def target_cost(j, u):
            r = pk.dunits[u]
            need = (D[j] // 2) + (D[j + 1] - D[j + 1] // 2)
            d_dur = abs(math.log(max(int(r["n_frames"]), 1) / max(need, 1)))
            ctx = 0.0
            if j > 0 and int(r["prev"]) >= 0 and canon(int(r["prev"])) != c[j - 1][0]:
                ctx += 1.0
            if j + 2 < n and int(r["next"]) >= 0 and canon(int(r["next"])) != c[j + 2][0]:
                ctx += 1.0
            return float(r["score"]) + W_DUR * d_dur + W_CTX * ctx

        def join_cost(ua, ub):
            ra, rb = pk.dunits[ua], pk.dunits[ub]
            acc = int(
                np.abs(
                    ra["edge_tail"].astype(np.int32) - rb["edge_head"].astype(np.int32)
                ).sum()
            )
            return W_JOIN * pk.edge_scale * acc / EDGE_BANDS

        j = 0
        while j < n_bound:
            if not cands[j]:
                j += 1
                continue
            lo = j
            while j < n_bound and cands[j]:
                j += 1
            hi = j
            cost = [target_cost(lo, u) for u in cands[lo]]
            back: dict[tuple[int, int], int] = {}
            for bdy in range(lo + 1, hi):
                ncost = []
                for ui, u in enumerate(cands[bdy]):
                    bestc, bestp = 1e30, 0
                    for pi, pu in enumerate(cands[bdy - 1]):
                        cc = cost[pi] + join_cost(pu, u)
                        if cc < bestc:
                            bestc, bestp = cc, pi
                    ncost.append(bestc + target_cost(bdy, u))
                    back[(bdy, ui)] = bestp
                cost = ncost
            kk = int(np.argmin(cost))
            for bdy in range(hi - 1, lo, -1):
                chosen[bdy] = cands[bdy][kk]
                kk = back[(bdy, kk)]
            chosen[lo] = cands[lo][kk]
        return chosen

    def _build_parts(self, c, D):
        """Parts + joins from words/diphones (neural_tts.cc:928-1079)."""
        pk = self.pk
        seg_chunk, chunk_func, chunk_pos = self._prosody_buckets(c)
        word_at, word_end, covered = self._match_words(c, D)
        chosen = self._select_diphones(c, D, covered)

        def seg_off(table, seg):
            return self._pros_off(table, seg_chunk, chunk_func, chunk_pos, seg)

        n = len(c)
        n_bound = n - 1
        parts: list[Part] = []
        joins: list[int] = []
        pos = 0

        def add(p: Part):
            nonlocal pos
            parts.append(p)
            p.start = pos  # type: ignore[attr-defined]
            pos += p.out_frames

        add(Part("sil", -1, h2=D[0] - D[0] // 2, out_frames=D[0] - D[0] // 2))
        j = 0
        while j < n_bound:
            if word_at[j] >= 0:
                w = word_at[j]
                jend = word_end[j]
                need_rule = 0
                for bdy in range(j, jend + 1):
                    need_rule += (D[bdy] // 2) + (D[bdy + 1] - D[bdy + 1] // 2)
                need = _blend_len_unit(need_rule, int(pk.wunits[w]["n_frames"]))
                d_off = f_off = e_off = 0.0
                n_off = 0
                for s in range(j + 1, jend + 1):
                    if seg_chunk[s] == s:
                        d_off += seg_off(pk.prosody_dur, s)
                        f_off += seg_off(pk.prosody_f0, s)
                        e_off += seg_off(pk.prosody_energy, s) - pk.energy_base
                        n_off += 1
                if n_off:
                    d_off /= n_off
                    f_off /= n_off
                    e_off /= n_off
                    need = max(int(need * math.exp(d_off) + 0.5), 4)
                p = Part("word", w, out_frames=need)
                f0m = f0_from_code(int(pk.wunits[w]["f0med_q"]))
                p.f0_scale_a = p.f0_scale_b = (
                    pk.median_f0 / f0m if f0m > 0.0 else 1.0
                ) * math.exp(f_off)
                p.e_off_a = p.e_off_b = min(max(e_off, -0.8), 0.8)
                joins.append(pos)
                add(p)
                joins.append(pos)
                j = jend + 1
                continue
            h2 = D[j] // 2
            h1 = D[j + 1] - D[j + 1] // 2
            u = chosen[j]
            if u < 0:
                p = Part("sil", -1, h2=h2, h1=h1, out_frames=h2 + h1)
            else:
                r = pk.dunits[u]
                if not self._is_sil(c[j][0]) and not self._is_gap(c[j][0]):
                    h2 = _blend_len_unit(h2, int(r["cut"]))
                if not self._is_sil(c[j + 1][0]) and not self._is_gap(c[j + 1][0]):
                    h1 = _blend_len_unit(h1, int(r["n_frames"]) - int(r["cut"]))
                h2 = max(int(h2 * math.exp(seg_off(pk.prosody_dur, j)) + 0.5), 1)
                h1 = max(int(h1 * math.exp(seg_off(pk.prosody_dur, j + 1)) + 0.5), 1)
                p = Part(
                    "diphone", u, h2=h2, h1=h1, out_frames=h2 + h1,
                    cut=int(r["cut"]),
                    centroid_type=self._find_diphone_type(c[j][0], c[j + 1][0]),
                )
                f0m = f0_from_code(int(r["f0med_q"]))
                fnorm = pk.median_f0 / f0m if f0m > 0.0 else 1.0
                p.f0_scale_a = fnorm * math.exp(seg_off(pk.prosody_f0, j))
                p.f0_scale_b = fnorm * math.exp(seg_off(pk.prosody_f0, j + 1))

                def eclamp(seg):
                    cs = seg_chunk[seg] if seg < len(seg_chunk) else -1
                    e = (
                        self._pros_off(
                            pk.prosody_energy, seg_chunk, chunk_func, chunk_pos, seg
                        ) - pk.energy_base
                        if cs >= 0 else 0.0
                    )
                    return min(max(e, -0.8), 0.8)

                p.e_off_a = eclamp(j)
                p.e_off_b = eclamp(j + 1)
            joins.append(pos)
            add(p)
            j += 1
        add(Part("sil", -1, h2=D[n - 1] // 2, out_frames=D[n - 1] // 2))
        return parts, pos, joins

    # -- materialization -----------------------------------------------------

    def _unit_ref(self, p: Part):
        pk = self.pk
        if p.kind == "word":
            r = pk.wunits[p.unit]
        else:
            r = pk.dunits[p.unit]
        T = min(int(r["n_frames"]), MAX_UNIT_FRAMES)
        return r, T

    def _ranges(self, p: Part, T: int):
        """(src0, src_n, out_n, anchor_end, plain, f0s, eoff) per range
        (neural_tts.cc:1167-1180)."""
        if p.kind == "word":
            return [(0, T, p.out_frames, False, True, p.f0_scale_a, p.e_off_a)]
        cut = min(p.cut, T)
        return [
            (0, cut, p.h2, True, False, p.f0_scale_a, p.e_off_a),
            (cut, T - cut, p.h1, False, False, p.f0_scale_b, p.e_off_b),
        ]

    def _decode_stream(self, parts) -> tuple[np.ndarray, list[int]]:
        """Concatenate all unit codes and decode them in ONE batched call
        on the device over disjoint tiles (tile_hop == tile_latents in the
        shipped pack, so the reference's tile grid is exactly a batch axis).
        Returns (rows [total_frames, 60] float log10-amp/bap, part_base)."""
        pk = self.pk
        code_chunks = []
        part_base: list[int] = []
        base_latent = 0
        for p in parts:
            if p.kind == "sil":
                part_base.append(-1)
                continue
            r, T = self._unit_ref(p)
            nl = (T + 3) // 4
            code_chunks.append(unpack_codes(pk, int(r["codes_off"]), nl))
            part_base.append(base_latent * 4)
            base_latent += nl
        if base_latent == 0:
            return np.zeros((0, 60), np.float32), part_base
        codes = np.concatenate(code_chunks, axis=0)  # [L, 3]
        # latents = sum of scaled codebook rows (pb_decoder.cc:157-179,
        # minus the int16 round-trip: float is the dequantized arithmetic)
        lat = (
            pk.codebooks[0][codes[:, 0]]
            + pk.codebooks[1][codes[:, 1]]
            + pk.codebooks[2][codes[:, 2]]
        ).astype(np.float32)
        TL = pk.tile_latents
        n_tiles = -(-len(lat) // TL)
        pad = n_tiles * TL - len(lat)
        if pad:
            lat = np.concatenate([lat, np.zeros((pad, lat.shape[1]), np.float32)])
        tiles = lat.reshape(n_tiles, TL, pk.latent_dim)
        rows = decode_tiles(self.executor, tiles)
        rows = rows.reshape(n_tiles * TL * 4, 60)[: base_latent * 4]
        return rows.astype(np.float32), part_base

    def _plan_and_materialize(self, runs):
        pk = self.pk
        c, D = self._chunk_segments(runs)
        parts, T, joins = self._build_parts(c, D)
        rows_all, part_base = self._decode_stream(parts)

        track = np.zeros((T, 60), np.float32)
        f0 = np.zeros(T, np.float32)
        # silence rows: benv log10 = -6, bap = 1
        track[:, :48] = -6.0
        track[:, 48:] = 1.0

        # -- f0 prepass (neural_tts.cc:1187-1237) + F0Pass ------------------
        for pi, p in enumerate(parts):
            out0 = getattr(p, "start")
            if p.kind == "sil":
                continue
            r, uT = self._unit_ref(p)
            f0_stream = decode_f0_stream(
                pk.raw[pk.f0_base + int(r["f0_off"]) :], uT
            )
            for src0, src_n, out_n, anchor_end, plain, f0s, _eoff in self._ranges(p, uT):
                if out_n <= 0:
                    continue
                if src_n <= 0:
                    out0 += out_n
                    continue
                eff = min(out_n, MAX_UNIT_FRAMES)
                pos = (
                    _warp_positions(src_n, eff) if plain
                    else _warp_anchored(src_n, eff, anchor_end)
                )
                for t in range(out_n):
                    sp = pos[min(t, eff - 1)]
                    s0 = min(int(sp), src_n - 1)
                    s1 = min(s0 + 1, src_n - 1)
                    a = sp - s0
                    fa, fb = f0_stream[src0 + s0], f0_stream[src0 + s1]
                    if fa > 1.0 and fb > 1.0:
                        f = fa + (fb - fa) * a
                    else:
                        f = fa if a < 0.5 else fb
                    f0[out0 + t] = f * f0s if f > 1.0 else 0.0
                out0 += out_n
        self._f0_pass(f0)

        # -- track materialization (neural_tts.cc:1243-1341), float domain --
        for pi, p in enumerate(parts):
            out0 = getattr(p, "start")
            if p.kind == "sil":
                continue
            r, uT = self._unit_ref(p)
            rows = rows_all[part_base[pi] : part_base[pi] + uT]
            mean_lnb = rows[:, :48].mean(axis=0) * LN10  # natural-log benv
            unit_eoff = int(r["gain_q"]) * UNIT_GAIN_STEP
            timbre = np.zeros(48, np.float32)
            if p.kind == "diphone" and p.centroid_type >= 0:
                cen = pk.centroids[p.centroid_type]
                timbre = TIMBRE_NORM * (cen - mean_lnb) / LN10  # log10 units
            for src0, src_n, out_n, anchor_end, plain, _f0s, eoff in self._ranges(p, uT):
                if out_n <= 0:
                    continue
                if src_n <= 0:
                    track[out0 : out0 + out_n, :48] = -6.0
                    track[out0 : out0 + out_n, 48:] = 1.0
                    out0 += out_n
                    continue
                eff = min(out_n, MAX_UNIT_FRAMES)
                pos = (
                    _warp_positions(src_n, eff) if plain
                    else _warp_anchored(src_n, eff, anchor_end)
                )
                posf = pos[np.minimum(np.arange(out_n), eff - 1)]
                s0 = np.minimum(posf.astype(np.int64), src_n - 1)
                s1 = np.minimum(s0 + 1, src_n - 1)
                a = (posf - s0)[:, None].astype(np.float32)
                seg = rows[src0 + s0] + a * (rows[src0 + s1] - rows[src0 + s0])
                eq = (eoff + unit_eoff) / LN10
                seg[:, :48] += timbre[None, :] + eq
                track[out0 : out0 + out_n] = seg
                out0 += out_n

        # -- gain EQ at part boundaries + join smoothing --------------------
        starts = [getattr(p, "start") for p in parts]
        for pi in range(len(parts) - 1):
            self._gain_eq(track, parts, starts, pi)
        for jf in joins:
            self._smooth_join(track, jf, T)

        loud = self._plan_loudness(parts, starts, T)
        return track, f0, loud

    def _f0_pass(self, f0: np.ndarray) -> None:
        """unit_decl shaping: gap interpolation, 9-frame boxcar, declination
        ramp, terminal falls; gated by original voicing
        (neural_tts.cc:1600-1681)."""
        T = len(f0)
        voiced = f0 > 1.0
        if not voiced.any():
            return
        idx = np.nonzero(voiced)[0]
        cont = np.interp(np.arange(T), idx, f0[idx]).astype(np.float32)
        pad = np.pad(cont, 4, mode="edge")
        kernel = np.ones(9, np.float32) / 9.0
        sm = np.convolve(pad, kernel, mode="valid")
        ramp = 1.06 + (0.92 - 1.06) * np.arange(T) / max(T - 1, 1)
        sm *= ramp
        # terminal falls
        span_end, gap = -1, 0
        falls = []
        for t in range(T):
            if voiced[t]:
                if span_end >= 0 and gap > 50:
                    falls.append(span_end)
                span_end, gap = t, 0
            else:
                gap += 1
        if span_end >= 0:
            falls.append(span_end)
        for last in falls:
            n = min(last + 1, 80)
            fall = 1.0 + (0.85 - 1.0) * (
                np.arange(n) / max(n - 1, 1) if n > 1 else np.ones(1)
            )
            sm[last - n + 1 : last + 1] *= fall
        f0[:] = np.where(voiced, sm, 0.0)

    def _frame_ln_energy(self, track, t) -> float:
        return float(np.log(np.maximum(
            np.power(10.0, track[t, :48]).sum(), 1e-8
        )))

    def _gain_eq(self, track, parts, starts, pi) -> None:
        """equalize_gains at boundary pi/pi+1 (neural_tts.cc:1344-1390)."""
        a_end = starts[pi] + parts[pi].out_frames
        b_start = starts[pi + 1]
        an, bn = parts[pi].out_frames, parts[pi + 1].out_frames
        if an < 1 or bn < 1:
            return
        ha, hb = min(an, XFADE_HW), min(bn, XFADE_HW)
        ea = np.mean([self._frame_ln_energy(track, a_end - 1 - t) for t in range(ha)])
        eb = np.mean([self._frame_ln_energy(track, b_start + t) for t in range(hb)])
        if ea < math.log(1e-4) or eb < math.log(1e-4):
            return
        step = min(max((ea - eb) * 0.5, -0.6), 0.6)
        na, nb = min(an, 8), min(bn, 8)
        for i in range(na):
            off = -step * i / max(na - 1, 1)
            track[a_end - na + i, :48] += off / LN10
        for i in range(nb):
            off = step * (1.0 - i / max(nb - 1, 1))
            track[b_start + i, :48] += off / LN10

    def _smooth_join(self, track, j, T) -> None:
        """smooth_joins_residual at frame j (neural_tts.cc:1392-1421)."""
        if j < 1 or j >= T:
            return
        d = track[j] - track[j - 1]
        nb = min(j, XFADE_HW)
        for i in range(1, nb + 1):
            ramp = 0.5 * i / nb
            track[j - 1 - (nb - i)] += ramp * d
        mf = min(T - j, XFADE_HW)
        for i in range(mf):
            ramp = 0.5 * (mf - i) / mf
            track[j + i] -= ramp * d

    def _plan_loudness(self, parts, starts, T) -> np.ndarray:
        """Full-lookahead loudness lift from the baked per-unit knots
        (neural_tts.cc:1444-1545).  Returns per-frame log10-amp boost."""
        pk = self.pk
        lsa = np.full(T, LOUD_SILENT, np.float32)
        for p, out0 in zip(parts, starts):
            if p.kind == "sil":
                continue
            r, uT = self._unit_ref(p)
            knots = r["loud"].astype(np.float32) * pk.loud_scale
            unit_eoff = int(r["gain_q"]) * UNIT_GAIN_STEP

            def knot_at(u):
                u = min(max(u, 0.0), 1.0)
                x = u * (LOUD_KNOTS - 1)
                i = min(max(int(x), 0), LOUD_KNOTS - 2)
                return knots[i] + (knots[i + 1] - knots[i]) * (x - i)

            def fill(o0, n, u0, u1, eoff):
                for t in range(n):
                    u = u0 + (u1 - u0) * t / max(n - 1, 1) if n > 1 else u0
                    lsa[o0 + t] = knot_at(u) + eoff + unit_eoff

            if p.kind == "word":
                fill(out0, p.out_frames, 0.0, 1.0, p.e_off_a)
            else:
                cutf = p.cut / max(uT, 1)
                if p.h2 > 0:
                    fill(out0, p.h2, 0.0, cutf, p.e_off_a)
                if p.h1 > 0:
                    fill(out0 + p.h2, p.h1, cutf, 1.0, p.e_off_b)

        voiced_mask = lsa > -100.0
        if not voiced_mask.any():
            return np.zeros(T, np.float32)
        ref = -1e30
        for t in range(T):
            if not voiced_mask[t]:
                continue
            lo, hi = max(t - LOUD_REF_HW, 0), min(t + LOUD_REF_HW, T - 1)
            vals = lsa[lo : hi + 1][voiced_mask[lo : hi + 1]]
            if len(vals):
                ref = max(ref, float(vals.mean()))
        floor, gate = ref - LOUD_FLOOR_DROP, ref - LOUD_GATE_DROP
        boost = np.where(
            voiced_mask & (lsa > gate),
            np.clip(floor - lsa, 0.0, LOUD_MAX_BOOST),
            0.0,
        ).astype(np.float32)
        hw = LOUD_SMOOTH_HW
        pad = np.pad(boost, hw, mode="edge")
        kernel = np.ones(2 * hw + 1, np.float32) / (2 * hw + 1)
        return (np.convolve(pad, kernel, mode="valid") / LN10).astype(np.float32)
