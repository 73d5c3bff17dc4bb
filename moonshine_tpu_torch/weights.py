"""Checkpoints and parameter trees -> the port's modules, and back.

Two sources of weights:

- **Checkpoints** in PyTorch naming: ``import_hf_moonshine`` reads an HF
  Moonshine state dict or ``.safetensors`` file, and ``import_streaming`` /
  ``load_streaming_checkpoint`` the streaming family's canonical state dict
  (``.safetensors``, ``model.onnx`` or the reference's five-session ONNX
  directory).  PyTorch's layouts are the port's (``Linear.weight [out,
  in]``, ``Conv1d.weight [out, in, k]``), so these need no transpose.
  ``load_safetensors`` reads the format itself (an 8-byte little-endian
  header length, a JSON header, raw little-endian tensors), so no
  ``safetensors`` package is needed.
- **JAX parameter trees**: the JAX package keeps nested dicts with the
  layers stacked on a leading axis, dense kernels ``[in, out]`` and conv
  kernels ``[k, in, out]`` (WIO).  ``params_from_jax_numpy`` and
  ``params_to_numpy`` convert in both directions, exec-quantized
  ``w_q``/``w_scale`` leaves included; the VAD, spelling CNN (HWIO
  ``[kh, kw, in, out]`` kernels), diarization, Gemma, TTS and G2P
  transformer models have their own ``*_from_jax_numpy`` /
  ``*_to_numpy`` pairs.  They take the tree as numpy
  arrays (a caller that has JAX passes ``jax.tree.map(np.asarray,
  params)``; the port itself never imports JAX).

Every leaf is made C-contiguous before it becomes a tensor: a numpy view of
a device array can be F-strided, and ``torch.from_numpy`` would keep those
strides.  Loaders put the model on ``device``, CUDA unless named.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping

import numpy as np
import torch

from .core.config import MoonshineArchConfig, StreamingConfig
from .core.device import resolve_device
from .models import moonshine as mm
from .models import streaming as ms
from .models import vad as vad_mod
from .models import diarization as dm
from .models import gemma as gm
from .models import spelling as sp
from .models import tts as tts_mod
from .models import voice_clone as vc_mod
from .tts import g2p_transformer as g2pt
from .tts import tok_pos as tp_mod
from .models.layers import Conv1d, Conv2d, Dense, Norm


def _tensor(x) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _numpy(t: torch.Tensor | None) -> np.ndarray | None:
    """A C-ordered numpy copy; bf16 becomes float32 (exact)."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.numpy())


def _dense(p: dict) -> Dense:
    bias = _tensor(p["b"]) if "b" in p else None
    if "w_q" in p:  # exec-quantized (quant.quantize_tree_exec)
        return Dense(None, bias, w_q=_tensor(np.swapaxes(p["w_q"], 0, 1)),
                     w_scale=_tensor(p["w_scale"]))
    return Dense(_tensor(np.swapaxes(p["w"], 0, 1)), bias)


def _conv(p: dict) -> Conv1d:
    """WIO ``[k, in, out]`` -> ``[out, in, k]``; HWIO -> OIHW (``Conv2d``)."""
    bias = _tensor(p["b"]) if "b" in p else None
    w = np.asarray(p["w"])
    weight = _tensor(np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))))
    return (Conv1d if w.ndim == 3 else Conv2d)(weight, bias)


def _norm(p: dict) -> Norm:
    return Norm(_tensor(p["scale"]), _tensor(p["bias"]) if "bias" in p else None)


def _attention(p: dict) -> mm.Attention:
    a = mm.Attention(_dense(p["q"]), _dense(p["k"]), _dense(p["v"]), _dense(p["o"]))
    if "q_swapped" in p:
        a.q_swapped = _dense(p["q_swapped"])
    if "k_swapped" in p:
        a.k_swapped = _dense(p["k_swapped"])
    return a


def _unstack(tree, n: int) -> list:
    """[L, ...] leaves -> a list of L trees."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"stacked leaf of shape {arr.shape} does not have {n} layers")
    return [arr[i] for i in range(n)]


def _encoder_layer(lp: dict) -> mm.EncoderLayer:
    return mm.EncoderLayer(_norm(lp["ln1"]), _attention(lp["attn"]), _norm(lp["ln2"]),
                           mm.Mlp(_dense(lp["mlp"]["fc1"]), _dense(lp["mlp"]["fc2"])))


def params_from_jax_numpy(tree: dict, cfg: MoonshineArchConfig,
                          device: str | torch.device | None = None) -> mm.Moonshine:
    """A JAX ``models.moonshine`` parameter tree (numpy leaves) -> the
    port's ``Moonshine`` on ``device`` (CUDA unless named).  The encoder's
    pair-swapped rotary projections are kept where the tree has them and
    built otherwise."""
    fe = tree["frontend"]
    frontend = mm.Frontend(_conv(fe["conv1"]), _norm(fe["gn"]), _conv(fe["conv2"]),
                           _conv(fe["conv3"]))
    enc_layers = [_encoder_layer(lp)
                  for lp in _unstack(tree["encoder"]["layers"], cfg.encoder_layers)]
    dec_layers = [
        mm.DecoderLayer(_norm(lp["ln1"]), _attention(lp["self_attn"]), _norm(lp["ln2"]),
                        _attention(lp["cross_attn"]), _norm(lp["ln3"]),
                        mm.Mlp(_dense(lp["mlp"]["fc1"]), _dense(lp["mlp"]["fc2"])))
        for lp in _unstack(tree["decoder"]["layers"], cfg.decoder_layers)
    ]
    dec = tree["decoder"]
    model = mm.Moonshine(
        frontend,
        mm.Encoder(enc_layers, _norm(tree["encoder"]["norm"])),
        mm.Decoder(_tensor(dec["embed"]), dec_layers, _norm(dec["norm"])),
    )
    return mm.prepare_rotary_params(model, cfg).to(resolve_device(device))


def _dense_np(p: Dense) -> dict:
    if p.quantized:
        out = {"w_q": _numpy(p.w_q).T.copy(), "w_scale": _numpy(p.w_scale)}
    else:
        out = {"w": _numpy(p.weight).T.copy()}
    if p.bias is not None:
        out["b"] = _numpy(p.bias)
    return out


def _conv_np(p: Conv1d) -> dict:
    w = _numpy(p.weight)
    out = {"w": np.ascontiguousarray(w.transpose(*range(2, w.ndim), 1, 0))}
    if p.bias is not None:
        out["b"] = _numpy(p.bias)
    return out


def _norm_np(p: Norm) -> dict:
    out = {"scale": _numpy(p.weight)}
    if p.bias is not None:
        out["bias"] = _numpy(p.bias)
    return out


def _attention_np(a: mm.Attention) -> dict:
    out = {k: _dense_np(getattr(a, k)) for k in ("q", "k", "v", "o")}
    for k in ("q_swapped", "k_swapped"):
        if getattr(a, k) is not None:
            out[k] = _dense_np(getattr(a, k))
    return out


def _encoder_layer_np(lp: mm.EncoderLayer) -> dict:
    return {"ln1": _norm_np(lp.ln1), "attn": _attention_np(lp.attn), "ln2": _norm_np(lp.ln2),
            "mlp": {"fc1": _dense_np(lp.mlp.fc1), "fc2": _dense_np(lp.mlp.fc2)}}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(model: mm.Moonshine) -> dict:
    """The port's ``Moonshine`` -> a JAX-layout parameter tree of numpy
    arrays (layers stacked; bf16 weights come back as float32; quantized
    layers as ``w_q``/``w_scale``)."""
    fe = model.frontend
    enc_layers = [_encoder_layer_np(lp) for lp in model.encoder.layers]
    dec_layers = [
        {"ln1": _norm_np(lp.ln1), "self_attn": _attention_np(lp.self_attn),
         "ln2": _norm_np(lp.ln2), "cross_attn": _attention_np(lp.cross_attn),
         "ln3": _norm_np(lp.ln3),
         "mlp": {"fc1": _dense_np(lp.mlp.fc1), "fc2": _dense_np(lp.mlp.fc2)}}
        for lp in model.decoder.layers
    ]
    return {
        "frontend": {"conv1": _conv_np(fe.conv1), "gn": _norm_np(fe.gn),
                     "conv2": _conv_np(fe.conv2), "conv3": _conv_np(fe.conv3)},
        "encoder": {"layers": _stack(enc_layers), "norm": _norm_np(model.encoder.norm)},
        "decoder": {"embed": _numpy(model.decoder.embed), "layers": _stack(dec_layers),
                    "norm": _norm_np(model.decoder.norm)},
    }


def vad_params_from_jax_numpy(tree: dict, device: str | torch.device | None = None) -> vad_mod.Vad:
    """A JAX ``models.vad`` parameter tree (numpy leaves) -> the port's
    ``Vad`` on ``device`` (CUDA unless named)."""
    model = vad_mod.Vad(
        _conv(tree["stft"]),
        [_conv(p) for p in tree["enc"]],
        vad_mod.Lstm(_dense(tree["lstm"]["wi"]), _dense(tree["lstm"]["wh"])),
        _dense(tree["head"]),
    )
    return model.to(resolve_device(device))


def vad_params_to_numpy(model: vad_mod.Vad) -> dict:
    """The port's ``Vad`` -> a JAX-layout VAD parameter tree of numpy arrays."""
    return {
        "stft": _conv_np(model.stft),
        "enc": [_conv_np(c) for c in model.enc],
        "lstm": {"wi": _dense_np(model.lstm.wi), "wh": _dense_np(model.lstm.wh)},
        "head": _dense_np(model.head),
    }


def spelling_params_from_jax_numpy(tree: dict,
                                   device: str | torch.device | None = None) -> sp.SpellingCNN:
    """A JAX ``models.spelling`` parameter tree (numpy leaves, HWIO
    convolutions) -> the port's ``SpellingCNN`` on ``device`` (CUDA unless
    named)."""
    model = sp.SpellingCNN([_conv(b) for b in tree["blocks"]], _dense(tree["head"]))
    return model.to(resolve_device(device))


def spelling_params_to_numpy(model: sp.SpellingCNN) -> dict:
    """The port's ``SpellingCNN`` -> a JAX-layout parameter tree."""
    return {"blocks": [_conv_np(b) for b in model.blocks], "head": _dense_np(model.head)}


def segmentation_params_from_jax_numpy(
        tree: dict, device: str | torch.device | None = None) -> dm.Segmentation:
    """A JAX diarization segmentation tree (numpy leaves, layers stacked on
    a leading axis) -> the port's ``Segmentation`` on ``device``."""
    depth = np.asarray(tree["layers"]["ln1"]["scale"]).shape[0]
    model = dm.Segmentation(_conv(tree["conv1"]), _conv(tree["conv2"]),
                            [_encoder_layer(lp) for lp in _unstack(tree["layers"], depth)],
                            _norm(tree["norm"]), _dense(tree["head"]))
    return model.to(resolve_device(device))


def segmentation_params_to_numpy(model: dm.Segmentation) -> dict:
    """The port's ``Segmentation`` -> a JAX-layout tree (layers stacked)."""
    return {"conv1": _conv_np(model.conv1), "conv2": _conv_np(model.conv2),
            "norm": _norm_np(model.norm),
            "layers": _stack([_encoder_layer_np(lp) for lp in model.layers]),
            "head": _dense_np(model.head)}


def embedding_params_from_jax_numpy(tree: dict,
                                    device: str | torch.device | None = None) -> dm.Embedding:
    """A JAX speaker-embedding tree (numpy leaves) -> the port's
    ``Embedding`` on ``device``."""
    model = dm.Embedding(_conv(tree["conv1"]), _conv(tree["conv2"]), _conv(tree["conv3"]),
                         _dense(tree["attn_pool"]), _dense(tree["proj"]))
    return model.to(resolve_device(device))


def embedding_params_to_numpy(model: dm.Embedding) -> dict:
    """The port's ``Embedding`` -> a JAX-layout tree."""
    return {"conv1": _conv_np(model.conv1), "conv2": _conv_np(model.conv2),
            "conv3": _conv_np(model.conv3), "attn_pool": _dense_np(model.attn_pool),
            "proj": _dense_np(model.proj)}


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested tree of dicts and lists -> ``{"a/0/b": leaf}``, the names
    the JAX package gives ``tree_flatten_with_path`` paths in its
    artifacts (dict keys, list indices)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """``flatten_tree``'s inverse: ``a/0/b`` names -> nested dicts, with
    the all-numeric levels as lists."""
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


_GEMMA_NORMS = ("input_norm", "q_norm", "k_norm", "post_attn_norm", "pre_ffw_norm",
                "post_ffw_norm")
_GEMMA_DENSE = ("q", "k", "v", "o", "gate", "up", "down")


def _gemma_layer(lp: dict) -> gm.GemmaLayer:
    return gm.GemmaLayer(**{k: Norm(_tensor(lp[k])) for k in _GEMMA_NORMS},
                         **{k: _dense(lp[k]) for k in _GEMMA_DENSE})


def gemma_params_from_jax_numpy(tree: dict, device: str | torch.device | None = None) -> gm.Gemma:
    """A JAX ``models.gemma`` tree (numpy leaves, layers stacked on a
    leading axis; norms are bare ``(1 + w)`` gain vectors) -> the port's
    ``Gemma`` on ``device``.  ``proj1``/``proj2`` stay absent where the
    tree has none."""
    depth = np.asarray(tree["layers"]["input_norm"]).shape[0]
    layers = [_gemma_layer(lp) for lp in _unstack(tree["layers"], depth)]
    proj = [_dense(tree[k]) if k in tree else None for k in ("proj1", "proj2")]
    model = gm.Gemma(_tensor(tree["embed"]), layers, Norm(_tensor(tree["final_norm"])), *proj)
    return model.to(resolve_device(device))


def gemma_params_to_numpy(model: gm.Gemma) -> dict:
    """The port's ``Gemma`` -> a JAX-layout tree (layers stacked)."""
    layers = [{**{k: _numpy(getattr(lp, k).weight) for k in _GEMMA_NORMS},
               **{k: _dense_np(getattr(lp, k)) for k in _GEMMA_DENSE}} for lp in model.layers]
    out = {"embed": _numpy(model.embed), "layers": _stack(layers),
           "final_norm": _numpy(model.final_norm.weight)}
    for k in ("proj1", "proj2"):
        if getattr(model, k) is not None:
            out[k] = _dense_np(getattr(model, k))
    return out


def tts_params_from_jax_numpy(tree: dict, device: str | torch.device | None = None) -> tts_mod.TTS:
    """A JAX ``models.tts`` tree (numpy leaves, layers stacked) -> the
    port's ``TTS`` on ``device``."""
    def layers(part: dict) -> list:
        depth = np.asarray(part["layers"]["ln1"]["scale"]).shape[0]
        return [_encoder_layer(lp) for lp in _unstack(part["layers"], depth)]

    enc, dec = tree["encoder"], tree["decoder"]
    model = tts_mod.TTS(_tensor(tree["embed"]), _dense(tree["style_proj"]), layers(enc),
                        _norm(enc["norm"]), _dense(tree["duration"]["fc1"]),
                        _dense(tree["duration"]["fc2"]), layers(dec), _norm(dec["norm"]),
                        _dense(tree["head_mag"]), _dense(tree["head_phase"]))
    return model.to(resolve_device(device))


def tts_params_to_numpy(model: tts_mod.TTS) -> dict:
    """The port's ``TTS`` -> a JAX-layout tree (layers stacked)."""
    def part(layers, norm) -> dict:
        return {"layers": _stack([_encoder_layer_np(lp) for lp in layers]),
                "norm": _norm_np(norm)}

    return {"embed": _numpy(model.embed), "style_proj": _dense_np(model.style_proj),
            "encoder": part(model.encoder_layers, model.encoder_norm),
            "duration": {"fc1": _dense_np(model.duration_fc1),
                         "fc2": _dense_np(model.duration_fc2)},
            "decoder": part(model.decoder_layers, model.decoder_norm),
            "head_mag": _dense_np(model.head_mag), "head_phase": _dense_np(model.head_phase)}


_G2P_NORMS = ("ln1", "ln2", "ln_x")
_G2P_DENSE = ("qkv", "attn_out", "fc1", "fc2", "x_q", "x_kv", "x_out")


def _g2p_block(p: dict) -> g2pt.G2PBlock:
    return g2pt.G2PBlock(**{k: _norm(p[k]) for k in _G2P_NORMS if k in p},
                         **{k: _dense(p[k]) for k in _G2P_DENSE if k in p})


def g2p_params_from_jax_numpy(tree: dict,
                              device: str | torch.device | None = None) -> g2pt.G2PModel:
    """A JAX ``tts.g2p_transformer`` tree (numpy leaves; ``enc`` and
    ``dec`` are lists of blocks) -> the port's ``G2PModel`` on ``device``."""
    model = g2pt.G2PModel(*(_tensor(tree[k]) for k in ("in_embed", "in_pos", "out_embed",
                                                       "out_pos")),
                          [_g2p_block(b) for b in tree["enc"]],
                          [_g2p_block(b) for b in tree["dec"]], _norm(tree["ln_f"]),
                          _dense(tree["head"]))
    return model.to(resolve_device(device))


def _g2p_block_np(b: g2pt.G2PBlock) -> dict:
    out = {k: _norm_np(getattr(b, k)) for k in _G2P_NORMS if getattr(b, k) is not None}
    out.update({k: _dense_np(getattr(b, k)) for k in _G2P_DENSE if getattr(b, k) is not None})
    return out


def g2p_params_to_numpy(model: g2pt.G2PModel) -> dict:
    """The port's ``G2PModel`` -> a JAX-layout tree."""
    return {**{k: _numpy(getattr(model, k)) for k in ("in_embed", "in_pos", "out_embed",
                                                      "out_pos")},
            "enc": [_g2p_block_np(b) for b in model.enc],
            "dec": [_g2p_block_np(b) for b in model.dec],
            "ln_f": _norm_np(model.ln_f), "head": _dense_np(model.head)}


def tok_pos_params_from_jax_numpy(tree: dict,
                                  device: str | torch.device | None = None) -> tp_mod.TokPosModel:
    """A JAX ``tts.tok_pos`` tree (numpy leaves; ``enc`` a list of blocks)
    -> the port's ``TokPosModel`` on ``device``."""
    model = tp_mod.TokPosModel(_tensor(tree["embed"]), _tensor(tree["pos"]),
                               [_g2p_block(b) for b in tree["enc"]], _norm(tree["ln_f"]),
                               _dense(tree["head_bio"]), _dense(tree["head_pos"]))
    return model.to(resolve_device(device))


def tok_pos_params_to_numpy(model: tp_mod.TokPosModel) -> dict:
    """The port's ``TokPosModel`` -> a JAX-layout tree."""
    return {"embed": _numpy(model.embed), "pos": _numpy(model.pos),
            "enc": [_g2p_block_np(b) for b in model.enc],
            "ln_f": _norm_np(model.ln_f), "head_bio": _dense_np(model.head_bio),
            "head_pos": _dense_np(model.head_pos)}


def voice_clone_params_from_jax_numpy(
        tree: dict, device: str | torch.device | None = None) -> vc_mod.VoiceCloneModel:
    """A JAX ``models.voice_clone`` tree (numpy leaves, layers stacked) ->
    the port's ``VoiceCloneModel`` on ``device``."""
    def layers(part: dict) -> list:
        depth = np.asarray(part["layers"]["ln1"]["scale"]).shape[0]
        return [_encoder_layer(lp) for lp in _unstack(part["layers"], depth)]

    voc = tree["vocoder"]
    model = vc_mod.VoiceCloneModel(
        _tensor(tree["embed"]), layers(tree["text"]), _norm(tree["text"]["norm"]),
        _dense(tree["in_proj"]), _dense(tree["time_mlp"]["fc1"]), _dense(tree["time_mlp"]["fc2"]),
        layers(tree["fm"]), _norm(tree["fm"]["norm"]), _dense(tree["out_proj"]),
        _dense(voc["fc1"]), _dense(voc["fc2"]), _dense(voc["mag"]), _dense(voc["phase"]))
    return model.to(resolve_device(device))


def voice_clone_params_to_numpy(model: vc_mod.VoiceCloneModel) -> dict:
    """The port's ``VoiceCloneModel`` -> a JAX-layout tree (layers stacked)."""
    def part(layers, norm) -> dict:
        return {"layers": _stack([_encoder_layer_np(lp) for lp in layers]),
                "norm": _norm_np(norm)}

    return {"embed": _numpy(model.embed), "text": part(model.text_layers, model.text_norm),
            "in_proj": _dense_np(model.in_proj),
            "time_mlp": {"fc1": _dense_np(model.time_fc1), "fc2": _dense_np(model.time_fc2)},
            "fm": part(model.fm_layers, model.fm_norm), "out_proj": _dense_np(model.out_proj),
            "vocoder": {"fc1": _dense_np(model.voc_fc1), "fc2": _dense_np(model.voc_fc2),
                        "mag": _dense_np(model.voc_mag), "phase": _dense_np(model.voc_phase)}}


# =========================================================================
# safetensors, read without the safetensors package
# =========================================================================

_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


def load_safetensors(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array.

    The format: an 8-byte little-endian header length, a JSON header
    mapping each name to its dtype, shape and byte range (and an optional
    ``__metadata__`` map of strings), then the raw little-endian data.
    BF16 tensors come back as float32 (exact: a bf16 value is the top half
    of a float32).
    """
    return load_safetensors_with_metadata(path)[0]


def load_safetensors_with_metadata(
        path: str | os.PathLike) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """``load_safetensors`` and the header's ``__metadata__`` ({} if none)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    metadata = dict(header.pop("__metadata__", None) or {})
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[start:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, _SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out, metadata


_SAFETENSORS_NAMES = {np.dtype(v): k for k, v in _SAFETENSORS_DTYPES.items()}


def save_safetensors(path: str | os.PathLike, tensors: Mapping[str, np.ndarray],
                     metadata: Mapping[str, str] | None = None) -> None:
    """Write numpy arrays as a ``.safetensors`` file (the layout
    ``load_safetensors`` reads; float32, float16 and the integer types),
    with ``metadata`` (strings to strings) as the header's
    ``__metadata__``."""
    header, chunks, offset = {}, [], 0
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _SAFETENSORS_NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in chunks:
            f.write(data)


# =========================================================================
# Checkpoints in PyTorch naming: the layouts are the port's own
# =========================================================================

def _as_state_dict(sd: Mapping[str, np.ndarray] | str | os.PathLike) -> Mapping[str, np.ndarray]:
    return load_safetensors(sd) if isinstance(sd, (str, os.PathLike)) else sd


def _sd(cls, sd, prefix: str, dtype):
    """A ``Dense``, ``Norm`` or ``Conv1d`` from ``prefix.weight`` (and
    ``prefix.bias`` where the checkpoint has one)."""
    bias = sd.get(f"{prefix}.bias")
    return cls(_tensor(sd[f"{prefix}.weight"]).to(dtype),
               None if bias is None else _tensor(bias).to(dtype))


def _sd_attention(sd, prefix: str, dtype) -> mm.Attention:
    return mm.Attention(*(_sd(Dense, sd, f"{prefix}.{n}_proj", dtype) for n in "qkvo"))


def _sd_mlp(sd, prefix: str, dtype) -> mm.Mlp:
    return mm.Mlp(_sd(Dense, sd, f"{prefix}.fc1", dtype), _sd(Dense, sd, f"{prefix}.fc2", dtype))


def _sd_encoder_layer(sd, pre: str, dtype) -> mm.EncoderLayer:
    return mm.EncoderLayer(
        _sd(Norm, sd, f"{pre}.input_layernorm", dtype), _sd_attention(sd, f"{pre}.self_attn", dtype),
        _sd(Norm, sd, f"{pre}.post_attention_layernorm", dtype), _sd_mlp(sd, f"{pre}.mlp", dtype))


def _sd_decoder_layer(sd, pre: str, dtype) -> mm.DecoderLayer:
    return mm.DecoderLayer(
        _sd(Norm, sd, f"{pre}.input_layernorm", dtype), _sd_attention(sd, f"{pre}.self_attn", dtype),
        _sd(Norm, sd, f"{pre}.post_attention_layernorm", dtype),
        _sd_attention(sd, f"{pre}.encoder_attn", dtype),
        _sd(Norm, sd, f"{pre}.final_layernorm", dtype), _sd_mlp(sd, f"{pre}.mlp", dtype))


def _put(out: dict, prefix: str, holder) -> None:
    """A Dense/Norm/Conv1d -> ``prefix.weight`` (and ``prefix.bias``)."""
    if isinstance(holder, Dense) and holder.quantized:
        raise ValueError(f"{prefix}: export a float model, not an exec-quantized one")
    out[f"{prefix}.weight"] = _numpy(holder.weight)
    if holder.bias is not None:
        out[f"{prefix}.bias"] = _numpy(holder.bias)


def _put_attention(out: dict, prefix: str, a: mm.Attention) -> None:
    for n in "qkvo":
        _put(out, f"{prefix}.{n}_proj", getattr(a, n))


def _put_encoder_layer(out: dict, pre: str, lp: mm.EncoderLayer) -> None:
    _put(out, f"{pre}.input_layernorm", lp.ln1)
    _put_attention(out, f"{pre}.self_attn", lp.attn)
    _put(out, f"{pre}.post_attention_layernorm", lp.ln2)
    _put(out, f"{pre}.mlp.fc1", lp.mlp.fc1)
    _put(out, f"{pre}.mlp.fc2", lp.mlp.fc2)


def _put_decoder(out: dict, pre: str, dec: mm.Decoder) -> None:
    out[f"{pre}.embed_tokens.weight"] = _numpy(dec.embed)
    for i, lp in enumerate(dec.layers):
        lpre = f"{pre}.layers.{i}"
        _put(out, f"{lpre}.input_layernorm", lp.ln1)
        _put_attention(out, f"{lpre}.self_attn", lp.self_attn)
        _put(out, f"{lpre}.post_attention_layernorm", lp.ln2)
        _put_attention(out, f"{lpre}.encoder_attn", lp.cross_attn)
        _put(out, f"{lpre}.final_layernorm", lp.ln3)
        _put(out, f"{lpre}.mlp.fc1", lp.mlp.fc1)
        _put(out, f"{lpre}.mlp.fc2", lp.mlp.fc2)
    _put(out, f"{pre}.norm", dec.norm)


def import_hf_moonshine(
    sd: Mapping[str, np.ndarray] | str | os.PathLike,
    cfg: MoonshineArchConfig,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> mm.Moonshine:
    """An HF Moonshine checkpoint (a state dict of numpy arrays or a
    ``.safetensors`` path) -> the port's ``Moonshine`` on ``device`` (CUDA
    unless named), with the encoder's pair-swapped rotary projections.

    HF's ``Linear.weight`` is ``[out, in]`` and its ``Conv1d.weight``
    ``[out, in, k]``, the port's own layouts, so no weight is transposed.
    Both ``MoonshineForConditionalGeneration`` names (``model.`` prefix)
    and bare ``MoonshineModel`` names import.
    """
    sd = _as_state_dict(sd)
    if not any(k.startswith("model.") for k in sd) and any(k.startswith("encoder.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    enc, dec = "model.encoder", "model.decoder"
    frontend = mm.Frontend(
        _sd(Conv1d, sd, f"{enc}.conv1", dtype), _sd(Norm, sd, f"{enc}.groupnorm", dtype),
        _sd(Conv1d, sd, f"{enc}.conv2", dtype), _sd(Conv1d, sd, f"{enc}.conv3", dtype))
    enc_layers = [_sd_encoder_layer(sd, f"{enc}.layers.{i}", dtype)
                  for i in range(cfg.encoder_layers)]
    dec_layers = [_sd_decoder_layer(sd, f"{dec}.layers.{i}", dtype)
                  for i in range(cfg.decoder_layers)]
    model = mm.Moonshine(
        frontend,
        mm.Encoder(enc_layers, _sd(Norm, sd, f"{enc}.layer_norm", dtype)),
        mm.Decoder(_tensor(sd[f"{dec}.embed_tokens.weight"]).to(dtype), dec_layers,
                   _sd(Norm, sd, f"{dec}.norm", dtype)),
    )
    return mm.prepare_rotary_params(model, cfg).to(resolve_device(device))


def import_hf_gemma3_text(sd: Mapping[str, np.ndarray] | str | os.PathLike, cfg: gm.GemmaTextConfig,
                          dtype: torch.dtype = torch.float32,
                          device: str | torch.device | None = None) -> gm.Gemma:
    """An HF ``Gemma3TextModel`` state dict (or ``.safetensors`` file) ->
    the port's ``Gemma`` on ``device`` (CUDA unless named).

    Where any key starts with ``model.``, only those keys are kept, without
    the prefix.  The sentence-transformers head (``dense1.weight``,
    ``dense2.weight``) is not part of the HF text model: ``proj1`` and
    ``proj2`` are read where those keys are, and stay absent otherwise.
    """
    sd = _as_state_dict(sd)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def t(k: str) -> torch.Tensor:
        return _tensor(np.asarray(sd[k])).to(dtype)

    def layer(i: int) -> gm.GemmaLayer:
        pre = f"layers.{i}"
        att, mlp = f"{pre}.self_attn", f"{pre}.mlp"
        return gm.GemmaLayer(
            Norm(t(f"{pre}.input_layernorm.weight")),
            *(Dense(t(f"{att}.{n}_proj.weight")) for n in ("q", "k", "v", "o")),
            Norm(t(f"{att}.q_norm.weight")), Norm(t(f"{att}.k_norm.weight")),
            Norm(t(f"{pre}.post_attention_layernorm.weight")),
            Norm(t(f"{pre}.pre_feedforward_layernorm.weight")),
            *(Dense(t(f"{mlp}.{n}_proj.weight")) for n in ("gate", "up", "down")),
            Norm(t(f"{pre}.post_feedforward_layernorm.weight")))

    proj = [Dense(t(k)) if k in sd else None for k in ("dense1.weight", "dense2.weight")]
    model = gm.Gemma(t("embed_tokens.weight"), [layer(i) for i in range(cfg.num_layers)],
                     Norm(t("norm.weight")), *proj)
    return model.to(resolve_device(device))


def export_hf_moonshine(model: mm.Moonshine) -> dict[str, np.ndarray]:
    """The port's float ``Moonshine`` -> an HF Moonshine state dict
    (``MoonshineForConditionalGeneration`` names, numpy, float32), the
    inverse of ``import_hf_moonshine``; the pair-swapped rotary
    projections are load-time copies and are not written."""
    out: dict[str, np.ndarray] = {}
    enc, dec = "model.encoder", "model.decoder"
    fe = model.frontend
    for name, holder in (("conv1", fe.conv1), ("groupnorm", fe.gn), ("conv2", fe.conv2),
                         ("conv3", fe.conv3)):
        _put(out, f"{enc}.{name}", holder)
    for i, lp in enumerate(model.encoder.layers):
        _put_encoder_layer(out, f"{enc}.layers.{i}", lp)
    _put(out, f"{enc}.layer_norm", model.encoder.norm)
    _put_decoder(out, dec, model.decoder)
    return out


# -- the streaming family -------------------------------------------------

def export_streaming_state_dict(model: ms.StreamingMoonshine,
                                cfg: StreamingConfig) -> dict[str, np.ndarray]:
    """The port's streaming model -> the canonical flat state dict (numpy,
    PyTorch naming and layouts), the inverse of ``import_streaming``."""
    del cfg  # the model's own layers say its depth
    out: dict[str, np.ndarray] = {}
    fr = model.frontend
    _put(out, "frontend.proj", fr.proj)
    _put(out, "frontend.conv1", fr.conv1)
    _put(out, "frontend.conv2", fr.conv2)
    _put(out, "frontend.norm", fr.norm)
    _put(out, "encoder.in_proj", model.encoder.in_proj)
    for i, lp in enumerate(model.encoder.layers):
        _put_encoder_layer(out, f"encoder.layers.{i}", lp)
    _put(out, "encoder.layer_norm", model.encoder.norm)
    _put(out, "adapter.proj", model.adapter.proj)
    _put(out, "adapter.norm", model.adapter.norm)
    _put_decoder(out, "decoder", model.decoder)
    return out


def import_streaming(
    sd: Mapping[str, np.ndarray] | str | os.PathLike,
    cfg: StreamingConfig,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> ms.StreamingMoonshine:
    """The canonical streaming state dict (or a ``.safetensors`` path) ->
    the port's ``StreamingMoonshine`` on ``device`` (CUDA unless named).
    An optional leading ``model.`` is stripped."""
    sd = _as_state_dict(sd)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    frontend = ms.StreamingFrontend(
        _sd(Dense, sd, "frontend.proj", dtype), _sd(Conv1d, sd, "frontend.conv1", dtype),
        _sd(Conv1d, sd, "frontend.conv2", dtype), _sd(Norm, sd, "frontend.norm", dtype))
    enc_layers = [_sd_encoder_layer(sd, f"encoder.layers.{i}", dtype)
                  for i in range(cfg.enc_depth)]
    dec_layers = [_sd_decoder_layer(sd, f"decoder.layers.{i}", dtype)
                  for i in range(cfg.depth)]
    model = ms.StreamingMoonshine(
        frontend,
        ms.StreamingEncoder(_sd(Dense, sd, "encoder.in_proj", dtype), enc_layers,
                            _sd(Norm, sd, "encoder.layer_norm", dtype)),
        ms.Adapter(_sd(Dense, sd, "adapter.proj", dtype), _sd(Norm, sd, "adapter.norm", dtype)),
        mm.Decoder(_tensor(sd["decoder.embed_tokens.weight"]).to(dtype), dec_layers,
                   _sd(Norm, sd, "decoder.norm", dtype)),
    )
    return model.to(resolve_device(device))


# Session membership for the five-file distribution form (which weights
# each of the reference's ONNX sessions holds).
STREAMING_SESSIONS = ("frontend", "encoder", "adapter", "cross_kv", "decoder_kv")


def _session_of(key: str) -> str:
    if key.startswith("frontend."):
        return "frontend"
    if key.startswith("encoder."):
        return "encoder"
    if key.startswith("adapter."):
        return "adapter"
    if ".encoder_attn.k_proj" in key or ".encoder_attn.v_proj" in key:
        return "cross_kv"
    return "decoder_kv"


def split_streaming_sessions(sd: Mapping[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """Partition a flat state dict into the reference's five-session layout."""
    out: dict[str, dict[str, np.ndarray]] = {s: {} for s in STREAMING_SESSIONS}
    for k, v in sd.items():
        out[_session_of(k)][k] = np.asarray(v)
    return out


def load_streaming_checkpoint(
    path: str | os.PathLike,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[ms.StreamingMoonshine, StreamingConfig]:
    """A streaming checkpoint directory -> (model, StreamingConfig).

    Reads, in this order of preference inside ``path``: ``model.safetensors``
    (the canonical flat state dict), ``model.onnx`` (the same names as graph
    initializers), or the reference's five session files
    ``{frontend,encoder,adapter,cross_kv,decoder_kv}.onnx``, whose
    initializers are merged.  ``streaming_config.json`` (the reference's
    field set) gives the architecture; without it, the defaults.
    """
    from .core.onnx_io import load_onnx

    cfg_path = os.path.join(path, "streaming_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = StreamingConfig.from_json(f.read())
    else:
        cfg = StreamingConfig()
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return import_streaming(st, cfg, dtype, device), cfg
    single = os.path.join(path, "model.onnx")
    if os.path.exists(single):
        return import_streaming(load_onnx(single).initializers, cfg, dtype, device), cfg
    merged: dict[str, np.ndarray] = {}
    for session in STREAMING_SESSIONS:
        p = os.path.join(path, f"{session}.onnx")
        if os.path.exists(p):
            merged.update(load_onnx(p).initializers)
    if not merged:
        raise FileNotFoundError(
            f"{path}: no model.safetensors, model.onnx or per-session .onnx files found "
            "(.ort flatbuffer files are a quantized serving artifact; convert from the "
            "float sources)")
    return import_streaming(merged, cfg, dtype, device), cfg
