"""Quantization accuracy harness: float32 against int8 weights, in PyTorch.

Counterpart of the JAX package's ``eval/quant_eval.py`` (the reference's
quantization protocol: quantize the weights, run the same decode pipeline,
compare the outputs).  On random weights it reports token-level agreement
and the model-size table; with real checkpoints the comparison becomes
corpus WER (``eval/librispeech.py`` takes any model).  Everything runs on
the device the model is on: CUDA unless ``device`` names another.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _without_rotary_copies(tree: dict) -> dict:
    """A numpy parameter tree without the encoder's pair-swapped rotary
    projections (load-time copies the JAX tree of ``init_params`` lacks),
    so that the sizes are the JAX harness's."""
    attn = tree["encoder"]["layers"]["attn"]
    kept = {k: v for k, v in attn.items() if k not in ("q_swapped", "k_swapped")}
    layers = dict(tree["encoder"]["layers"], attn=kept)
    return dict(tree, encoder=dict(tree["encoder"], layers=layers))


def compare_decodes(
    arch: str = "tiny",
    n_clips: int = 8,
    seconds: float = 4.0,
    per_channel: bool = True,
    seed: int = 0,
    w8a8: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """Greedy decodes of random-weight clips with float32 and fake-quantized
    weights (and, with ``w8a8``, with exec-quantized weights run as int8 x
    int8 products), their agreement, and the float and int8 sizes."""
    from ..core.config import ARCHS
    from ..core.device import resolve_device
    from ..decoding.greedy import greedy_decode
    from ..models import moonshine as mm
    from ..quant import fake_quantize_tree, quantize_tree, quantize_tree_exec, tree_nbytes
    from ..weights import params_from_jax_numpy, params_to_numpy

    cfg = ARCHS[arch]
    dev = resolve_device(device)
    model = mm.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    tree = params_to_numpy(model)
    model_q = params_from_jax_numpy(fake_quantize_tree(tree, per_channel=per_channel), cfg, dev)

    rng = np.random.RandomState(seed)
    audio = torch.from_numpy(
        rng.randn(n_clips, int(16000 * seconds)).astype(np.float32) * 0.1).to(dev)
    max_tokens = int(seconds * cfg.max_tokens_per_second)

    @torch.inference_mode()
    def decode(m):
        memory, mask = mm.encode(m, cfg, audio)
        res = greedy_decode(m, cfg, memory, mask, max_tokens=max_tokens)
        return res.tokens.cpu().numpy(), res.lengths.cpu().numpy()

    def agreement(a, la, b, lb):
        exact = float(np.mean([
            np.array_equal(a[i, :la[i]], b[i, :lb[i]]) for i in range(n_clips)]))
        return exact, float((a == b).mean())

    t_f, l_f = decode(model)
    t_q, l_q = decode(model_q)
    agree, tok_agree = agreement(t_f, l_f, t_q, l_q)
    plain = _without_rotary_copies(tree)
    packed = quantize_tree(plain)
    out = {
        "arch": arch,
        "per_channel": per_channel,
        "clips": n_clips,
        "device": str(dev),
        "exact_sequence_agreement": agree,
        "token_agreement": tok_agree,
        "fp32_bytes": tree_nbytes(plain),
        "int8_bytes": tree_nbytes(packed),
        "size_ratio": round(tree_nbytes(packed) / tree_nbytes(plain), 3),
    }
    if w8a8:
        t_x, l_x = decode(quantize_tree_exec(model))
        exact_x, tok_x = agreement(t_f, l_f, t_x, l_x)
        out["w8a8_exact_sequence_agreement"] = exact_x
        out["w8a8_token_agreement"] = tok_x
    return out


def main() -> None:  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tiny")
    p.add_argument("--per-tensor", action="store_true")
    p.add_argument("--w8a8", action="store_true",
                   help="also decode with int8 execution (int8 x int8 -> int32 products)")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args()
    print(json.dumps(compare_decodes(args.arch, per_channel=not args.per_tensor,
                                     w8a8=args.w8a8, device=args.device)))


if __name__ == "__main__":  # pragma: no cover
    main()
