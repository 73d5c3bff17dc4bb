"""The bodies of the ranks of the spawned process-group tests in
``tests/test_torch_parallel.py`` and ``tests/test_torch_weight_tp.py``.

Every spawned rank imports this module, so it imports only torch, numpy and
the port (no JAX): the ranks stay light, and the run shows that the port's
parallel layer stands without JAX.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from moonshine_tpu_torch import weights
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.models import moonshine as mm
from moonshine_tpu_torch.parallel.distributed import (
    all_reduce_metrics,
    host_local_batch_to_global,
    initialize,
)
from moonshine_tpu_torch.parallel.mesh import make_mesh
from moonshine_tpu_torch.parallel.sharding import shard_batch


def encode_and_greedy(rank: int, world: int, init_method: str, out_dir: str, tree: dict, cfg,
                      audio: np.ndarray, lengths: np.ndarray, max_tokens: int) -> None:
    """On a 2 x (world / 2) gloo mesh: this rank's rows of the batch, their
    encode with the sharded packed attention, a greedy decode of them, and
    the whole batch's memory, mask, tokens and lengths gathered back; saved
    to ``out_dir/rank<r>.npz`` with what the rank checked on its own."""
    torch.set_num_threads(1)
    initialize(init_method=init_method, world_size=world, rank=rank, device="cpu")
    try:
        mesh = make_mesh(data=2, model=world // 2, device_type="cpu")
        try:
            make_mesh(data=3, model=world // 2, device_type="cpu")
            world_error = ""
        except ValueError as e:
            world_error = str(e)
        model = weights.params_from_jax_numpy(tree, cfg, "cpu")
        rows, row_lengths = shard_batch(mesh, (torch.from_numpy(audio), torch.from_numpy(lengths)))
        memory, mask = mm.encode(model, cfg, rows, row_lengths, attn_impl="pallas_shmap",
                                 mesh=mesh)
        res = greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens)
        full_memory, full_mask, full = host_local_batch_to_global(mesh, (memory, mask, res))
        counted = all_reduce_metrics({"rows": rows.shape[0]}, mesh)
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", memory=full_memory.numpy(),
                 mask=full_mask.numpy(), tokens=full.tokens.numpy(),
                 lengths=full.lengths.numpy(), coord=np.array(mesh.get_coordinate()),
                 rows=counted["rows"], world_error=world_error,
                 jax_loaded="jax" in sys.modules)
    finally:
        dist.destroy_process_group()


def sharded_train_step(rank: int, world: int, init_method: str, out_dir: str, tree: dict, cfg,
                       arrays: tuple, lr: float) -> None:
    """One AdamW step of the ASR loss on a 2 x (world / 2) gloo mesh: the
    weights split over ``model`` (``shard_train_state``), this rank's data
    rows of the batch.  Saves the metrics, every parameter's reduced
    gradient and its value after the step (this rank's blocks) to
    ``out_dir/rank<r>.npz``."""
    from moonshine_tpu_torch.train import step as ts

    torch.set_num_threads(1)
    initialize(init_method=init_method, world_size=world, rank=rank, device="cpu")
    try:
        mesh = make_mesh(data=2, model=world // 2, device_type="cpu")
        model = weights.params_from_jax_numpy(tree, cfg, "cpu")
        opt = ts.adamw(lr)
        state = ts.shard_train_state(mesh, ts.make_train_state(model, opt, copy_params=False))
        batch = shard_batch(mesh, ts.Batch(*(torch.from_numpy(a) for a in arrays)))
        state, metrics = ts.make_train_step(cfg, opt, mesh)(state, batch)
        out = {"loss": metrics["loss"].numpy(), "accuracy": metrics["token_accuracy"].numpy(),
               "coord": np.array(mesh.get_coordinate()), "jax_loaded": "jax" in sys.modules,
               "tokens": batch.token_mask.sum().numpy()}
        for name, p in ts.trainable_parameters(state.params):
            out[f"grad/{name}"] = p.grad.numpy()
            out[f"param/{name}"] = p.detach().numpy()
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def evaluate_on_mesh(rank: int, world: int, init_method: str, out_dir: str, tree: dict, cfg,
                     root: str, tok_path: str, beam_sizes: tuple) -> None:
    """``eval.librispeech.evaluate(mesh=)`` on a 1 x world gloo mesh (the
    weights split over ``model``), greedy and beam; the texts and WERs saved
    to ``out_dir/rank<r>.npz``."""
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.eval.librispeech import evaluate

    torch.set_num_threads(1)
    initialize(init_method=init_method, world_size=world, rank=rank, device="cpu")
    try:
        mesh = make_mesh(data=1, model=world, device_type="cpu")
        model = weights.params_from_jax_numpy(tree, cfg, "cpu")
        out = {}
        for beam in beam_sizes:
            res = evaluate(model, cfg, BinTokenizer.from_file(tok_path), root, batch_size=3,
                           beam_size=beam, mesh=mesh, return_texts=True)
            out[f"hyps{beam}"] = np.array(res["hyps"])
            out[f"wer{beam}"] = np.array(res["wer"])
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
