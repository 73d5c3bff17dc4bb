"""The body of each rank of the spawned process-group test in
``tests/test_torch_parallel.py``.

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
