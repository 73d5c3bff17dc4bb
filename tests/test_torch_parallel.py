"""The port's parallel layer against the JAX package's, on the CPU.

- The per-rank bodies of ``encoder_attention_sharded`` (K2) and
  ``encoder_attention_packed_sharded`` (K1), run in one process at every
  coordinate of a 4x2 (data, model) mesh and assembled, against the JAX
  ``shard_map`` wrappers on the conftest's 8 virtual devices (Pallas in
  interpret mode): float32 atol 2e-5 / rtol 1e-4, as the JAX tests hold
  their kernels.
- Four spawned ranks on a 2x2 gloo mesh: ``encode(attn_impl="pallas_shmap")``
  of each rank's rows against JAX's ``encode`` (atol 5e-5 / rtol 1e-4, as
  ``tests/test_encoder_attention.py`` holds the sharded encode), and a
  data-parallel greedy decode (``shard_batch`` -> decode ->
  ``host_local_batch_to_global``) against JAX's ``greedy_decode``: tokens
  and lengths equal.  The parent joins the ranks against a deadline and
  kills them all past it, so a hung rank fails this test, not the suite.
- A world-1 group in this process: the 1x1 mesh, the sharded wrappers equal
  to the unsharded ones bit for bit, and the errors.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_parallel_ranks
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.decoding.greedy import greedy_decode as jax_greedy
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.ops import encoder_attention as jea
from moonshine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.ops import encoder_attention as ea
from moonshine_tpu_torch.parallel import distributed, mesh as pmesh, sharding

F32 = dict(atol=2e-5, rtol=1e-4)
ENCODE = dict(atol=5e-5, rtol=1e-4)
DEADLINE_S = 120
# The config of tests/test_encoder_attention.py's sharded encode test.
CFG = MoonshineArchConfig(
    name="t", vocab_size=128, hidden_size=64, intermediate_size=128,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _qkv(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) for _ in range(3))
    return q, k, v, rng.random((b, t)) > 0.2


def _assemble(body, b, t, width, n_data=4, n_model=2):
    """Every rank's block of a 4x2 mesh, run here one after another, put
    back at its rows and its heads (axis 2)."""
    out = None
    for d in range(n_data):
        for m in range(n_model):
            block = body((d, m), (n_data, n_model))
            if out is None:
                out = torch.empty((b, t, width) + tuple(block.shape[3:]), dtype=block.dtype)
            rb, hb = block.shape[0], block.shape[2]
            out[d * rb:(d + 1) * rb, :, m * hb:(m + 1) * hb] = block
    return out.numpy()


def test_head_major_bodies_on_4x2_match_jax_shard_map():
    b, t, h, hd = 8, 96, 4, 16
    q, k, v, mask = _qkv(0, b, t, h, hd)
    ref = jea.encoder_attention_sharded(*map(jnp.asarray, (q, k, v, mask)),
                                        jax_make_mesh(data=4, model=2), interpret=True)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    out = _assemble(lambda c, s: ea.encoder_attention_sharded_body(tq, tk, tv, tmask, c, s),
                    b, t, h)
    # Valid query rows, as the JAX tests compare them: padded rows are
    # dropped downstream by the frame mask.
    np.testing.assert_allclose(out[mask], np.asarray(ref)[mask], **F32)


def test_packed_bodies_on_4x2_match_jax_shard_map():
    b, t, h, hd = 8, 64, 4, 16
    q, k, v, mask = _qkv(5, b, t, h, hd)
    qp, vp = q.reshape(b, t, h * hd), v.reshape(b, t, h * hd)
    ktp = np.ascontiguousarray(k.reshape(b, t, h * hd).transpose(0, 2, 1))
    ref = jea.encoder_attention_packed_sharded(*map(jnp.asarray, (qp, ktp, vp, mask)), h,
                                               jax_make_mesh(data=4, model=2), interpret=True)
    tq, tkt, tv, tmask = map(torch.from_numpy, (qp, ktp, vp, mask))
    out = _assemble(
        lambda c, s: ea.encoder_attention_packed_sharded_body(tq, tkt, tv, tmask, h, c, s),
        b, t, h * hd)
    np.testing.assert_allclose(out[mask], np.asarray(ref)[mask], **F32)


@pytest.mark.parametrize("which", ["head_major", "packed"])
def test_bodies_reject_heads_not_divisible_by_model(which):
    q, k, v, mask = map(torch.from_numpy, _qkv(1, 4, 8, 4, 4))
    with pytest.raises(ValueError, match="heads 4 not divisible by model axis 3"):
        if which == "head_major":
            ea.encoder_attention_sharded_body(q, k, v, mask, (0, 0), (1, 3))
        else:
            ea.encoder_attention_packed_sharded_body(
                q.flatten(2), k.flatten(2).transpose(1, 2), v.flatten(2), mask, 4, (0, 0), (1, 3))
    with pytest.raises(ValueError, match="batch 4 not divisible by 3"):
        ea.encoder_attention_sharded_body(q, k, v, mask, (0, 0), (3, 1))


def test_world_one_group_and_its_mesh():
    """A single process that asks for a mesh gets a world-1 group; on its
    1x1 mesh the sharded paths are the unsharded ones, bit for bit."""
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh(data=1, model=1, device_type="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == (pmesh.DATA_AXIS, pmesh.MODEL_AXIS)
        assert tuple(mesh.shape) == (1, 1)
        for data, model in ((2, 1), (None, 2), (1, 2)):
            with pytest.raises(ValueError, match="world size"):
                pmesh.make_mesh(data=data, model=model, device_type="cpu")
        assert distributed.global_mesh(device_type="cpu").shape == mesh.shape
        assert pmesh.data_sharding(mesh) == [dist.tensor.Shard(0), dist.tensor.Replicate()]
        assert pmesh.replicated(mesh) == [dist.tensor.Replicate()] * 2
        assert sharding.batch_pspec(3) == ("data", None, None)

        q, k, v, mask = map(torch.from_numpy, _qkv(2, 2, 24, 4, 8))
        assert torch.equal(ea.encoder_attention_sharded(q, k, v, mask, mesh),
                           ea.encoder_attention(q, k, v, mask))
        kt = k.flatten(2).transpose(1, 2).contiguous()
        assert torch.equal(
            ea.encoder_attention_packed_sharded(q.flatten(2), kt, v.flatten(2), None, 4, mesh),
            ea.encoder_attention_packed(q.flatten(2), kt, v.flatten(2), None, 4))

        params = jm.init_params(CFG, jax.random.PRNGKey(0))
        model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
        audio = torch.from_numpy(
            np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32) * 0.1)
        ref = tm.encode(model, TCFG, audio)
        got = tm.encode(model, TCFG, sharding.shard_batch(mesh, audio),
                        attn_impl="pallas_shmap", mesh=mesh)
        got = distributed.host_local_batch_to_global(mesh, got)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        with pytest.raises(ValueError, match="needs a mesh"):
            tm.encode(model, TCFG, audio, attn_impl="pallas_shmap")
        assert distributed.all_reduce_metrics({"n": 3, "s": 1.5}, mesh) == {"n": 3.0, "s": 1.5}
    finally:
        dist.destroy_process_group()
    assert distributed.all_reduce_metrics({"n": 2}) == {"n": 2.0}


def test_spawned_2x2_gloo_encode_and_greedy_match_jax(tmp_path):
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((4, 8000)) * 0.1).astype(np.float32)
    lengths = np.array([8000, 6100, 7000, 4200], np.int32)
    ref_mem, ref_mask = jax.jit(jm.encode, static_argnames=("cfg",))(
        params, CFG, jnp.asarray(audio), jnp.asarray(lengths))
    ref = jax_greedy(params, CFG, ref_mem, ref_mask, max_tokens=8)

    world = 4
    ctx = mp.start_processes(
        torch_parallel_ranks.encode_and_greedy,
        args=(world, f"file://{tmp_path / 'rendezvous'}", str(tmp_path),
              jax.tree.map(np.asarray, params), TCFG, audio, lengths.astype(np.int64), 8),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()

    coords = set()
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        coords.add(tuple(got["coord"]))
        assert not got["jax_loaded"]
        assert "world size" in str(got["world_error"])
        assert float(got["rows"]) == 4  # the data group's rows, each counted once
        np.testing.assert_allclose(got["memory"], np.asarray(ref_mem), **ENCODE)
        np.testing.assert_array_equal(got["mask"], np.asarray(ref_mask))
        np.testing.assert_array_equal(got["tokens"], np.asarray(ref.tokens))
        np.testing.assert_array_equal(got["lengths"], np.asarray(ref.lengths))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
