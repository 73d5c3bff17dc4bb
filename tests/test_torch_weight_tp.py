"""Weight tensor parallelism in the port against the JAX package, on the CPU.

- ``param_pspecs`` against JAX's rules (tests/test_sharding.py's): every
  parameter of the port's tree has the layout JAX's ``param_pspecs`` gives
  its leaf, read in the port's ``[out, in]`` layout without the stacked
  layer axis; the rotary copies take q's and k's.
- On a world-1 gloo group's 1x1 mesh, ``shard_params`` runs the same
  arithmetic over a group of one: the encode, a greedy decode and a train
  step (loss and every parameter after it) equal the unsharded ones bit for
  bit.
- Four spawned ranks on a 2x2 gloo mesh run the sharded train step against
  the single-process step on the whole batch, with the two data rows'
  token counts unequal (5 against 12), so a mean of per-rank means would
  differ from the global mean: the loss within rtol 1e-4
  (tests/test_sharding.py's bound), each rank's reduced gradient blocks
  within 1e-4 of each leaf's largest |g|, and the replicated parameters
  bit-identical on all four ranks after the update.
- Two spawned ranks on a 1x2 gloo mesh: ``evaluate(mesh=)`` (greedy and
  beam 3) gives the texts and WER of ``evaluate()``.
The parent joins the ranks against a deadline and kills them past it.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_parallel_ranks
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.audio.wav import save_wav
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.tokenizer import BinTokenizer
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.eval.librispeech import evaluate
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.models.layers import Norm
from moonshine_tpu_torch.parallel import mesh as pmesh
from moonshine_tpu_torch.parallel import sharding
from moonshine_tpu_torch.train import step as ts

DEADLINE_S = 150
GRAD_REL = 1e-4
# tests/test_sharding.py's CFG, narrowed.
CFG = MoonshineArchConfig(
    name="tp", vocab_size=128, hidden_size=32, intermediate_size=64, encoder_layers=2,
    decoder_layers=2, encoder_heads=4, decoder_heads=4, encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


@pytest.fixture(scope="module")
def params():
    return jm.init_params(CFG, jax.random.PRNGKey(0))


def _model(params):
    return weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")


def _jax_spec(jspecs: dict, model: tm.Moonshine, name: str) -> tuple:
    """JAX's layout of the leaf that the port's parameter ``name`` holds,
    in the port's axis order."""
    *path, leaf = name.split(".")
    holder = model.get_submodule(".".join(path))
    keys = [k for k in path if not k.isdigit()]
    if leaf == "embed":
        return tuple(jspecs["decoder"]["embed"])
    jleaf = ({"weight": "scale", "bias": "bias"} if isinstance(holder, Norm)
             else {"weight": "w", "bias": "b"})[leaf]
    node = jspecs
    for k in keys + [jleaf]:
        node = node[k]
    spec = tuple(node)
    if "layers" in keys and spec:
        spec = spec[1:]  # the stacked layer axis
    if jleaf == "w" and len(spec) == 2:
        spec = spec[::-1]  # [in, out] -> [out, in]
    return spec


def test_param_pspecs_follow_jax_s_rules(params):
    model = _model(params)
    ours = sharding.param_pspecs(model)
    jspecs = jax_param_pspecs(params)
    for name, spec in ours.items():
        if "swapped" in name:
            assert spec == ours[name.replace("_swapped", "")], name
            continue
        assert spec == _jax_spec(jspecs, model, name), name
    # tests/test_sharding.py's cases, in the port's names.
    assert ours["encoder.layers.0.attn.q.weight"] == ("model", None)
    assert ours["encoder.layers.0.attn.o.weight"] == (None, "model")
    assert ours["encoder.layers.1.mlp.fc1.weight"] == ("model", None)
    assert ours["encoder.layers.1.mlp.fc2.weight"] == (None, "model")
    assert ours["encoder.layers.0.ln1.weight"] == ()
    assert ours["decoder.embed"] == ("model", None)
    assert ours["frontend.conv1.weight"] == ()


def test_shard_tensor_blocks_and_paired_halves():
    x = torch.arange(16.0).reshape(8, 2)
    assert torch.equal(sharding.shard_tensor("encoder.layers.0.mlp.fc1.weight", x,
                                             ("model", None), 1, 2), x[4:])
    # The decoder's SwiGLU fc1: block 1 of each half, so gate meets its half.
    paired = sharding.shard_tensor("decoder.layers.0.mlp.fc1.weight", x, ("model", None), 1, 2)
    assert torch.equal(paired, torch.cat([x[2:4], x[6:8]]))
    assert torch.equal(sharding.shard_tensor("decoder.norm.weight", x[0], (), 1, 2), x[0])
    with pytest.raises(ValueError, match="not divisible"):
        sharding.shard_tensor("decoder.layers.0.mlp.fc1.weight", x, ("model", None), 0, 3)


def _batch_arrays(seed=0, b=4, n=4000, s=6, counts=(4, 1, 6, 6)):
    """A batch whose first two rows (data rank 0) hold 5 real tokens and
    whose last two (data rank 1) hold 12."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n)) * 0.1).astype(np.float32),
            np.array([n, 3000, 3500, n], np.int64),
            rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int64),
            rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int64),
            np.arange(s)[None] < np.array(counts)[:, None])


def _torch_batch(arrays) -> ts.Batch:
    return ts.Batch(*(torch.from_numpy(a) for a in arrays))


def test_one_by_one_mesh_equals_the_unsharded_model_bit_for_bit(params):
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh(data=1, model=1, device_type="cpu")
        model = _model(params)
        split = sharding.shard_params(mesh, model)
        assert all(lp.attn.tp is not None for lp in split.encoder.layers)
        assert model.decoder.tp is None  # the caller's model is not changed
        audio = torch.from_numpy(_batch_arrays()[0])
        with torch.inference_mode():
            ref = tm.encode(model, TCFG, audio, attn_impl="xla")
            got = tm.encode(split, TCFG, audio, attn_impl="xla")
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
            assert torch.equal(tm.encode(split, TCFG, audio)[0], tm.encode(model, TCFG, audio)[0])
            g_ref = greedy_decode(model, TCFG, *ref, max_tokens=6)
            g_got = greedy_decode(split, TCFG, *got, max_tokens=6)
            assert torch.equal(g_ref.tokens, g_got.tokens)
        with pytest.raises(ValueError, match="already holds only its heads"):
            tm.encode(split, TCFG, audio, attn_impl="pallas_shmap", mesh=mesh)

        opt = ts.adamw(1e-3)
        batch = _torch_batch(_batch_arrays())
        plain, m_plain = ts.make_train_step(TCFG, opt)(ts.make_train_state(model, opt), batch)
        state = ts.shard_train_state(mesh, ts.make_train_state(model, opt))
        assert ts.state_pspecs(state).params == sharding.param_pspecs(state.params)
        sharded, m_sharded = ts.make_train_step(TCFG, opt, mesh)(state, batch)
        assert torch.equal(m_plain["loss"], m_sharded["loss"])
        specs = ts.state_pspecs(sharded)
        for name, p in dict(plain.params.named_parameters()).items():
            assert torch.equal(p, dict(sharded.params.named_parameters())[name]), name
        assert specs.opt_state["decoder.embed"]["exp_avg"] == ("model", None)
        assert ts.batch_pspecs() == ts.Batch(("data", None), ("data",), ("data", None),
                                             ("data", None), ("data", None))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, tmp_path, *args) -> list:
    ctx = mp.start_processes(fn, args=(world, f"file://{tmp_path / 'rendezvous'}",
                                       str(tmp_path), *args),
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
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def test_spawned_2x2_sharded_train_step_matches_the_single_process_step(params, tmp_path):
    arrays = _batch_arrays()
    lr = 1e-3
    state = ts.make_train_state(_model(params), ts.adamw(lr))
    with torch.enable_grad():
        loss, _ = ts.asr_loss(state.params, TCFG, _torch_batch(arrays))
        loss.backward()
    grads = {n: p.grad for n, p in ts.trainable_parameters(state.params)}

    ranks = _spawn(torch_parallel_ranks.sharded_train_step, 4, tmp_path,
                   jax.tree.map(np.asarray, params), TCFG, arrays, lr)
    assert sorted(int(r["tokens"]) for r in ranks) == [5, 5, 12, 12]
    specs = sharding.param_pspecs(state.params)
    for r in ranks:
        assert not r["jax_loaded"]
        np.testing.assert_allclose(float(r["loss"]), float(loss.detach()), rtol=1e-4)
        _, m = r["coord"]
        for name, g in grads.items():
            want = sharding.shard_tensor(name, g, specs[name], int(m), 2).numpy()
            bound = GRAD_REL * max(float(np.abs(g.numpy()).max()), 1e-30)
            err = float(np.abs(r[f"grad/{name}"] - want).max())
            assert err <= bound, f"rank {tuple(r['coord'])} {name}: {err:.3e} > {bound:.3e}"
    for name in grads:
        same = [r for r in ranks if "model" not in specs[name]
                or r["coord"][1] == ranks[0]["coord"][1]]
        for r in same[1:]:
            assert np.array_equal(r[f"param/{name}"], same[0][f"param/{name}"]), name


def _corpus(root, seconds=(1.2, 2.0, 2.6, 3.4), seed=1):
    rng = np.random.default_rng(seed)
    for i, s in enumerate(seconds):
        save_wav(str(root / f"clip{i}.wav"),
                 (rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32), 16000)
        (root / f"clip{i}.txt").write_text(f"W{3 + i} W{10 + i} SOME\n")


def test_spawned_evaluate_on_a_1x2_mesh_equals_evaluate(params, tmp_path):
    root = tmp_path / "corpus"
    root.mkdir()
    _corpus(root)
    tok = tmp_path / "tokenizer.bin"
    tok.write_bytes(BinTokenizer([b"<unk>", b"<s>", b"</s>"] + [
        f"▁w{i}".encode() for i in range(3, CFG.vocab_size)]).to_bytes())
    # Larger weights than the initializer's make the random model emit a
    # few tokens before EOS (tests/test_torch_eval.py's scaling).
    tree = jax.tree.map(lambda a: np.asarray(a) * 3.0 if a.ndim >= 2 else np.asarray(a), params)
    model = weights.params_from_jax_numpy(tree, TCFG, "cpu")
    ranks = _spawn(torch_parallel_ranks.evaluate_on_mesh, 2, tmp_path, tree, TCFG, str(root),
                   str(tok), (1, 3))
    for beam in (1, 3):
        ref = evaluate(model, TCFG, BinTokenizer.from_file(str(tok)), str(root), batch_size=3,
                       beam_size=beam, return_texts=True)
        assert any(ref["hyps"])
        for r in ranks:
            assert list(r[f"hyps{beam}"]) == ref["hyps"]
            assert float(r[f"wer{beam}"]) == ref["wer"]
