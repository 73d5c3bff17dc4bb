"""The port's checkpoints against the JAX package's, on the CPU.

- A safetensors file crosses both ways: one the port exports loads in JAX's
  ``import_safetensors`` and equals the port's weights in JAX's layout,
  and one JAX exports loads in the port's and gives the same model, both
  exactly (a copy of float32 values).  The missing-tensor ``KeyError`` and
  the shape-mismatch ``ValueError`` are JAX's.
- A train-state checkpoint round trip resumes the exact next step: the
  step's loss and every parameter after it equal the uninterrupted run's
  bit for bit (the same CPU arithmetic on the same values).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.train import checkpoint as jc
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.train import checkpoint as tc
from moonshine_tpu_torch.train import step as ts

# tests/test_checkpoint.py's CFG.
CFG = MoonshineArchConfig(
    name="ckpt", vocab_size=64, hidden_size=32, intermediate_size=64,
    encoder_layers=1, decoder_layers=1, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _port(params):
    return weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")


def _same_model(a: tm.Moonshine, b: tm.Moonshine) -> None:
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_port_export_loads_in_jax(tmp_path):
    model = tm.init_params(TCFG, torch.Generator().manual_seed(3), "cpu")
    path = tmp_path / "port.safetensors"
    tc.export_safetensors(path, model)
    target = jax.tree.map(jax.numpy.zeros_like, jm.init_params(CFG, jax.random.PRNGKey(0)))
    restored = jc.import_safetensors(path, target)
    ours = weights.flatten_tree(weights.params_to_numpy(model))
    theirs = weights.flatten_tree(jax.tree.map(np.asarray, restored))
    assert set(theirs) == {k for k in ours if "swapped" not in k}
    for k, v in theirs.items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)


def test_jax_export_loads_in_the_port(tmp_path):
    params = jm.init_params(CFG, jax.random.PRNGKey(1))
    path = tmp_path / "jax.safetensors"
    jc.export_safetensors(path, params)
    target = tm.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    _same_model(tc.import_safetensors(path, target, TCFG), _port(params))
    # And back out of the port, value for value.
    again = tmp_path / "again.safetensors"
    tc.export_safetensors(again, tc.import_safetensors(path, target, TCFG))
    a, b = weights.load_safetensors(path), weights.load_safetensors(again)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_import_errors_are_jax_s(tmp_path):
    model = tm.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    path = tmp_path / "m.safetensors"
    tc.export_safetensors(path, model)
    wider = TorchArchConfig(**{**{f: getattr(TCFG, f) for f in TCFG.__dataclass_fields__},
                               "vocab_size": 128})
    other = tm.init_params(wider, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="Shape mismatch for decoder/embed"):
        tc.import_safetensors(path, other, wider)
    flat = weights.load_safetensors(path)
    del flat["decoder/norm/scale"]
    weights.save_safetensors(path, flat)
    with pytest.raises(KeyError, match="decoder/norm/scale"):
        tc.import_safetensors(path, model, TCFG)


def _batch(seed):
    rng = np.random.default_rng(seed)
    b, n, s = 2, 4000, 6
    return ts.Batch(torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)),
                    torch.full((b,), n), torch.from_numpy(rng.integers(0, 64, (b, s))),
                    torch.from_numpy(rng.integers(0, 64, (b, s))), torch.ones((b, s), dtype=bool))


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_train_state_round_trip_resumes_the_exact_next_step(tmp_path, kind):
    opt = getattr(ts, kind)(2e-3)
    step = ts.make_train_step(TCFG, opt)
    state = ts.init_train_state(TCFG, opt, torch.Generator().manual_seed(0), "cpu")
    state, _ = step(state, _batch(0))
    state, _ = step(state, _batch(1))
    path = tmp_path / "state.safetensors"
    tc.save_checkpoint(path, state)
    fresh = ts.init_train_state(TCFG, opt, torch.Generator().manual_seed(9), "cpu")
    restored = tc.restore_checkpoint(path, fresh)
    assert restored.step == 2
    _same_model(restored.params, state.params)
    cont, m1 = step(state, _batch(2))
    resumed, m2 = step(restored, _batch(2))
    assert resumed.step == cont.step == 3
    assert torch.equal(m1["loss"], m2["loss"])
    _same_model(resumed.params, cont.params)
