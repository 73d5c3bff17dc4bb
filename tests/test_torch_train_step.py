"""The port's ASR train step against the JAX package's, on the CPU.

- ``asr_loss`` and its gradients against ``jax.value_and_grad`` of JAX's,
  on JAX's weights and one numpy batch with ragged audio and token masks:
  the loss to rtol 1e-5, the token accuracy exactly, and every gradient
  leaf within 1e-4 of that leaf's largest |g| (float32 sums in another
  order; Adam's first step would amplify a near-zero element's rounding to
  a full learning-rate step, so the updated parameters are not compared to
  a float32 tolerance).
- The optimizers alone, fed JAX's gradients: ``adamw`` against
  ``optax.adamw`` and ``adam`` against ``optax.adam``, three updates, each
  from JAX's parameters, to one float32 step of the parameter (rtol
  1.2e-7) plus atol 3e-8: optax takes the bias correction 1 - 0.999^t in
  float32, 1.3e-5 off its value at t = 1, where torch takes it in double,
  so an update of about lr = 1e-3 moves by about 1e-8.
- The step: three steps lower the loss, count, and keep the encoder's
  rotary copies equal to their permutation of q and k.
- The encoder attention kernels' wrappers (K1, K2 and the two sharded
  ones) refuse an input that requires grad, naming ``attn_impl="xla"``; on
  the card too (a ``cuda`` test).  The check holds no reference to what
  it saw: K1's and K2's inputs are freed after an ``inference_mode`` call.
"""

from __future__ import annotations

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.train import step as js
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.ops import encoder_attention as ea
from moonshine_tpu_torch.ops.rotary import pair_swap_perm
from moonshine_tpu_torch.train import step as ts

CFG = MoonshineArchConfig(
    name="train", vocab_size=96, hidden_size=32, intermediate_size=64, encoder_layers=2,
    decoder_layers=2, encoder_heads=4, decoder_heads=4, encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
GRAD_REL = 1e-4
OPT_TOL = dict(atol=3e-8, rtol=1.2e-7)
# One compiled program for the JAX loss and gradients (CFG is static).
JAX_GRAD = jax.jit(jax.value_and_grad(js.asr_loss, has_aux=True), static_argnums=1)


def batch_arrays(seed=0, b=3, n=6000, s=7, vocab=96):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    lengths = np.array([n, 3 * n // 4, 5 * n // 6][:b], np.int32)
    tokens_in = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tokens_out = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.arange(s)[None] < np.array([s, 4, 5][:b])[:, None]
    return audio, lengths, tokens_in, tokens_out, mask


def torch_batch(arrays) -> ts.Batch:
    audio, lengths, ti, to, mask = arrays
    return ts.Batch(torch.from_numpy(audio), torch.from_numpy(lengths.astype(np.int64)),
                    torch.from_numpy(ti.astype(np.int64)), torch.from_numpy(to.astype(np.int64)),
                    torch.from_numpy(mask))


def jax_batch(arrays) -> js.Batch:
    return js.Batch(*map(jnp.asarray, arrays))


def grads_as_jax_tree(model) -> dict[str, np.ndarray]:
    """The trainable parameters' gradients in the JAX package's flat names
    and layouts (the derived rotary copies dropped)."""
    g = copy.deepcopy(model)
    for (_, p), (_, q) in zip(ts.trainable_parameters(g), ts.trainable_parameters(model)):
        p.data = q.grad.detach().clone()
    return {k: v for k, v in weights.flatten_tree(weights.params_to_numpy(g)).items()
            if "swapped" not in k}


def assert_grads_close(ours: dict, ref: dict, rel: float = GRAD_REL) -> None:
    assert set(ours) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        bound = rel * max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(ours[k] - v).max())
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(0))


def port_model(jax_params):
    return weights.params_from_jax_numpy(jax.tree.map(np.asarray, jax_params), TCFG, "cpu")


def test_asr_loss_and_gradients_match_jax(jax_params):
    arrays = batch_arrays()
    (loss, met), grads = JAX_GRAD(jax_params, CFG, jax_batch(arrays))
    state = ts.make_train_state(port_model(jax_params), ts.adamw(1e-3))
    with torch.enable_grad():
        tloss, tmet = ts.asr_loss(state.params, TCFG, torch_batch(arrays))
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert float(tmet["token_accuracy"]) == pytest.approx(float(met["token_accuracy"]))
    assert_grads_close(grads_as_jax_tree(state.params),
                       weights.flatten_tree(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_optimizer_matches_optax_on_jax_gradients(jax_params, kind):
    lr = 1e-3
    tx = optax.adamw(lr) if kind == "adamw" else optax.adam(lr)
    arrays = batch_arrays(1)
    params = jax_params
    opt_state = tx.init(params)
    model = port_model(jax_params)
    named = dict(ts.trainable_parameters(model))
    for p in named.values():
        p.requires_grad_(True)
    opt = getattr(ts, kind)(lr)(list(named.values()))
    for _ in range(3):
        # Both start each update from JAX's parameters, so that what is
        # compared is one update's rounding; the moments run on.
        start = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
        with torch.no_grad():
            for name, p in ts.trainable_parameters(start):
                named[name].copy_(p)
        (_, _), grads = JAX_GRAD(params, CFG, jax_batch(arrays))
        updates, opt_state = tx.update(grads, opt_state, params)
        # The same gradients into the port's parameters, in its layout.
        gmodel = weights.params_from_jax_numpy(jax.tree.map(np.asarray, grads), TCFG, "cpu")
        for name, g in ts.trainable_parameters(gmodel):
            named[name].grad = g.detach().clone()
        opt.step()
        params = optax.apply_updates(params, updates)
        ours = {k: v for k, v in weights.flatten_tree(weights.params_to_numpy(model)).items()
                if "swapped" not in k}
        for k, v in weights.flatten_tree(jax.tree.map(np.asarray, params)).items():
            np.testing.assert_allclose(ours[k], v, err_msg=k, **OPT_TOL)


def test_adamw_takes_optax_defaults():
    opt = ts.adamw(3e-4)([torch.nn.Parameter(torch.zeros(2))])
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["lr"] == 3e-4


def test_train_steps_lower_the_loss_and_refresh_the_rotary_copies(jax_params):
    state = ts.make_train_state(port_model(jax_params), ts.adamw(3e-3))
    step = ts.make_train_step(TCFG, ts.adamw(3e-3))
    batch = torch_batch(batch_arrays(2))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == 3 and losses[-1] < losses[0]
    half = TCFG.rotary_dim // 2
    perm = torch.from_numpy(pair_swap_perm(TCFG.head_dim, half, TCFG.encoder_heads))
    for lp in state.params.encoder.layers:
        a = lp.attn
        assert torch.equal(a.q_swapped.weight, a.q.weight[perm])
        assert torch.equal(a.k_swapped.weight, a.k.weight[perm])
        assert not a.q_swapped.weight.requires_grad
    # The caller's model is not trained in place.
    ref = port_model(jax_params)
    assert torch.equal(ref.decoder.embed, port_model(jax_params).decoder.embed)


def test_init_train_state_on_the_cpu():
    state = ts.init_train_state(TCFG, ts.adamw(1e-3), torch.Generator().manual_seed(0), "cpu")
    names = [n for n, _ in ts.trainable_parameters(state.params)]
    assert state.step == 0 and not any("swapped" in n for n in names)
    assert all(p.requires_grad for _, p in ts.trainable_parameters(state.params))
    assert state.params.decoder.embed.device.type == "cpu"


def _attention_inputs(device, requires_grad=True):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 8, 4, 8), generator=g).to(device).requires_grad_(requires_grad)
               for _ in range(3))
    return q, k, v


def _refusals(q, k, v):
    kt = k.flatten(2).transpose(1, 2)
    return {
        "encoder_attention_packed": lambda: ea.encoder_attention_packed(
            q.flatten(2), kt, v.flatten(2), None, 4),
        "encoder_attention": lambda: ea.encoder_attention(q, k, v, None),
        "encoder_attention_sharded": lambda: ea.encoder_attention_sharded(q, k, v, None, None),
        "encoder_attention_packed_sharded": lambda: ea.encoder_attention_packed_sharded(
            q.flatten(2), kt, v.flatten(2), None, 4, None),
    }


@pytest.mark.parametrize("name", ["encoder_attention_packed", "encoder_attention",
                                  "encoder_attention_sharded",
                                  "encoder_attention_packed_sharded"])
def test_attention_kernels_refuse_autograd(name):
    q, k, v = _attention_inputs("cpu")
    with pytest.raises(RuntimeError, match='attn_impl="xla"'):
        _refusals(q, k, v)[name]()
    with torch.no_grad():  # no graph to cut: the plain version runs
        if "sharded" not in name:
            assert _refusals(q, k, v)[name]().shape[0] == 2


@pytest.mark.parametrize("name", ["encoder_attention_packed", "encoder_attention"])
def test_attention_wrappers_hold_no_reference_to_their_inputs(name):
    """The grad check keeps nothing: inputs a call saw are freed after it,
    and a tensor seen once with grad off is checked again with grad on."""
    q, k, v = _attention_inputs("cpu")
    with torch.no_grad():
        _refusals(q, k, v)[name]()
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        _refusals(q, k, v)[name]()
    q, k, v = _attention_inputs("cpu", requires_grad=False)
    refs = [weakref.ref(x) for x in (q, k, v)]
    with torch.inference_mode():
        out = _refusals(q, k, v)[name]()
    del q, k, v
    gc.collect()
    assert out.shape[0] == 2 and all(r() is None for r in refs)


def test_training_through_the_packed_attention_raises(jax_params):
    state = ts.make_train_state(port_model(jax_params), ts.adamw(1e-3))
    audio = torch.from_numpy(batch_arrays()[0])
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        tm.encode(state.params, TCFG, audio)  # attn_impl="auto": K1


@pytest.mark.cuda
def test_attention_kernels_refuse_autograd_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = _attention_inputs("cuda")
    for name, call in _refusals(q, k, v).items():
        with pytest.raises(RuntimeError, match='attn_impl="xla"'):
            call()
