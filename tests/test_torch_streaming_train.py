"""The port's streaming trainer against the JAX package's, on the CPU.

- ``streaming_asr_loss`` and its gradients against ``jax.value_and_grad``
  of JAX's on JAX's weights (carried across through the canonical state
  dict): the loss to rtol 1e-5, every gradient leaf within 1e-4 of its
  largest |g| (float32 sums in another order).
- Recomputing each stage in the backward (``remat``) changes no bit of the
  gradients.
- ``make_overfit_step`` (clips of two lengths) and
  ``make_batched_overfit_step`` (same-length clips, a mean over the clips
  as JAX's ``vmap`` takes it): the first step's loss equals JAX's to rtol
  1e-5, and three steps lower it.
- Outside autograd the stages still write the state in place.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import StreamingConfig
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.train import streaming_step as jss
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.models import streaming as tms
from moonshine_tpu_torch.train import step as ts
from moonshine_tpu_torch.train import streaming_step as tss

CFG = StreamingConfig(
    encoder_dim=32, decoder_dim=32, depth=2, nheads=4, head_dim=8, vocab_size=64,
    frame_len=80, total_lookahead=16, d_model_frontend=32, c1=48, c2=32, max_seq_len=32,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def params():
    return jms.init_params(CFG, jax.random.PRNGKey(0))


def _model(params):
    return weights.import_streaming(jax_export(params, CFG), TCFG, device="cpu")


def _example(n_frames, tokens, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(n_frames * CFG.frame_len) * 0.1).astype(np.float32)
    s = len(tokens) + 1
    return (audio, np.array([CFG.bos_id] + tokens, np.int32),
            np.array(tokens + [CFG.eos_id], np.int32), np.ones((s,), bool))


def _grads(model) -> dict:
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.detach().clone()
    return weights.export_streaming_state_dict(g, TCFG)


def _loss_and_grads(model, example, remat=True):
    a, ti, to, m = (torch.from_numpy(x) for x in example)
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    n = len(a) // CFG.frame_len
    with torch.enable_grad():
        state = tss.streaming_forward(model, TCFG, a, n, remat=remat)
        logits, _, _ = tms.decode_tokens(model, TCFG, ti.long(), tms.decoder_reset(state),
                                         mem_bucket=512)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, to.long()[:, None])[:, 0]
        loss = (nll * m.float()).sum() / m.float().sum().clamp(min=1.0)
        loss.backward()
    return loss.detach(), _grads(model)


def test_streaming_loss_and_gradients_match_jax(params):
    ex = _example(150, [5, 9, 12, 3], seed=0)
    ex = ex[:3] + (np.array([1, 1, 1, 1, 0], bool),)  # a masked target
    n = len(ex[0]) // CFG.frame_len
    loss, grads = jax.value_and_grad(
        lambda p: jss.streaming_asr_loss(p, CFG, *map(jnp.asarray, ex), n))(params)
    model = _model(params)
    for p in model.parameters():
        p.requires_grad_(True)
    with torch.enable_grad():
        tloss = tss.streaming_asr_loss(model, TCFG, *(torch.from_numpy(x) for x in ex), n)
        tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    ours, theirs = _grads(model), jax_export(grads, CFG)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        v = np.asarray(v)
        bound = GRAD_REL * max(float(np.abs(v).max()), 1e-30)
        assert float(np.abs(ours[k] - v).max()) <= bound, k


def test_remat_changes_no_gradient(params):
    ex = _example(140, [7, 8], seed=3)
    l1, g1 = _loss_and_grads(_model(params), ex, remat=True)
    l2, g2 = _loss_and_grads(_model(params), ex, remat=False)
    assert torch.equal(l1, l2)
    for k in g1:
        np.testing.assert_array_equal(g1[k], g2[k], err_msg=k)


def test_overfit_step_matches_jax_s_first_step(params):
    examples = [_example(100, [5, 9, 12], 1), _example(60, [20, 21], 2)]
    opt = optax.adam(2e-3)
    jstep = jss.make_overfit_step(CFG, opt, [tuple(map(jnp.asarray, e)) for e in examples])
    _, _, jloss = jstep(params, opt.init(params))
    step = tss.make_overfit_step(TCFG, ts.adam(2e-3), examples)
    model, opt_state, loss = step(_model(params))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for _ in range(2):
        model, opt_state, later = step(model, opt_state)
    assert later < loss


def test_batched_overfit_step_matches_jax_s_first_step(params):
    examples = [_example(120, [5, 9, 12], 1), _example(120, [20, 21], 2)]
    opt = optax.adam(2e-3)
    jstep = jss.make_batched_overfit_step(CFG, opt, [tuple(map(jnp.asarray, e))
                                                      for e in examples])
    _, _, jloss = jstep(params, opt.init(params))
    step = tss.make_batched_overfit_step(TCFG, ts.adam(2e-3), examples)
    model, opt_state, loss = step(_model(params))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for _ in range(2):
        model, opt_state, later = step(model, opt_state)
    assert float(later) < float(loss)
    with pytest.raises(ValueError, match="one length"):
        tss.make_batched_overfit_step(TCFG, ts.adam(1e-3), [examples[0], _example(90, [3], 4)])


def test_stages_write_in_place_outside_autograd(params):
    model = _model(params)
    state = tms.init_state(TCFG, device="cpu")
    audio = torch.from_numpy(_example(8, [1], 5)[0])
    new = tms.frontend_step(model, TCFG, audio, state)
    assert new.feats is state.feats and new.feat_count == 8
    for p in model.parameters():
        p.requires_grad_(True)
    with torch.enable_grad():
        grad_state = tms.frontend_step(model, TCFG, audio, tms.init_state(TCFG, device="cpu"))
    assert grad_state.feats.requires_grad
    torch.testing.assert_close(grad_state.feats.detach(), new.feats, rtol=0, atol=0)
