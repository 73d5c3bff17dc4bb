"""The port's finetuning against the JAX package's, on the CPU.

With a synthetic tokenizer (no reference assets here):

- ``_batches`` builds the same batches as JAX's (audio, lengths, tokens and
  masks equal exactly);
- ``finetune`` from JAX's initial weights: the first step's loss equals
  JAX's to rtol 1e-5 (the same forward on the same values; the later
  steps' losses are not held to a float32 tolerance, since Adam's first
  update amplifies rounding, see tests/test_torch_train_step.py), and
  both runs lower their loss;
- ``finetune`` from random weights lowers its loss by half in 60 steps,
  leaves the caller's ``init_params`` unchanged, moves the adapted weights
  away from them, and the result drops into
  ``Transcriber(...).with_params(...)``;
- ``finetune(..., mesh=)`` on a world-1 gloo group's 1x1 mesh (the sharded
  step over groups of one, as tests/test_finetune.py runs JAX's on a mesh)
  gives the unsharded run's losses and weights bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.train import finetune as jf
from moonshine_tpu_torch import Transcriber, weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.config import TranscriberOptions, VadOptions
from moonshine_tpu_torch.core.tokenizer import BinTokenizer as TorchTokenizer
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.parallel import mesh as pmesh
from moonshine_tpu_torch.train import finetune as tf

CFG = MoonshineArchConfig(
    name="ft-small", vocab_size=256, hidden_size=32, intermediate_size=64,
    encoder_layers=1, decoder_layers=1, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
TEXTS = [" w5 w9 w17", " w40 w3", " w77 w78 w79 w80"]  # each word one token


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tok = tmp_path_factory.mktemp("tok") / "tokenizer.bin"
    tok.write_bytes(BinTokenizer([b"<unk>", b"<s>", b"</s>"] + [
        f"▁w{i}".encode() for i in range(3, CFG.vocab_size)]).to_bytes())
    rng = np.random.RandomState(0)
    examples = [((rng.randn(n) * 0.1).astype(np.float32), t)
                for n, t in zip((16000, 12000, 21000), TEXTS)]
    return examples, str(tok)


def test_batches_equal_jax_s(setup):
    examples, tok = setup
    ours = list(tf._batches(TCFG, examples, TorchTokenizer.from_file(tok), 2, "cpu"))
    theirs = list(jf._batches(CFG, examples, BinTokenizer.from_file(tok), 2))
    assert len(ours) == len(theirs) >= 2
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_finetune_from_jax_weights_matches_its_first_step(setup):
    examples, tok = setup
    params = jm.init_params(CFG, jax.random.PRNGKey(3))
    ref = jf.finetune(CFG, BinTokenizer.from_file(tok), examples, init_params=params,
                      steps=6, batch_size=3, learning_rate=2e-3, log_every=1)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    out = tf.finetune(TCFG, TorchTokenizer.from_file(tok), examples, init_params=model,
                      steps=6, batch_size=3, learning_rate=2e-3, log_every=1)
    assert out.steps == ref.steps == 6 and out.examples == ref.examples == 3
    assert len(out.losses) == len(ref.losses) == 6
    np.testing.assert_allclose(out.losses[0], ref.losses[0], rtol=1e-5)
    assert out.losses[-1] < out.losses[0] and ref.losses[-1] < ref.losses[0]


def test_finetune_reduces_loss_and_drops_into_the_transcriber(setup):
    examples, tok = setup
    init = tm.init_params(TCFG, torch.Generator().manual_seed(42), "cpu")
    before = {n: p.clone() for n, p in init.named_parameters()}
    res = tf.finetune(TCFG, TorchTokenizer.from_file(tok), examples, init_params=init,
                      steps=60, batch_size=3, learning_rate=3e-3, log_every=10)
    assert res.steps == 60 and len(res.losses) == 6
    assert res.losses[-1] < 0.5 * res.losses[0]
    for n, p in init.named_parameters():  # the caller's model is untouched
        assert torch.equal(p, before[n]) and not p.requires_grad, n
    moved = max(float((p - before[n]).abs().max()) for n, p in res.params.named_parameters())
    assert moved > 0
    t = Transcriber(model=TCFG, tokenizer_path=tok, device="cpu",
                    options=TranscriberOptions(vad=VadOptions(threshold=0.0)))
    out = t.with_params(res.params).load().transcribe(examples[0][0])
    assert out.lines  # runs end to end with the adapted weights


def test_finetune_from_a_seed_on_the_cpu(setup):
    examples, tok = setup
    res = tf.finetune(TCFG, TorchTokenizer.from_file(tok), examples, steps=3, batch_size=3,
                      device="cpu", log_every=1)
    assert res.steps == 3 and len(res.losses) == 3
    assert res.params.decoder.embed.device.type == "cpu"
    with pytest.raises(ValueError, match="no training examples"):
        tf.finetune(TCFG, TorchTokenizer.from_file(tok), [], steps=1, device="cpu")


def test_finetune_on_a_one_by_one_mesh_equals_the_unsharded_run(setup):
    examples, tok = setup
    init = tm.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    kw = dict(init_params=init, steps=4, batch_size=3, learning_rate=2e-3, log_every=1)
    plain = tf.finetune(TCFG, TorchTokenizer.from_file(tok), examples, **kw)
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh(data=1, model=1, device_type="cpu")
        split = tf.finetune(TCFG, TorchTokenizer.from_file(tok), examples, mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    assert split.losses == plain.losses
    assert split.params.decoder.tp is not None
    ours = dict(split.params.named_parameters())
    for name, p in plain.params.named_parameters():
        assert torch.equal(ours[name], p), name
