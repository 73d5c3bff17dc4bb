"""The port's Gemma text encoder and ``GemmaEmbedder`` against the JAX
package's and against HF ``Gemma3TextModel``, on the CPU.

- ``encode_tokens`` (causal and not) and ``embed_tokens`` with JAX's
  weights through the bridge, at tests/test_gemma.py's ``SMALL`` config
  (GQA 4/2 heads, window 8, a full layer every second one) on padded
  batches longer than the window: hidden states to atol 1e-4 (float32
  through four layers, products summed in other orders), embeddings to
  atol 1e-5 (unit vectors after pooling and a two-layer head).
- ``GemmaEmbedder`` on both packages with a byte tokenizer (as
  tests/test_gemma.py uses), over texts that land in every bucket up to
  ``max_seq_length`` (truncated there with EOS kept), with and without the
  task prefixes: vectors to atol 1e-5.
- ``weights.import_hf_gemma3_text`` against ``transformers``'
  ``Gemma3TextModel`` directly, causal (atol 2e-4, rtol 1e-3, as
  tests/test_gemma.py holds the JAX importer); without ``dense1``/
  ``dense2`` the projection head stays absent, with them it is read.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.models import gemma as jg
from moonshine_tpu.weights import import_hf_gemma3_text as jax_import_hf_gemma3_text
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.models import gemma as tg

SMALL = jg.GemmaTextConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
    num_kv_heads=2, head_dim=16, sliding_window=8, global_layer_interval=2,
    query_pre_attn_scalar=16.0, projection_hidden=96, embedding_dim=48, max_seq_length=64,
)
TSMALL = tg.GemmaTextConfig(**SMALL.__dict__)
HIDDEN_TOL = dict(atol=1e-4, rtol=0)
EMBED_TOL = dict(atol=1e-5, rtol=0)



def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def models():
    jparams = jg.init_params(SMALL, jax.random.PRNGKey(0))
    return jparams, weights.gemma_params_from_jax_numpy(_tree(jparams), "cpu")


def _batch(seed: int, b: int = 3, s: int = 40):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, SMALL.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([s, 23, 5][:b])
    mask = np.arange(s)[None, :] < lengths[:, None]
    tokens[~mask] = SMALL.pad_token_id
    return tokens, mask


def test_config_matches_jax():
    assert tg.GemmaTextConfig() == tg.GemmaTextConfig(**jg.GemmaTextConfig().__dict__)
    assert [TSMALL.layer_is_global(i) for i in range(4)] == [SMALL.layer_is_global(i)
                                                             for i in range(4)]
    assert (tg.QUERY_PREFIX, tg.DOCUMENT_PREFIX) == (jg.QUERY_PREFIX, jg.DOCUMENT_PREFIX)


def test_bridge_round_trips(models):
    jparams, model = models
    back = weights.gemma_params_to_numpy(model)
    assert jax.tree.structure(_tree(jparams)) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(_tree(jparams)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_params_shapes_match_jax():
    ours = weights.gemma_params_to_numpy(
        tg.init_params(TSMALL, torch.Generator().manual_seed(0), "cpu"))
    ref = _tree(jg.init_params(SMALL, jax.random.PRNGKey(0)))
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_encode_tokens_matches_jax(models, causal):
    jparams, model = models
    tokens, mask = _batch(1)
    ref = jg.encode_tokens(jparams, SMALL, jnp.asarray(tokens), jnp.asarray(mask), causal=causal)
    ours = tg.encode_tokens(model, TSMALL, torch.from_numpy(tokens), torch.from_numpy(mask),
                            causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **HIDDEN_TOL)


def test_embed_tokens_matches_jax(models):
    jparams, model = models
    tokens, mask = _batch(2)
    ref = jg.embed_tokens(jparams, SMALL, jnp.asarray(tokens), jnp.asarray(mask))
    ours = tg.embed_tokens(model, TSMALL, torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **EMBED_TOL)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)


TEXTS = ["hi", "hello world", "x" * 20, "the quick brown fox jumps over", "y" * 60, "z" * 200,
         "yes", "cancel", "¿qué tal?"]


@pytest.fixture(scope="module")
def embedders(models):
    jparams, model = models
    return (jg.GemmaEmbedder(jparams, SMALL, ByteTokenizer()),
            tg.GemmaEmbedder(model, TSMALL, ByteTokenizer(), device="cpu"))


def test_embedder_matches_jax(embedders):
    jemb, temb = embedders
    buckets = set()
    for text in TEXTS:
        buckets.add(temb.batch(text)[0].shape[1])
        np.testing.assert_allclose(temb.get_embeddings(text), jemb.get_embeddings(text),
                                   **EMBED_TOL)
        np.testing.assert_allclose(temb.get_query_embeddings(text),
                                   jemb.get_query_embeddings(text), **EMBED_TOL)
        np.testing.assert_allclose(temb.get_document_embeddings(text),
                                   jemb.get_document_embeddings(text), **EMBED_TOL)
    assert buckets == {16, 32, 64}
    assert abs(temb.get_similarity("yes", "yeah") - jemb.get_similarity("yes", "yeah")) < 1e-5


def test_embedder_truncates_with_eos_kept(embedders):
    _, temb = embedders
    tokens, mask = temb.batch("w" * 500)
    assert tokens.shape == (1, SMALL.max_seq_length) and mask.all()
    assert tokens[0, 0] == SMALL.bos_token_id and tokens[0, -1] == SMALL.eos_token_id


# -- the contracts of tests/test_gemma.py --------------------------------------

def test_embeddings_normalized_and_deterministic(embedders):
    _, temb = embedders
    e1, e2 = temb.get_embeddings("hello world"), temb.get_embeddings("hello world")
    assert e1.shape == (SMALL.embedding_dim,) and e1.dtype == np.float32
    assert abs(np.linalg.norm(e1) - 1.0) < 1e-5
    np.testing.assert_array_equal(e1, e2)
    assert tg.cosine_similarity(e1, temb.get_embeddings("completely different")) < 0.999999


def test_prefixes_applied(embedders):
    _, temb = embedders
    np.testing.assert_array_equal(temb.get_query_embeddings("find me"),
                                  temb.get_embeddings(tg.QUERY_PREFIX + "find me"))
    np.testing.assert_array_equal(temb.get_document_embeddings("a doc"),
                                  temb.get_embeddings(tg.DOCUMENT_PREFIX + "a doc"))


def test_truncate_embedding_matches_jax(embedders):
    _, temb = embedders
    e = temb.get_embeddings("truncate me")
    for dim in (16, 0, 10_000, 48):
        np.testing.assert_array_equal(tg.GemmaEmbedder.truncate_embedding(e, dim),
                                      jg.GemmaEmbedder.truncate_embedding(e, dim))
    assert abs(np.linalg.norm(tg.GemmaEmbedder.truncate_embedding(e, 16)) - 1.0) < 1e-5


def test_cosine_helpers_match_jax():
    a, b = np.asarray([1.0, 0.0]), np.asarray([0.0, 1.0])
    for x, y in ((a, a), (a, b), (np.zeros(2), a), (np.arange(5.0), np.arange(5.0)[::-1])):
        assert tg.cosine_similarity(x, y) == jg.cosine_similarity(x, y)
    assert tg.cosine_distance(a, b) == pytest.approx(1.0)
    assert tg.cosine_similarity(np.zeros(2), np.zeros(3)) == 0.0
    with pytest.raises(ValueError):
        tg.cosine_distance(np.zeros(2), np.zeros(3))


def test_embedder_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.GemmaEmbedder(models[1], TSMALL, ByteTokenizer())


# -- the HF importer ------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_state_dict():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"] * 2, query_pre_attn_scalar=16,
        rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf = transformers.Gemma3TextModel(hf_cfg).eval()
    return hf, {f"model.{k}": v.detach().numpy() for k, v in hf.state_dict().items()}


def test_hf_gemma3_parity(hf_state_dict):
    hf, sd = hf_state_dict
    model = weights.import_hf_gemma3_text(sd, TSMALL, device="cpu")
    tokens = np.random.default_rng(0).integers(1, 256, (2, 12)).astype(np.int64)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(tokens)).last_hidden_state.numpy()
    ours = tg.encode_tokens(model, TSMALL, torch.from_numpy(tokens),
                            torch.ones((2, 12), dtype=torch.bool), causal=True)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-3)
    # The same tree as the JAX importer's.
    jtree = _tree(jax_import_hf_gemma3_text(sd, SMALL))
    back = weights.gemma_params_to_numpy(model)
    assert jax.tree.structure(jtree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_hf_import_without_and_with_the_dense_head(hf_state_dict):
    _, sd = hf_state_dict
    model = weights.import_hf_gemma3_text(sd, TSMALL, device="cpu")
    assert model.proj1 is None and model.proj2 is None
    tokens, mask = _batch(3)
    with pytest.raises(KeyError):
        tg.embed_tokens(model, TSMALL, torch.from_numpy(tokens), torch.from_numpy(mask))
    # An unprefixed state dict with the sentence-transformers head.
    rng = np.random.default_rng(4)
    plain = {k[len("model."):]: v for k, v in sd.items()}
    plain["dense1.weight"] = rng.standard_normal((96, 64)).astype(np.float32) * 0.1
    plain["dense2.weight"] = rng.standard_normal((48, 96)).astype(np.float32) * 0.1
    headed = weights.import_hf_gemma3_text(plain, TSMALL, device="cpu")
    jheaded = jax_import_hf_gemma3_text(plain, SMALL)
    np.testing.assert_array_equal(headed.proj1.weight.numpy(), plain["dense1.weight"])
    ref = jg.embed_tokens(jheaded, SMALL, jnp.asarray(tokens), jnp.asarray(mask))
    ours = tg.embed_tokens(headed, TSMALL, torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **EMBED_TOL)


def test_hf_import_from_safetensors(hf_state_dict, tmp_path):
    _, sd = hf_state_dict
    path = tmp_path / "gemma.safetensors"
    weights.save_safetensors(path, sd)
    a = weights.gemma_params_to_numpy(weights.import_hf_gemma3_text(str(path), TSMALL, device="cpu"))
    b = weights.gemma_params_to_numpy(weights.import_hf_gemma3_text(sd, TSMALL, device="cpu"))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
