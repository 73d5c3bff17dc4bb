"""The port's streaming model family against the JAX package's, on the CPU.

The JAX parameters go to the port through the canonical state dict (the
JAX package's ``export_streaming_state_dict``, then the port's
``weights.import_streaming``), so every case also exercises the importer.
The contracts of tests/test_streaming.py hold for the port, and its
results equal JAX's: chunking invariance and causality of the frontend,
lookahead holdback and emission counts of the encoder, incremental equals
batch, speculative equals greedy, ``decoder_reset``, the backend in the
pipeline, and fused equals host; then the importer round trips of
tests/test_streaming_import.py.

Tolerances: features, memory and logits in float32 to atol = rtol = 1e-4
(tests/test_torch_moonshine.py's: summation order differs in every
product); the chunking-invariance and causality bounds are the JAX
tests' own; tokens, emission counts and transcripts must be identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import StreamingConfig, TranscriberOptions, VadOptions
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.pipeline.backends import StreamingBackend as JaxStreamingBackend
from moonshine_tpu.pipeline.transcriber import Transcriber as JaxPipeline
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.core.config import TranscriberOptions as TorchOptions
from moonshine_tpu_torch.core.config import VadOptions as TorchVadOptions
from moonshine_tpu_torch.core.onnx_io import save_onnx
from moonshine_tpu_torch.core.tokenizer import BinTokenizer as TorchTokenizer
from moonshine_tpu_torch.models import streaming as tms
from moonshine_tpu_torch.pipeline.backends import StreamingBackend
from moonshine_tpu_torch.pipeline.transcriber import FLAG_FORCE_UPDATE
from moonshine_tpu_torch.pipeline.transcriber import Transcriber as TorchPipeline

# tests/test_streaming.py's CFG.
CFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16, vocab_size=128,
    frame_len=80, total_lookahead=16, d_model_frontend=64, c1=128, c2=64, max_seq_len=64,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
F32 = dict(atol=1e-4, rtol=1e-4)


def _torch_cfg(cfg: StreamingConfig) -> TorchStreamingConfig:
    return TorchStreamingConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def params():
    return jms.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(params):
    return weights.import_streaming(jax_export(params, CFG), TCFG, device="cpu")


def audio_frames(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_frames * CFG.frame_len).astype(np.float32) * 0.1


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_frontend(model, audio, chunk_frames, cfg=TCFG):
    state = tms.init_state(cfg, device="cpu")
    n = len(audio) // cfg.frame_len
    i = 0
    while i < n:
        step = min(chunk_frames, n - i)
        chunk = torch.from_numpy(audio[i * cfg.frame_len:(i + step) * cfg.frame_len])
        state = tms.frontend_step(model, cfg, chunk, state)
        i += step
    return state


def jax_frontend(params, audio, chunk_frames, cfg=CFG):
    state = jms.init_state(cfg)
    n = len(audio) // cfg.frame_len
    i = 0
    while i < n:
        step = min(chunk_frames, n - i)
        chunk = jnp.asarray(audio[i * cfg.frame_len:(i + step) * cfg.frame_len])
        state = jms.frontend_step(params, cfg, chunk, state)
        i += step
    return state


def encoded_states(params, model, n_frames=32, seed=5):
    audio = audio_frames(n_frames, seed)
    js, _ = jms.encode(params, CFG, jax_frontend(params, audio, n_frames), is_final=True)
    ts, _ = tms.encode(model, TCFG, run_frontend(model, audio, n_frames), is_final=True)
    return js, ts


# -- frontend --------------------------------------------------------------

def test_frontend_chunking_invariance(params, model):
    audio = audio_frames(20)
    s_big = run_frontend(model, audio, 20)
    s_small = run_frontend(model, audio, 3)
    s_one = run_frontend(model, audio, 1)
    assert s_big.feat_count == s_big.frame_count == 20
    f_big = _np(s_big.feats[:20])
    np.testing.assert_allclose(_np(s_small.feats[:20]), f_big, atol=1e-5)
    np.testing.assert_allclose(_np(s_one.feats[:20]), f_big, atol=1e-5)
    np.testing.assert_allclose(_np(s_one.sample_ctx), _np(s_big.sample_ctx), atol=1e-6)
    ref = jax_frontend(params, audio, 3)
    for a, b in ((s_small.feats, ref.feats), (s_small.conv1_carry, ref.conv1_carry),
                 (s_small.conv2_carry, ref.conv2_carry), (s_small.sample_ctx, ref.sample_ctx)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


def test_frontend_causality(model):
    """Changing future samples must not change past features."""
    a1 = audio_frames(10, seed=1)
    a2 = a1.copy()
    a2[8 * CFG.frame_len:] = 0.5  # perturb the last 2 frames
    s1 = run_frontend(model, a1, 10)
    s2 = run_frontend(model, a2, 10)
    np.testing.assert_allclose(_np(s1.feats[:8]), _np(s2.feats[:8]), atol=1e-6)
    assert not np.allclose(_np(s1.feats[8:10]), _np(s2.feats[8:10]))


def test_frontend_refuses_what_jax_would_clamp(model):
    state = tms.init_state(TCFG, device="cpu")._replace(feat_count=tms.FEAT_CAP - 1)
    with pytest.raises(ValueError, match="feats"):
        tms.frontend_step(model, TCFG, torch.zeros(2 * CFG.frame_len), state)


# -- encoder emission ------------------------------------------------------

def test_lookahead_holdback(params, model):
    audio = audio_frames(30)
    state = run_frontend(model, audio, 30)
    state, n = tms.encode(model, TCFG, state, is_final=False)
    assert n == 30 - CFG.total_lookahead
    assert state.mem_len == n
    jstate, jn = jms.encode(params, CFG, jax_frontend(params, audio, 30), is_final=False)
    assert jn == n
    np.testing.assert_allclose(_np(state.memory), _np(jstate.memory), **F32)
    # Finalizing releases the lookahead frames.
    state, n2 = tms.encode(model, TCFG, state, is_final=True)
    assert n2 == CFG.total_lookahead
    assert state.mem_len == 30


def test_encode_no_new_frames_noop(model):
    state = run_frontend(model, audio_frames(20), 20)
    state, _ = tms.encode(model, TCFG, state, is_final=False)
    _, n2 = tms.encode(model, TCFG, state, is_final=False)
    assert n2 == 0


def test_encode_deterministic_and_emission_counts(params, model):
    """Same schedule twice -> bit-identical memory; an incremental schedule
    emits the same frame counts as one-shot, and its memory and cross K/V
    equal JAX's on the same schedule."""
    audio = audio_frames(64, seed=3)

    def run_oneshot():
        s = run_frontend(model, audio, 64)
        s, _ = tms.encode(model, TCFG, s, is_final=True)
        return s

    s1a, s1b = run_oneshot(), run_oneshot()
    np.testing.assert_array_equal(_np(s1a.memory), _np(s1b.memory))

    s2 = tms.init_state(TCFG, device="cpu")
    js = jms.init_state(CFG)
    emitted = 0
    for i in range(0, 64, 8):
        chunk = audio[i * CFG.frame_len:(i + 8) * CFG.frame_len]
        s2 = tms.frontend_step(model, TCFG, torch.from_numpy(chunk), s2)
        s2, n = tms.encode(model, TCFG, s2, is_final=False)
        js = jms.frontend_step(params, CFG, jnp.asarray(chunk), js)
        js, jn = jms.encode(params, CFG, js, is_final=False)
        assert n == jn
        emitted += n
    s2, n = tms.encode(model, TCFG, s2, is_final=True)
    js, _ = jms.encode(params, CFG, js, is_final=True)
    emitted += n
    assert emitted == 64
    assert s2.mem_len == s1a.mem_len == int(js.mem_len) == 64
    # Cross-K/V rows track memory rows 1:1 (layout [L, T, H, hd]).
    k = _np(s2.k_cross)
    assert not np.allclose(k[:, 63], 0)
    assert np.allclose(k[:, 64:], 0)
    np.testing.assert_allclose(_np(s2.memory), _np(js.memory), **F32)
    np.testing.assert_allclose(k, _np(js.k_cross), **F32)
    np.testing.assert_allclose(_np(s2.v_cross), _np(js.v_cross), **F32)


def test_deep_encoder_window_clamps_as_jax():
    """With ``16 * enc_depth`` frames of left context past ENC_WIN -
    ENC_STEP (Medium Streaming's depth 10: 160 > 128), JAX's read of the
    newly stable block clamps inside the window; the port reads the same
    rows, so its memory equals JAX's."""
    cfg = StreamingConfig(encoder_dim=32, decoder_dim=32, depth=1, nheads=2, head_dim=16,
                          vocab_size=64, d_model_frontend=16, c1=32, c2=32, max_seq_len=16,
                          encoder_depth=10)
    assert cfg.left_context_frames > tms.ENC_WIN - tms.ENC_STEP
    p = jms.init_params(cfg, jax.random.PRNGKey(2))
    tcfg = _torch_cfg(cfg)
    m = weights.import_streaming(jax_export(p, cfg), tcfg, device="cpu")
    audio = audio_frames(400, seed=4)
    ts = run_frontend(m, audio, 400, tcfg)
    js = jax_frontend(p, audio, 400, cfg)
    for stop in (200, 400):  # the second call starts at enc_emitted 200 > 160
        ts = ts._replace(feat_count=stop)
        js = js._replace(feat_count=jnp.asarray(stop, jnp.int32))
        ts, n = tms.encode(m, tcfg, ts, is_final=True)
        js, jn = jms.encode(p, cfg, js, is_final=True)
        assert n == jn
    np.testing.assert_allclose(_np(ts.memory[:400]), _np(js.memory[:400]), **F32)


# -- decoder ---------------------------------------------------------------

def test_decode_incremental_matches_batch(params, model):
    js, ts = encoded_states(params, model)
    tokens = [CFG.bos_id, 5, 9, 17]
    logits_batch, _, _ = tms.decode_tokens(model, TCFG, torch.tensor(tokens),
                                           tms.decoder_reset(ts))
    s_inc = tms.decoder_reset(ts)
    outs = []
    for t in tokens:
        lg, s_inc, _ = tms.decode_tokens(model, TCFG, torch.tensor([t]), s_inc)
        outs.append(_np(lg)[0])
    np.testing.assert_allclose(_np(logits_batch), np.stack(outs), atol=1e-4, rtol=1e-3)
    ref, _, _ = jms.decode_tokens(params, CFG, jnp.asarray(tokens, jnp.int32),
                                  jms.decoder_reset(js))
    np.testing.assert_allclose(_np(logits_batch), _np(ref), **F32)


@pytest.fixture(scope="module")
def greedy(params, model):
    js, ts = encoded_states(params, model)
    ref, _ = jms.decode_full(params, CFG, js, max_tokens=12)
    out, _ = tms.decode_full(model, TCFG, ts, max_tokens=12)
    return ts, out, ref


def test_decode_full_greedy_matches_jax(greedy):
    _, out, ref = greedy
    assert out == ref
    assert len(out) <= 12
    assert CFG.eos_id not in out


def test_speculative_matches_greedy(greedy, model):
    """Verify-accept with the true previous hypothesis, a corrupted one
    (diverge and roll back) and a partial one reproduce greedy exactly."""
    state, out, _ = greedy
    spec, _ = tms.decode_full(model, TCFG, state, speculative_tokens=out, max_tokens=12)
    assert spec == out
    for corrupt_at in (0, 1, len(out) // 2, max(len(out) - 1, 0)):
        draft = list(out)
        if draft:
            draft[corrupt_at] = (draft[corrupt_at] + 7) % CFG.vocab_size
        spec, _ = tms.decode_full(model, TCFG, state, speculative_tokens=draft, max_tokens=12)
        assert spec == out, f"divergence at {corrupt_at}"
    if len(out) > 2:
        spec, _ = tms.decode_full(model, TCFG, state, speculative_tokens=out[:2],
                                  max_tokens=12)
        assert spec == out


def test_decoder_reset_preserves_cross_kv(params, model):
    _, state = encoded_states(params, model)
    t1, state = tms.decode_full(model, TCFG, state, max_tokens=8)
    state = tms.decoder_reset(state)
    assert state.cache_len == 0
    assert state.mem_len > 0
    t2, _ = tms.decode_full(model, TCFG, state, max_tokens=8)
    assert t1 == t2


def test_decode_full_fused_matches_host(params, model):
    """The fused decode reproduces the host decode_full and JAX's fused
    program: greedy from scratch, correct draft, corrupted drafts, and the
    budget."""
    js, state = encoded_states(params, model, n_frames=32, seed=11)
    greedy_tokens, _ = tms.decode_full(model, TCFG, state, max_tokens=12)
    bucket = tms.mem_bucket_for(state.mem_len)
    assert bucket == jms.mem_bucket_for(int(js.mem_len))

    def run_fused(draft_list, budget=12):
        tokens, _ = tms.decode_full_fused(model, TCFG, state, draft_list, budget,
                                          mem_bucket=bucket)
        draft = np.full(CFG.max_seq_len, CFG.eos_id, np.int32)
        draft[:len(draft_list)] = draft_list
        ref, count, _ = jms.decode_full_fused(
            params, CFG, js, jnp.asarray(draft), jnp.asarray(len(draft_list), jnp.int32),
            jnp.asarray(budget, jnp.int32), mem_bucket=bucket)
        assert tokens == [int(t) for t in np.asarray(ref)[:int(count)]]
        return tokens

    assert run_fused([]) == greedy_tokens
    assert run_fused(greedy_tokens) == greedy_tokens
    for corrupt_at in (0, len(greedy_tokens) // 2, max(len(greedy_tokens) - 1, 0)):
        bad = list(greedy_tokens)
        if bad:
            bad[corrupt_at] = (bad[corrupt_at] + 7) % CFG.vocab_size
        assert run_fused(bad) == greedy_tokens, f"corrupt at {corrupt_at}"
    assert len(run_fused(greedy_tokens, budget=3)) <= 3
    assert run_fused(greedy_tokens, budget=0) == []


# -- end to end through the pipeline ---------------------------------------

def _byte_tokens() -> list[bytes]:
    tokens = [b""] * CFG.vocab_size
    tokens[CFG.bos_id] = b"<s>"
    tokens[CFG.eos_id] = b"</s>"
    for i in range(3, CFG.vocab_size):
        tokens[i] = bytes([97 + (i % 26)])
    return tokens


def _events(stream) -> list:
    seen = []
    stream.add_listener(lambda e: seen.append(
        (type(e).__name__, e.line.text, e.line.start_time, e.line.duration,
         e.line.is_complete, tuple((w.text, w.start, w.end) for w in e.line.words))))
    return seen


@pytest.mark.parametrize("word_timestamps", [False, True])
def test_streaming_backend_in_pipeline_matches_jax(params, model, word_timestamps):
    """A stream fed 0.1 s chunks through each package's StreamingBackend
    and pipeline, updated after each chunk, gives the same events (text,
    timing, words).  The update interval is long, so that only the
    explicit updates run and the events do not depend on how long a pass
    takes."""
    jb = JaxStreamingBackend(params, CFG, BinTokenizer(_byte_tokens()),
                             word_timestamps=word_timestamps)
    tb = StreamingBackend(model, TCFG, TorchTokenizer(_byte_tokens()),
                          word_timestamps=word_timestamps)
    audio = audio_frames(100, seed=9)  # 0.5 s
    results = []
    for pipeline in (
            JaxPipeline(jb, TranscriberOptions(transcription_interval=0.1,
                                               vad=VadOptions(threshold=0.0))),
            TorchPipeline(tb, TorchOptions(transcription_interval=0.1,
                                           vad=TorchVadOptions(threshold=0.0)))):
        stream = pipeline.create_stream(update_interval=1000)
        seen = _events(stream)
        stream.start()
        for i in range(0, len(audio), 1600):
            stream.add_audio(audio[i:i + 1600])
            stream.update_transcription(FLAG_FORCE_UPDATE)
        transcript = stream.stop()
        assert len(transcript.lines) == 1
        line = transcript.lines[0]
        assert line.is_complete and line.text is not None
        results.append(seen)
    assert results[1] == results[0]
    assert any(e[0] == "LineCompleted" for e in results[1])
    if word_timestamps:
        assert any(e[5] for e in results[1]), "the final line should carry words"


# -- checkpoint round trips (tests/test_streaming_import.py) ---------------

ICFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16, vocab_size=128,
    d_model_frontend=32, c1=48, c2=64, max_seq_len=64, encoder_depth=2,
)
TICFG = _torch_cfg(ICFG)


@pytest.fixture(scope="module")
def import_params():
    return jms.init_params(ICFG, jax.random.PRNGKey(7))


def _decode_probe(model) -> np.ndarray:
    """Frontend + encode + decode of fixed audio; the logits."""
    state = tms.init_state(TICFG, device="cpu")
    chunk = np.random.RandomState(0).randn(40 * ICFG.frame_len).astype(np.float32) * 0.1
    state = tms.frontend_step(model, TICFG, torch.from_numpy(chunk), state)
    state, _ = tms.encode(model, TICFG, state, is_final=True)
    logits, _, _ = tms.decode_tokens(model, TICFG, torch.tensor([ICFG.bos_id, 5, 9]), state,
                                     mem_bucket=512)
    return _np(logits)


def _jax_decode_probe(params) -> np.ndarray:
    state = jms.init_state(ICFG)
    chunk = np.random.RandomState(0).randn(40 * ICFG.frame_len).astype(np.float32) * 0.1
    state = jms.frontend_step(params, ICFG, jnp.asarray(chunk), state)
    state, _ = jms.encode(params, ICFG, state, is_final=True)
    logits, _, _ = jms.decode_tokens(params, ICFG, jnp.asarray([ICFG.bos_id, 5, 9], jnp.int32),
                                     state, mem_bucket=512)
    return np.asarray(logits)


def _assert_same(sd_a: dict, sd_b: dict) -> None:
    assert sorted(sd_a) == sorted(sd_b)
    for k in sd_a:
        np.testing.assert_array_equal(np.asarray(sd_a[k]), np.asarray(sd_b[k]), err_msg=k)


def test_roundtrip_dict(import_params):
    sd = jax_export(import_params, ICFG)
    model = weights.import_streaming(sd, TICFG, device="cpu")
    back = weights.export_streaming_state_dict(model, TICFG)
    # Canonical naming is complete: frontend(7) + enc head(3) + 10 per
    # encoder layer + adapter(3) + embed(1) + 15 per decoder layer + norm(1).
    assert len(back) == 7 + 3 + 10 * ICFG.enc_depth + 3 + 1 + 15 * ICFG.depth + 1
    _assert_same(back, sd)
    np.testing.assert_allclose(_decode_probe(model), _jax_decode_probe(import_params), **F32)
    # An HF-style "model." prefix imports the same weights.
    again = weights.import_streaming({f"model.{k}": v for k, v in sd.items()}, TICFG,
                                     device="cpu")
    _assert_same(weights.export_streaming_state_dict(again, TICFG), sd)


def test_roundtrip_safetensors(import_params, tmp_path):
    from safetensors.numpy import save_file

    sd = jax_export(import_params, ICFG)
    path = tmp_path / "model.safetensors"
    save_file(sd, str(path))
    model = weights.import_streaming(str(path), TICFG, device="cpu")
    _assert_same(weights.export_streaming_state_dict(model, TICFG), sd)
    np.testing.assert_allclose(_decode_probe(model), _jax_decode_probe(import_params), **F32)


@pytest.mark.parametrize("layout", ["five_sessions", "single_onnx"])
def test_roundtrip_onnx_dir(import_params, tmp_path, layout):
    """The reference's distribution layouts: five session files, or one
    model.onnx, with streaming_config.json."""
    sd = jax_export(import_params, ICFG)
    if layout == "five_sessions":
        sessions = weights.split_streaming_sessions(sd)
        assert set(sessions) == {"frontend", "encoder", "adapter", "cross_kv", "decoder_kv"}
        assert all(".encoder_attn.k_proj" in k or ".encoder_attn.v_proj" in k
                   for k in sessions["cross_kv"])
        assert len(sessions["cross_kv"]) == 2 * ICFG.depth  # bias-free k/v weights
        for name, tensors in sessions.items():
            save_onnx(str(tmp_path / f"{name}.onnx"), tensors)
    else:
        save_onnx(str(tmp_path / "model.onnx"), sd)
    (tmp_path / "streaming_config.json").write_text(TICFG.to_json())
    model, cfg = weights.load_streaming_checkpoint(str(tmp_path), device="cpu")
    assert cfg == TICFG
    _assert_same(weights.export_streaming_state_dict(model, cfg), sd)
    np.testing.assert_allclose(_decode_probe(model), _jax_decode_probe(import_params), **F32)


def test_missing_checkpoint_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.load_streaming_checkpoint(str(tmp_path), device="cpu")


def test_api_loads_streaming_checkpoint_dir(import_params, tmp_path, monkeypatch):
    """Transcriber.load() takes a streaming checkpoint directory through
    weights= (its streaming_config.json configures the model and backend),
    and tiny_streaming loads with random weights."""
    from safetensors.numpy import save_file

    from moonshine_tpu_torch import api

    save_file(jax_export(import_params, ICFG), str(tmp_path / "model.safetensors"))
    (tmp_path / "streaming_config.json").write_text(TICFG.to_json())
    tok = tmp_path / "tokenizer.bin"
    tok.write_bytes(TorchTokenizer(_byte_tokens()).to_bytes())
    t = api.Transcriber("tiny_streaming", "en", str(tmp_path), str(tok), device="cpu").load()
    assert isinstance(t.model, tms.StreamingMoonshine)
    assert t._pipeline.backend.cfg == TICFG
    np.testing.assert_allclose(_decode_probe(t.model), _jax_decode_probe(import_params), **F32)
    fresh = api.Transcriber(model="tiny_streaming", tokenizer_path=str(tok), device="cpu")
    fresh.with_options(vad_threshold=0).load()
    assert isinstance(fresh.model, tms.StreamingMoonshine)
