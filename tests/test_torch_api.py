"""The port's ``Transcriber`` entry point against the JAX package's, on the
CPU: the constructor's order, catalog resolution (weights and tokenizer,
with the default-tokenizer fallback), HF checkpoint import, the
safetensors reader, ``transcribe_wav``, streams and the implicit default
stream, the real-weight VAD of ``vad_weights=``, the run and API logs, and
``MicTranscriber``'s refusal.

Tolerances: logits against HF ``transformers`` to atol 2e-4, rtol 1e-3
(tests/test_hf_parity.py's); imported parameters and read tensors must be
bit-equal; transcript events must be identical.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import api as japi
from moonshine_tpu import catalog as jcatalog
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.core.tokenizer import BinTokenizer
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.weights import import_hf_moonshine as jax_import_hf
from moonshine_tpu_torch import api as tapi
from moonshine_tpu_torch import catalog as tcatalog
from moonshine_tpu_torch import profiling, weights
from moonshine_tpu_torch.audio.wav import save_wav
from moonshine_tpu_torch.core import config as tconfig
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.pipeline.transcriber import FLAG_FORCE_UPDATE

from chip_smoke import tinyvad_graph

transformers = pytest.importorskip("transformers")

# tests/test_hf_parity.py's three parity points.
HF_CASES = {
    "small": dict(hidden_size=64, intermediate_size=256, encoder_num_hidden_layers=2,
                  decoder_num_hidden_layers=2, encoder_num_attention_heads=4,
                  decoder_num_attention_heads=4, encoder_num_key_value_heads=4,
                  decoder_num_key_value_heads=4, vocab_size=256),
    "tiny": dict(hidden_size=288, intermediate_size=1152, encoder_num_hidden_layers=6,
                 decoder_num_hidden_layers=6, encoder_num_attention_heads=8,
                 decoder_num_attention_heads=8, encoder_num_key_value_heads=8,
                 decoder_num_key_value_heads=8, vocab_size=32768),
    "base": dict(hidden_size=416, intermediate_size=1664, encoder_num_hidden_layers=8,
                 decoder_num_hidden_layers=8, encoder_num_attention_heads=8,
                 decoder_num_attention_heads=8, encoder_num_key_value_heads=8,
                 decoder_num_key_value_heads=8, vocab_size=32768),
}
HF_TOL = dict(atol=2e-4, rtol=1e-3)


def _configs(name: str, spec: dict) -> tuple[MoonshineArchConfig, TorchArchConfig]:
    fields = dict(
        name=name, vocab_size=spec["vocab_size"], hidden_size=spec["hidden_size"],
        intermediate_size=spec["intermediate_size"],
        encoder_layers=spec["encoder_num_hidden_layers"],
        decoder_layers=spec["decoder_num_hidden_layers"],
        encoder_heads=spec["encoder_num_attention_heads"],
        decoder_heads=spec["decoder_num_attention_heads"],
        encoder_kv_heads=spec["encoder_num_key_value_heads"],
        decoder_kv_heads=spec["decoder_num_key_value_heads"])
    return MoonshineArchConfig(**fields), TorchArchConfig(**fields)


def _hf_model(spec: dict):
    torch.manual_seed(0)
    return transformers.MoonshineForConditionalGeneration(
        transformers.MoonshineConfig(**spec)).eval()


def _state_dict(hf) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()}


def _tokens(vocab: int) -> list[bytes]:
    return [b"<unk>", b"<s>", b"</s>"] + [f"▁w{i}".encode() for i in range(3, vocab)]


def _speechy_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    tone = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.3 * tone + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


# -- the constructor ---------------------------------------------------------

def test_constructor_takes_the_jax_order():
    t = tapi.Transcriber("tiny", "en")
    assert (t._model, t._language, t._weights, t._tokenizer_path) == ("tiny", "en", None, None)
    opts = tconfig.TranscriberOptions(model="base")
    t = tapi.Transcriber("base", "es", "w.safetensors", "tok.bin", opts, None, 5,
                         device="cpu")
    assert (t._model, t._language, t._weights, t._tokenizer_path, t.options, t._seed,
            t._device) == ("base", "es", "w.safetensors", "tok.bin", opts, 5, "cpu")
    with pytest.raises(TypeError):
        tapi.Transcriber("base", "en", None, None, None, None, 0, "cpu")  # device is keyword-only
    assert t.language("ja") is t and t._language == "ja"
    assert t.with_weights("other.safetensors")._weights == "other.safetensors"


# -- the catalog -------------------------------------------------------------

def test_catalog_copy_answers_as_jax():
    assert tcatalog.list_models() == jcatalog.list_models()
    assert tcatalog.catalog_json() == jcatalog.catalog_json()
    for kind in ("stt_catalog", "stt_dependencies", "embedding_catalog",
                 "diarization_dependencies"):
        assert tcatalog.catalog_request_json(kind) == jcatalog.catalog_request_json(kind)


def test_tokenizer_resolution_order(tmp_path, monkeypatch):
    """The explicit path, then <cache>/<model>-<language>/tokenizer.bin,
    then the catalog's default tokenizer; FileNotFoundError when all
    three fail.  Both packages resolve the same files."""
    monkeypatch.setenv(tcatalog.DEFAULT_CACHE_ENV, str(tmp_path / "cache"))
    default = tmp_path / "default.bin"
    default.write_bytes(BinTokenizer(_tokens(40)).to_bytes())
    monkeypatch.setattr(tcatalog, "_REFERENCE_TOKENIZER", str(default))
    monkeypatch.setattr(jcatalog, "_REFERENCE_TOKENIZER", str(default))
    assert tcatalog.default_tokenizer_path() == jcatalog.default_tokenizer_path() == str(default)
    assert tapi.Transcriber("tiny", "en")._load_tokenizer().vocab_size == 40

    entry = tmp_path / "cache" / "tiny-en"
    entry.mkdir(parents=True)
    (entry / "tokenizer.bin").write_bytes(BinTokenizer(_tokens(50)).to_bytes())
    (entry / "model.safetensors").write_bytes(b"")
    assert tcatalog.resolve("tiny", "en").files == jcatalog.resolve("tiny", "en").files
    assert tapi.Transcriber("tiny", "en")._load_tokenizer().vocab_size == 50
    explicit = tmp_path / "explicit.bin"
    explicit.write_bytes(BinTokenizer(_tokens(60)).to_bytes())
    t = tapi.Transcriber("tiny", "en", tokenizer_path=explicit)
    assert t._load_tokenizer().vocab_size == 60

    monkeypatch.setattr(tcatalog, "_REFERENCE_TOKENIZER", str(tmp_path / "absent.bin"))
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        tapi.Transcriber("base", "en")._load_tokenizer()


# -- checkpoints ---------------------------------------------------------------

def test_safetensors_reader_equals_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load_file
    from safetensors.torch import save_file as torch_save_file

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "i64": rng.integers(-9, 9, (2, 2, 2)),
        "i8": rng.integers(-127, 128, (7,)).astype(np.int8),
        "u8": rng.integers(0, 255, (1, 3)).astype(np.uint8),
        "scalar": np.array(1.5, np.float32),
    }
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    ours, ref = weights.load_safetensors(tmp_path / "a.safetensors"), load_file(
        str(tmp_path / "a.safetensors"))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k], ref[k])
    # The port's writer gives the files the package reads.
    weights.save_safetensors(tmp_path / "c.safetensors", arrays)
    back = load_file(str(tmp_path / "c.safetensors"))
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(back[k], arrays[k])
    bf16 = torch.randn(6, 2).to(torch.bfloat16)
    torch_save_file({"bf16": bf16}, str(tmp_path / "b.safetensors"))
    ours = weights.load_safetensors(str(tmp_path / "b.safetensors"))["bf16"]
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, torch_load_file(str(tmp_path / "b.safetensors"))["bf16"].float().numpy())


@pytest.mark.parametrize("case", list(HF_CASES))
def test_import_hf_moonshine_matches_transformers(case, tmp_path):
    """import_hf_moonshine of a random MoonshineForConditionalGeneration
    gives HF's logits, and the JAX import's parameters carried across."""
    spec = HF_CASES[case]
    cfg, tcfg = _configs(case, spec)
    hf = _hf_model(spec)
    sd = _state_dict(hf)
    model = weights.import_hf_moonshine(sd, tcfg, device="cpu")
    ref_tree = jax.tree.map(np.asarray, jm.prepare_rotary_params(jax_import_hf(sd, cfg), cfg))
    ours = weights.params_to_numpy(model)
    assert jax.tree.structure(ours) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(a, b)

    audio = (np.random.default_rng(3).standard_normal(16000) * 0.1).astype(np.float32)
    tokens = np.array([[1, 5, 9, 200, 17]])
    with torch.no_grad():
        ref = hf(input_values=torch.from_numpy(audio)[None],
                 decoder_input_ids=torch.from_numpy(tokens)).logits.numpy()
    with torch.inference_mode():
        memory, mask = tm.encode(model, tcfg, torch.from_numpy(audio)[None])
        kc, vc = tm.compute_cross_kv(model.decoder, tcfg, memory)
        cache = tm.init_cache(tcfg, 1, 16, kc, vc, mask)
        logits, _, _ = tm.decoder_apply(model.decoder, tcfg, torch.from_numpy(tokens), cache)
    np.testing.assert_allclose(logits.numpy(), ref, **HF_TOL)

    # export_hf_moonshine writes the checkpoint back (HF ties proj_out to
    # the embedding, so its copy is left out).
    exported = weights.export_hf_moonshine(model)
    assert sorted(exported) == sorted(k for k in sd if k != "proj_out.weight")
    for k, v in exported.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)

    if case == "small":  # the same checkpoint from a file, with and without "model."
        from safetensors.numpy import save_file

        save_file(sd, str(tmp_path / "model.safetensors"))
        save_file({k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")},
                  str(tmp_path / "bare.safetensors"))
        for name in ("model.safetensors", "bare.safetensors"):
            again = weights.import_hf_moonshine(str(tmp_path / name), tcfg, device="cpu")
            for a, b in zip(jax.tree.leaves(weights.params_to_numpy(again)),
                            jax.tree.leaves(ours)):
                np.testing.assert_array_equal(a, b)


# -- the entry point, end to end -----------------------------------------------

@pytest.fixture()
def catalog_cache(tmp_path, monkeypatch):
    """A cache holding base-en: an HF-named checkpoint of a small Base-like
    model (weights scaled up so that the random model emits text) and a
    tokenizer; both packages' "base" points at its config."""
    cfg, tcfg = _configs("base", HF_CASES["small"])
    sd = {k: v * 3.0 if v.ndim >= 2 else v for k, v in _state_dict(_hf_model(
        HF_CASES["small"])).items()}
    entry = tmp_path / "base-en"
    entry.mkdir()
    from safetensors.numpy import save_file

    save_file(sd, str(entry / "model.safetensors"))
    (entry / "tokenizer.bin").write_bytes(BinTokenizer(_tokens(cfg.vocab_size)).to_bytes())
    monkeypatch.setenv(tcatalog.DEFAULT_CACHE_ENV, str(tmp_path))
    monkeypatch.setitem(japi.ARCHS, "base", cfg)
    monkeypatch.setitem(tapi.ARCHS, "base", tcfg)
    return tmp_path


def _pair(**options):
    jt = japi.Transcriber("base", "en").with_options(vad_threshold=0, **options).load()
    tt = tapi.Transcriber("base", "en", device="cpu").with_options(vad_threshold=0, **options)
    return jt, tt.load()


def _lines(transcript) -> list:
    return [(line.text, line.start_time, line.duration, line.is_complete)
            for line in transcript.lines]


def _listen(stream) -> list:
    seen = []
    stream.add_listener(lambda e: seen.append(
        (type(e).__name__, e.line.text, e.line.start_time, e.line.is_complete)))
    return seen


def test_catalog_checkpoint_transcribe_wav_matches_jax(catalog_cache, tmp_path):
    jt, tt = _pair()
    assert isinstance(tt.model, tm.Moonshine) and tt._weights is not None
    audio = np.concatenate([_speechy_audio(2.2, 3), np.zeros(8000, np.float32),
                            _speechy_audio(1.5, 4)])
    path = str(tmp_path / "clip.wav")
    save_wav(path, audio, 16000)
    out = tt.transcribe_wav(path)
    assert _lines(out) == _lines(jt.transcribe_wav(path))
    assert _lines(out) == _lines(tt.transcribe(audio))
    assert any(line.text for line in out.lines)


def test_streams_match_jax(catalog_cache):
    """A stream and the implicit default stream, each updated at fixed
    points, give JAX's events."""
    audio = np.concatenate([_speechy_audio(1.6, 5), np.zeros(4000, np.float32),
                            _speechy_audio(1.2, 6)])
    chunks = [audio[i:i + 8000] for i in range(0, len(audio), 8000)]
    # A long interval: the stream updates only where the test asks it to,
    # so the events do not depend on how long a pass takes.
    jt, tt = _pair(transcription_interval=1000)
    events = []
    for t in (jt, tt):
        stream = t.create_stream(update_interval=1000)
        seen = _listen(stream)
        stream.start()
        for chunk in chunks:
            stream.add_audio(chunk)
            stream.update_transcription(FLAG_FORCE_UPDATE)
        final = stream.stop()
        t.free_stream(stream)
        events.append((seen, _lines(final)))
    assert events[1] == events[0]
    assert any(kind == "LineCompleted" for kind, *_ in events[1][0])

    events = []
    for t in (jt, tt):
        seen = []
        t.add_listener(lambda e, seen=seen: seen.append((type(e).__name__, e.line.text)))
        for chunk in chunks:
            t.add_audio(chunk)
            t.update_transcription(FLAG_FORCE_UPDATE)
        events.append((seen, _lines(t.stop())))
        assert t._default_stream is None
    assert events[1] == events[0]


def test_vad_weights_transcribe_as_jax(catalog_cache, monkeypatch, tmp_path):
    """``vad_weights=`` runs TinyVad on the named export (both packages'
    ``load_onnx`` return the same in-memory graph of TinyVadCNN's
    contract): the same segments and lines as JAX's, at the default VAD
    threshold."""
    from moonshine_tpu.core import onnx_io as jonnx
    from moonshine_tpu_torch.core import onnx_io as tonnx

    graph = tinyvad_graph(0)
    path = str(tmp_path / "tinyvad.onnx")
    opened = []
    for module in (jonnx, tonnx):
        monkeypatch.setattr(module, "load_onnx", lambda p: opened.append(p) or graph)
    audio = np.concatenate([_speechy_audio(1.6, 8), np.zeros(24000, np.float32),
                            _speechy_audio(1.2, 9), np.zeros(16000, np.float32)])
    jt = japi.Transcriber("base", "en", vad_weights=path).load()
    tt = tapi.Transcriber("base", "en", vad_weights=path, device="cpu").load()
    assert opened == [path, path]
    out = tt.transcribe(audio)
    assert _lines(out) == _lines(jt.transcribe(audio))
    assert len(out.lines) == 2 and all(line.text for line in out.lines)


def test_run_and_api_logs(catalog_cache, capsys):
    """log_model_run (no longer refused) prints each backend run with its
    time, and log_api_calls each public call, as in the JAX package."""
    profiling.stats.reset()
    try:
        tt = tapi.Transcriber("base", "en", device="cpu").with_options(
            vad_threshold=0, log_model_run=True, log_api_calls=True).load()
        tt.transcribe(_speechy_audio(1.0, 7))
    finally:
        profiling.enable_device_run_log(False)
    err = capsys.readouterr().err
    assert "[api-call] transcribe(audio=array(16000,), sample_rate=16000)" in err
    assert "[model-run] encode" in err and "[model-run] decode" in err
    assert {"encode", "decode"} <= set(profiling.stats.snapshot())


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").is_file()
    assert any("matmul" in e.key or "dot" in e.key for e in prof.key_averages())
    json.loads((tmp_path / "trace" / "trace.json").read_text())


def test_librispeech_main_loads_weights(catalog_cache, tmp_path, capsys, monkeypatch):
    """eval/librispeech.py's main() takes --weights through
    import_hf_moonshine."""
    from moonshine_tpu_torch.eval.librispeech import main

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    save_wav(str(corpus / "a.wav"), _speechy_audio(1.5, 8), 16000)
    (corpus / "a.txt").write_text("W3 W4\n")
    loaded = []
    real = weights.import_hf_moonshine
    monkeypatch.setattr(weights, "import_hf_moonshine",
                        lambda *a, **k: loaded.append(a[0]) or real(*a, **k))
    checkpoint = str(catalog_cache / "base-en" / "model.safetensors")
    main([str(corpus), "--arch", "base", "--weights", checkpoint, "--tokenizer",
          str(catalog_cache / "base-en" / "tokenizer.bin"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert loaded == [checkpoint]
    assert out["utterances"] == 1 and np.isfinite(out["wer"])


def test_mic_transcriber_refuses_without_sounddevice(catalog_cache, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sounddevice", None)
    _, tt = _pair()
    mic = tapi.MicTranscriber(tt)
    with pytest.raises(RuntimeError, match="sounddevice"):
        mic.start()
