"""The port's command line (``cli.py``) against the JAX package's, on the
CPU.  Mirrors the CLI cases of tests/test_api.py: ``models``, ``g2p``,
``tts``, ``agent``, ``download`` without a base URL, and ``transcribe`` (one
HF checkpoint and tokenizer in a catalog cache that both packages resolve,
so it runs without the reference's tokenizer); ``serve`` hands its
arguments to the port's ``server.main``, and ``bench`` refuses.

Output must equal the JAX CLI's where it is deterministic: the catalog,
the IPA, the agent's replies, the download refusal and the transcript
lines.  Speech from the Klatt voice (no weights) must have JAX's length
and sample rate and lie within the Klatt tests' relative RMS error of
2e-3; the random-weight neural voice draws its weights differently from
JAX, so only its format is checked.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from test_torch_api import _speechy_audio, catalog_cache  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import cli as jcli
from moonshine_tpu_torch import cli as tcli
from moonshine_tpu_torch.audio.wav import load_wav, save_wav


def _run(main, argv, capsys, monkeypatch, stdin: str | None = None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, monkeypatch, stdin=None):
    return (_run(jcli.main, argv, capsys, monkeypatch, stdin),
            _run(tcli.main, argv, capsys, monkeypatch, stdin))


@pytest.mark.parametrize("argv", [["models"], ["models", "--json"]])
def test_models_matches_jax(argv, capsys, monkeypatch):
    ref, out = _both(argv, capsys, monkeypatch)
    assert out == ref
    assert out[0] == 0 and "tiny-en" in out[1]


@pytest.mark.parametrize("argv", [["g2p", "hello world", "--language", "en"],
                                  ["g2p", "dos gatos", "--language", "es"],
                                  ["g2p", "数学", "--language", "zh"]])
def test_g2p_matches_jax(argv, capsys, monkeypatch):
    ref, out = _both(argv, capsys, monkeypatch)
    assert out == ref
    assert out[0] == 0 and out[1].strip()


def test_agent_matches_jax(capsys, monkeypatch):
    ref, out = _both(["agent", "--trigger", "hello agent"], capsys, monkeypatch,
                     stdin="hello agent\nanything\nsomething else\n")
    assert out == ref
    assert "Say something" in out[1] and "You said: anything" in out[1]


def test_download_without_base_url_matches_jax(capsys, monkeypatch):
    monkeypatch.delenv("MOONSHINE_TPU_MODEL_URL", raising=False)
    ref, out = _both(["download", "tiny"], capsys, monkeypatch)
    assert out == ref
    assert out[0] == 1 and "download failed" in out[2]


def test_tts_klatt_matches_jax(tmp_path, capsys, monkeypatch):
    from moonshine_tpu.audio.wav import load_wav as jax_load_wav

    paths = [str(tmp_path / "jax.wav"), str(tmp_path / "port.wav")]
    rc, ref, _ = _run(jcli.main, ["tts", "seven", "--voice", "klatt", "-o", paths[0]],
                      capsys, monkeypatch)
    assert rc == 0
    rc, out, _ = _run(tcli.main, ["tts", "seven", "--voice", "klatt", "-o", paths[1],
                                  "--device", "cpu"], capsys, monkeypatch)
    assert rc == 0 and out.replace(paths[1], paths[0]) == ref
    (wav, sr), (jwav, jsr) = load_wav(paths[1]), jax_load_wav(paths[0])
    assert sr == jsr and wav.shape == jwav.shape and wav.size > 0
    rel = np.sqrt(np.mean((wav - jwav) ** 2)) / np.sqrt(np.mean(jwav ** 2))
    assert rel < 2e-3


def test_tts_default_voice(tmp_path, capsys, monkeypatch):
    path = tmp_path / "x.wav"
    rc, out, _ = _run(tcli.main, ["tts", "hi", "-o", str(path), "--device", "cpu"], capsys,
                      monkeypatch)
    assert rc == 0 and out.startswith(f"wrote {path} (") and out.rstrip().endswith("24000 Hz)")
    audio, sr = load_wav(str(path))
    assert sr == 24000 and audio.size > 0


def test_transcribe_matches_jax(catalog_cache, tmp_path, capsys, monkeypatch):  # noqa: F811
    audio = np.concatenate([_speechy_audio(1.8, 21), np.zeros(8000, np.float32),
                            _speechy_audio(1.2, 22)])
    wav = str(tmp_path / "t.wav")
    save_wav(wav, audio, 16000)
    argv = ["transcribe", wav, "--model", "base", "--vad-threshold", "0"]
    rc, ref, _ = _run(jcli.main, argv, capsys, monkeypatch)
    assert rc == 0
    rc, out, err = _run(tcli.main, argv + ["--device", "cpu"], capsys, monkeypatch)
    assert rc == 0 and out == ref
    assert out.startswith("[") and "# transcribed in" in err


def test_serve_passes_its_arguments(monkeypatch):
    from moonshine_tpu_torch import server

    seen = []
    monkeypatch.setattr(server, "main", seen.append)
    assert tcli.main(["serve", "--streams", "4", "--port", "0", "--device", "cpu"]) == 0
    assert seen == [["--model", "tiny_streaming", "--streams", "4", "--host", "127.0.0.1",
                     "--port", "0", "--device", "cpu"]]


def test_bench_refuses(capsys, monkeypatch):
    import subprocess

    monkeypatch.setattr(subprocess, "call", lambda *a, **k: pytest.fail("bench ran a process"))
    rc, out, err = _run(tcli.main, ["bench"], capsys, monkeypatch)
    assert rc != 0 and out == ""
    assert "13.5" in err
