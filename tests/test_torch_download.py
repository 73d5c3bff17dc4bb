"""The port's downloader (``download.py``, a copy of the JAX package's over
the port's catalog) against a loopback HTTP server with Range support,
case for case as tests/test_download.py (reference: offline
AssetDownloaderTests mock the HTTP layer, README.md:1048).  No request
leaves the host.  Downloaded bytes must equal the served payload exactly,
and ``download_model`` must lay out the same files as the JAX package's.
"""

import http.server
import threading

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import download as jax_download
from moonshine_tpu_torch import catalog
from moonshine_tpu_torch.download import DownloadError, download_file, download_model


class RangeHandler(http.server.BaseHTTPRequestHandler):
    payload = b"x" * 100_000
    support_range = True
    fail_after: int | None = None  # bytes to serve before dropping

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        data = self.payload
        start = 0
        rng = self.headers.get("Range")
        if rng and self.support_range:
            start = int(rng.split("=")[1].split("-")[0])
            if start >= len(data):
                self.send_response(416)
                self.end_headers()
                return
            self.send_response(206)
        else:
            self.send_response(200)
        body = data[start:]
        if self.fail_after is not None:
            body = body[: self.fail_after]
        self.send_header("Content-Length", str(len(data) - start))
        self.end_headers()
        try:
            self.wfile.write(body)
        except BrokenPipeError:
            pass


@pytest.fixture()
def server():
    RangeHandler.fail_after = None
    RangeHandler.support_range = True
    httpd = http.server.HTTPServer(("127.0.0.1", 0), RangeHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()


def test_basic_download_with_progress(server, tmp_path):
    seen = []
    dest = download_file(
        server + "/file.bin",
        tmp_path / "file.bin",
        expected_size=100_000,
        progress=lambda f, n: seen.append(f),
    )
    assert dest.read_bytes() == RangeHandler.payload
    assert not (tmp_path / "file.bin.part").exists()
    assert seen[-1] == 1.0


def test_idempotent_refetch(server, tmp_path):
    dest = download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    mtime = dest.stat().st_mtime_ns
    dest2 = download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    assert dest2.stat().st_mtime_ns == mtime  # untouched


def test_resume_after_interruption(server, tmp_path):
    RangeHandler.fail_after = 30_000
    with pytest.raises(DownloadError):
        download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    part = tmp_path / "f.part"
    assert part.exists() and part.stat().st_size == 30_000
    RangeHandler.fail_after = None
    dest = download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    assert dest.read_bytes() == RangeHandler.payload


def test_server_without_range_restarts(server, tmp_path):
    RangeHandler.fail_after = 30_000
    with pytest.raises(DownloadError):
        download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    RangeHandler.fail_after = None
    RangeHandler.support_range = False
    dest = download_file(server + "/f", tmp_path / "f", expected_size=100_000)
    assert dest.read_bytes() == RangeHandler.payload


def test_checksum_verification(server, tmp_path):
    import zlib

    good = f"{zlib.crc32(RangeHandler.payload):08x}"
    dest = download_file(
        server + "/f", tmp_path / "f", expected_size=100_000, expected_crc32c=good
    )
    assert dest.exists()
    with pytest.raises(DownloadError):
        download_file(
            server + "/g", tmp_path / "g", expected_size=100_000,
            expected_crc32c="deadbeef",
        )
    assert not (tmp_path / "g").exists()


def test_download_model_requires_base_url(tmp_path, monkeypatch):
    monkeypatch.delenv("MOONSHINE_TPU_MODEL_URL", raising=False)
    with pytest.raises(DownloadError):
        download_model("tiny", dest_dir=tmp_path)


def test_download_model_layout(server, tmp_path, monkeypatch):
    # Serve every file from the same payload; optional files succeed too.
    root = download_model("tiny", base_url=server, dest_dir=tmp_path / "tiny-en")
    resolved = catalog.resolve("tiny", "en", search_dirs=[root])
    assert resolved.path("model.safetensors").exists()
    assert resolved.path("tokenizer.bin").exists()
    ref = jax_download.download_model("tiny", base_url=server, dest_dir=tmp_path / "jax")
    files = sorted(p.name for p in root.iterdir())
    assert files == sorted(p.name for p in ref.iterdir())
    for name in files:
        assert (root / name).read_bytes() == (ref / name).read_bytes() == RangeHandler.payload
    # Without dest_dir: the cache layout, <cache>/<model>-<language>/.
    monkeypatch.setenv(catalog.DEFAULT_CACHE_ENV, str(tmp_path / "cache"))
    monkeypatch.setenv("MOONSHINE_TPU_MODEL_URL", server)
    assert download_model("base", "es") == tmp_path / "cache" / "base-es"
