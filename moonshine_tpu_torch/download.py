"""Asset downloader: resumable, atomic, checksum-verified model fetches.

A copy of the JAX package's ``download.py`` (pure Python), over the port's
``catalog`` (the same cache layout and catalog entries).

Capability mirror of the reference's download stack (reference:
language-bindings/python/src/moonshine_voice/download.py, 1,338 LoC; the
Swift/Android/JS AssetDownloaders share the semantics, README.md:985-988):

- atomic ``.part`` staging renamed into place only on success
- HTTP Range resume of interrupted downloads
- free-disk-space preflight
- optional checksum verification against the catalog
- progress callbacks ``(fraction, filename)``

A deployment may have no egress; everything network-facing funnels
through ``urllib`` and is exercised in tests against a loopback HTTP
server.
"""

from __future__ import annotations

import os
import shutil
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable, Optional

from . import catalog

ProgressFn = Callable[[float, str], None]

CHUNK = 1 << 18


class DownloadError(RuntimeError):
    pass


def free_space_bytes(path: Path) -> int:
    return shutil.disk_usage(path).free


def download_file(
    url: str,
    dest: str | Path,
    expected_size: int = 0,
    expected_crc32c: str = "",
    progress: Optional[ProgressFn] = None,
    min_free_bytes_margin: int = 64 << 20,
) -> Path:
    """Fetch ``url`` into ``dest`` with resume + atomic rename.

    An existing ``dest`` with matching size/checksum is returned untouched
    (idempotent re-fetch, reference: scripts/fetch-voice-assets.sh
    idempotency).
    """
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    name = dest.name

    if dest.exists():
        if (not expected_size or dest.stat().st_size == expected_size) and (
            not expected_crc32c or catalog.crc32c_of(dest) == expected_crc32c
        ):
            if progress:
                progress(1.0, name)
            return dest
        dest.unlink()

    part = dest.with_suffix(dest.suffix + ".part")
    validator_file = dest.with_suffix(dest.suffix + ".part.etag")
    offset = part.stat().st_size if part.exists() else 0
    validator = None
    if offset:
        if validator_file.exists():
            validator = validator_file.read_text().strip() or None
        if validator is None and not expected_size and not expected_crc32c:
            # Nothing can validate a stitched file (no If-Range validator,
            # no catalog size/checksum): resuming could silently corrupt it
            # if the remote changed.  Start over.
            part.unlink()
            offset = 0

    if expected_size:
        need = expected_size - offset + min_free_bytes_margin
        if free_space_bytes(dest.parent) < need:
            raise DownloadError(
                f"Not enough free space for {name}: need {need} bytes"
            )

    req = urllib.request.Request(url)
    if offset:
        req.add_header("Range", f"bytes={offset}-")
        if validator:
            # If the remote changed since the first attempt, If-Range makes
            # the server return 200 + full body instead of a mismatched 206.
            req.add_header("If-Range", validator)
    try:
        resp = urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:
        if e.code == 416 and offset:  # range beyond EOF: restart clean
            part.unlink()
            return download_file(url, dest, expected_size, expected_crc32c, progress)
        raise DownloadError(f"HTTP {e.code} fetching {url}") from e
    except urllib.error.URLError as e:
        raise DownloadError(f"Cannot reach {url}: {e.reason}") from e

    with resp:
        status = resp.status
        if offset and status != 206:
            # Server ignored the Range header (or If-Range detected a
            # changed file): restart from zero.
            offset = 0
            mode = "wb"
        else:
            mode = "ab" if offset else "wb"
        etag = resp.headers.get("ETag") or resp.headers.get("Last-Modified")
        if etag:
            validator_file.write_text(etag)
        total = expected_size
        if not total:
            length = resp.headers.get("Content-Length")
            if length:
                total = offset + int(length)
        with open(part, mode) as f:
            received = offset
            while True:
                chunk = resp.read(CHUNK)
                if not chunk:
                    break
                f.write(chunk)
                received += len(chunk)
                if progress and total:
                    progress(min(received / total, 1.0), name)

    if expected_size and part.stat().st_size != expected_size:
        raise DownloadError(
            f"Size mismatch for {name}: got {part.stat().st_size}, "
            f"expected {expected_size} (partial download kept for resume)"
        )
    if expected_crc32c and catalog.crc32c_of(part) != expected_crc32c:
        part.unlink()
        raise DownloadError(f"Checksum mismatch for {name}; removed")

    part.replace(dest)  # atomic
    validator_file.unlink(missing_ok=True)
    if progress:
        progress(1.0, name)
    return dest


def download_model(
    model: str,
    language: str = "en",
    base_url: str | None = None,
    dest_dir: str | Path | None = None,
    progress: Optional[ProgressFn] = None,
) -> Path:
    """Fetch every catalog file of a model into the cache layout."""
    base_url = base_url or os.environ.get("MOONSHINE_TPU_MODEL_URL")
    if not base_url:
        raise DownloadError(
            "No model base URL configured (set MOONSHINE_TPU_MODEL_URL or "
            "pass base_url)"
        )
    key = f"{model}-{language}"
    entry = catalog.CATALOG.get(key)
    if entry is None:
        raise KeyError(f"Unknown model {key!r}")
    root = Path(dest_dir) if dest_dir else catalog.cache_dir() / key
    for f in entry.files:
        url = f"{base_url.rstrip('/')}/{key}/{f.name}"
        try:
            download_file(
                url, root / f.name, f.size, f.crc32c, progress=progress
            )
        except DownloadError:
            if not f.optional:
                raise
    return root
