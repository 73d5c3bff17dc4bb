"""Precomputed phrase embeddings shipped as data (TSV).

Capability mirror of the reference's cached-embeddings module (reference:
language-bindings/python/src/moonshine_voice/cached_embeddings.py +
scripts/build-cached-embeddings.py): embedding the library's constant
phrases (Confirm's yes/no sets, registered trigger phrases) costs a full
embedder forward pass each, every run — but the phrases and model never
change, so the vectors ship as a TSV and load instantly.  Cache hits
return the stored vector; misses (live utterances) fall through to the
real embedder.

TSV format (identical to the reference's):
    # model_name: gemma-embedder
    # embedding_dim: 768
    # phrase_count: 2
    yes\t0.0123\t-0.0456\t...
    no\t0.0987\t0.0321\t...
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Mapping

import numpy as np


def save_cached_embeddings(
    path: str | Path,
    embeddings: Mapping[str, np.ndarray],
    metadata: Mapping[str, str] | None = None,
) -> None:
    """Write phrase -> vector rows with `# key: value` header lines."""
    lines = []
    meta = dict(metadata or {})
    dims = {np.asarray(v).shape[-1] for v in embeddings.values()}
    if len(dims) > 1:
        raise ValueError(f"Mixed embedding dims {dims}")
    if embeddings:
        meta.setdefault("embedding_dim", str(dims.pop()))
    meta.setdefault("phrase_count", str(len(embeddings)))
    for k, v in meta.items():
        lines.append(f"# {k}: {v}")
    for phrase, vec in embeddings.items():
        if "\t" in phrase or "\n" in phrase:
            raise ValueError(f"Phrase contains tab/newline: {phrase!r}")
        cols = "\t".join(repr(float(x)) for x in np.asarray(vec, np.float32).ravel())
        lines.append(f"{phrase}\t{cols}")
    Path(path).write_text("\n".join(lines) + "\n")


def load_cached_embeddings(path: str | Path) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Read a TSV written by :func:`save_cached_embeddings` (or the
    reference's builder).  Returns ({phrase: vector}, metadata)."""
    embeddings: dict[str, np.ndarray] = {}
    metadata: dict[str, str] = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.rstrip("\n")
        if not line.strip():
            continue
        if line.startswith("#"):
            body = line[1:].strip()
            if ":" in body:
                k, v = body.split(":", 1)
                metadata[k.strip()] = v.strip()
            continue
        parts = line.split("\t")
        phrase, cols = parts[0], parts[1:]
        embeddings[phrase] = np.asarray([float(c) for c in cols], np.float32)
    dim = metadata.get("embedding_dim")
    if dim is not None:
        for phrase, vec in embeddings.items():
            if vec.shape[-1] != int(dim):
                raise ValueError(
                    f"{phrase!r}: {vec.shape[-1]} dims, header says {dim}"
                )
    return embeddings, metadata


def build_cached_embeddings(
    embedder, phrases: Iterable[str], path: str | Path,
    metadata: Mapping[str, str] | None = None,
) -> dict[str, np.ndarray]:
    """Embed phrases with a real embedder and write the TSV (the
    scripts/build-cached-embeddings.py analog)."""
    vecs = {p: np.asarray(embedder.get_embeddings(p), np.float32) for p in phrases}
    save_cached_embeddings(path, vecs, metadata)
    return vecs
