"""Model catalog: the single source of truth for model assets.

A copy of the JAX package's ``catalog.py`` (pure Python).  It keeps the
JAX package's cache variable and directory (``MOONSHINE_TPU_CACHE``,
``~/.cache/moonshine_tpu``) and its tokenizer fallback, so that both
packages resolve the same files.

Mirror of the reference's native catalog (reference:
core/moonshine-model-catalog.{h,cpp} + generated file metadata): each
entry lists the files an architecture needs, expected sizes/checksums
where known, and where to resolve them.  This environment has no egress,
so the resolver only checks local directories (``MOONSHINE_TPU_CACHE``,
explicit paths); the download step is a separate, gated hook that a
deployment wires to its artifact store.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

DEFAULT_CACHE_ENV = "MOONSHINE_TPU_CACHE"  # reference: MOONSHINE_VOICE_CACHE
# The tiny-en tokenizer that the reference's Python binding bundles, in a
# checkout of the reference at ~/reference.
_REFERENCE_TOKENIZER = str(
    Path.home() / "reference" / "language-bindings" / "python" / "src" / "moonshine_voice"
    / "assets" / "tiny-en" / "tokenizer.bin"
)


@dataclass(frozen=True)
class CatalogFile:
    name: str  # canonical filename, e.g. "model.safetensors"
    size: int = 0  # 0 = unknown
    crc32c: str = ""  # empty = unchecked
    optional: bool = False


@dataclass(frozen=True)
class CatalogEntry:
    model: str  # e.g. "tiny", "base", "tiny_streaming"
    language: str = "en"
    files: tuple[CatalogFile, ...] = ()

    @property
    def key(self) -> str:
        return f"{self.model}-{self.language}"


_STANDARD_FILES = (
    CatalogFile("model.safetensors"),
    CatalogFile("tokenizer.bin"),
    CatalogFile("config.json", optional=True),
)
_STREAMING_FILES = _STANDARD_FILES + (
    CatalogFile("streaming_config.json", optional=True),
)

CATALOG: dict[str, CatalogEntry] = {}
for _m in ("tiny", "base"):
    for _lang in ("en", "ar", "zh", "ja", "ko", "uk", "vi", "es"):
        e = CatalogEntry(_m, _lang, _STANDARD_FILES)
        CATALOG[e.key] = e
for _m in ("tiny_streaming", "small_streaming", "medium_streaming"):
    e = CatalogEntry(_m, "en", _STREAMING_FILES)
    CATALOG[e.key] = e

# Models that only the port runs, kept out of CATALOG (whose listings answer
# as the JAX package's do); ``resolve`` finds them too.  Canary-1B-Flash
# (https://huggingface.co/nvidia/canary-1b-flash): a SentencePiece
# tokenizer.model beside the weights; sizes and checksums unchecked.
CANARY_ENTRY = CatalogEntry("canary-1b-flash", "en",
                            (CatalogFile("model.safetensors"), CatalogFile("tokenizer.model")))
PORT_CATALOG: dict[str, CatalogEntry] = {CANARY_ENTRY.key: CANARY_ENTRY}

VAD_ENTRY = CatalogEntry("vad", "any", (CatalogFile("vad.safetensors"),))
EMBEDDING_ENTRY = CatalogEntry(
    "embeddinggemma-300m", "any",
    (CatalogFile("model.safetensors"), CatalogFile("tokenizer.bin")),
)
DIARIZATION_ENTRY = CatalogEntry(
    "diarization", "any",
    (CatalogFile("segmentation.safetensors"), CatalogFile("embedding.safetensors")),
)


def list_models() -> list[str]:
    return sorted(CATALOG)


def catalog_json() -> str:
    """JSON listing (reference: the catalog JSON C APIs,
    moonshine-c-api.h:910-1074)."""
    return json.dumps(
        {
            key: {
                "model": e.model,
                "language": e.language,
                "files": [dataclasses.asdict(f) for f in e.files],
            }
            for key, e in CATALOG.items()
        },
        indent=2,
    )


_LANGUAGE_NAMES = {
    "en": "English", "ar": "Arabic", "zh": "Chinese", "ja": "Japanese",
    "ko": "Korean", "uk": "Ukrainian", "vi": "Vietnamese", "es": "Spanish",
}

# reference: the catalog's default (first) model per language
_DEFAULT_MODEL = "tiny"


def _base_url() -> str:
    return (os.environ.get("MOONSHINE_TPU_MODEL_URL") or "").rstrip("/")


def _file_obj(base: str, key: str, f: CatalogFile) -> dict:
    url = f"{base}/{key}/{f.name}" if base else ""
    return {
        "name": f.name,
        "url": url,
        "size": f.size or None,
        "checksum": f.crc32c,
        "checksum_type": "crc32c" if f.crc32c else "",
    }


def _groups_json(entries: list[CatalogEntry]) -> str:
    """The reference's dependency-manifest shape
    (moonshine-c-api.h:910-1074): ``{"groups":[{"base_url","files":
    [{name,url,size,checksum,checksum_type}]}]}``."""
    base = _base_url()
    groups = []
    for e in entries:
        gb = f"{base}/{e.key}" if base else ""
        groups.append({
            "base_url": gb,
            "files": [_file_obj(base, e.key, f) for f in e.files],
        })
    return json.dumps({"groups": groups})


def stt_dependencies_json(language: str = "en",
                          model_arch: str | None = None,
                          include_spelling: bool = False) -> str:
    """Download manifest for an STT model (reference:
    moonshine_get_stt_dependencies, moonshine-c-api.h:975-1017)."""
    lang = (language or "en").strip().lower()
    for code, name in _LANGUAGE_NAMES.items():
        if lang == name.lower():
            lang = code
            break
    model = model_arch or _DEFAULT_MODEL
    e = CATALOG.get(f"{model}-{lang}")
    if e is None:
        raise KeyError(f"unknown language/arch: {language}/{model}")
    entries = [e]
    if include_spelling:
        entries.append(CatalogEntry(
            "spelling", lang, (CatalogFile("spelling.safetensors"),)))
    return _groups_json(entries)


#: Embedding variants this build ships (the reference's q4/q8/fp16 tiers are
#: ONNX-specific; on TPU the tiers are the safetensors dtype).
EMBEDDING_VARIANTS = ("fp32", "bf16")
_DEFAULT_EMBEDDING_VARIANT = "bf16"


def embedding_dependencies_json(model_name: str | None = None,
                                variant: str | None = None) -> str:
    """(reference: moonshine_get_embedding_dependencies,
    moonshine-c-api.h:1018-1027 — options recognize ``variant`` and the
    manifest lists the variant-specific model file)."""
    name = model_name or EMBEDDING_ENTRY.model
    if name != EMBEDDING_ENTRY.model:
        raise KeyError(f"unknown embedding model: {model_name}")
    v = variant or _DEFAULT_EMBEDDING_VARIANT
    if v not in EMBEDDING_VARIANTS:
        raise KeyError(f"unknown embedding variant: {variant!r} "
                       f"(expected one of {EMBEDDING_VARIANTS})")
    files = tuple(
        CatalogFile(f"model_{v}.safetensors" if f.name == "model.safetensors"
                    else f.name, optional=f.optional)
        for f in EMBEDDING_ENTRY.files)
    e = CatalogEntry(EMBEDDING_ENTRY.model, EMBEDDING_ENTRY.language, files)
    return _groups_json([e])


def diarization_dependencies_json() -> str:
    """(reference: moonshine_get_diarization_dependencies)."""
    return _groups_json([DIARIZATION_ENTRY])


def g2p_dependencies_json(languages: str | None = None) -> str:
    """G2P data dependencies (reference: moonshine_get_g2p_dependencies).
    The TPU build bakes its rule/lexicon data into the package, so the
    manifest is typically empty groups per language — the honest answer
    for a build with no CDN-fetched G2P assets."""
    return json.dumps({"groups": []})


def tts_dependencies_json(languages: str | None = None) -> str:
    """Merged G2P + TTS voice dependencies (reference:
    moonshine_get_tts_dependencies)."""
    e = CatalogEntry("tts", "any", (CatalogFile("voices.safetensors"),))
    return _groups_json([e])


#: Downloadable voice-pack ids the catalog knows about even when absent —
#: listed with ``state: "missing"`` when the pack root has no files, mirroring
#: the reference catalog's not-yet-downloaded voices.
KNOWN_VOICE_PACKS = ("alto", "tenor")


def tts_voices_json(languages: str | None = None,
                    root: str | os.PathLike | None = None,
                    _trusted_root: bool = True) -> str:
    """Known TTS voices with availability (reference:
    moonshine_get_tts_voices: ``{lang: [{"id","state"}]}``).  Built-in
    voices (the trained style voice and the shipped neural pack) are
    always ``found``; ``<name>.voicepack.safetensors`` packs under
    ``root`` list as found; catalog-known packs (:data:`KNOWN_VOICE_PACKS`)
    with no file under ``root`` list as ``missing``.

    ``_trusted_root=False`` (the server RPC path) confines ``root`` to
    descendants of :func:`cache_dir` so a remote client cannot glob
    arbitrary server directories."""
    langs = [s.strip() for s in (languages or "en").split(",") if s.strip()]
    rootp = Path(root) if root else cache_dir()
    if not _trusted_root:
        cache = cache_dir().resolve()
        try:
            rootp.resolve().relative_to(cache)
        except ValueError:
            rootp = cache
    out: dict[str, list[dict]] = {}
    found_packs = set()
    if rootp.is_dir():
        found_packs = {p.name.split(".")[0]
                       for p in rootp.glob("*.voicepack.safetensors")}
    for lang in langs:
        voices = [{"id": "style_default", "state": "found"},
                  {"id": "neural-pack", "state": "found"},
                  # code-only Klatt formant voice (tts/klatt.py) — no
                  # assets to download, always available
                  {"id": "klatt", "state": "found"}]
        for pid in sorted(found_packs):
            voices.append({"id": pid, "state": "found"})
        for pid in KNOWN_VOICE_PACKS:
            if pid not in found_packs:
                voices.append({"id": pid, "state": "missing"})
        out[lang] = voices
    return json.dumps(out)


def stt_catalog_json() -> str:
    """Full STT catalog (reference: moonshine_get_stt_catalog:
    ``{"languages":[{code, english_name, models:[...]}]}``)."""
    base = _base_url()
    langs: dict[str, list[dict]] = {}
    for e in CATALOG.values():
        langs.setdefault(e.language, []).append({
            "model_arch": e.model,
            "download_url": f"{base}/{e.key}" if base else "",
            "is_default": e.model == _DEFAULT_MODEL,
        })
    return json.dumps({"languages": [
        {"code": code, "english_name": _LANGUAGE_NAMES.get(code, code),
         "models": sorted(models, key=lambda m: not m["is_default"])}
        for code, models in sorted(langs.items())
    ]})


def embedding_catalog_json() -> str:
    """(reference: moonshine_get_embedding_catalog)."""
    base = _base_url()
    e = EMBEDDING_ENTRY
    return json.dumps({"models": [{
        "name": e.model,
        "english_name": "Embedding Gemma 300M",
        "download_url": f"{base}/{e.key}" if base else "",
        "variants": ["fp32", "bf16"],
        "default_variant": "bf16",
    }]})


_CATALOG_KINDS = {
    "stt_catalog": lambda arg, opt: stt_catalog_json(),
    "embedding_catalog": lambda arg, opt: embedding_catalog_json(),
    "stt_dependencies": lambda arg, opt: stt_dependencies_json(
        arg or "en", (opt or {}).get("model_arch"),
        bool((opt or {}).get("include_spelling"))),
    "tts_dependencies": lambda arg, opt: tts_dependencies_json(arg),
    "g2p_dependencies": lambda arg, opt: g2p_dependencies_json(arg),
    "embedding_dependencies": lambda arg, opt: embedding_dependencies_json(
        arg, (opt or {}).get("variant")),
    "diarization_dependencies": lambda arg, opt: diarization_dependencies_json(),
    "tts_voices": lambda arg, opt: tts_voices_json(
        arg, (opt or {}).get("root") or (opt or {}).get("g2p_root"),
        _trusted_root=False),
}


def catalog_request_json(kind: str, arg: str | None = None,
                         options: dict | None = None) -> str:
    """Single dispatch for the native catalog/dependency JSON surface
    (server RPC ``{"type":"catalog","kind":...}`` and the C ABI's
    mt_client_catalog_json) — the service-boundary analog of the
    reference's eight moonshine_get_* entry points
    (moonshine-c-api.h:910-1074)."""
    fn = _CATALOG_KINDS.get(kind)
    if fn is None:
        raise KeyError(f"unknown catalog kind: {kind!r} "
                       f"(one of {sorted(_CATALOG_KINDS)})")
    return fn(arg, options)


def cache_dir() -> Path:
    root = os.environ.get(DEFAULT_CACHE_ENV)
    if root:
        return Path(root)
    return Path.home() / ".cache" / "moonshine_tpu"


def crc32c_of(path: Path) -> str:
    # zlib crc32 stands in for crc32c in this build; the field carries
    # whichever the manifest generator wrote.
    h = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h = zlib.crc32(chunk, h)
    return f"{h:08x}"


@dataclass
class ResolvedModel:
    entry: CatalogEntry
    root: Path
    files: dict[str, Path] = field(default_factory=dict)

    def path(self, name: str) -> Optional[Path]:
        return self.files.get(name)


def resolve(
    model: str,
    language: str = "en",
    search_dirs: list[str | Path] | None = None,
    verify: bool = False,
) -> ResolvedModel:
    """Locate a model's files locally.

    Searches explicit dirs, then ``<cache>/<model>-<language>/``.  Missing
    non-optional files raise FileNotFoundError listing what's absent —
    the reference's behavior when assets are missing and downloads are
    disabled.
    """
    key = f"{model}-{language}"
    entry = CATALOG.get(key) or PORT_CATALOG.get(key)
    if entry is None:
        raise KeyError(f"Unknown model {key!r}; known: {list_models() + sorted(PORT_CATALOG)}")
    roots = [Path(d) for d in (search_dirs or [])]
    roots.append(cache_dir() / key)
    missing: list[str] = []
    resolved = None
    for root in roots:
        files: dict[str, Path] = {}
        missing = []
        for f in entry.files:
            p = root / f.name
            if p.exists():
                if verify and f.crc32c and crc32c_of(p) != f.crc32c:
                    raise ValueError(f"Checksum mismatch for {p}")
                files[f.name] = p
            elif not f.optional:
                missing.append(f.name)
        if not missing:
            resolved = ResolvedModel(entry, root, files)
            break
    if resolved is None:
        # Last resort: the reference repo ships the tiny-en tokenizer;
        # loaders can still run with random-initialized weights.
        raise FileNotFoundError(
            f"Model assets for {key} not found (missing {missing}); searched "
            f"{[str(r) for r in roots]}. Place files there or set "
            f"${DEFAULT_CACHE_ENV}."
        )
    return resolved


def default_tokenizer_path() -> Optional[str]:
    """tokenizer.bin fallback: the reference's bundled tiny-en tokenizer
    (shared across the English model family)."""
    if os.path.exists(_REFERENCE_TOKENIZER):
        return _REFERENCE_TOKENIZER
    return None
