"""Baked English pronunciation dictionary (real data, shipped in-tree).

The reference ships a 10,855-word common-word pronunciation dictionary as
generated C data (reference: micro/g2p/src/g2p_dict_data.h, built by
micro/g2p/tools/build_g2p_dict.py): the most frequent English words whose
CMUdict pronunciation disagrees with a rule-based G2P — i.e. exactly the
exception lexicon a rules engine needs.  This module parses that shipped
artifact's wire format (the same way core/tokenizer.py reads the shipped
tokenizer.bin), so the English engine gets 10k+ REAL pronunciations with
zero egress.

Wire format (reference: micro/g2p/src/g2p_dict.cc:16-99):
  - ``kG2pPhones``: table of IPA symbols, one UTF-8 codepoint each; phone
    ids in entries are byte indexes into it.
  - ``kG2pBody``: front-coded sorted entries, restart every
    ``kG2pBlockSize`` (16).  Each entry is
    ``[sharedPrefixLen][suffixLen][suffix bytes...][ipaLen][phoneIds...]``;
    a key is the previous key's first ``sharedPrefixLen`` bytes + suffix.
  - Keys are normalized: lowercase a-z plus internal apostrophes
    (contractions keep them; surrounding quote-apostrophes are stripped).
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path

# A checkout of the reference at ~/reference (the catalog looks there too).
_REFERENCE_DICT = Path.home() / "reference" / "micro" / "g2p" / "src" / "g2p_dict_data.h"


def default_baked_dict_path() -> Path | None:
    """The in-tree reference artifact, when mounted (tests/dev); None in
    deployments that ship their own lexicon via ``lexicon_path``."""
    return _REFERENCE_DICT if _REFERENCE_DICT.exists() else None


def _extract_array(text: str, name: str) -> str:
    m = re.search(rf"{name}\[\]\s*=\s*\{{(.*?)\}};", text, re.DOTALL)
    if not m:
        raise ValueError(f"array {name} not found in baked dict header")
    return m.group(1)


def _parse_phones(text: str) -> list[str]:
    body = _extract_array(text, "kG2pPhones")
    phones = []
    for lit in re.findall(r'"((?:\\x[0-9A-Fa-f]{2}|[^"\\])*)"', body):
        raw = re.sub(
            r"\\x([0-9A-Fa-f]{2})", lambda m: chr(int(m.group(1), 16)), lit
        ).encode("latin-1")
        phones.append(raw.decode("utf-8"))
    return phones


def normalize_word_key(word: str) -> str:
    """The reference's NormalizeWordKey (g2p_dict.cc:35-49): lowercase
    letters + internal apostrophes; surrounding apostrophes stripped."""
    key = "".join(c for c in word.lower() if ("a" <= c <= "z") or c == "'")
    return key.strip("'")


def parse_baked_dict(path: str | Path) -> dict[str, str]:
    """Decode the baked dictionary header into {word: ipa}."""
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    phones = _parse_phones(text)
    n_entries = int(re.search(r"kG2pNumEntries\s*=\s*(\d+)", text).group(1))
    body_txt = _extract_array(text, "kG2pBody")
    body = bytes(int(t) for t in re.findall(r"\d+", body_txt))

    out: dict[str, str] = {}
    off = 0
    prev = b""
    for _ in range(n_entries):
        shared = body[off]
        slen = body[off + 1]
        off += 2
        key = prev[:shared] + body[off : off + slen]
        off += slen
        ilen = body[off]
        off += 1
        ipa = "".join(phones[b] for b in body[off : off + ilen] if b < len(phones))
        off += ilen
        out[key.decode("utf-8")] = ipa
        prev = key
    return out


@lru_cache(maxsize=1)
def _cached_reference_dict() -> dict[str, str]:
    path = default_baked_dict_path()
    return parse_baked_dict(path) if path else {}


def load_baked_dict(path: str | Path | None = None) -> dict[str, str]:
    """Parse ``path`` (or the mounted reference artifact; {} if absent)."""
    if path is not None:
        return parse_baked_dict(path)
    return dict(_cached_reference_dict())
