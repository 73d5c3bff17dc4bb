"""Score our G2P engines against reference-engine IPA goldens.

The goldens under ``tests/data/g2p_ref/<lang>.golden.tsv`` were produced by
running the REFERENCE's own rule engines (core/moonshine-tts/src/
lang-specific/*.cpp, compiled unmodified as an offline oracle with the
ONNX-helper tier stubbed out and — except for English — no lexicon, since
the reference's per-language ``dict.tsv`` trees are CDN-fetched and absent
in this environment; English uses the 10,855-word dictionary the reference
ships in-tree, the same one our engine bakes in).  Each line is
``source text<TAB>reference IPA``.  This mirrors the reference's own golden
methodology (core/moonshine-tts/tests/data/*/rule_g2p_wiki_100.txt and the
``*-rule-g2p-test.cpp`` word goldens): pre-generated reference-engine output
compared verbatim, with a stress-stripped variant exactly like the
``strip_stress`` helper in french-rule-g2p-test.cpp.

Metrics per language:
- ``word_agreement``: fraction of reference IPA words our engine reproduces
  exactly after stress stripping (difflib alignment, scored against the
  reference token count) — the headline number.
- ``word_agreement_strict``: same but including ˈ/ˌ stress marks.
- ``char_similarity``: SequenceMatcher ratio over the stress-stripped
  full-line strings (partial credit for near-miss words).
"""

from __future__ import annotations

import difflib
import re
import unicodedata
from dataclasses import dataclass
from pathlib import Path

# reference dialect id -> our engine language key
DIALECT_TO_LANG = {
    "en": "en",
    "es_es": "es_es",
    "es_mx": "es_mx",
    "de": "de",
    "fr": "fr",
    "nl": "nl",
    "it": "it",
    "ru": "ru",
    "uk": "uk",
    "pt_br": "pt_br",
    "pt_pt": "pt_pt",
    "tr": "tr",
    "ko": "ko",
    "vi": "vi",
    "hi": "hi",
    "ar": "ar",
    "ja": "ja",
}

_STRESS = re.compile("[ˈˌ]")  # ˈ ˌ
# Pause/punctuation tokens both engines may interleave with words.
_PUNCT_ONLY = re.compile(r"^[\W_|‖…]+$", re.UNICODE)


def default_data_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "tests" / "data" / "g2p_ref"


def strip_stress(s: str) -> str:
    return _STRESS.sub("", s)


def _tokens(ipa_line: str) -> list[str]:
    """IPA words with surrounding punctuation removed; pause marks dropped."""
    out = []
    for raw in ipa_line.split():
        if _PUNCT_ONLY.match(raw):
            continue
        # strip leading/trailing punctuation but keep word-internal marks
        t = raw.strip(".,;:!?¿¡()[]\"'«»|‖–—")
        if t:
            out.append(unicodedata.normalize("NFC", t))
    return out


def _aligned_matches(ref: list[str], hyp: list[str]) -> int:
    sm = difflib.SequenceMatcher(a=ref, b=hyp, autojunk=False)
    return sum(b.size for b in sm.get_matching_blocks())


@dataclass
class LangScore:
    dialect: str
    lines: int
    ref_words: int
    word_agreement: float
    word_agreement_strict: float
    char_similarity: float


def score_language(dialect: str, data_dir: Path | None = None,
                   phonemizer=None,
                   line_range: tuple[int, int] | None = None) -> LangScore:
    """``line_range``: optional (start, end) half-open golden-row slice —
    used for honest train/held-out splits (e.g. the ja reading tier
    trains on rows 0..80 and scores on 80..100)."""
    from ..tts.g2p import GraphemeToPhonemizer

    data_dir = data_dir or default_data_dir()
    golden = data_dir / f"{dialect}.golden.tsv"
    rows = []
    for line in golden.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        text, ipa = line.split("\t", 1)
        rows.append((text, ipa))
    if line_range is not None:
        rows = rows[line_range[0]:line_range[1]]
    g = phonemizer or GraphemeToPhonemizer(language=DIALECT_TO_LANG[dialect])

    ref_words = 0
    m_loose = 0
    m_strict = 0
    sim_num = 0.0
    for text, ref_ipa in rows:
        hyp_ipa = g.text_to_ipa(text)
        rt = _tokens(ref_ipa)
        ht = _tokens(hyp_ipa)
        ref_words += len(rt)
        m_strict += _aligned_matches(rt, ht)
        rt_s = [strip_stress(t) for t in rt]
        ht_s = [strip_stress(t) for t in ht]
        m_loose += _aligned_matches(rt_s, ht_s)
        sm = difflib.SequenceMatcher(
            a=strip_stress(" ".join(rt_s)), b=strip_stress(" ".join(ht_s)),
            autojunk=False)
        sim_num += sm.ratio()
    n = max(1, ref_words)
    return LangScore(
        dialect=dialect,
        lines=len(rows),
        ref_words=ref_words,
        word_agreement=m_loose / n,
        word_agreement_strict=m_strict / n,
        char_similarity=sim_num / max(1, len(rows)),
    )


def score_all(dialects=None, data_dir: Path | None = None) -> list[LangScore]:
    data_dir = data_dir or default_data_dir()
    if dialects is None:
        dialects = sorted(
            p.name.split(".")[0] for p in data_dir.glob("*.golden.tsv"))
    return [score_language(d, data_dir) for d in dialects]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--langs", nargs="*", default=None)
    ap.add_argument("--verbose", action="store_true",
                    help="print per-line diffs for the worst lines")
    args = ap.parse_args(argv)
    scores = score_all(args.langs)
    print(f"{'dialect':8} {'lines':>5} {'words':>6} "
          f"{'agree':>7} {'strict':>7} {'charsim':>8}")
    for s in scores:
        print(f"{s.dialect:8} {s.lines:>5} {s.ref_words:>6} "
              f"{s.word_agreement:>7.1%} {s.word_agreement_strict:>7.1%} "
              f"{s.char_similarity:>8.3f}")
    mean = sum(s.word_agreement for s in scores) / max(1, len(scores))
    print(f"{'MEAN':8} {'':>5} {'':>6} {mean:>7.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
