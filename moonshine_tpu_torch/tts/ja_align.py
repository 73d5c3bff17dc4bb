"""Kana-anchored alignment of the reference's shipped ja wiki corpus.

The reference ships, in-tree, 100 wiki lines with BOTH the source text
(reference: core/moonshine-tts/tests/data/ja/tok_pos_wiki_100.txt — strip
the /TAG annotations) and the full ONNX-pipeline IPA
(onnx_g2p_wiki_100.txt).  Kana-only spans convert deterministically with
the reference's kana table, so they anchor an alignment between the
source characters and the golden IPA words; kanji spans between anchors
yield (surface, reading) pairs.

Consumers: scripts/harvest_ja_readings.py (writes the reading lexicon
TSV) and train/ja_reader.py (trains the neural kanji-reading tier on the
aligned pairs — the analog of the reference's ja ONNX helper,
japanese-tok-pos-onnx.h).
"""

from __future__ import annotations

from collections import Counter
from functools import lru_cache
import os
from pathlib import Path

from .lang_rules import kana_to_ipa

MAX_SPAN = 8
MAX_PATHS = 200

REF_JA_DIR = Path(os.environ.get(
    "MOONSHINE_REFERENCE_ROOT",
    Path.home() / "reference")) / "core" / "moonshine-tts" / "tests" / "data" / "ja"


def is_kana(c: str) -> bool:
    o = ord(c)
    return 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF or c in "ーっッ"


def is_kanji(c: str) -> bool:
    return 0x4E00 <= ord(c) <= 0x9FFF or c in "々〆ヶ"


def is_skippable(c: str) -> bool:
    # Latin/digits/symbols the reference's pipeline drops.
    return not (is_kana(c) or is_kanji(c))


def kana_eq(span: str, word: str) -> bool:
    """Kana conversion match, tolerating the dict-vs-kana-table symbol
    variants in the goldens (compressed-w and long-vowel notation)."""
    a = kana_to_ipa(span)
    b = word
    for x, y in (("ᵝ", ""), ("ʔ", ""), ("ː", "")):
        a = a.replace(x, y)
        b = b.replace(x, y)
    return a == b


def _is_hira(c: str) -> bool:
    return 0x3041 <= ord(c) <= 0x309F or c in "ーっ"


def _is_kata(c: str) -> bool:
    return 0x30A1 <= ord(c) <= 0x30FF or c == "ー"


def kanji_okurigana(span: str) -> bool:
    """katakana* kanji+ hiragana* — a katakana/kanji stem with optional
    trailing hiragana okurigana; no kana between kanji."""
    if not any(is_kanji(c) for c in span):
        return False
    state = 0  # 0 = katakana prefix, 1 = kanji stem, 2 = hiragana tail
    for c in span:
        if state == 0:
            if _is_kata(c):
                continue
            if is_kanji(c):
                state = 1
                continue
            return False
        if state == 1:
            if is_kanji(c):
                continue
            if _is_hira(c):
                state = 2
                continue
            return False
        if not _is_hira(c):
            return False
    return state >= 1


def align_line(src: str, words: list[str], known=None):
    """Yield alignment paths: lists of (span, word, is_kanji_pair).
    *known* maps surface->reading; matching spans anchor like kana."""
    n, m = len(src), len(words)
    known = known or {}

    @lru_cache(maxsize=None)
    def reachable(pos: int, wi: int) -> bool:
        if wi == m:
            return all(is_skippable(c) for c in src[pos:])
        if pos >= n:
            return False
        if is_skippable(src[pos]):
            return reachable(pos + 1, wi)
        w = words[wi]
        for L in range(1, min(MAX_SPAN, n - pos) + 1):
            span = src[pos:pos + L]
            if all(is_kana(c) for c in span):
                if kana_eq(span, w) and reachable(pos + L, wi + 1):
                    return True
                continue
            if kanji_okurigana(span):
                k = known.get(span)
                if k is not None and k != w:
                    continue
                if reachable(pos + L, wi + 1):
                    return True
        return False

    paths = []

    def walk(pos: int, wi: int, acc):
        if len(paths) >= MAX_PATHS:
            return
        if wi == m:
            if all(is_skippable(c) for c in src[pos:]):
                paths.append(list(acc))
            return
        if pos >= n:
            return
        if is_skippable(src[pos]):
            walk(pos + 1, wi, acc)
            return
        w = words[wi]
        for L in range(1, min(MAX_SPAN, n - pos) + 1):
            span = src[pos:pos + L]
            if all(is_kana(c) for c in span):
                if kana_eq(span, w) and reachable(pos + L, wi + 1):
                    acc.append((span, w, False))
                    walk(pos + L, wi + 1, acc)
                    acc.pop()
                continue
            if kanji_okurigana(span):
                k = known.get(span)
                if k is not None and k != w:
                    continue
                if reachable(pos + L, wi + 1):
                    acc.append((span, w, k is None))
                    walk(pos + L, wi + 1, acc)
                    acc.pop()
    walk(0, 0, [])
    return paths


def harvest(lines, known=None):
    """-> (Counter[(surface, ipa)], aligned_line_count) of kanji pairs
    consistent across each line's alignment paths."""
    agreed = Counter()
    aligned_lines = 0
    known = dict(known or {})
    for src, words in lines:
        if any(c.isdigit() for c in src):
            # Digit runs expand to number words in the golden IPA and
            # cannot be anchored; skip those lines.
            continue
        paths = align_line(src, words, known)
        if not paths:
            continue
        aligned_lines += 1
        common = set(p for p in paths[0] if p[2])
        for path in paths[1:]:
            common &= set(p for p in path if p[2])
        # sorted: set iteration order is hash-randomized per process;
        # Counter insertion order must be deterministic because
        # most_common ties break by it (em_harvest).
        for span, w, _ in sorted(common):
            agreed[(span, w)] += 1
    return agreed, aligned_lines


def em_harvest(corpus, rounds: int = 5):
    """EM-style bootstrap: confident pairs become anchors for the next
    round, shrinking the ambiguity of the remaining lines.

    -> (readings dict surface->ipa, aligned_line_count)
    """
    known: dict[str, str] = {}
    n_aligned = 0
    for _ in range(rounds):
        agreed, n_aligned = harvest(corpus, known)
        by_surface: dict[str, Counter] = {}
        for (span, w), c in sorted(agreed.items()):
            by_surface.setdefault(span, Counter())[w] += c
        # deterministic majority: count, then lexicographic tie-break
        new_known = {sp: max(sorted(cnt.items()),
                             key=lambda kv: kv[1])[0]
                     for sp, cnt in by_surface.items()}
        before = len(known)
        for sp, w in new_known.items():
            known.setdefault(sp, w)
        if len(known) == before:
            break
    return known, n_aligned


def load_corpus(ref_dir: Path | None = None):
    """-> [(source_line, [golden IPA words])] for the 100 wiki lines."""
    ref = ref_dir or REF_JA_DIR
    srcs = []
    for line in (ref / "tok_pos_wiki_100.txt").read_text(
            encoding="utf-8").splitlines():
        srcs.append("".join(c.rsplit("/", 1)[0]
                            for c in line.split(" ") if c))
    golds = (ref / "onnx_g2p_wiki_100.txt").read_text(
        encoding="utf-8").splitlines()
    return [(s, g.split()) for s, g in zip(srcs, golds)]


def load_annotations(ref_dir: Path | None = None):
    """The reference helper's own shipped (surface, UPOS) annotations,
    one list per wiki line (tok_pos_wiki_100.txt — the output of
    japanese-tok-pos-onnx on exactly these lines)."""
    ref = ref_dir or REF_JA_DIR
    out = []
    for line in (ref / "tok_pos_wiki_100.txt").read_text(
            encoding="utf-8").splitlines():
        pairs = []
        for tok in line.split(" "):
            if not tok:
                continue
            surf, _, tag = tok.rpartition("/")
            if surf:
                pairs.append((surf, tag))
        out.append(pairs)
    return out


def reference_annotator(ref_dir: Path | None = None):
    """annotate(text) -> [(surface, UPOS)] backed by the shipped
    annotations (keyed by reconstructed source line); unknown text gets
    a script-run fallback segmentation (NOUN for han runs)."""
    index = {}
    for pairs in load_annotations(ref_dir):
        index["".join(s for s, _ in pairs)] = pairs

    def annotate(text: str):
        hit = index.get(text)
        if hit is not None:
            return hit
        out, cur, kind = [], [], None

        def k_of(c):
            if is_kanji(c):
                return "han"
            if is_kana(c):
                return "kana"
            return "other"
        for c in text:
            k = k_of(c)
            if k != kind and cur:
                out.append(("".join(cur),
                            "NOUN" if kind == "han" else "ADP"))
                cur = []
            kind = k
            cur.append(c)
        if cur:
            out.append(("".join(cur), "NOUN" if kind == "han" else "ADP"))
        return out

    return annotate


def kana_spans(corpus) -> Counter:
    """Kana-only training spans: every kana run in the corpus source
    paired with its deterministic kana-table IPA (exact supervision the
    aligner itself relies on)."""
    pairs = Counter()
    for src, _ in corpus:
        i, n = 0, len(src)
        while i < n:
            if is_kana(src[i]):
                j = i
                while j < n and is_kana(src[j]):
                    j += 1
                span = src[i:j]
                ipa = kana_to_ipa(span)
                if ipa and len(span) <= MAX_SPAN:
                    pairs[(span, ipa)] += 1
                i = j
            else:
                i += 1
    return pairs
