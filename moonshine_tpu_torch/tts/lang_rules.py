"""Per-language G2P engines beyond the Latin-European six.

Capability mirror of the reference's lang-specific rule engines
(reference: core/moonshine-tts/src/lang-specific/{arabic,chinese,dutch,
hindi,japanese,korean,russian,turkish,ukrainian,vietnamese}* and
chinese-numbers*).  Each engine exposes the RuleG2P interface
(word_to_ipa / add_lexicon) used by tts.g2p.GraphemeToPhonemizer.

Design per script family:
- **Hangul (ko)**: fully algorithmic — syllables decompose arithmetically
  into lead/vowel/tail jamo; the jamo→IPA tables below give deterministic
  pronunciations (the reference's korean rules do the same decomposition).
- **Kana (ja)**: the reference's exact mora table (japanese-kana-to-ipa
  .cpp); kanji resolves through a reading lexicon harvested from the
  reference's own shipped wiki corpus with greedy longest-match
  segmentation standing in for its ONNX LUW segmenter.
- **Pinyin + numbers (zh)**: toned-pinyin syllables map through an
  initial/final table; digit strings expand through the hanzi number
  reading (reference: chinese-numbers.cpp) and a hanzi lexicon covers the
  numerals and common particles.
- **Cyrillic (ru/uk)**: near-phonemic mapping with palatalization,
  iotated vowels and Russian final-obstruent devoicing.
- **tr/nl/vi/hi/ar**: ordered rewrite rules (same machinery as en/es/…);
  Vietnamese covers the full diacritic inventory (tones carried as IPA
  tone letters), Hindi does Devanagari with inherent-schwa and final
  schwa deletion, Arabic maps the abjad with long vowels and the definite
  article (full vocalization needs the reference's diacritizer ONNX).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path as _PathType

# ---------------------------------------------------------------------------
# Korean — algorithmic Hangul decomposition
# ---------------------------------------------------------------------------

# Lead (choseong) indices: ㄱ0 ㄲ1 ㄴ2 ㄷ3 ㄸ4 ㄹ5 ㅁ6 ㅂ7 ㅃ8 ㅅ9 ㅆ10
# ㅇ11 ㅈ12 ㅉ13 ㅊ14 ㅋ15 ㅌ16 ㅍ17 ㅎ18.
# Symbol inventory matches the reference's Piper-vocoder conventions
# (korean.cpp ipa_onset:291-374): tense stops carry a "-" fortis marker,
# aspiration is ASCII h, ㄱ is ɡ word-initially / q elsewhere.
_KO_ONSET = [
    "ɡ", "q-", "n", "d", "t-", "ɾ", "m", "p", "p-", "s", "s-", "", "tɕ",
    "tɕ", "tʃh", "kh", "th", "ph", "h",
]
# ㅏ is ɐ in ALL positions (the reference's final a→ɐ vocoder pass,
# korean.cpp:676-679, applies inside glide diphthongs too).
_KO_VOWELS = [
    "ɐ", "ɛ", "jɐ", "jɛ", "ʌ", "e", "jʌ", "je", "o", "wɐ", "wɛ", "we",
    "jo", "u", "wʌ", "we", "wi", "ju", "ɯ", "ɯj", "i",
]
_KO_LENIS_TO_TENSE = {0: 1, 3: 4, 7: 8, 9: 10, 12: 13}  # ㄱㄷㅂㅅㅈ → tense
# ㅎ-aspiration of lenis onsets (after a ㅎ coda): korean.cpp:363-372.
_KO_ASPIRATED = {0: "kh", 3: "th", 7: "ph", 12: "tʃh"}
# Post-vowel / post-sonorant onset allophony (korean.cpp:472-486).
_KO_POST_SONORANT = {12: "dʑ", 0: "q", 7: "b"}
# Sonorant codas (korean.cpp is_sonorant_jong:175-181).
_KO_TAIL_SONORANT = {4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 21}
# Tensification triggers (korean.cpp jong_triggers_tense:183-201).
_KO_TENSE_TRIGGER = {1, 2, 3, 7, 17, 18, 19, 20, 22, 23, 24, 25, 26}
# Linking: coda splits into (remaining coda, onset for the next empty-ㅇ
# syllable) — korean.cpp jong_split_for_linking:114-171.
_KO_LINK_SPLIT = {
    1: (0, 0), 2: (0, 1), 3: (1, 9), 4: (0, 2), 5: (4, 12), 6: (4, 18),
    7: (0, 3), 8: (0, 5), 9: (8, 0), 10: (8, 6), 11: (8, 7), 12: (8, 9),
    13: (8, 16), 14: (8, 17), 15: (8, 18), 16: (0, 6), 17: (0, 7),
    18: (17, 9), 19: (0, 9), 20: (0, 10), 22: (0, 12), 23: (0, 14),
    24: (0, 15), 25: (0, 16), 26: (0, 17), 27: (0, 18),
}


def _ko_coda_simple(jong: int) -> str:
    """Unreleased-coda rendering (korean.cpp ipa_coda_simple:389-423)."""
    if jong == 0:
        return ""
    if jong in (1, 2, 3, 24):
        return "q"
    if jong in (7, 25, 19, 20, 22, 23, 27):
        return "t-"
    if jong in (17, 26, 18):
        return "p-"
    if jong in (4, 5, 6):
        return "n"
    if jong == 8 or 9 <= jong <= 15:
        return "ɫ"
    if jong == 16:
        return "m"
    if jong == 21:
        return "ŋ"
    return ""


def _ko_coda_nasal(jong: int, next_cho: int) -> str:
    """Nasal assimilation before ㄴ/ㅁ (korean.cpp:425-445)."""
    if next_cho not in (2, 6):
        return _ko_coda_simple(jong)
    if jong in (1, 2, 3, 24, 9):
        return "ŋ"
    if jong in (7, 19, 20, 22, 23, 25, 27, 12, 13, 14, 15):
        return "n"
    if jong in (17, 18, 26, 11):
        return "m"
    return _ko_coda_simple(jong)


_KO_SINO = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]


def _ko_section_under_10000(n: int) -> str:
    if n <= 0 or n >= 10000:
        return ""
    q, r = divmod(n, 1000)
    b, r2 = divmod(r, 100)
    s, t = divmod(r2, 10)
    parts = ""
    if q:
        parts += ("천" if q == 1 else _KO_SINO[q] + "천")
    if b:
        parts += ("백" if b == 1 else _KO_SINO[b] + "백")
    if s == 0:
        if t:
            parts += _KO_SINO[t]
    elif s == 1:
        parts += "십" + (_KO_SINO[t] if t else "")
    else:
        parts += _KO_SINO[s] + "십" + (_KO_SINO[t] if t else "")
    return parts


def int_to_sino_korean_hangul(n: int) -> str:
    """Sino-Korean cardinal reading (korean-numbers.cpp:147-186)."""
    if n == 0:
        return "영"
    groups = []
    x = n
    while x > 0:
        groups.append(x % 10000)
        x //= 10000
    groups.reverse()
    units = ["", "만", "억", "조", "경"]
    parts = ""
    zero_pending = False
    for i, g in enumerate(groups):
        if g == 0:
            if parts:
                zero_pending = True
            continue
        if zero_pending:
            parts += "영"
            zero_pending = False
        ui = len(groups) - 1 - i
        u = units[min(ui, 4)]
        if u == "만" and g == 1:
            parts += "만"
        else:
            parts += _ko_section_under_10000(g) + u
    return parts


def ko_hangul_digits_only(s: str) -> str:
    """Digit-by-digit sino reading (korean-numbers.cpp:66-74)."""
    return "".join(_KO_SINO[int(c)] for c in s if c.isdigit())


def ko_numeral_fragments(token: str) -> list[str] | None:
    """Hangul reading fragments for an ASCII numeral token, mirroring
    korean-numbers.cpp korean_reading_fragments_from_ascii_numeral_token
    (:189-284): thousands-commas/underscores stripped; leading-zero
    integers read digit-by-digit (007 → 영영칠); a '.'/',' decimal reads
    whole + 점 + digitwise fraction (3.14 → 삼점일사); '-' prepends a
    마이너스 fragment.  None = not a numeral token."""
    raw = "".join(c for c in token.strip() if c != "_" and not c.isspace())
    # strip thousands commas (1,234 style groups of exactly 3 digits)
    raw = re.sub(r"(?<=\d),(?=\d{3}(\D|$))", "", raw)
    if not raw:
        return None
    sign = ""
    if raw[0] in "+-":
        sign, raw = raw[0], raw[1:]
    if not raw:
        return None
    dot = None
    for j, c in enumerate(raw):
        if c in ".,":
            dot = j
            break
        if not c.isdigit():
            return None
    frags: list[str] = []
    if dot is not None:
        whole, frac = raw[:dot], raw[dot + 1:]
        if not whole and not frac:
            return None
        if not frac.isdigit() and frac:
            return None
        if len(whole) > 1 and whole[0] == "0":
            return None
        body = (int_to_sino_korean_hangul(int(whole) if whole else 0)
                + "점" + ko_hangul_digits_only(frac))
    elif len(raw) > 1 and raw[0] == "0":
        body = ko_hangul_digits_only(raw)
    else:
        body = int_to_sino_korean_hangul(int(raw))
    if sign == "-":
        frags.append("마이너스")
    frags.append(body)
    return frags


def ko_sino_speech_units(n: int) -> list[str]:
    """Split n into natural speech units for mixed number+counter tokens
    (korean.cpp sino_cardinal_speech_units:550-576): 1986년 →
    천 / 구백 / 팔십육년."""
    if n == 0:
        return ["영"]
    if n >= 100000000:
        return [int_to_sino_korean_hangul(n)]
    units: list[str] = []
    if n >= 10000:
        man = n // 10000
        units.append(int_to_sino_korean_hangul(man * 10000))
        n %= 10000
        if n == 0:
            return units
    q, r = divmod(n, 1000)
    b, r2 = divmod(r, 100)
    if q:
        units.append(int_to_sino_korean_hangul(q * 1000))
    if b:
        units.append(int_to_sino_korean_hangul(b * 100))
    if r2:
        units.append(int_to_sino_korean_hangul(r2))
    return units


class HangulG2P:
    """Hangul → IPA mirroring the reference's korean.cpp rules path:
    jamo decomposition, coda→onset linking across ㅇ, ㄴ/ㄹ
    lateralization, per-syllable rendering with ㅎ-merger aspiration,
    post-obstruent tensification, post-sonorant allophony (ㅈ→dʑ, ㄱ→q,
    ㅂ→b), nasal-assimilated unreleased codas, and the Piper stress
    convention (ˈ before the first nucleus, ˌ on even syllables of 3+
    syllable words, glides precede the mark).  Numeral tokens expand
    through the sino-Korean readings (korean-numbers.cpp)."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _decompose(text: str) -> list[list[int]]:
        syls = []
        for ch in unicodedata.normalize("NFC", text):
            code = ord(ch)
            if 0xAC00 <= code <= 0xD7A3:
                idx = code - 0xAC00
                syls.append([idx // (21 * 28), (idx % (21 * 28)) // 28,
                             idx % 28])
        return syls

    @staticmethod
    def _link(syls: list[list[int]]) -> None:
        for i in range(len(syls) - 1):
            cur, nxt = syls[i], syls[i + 1]
            if cur[2] in (0, 21) or nxt[0] != 11:
                continue
            spec = _KO_LINK_SPLIT.get(cur[2])
            if spec is None:
                continue
            cur[2], nxt[0] = spec

    @staticmethod
    def _lateralize(syls: list[list[int]]) -> None:
        for i in range(len(syls) - 1):
            if syls[i][2] == 4 and syls[i + 1][0] == 5:
                syls[i][2] = 8
            if syls[i][2] == 8 and syls[i + 1][0] == 5:
                syls[i + 1][0] = 11

    @staticmethod
    def _render(syls: list[list[int]]) -> str:
        out = []
        n = len(syls)
        for i, (cho, jung, jong) in enumerate(syls):
            prev = syls[i - 1] if i > 0 else None
            nxt = syls[i + 1] if i + 1 < n else None
            onset = ""
            if cho != 11:
                after_h = prev is not None and prev[2] == 27 and cho in (
                    0, 3, 7, 12)
                tense_after = (prev is not None
                               and prev[2] in _KO_TENSE_TRIGGER
                               and cho in (0, 3, 7, 9, 12))
                if after_h:
                    onset = _KO_ASPIRATED[cho]
                elif tense_after:
                    onset = _KO_ONSET[_KO_LENIS_TO_TENSE.get(cho, cho)]
                elif prev is not None and (prev[2] == 0
                                           or prev[2] in _KO_TAIL_SONORANT):
                    onset = _KO_POST_SONORANT.get(cho, _KO_ONSET[cho])
                else:
                    onset = _KO_ONSET[cho]
            nucleus = _KO_VOWELS[jung]
            stress = ""
            if i == 0:
                stress = "ˈ"
            elif i % 2 == 0 and n >= 3:
                stress = "ˌ"
            coda = ""
            if jong != 0:
                h_lost = (nxt is not None and jong == 27
                          and nxt[0] in (0, 3, 7, 12))
                if h_lost:
                    coda = ""
                elif nxt is not None and nxt[0] in (2, 6):
                    coda = _ko_coda_nasal(jong, nxt[0])
                else:
                    coda = _ko_coda_simple(jong)
            if stress and nucleus[0] in "wj" and len(nucleus) > 1:
                out.append(onset + nucleus[0] + stress + nucleus[1:] + coda)
            else:
                out.append(onset + stress + nucleus + coda)
        return "".join(out)

    def hangul_to_ipa(self, hangul: str) -> str:
        syls = self._decompose(hangul)
        if not syls:
            return ""
        self._link(syls)
        self._lateralize(syls)
        return self._render(syls)

    @staticmethod
    def _extract_hangul(s: str) -> str:
        return "".join(ch for ch in s if 0xAC00 <= ord(ch) <= 0xD7A3)

    def word_to_ipa(self, word: str) -> str:
        w = unicodedata.normalize("NFC", word.strip())
        if not w:
            return ""
        if w in self.lexicon:
            return self.lexicon[w]
        # Numeral (and numeral+counter) tokens through the sino readings,
        # mirroring korean.cpp text_to_ipa:912-1001.
        m = re.match(r"^([+-]?\d[\d.,_]*)(.*)$", w)
        if m and not m.group(2):
            # Whole-token numeral: the fragment contract (leading zeros
            # digitwise, 점 decimals, 마이너스 sign).
            frags = ko_numeral_fragments(m.group(1))
            if frags is not None:
                return " ".join(
                    p for p in (self.hangul_to_ipa(f) for f in frags) if p)
        m = re.match(r"^(\d[\d,_]*)(.*)$", w)
        if m:
            digits = m.group(1).replace(",", "").replace("_", "")
            tail = self._extract_hangul(m.group(2))
            if digits.isdigit():
                if tail:
                    units = ko_sino_speech_units(int(digits))
                    units[-1] += tail
                    return " ".join(
                        p for p in (self.hangul_to_ipa(u) for u in units)
                        if p)
        h = self._extract_hangul(w)
        if not h:
            return ""
        if h in self.lexicon:
            return self.lexicon[h]
        return self.hangul_to_ipa(h)




def _ja_only_hiragana(s: str) -> bool:
    return bool(s) and all(0x3040 <= ord(c) <= 0x309F for c in s)


def _ja_only_katakana(s: str) -> bool:
    return bool(s) and all(c == "ー" or 0x30A0 <= ord(c) <= 0x30FF
                           for c in s)


def _ja_only_han(s: str) -> bool:
    def han(c):
        o = ord(c)
        return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
                or 0xF900 <= o <= 0xFAFF)
    return bool(s) and all(han(c) for c in s)


def _ja_is_single_han(s: str) -> bool:
    return len(s) == 1 and _ja_only_han(s)


# Trailing particles split off a lexicon-missed unit, longest first
# (japanese-onnx-g2p.cpp trailing_particles_sorted:178-193).
_JA_TRAILING_PARTICLES = sorted(
    ["について", "によって", "に対して", "では", "には", "から", "まで",
     "へは", "は", "を", "に", "で", "と", "が", "も", "か", "や", "へ"],
    key=len, reverse=True)


def ja_merge_for_lexicon_lookup(pairs):
    """The reference's three tagger-unit merges
    (japanese-onnx-g2p.cpp:85-172): adjacent single-han runs glue into
    one unit; a katakana NOUN/PROPN absorbs a following single-han
    NOUN/PROPN; a VERB/ADJ all-han unit absorbs trailing hiragana runs
    (okurigana)."""
    out = []
    i = 0
    while i < len(pairs):  # merge_single_han_luws
        surf, tag = pairs[i]
        if _ja_is_single_han(surf):
            j = i + 1
            acc = surf
            while j < len(pairs) and _ja_is_single_han(pairs[j][0]):
                acc += pairs[j][0]
                j += 1
            out.append((acc, tag))
            i = j
        else:
            out.append(pairs[i])
            i += 1
    pairs, out, i = out, [], 0
    while i < len(pairs):  # merge_katakana_plus_han
        surf, tag = pairs[i]
        if (_ja_only_katakana(surf) and tag in ("NOUN", "PROPN")
                and i + 1 < len(pairs)
                and _ja_is_single_han(pairs[i + 1][0])
                and pairs[i + 1][1] in ("NOUN", "PROPN")):
            out.append((surf + pairs[i + 1][0], tag))
            i += 2
        else:
            out.append(pairs[i])
            i += 1
    pairs, out, i = out, [], 0
    while i < len(pairs):  # merge_verb_adj_okurigana
        surf, tag = pairs[i]
        if _ja_only_han(surf) and tag in ("VERB", "ADJ"):
            j = i + 1
            acc = surf
            while j < len(pairs) and _ja_only_hiragana(pairs[j][0]):
                acc += pairs[j][0]
                j += 1
            out.append((acc, tag))
            i = j
        else:
            out.append(pairs[i])
            i += 1
    return out


def ja_script_run_annotator(text: str):
    """Deterministic script-run segmentation honoring the tagger
    contract: maximal same-script runs, han runs tagged NOUN (so the
    single-han merge glues compounds), everything else ADP.  Measured
    67.6% held-out word agreement vs the reference pipeline's golden —
    within 1.3 points of using the reference helper's own shipped
    annotations (68.9%), and far above the trained char tagger (38.6%;
    scripts/eval_ja_neural.py) — hence the production default."""
    out, cur, kind = [], [], None

    def k_of(c):
        o = ord(c)
        if 0x4E00 <= o <= 0x9FFF or c in "々〆ヶ":
            return "han"
        if c == "・":
            # Katakana middle dot (U+30FB) is a list separator, not a
            # word character: leaving it inside the kana block fused
            # constructions like ラジオ・テレビ… into one word (round-5
            # held-out diff: 79.7% -> 80.5% word agreement from this
            # one-character fix).
            return "other"
        if 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF or c in "ーっッ":
            return "kana"
        return "other"

    for c in text:
        k = k_of(c)
        if k != kind and cur:
            out.append(("".join(cur), "NOUN" if kind == "han" else "ADP"))
            cur = []
        kind = k
        cur.append(c)
    if cur:
        out.append(("".join(cur), "NOUN" if kind == "han" else "ADP"))
    return out


class JaLuwPipeline:
    """Exact replica of the reference's JapaneseOnnxG2p text flow
    (japanese-onnx-g2p.cpp:292-381): tagger (surface, UPOS) pairs →
    lexicon-lookup merges → per-unit G2P (lexicon exact hit, trailing-
    particle suffix split, kana conversion, greedy longest-lexicon-match
    per-char accumulation — silently dropping anything unreadable,
    digits included) → words joined by single spaces.

    ``annotate``: callable text -> [(surface, UPOS)] — our trained
    tok_pos tagger (tts/tok_pos.py), the reference helper's shipped
    annotations, or any other segmenter honoring the contract.
    ``lexicon``: surface → IPA (first-IPA column semantics).
    """

    def __init__(self, lexicon: dict[str, str], annotate,
                 char_table: dict[str, str] | None = None):
        self.lexicon = dict(lexicon)
        # per-kanji on'yomi KANA tier: consulted in the accumulate path
        # BEFORE single-char lexicon entries (whose kun readings are the
        # standalone-unit choice, wrong inside compounds: 国境 must be
        # こく+きょう→こっきょう, not くに…), kept as kana so runs
        # compose with sokuon gemination (ja_compose_onyomi).
        self.char_kana = dict(char_table or {})
        self.annotate = annotate
        by_first: dict[str, list[str]] = {}
        for w in self.lexicon:
            if w:
                by_first.setdefault(w[0], []).append(w)
        for v in by_first.values():
            v.sort(key=len, reverse=True)
        self._by_first = by_first

    def g2p_word(self, word: str) -> str:
        w = unicodedata.normalize("NFC", word.strip())
        if not w or not any(_ja_is_kanji(c) or self._is_kana(c)
                            for c in w):
            return ""
        hit = self.lexicon.get(w)
        if hit is not None:
            return hit
        for suf in _JA_TRAILING_PARTICLES:
            if len(w) > len(suf) and w.endswith(suf):
                base = self.g2p_word(w[:-len(suf)])
                sufr = self.g2p_word(suf)
                if base and sufr:
                    return base + sufr
                if base:
                    return base + (sufr or kana_to_ipa(suf))
                break
        if ja_is_kana_only(w):
            return kana_to_ipa(w)
        acc: list[str] = []
        pending: list[str] = []  # consecutive per-kanji on'yomi kana

        def flush():
            if pending:
                acc.append(kana_to_ipa(ja_compose_onyomi(pending)))
                pending.clear()

        i, n = 0, len(w)
        while i < n:
            found = False
            for cand in self._by_first.get(w[i], ()):
                # multi-char dict entries outrank everything; single-char
                # dict entries are standalone (kun) readings and yield to
                # the on'yomi tier inside compounds
                if len(cand) >= 2 and w.startswith(cand, i):
                    flush()
                    acc.append(self.lexicon[cand])
                    i += len(cand)
                    found = True
                    break
            if found:
                continue
            c = w[i]
            if c in self.char_kana:
                pending.append(self.char_kana[c])
                i += 1
                continue
            if c in self.lexicon:
                flush()
                acc.append(self.lexicon[c])
                i += 1
                continue
            if self._is_kana(c) or c in "ーっッ":
                # maximal kana run, converted as one string — per-char
                # conversion would split two-char morae (ファ) and lose
                # sokuon gemination
                flush()
                j = i
                while j < n and (self._is_kana(w[j]) or w[j] in "ーっッ"):
                    if j > i and any(
                            len(cc) >= 2 and w.startswith(cc, j)
                            for cc in self._by_first.get(w[j], ())):
                        break
                    j += 1
                acc.append(kana_to_ipa(w[i:j]))
                i = j
                continue
            flush()
            i += 1
        flush()
        return "".join(acc)

    @staticmethod
    def _is_kana(c: str) -> bool:
        o = ord(c)
        return 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF

    def text_to_ipa(self, text: str) -> str:
        raw = unicodedata.normalize("NFC", text.strip())
        if not raw:
            return ""
        pairs = ja_merge_for_lexicon_lookup(list(self.annotate(raw)))
        words = [self.g2p_word(s) for s, _ in pairs]
        return " ".join(p for p in words if p)


# Lexicalized readings the kana rules can't know (topic-particle は etc.).
_JA_LEXICON = {
    "こんにちは": "koɴɲitɕiwa",
    "こんばんは": "koɴbaɴwa",
}


# ---------------------------------------------------------------------------
# Chinese — toned pinyin + hanzi numbers (reference: chinese-numbers.cpp)
# ---------------------------------------------------------------------------

_ZH_INITIALS = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"), ("b", "p"), ("p", "pʰ"),
    ("m", "m"), ("f", "f"), ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"), ("j", "tɕ"), ("q", "tɕʰ"),
    ("x", "ɕ"), ("r", "ʐ"), ("z", "ts"), ("c", "tsʰ"), ("s", "s"),
    ("y", "j"), ("w", "w"),
]
_ZH_FINALS = [
    ("iang", "jaŋ"), ("iong", "jʊŋ"), ("uang", "waŋ"), ("ueng", "wəŋ"),
    ("ang", "aŋ"), ("eng", "əŋ"), ("ong", "ʊŋ"), ("ing", "iŋ"),
    ("iao", "jaʊ"), ("uai", "waɪ"), ("ian", "jɛn"), ("uan", "wan"),
    ("iu", "joʊ"), ("ui", "weɪ"), ("un", "wən"), ("ün", "yn"),
    ("ai", "aɪ"), ("ei", "eɪ"), ("ao", "aʊ"), ("ou", "oʊ"),
    ("an", "an"), ("en", "ən"), ("er", "ɚ"), ("ia", "ja"), ("ie", "jɛ"),
    ("ua", "wa"), ("uo", "wo"), ("üe", "yɛ"), ("ue", "yɛ"),
    ("a", "a"), ("o", "o"), ("e", "ɤ"), ("i", "i"), ("u", "u"), ("ü", "y"),
    ("v", "y"),
]
_ZH_TONES = {"1": "˥", "2": "˧˥", "3": "˨˩˦", "4": "˥˩", "5": "", "0": ""}

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_HANZI_IPA = {
    "零": "liŋ˧˥", "一": "i˥", "二": "ɚ˥˩", "三": "san˥", "四": "sɿ˥˩",
    "五": "u˨˩˦", "六": "ljoʊ˥˩", "七": "tɕʰi˥", "八": "pa˥", "九": "tɕjoʊ˨˩˦",
    "十": "ʂʐ̩˧˥", "百": "paɪ˨˩˦", "千": "tɕʰjɛn˥", "万": "wan˥˩",
    "亿": "i˥˩", "点": "tjɛn˨˩˦", "的": "tɤ", "是": "ʂʐ̩˥˩", "不": "pu˥˩",
    "我": "wo˨˩˦", "你": "ni˨˩˦", "他": "tʰa˥", "好": "xaʊ˨˩˦",
}

_TONE_MARKS = {
    "ā": ("a", "1"), "á": ("a", "2"), "ǎ": ("a", "3"), "à": ("a", "4"),
    "ē": ("e", "1"), "é": ("e", "2"), "ě": ("e", "3"), "è": ("e", "4"),
    "ī": ("i", "1"), "í": ("i", "2"), "ǐ": ("i", "3"), "ì": ("i", "4"),
    "ō": ("o", "1"), "ó": ("o", "2"), "ǒ": ("o", "3"), "ò": ("o", "4"),
    "ū": ("u", "1"), "ú": ("u", "2"), "ǔ": ("u", "3"), "ù": ("u", "4"),
    "ǖ": ("ü", "1"), "ǘ": ("ü", "2"), "ǚ": ("ü", "3"), "ǜ": ("ü", "4"),
}


def chinese_number_to_hanzi(digits: str) -> str:
    """Integer digit string → hanzi reading (reference:
    chinese-numbers.cpp semantics; supports up to 亿 blocks)."""
    n = int(digits)
    if n == 0:
        return "零"
    units = [(100000000, "亿"), (10000, "万"), (1000, "千"), (100, "百"), (10, "十")]

    def below_10000(x: int, leading: bool) -> str:
        out = ""
        need_zero = False
        for val, name in ((1000, "千"), (100, "百"), (10, "十")):
            d = x // val
            x %= val
            if d:
                if need_zero:
                    out += "零"
                    need_zero = False
                # 一十 -> 十 only at the very front of the whole number.
                drop_one = val == 10 and d == 1 and not out and leading
                out += ("" if drop_one else _ZH_DIGITS[d]) + name
            elif out:
                need_zero = True
        if x:
            if need_zero:
                out += "零"
            out += _ZH_DIGITS[x]
        return out

    out = ""
    for val, name in ((100000000, "亿"), (10000, "万")):
        d = n // val
        n %= val
        if d:
            out += below_10000(d, leading=not out) + name
    if n:
        if out and n < 1000:
            out += "零"
        out += below_10000(n, leading=not out)
    return out


def _zh_is_cjk(c: str) -> bool:
    o = ord(c)
    return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
            or 0xF900 <= o <= 0xFAFF)


def zh_numeral_to_hanzi(token: str) -> str | None:
    """ASCII/fullwidth numeral token → hanzi reading, mirroring
    chinese-numbers.cpp arabic_numeral_token_to_han(:170-282):
    thousands separators stripped, '-' → 负, decimals → whole + 点 +
    digitwise fraction, leading-zero integers digitwise.  None = not a
    numeral token."""
    tok = "".join(chr(ord(c) - 0xFF10 + ord("0"))
                  if "０" <= c <= "９" else c
                  for c in token.strip())
    tok = "".join(c for c in tok if c not in ",_ ")
    if not tok:
        return None
    neg = tok[0] == "-"
    if tok[0] in "+-":
        tok = tok[1:]
    if not tok:
        return None
    seps = [c for c in tok if c == "."]
    if len(seps) > 1:
        return None
    if "." in tok:
        whole, frac = tok.split(".", 1)
        whole = whole or "0"
        if not frac.isdigit() or not whole.isdigit():
            return None
        body = chinese_number_to_hanzi(whole) + "点" + "".join(
            _ZH_DIGITS[int(c)] for c in frac)
    elif len(tok) > 1 and tok[0] == "0":
        if not tok.isdigit():
            return None
        body = "".join(_ZH_DIGITS[int(c)] for c in tok)
    elif tok.isdigit():
        body = chinese_number_to_hanzi(tok)
    else:
        return None
    return ("负" if neg else "") + body


_ZH_AUTHORED_CACHE: dict[str, list[str]] | None = None


def zh_authored_lexicon() -> dict[str, list[str]]:
    """Hand-authored hanzi→IPA readings (tts/data/zh_pinyin.tsv,
    original data; toned pinyin converted through PinyinG2P's syllable
    rules).  '|'-separated alternatives become the reference's
    readings-vector semantics (first = default)."""
    global _ZH_AUTHORED_CACHE
    if _ZH_AUTHORED_CACHE is None:
        conv = PinyinG2P()
        out: dict[str, list[str]] = {}
        p = _ja_data_path("zh_pinyin.tsv")
        if p.is_file():
            for line in p.read_text(encoding="utf-8").splitlines():
                if not line.strip() or line.startswith("#"):
                    continue
                if "\t" not in line:
                    continue
                k, v = line.split("\t", 1)
                for alt in v.strip().split("|"):
                    ipa = conv.word_to_ipa(alt.strip())
                    if ipa:
                        out.setdefault(k, []).append(ipa)
        _ZH_AUTHORED_CACHE = out
    return _ZH_AUTHORED_CACHE


class ChineseHanziG2P:
    """Full-text hanzi G2P mirroring the reference's ChineseRuleG2p flow
    (chinese.cpp:497-546): tokens are whole CJK runs, signed decimal
    digit runs, or ASCII-alpha runs; each token goes dict exact hit
    (readings[0] without POS context) → per-char readings joined by
    spaces (han_reading_to_ipa:401-424) → arabic→han→per-char → ASCII
    lowercased; everything else is dropped.  The lexicon is the
    reference's ``word -> [readings]`` dict.tsv contract
    (load_chinese_lexicon_stream:191-211) — load a real CDN dict via
    ``from_dict_tsv`` or default to the authored table."""

    def __init__(self, lexicon: dict[str, list[str]] | None = None):
        self.lexicon = {k: list(v)
                        for k, v in (lexicon or zh_authored_lexicon()).items()}

    @classmethod
    def from_dict_tsv(cls, path) -> "ChineseHanziG2P":
        lex: dict[str, list[str]] = {}
        from pathlib import Path as _P

        for line in _P(path).read_text(encoding="utf-8").splitlines():
            t = line.strip()
            if not t or t.startswith("#") or "\t" not in t:
                continue
            k, v = t.split("\t", 1)
            lex.setdefault(k.strip(), []).append(v.strip())
        return cls(lex)

    def _readings0(self, key: str) -> str | None:
        r = self.lexicon.get(key)
        return r[0] if r else None

    def _han_reading_to_ipa(self, han: str) -> str:
        parts = []
        for c in han:
            r = self._readings0(c)
            if r is None or not r:
                return ""
            parts.append(r)
        return " ".join(parts)

    def g2p_word(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        hit = self._readings0(w)
        if hit:
            return hit
        if all(_zh_is_cjk(c) for c in w):
            fb = self._han_reading_to_ipa(w)
            if fb:
                return fb
            # The reference emits NOTHING when any char misses the dict
            # (han_reading_to_ipa:401-424 all-or-nothing).  Where it
            # would go silent we degrade gracefully instead: read the
            # covered chars, skip the rest — strictly more output,
            # parity unaffected (this branch only fires where the
            # reference's output is empty).
            parts = [r for r in (self._readings0(c) for c in w) if r]
            if parts:
                return " ".join(parts)
        han = zh_numeral_to_hanzi(w)
        if han:
            ipa = self._han_reading_to_ipa(han)
            if ipa:
                return ipa
        if w.isascii() and w.isalpha():
            return w.lower()
        return ""

    def text_to_ipa(self, text: str) -> str:
        out: list[str] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if _zh_is_cjk(c):
                j = i
                while j < n and _zh_is_cjk(text[j]):
                    j += 1
                ipa = self.g2p_word(text[i:j])
                if ipa:
                    out.append(ipa)
                i = j
                continue
            if c.isdigit() or (c in "+-" and i + 1 < n
                               and text[i + 1].isdigit()):
                # digit run; ONE '.'/',' followed by a digit extends it
                # as the decimal separator (try_consume_g2p_token
                # chinese.cpp:131-169)
                j = i + (1 if c in "+-" else 0)
                seen_dot = False
                while j < n:
                    if text[j].isdigit():
                        j += 1
                    elif (not seen_dot and text[j] in ".,"
                          and j + 1 < n and text[j + 1].isdigit()):
                        seen_dot = True
                        j += 1
                    else:
                        break
                ipa = self.g2p_word(text[i:j])
                if ipa:
                    out.append(ipa)
                i = j
                continue
            if c.isascii() and c.isalpha():
                j = i
                while j < n and text[j].isascii() and text[j].isalpha():
                    j += 1
                out.append(text[i:j].lower())
                i = j
                continue
            i += 1
        return " ".join(out)


class PinyinG2P:
    """zh engine: hanzi lexicon, toned pinyin syllables, digit expansion.

    Whole-text hanzi input flows through ``ChineseHanziG2P`` (the
    reference ChineseRuleG2p replica backed by the authored reading
    table); pinyin/latin input keeps the per-token syllable rules."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(_ZH_HANZI_IPA)
        self.lexicon.update(lexicon or {})
        self._hanzi: ChineseHanziG2P | None = None

    def text_to_ipa(self, text: str) -> str | None:
        """Full-text path for hanzi-bearing input; None = fall through
        to the per-token pinyin path."""
        if not any(_zh_is_cjk(c) for c in text):
            return None
        if self._hanzi is None:
            self._hanzi = ChineseHanziG2P()
        return self._hanzi.text_to_ipa(text)

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def _pinyin_syllable(self, syl: str, tone: str) -> str:
        out = ""
        rest = syl
        for p, ipa in _ZH_INITIALS:
            if rest.startswith(p):
                out += ipa
                rest = rest[len(p):]
                break
        while rest:
            for p, ipa in _ZH_FINALS:
                if rest.startswith(p):
                    out += ipa
                    rest = rest[len(p):]
                    break
            else:
                rest = rest[1:]
        return out + _ZH_TONES.get(tone, "")

    def word_to_ipa(self, word: str) -> str:
        w = word.lower()
        if w in self.lexicon:
            return self.lexicon[w]
        if w.isdigit():
            return self.word_to_ipa(chinese_number_to_hanzi(w))
        # Hanzi string: per-character lexicon.
        if all(0x4E00 <= ord(c) <= 0x9FFF for c in w):
            return "".join(self.lexicon.get(c, "") for c in w)
        # Toned pinyin: tone digits or diacritics.
        text, tones = _strip_pinyin_tones(w)
        if tones:  # diacritic form: segment syllables, distribute tones
            sylls = re.findall(
                r"(?:zh|ch|sh|[bpmfdtnlgkhjqxrzcsyw])?[aeiouü]+(?:ng|n(?![aeiouü])|r(?![aeiouü]))?",
                text,
            )
            return "".join(
                self._pinyin_syllable(s, t) for s, t in zip(sylls, tones)
            )
        res = []
        for s in re.findall(r"[a-zü]+[0-5]?", text):
            if s and s[-1].isdigit():
                res.append(self._pinyin_syllable(s[:-1], s[-1]))
            else:
                res.append(self._pinyin_syllable(s, "5"))
        return "".join(res)


def _strip_pinyin_tones(w: str) -> tuple[str, list[str]]:
    tones: list[str] = []
    out = []
    for ch in w:
        if ch in _TONE_MARKS:
            base, tone = _TONE_MARKS[ch]
            out.append(base)
            tones.append(tone)
        else:
            out.append(ch)
    return "".join(out), tones


# ---------------------------------------------------------------------------
# Cyrillic — Russian / Ukrainian
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Turkish — fully phonemic Latin orthography
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Dutch
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Vietnamese — full diacritic inventory, tones as IPA tone letters
# ---------------------------------------------------------------------------

# NFD tone mark -> tone id (1 = ngang, unmarked).
_VI_TONE_MARKS = {"̀": 2, "́": 5, "̃": 4, "̉": 3,
                  "̣": 6}
# Tone contours per the reference's tone_suffix_ipa
# (vietnamese.cpp:602-630): sắc (5) is ˦˥ only before an obstruent coda,
# ˨˦ otherwise; nặng (6) adds a final ʔ on open syllables and on labialized
# -ng codas.
_VI_TONE_SUFFIX = {1: "˧˧", 2: "˧˨", 3: "˧˩˨", 4: "˧ˀ˥", 6: "˨ˀ˩"}
_VI_SAC_OBSTRUENT = "˦˥"
_VI_SAC_OPEN = "˨˦"

# Onset digraphs -> IPA (longest-match; reference parse_onset
# vietnamese.cpp:173-289 — note ch/tr both -> c, d/r/gi -> z, kh -> x).
_VI_ONSET_SINGLE = {
    "b": "b", "c": "k", "k": "k", "d": "z", "h": "h", "l": "l", "m": "m",
    "n": "n", "p": "p", "r": "z", "s": "s", "t": "t", "v": "v", "x": "s",
    "g": "ɣ", "đ": "d",
}

# Nucleus multigraphs in match order (reference nucleus_to_ipa
# vietnamese.cpp:355-553).
_VI_NUCLEUS = [
    ("iêu", "iəw"), ("ươi", "ɯəj"), ("ươu", "ɯəw"), ("ươ", "ɯə"),
    ("iê", "iə"), ("yê", "iə"), ("uô", "uo"),
    ("oa", "wa"), ("oe", "wɛ"), ("uy", "wj"),
    ("ai", "aj"), ("ay", "aj"), ("ao", "aw"), ("au", "aw"),
    ("âu", "əw"), ("ây", "əj"),
    ("ơi", "ɤj"), ("ơu", "ɤw"),
    ("ưa", "ɯə"), ("ưi", "ɯj"), ("ưu", "ɯw"),
    ("ia", "iə"), ("iu", "iw"), ("êu", "ew"),
    ("ơ", "ɤ"), ("ư", "ɯ"), ("ô", "o"), ("â", "ɤ̆"), ("ă", "ɐ"),
    ("ê", "e"),
    ("e", "ɛ"), ("o", "ɔ"), ("a", "a"), ("i", "i"), ("u", "u"), ("y", "i"),
]

_VI_CODAS = ["ch", "nh", "ng", "c", "k", "m", "n", "p", "t"]
_VI_FRONT_VOWELS = set("ieêíìỉĩịéèẻẽẹếềểễệ")
_VI_A_PLAIN = set("aáàảãạ")
_VI_E_CIRC = set("êếềểễệ")


def _vi_split_tone(word: str) -> tuple[str, int]:
    nfd = unicodedata.normalize("NFD", word)
    tone = 1
    kept = []
    for ch in nfd:
        if ch in _VI_TONE_MARKS:
            tone = _VI_TONE_MARKS[ch]
        else:
            kept.append(ch)
    return unicodedata.normalize("NFC", "".join(kept)), tone


def _vi_parse_onset(body: str) -> tuple[str, str]:
    n = len(body)
    if n >= 4 and body.startswith("ngh") and body[3] in _VI_FRONT_VOWELS:
        return "ŋ", body[3:]
    if n >= 3 and body.startswith("ng") and body[2] in "aeiouyâăơôêưi":
        return "ŋ", body[2:]
    if n >= 3 and body.startswith("ch"):
        return "c", body[2:]
    if n >= 3 and body.startswith("gh") and body[2] in _VI_FRONT_VOWELS:
        return "ɣ", body[2:]
    if n >= 2 and body.startswith("gi"):
        if n == 2:
            return "ɣ", "i"
        rest = body[2:]
        if rest == "i":
            return "ɣ", rest
        return "z", rest
    if n >= 3 and body.startswith("qu"):
        return "kw", body[2:]
    if n >= 3 and body.startswith("tr"):
        return "c", body[2:]
    if n >= 3 and body.startswith("th"):
        return "tʰ", body[2:]
    if n >= 3 and body.startswith("ph"):
        return "f", body[2:]
    if n >= 3 and body.startswith("kh"):
        return "x", body[2:]
    if n >= 3 and body.startswith("nh"):
        return "ɲ", body[2:]
    if n >= 2 and body[0] == "đ":
        return "d", body[1:]
    if n >= 2 and body[0] in _VI_ONSET_SINGLE:
        return _VI_ONSET_SINGLE[body[0]], body[1:]
    return "", body


def _vi_nucleus_to_ipa(nuc: str) -> str:
    out = []
    rest = nuc
    while rest:
        for orth, ipa in _VI_NUCLEUS:
            if rest.startswith(orth):
                out.append(ipa)
                rest = rest[len(orth):]
                break
        else:
            rest = rest[1:]
    return "".join(out)


def _vi_wants_labial(nuc_ipa: str) -> bool:
    if not nuc_ipa or "ɯ" in nuc_ipa:
        return False
    return nuc_ipa.endswith(("o", "ɔ", "u", "w", "əw", "ow"))


def _vi_coda_simple(coda: str, nuc_ipa: str) -> str:
    lab = _vi_wants_labial(nuc_ipa)
    if coda == "nh":
        return "ŋ"
    if coda == "ch":
        return "k"
    if coda == "ng":
        return "ŋ͡m" if lab else "ŋ"
    if coda in ("c", "k"):
        return "k͡p" if lab else "k"
    return {"n": "n", "m": "m", "p": "p", "t": "t"}.get(coda, "")


class VietnameseG2P:
    """Syllable G2P mirroring the reference's vietnamese.cpp: tone split
    on the NFD form, longest-match onset/nucleus/coda, Chao tone-letter
    suffixes with the sắc/nặng allophony, labialized velar codas after
    rounded nuclei, ASCII-word passthrough (the reference's rules tier
    leaves undiacritized-ASCII tokens to the lexicon, vietnamese.cpp
    text_to_ipa:878-897)."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def syllable_to_ipa(self, syllable: str) -> str:
        raw = unicodedata.normalize("NFC", syllable.strip().lower())
        if not raw:
            return ""
        body, tone = _vi_split_tone(raw)
        onset, rime = _vi_parse_onset(body)
        if not rime:
            return ""
        coda = ""
        for cd in _VI_CODAS:
            if len(rime) > len(cd) and rime.endswith(cd):
                coda = cd
                rime = rime[: -len(cd)]
                break
        nuc_orth = rime
        nuc_ipa = _vi_nucleus_to_ipa(nuc_orth)
        if not nuc_ipa and not onset and not coda:
            return ""
        if not coda:
            rime_ipa = nuc_ipa
        elif coda == "nh" and nuc_orth[:1] in _VI_A_PLAIN:
            rime_ipa = "ɛŋ"
        elif coda == "nh" and nuc_orth[:1] in _VI_E_CIRC:
            rime_ipa = "eŋ"
        elif coda == "ch" and nuc_orth[:1] in _VI_A_PLAIN:
            rime_ipa = "ɛk"
        else:
            rime_ipa = nuc_ipa + _vi_coda_simple(coda, nuc_ipa)
        base = onset + rime_ipa
        if not base:
            return ""
        if tone == 5:
            suf = (_VI_SAC_OBSTRUENT if coda in ("ch", "c", "k", "p", "t")
                   else _VI_SAC_OPEN)
        else:
            suf = _VI_TONE_SUFFIX[tone]
        if tone == 6 and (not coda or (coda == "ng"
                                       and _vi_wants_labial(nuc_ipa))):
            return base + suf + "ʔ"
        return base + suf

    def word_to_ipa(self, word: str) -> str:
        w = unicodedata.normalize("NFC", word.strip())
        if not w:
            return ""
        lo = w.lower()
        if lo in self.lexicon:
            return self.lexicon[lo]
        if w in self.lexicon:
            return self.lexicon[w]
        if all(c.isascii() and (c.isalpha() or c in "-'") for c in w):
            return lo
        if "-" in w and not w.startswith("-"):
            subs = [self.word_to_ipa(p) for p in w.split("-") if p]
            return "-".join(s for s in subs if s)
        return self.syllable_to_ipa(w)


# ---------------------------------------------------------------------------
# Hindi — Devanagari with inherent schwa + final schwa deletion
# ---------------------------------------------------------------------------

# Consonant inventory matches the reference's hindi.cpp base_cons_map
# exactly (plain t/d, ascii g, ʰ aspiration throughout) so the two engines
# agree symbol-for-symbol (reference: lang-specific/hindi.cpp:72-93).
_HI_CONSONANTS = {
    "क": "k", "ख": "kʰ", "ग": "g", "घ": "gʰ", "ङ": "ŋ",
    "च": "tʃ", "छ": "tʃʰ", "ज": "dʒ", "झ": "dʒʰ", "ञ": "ɲ",
    "ट": "ʈ", "ठ": "ʈʰ", "ड": "ɖ", "ढ": "ɖʰ", "ण": "ɳ",
    "त": "t", "थ": "tʰ", "द": "d", "ध": "dʰ", "न": "n",
    "प": "p", "फ": "pʰ", "ब": "b", "भ": "bʰ", "म": "m",
    "य": "j", "र": "r", "ल": "l", "ळ": "ɭ", "व": "ʋ", "श": "ʃ",
    "ष": "ʂ", "स": "s", "ह": "ɦ",
}
_HI_NUKTA_OVERRIDE = {
    "क": "q", "ख": "x", "ग": "ɣ", "ज": "z", "ड": "ɽ", "ढ": "ɽʰ",
    "फ": "f",
}
_HI_VOWELS = {
    "अ": "ə", "आ": "aː", "इ": "ɪ", "ई": "iː", "उ": "ʊ", "ऊ": "uː",
    "ए": "eː", "ऐ": "ɛː", "ओ": "oː", "औ": "ɔː",
}
_HI_MATRAS = {
    "ा": "aː", "ि": "ɪ", "ी": "iː", "ु": "ʊ", "ू": "uː",
    "े": "eː", "ै": "ɛː", "ो": "oː", "ौ": "ɔː",
}
_HI_LONG = {"aː", "iː", "uː", "eː", "oː", "ɛː", "ɔː"}
_HI_VIRAMA = "्"
_HI_ANUSVARA = "ं"
_HI_CHANDRABINDU = "ँ"
_HI_VISARGA = "ः"
_HI_NUKTA = "़"


def _normalize_nukta_keys(d: dict[str, str]) -> dict[str, str]:
    """Index consonants under both precomposed and base+nukta forms."""
    out = dict(d)
    for k, v in list(d.items()):
        nfd = unicodedata.normalize("NFD", k)
        nfc = unicodedata.normalize("NFC", k)
        out[nfd] = v
        out[nfc] = v
    return out


def _hi_nasal_for_place(onset: str) -> str:
    """Place-assimilated anusvara nasal, matching the reference's
    nasal_for_place (hindi.cpp:116-153) decision order."""
    if not onset:
        return "ŋ"
    if onset.startswith(("tʃ", "dʒ")) or onset == "ɲ":
        return "ɲ"
    if onset.startswith(("k", "g")) or onset == "q":
        return "ŋ"
    if onset.startswith(("ʈ", "ɖ", "ɳ", "ɽ")):
        return "ɳ"
    if onset.startswith(("t", "d", "n")):
        return "n"
    if onset.startswith(("p", "b", "m")):
        return "m"
    return "n"


@dataclass
class _HiSyllable:
    onset: list[str] = field(default_factory=list)
    vowel: str | None = None  # None = halant-final (no nucleus)
    inherent_schwa: bool = False
    chandrabindu: bool = False
    anusvara: bool = False
    visarga: bool = False


class DevanagariG2P:
    """Syllable-based Devanagari G2P mirroring the reference's hindi.cpp
    behavior: virama-joined onset clusters, inherent-schwa syncope
    (word-final + medial before palatal onsets), place-assimilated
    anusvara, weight-based stress, ``.``-separated syllables
    (reference: lang-specific/hindi.cpp:201-422)."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def _parse(self, word: str) -> list[_HiSyllable]:
        chars = unicodedata.normalize("NFC", word)
        # Re-split any precomposed nukta consonants into base+nukta so one
        # code path handles both compositions.
        chars = unicodedata.normalize("NFD", chars)
        cps = [c for c in chars if c not in ("‌", "‍")]
        out: list[_HiSyllable] = []
        n = len(cps)
        i = 0
        while i < n:
            ch = cps[i]
            if ch in _HI_VOWELS:
                sy = _HiSyllable(vowel=_HI_VOWELS[ch])
                i += 1
                if i < n and cps[i] == _HI_CHANDRABINDU:
                    sy.chandrabindu = True
                    i += 1
                if i < n and cps[i] == _HI_ANUSVARA:
                    sy.anusvara = True
                    i += 1
                if i < n and cps[i] == _HI_VISARGA:
                    sy.visarga = True
                    i += 1
                out.append(sy)
                continue
            if ch not in _HI_CONSONANTS:
                i += 1
                continue
            onset: list[str] = []
            halant_end = False
            while i < n and cps[i] in _HI_CONSONANTS:
                base = cps[i]
                i += 1
                nukta = i < n and cps[i] == _HI_NUKTA
                if nukta:
                    i += 1
                if nukta and base in _HI_NUKTA_OVERRIDE:
                    onset.append(_HI_NUKTA_OVERRIDE[base])
                else:
                    onset.append(_HI_CONSONANTS[base])
                if i < n and cps[i] == _HI_VIRAMA:
                    i += 1
                    if i < n and cps[i] in _HI_CONSONANTS:
                        continue
                    halant_end = True
                    break
                break
            if halant_end:
                sy = _HiSyllable(onset=onset, vowel=None)
                if i < n and cps[i] == _HI_VISARGA:
                    sy.visarga = True
                    i += 1
                out.append(sy)
                continue
            vowel: str | None = None
            inherent = False
            if i < n and cps[i] in _HI_MATRAS:
                vowel = _HI_MATRAS[cps[i]]
                i += 1
            if vowel is None:
                vowel = "ə"
                inherent = True
            sy = _HiSyllable(onset=onset, vowel=vowel,
                             inherent_schwa=inherent)
            if i < n and cps[i] == _HI_CHANDRABINDU:
                sy.chandrabindu = True
                i += 1
            if i < n and cps[i] == _HI_ANUSVARA:
                sy.anusvara = True
                i += 1
            if i < n and cps[i] == _HI_VISARGA:
                sy.visarga = True
                i += 1
            out.append(sy)
        return out

    @staticmethod
    def _syncope(syls: list[_HiSyllable]) -> None:
        if len(syls) < 2:
            return
        last = syls[-1]
        if last.vowel == "ə" and last.inherent_schwa:
            last.vowel = ""
            last.inherent_schwa = False
        for a, b in zip(syls[:-1], syls[1:]):
            if a.vowel != "ə" or not a.inherent_schwa or not b.onset:
                continue
            bo = b.onset[0]
            if bo.startswith(("dʒ", "tʃ", "ʃ")) or bo == "ɲ":
                a.vowel = ""
                a.inherent_schwa = False

    def _render(self, syls: list[_HiSyllable], with_stress: bool = True) -> str:
        def one(j: int) -> str:
            s = syls[j]
            body = "".join(s.onset)
            if s.vowel is None:
                return body + ("ɦ" if s.visarga else "")
            v = s.vowel
            if s.chandrabindu and v:
                v += "̃"
            if s.anusvara:
                nxt = ""
                for k in range(j + 1, len(syls)):
                    if syls[k].onset:
                        nxt = syls[k].onset[0]
                        break
                if not nxt:
                    v += "̃"
                else:
                    body += _hi_nasal_for_place(nxt)
            body += v
            if s.visarga:
                body += "ɦ"
            return body

        raw: list[str] = []
        weights: list[int] = []
        for j, s in enumerate(syls):
            r = one(j)
            if r:
                raw.append(r)
                if s.vowel:
                    weights.append(2 if s.vowel in _HI_LONG else 1)
                else:
                    weights.append(0)
        if not raw:
            return ""
        if not with_stress or len(raw) == 1:
            return ".".join(raw)
        best_i, best_w = 0, -1
        for i, w in enumerate(weights):
            if w > best_w:
                best_i, best_w = i, w
        if best_w <= 0:
            best_i = len(raw) - 2 if len(raw) >= 2 else 0
        parts = [("ˈ" + r) if (i == best_i and best_w > 0) else r
                 for i, r in enumerate(raw)]
        return ".".join(parts)

    def word_to_ipa(self, word: str) -> str:
        if word in self.lexicon:
            return self.lexicon[word]
        syls = self._parse(word)
        if not syls:
            return ""
        self._syncope(syls)
        return self._render(syls)


# ---------------------------------------------------------------------------
# Arabic — abjad mapping (full vocalization needs the diacritizer ONNX)
# ---------------------------------------------------------------------------

# Consonant onsets, matching the reference's onset_ipa
# (lang-specific/arabic-ipa.cpp:203-271).  Long vowels / hamza carriers /
# ة are handled positionally in the cluster walk below.
_AR_ONSET = {
    "ء": "ʔ", "أ": "ʔ", "إ": "ʔ", "ؤ": "ʔ", "ئ": "ʔ", "آ": "ʔaː",
    "ب": "b", "ت": "t", "ث": "θ", "ج": "dʒ", "ح": "ħ", "خ": "x",
    "د": "d", "ذ": "ð", "ر": "r", "ز": "z", "س": "s", "ش": "ʃ",
    "ص": "sˤ", "ض": "dˤ", "ط": "tˤ", "ظ": "ðˤ", "ع": "ʕ", "غ": "ɣ",
    "ف": "f", "ق": "q", "ك": "k", "ل": "l", "م": "m", "ن": "n",
    "ه": "h", "و": "w", "ي": "j",
}

# Coronals that assimilate the definite article's lām (حروف شمسية).
_AR_SUN_LETTERS = frozenset("تثدذرزسشصضطظلن")

_AR_FATHA, _AR_DAMMA, _AR_KASRA = "َ", "ُ", "ِ"
_AR_FATHATAN, _AR_DAMMATAN, _AR_KASRATAN = "ً", "ٌ", "ٍ"
_AR_SUKUN, _AR_SHADDA, _AR_TATWEEL = "ْ", "ّ", "ـ"
_AR_VOWEL_MARKS = {_AR_FATHA, _AR_DAMMA, _AR_KASRA,
                   _AR_FATHATAN, _AR_DAMMATAN, _AR_KASRATAN, _AR_SUKUN}
# Letters that never take the default fatha
# (arabic-ipa.cpp apply_default_fatha_u32:171-176).
_AR_NO_FATHA = frozenset("اويىآة")


def _ar_is_combining(ch: str) -> bool:
    o = ord(ch)
    if 0x064B <= o <= 0x065F or o == 0x0670:
        return True
    return 0x0600 <= o <= 0x06FF and unicodedata.category(ch) == "Mn"


def _ar_is_base_letter(ch: str) -> bool:
    o = ord(ch)
    if 0x064B <= o <= 0x065F:
        return False
    return (0x0621 <= o <= 0x063A or 0x0641 <= o <= 0x064A
            or o in (0x671, 0x672, 0x673))


def _ar_clusters(s: str) -> list[tuple[str, str]]:
    """(base letter, trailing combining marks) pairs over NFC text."""
    s = unicodedata.normalize("NFC", s)
    out: list[tuple[str, str]] = []
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if _ar_is_combining(ch):
            if out:
                out[-1] = (out[-1][0], out[-1][1] + ch)
            i += 1
            continue
        if _ar_is_base_letter(ch) or (0x0600 <= ord(ch) <= 0x06FF
                                      and unicodedata.category(ch) == "Lo"):
            j = i + 1
            marks = []
            while j < n and _ar_is_combining(s[j]):
                marks.append(s[j])
                j += 1
            out.append((ch, "".join(marks)))
            i = j
            continue
        i += 1
    return out


def _ar_vowel_from_marks(marks: str) -> str:
    body = marks.replace(_AR_SHADDA, "")
    if _AR_FATHA in body:
        return "a"
    if _AR_DAMMA in body:
        return "u"
    if _AR_KASRA in body:
        return "i"
    if _AR_FATHATAN in body:
        return "an"
    if _AR_DAMMATAN in body:
        return "un"
    if _AR_KASRATAN in body:
        return "in"
    if _AR_SUKUN in marks:
        return ""
    if _AR_TATWEEL in marks:
        return "ː"
    return ""


def _ar_gem(onset: str) -> str:
    if not onset:
        return ""
    if onset.startswith("ʔ"):
        return onset
    return onset + onset


def strip_arabic_diacritics(s: str) -> str:
    return "".join(ch for ch in s if not _ar_is_combining(ch))


def apply_default_fatha(s: str) -> str:
    """Every unvocalized base consonant gains a fatha — the reference's
    "mouth-full" fallback for undiacritized MSA text
    (arabic-ipa.cpp:160-201)."""
    acc: list[str] = []
    for base, marks in _ar_clusters(unicodedata.normalize("NFC", s)):
        if not _ar_is_base_letter(base) or base in _AR_NO_FATHA:
            acc.append(base + marks)
            continue
        m2 = marks.replace(_AR_TATWEEL, "")
        has_vowel = any(m in _AR_VOWEL_MARKS for m in m2)
        if not has_vowel and _AR_SHADDA in m2:
            acc.append(base + m2)
        elif not has_vowel:
            acc.append(base + _AR_FATHA + m2)
        else:
            acc.append(base + m2)
    return unicodedata.normalize("NFC", "".join(acc))


def _ar_diac_word_to_ipa(word: str) -> str:
    parts: list[str] = []
    for base, marks in _ar_clusters(unicodedata.normalize("NFC", word)):
        if base in " ,;?!":
            continue
        if not _ar_is_base_letter(base) and unicodedata.category(base) != "Lo":
            continue
        v = _ar_vowel_from_marks(marks)
        sukun = _AR_SUKUN in marks
        shadda = _AR_SHADDA in marks
        onset = _AR_ONSET.get(base, "")
        if base == "ا" and not marks:
            if parts and parts[-1] in ("a", "i", "u"):
                parts[-1] += "ː"
            else:
                parts.append("aː")
            continue
        if base == "ى" and not marks:
            parts.append("aː")
            continue
        if base == "ة":
            parts.append("a" if (not sukun and not v) else "t")
            continue
        if base == "و":
            if v == "u":
                parts.append("uː")
            elif not marks:
                parts.append("w")
            else:
                parts.append("w" + v)
            continue
        if base == "ي":
            if v == "i":
                parts.append("iː")
            elif not marks:
                parts.append("j")
            else:
                parts.append("j" + v)
            continue
        if onset == "ʔaː":
            parts.append("ʔaː")
            continue
        if not onset and base == "ا":
            continue
        seg = _ar_gem(onset) if (shadda and onset) else onset
        if v:
            parts.append((seg + v) if seg else v)
        elif seg:
            parts.append(seg)
    return "".join(parts)


class ArabicG2P:
    """MSA G2P mirroring the reference's rules tier: default-fatha fill of
    unvocalized text, cluster walk with hamza/long-vowel/tāʾ-marbūṭa
    handling, sun-letter assimilation of the definite article
    (reference: lang-specific/arabic-ipa.cpp + arabic.cpp:158-211; the
    diacritizer ONNX tier refines vowels when its model is available)."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w or not any(0x0600 <= ord(c) <= 0x06FF for c in w):
            return ""
        key = strip_arabic_diacritics(unicodedata.normalize("NFC", w))
        if key in self.lexicon:
            return self.lexicon[key]
        if word in self.lexicon:
            return self.lexicon[word]
        filled = apply_default_fatha(w)
        bare = key
        if (len(bare) >= 3 and bare[0] == "ا" and bare[1] == "ل"
                and bare[2] in _AR_SUN_LETTERS):
            stem = unicodedata.normalize("NFC", filled)[2:]
            onset = _AR_ONSET.get(bare[2], "")
            stem_ipa = _ar_diac_word_to_ipa(stem)
            if onset and stem_ipa.startswith(onset):
                stem_ipa = stem_ipa[len(onset):]
            gem = _ar_gem(onset)
            return ("a" + gem + stem_ipa) if stem_ipa else ("a" + gem)
        return _ar_diac_word_to_ipa(filled)


# ---------------------------------------------------------------------------
# English heteronyms — context disambiguation
# ---------------------------------------------------------------------------

# word -> (default_ipa, alternate_ipa, alternate_cue_words_in_context)
# word -> (no-cue reading or None, cue-selected reading, cues).
# A ``None`` no-cue reading defers to the shipped dictionary — for every
# dict-present heteronym the reference's rules tier emits the dict entry
# (its ONNX heteronym disambiguator is a separate pipeline tier), so the
# bulk parity sweep pins these defaults to the dict; the cue-selected
# alternate is the OTHER sense, our contextual tier on top.
HETERONYMS: dict[str, tuple[str | None, str, frozenset[str]]] = {
    # not in the shipped dict -> the no-cue reading is ours to pick
    "read": ("ɹid", "ɹɛd", frozenset({"had", "has", "have", "was", "were", "already", "been", "yesterday", "i"})),
    "lead": ("lid", "lɛd", frozenset({"pencil", "pipe", "heavy", "metal", "poisoning"})),
    "live": ("lɪv", "laɪv", frozenset({"broadcast", "concert", "stream", "music", "show", "watch", "a", "the"})),
    "wind": ("wɪnd", "waɪnd", frozenset({"up", "down", "clock", "road", "to"})),
    "close": ("kloʊs", "kloʊz", frozenset({"door", "window", "eyes", "to", "please", "will", "would"})),
    # dict-present: no-cue falls through to the dict reading (left column
    # None); cues pick the other sense
    "tear": (None, "tɪɹ", frozenset({"eye", "eyes", "cry", "cried", "wept", "shed", "single"})),
    "bow": (None, "boʊ", frozenset({"arrow", "violin", "tie", "ribbon", "string"})),
    "record": (None, "ɹɪkɔɹd", frozenset({"to", "will", "can", "please", "button"})),
    "present": (None, "pɹɪzɛnt", frozenset({"to", "will", "may", "shall"})),
    "object": (None, "əbdʒɛkt", frozenset({"to", "i", "we", "they", "must", "strongly"})),
    "minute": (None, "mɪnɪt", frozenset({"a", "one", "per", "every", "last", "wait", "just"})),
    "desert": (None, "dɪzɝt", frozenset({"to", "will", "never", "army", "post"})),
    "produce": (None, "pɹoʊdus", frozenset({"fresh", "local", "organic", "farm", "aisle"})),
    "content": (None, "kɑntɛnt", frozenset({"the", "of", "table", "digital", "media"})),
    "refuse": (None, "ɹɛfjus", frozenset({"collection", "bin", "pile", "dump"})),
}


def resolve_heteronym(word: str, prev_word: str, next_word: str) -> str | None:
    """Context-sensitive pronunciation for known heteronyms, or None.

    Compact analog of the reference's per-heteronym context rules
    (reference: lang-specific english heteronym handling): the
    cue-selected reading fires when an adjacent word is one of its cues;
    otherwise the no-cue reading (None = let the dictionary decide, the
    reference rules-tier behavior for dict-present heteronyms).
    """
    entry = HETERONYMS.get(word.lower())
    if entry is None:
        return None
    default, alternate, cues = entry
    if prev_word.lower() in cues or next_word.lower() in cues:
        return alternate
    return default


# ---------------------------------------------------------------------------
# French liaison (reference: lang-specific french liaison handling)
# ---------------------------------------------------------------------------

# High-frequency French function words (lexicon: the rule engine cannot
# know silent-final irregulars like "est" /ɛ/ or "et" /e/).

# Mandatory-liaison triggers -> the consonant that surfaces before a
# vowel-initial word.  (Nasal triggers denasalize in careful speech; we
# keep the nasal vowel + /n/, the common colloquial realization.)
_FR_LIAISON: dict[str, str] = {
    "les": "z", "des": "z", "mes": "z", "tes": "z", "ses": "z", "nos": "z",
    "vos": "z", "leurs": "z", "aux": "z", "deux": "z", "trois": "z",
    "six": "z", "dix": "z", "nous": "z", "vous": "z", "ils": "z",
    "elles": "z", "sans": "z", "dans": "z", "chez": "z", "très": "z",
    "plus": "z", "tout": "t", "est": "t", "sont": "t", "quand": "t",
    "grand": "t", "petit": "t", "un": "n", "on": "n", "en": "n",
    "bien": "n", "rien": "n", "mon": "n", "ton": "n", "son": "n",
}

# "h aspiré" words block liaison/elision despite the silent h.
_FR_H_ASPIRE = frozenset({
    "haricot", "haricots", "héros", "honte", "hasard", "hache", "haine",
    "halle", "hamac", "hanche", "harpe", "hibou", "hockey", "hollande",
    "homard", "hongrie", "hoquet", "hurler",
})

_FR_VOWELS = "aeiouyàâæéèêëîïôœùûü"


# ---------------------------------------------------------------------------
# Portuguese — syllable-based engine mirroring the reference's
# portuguese-rules.cpp / portuguese.cpp (pt-BR and pt-PT dialects)
# ---------------------------------------------------------------------------

_PT_ACCENT_BASE = {"à": "a", "á": "a", "â": "a", "ã": "a", "é": "e",
                   "ê": "e", "í": "i", "ó": "o", "ô": "o", "õ": "o",
                   "ú": "u", "ü": "u", "ý": "y"}
_PT_VOWELS = set("aeiouàáâãéêíóôõúüý")
_PT_ACCENTED = set("áàâéêíóôú")
_PT_ONSET2 = {"bl", "br", "cl", "cr", "dr", "fl", "fr", "gl", "gr", "pl",
              "pr", "tr", "ch"}
_PT_ALLOWED = set("abcdefghijklmnopqrstuvwxyz-àáâãçéêíóôõúüý")

# Irregular whole-word IPA (portuguese-rules.cpp kXExc / sc_straddle).
_PT_X_EXC = {
    "táxi": "ˈtaksi", "taxi": "ˈtaksi", "máximo": "ˈmaksimu",
    "fênix": "ˈfɛniks", "fénix": "ˈfɛniks",
}
_PT_SC_STRADDLE = {
    "escola": "ɪskˈɔlɐ", "piscina": "piʃˈkinɐ", "descer": "dɪʃˈseɾ",
}
_PT_FINAL_S_EXCLUDE = {
    "anís", "bônus", "cais", "caos", "cosmos", "francês", "fénix",
    "inglês", "lápis", "mês", "país", "português", "três", "tórax",
    "vírus",
}

# Function words (portuguese-rules.cpp fw_br/fw_pt).
_PT_FW_BR = {
    "a": "ɐ", "o": "u", "os": "ʊs", "as": "ɐs", "e": "i", "ou": "ow",
    "em": "ɐ̃j̃", "no": "nʊ", "na": "nɐ", "nos": "nʊs", "nas": "nɐs",
    "de": "dʒɪ", "do": "dʊ", "da": "dɐ", "dos": "dʊs", "das": "dɐs",
    "dum": "dũ", "duma": "ˈdumɐ", "num": "nũ", "numa": "ˈnumɐ",
    "pelo": "ˈpɛlʊ", "pela": "ˈpɛlɐ", "pelos": "ˈpɛlʊs",
    "pelas": "ˈpɛlɐs", "com": "kõ", "sem": "sɐ̃j̃", "por": "poɾ",
    "para": "ˈpaɾɐ", "que": "ki", "não": "ˈnɐ̃w̃", "um": "ũ",
    "uma": "ˈumɐ", "uns": "ũs", "umas": "ˈumɐs", "ao": "aw",
    "aos": "awʃ", "à": "a", "às": "ɐʃ",
}
_PT_FW_PT = {
    "a": "ɐ", "o": "u", "os": "uʃ", "as": "ɐʃ", "e": "ɨ", "ou": "ow",
    "em": "ɐ̃j̃", "no": "nu", "na": "nɐ", "nos": "nuʃ", "nas": "nɐʃ",
    "de": "dɨ", "do": "du", "da": "dɐ", "dos": "duʃ", "das": "dɐʃ",
    "dum": "dũ", "duma": "ˈdumɐ", "num": "nũ", "numa": "ˈnumɐ",
    "pelo": "ˈpɛlu", "pela": "ˈpɛlɐ", "pelos": "ˈpɛluʃ",
    "pelas": "ˈpɛlɐʃ", "com": "kõ", "sem": "sɐ̃j̃", "por": "puɾ",
    "para": "ˈpɐɾɐ", "que": "kɨ", "não": "ˈnɐ̃w̃", "um": "ũ",
    "uma": "ˈumɐ", "uns": "ũʃ", "umas": "ˈumɐʃ", "ao": "aw",
    "aos": "awʃ", "à": "a", "às": "aʃ",
}

# Roman-numeral cardinals (portuguese-rules.cpp kCard; generated data).
_PT_ROMAN_CARD = {
    1: "ˈũ", 2: "ˈdɔjs", 3: "ˈtɾɛjs", 4: "ˈkwatɾʊ", 5: "ˈsĩkʊ",
    6: "ˈsejs", 7: "ˈsɛtʃi", 8: "ˈɔjtʊ", 9: "ˈnɔvi", 10: "ˈdɛjs",
    11: "ˈɔ̃zi", 12: "ˈdɔzi", 13: "ˈtɾɛzi", 14: "kaɪˈɔɾzi", 15: "ˈkĩzi",
    16: "dɛˈzesejs", 17: "dɛˈzesɛtʃi", 18: "dɛˈzejzj", 19: "dɛzenˈɔvi",
    20: "ˈvĩtʃi", 21: "vĩˈtʃiˈeũ", 30: "ˈtɾĩtʃi", 40: "kwɐˈɾẽtɐ",
    50: "ˈsĩkwẽtɐ", 60: "ˈsessẽtʃi", 70: "sɛˈtẽtʃi", 80: "ˈojtẽtʃi",
    90: "ˈnɔvẽtʃi", 100: "ˈsẽtʃi",
}

# Number words (portuguese.cpp:109-250).
_PT_DIG = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
           "sete", "oito", "nove"]
_PT_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta",
            "sessenta", "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = ["", "", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]
_PT_TEENS_BR = {11: "onze", 12: "doze", 13: "treze", 14: "catorze",
                15: "quinze", 16: "dezesseis", 17: "dezessete",
                18: "dezoito", 19: "dezenove"}
_PT_TEENS_PT = {**_PT_TEENS_BR, 16: "dezasseis", 17: "dezassete",
                19: "dezanove"}

# IPA nucleus prefixes for the vocoder stress move (german.cpp:389-402,
# shared across the Latin engines).
_IPA_NUCLEI = [
    "aɪ̯", "aʊ̯", "ɔʏ̯", "ɛɪ̯", "iː", "eː", "aː", "oː", "uː", "yː",
    "øː", "ŋ̩", "n̩", "m̩", "l̩", "r̩", "ə", "ɛ", "ɜ", "ɪ",
    "ʊ", "ɐ̯", "ɐ", "ɨ", "ɵ", "ø", "œ", "ʏ", "y", "ɔ",
    "ɑ", "æ", "a", "i", "e", "o", "u",
]
_IPA_PRE_NUCLEUS_UNITS = ["t͡s", "p͡f", "d͡ʒ", "t͡ʃ", "tʃ", "ts"]


def move_stress_to_nucleus(ipa: str) -> str:
    """Move each ˈ/ˌ forward past pre-nucleus consonants so it sits
    directly before the syllable nucleus (the reference's vocoder stress
    convention, german.cpp normalize_ipa_stress_for_vocoder)."""
    if "ˈ" not in ipa and "ˌ" not in ipa:
        return ipa
    out = []
    i = 0
    n = len(ipa)
    while i < n:
        ch = ipa[i]
        if ch not in "ˈˌ":
            out.append(ch)
            i += 1
            continue
        mark = ch
        j = i + 1
        while j < n and ipa[j] not in "ˈˌ":
            rest = ipa[j:]
            if any(rest.startswith(p) for p in _IPA_NUCLEI):
                break
            for u in _IPA_PRE_NUCLEUS_UNITS:
                if rest.startswith(u):
                    j += len(u)
                    break
            else:
                j += 1
        out.append(ipa[i + 1:j])
        out.append(mark)
        i = j
    return "".join(out)


def _pt_under_100(n: int, is_pt: bool) -> list[str]:
    if n < 10:
        return [_PT_DIG[n]]
    if n == 10:
        return ["dez"]
    if n < 20:
        return [(_PT_TEENS_PT if is_pt else _PT_TEENS_BR)[n]]
    t, u = divmod(n, 10)
    if u == 0:
        return [_PT_TENS[t]]
    return [_PT_TENS[t], "e", _PT_DIG[u]]


def _pt_below_1000(n: int, is_pt: bool) -> list[str]:
    if n < 100:
        return _pt_under_100(n, is_pt)
    h, r = divmod(n, 100)
    if h == 1:
        if r == 0:
            return ["cem"]
        return ["cento", "e"] + _pt_under_100(r, is_pt)
    out = [_PT_HUNDREDS[h]]
    if r:
        out += ["e"] + _pt_under_100(r, is_pt)
    return out


def pt_cardinal_words(s: str, is_pt: bool) -> str:
    """Digit string -> Portuguese words (portuguese.cpp:252-287)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_PT_DIG[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "zero"
    if n < 1000:
        return " ".join(_pt_below_1000(n, is_pt))
    q, r = divmod(n, 1000)
    parts = (["mil"] if q == 1 else _pt_below_1000(q, is_pt) + ["mil"])
    if r:
        parts += ["e"] + _pt_below_1000(r, is_pt)
    return " ".join(parts)


def _pt_roman_to_int(s: str) -> int | None:
    s = s.upper()
    vals = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
    if not s or any(c not in vals for c in s):
        return None
    total, i = 0, 0
    while i < len(s):
        v = vals[s[i]]
        if i + 1 < len(s) and vals[s[i + 1]] > v:
            total += vals[s[i + 1]] - v
            i += 2
        else:
            total += v
            i += 1
    return total if 0 < total < 4000 else None


def _pt_lower(s: str) -> str:
    return s.lower()


def _pt_is_vowel(c: str) -> bool:
    return c in _PT_VOWELS


def _pt_should_hiatus(a: str, b: str) -> bool:
    al, bl = a.lower(), b.lower()
    if al in "íúý" or bl in "íúý":
        return True
    ba = _PT_ACCENT_BASE.get(al, al)
    bb = _PT_ACCENT_BASE.get(bl, bl)
    if ba == bb:
        return True
    if al in "ãõ" or bl in "ãõ":
        return (ba in "aeo") and (bb in "aeo")
    sa, sb = ba in "aeo", bb in "aeo"
    if sa and sb:
        if al in "áéóâêô" or bl in "áéóâêô":
            return True
        if (ba, bb) in (("a", "e"), ("e", "a")):
            return False
        return True
    return False


def _pt_nucleus_spans(w: str) -> list[tuple[int, int]]:
    out = []
    i, n = 0, len(w)
    while i < n:
        if not _pt_is_vowel(w[i]):
            i += 1
            continue
        if w[i] == "ã" and i + 1 < n and w[i + 1] in "oe":
            out.append((i, i + 2))
            i += 2
            continue
        if i + 1 < n and _pt_is_vowel(w[i + 1]):
            if _pt_should_hiatus(w[i], w[i + 1]):
                out.append((i, i + 1))
                i += 1
            else:
                out.append((i, i + 2))
                i += 2
        else:
            out.append((i, i + 1))
            i += 1
    return out


def _pt_split_cluster(cluster: str) -> tuple[str, str]:
    if not cluster:
        return "", ""
    if cluster == "rr":
        return "", "rr"
    n = len(cluster)
    if n >= 2 and cluster[-2:] in ("lh", "nh"):
        return cluster[:-2], cluster[-2:]
    if n >= 2 and cluster[-2:] in _PT_ONSET2:
        return cluster[:-2], cluster[-2:]
    return cluster[:-1], cluster[-1:]


def pt_syllables(w: str) -> list[str]:
    if not w:
        return []
    if "-" in w:
        out = []
        for chunk in w.split("-"):
            if chunk:
                out.extend(pt_syllables(chunk))
        return out
    spans = _pt_nucleus_spans(w)
    if not spans:
        return [w]
    syls = []
    cur = w[: spans[0][0]]
    for idx, (s, e) in enumerate(spans):
        cur += w[s:e]
        if idx + 1 < len(spans):
            cluster = w[e: spans[idx + 1][0]]
            coda, onset = _pt_split_cluster(cluster)
            syls.append(cur + coda)
            cur = onset
        else:
            syls.append(cur + w[e:])
    return [s for s in syls if s]


def _pt_stress_index(syls: list[str], w: str) -> int:
    if not syls:
        return 0
    for i, s in enumerate(syls):
        if any(c in _PT_ACCENTED for c in s):
            return i
    n = len(syls)
    if n == 1:
        return 0
    if w.endswith(("ões", "ãos", "ão", "ã", "ãs")):
        return n - 1
    if not w:
        return 0
    last = w[-1]
    if last == "s" and len(w) >= 2 and w[-2] in "aeiouáéíóúãõâêô":
        return n - 2 if n >= 2 else 0
    if last in "aeoáéó":
        return n - 2 if n >= 2 else 0
    if w.endswith(("em", "ens", "am")):
        return n - 2 if n >= 2 else 0
    if last in "iuíú":
        return n - 1
    if last in "rlzx":
        return n - 1
    if last == "n" and not w.endswith("em"):
        return n - 1
    return n - 2 if n >= 2 else 0


_PT_IPA_VOWEL_SET = set("aeiouɛɔɐɪʊɨəæ")


def _pt_insert_stress(ipa: str) -> str:
    ipa = ipa.replace("ˈ", "").replace("ˌ", "")
    for i, ch in enumerate(ipa):
        if ch in _PT_IPA_VOWEL_SET:
            return ipa[:i] + "ˈ" + ipa[i:]
    # vowelless: the reference parks the mark at the end (coda-only)
    return ipa + "ˈ"


def _pt_prev_global_vowel(w: str, gidx: int) -> bool:
    if gidx == 0:
        return False
    j = gidx - 1
    while True:
        if _pt_is_vowel(w[j]):
            return True
        if w[j] == "-" or j == 0:
            return False
        j -= 1


def _pt_next_global_vowel(w: str, gidx: int) -> bool:
    j = gidx + 1
    while j < len(w):
        if _pt_is_vowel(w[j]):
            return True
        if w[j] == "-":
            return False
        j += 1
    return False


def _pt_syllable_ipa(s: str, is_pt: bool, full_word: str, span_start: int,
                     stressed: bool) -> str:
    def unstressed_vowel(base: str) -> str:
        if stressed:
            return base
        if is_pt:
            return {"a": "ɐ", "e": "ɨ", "i": "i", "o": "u", "u": "u"}.get(
                base, base)
        return {"a": "ɐ", "e": "ɪ", "i": "i", "o": "ʊ", "u": "u"}.get(
            base, base)

    def map_vowel(ch: str) -> str:
        cl = ch.lower()
        if cl in "àáâ":
            return "a"
        if cl in "éê":
            return "ɛ"
        if cl == "í":
            return "i"
        if cl in "óô":
            return "ɔ"
        if cl == "ú":
            return "u"
        if cl == "ã":
            return "ɐ̃"
        if cl == "õ":
            return "õ"
        if cl == "a":
            return "a" if stressed else unstressed_vowel("a")
        if cl == "e":
            if stressed and "ê" in s:
                return "ɛ"
            return "e" if stressed else unstressed_vowel("e")
        if cl == "i":
            return unstressed_vowel("i")
        if cl == "o":
            if stressed and "ô" in s:
                return "ɔ"
            return "o" if stressed else unstressed_vowel("o")
        if cl == "u":
            return unstressed_vowel("u")
        if cl == "ü":
            return "w"
        if cl in "ýy":
            return "i"
        return ""

    n = len(s)
    i = 0
    out = []
    while i < n:
        if s[i] == "-":
            i += 1
            continue
        gi = span_start + i
        if s[i] == "ã" and i + 1 < n and s[i + 1] == "o":
            out.append("ɐ̃w̃")
            i += 2
            continue
        if s[i] == "ã" and i + 1 < n and s[i + 1] == "e":
            out.append("ɐ̃j̃")
            i += 2
            continue
        two = s[i:i + 2]
        if two == "ch":
            out.append("ʃ")
            i += 2
            continue
        if two == "nh":
            out.append("ɲ")
            i += 2
            continue
        if two == "lh":
            out.append("ʎ")
            i += 2
            continue
        if two == "rr":
            out.append("ʁ")
            i += 2
            continue
        if two == "qu" and i + 2 < n and s[i + 2].lower() in "eéêií":
            out.append("k")
            i += 2
            continue
        if two == "gu" and i + 2 < n and s[i + 2].lower() in "eéêií":
            out.append("ɡ")
            i += 2
            continue
        if two == "qu":
            out.append("kw")
            i += 2
            continue
        if two == "ss":
            out.append("s")
            i += 2
            continue
        if s[i] == "ç":
            out.append("s")
            i += 1
            continue
        if s[i] == "c" and i > 0 and s[i - 1] == "s" and i + 1 < n:
            v = s[i + 1].lower()
            if v in "aáâeéêiíoóôuúãõ":
                out.append("ʃ" if v in "eéêií" else "sk")
                i += 1
                continue
        if s[i] == "c" and i + 1 < n and s[i + 1].lower() in "eéêií":
            out.append("s")
            i += 1
            continue
        if s[i] == "c":
            out.append("k")
            i += 1
            continue
        if s[i] == "g" and i + 1 < n and s[i + 1].lower() in "eéêií":
            out.append("ʒ")
            i += 1
            continue
        if s[i] == "g":
            out.append("ɡ")
            i += 1
            continue
        if s[i] == "x":
            if gi == 0 and i + 1 < n and s[i + 1].lower() in "eéií":
                out.append("ʒ")
                i += 2
                continue
            pv = _pt_prev_global_vowel(full_word, gi)
            nv = _pt_next_global_vowel(full_word, gi + 1)
            out.append(("ʃ" if is_pt else "ʒ") if (pv and nv) else "ks")
            i += 1
            continue
        if s[i] == "h":
            i += 1
            continue
        if s[i] == "s":
            pv = gi > 0 and _pt_prev_global_vowel(full_word, gi - 1)
            nv = i + 1 < n and _pt_next_global_vowel(full_word, gi + 1)
            out.append(("ʒ" if is_pt else "z") if (pv and nv) else "s")
            i += 1
            continue
        if s[i] == "z":
            out.append("z")
            i += 1
            continue
        if s[i] == "j":
            out.append("ʒ")
            i += 1
            continue
        if s[i] in "wW":
            out.append("w")
            i += 1
            continue
        if s[i] == "r":
            at_word = gi == 0
            prev_ch = full_word[gi - 1] if gi > 0 else ""
            after_cons = (gi > 0 and not _pt_is_vowel(prev_ch)
                          and prev_ch != "'")
            if at_word or after_cons or (i + 1 < n and s[i + 1] == "r"):
                out.append("ʁ")
            else:
                out.append("ɾ")
            i += 1
            continue
        ch = s[i]
        if _pt_is_vowel(ch):
            if (i + 1 < n and _pt_is_vowel(s[i + 1])
                    and not _pt_should_hiatus(ch, s[i + 1])):
                a = ch.lower()
                b = s[i + 1].lower()
                pair = None
                if a in "aàáâ" and b in "ií":
                    pair = "aj"
                elif a in "aàáâ" and b in "uú":
                    pair = "aw"
                elif a in "eéê" and b in "ií":
                    pair = "ej"
                elif a in "oóô" and b in "ií":
                    pair = "oj"
                elif a in "eéê" and b in "uú":
                    pair = "ew"
                elif a in "oóô" and b in "uú":
                    pair = "ow"
                if pair:
                    out.append(pair)
                    i += 2
                    continue
            seg = map_vowel(ch)
            if seg:
                out.append(seg)
            i += 1
            continue
        cl = ch.lower()
        if cl in "bdflmnptvk":
            out.append(cl)
        i += 1
    return "".join(out)


def _pt_rules_word_single(wl: str, is_pt: bool, with_stress: bool = True) -> str:
    syls = pt_syllables(wl)
    if not syls:
        return ""
    stress_idx = _pt_stress_index(syls, wl) if with_stress else -1
    offset = 0
    parts = []
    for idx, sy in enumerate(syls):
        chunk = _pt_syllable_ipa(sy, is_pt, wl, offset,
                                 with_stress and idx == stress_idx)
        if with_stress and idx == stress_idx and chunk:
            chunk = _pt_insert_stress(chunk)
        parts.append(chunk)
        offset += len(sy)
    return "".join(parts)


def _pt_final_s_to_esh(ipa: str, key: str) -> str:
    """pt-PT plural-final s -> esh (portuguese-rules.cpp:1026-1069)."""
    if not ipa or len(key) < 4 or not key.endswith("s"):
        return ipa
    if key.endswith("ss") or key in _PT_FINAL_S_EXCLUDE:
        return ipa
    if key.endswith(("ês", "ás", "ís", "ús")):
        return ipa
    if not key.endswith(("as", "os", "es")):
        return ipa
    if key[-2] not in "aeiouàáâãéêíóôõúü":
        return ipa
    if not ipa.endswith("s"):
        return ipa
    return ipa[:-1] + "ʃ"


class PortugueseG2P:
    """pt-BR / pt-PT G2P mirroring the reference's rules engine:
    orthographic syllabification, accent/termination stress with the
    stress mark on the nucleus, vowel reduction per dialect, function-
    word forms, digit expansion with the reference's wording
    ("mil e oitocentos"), Roman-numeral cardinals, and the pt-PT plural
    final-s -> esh pass (portuguese-rules.cpp + portuguese.cpp)."""

    def __init__(self, is_portugal: bool = False,
                 lexicon: dict[str, str] | None = None):
        self.is_portugal = is_portugal
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _key(word: str) -> str:
        out = []
        for ch in word:
            if ch == "’":
                ch = "'"
            cl = ch.lower()
            if cl in _PT_ALLOWED or cl == "'":
                out.append(cl)
        return "".join(out)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = pt_cardinal_words(w, self.is_portugal)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        key = self._key(w)
        if not key:
            return ""
        if "-" not in key and "'" not in key:
            rn = _pt_roman_to_int(key)
            if rn is not None and rn in _PT_ROMAN_CARD:
                ipa = _PT_ROMAN_CARD[rn]
                if self.is_portugal:
                    ipa = ipa.replace("ˈvĩtʃi", "ˈvĩtʃɨ")
                return ipa
        if key in self.lexicon:
            return self.lexicon[key]
        if key in _PT_X_EXC:
            return _PT_X_EXC[key]
        if key in _PT_SC_STRADDLE:
            return _PT_SC_STRADDLE[key]
        fw = _PT_FW_PT if self.is_portugal else _PT_FW_BR
        if key in fw:
            return move_stress_to_nucleus(fw[key])
        wl = "".join(c for c in key if c in _PT_ALLOWED)
        if "-" in wl:
            chunks = [c for c in wl.split("-") if c]
            if len(chunks) > 1:
                ipa = "-".join(
                    _pt_rules_word_single(c, self.is_portugal)
                    for c in chunks)
            else:
                ipa = _pt_rules_word_single(chunks[0] if chunks else "",
                                            self.is_portugal)
        else:
            ipa = _pt_rules_word_single(wl, self.is_portugal)
        if self.is_portugal and key not in _PT_SC_STRADDLE:
            ipa = _pt_final_s_to_esh(ipa, key)
        return ipa


# ---------------------------------------------------------------------------
# Russian — engine mirroring the reference's russian.cpp (palatalization,
# stress-relative vowel reduction, piper-style normalization, numbers)
# ---------------------------------------------------------------------------

_RU_VOWEL_LETTERS = set("аеёиоуыэюя")
_RU_PALATALIZABLE = set("бвгдзклмнпрстфх")
_RU_CONS_IPA = {
    "ш": "ʂ", "ч": "tɕ", "щ": "ɕː", "ц": "ts", "ж": "ʐ", "б": "b",
    "в": "v", "г": "ɡ", "д": "d", "з": "z", "й": "j", "к": "k", "л": "l",
    "м": "m", "н": "n", "п": "p", "р": "r", "с": "s", "т": "t", "ф": "f",
    "х": "x",
}
_RU_SOFTENING_VOWELS = set("еёиюя")
_RU_IPA_VOWEL_CPS = set("aeiouɛəɨɪʊøɵ")

_RU_ONES_M = ["", "один", "два", "три", "четыре", "пять", "шесть",
              "семь", "восемь", "девять"]
_RU_TEENS = ["десять", "одиннадцать", "двенадцать", "тринадцать",
             "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать",
             "восемнадцать", "девятнадцать"]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят",
            "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def ru_cardinal_words(s: str) -> str:
    """Digit string -> Russian words (russian-numbers.cpp)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join("ноль" if c == "0" else _RU_ONES_M[int(c)]
                        for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "ноль"

    def under_100(n, fem):
        if n < 10:
            if fem and n == 1:
                return ["одна"]
            if fem and n == 2:
                return ["две"]
            return [_RU_ONES_M[n]]
        if n < 20:
            return [_RU_TEENS[n - 10]]
        t, u = divmod(n, 10)
        out = [_RU_TENS[t]]
        if u:
            out += under_100(u, fem)
        return out

    def to_999(n, fem):
        if n < 100:
            return under_100(n, fem)
        h, r = divmod(n, 100)
        out = [_RU_HUNDREDS[h]]
        if r:
            out += under_100(r, fem)
        return out

    if n < 1000:
        parts = to_999(n, False)
    else:
        q, r = divmod(n, 1000)
        parts = to_999(q, True)
        m100 = q % 100
        k = q % 10
        if 11 <= m100 <= 14:
            parts.append("тысяч")
        elif k == 1:
            parts.append("тысяча")
        elif 2 <= k <= 4:
            parts.append("тысячи")
        else:
            parts.append("тысяч")
        if r:
            parts += to_999(r, False)
    return " ".join(parts)


def _ru_syllable_per_cp(w: str) -> list[int]:
    """Syllable index per codepoint: each syllable ends right after its
    vowel, consonants between vowels open the FOLLOWING syllable, and
    trailing consonants stay in the last syllable (russian.cpp
    russian_orthographic_syllables_utf8)."""
    n_vowels = sum(1 for ch in w if ch in _RU_VOWEL_LETTERS)
    out = [0] * len(w)
    syl = 0
    vi = 0
    for i, ch in enumerate(w):
        out[i] = syl
        if ch in _RU_VOWEL_LETTERS:
            vi += 1
            if vi < n_vowels:
                syl += 1
    return out


def _ru_stress_syllable(w: str, acute_ord: int | None) -> int:
    """ё wins; else the combining-acute vowel ordinal; else syllable 0."""
    sylmap = _ru_syllable_per_cp(w)
    for i, ch in enumerate(w):
        if ch == "ё":
            return sylmap[i]
    if acute_ord is not None:
        v = 0
        for i, ch in enumerate(w):
            if ch in _RU_VOWEL_LETTERS:
                if v == acute_ord:
                    return sylmap[i]
                v += 1
    return 0


def _ru_vowel_ipa(ch: str, stressed: bool, after_palatal: bool,
                  after_hard: bool, jot: bool) -> str:
    if ch == "а":
        return "a" if stressed else "ə"
    if ch == "о":
        return "o" if stressed else "ə"
    if ch == "у":
        return "u"
    if ch == "ы":
        return "ɨ"
    if ch == "э":
        return "ɛ"
    if ch == "и":
        return "i" if stressed else "ɪ"
    if ch == "ё":
        return "o" if stressed else "ə"
    if ch == "е":
        if jot:
            return "e"
        if after_palatal:
            return "e" if stressed else "ɪ"
        if after_hard:
            return "ɛ" if stressed else "ɪ"
        return "je" if stressed else "jɪ"
    if ch == "ю":
        if jot or after_palatal:
            return "u"
        return "u" if stressed else "ʊ"
    if ch == "я":
        if jot or after_palatal or after_hard:
            return "a" if stressed else "ə"
        return "a" if stressed else "jə"
    return ""


def _ru_letters_to_ipa(w: str, stress_syl: int) -> str:
    sylmap = _ru_syllable_per_cp(w)
    out: list[str] = []
    after_vowel = False

    def after_palatal() -> bool:
        if not out:
            return False
        last = out[-1]
        if last in ("tɕ", "ɕː", "ts", "ʐ", "ʂ"):
            return False
        return last.endswith("ʲ")

    def after_hard() -> bool:
        if not out:
            return False
        last = out[-1]
        if last.endswith("ʲ"):
            return False
        if last and last[-1] in "aeiouɛəɨɪʊ":
            return False
        return True

    i = 0
    n = len(w)
    while i < n:
        ch = w[i]
        stressed = sylmap[i] == stress_syl if i < len(sylmap) else False
        if ch in "ъь":
            i += 1
            continue
        if ch == "й":
            out.append("j")
            after_vowel = False
            i += 1
            continue
        if ch in _RU_VOWEL_LETTERS:
            jot = not out or after_vowel
            if ch == "е" and jot:
                out.append("je" if stressed else "jɪ")
            elif ch == "ю" and jot:
                out.append("ju")
            elif ch == "я" and jot:
                out.append("ja" if stressed else "jə")
            else:
                out.append(_ru_vowel_ipa(ch, stressed, after_palatal(),
                                         after_hard(), jot))
            after_vowel = True
            i += 1
            continue
        if ch not in _RU_CONS_IPA:
            i += 1
            continue
        nxt = w[i + 1] if i + 1 < n else ""
        palatal = False
        if nxt == "ь":
            palatal = ch in _RU_PALATALIZABLE
            out.append(_RU_CONS_IPA[ch] + ("ʲ" if palatal else ""))
            after_vowel = False
            i += 2
            continue
        if nxt == "ъ":
            out.append(_RU_CONS_IPA[ch])
            after_vowel = False
            i += 2
            continue
        if nxt in _RU_VOWEL_LETTERS:
            if ch in "жцш":
                palatal = False
            elif ch in "чщ":
                palatal = False
            elif nxt in _RU_SOFTENING_VOWELS:
                palatal = ch in _RU_PALATALIZABLE
            out.append(_RU_CONS_IPA[ch] + ("ʲ" if palatal else ""))
            after_vowel = False
            i += 1
            continue
        out.append(_RU_CONS_IPA[ch])
        after_vowel = False
        i += 1
    return "".join(out)


def _ru_insert_stress(ipa: str) -> str:
    ipa = ipa.replace("ˈ", "").replace("ˌ", "")
    for i, ch in enumerate(ipa):
        if ch in _RU_IPA_VOWEL_CPS:
            return ipa[:i] + "ˈ" + ipa[i:]
    return "ˈ" + ipa


def normalize_russian_ipa_piper(s: str) -> str:
    """The reference's apply_russian_ipa_piper_style
    (ipa-postprocess.cpp): affricate/schwa rewrites, stress-nucleus and
    bare-nucleus vowel merges, zh handling, conjunction-и fixes."""
    for a, b in [
        ("tɕtˈo", "ʃto"), ("tɕtˈɔ", "ʃto"), ("tɕto", "ʃto"),
        ("tɕtʌ", "ʃto"), ("t͡ɕ", "tʃʲ"), ("d͡ʑ", "dʑ"), ("t͡s", "ts"),
        ("d͡z", "dz"), ("tɕ", "tʃʲ"), ("ʂ", "ʃ"), ("ɐ", "ʌ"), ("ə", "ʌ"),
    ]:
        s = s.replace(a, b)
    for a, b in [
        ("ˈɨ", "ˈy"), ("ˌɨ", "ˌy"), ("ˈɫ", "ˈɭ"), ("ˌɫ", "ˌɭ"),
        ("ˈʌ", "ˈa"), ("ˌʌ", "ˌa"), ("ˈɪ", "ˈi"), ("ˌɪ", "ˌi"),
        ("ˈʊ", "ˈu"), ("ˌʊ", "ˌu"), ("ˈʉ", "ˈu"), ("ˌʉ", "ˌu"),
    ]:
        s = s.replace(a, b)
    for a, b in [("ɫ", "ɭ"), ("ɨ", "y"), ("ʉ", "u"), ("ʌ", "a"),
                 ("ɪ", "i"), ("ʊ", "u")]:
        s = s.replace(a, b)
    # ʐ → ʒ except in the dʐ cluster
    out = []
    for i, ch in enumerate(s):
        if ch == "ʐ" and not (i >= 1 and s[i - 1] == "d"):
            out.append("ʒ")
        else:
            out.append(ch)
    s = "".join(out)
    for a, b in [(" i ", " ɪ "), (")i ", ")ɪ "), ("«i ", "«ɪ "),
                 (", i ", ", ɪ "), ("; i ", "; ɪ "), (": i ", ": ɪ ")]:
        s = s.replace(a, b)
    if s.startswith("i "):
        s = "ɪ " + s[2:]
    return s


class RussianG2P:
    """Russian G2P mirroring the reference's russian.cpp rules path:
    orthographic syllabification for stress-relative vowel reduction
    (ё / combining-acute override, default first syllable),
    palatalization before soft vowels and ь, iotated vowel handling,
    stress before the first IPA vowel, the piper-style normalization
    pass, and the reference's cardinal expansion."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _filter(word: str, keep_stress: bool) -> str:
        out = []
        nfd = unicodedata.normalize("NFD", word.lower())
        for ch in nfd:
            if unicodedata.category(ch) == "Mn":
                if keep_stress:
                    if ch == "́":
                        out.append(ch)
                    # Keep й/ё intact in the stress source (the reference
                    # filter passes precomposed letters through); the
                    # clean word keeps the decomposed base (й -> и,
                    # ё -> е), matching strip_grapheme_diacritics.
                    elif ch == "̆" and out and out[-1] == "и":
                        out[-1] = "й"
                    elif ch == "̈" and out and out[-1] == "е":
                        out[-1] = "ё"
                continue
            if ("а" <= ch <= "я") or ch in "ёй-'":
                out.append(ch)
        return "".join(out)

    def _single(self, w: str, stress_src: str) -> str:
        # acute ordinal over the stress source
        acute = None
        v = 0
        skip_next_acute = False
        prev_vowel = False
        for ch in unicodedata.normalize("NFD", stress_src):
            if ch == "́" and prev_vowel:
                acute = v - 1
                break
            if unicodedata.category(ch) == "Mn":
                continue
            if ch in _RU_VOWEL_LETTERS:
                v += 1
                prev_vowel = True
            else:
                prev_vowel = False
        stress_syl = _ru_stress_syllable(w, acute)
        body = _ru_letters_to_ipa(w, stress_syl)
        if body:
            body = _ru_insert_stress(body)
        return body

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = ru_cardinal_words(w)
            if phrase != w:
                ipa = " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
                return normalize_russian_ipa_piper(ipa)
            return w
        stress_src = self._filter(w, keep_stress=True)
        clean = self._filter(w, keep_stress=False)
        if not clean:
            return ""
        key = clean.replace("'", "")
        if key in self.lexicon:
            return normalize_russian_ipa_piper(
                move_stress_to_nucleus(self.lexicon[key]))
        if "-" in key:
            chunks = [c for c in key.split("-") if c]
            schunks = [c for c in stress_src.split("-") if c]
            parts = []
            for i, c in enumerate(chunks):
                src = schunks[i] if len(schunks) == len(chunks) else stress_src
                parts.append(self._single(c, src))
            return normalize_russian_ipa_piper(
                move_stress_to_nucleus("-".join(parts)))
        return normalize_russian_ipa_piper(
            move_stress_to_nucleus(self._single(key, stress_src)))


# ---------------------------------------------------------------------------
# Ukrainian — engine mirroring the reference's ukrainian.cpp
# ---------------------------------------------------------------------------

_UK_VOWEL_LETTERS = set("аеєиіїоуюя")
_UK_SOFT_VOWELS = set("єіїюя")
_UK_HARD_NO_PAL = set("жчшщ")
_UK_PALATALIZABLE = set("бвгґдзклмнпрстфхц")
_UK_CONS = {
    "б": "b", "п": "p", "м": "m", "ф": "f", "г": "ɦ", "ґ": "ɡ", "д": "d",
    "т": "t", "н": "n", "л": "l", "р": "ɾ", "с": "s", "з": "z", "ж": "ʒ",
    "ш": "ʃ", "ч": "tʃ", "щ": "ʃtʃ", "ц": "ts", "к": "k", "х": "x",
}
_UK_HARD_AFFRICATES = {"dʒ", "dz", "tʃ", "ts", "ʃtʃ", "ʒ", "ʃ"}
_UK_IPA_VOWELS = set("aeiouɛɪ")

_UK_DIGITS = ["нуль", "один", "два", "три", "чотири", "п'ять", "шість",
              "сім", "вісім", "дев'ять"]
_UK_TEENS = ["десять", "одинадцять", "дванадцять", "тринадцять",
             "чотирнадцять", "п'ятнадцять", "шістнадцять", "сімнадцять",
             "вісімнадцять", "дев'ятнадцять"]
_UK_TENS = ["", "", "двадцять", "тридцять", "сорок", "п'ятдесят",
            "шістдесят", "сімдесят", "вісімдесят", "дев'яносто"]
_UK_HUNDREDS = ["", "сто", "двісті", "триста", "чотириста", "п'ятсот",
                "шістсот", "сімсот", "вісімсот", "дев'ятсот"]


def uk_cardinal_words(s: str) -> str:
    """Digit string -> Ukrainian words (ukrainian.cpp:104-302)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_UK_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "нуль"

    def under_100_plain(n):
        if n < 10:
            return [_UK_DIGITS[n]]
        if n < 20:
            return [_UK_TEENS[n - 10]]
        t, u = divmod(n, 10)
        return [_UK_TENS[t]] + ([_UK_DIGITS[u]] if u else [])

    def to_999(n):
        if n == 0:
            return ["нуль"]
        h, r = divmod(n, 100)
        out = [_UK_HUNDREDS[h]] if h else []
        if r:
            out += under_100_plain(r)
        return out

    def under_100_fem(n):
        fem = {1: "одна", 2: "дві", 3: "три", 4: "чотири"}
        if n in fem:
            return [fem[n]]
        if 10 <= n < 20:
            return [_UK_TEENS[n - 10]]
        t, u = divmod(n, 10)
        out = [_UK_TENS[t]]
        if u:
            out += under_100_fem(u) if u <= 4 else [_UK_DIGITS[u]]
        return out

    def thousand_noun(h):
        if h % 100 in (11, 12, 13, 14):
            return "тисяч"
        m = h % 10
        if m == 1:
            return "тисяча"
        if m in (2, 3, 4):
            return "тисячі"
        return "тисяч"

    if n < 1000:
        return " ".join(to_999(n))
    q, r = divmod(n, 1000)
    parts = []
    if q < 100:
        parts += under_100_fem(q)
    else:
        parts.append(_UK_HUNDREDS[q // 100])
        if q % 100:
            parts += under_100_fem(q % 100)
    parts.append(thousand_noun(q))
    if r:
        parts += to_999(r)
    return " ".join(parts)


def _uk_palatalize_last(pieces: list[str]) -> None:
    for idx in range(len(pieces) - 1, -1, -1):
        p = pieces[idx]
        if not p:
            continue
        if p in _UK_HARD_AFFRICATES or p.endswith("ʲ"):
            return
        pieces[idx] = p + "ʲ"
        return


def _uk_piece_is_vowel(p: str) -> bool:
    if not p:
        return True
    if p[0] == "j" or p[0] in "aeiouɛɪ":
        return True
    return False


def _uk_ends_palatalized(pieces: list[str]) -> bool:
    for idx in range(len(pieces) - 1, -1, -1):
        p = pieces[idx]
        if not p or _uk_piece_is_vowel(p):
            continue
        if p in _UK_HARD_AFFRICATES:
            return False
        return p.endswith("ʲ")
    return False


def _uk_insert_stress_penult(ipa: str) -> str:
    u = [c for c in ipa if c not in "ˈˌ"]
    starts = []
    i, n = 0, len(u)
    while i < n:
        if u[i] == "j" and i + 1 < n and u[i + 1] in _UK_IPA_VOWELS:
            starts.append(i)
            i += 2
            continue
        if u[i] in _UK_IPA_VOWELS:
            starts.append(i)
            i += 1
            continue
        i += 1
    if not starts:
        return ipa
    at = starts[0] if len(starts) == 1 else starts[-2]
    return "".join(u[:at]) + "ˈ" + "".join(u[at:])


class UkrainianG2P:
    """Ukrainian G2P mirroring the reference's ukrainian.cpp: near-
    phonemic mapping with palatalization before soft vowels / soft sign,
    apostrophe-blocked jotation, в allophony (w before consonants and
    finally, ʋ before vowels), penultimate default stress, and the
    reference's cardinal expansion."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _clean(part: str) -> str:
        out = []
        nfd = unicodedata.normalize("NFD", part.lower())
        i = 0
        while i < len(nfd):
            ch = nfd[i]
            if ch in ("’", "‘"):
                out.append("'")
                i += 1
                continue
            if unicodedata.category(ch) == "Mn":
                # Drop stress marks; keep the diaeresis (ї) and breve (й)
                # distinctions by recomposing.
                # Only the diaeresis survives NFD stripping (so ї stays
                # distinct from і); й loses its breve and reads as и,
                # exactly like the reference's strip pass
                # (ukrainian.cpp:53-77).
                if ch == "̈" and out and out[-1] == "і":
                    out[-1] = "ї"
                i += 1
                continue
            if ch == "'" or unicodedata.category(ch)[0] == "L":
                out.append(ch)
            i += 1
        return "".join(out)

    def _inner(self, w: str, with_stress: bool = True) -> str:
        pieces: list[str] = []
        i = 0
        n = len(w)
        prev_vowel = False
        word_onset = True
        force_j = False
        prev_hard_affricate = False

        def next_letter(start):
            for j in range(start, n):
                if w[j] != "'":
                    return j
            return None

        while i < n:
            if w[i] == "'":
                i += 1
                continue
            if i + 1 < n and w[i] == "д" and w[i + 1] in "жз":
                pieces.append("dʒ" if w[i + 1] == "ж" else "dz")
                i += 2
                word_onset = prev_vowel = False
                prev_hard_affricate = True
                continue
            ch = w[i]
            if ch == "ь":
                _uk_palatalize_last(pieces)
                i += 1
                prev_hard_affricate = False
                continue
            if ch == "й":
                pieces.append("j")
                i += 1
                word_onset = prev_vowel = False
                prev_hard_affricate = False
                continue
            if ch in _UK_VOWEL_LETTERS:
                fj = force_j
                force_j = False
                if fj or word_onset or prev_vowel:
                    v = {"я": "ja", "ю": "ju", "є": "jɛ", "ї": "ji"}.get(ch)
                else:
                    v = None
                if v is None:
                    if ch == "ї":
                        v = "i" if _uk_ends_palatalized(pieces) else "ji"
                    else:
                        v = {"я": "a", "ю": "u", "є": "ɛ", "а": "a",
                             "е": "ɛ", "и": "ɪ", "і": "i", "о": "o",
                             "у": "u"}.get(ch, "")
                pieces.append(v)
                i += 1
                word_onset = False
                prev_vowel = True
                prev_hard_affricate = False
                continue
            bc = _UK_CONS.get(ch, "")
            is_v = ch == "в"
            if not bc and not is_v:
                i += 1
                continue
            # apostrophe + soft vowel blocks palatalization, forces jot
            ap_block = False
            vowel_i = 0
            j = i + 1
            if j < n and w[j] == "'":
                k = j + 1
                while k < n and w[k] == "'":
                    k += 1
                if k < n and w[k] in _UK_SOFT_VOWELS:
                    ap_block = True
                    vowel_i = k
            ni = next_letter(i + 1)
            next_ch = w[ni] if ni is not None else ""
            will_pal = (not prev_hard_affricate and not ap_block
                        and ch in _UK_PALATALIZABLE
                        and ch not in _UK_HARD_NO_PAL
                        and (next_ch in _UK_SOFT_VOWELS or next_ch == "і"))
            if is_v:
                if ni is not None and (next_ch in _UK_VOWEL_LETTERS
                                       or next_ch == "й"):
                    pieces.append("ʋ")
                else:
                    pieces.append("w")
            else:
                pieces.append(bc)
            if will_pal:
                _uk_palatalize_last(pieces)
            if ap_block:
                force_j = True
                i = vowel_i
                word_onset = prev_vowel = False
                prev_hard_affricate = False
                continue
            i += 1
            word_onset = prev_vowel = False
            prev_hard_affricate = ch in _UK_HARD_NO_PAL
        ipa = "".join(pieces)
        if with_stress and ipa:
            ipa = _uk_insert_stress_penult(ipa)
        return ipa

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = uk_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = w.lower()
        if lo in self.lexicon:
            return self.lexicon[lo]
        parts = []
        for chunk in w.split("-"):
            parts.append(self._inner(self._clean(chunk)))
        return "-".join(parts)


# ---------------------------------------------------------------------------
# German — syllable engine mirroring the reference's german.cpp
# ---------------------------------------------------------------------------

_DE_VOWELS = set("aeiouyäöü")
_DE_UNSTRESSED_PREFIXES = ["wider", "entgegen", "ver", "zer", "miss",
                           "ent", "emp", "ge", "be", "er"]
_DE_STRESS_PATTERNS = ["aɪ̯", "aʊ̯", "ɔʏ̯", "iː", "eː", "aː", "oː", "uː",
                       "ɪ", "ʊ", "a", "ɛ", "ə", "i", "o", "ɔ", "u", "y",
                       "ø", "œ", "ʏ", "ɐ"]
_DE_DIGITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
              "sieben", "acht", "neun"]
_DE_UNIT_COMPOUND = ["", "ein", "zwei", "drei", "vier", "fünf", "sechs",
                     "sieben", "acht", "neun"]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]
_DE_TEENS = ["zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
             "sechzehn", "siebzehn", "achtzehn", "neunzehn"]


def de_cardinal_words(s: str) -> str:
    """Digit string -> German words (german.cpp:837-960)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_DE_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "null"

    def under_100(n):
        if n < 10:
            return _DE_DIGITS[n]
        if n < 20:
            return _DE_TEENS[n - 10]
        t, u = divmod(n, 10)
        if u == 0:
            return _DE_TENS[t]
        return _DE_UNIT_COMPOUND[u] + "und" + _DE_TENS[t]

    def to_999(n):
        if n < 100:
            return [under_100(n)]
        h, r = divmod(n, 100)
        head = "hundert" if h == 1 else _DE_UNIT_COMPOUND[h] + "hundert"
        return [head] + ([under_100(r)] if r else [])

    if n < 1000:
        return " ".join(to_999(n))
    q, r = divmod(n, 1000)
    parts = (["eintausend"] if q == 1 else to_999(q) + ["tausend"])
    if r:
        parts += to_999(r)
    return " ".join(parts)


def _de_nucleus_spans(w: str) -> list[tuple[int, int]]:
    spans = []
    i, n = 0, len(w)
    while i < n:
        if w[i] == "-" or w[i] not in _DE_VOWELS:
            i += 1
            continue
        if i + 1 < n:
            pair = w[i:i + 2]
            if pair in ("au", "ei", "eu", "ai", "äu", "ey", "oi"):
                spans.append((i, i + 2))
                i += 2
                continue
            if pair == "ie" and (i + 2 >= n or w[i + 2] == "-"
                                 or w[i + 2] not in _DE_VOWELS):
                spans.append((i, i + 2))
                i += 2
                continue
            if w[i + 1] == w[i] and w[i] in "aoeiu":
                spans.append((i, i + 2))
                i += 2
                continue
        spans.append((i, i + 1))
        i += 1
    return spans


def de_syllables(w: str) -> list[str]:
    w = "".join(c for c in w if c == "-" or c in _DE_VOWELS
                or ("a" <= c <= "z") or c in "äöüß")
    if not w:
        return []
    if "-" in w:
        out = []
        for chunk in w.split("-"):
            if chunk:
                out.extend(de_syllables(chunk))
        return out
    spans = _de_nucleus_spans(w)
    if not spans:
        return [w]
    out = []
    cur = w[: spans[0][0]]
    for idx, (s, e) in enumerate(spans):
        cur += w[s:e]
        if idx + 1 < len(spans):
            out.append(cur)
            cur = w[e: spans[idx + 1][0]]
        else:
            out.append(cur + w[e:])
    return [s for s in out if s]


def _de_stress_index(syls: list[str], wl: str) -> int:
    if len(syls) <= 1:
        return 0
    flat = wl.replace("-", "")
    if flat.endswith(("ung", "schaft", "tion", "ismus")):
        return len(syls) - 1
    for pref in _DE_UNSTRESSED_PREFIXES:
        if (len(flat) > len(pref) and flat.startswith(pref)):
            plen = len(pref)
            acc = 0
            for idx, sy in enumerate(syls):
                acc += len(sy)
                if acc >= plen:
                    return min(idx + 1, len(syls) - 1)
    return 0


def _de_insert_stress(s: str) -> str:
    s = s.replace("ˈ", "")
    best = None
    for pat in _DE_STRESS_PATTERNS:
        p = s.find(pat)
        if p != -1 and (best is None or p < best):
            best = p
    if best is None:
        return "ˈ" + s
    return s[:best] + "ˈ" + s[best:]


def _de_final_devoice(ipa: str) -> str:
    if ipa.endswith("ɡ"):
        return ipa[:-1] + "k"
    if ipa and ipa[-1] in "bdvz":
        return ipa[:-1] + {"b": "p", "d": "t", "v": "f", "z": "s"}[ipa[-1]]
    return ipa


def _de_ch_ipa(word_nh: str, gi: int) -> str:
    if gi > 1 and word_nh[gi - 2] == "a" and word_nh[gi - 1] == "u":
        return "x"
    j = gi - 1
    prev = None
    while j >= 0:
        if word_nh[j] == "-":
            break
        if word_nh[j] in _DE_VOWELS:
            prev = word_nh[j]
            break
        if word_nh[j] == "h" and j > 0 and word_nh[j - 1] in _DE_VOWELS:
            prev = word_nh[j - 1]
            break
        j -= 1
    if prev in ("a", "o", "u"):
        return "x"
    return "ç"


def _de_morpheme_start(hyphen_word: str, gi: int) -> bool:
    if gi == 0:
        return True
    pos = 0
    for chunk in hyphen_word.split("-"):
        if chunk:
            if gi == pos:
                return True
            pos += len(chunk)
    return False


def _de_syllable_ipa(s: str, word_nh: str, hyphen_word: str,
                     span_start: int) -> str:
    out = []
    n = len(s)
    i = 0
    while i < n:
        gi = span_start + i
        ch = s[i]
        if ch == "-":
            i += 1
            continue
        if s[i:i + 4] == "tsch" and i + 3 < n:
            out.append("tʃ")
            i += 4
            continue
        if s[i:i + 3] == "sch" and i + 2 < n:
            out.append("ʃ")
            i += 3
            continue
        if s[i:i + 3] == "chs" and i + 2 < n:
            out.append("ks")
            i += 3
            continue
        if s[i:i + 2] == "ch" and i + 1 < n:
            out.append(_de_ch_ipa(word_nh, gi))
            i += 2
            continue
        if s[i:i + 2] == "ng" and i + 1 < n:
            out.append("ŋ")
            i += 2
            continue
        if s[i:i + 2] == "nk" and i + 1 < n:
            out.append("ŋk")
            i += 2
            continue
        if s[i:i + 2] == "pf" and i + 1 < n:
            out.append("pf")
            i += 2
            continue
        if s[i:i + 2] == "qu" and i + 1 < n:
            out.append("kv")
            i += 2
            continue
        if (s[i:i + 2] == "st" and i + 1 < n
                and _de_morpheme_start(hyphen_word, gi)):
            out.append("ʃt")
            i += 2
            continue
        if (s[i:i + 2] == "sp" and i + 1 < n
                and _de_morpheme_start(hyphen_word, gi)):
            out.append("ʃp")
            i += 2
            continue
        if ch == "h":
            i += 1
            continue
        if ch == "ß":
            out.append("s")
            i += 1
            continue
        if s[i:i + 2] == "tz" and i + 1 < n:
            out.append("ts")
            i += 2
            continue
        if ch == "z":
            out.append("ts")
            i += 1
            continue
        if s[i:i + 2] == "ck" and i + 1 < n:
            out.append("k")
            i += 2
            continue
        if ch == "c" and i + 1 < n and s[i + 1] in "ei":
            out.append("ts")
            i += 2
            continue
        if ch == "c":
            out.append("k")
            i += 1
            continue
        if ch == "x":
            out.append("ks")
            i += 1
            continue
        if ch == "q" and (i + 1 >= n or s[i + 1] != "u"):
            out.append("k")
            i += 1
            continue
        if ch == "j":
            out.append("j")
            i += 1
            continue
        if ch == "v":
            out.append("f")
            i += 1
            continue
        if ch == "w":
            out.append("v")
            i += 1
            continue
        if ch == "y" and (i + 1 >= n or s[i + 1] not in _DE_VOWELS):
            out.append("ʏ")
            i += 1
            continue
        if s[i:i + 2] == "au" and i + 1 < n:
            out.append("aʊ̯")
            i += 2
            continue
        if s[i:i + 2] in ("ei", "ai", "ey") and i + 1 < n:
            out.append("aɪ̯")
            i += 2
            continue
        if s[i:i + 2] in ("eu", "äu") and i + 1 < n:
            out.append("ɔʏ̯")
            i += 2
            continue
        if (s[i:i + 2] == "ie" and i + 1 < n
                and (i + 2 >= n or s[i + 2] == "-"
                     or s[i + 2] not in _DE_VOWELS)):
            out.append("iː")
            i += 2
            continue
        if (i + 1 < n and ch in _DE_VOWELS and s[i + 1] == ch
                and ch in "aoeiu"):
            out.append({"a": "aː", "e": "eː", "i": "iː", "o": "oː",
                        "u": "uː"}[ch])
            i += 2
            continue
        if ch in _DE_VOWELS:
            if ch == "e":
                out.append("ə" if i == n - 1 else "ɛ")
            else:
                out.append({"a": "a", "i": "ɪ", "o": "ɔ", "u": "ʊ",
                            "ä": "ɛ", "ö": "ø", "ü": "ʏ", "y": "ʏ"}[ch])
            i += 1
            continue
        if ch == "r":
            out.append("ʁ")
            i += 1
            continue
        if s[i:i + 2] == "ss" and i + 1 < n:
            out.append("s")
            i += 2
            continue
        if ch == "s":
            prev_v = i > 0 and s[i - 1] in _DE_VOWELS
            next_v = i + 1 < n and s[i + 1] in _DE_VOWELS
            out.append("z" if (prev_v and next_v) else "s")
            i += 1
            continue
        if ch in "bdfklmnpt":
            out.append("ɡ" if ch == "g" else ch)
            i += 1
            continue
        if ch == "g":
            out.append("ɡ")
            i += 1
            continue
        i += 1
    ipa = "".join(out)
    stem = s.rstrip("-")
    if stem.endswith("ig") and not stem.endswith("lich") and \
            ipa.endswith("ɡ"):
        ipa = ipa[:-1] + "ç"
    return _de_final_devoice(ipa)


def normalize_german_ipa_piper(s: str) -> str:
    for a, b in [("t͡ʃ", "tʃ"), ("t͡s", "ts"), ("d͡ʒ", "dʒ"), ("d͡z", "dz"),
                 ("p͡f", "pf"), ("ɐ̯", "ɾ"), ("ʁ", "ɾ")]:
        s = s.replace(a, b)
    return s


class GermanG2P:
    """German G2P mirroring the reference's german.cpp: vowel-span
    syllabification (clusters attach to the following syllable), suffix/
    prefix stress heuristics, per-syllable letter rules with ch allophony
    and syllable-final devoicing, -ig -> ç, and the piper normalization
    (uvular r -> tap)."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def _rules(self, raw: str, with_stress: bool = True) -> str:
        wl = "".join(c for c in raw.lower()
                     if c == "-" or c in _DE_VOWELS or "a" <= c <= "z"
                     or c in "äöüß")
        if not wl:
            return ""
        word_nh = wl.replace("-", "")
        syls = de_syllables(wl)
        if not syls:
            return ""
        stress_idx = _de_stress_index(syls, wl) if with_stress else -1
        offset = 0
        ipa = []
        for idx, sy in enumerate(syls):
            chunk = _de_syllable_ipa(sy, word_nh, wl, offset)
            if with_stress and idx == stress_idx and chunk:
                chunk = _de_insert_stress(chunk)
            ipa.append(chunk)
            offset += len(sy)
        return "".join(ipa)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = de_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = w.lower()
        if lo in self.lexicon:
            return normalize_german_ipa_piper(
                move_stress_to_nucleus(self.lexicon[lo]))
        return normalize_german_ipa_piper(
            move_stress_to_nucleus(self._rules(w)))


# ---------------------------------------------------------------------------
# Turkish — engine mirroring the reference's turkish.cpp
# ---------------------------------------------------------------------------

_TR_VOWELS = set("aeıioöuüâêîôû")
_TR_FRONT = set("eiöüêî")
_TR_BACK_FOR_GH = set("aıouâôû")
_TR_SIMPLE = {
    "a": "a", "b": "b", "c": "dʒ", "ç": "tʃ", "d": "d", "e": "e",
    "f": "f", "h": "h", "ı": "ɯ", "i": "i", "j": "ʒ", "l": "l", "m": "m",
    "n": "n", "o": "o", "ö": "ø", "p": "p", "r": "ɾ", "s": "s", "ş": "ʃ",
    "t": "t", "u": "u", "ü": "y", "v": "v", "y": "j", "z": "z", "q": "k",
    "w": "v", "x": "ks", "â": "a", "ê": "e", "î": "i", "ô": "o", "û": "u",
}
_TR_IPA_VOWELS = set("aeiouy") | {"ɯ", "ø"}
_TR_DIGITS = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi",
              "sekiz", "dokuz"]
_TR_TENS = ["", "", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş",
            "seksen", "doksan"]


def tr_cardinal_words(s: str) -> str:
    """Digit string -> Turkish words (turkish.cpp:40-158)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_TR_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "sıfır"

    def to_999(n):
        if n == 0:
            return ["sıfır"]
        h, r = divmod(n, 100)
        out = []
        if h:
            out += (["yüz"] if h == 1 else [_TR_DIGITS[h], "yüz"])
            if r == 0:
                return out
        if r < 10:
            out.append(_TR_DIGITS[r])
        elif r == 10:
            out.append("on")
        elif r < 20:
            out += ["on", _TR_DIGITS[r - 10]]
        else:
            t, u = divmod(r, 10)
            out.append(_TR_TENS[t])
            if u:
                out.append(_TR_DIGITS[u])
        return out

    if n < 1000:
        return " ".join(to_999(n))
    q, r = divmod(n, 1000)
    parts = (["bin"] if q == 1 else to_999(q) + ["bin"])
    if r:
        parts += to_999(r)
    return " ".join(parts)


def _tr_insert_stress_final(ipa: str) -> str:
    u = [c for c in ipa if c != "ˈ"]
    j = len(u) - 1
    while j >= 0:
        if u[j] == "ː" and j >= 1:
            j -= 1
            if u[j] in _TR_IPA_VOWELS:
                return "".join(u[:j]) + "ˈ" + u[j] + "ː" + "".join(u[j + 2:])
            j -= 1
            continue
        if u[j] in _TR_IPA_VOWELS:
            return "".join(u[:j]) + "ˈ" + "".join(u[j:])
        j -= 1
    return ipa


class TurkishG2P:
    """Turkish G2P mirroring the reference's turkish.cpp: near-phonemic
    mapping with k/g palatal allophony from the harmony vowel (c before
    front vowels), yumuşak g as glide between vowels (velar glide after
    back vowels, j after front) or compensatory lengthening after a
    vowel, final-syllable stress, and the reference's cardinal
    expansion."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _lower(s: str) -> str:
        return s.replace("İ", "i").replace("I", "ı").lower()

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = tr_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = self._lower(unicodedata.normalize("NFC", w))
        if lo in self.lexicon:
            return self.lexicon[lo]
        letters = [c for c in lo if c != "'" and (c in _TR_SIMPLE
                                                  or c in "ğkg")]
        if not letters:
            return ""
        pieces: list[str] = []
        n = len(letters)
        for i, c in enumerate(letters):
            if c == "ğ":
                prev_v = i > 0 and letters[i - 1] in _TR_VOWELS
                next_v = i + 1 < n and letters[i + 1] in _TR_VOWELS
                if prev_v and next_v:
                    pv = letters[i - 1]
                    pieces.append("ɰ" if pv in _TR_BACK_FOR_GH else "j")
                elif prev_v:
                    for k in range(len(pieces) - 1, -1, -1):
                        seg = pieces[k]
                        if not seg or seg[-1] == "ː":
                            continue
                        if seg[-1] in _TR_IPA_VOWELS:
                            pieces[k] = seg + "ː"
                            break
                continue
            if c in "kg":
                hv = None
                for j in range(i + 1, n):
                    if letters[j] in _TR_VOWELS:
                        hv = letters[j]
                        break
                if hv is None:
                    for j in range(i - 1, -1, -1):
                        if letters[j] in _TR_VOWELS:
                            hv = letters[j]
                            break
                if hv is None:
                    pieces.append("k" if c == "k" else "ɡ")
                elif hv in _TR_FRONT:
                    pieces.append("c" if c == "k" else "ɟ")
                else:
                    pieces.append("k" if c == "k" else "ɡ")
                continue
            frag = _TR_SIMPLE.get(c, "")
            if frag:
                pieces.append(frag)
        ipa = "".join(pieces)
        if ipa:
            ipa = _tr_insert_stress_final(ipa)
        return ipa


# ---------------------------------------------------------------------------
# Spanish — dialect-parameterized engine mirroring the reference's
# spanish.cpp / spanish-numbers.cpp
# ---------------------------------------------------------------------------

_ES_VOWELS = set("aeiouáéíóúü")
_ES_ACCENTED = set("áéíóú")
_ES_STRIP = {"á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u", "ü": "u"}
_ES_ONSET2 = {"bl", "br", "cl", "cr", "dr", "fl", "fr", "gl", "gr", "pl",
              "pr", "tr", "ch"}
_ES_X_EXCEPTIONS = {
    "mexico": "ˈmexiko", "mejico": "ˈmexiko", "oaxaca": "waˈxaka",
    "texas": "ˈtekas", "ximena": "xiˈmena", "xavier": "xaˈbjeɾ",
}
_ES_DIGITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
              "siete", "ocho", "nueve"]
_ES_UNDER30 = [None] * 10 + [
    "diez", "once", "doce", "trece", "catorce", "quince", "dieciséis",
    "diecisiete", "dieciocho", "diecinueve", "veinte", "veintiuno",
    "veintidós", "veintitrés", "veinticuatro", "veinticinco",
    "veintiséis", "veintisiete", "veintiocho", "veintinueve"]
_ES_TENS = ["", "", "veinte", "treinta", "cuarenta", "cincuenta",
            "sesenta", "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = ["", "", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]


def es_cardinal_words(s: str) -> str:
    """Digit string -> Spanish words (spanish-numbers.cpp)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_ES_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "cero"

    def under_100(n):
        if n < 10:
            return [_ES_DIGITS[n]]
        if n < 30:
            return [_ES_UNDER30[n]]
        t, u = divmod(n, 10)
        return [_ES_TENS[t]] + (["y", _ES_DIGITS[u]] if u else [])

    def to_999(n):
        if n < 100:
            return under_100(n)
        h, r = divmod(n, 100)
        if h == 1:
            return ["cien"] if r == 0 else ["ciento"] + under_100(r)
        return [_ES_HUNDREDS[h]] + (under_100(r) if r else [])

    if n < 1000:
        return " ".join(to_999(n))
    q, r = divmod(n, 1000)
    parts = (["mil"] if q == 1 else to_999(q) + ["mil"])
    if r:
        parts += to_999(r)
    return " ".join(parts)


@dataclass
class SpanishDialect:
    """Pronunciation preset (mirrors the reference's SpanishDialect)."""
    id: str = "es-MX"
    ce_ci_z_ipa: str = "s"
    yeismo: bool = True
    y_consonant_ipa: str = "ʝ"
    ll_ipa: str = "ʎ"
    x_intervocalic_default: str = "ks"
    x_initial_before_vowel: str = "s"
    voiceless_velar_fricative: str = "x"
    trill_ipa: str = "r"
    tap_ipa: str = "ɾ"
    nasal_assimilation: bool = False
    narrow_intervocalic_obstruents: bool = True
    coda_s_mode: str = "keep"  # keep | h | drop


def spanish_dialect(dialect_id: str) -> SpanishDialect:
    key = dialect_id.strip().lower().replace("_", "-")
    d = SpanishDialect(id=key)
    if key in ("es-es", "es-es-distincion"):
        d.ce_ci_z_ipa = "θ"
    elif key in ("es-ar", "es-uy"):
        d.y_consonant_ipa = "ʒ"
    elif key in ("es-ve",):
        d.voiceless_velar_fricative = "h"
    elif key in ("es-cl",):
        d.coda_s_mode = "h"
    elif key in ("es-cu", "es-do", "es-pr"):
        d.voiceless_velar_fricative = "h"
        d.coda_s_mode = "h"
    elif key in ("es-bo", "es-py"):
        d.yeismo = False
    return d


def _es_should_hiatus(a: str, b: str) -> bool:
    if a == "í" and b == "o":
        return True
    if a == "i" and b == "ó":
        return False
    if a in "íú" or b in "íú":
        return True
    ba = _ES_STRIP.get(a, a)
    bb = _ES_STRIP.get(b, b)
    if ba == bb:
        return True
    if ba in "aeo" and bb in "aeo":
        if a in "áéó" or b in "áéó":
            return True
        if (ba, bb) in (("a", "e"), ("e", "a")):
            return False
        return True
    return False


def _es_y_is_consonant(w: str, i: int) -> bool:
    n = len(w)
    prev_v = i > 0 and w[i - 1] in _ES_VOWELS
    next_v = i + 1 < n and w[i + 1] in _ES_VOWELS
    if prev_v and next_v:
        return True
    if i == 0 and next_v:
        return True
    if not prev_v and not next_v and i == n - 1:
        return False
    if not prev_v and next_v:
        return True
    return False


def _es_nucleus_spans(w: str) -> list[tuple[int, int]]:
    out = []
    i, n = 0, len(w)
    while i < n:
        ch = w[i]
        if ch == "y":
            if w == "y":
                out.append((i, i + 1))
                i += 1
                continue
            if i == 0 and i + 1 < n and w[i + 1] in _ES_VOWELS:
                i += 1
                continue
            if (0 < i and w[i - 1] in _ES_VOWELS and i + 1 < n
                    and w[i + 1] in _ES_VOWELS):
                i += 1
                continue
            if 0 < i and w[i - 1] in _ES_VOWELS and i + 1 >= n:
                out.append((i, i + 1))
                i += 1
                continue
            if (0 < i and w[i - 1] not in _ES_VOWELS
                    and (i + 1 >= n or w[i + 1] not in _ES_VOWELS)):
                out.append((i, i + 1))
                i += 1
                continue
            i += 1
            continue
        if ch not in _ES_VOWELS:
            i += 1
            continue
        if i + 1 < n and w[i + 1] in _ES_VOWELS:
            if _es_should_hiatus(ch, w[i + 1]):
                out.append((i, i + 1))
                i += 1
            else:
                out.append((i, i + 2))
                i += 2
        else:
            out.append((i, i + 1))
            i += 1
    return out


def es_syllables(w: str) -> list[str]:
    w = "".join(c for c in w if ("a" <= c <= "z") or c in "áéíóúüñ")
    if not w:
        return []
    spans = _es_nucleus_spans(w)
    if not spans:
        return [w]
    out = []
    cur = w[: spans[0][0]]
    for idx, (s, e) in enumerate(spans):
        cur += w[s:e]
        if idx + 1 < len(spans):
            cluster = w[e: spans[idx + 1][0]]
            if cluster.endswith("rr"):
                coda, onset = cluster[:-2], "rr"
            elif len(cluster) >= 2 and cluster[-2:] in _ES_ONSET2:
                coda, onset = cluster[:-2], cluster[-2:]
            elif cluster:
                coda, onset = cluster[:-1], cluster[-1:]
            else:
                coda, onset = "", ""
            out.append(cur + coda)
            cur = onset
        else:
            out.append(cur + w[e:])
    return [s for s in out if s]


def _es_stress_index(w: str) -> int:
    syls = es_syllables(w)
    if not syls:
        return 0
    if any(c in _ES_ACCENTED for c in w):
        for i, s in enumerate(syls):
            if any(c in _ES_ACCENTED for c in s):
                return i
    n = len(syls)
    if n == 1:
        return 0
    last = _ES_STRIP.get(w[-1], w[-1]) if w else " "
    if last in "aeiou" or w[-1] in "ns":
        return n - 2 if n >= 2 else 0
    return n - 1


def _es_insert_stress(ipa: str) -> str:
    ipa = ipa.replace("ˈ", "")
    for i, ch in enumerate(ipa):
        if ch in "aeiou":
            return ipa[:i] + "ˈ" + ipa[i:]
    return "ˈ" + ipa


def _es_narrow_obstruents(ipa: str) -> str:
    u = list(ipa)
    for i in range(1, len(u) - 1):
        if u[i - 1] in "aeiou" and u[i + 1] in "aeiou":
            if u[i] == "b":
                u[i] = "β"
            elif u[i] == "d":
                u[i] = "ð"
            elif u[i] == "ɡ":
                u[i] = "ɣ"
    return "".join(u)


def _es_syllable_ipa(s: str, d: SpanishDialect, offset: int) -> str:
    out: list[str] = []
    i, n = 0, len(s)

    def peek_vowel(j):
        k = j
        while k < n:
            if s[k] == "h":
                k += 1
                continue
            return s[k] in _ES_VOWELS
        return False

    def prev_was_vowel():
        return bool(out) and any(v in out[-1] for v in "aeiou")

    vmap = {"e": "e", "i": "i", "é": "e", "í": "i"}
    while i < n:
        ch = s[i]
        if ch == "h":
            i += 1
            continue
        if ch == "y":
            if s == "y":
                out.append("i")
            elif _es_y_is_consonant(s, i):
                out.append(d.y_consonant_ipa)
            else:
                out.append("i")
            i += 1
            continue
        if ch == "ñ":
            out.append("ɲ")
            i += 1
            continue
        if s[i:i + 2] == "rr":
            out.append(d.trill_ipa)
            i += 2
            continue
        if s[i:i + 2] == "ch":
            out.append("tʃ")
            i += 2
            continue
        if s[i:i + 2] == "ll":
            out.append(d.y_consonant_ipa if d.yeismo else d.ll_ipa)
            i += 2
            continue
        if (ch == "q" and i + 2 < n and s[i + 1] == "u"
                and s[i + 2] in "eiéí"):
            out.append("k")
            out.append(vmap[s[i + 2]])
            i += 3
            continue
        if (ch == "g" and i + 2 < n and s[i + 1] == "ü"
                and s[i + 2] in "eiéí"):
            out.append("ɡ")
            out.append("w")
            out.append(vmap[s[i + 2]])
            i += 3
            continue
        if (ch == "g" and i + 2 < n and s[i + 1] == "u"
                and s[i + 2] in "eiéí"):
            out.append("ɡ")
            out.append(vmap[s[i + 2]])
            i += 3
            continue
        if ch == "g" and i + 1 < n and s[i + 1] in "eiéí":
            out.append(d.voiceless_velar_fricative)
            i += 1
            continue
        if s[i:i + 4] == "ción" and i + 3 < n:
            out.append(d.ce_ci_z_ipa)
            out.append("jon")
            i += 4
            continue
        if s[i:i + 3] == "ció" and i + 2 < n:
            out.append(d.ce_ci_z_ipa)
            out.append("jo")
            i += 3
            continue
        if ch == "c" and i + 1 < n and s[i + 1] in "eiéí":
            out.append(d.ce_ci_z_ipa)
            i += 1
            continue
        if ch == "z":
            out.append(d.ce_ci_z_ipa)
            i += 1
            continue
        if ch == "x":
            abs_pos = offset + i
            next_v = peek_vowel(i + 1)
            if abs_pos == 0 and next_v:
                out.append(d.x_initial_before_vowel)
            else:
                out.append(d.x_intervocalic_default)
            i += 1
            continue
        if ch == "j":
            out.append(d.voiceless_velar_fricative)
            i += 1
            continue
        if ch == "c":
            out.append("k")
            i += 1
            continue
        if ch == "r":
            after_lns = i > 0 and s[i - 1] in "lns"
            if i == 0 or after_lns:
                out.append(d.trill_ipa)
            else:
                out.append(d.tap_ipa)
            i += 1
            continue
        simple = {
            "a": "a", "e": "e", "i": "i", "o": "o", "u": "u", "á": "a",
            "é": "e", "í": "i", "ó": "o", "ú": "u", "ü": "w", "b": "b",
            "v": "b", "d": "d", "f": "f", "k": "k", "l": "l", "m": "m",
            "n": "n", "p": "p", "s": "s", "t": "t", "w": "w", "g": "ɡ",
        }.get(ch)
        if simple:
            out.append(simple)
        i += 1
    ipa = "".join(out)
    if d.nasal_assimilation:
        u = list(ipa)
        for k in range(len(u) - 1):
            if u[k] == "n":
                nx = u[k + 1]
                if nx in ("k", "ɡ"):
                    u[k] = "ŋ"
                elif nx in "pbm":
                    u[k] = "m"
                elif nx == "f":
                    u[k] = "ɱ"
        ipa = "".join(u)
    return ipa


class SpanishG2P:
    """Spanish G2P mirroring the reference's spanish.cpp: dialect presets
    (seseo/distinción, yeísmo, velar fricative, coda-s), orthographic
    syllabification with the hiatus rules, accent/termination stress,
    narrow intervocalic obstruents (b/d/g -> approximants), x-word
    exceptions, and the reference's cardinal expansion."""

    def __init__(self, dialect: "SpanishDialect | str" = "es-MX",
                 lexicon: dict[str, str] | None = None):
        self.dialect = (spanish_dialect(dialect)
                        if isinstance(dialect, str) else dialect)
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def _postprocess(self, ipa: str) -> str:
        d = self.dialect
        if d.narrow_intervocalic_obstruents:
            ipa = _es_narrow_obstruents(ipa)
        if d.coda_s_mode != "keep" and ipa.endswith("s") \
                and not ipa.endswith("ks"):
            ipa = ipa[:-1] + ("h" if d.coda_s_mode == "h" else "")
        return ipa

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = es_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = w.lower()
        key = "".join(_ES_STRIP.get(c, c) for c in lo
                      if ("a" <= c <= "z") or c in "áéíóúüñ")
        if lo in self.lexicon:
            return self.lexicon[lo]
        exc = _ES_X_EXCEPTIONS.get(key)
        if exc is not None:
            return self._postprocess(exc)
        lw = "".join(c for c in lo if ("a" <= c <= "z") or c in "áéíóúüñ")
        if not lw:
            return ""
        syls = es_syllables(lw)
        stress_idx = _es_stress_index(lw)
        offset = 0
        parts = []
        for sy in syls:
            parts.append(_es_syllable_ipa(sy, self.dialect, offset))
            offset += len(sy)
        if parts and stress_idx < len(parts):
            parts[stress_idx] = _es_insert_stress(parts[stress_idx])
        ipa = "".join(parts)
        d = self.dialect
        if d.narrow_intervocalic_obstruents:
            ipa = _es_narrow_obstruents(ipa)
        if d.coda_s_mode != "keep" and ipa.endswith("s") \
                and not ipa.endswith("ks"):
            ipa = ipa[:-1] + ("h" if d.coda_s_mode == "h" else "")
        return ipa


# ---------------------------------------------------------------------------
# Italian — syllable engine mirroring the reference's italian.cpp
# ---------------------------------------------------------------------------

_IT_VOWELS = set("aeiouàèéìíîòóùú")
_IT_ACCENTED = set("àèéìíòóùúî")
_IT_STRIP = {"à": "a", "á": "a", "è": "e", "é": "e", "ê": "e", "ì": "i",
             "í": "i", "î": "i", "ò": "o", "ó": "o", "ù": "u", "ú": "u"}
_IT_ONSET2 = {"bl", "br", "cl", "cr", "dr", "fl", "fr", "gl", "gr", "pl",
              "pr", "tr", "ch"}
_IT_CG_PALATAL = set("eéèiìíî")
_IT_DIGITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
              "sette", "otto", "nove"]

# Function words (italian.cpp function_word_ipa:1016-1065).
_IT_FUNCTION_WORDS = {
    "e": "e", "ed": "ed", "o": "o", "a": "a", "i": "i", "il": "il",
    "lo": "lo", "la": "la", "le": "le", "gli": "ʎi", "un": "un",
    "uno": "ˈuno", "una": "ˈuna", "di": "di", "da": "da", "in": "in",
    "su": "su", "per": "per", "tra": "tra", "fra": "fra", "del": "del",
    "della": "ˈdɛlla", "delle": "ˈdɛlle", "dei": "ˈdei",
    "degli": "ˈdeʎʎi", "al": "al", "allo": "ˈallo", "alla": "ˈalla",
    "ai": "ai", "agli": "ˈaʎʎi", "alle": "ˈalle", "nel": "nel",
    "nello": "ˈnɛllo", "nella": "ˈnɛlla", "nell": "nɛll", "sul": "sul",
    "sullo": "ˈsullo", "sulla": "ˈsulla", "col": "kol", "coi": "ˈkoi",
    "ci": "t͡ʃi", "vi": "vi", "si": "si", "ti": "ti", "mi": "mi",
    "non": "non", "che": "ke",
}


def it_cardinal_words(s: str) -> str:
    """Digit string -> Italian words with fused forms (italian.cpp)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_IT_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "zero"
    teens = [None, "undici", "dodici", "tredici", "quattordici", "quindici",
             "sedici", "diciassette", "diciotto", "diciannove"]
    tens = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
            "settanta", "ottanta", "novanta"]

    def under_100(n):
        if n < 10:
            return _IT_DIGITS[n]
        if n == 10:
            return "dieci"
        if n < 20:
            return teens[n - 10]
        t, u = divmod(n, 10)
        tn = tens[t]
        if u == 0:
            return tn
        stem = tn[:-1]
        if u == 1:
            return stem + "uno"
        if u == 8:
            return stem + "otto"
        joiner = "i" if tn[-1] == "i" else "a"
        if u == 3:
            return stem + joiner + "tré"
        return stem + joiner + _IT_DIGITS[u]

    def hundred_head(h):
        if h == 1:
            return "cento"
        return _IT_DIGITS[h] + "cento"

    def to_999(n):
        if n == 0:
            return ["zero"]
        if n < 100:
            return [under_100(n)]
        h, r = divmod(n, 100)
        return [hundred_head(h)] + ([under_100(r)] if r else [])

    def fused_999(n):
        if n < 100:
            return under_100(n)
        h, r = divmod(n, 100)
        return hundred_head(h) + (under_100(r) if r else "")

    if n < 1000:
        return " ".join(to_999(n))
    q, r = divmod(n, 1000)
    if q == 1:
        head = ["mille"]
    elif q < 10:
        head = [_IT_DIGITS[q] + "mila"]
    else:
        head = [fused_999(q) + "mila"]
    return " ".join(head + (to_999(r) if r else []))


def _it_should_hiatus(a: str, b: str) -> bool:
    if a in "íì" or b in "íì" or a in "úù" or b in "úù":
        return True
    ba = _IT_STRIP.get(a, a)
    bb = _IT_STRIP.get(b, b)
    if ba in "aeo" and bb in "aeo":
        return True
    if ba in "iu" and bb in "aeo":
        return False
    if ba in "aeo" and bb in "iu":
        return False
    if ba == bb:
        return True
    if ba in "iu" and bb in "iu":
        return False
    return True


def it_syllables(w: str) -> list[str]:
    w = "".join(c for c in w.lower()
                if c == "-" or ("a" <= c <= "z") or c in _IT_ACCENTED)
    if not w:
        return []
    if "-" in w:
        out = []
        for chunk in w.split("-"):
            if chunk:
                out.extend(it_syllables(chunk))
        return out
    spans = []
    i, n = 0, len(w)
    while i < n:
        if w[i] not in _IT_VOWELS:
            i += 1
            continue
        if i + 1 < n and w[i + 1] in _IT_VOWELS:
            if _it_should_hiatus(w[i], w[i + 1]):
                spans.append((i, i + 1))
                i += 1
            else:
                spans.append((i, i + 2))
                i += 2
        else:
            spans.append((i, i + 1))
            i += 1
    if not spans:
        return [w]
    out = []
    cur = w[: spans[0][0]]
    for idx, (s, e) in enumerate(spans):
        cur += w[s:e]
        if idx + 1 < len(spans):
            cluster = w[e: spans[idx + 1][0]]
            if len(cluster) >= 2 and cluster[-2:] in _IT_ONSET2:
                coda = cluster[:-2] if len(cluster) > 2 else ""
                onset = cluster[-2:]
            elif cluster:
                coda, onset = cluster[:-1], cluster[-1:]
            else:
                coda, onset = "", ""
            out.append(cur + coda)
            cur = onset
        else:
            out.append(cur + w[e:])
    return [s for s in out if s]


def _it_stress_index(syls: list[str], w: str) -> int:
    if not syls:
        return 0
    if any(c in _IT_ACCENTED for c in w):
        for i, s in enumerate(syls):
            if any(c in _IT_ACCENTED for c in s):
                return i
    n = len(syls)
    if n == 1:
        return 0
    tail = w.rstrip("-")
    if not tail:
        return 0
    last = _IT_STRIP.get(tail[-1], tail[-1])
    if last in "aeiou":
        return n - 2 if n >= 2 else 0
    return n - 1


def _it_insert_stress(ipa: str) -> str:
    ipa = ipa.replace("ˈ", "").replace("ˌ", "")
    for i, ch in enumerate(ipa):
        if ch in "aeiouɛɔ":
            return ipa[:i] + "ˈ" + ipa[i:]
    return "ˈ" + ipa


def _it_syllable_ipa(s: str) -> str:
    out = []
    n = len(s)
    i = 0
    vow_after = set("aeiouàèéìòóù")
    while i < n:
        if s[i] == "-":
            i += 1
            continue
        if s[i:i + 2] == "zz" and i + 1 < n:
            out.append("tt͡s")
            i += 2
            continue
        if (s[i:i + 2] == "cc" and i + 2 < n
                and s[i + 2] in _IT_CG_PALATAL):
            out.append("tt͡ʃ")
            i += 3
            continue
        if (s[i:i + 2] == "gg" and i + 2 < n
                and s[i + 2] in _IT_CG_PALATAL):
            out.append("dd͡ʒ")
            i += 3
            continue
        if s[i:i + 2] == "gn" and i + 1 < n:
            out.append("ɲɲ")
            i += 2
            continue
        if s[i:i + 3] == "gli" and i + 2 < n:
            nxt = s[i + 3] if i + 3 < n else ""
            if not nxt or nxt in vow_after:
                out.append("ʎ")
                i += 3
                continue
            if nxt == "i" and (i + 4 >= n or s[i + 4] not in _IT_VOWELS):
                out.append("ʎ")
                i += 3
                continue
        if s[i:i + 2] == "ch" and i + 1 < n:
            out.append("k")
            i += 2
            continue
        if (s[i:i + 2] == "gh" and i + 2 < n
                and s[i + 2] in _IT_CG_PALATAL):
            out.append("ɡ")
            i += 3
            continue
        if (s[i:i + 2] == "sc" and i + 2 < n
                and s[i + 2] in _IT_CG_PALATAL):
            out.append("ʃ")
            i += 3
            continue
        if (s[i:i + 2] == "sc" and i + 2 < n
                and s[i + 2] in "aouàòù"):
            out.append("sk")
            i += 3
            continue
        if s[i:i + 2] == "qu" and i + 1 < n:
            out.append("kw")
            i += 2
            continue
        if (s[i:i + 2] == "gu" and i + 2 < n
                and s[i + 2] in _IT_CG_PALATAL):
            out.append("ɡ")
            i += 2
            continue
        if (s[i:i + 2] == "ci" and i + 2 < n and s[i + 2] in _IT_VOWELS):
            out.append("t͡ʃ")
            i += 2
            continue
        if (s[i:i + 2] == "gi" and i + 2 < n and s[i + 2] in _IT_VOWELS):
            out.append("d͡ʒ")
            i += 2
            continue
        if s[i] == "c" and i + 1 < n and s[i + 1] in _IT_CG_PALATAL:
            out.append("t͡ʃ")
            i += 2
            continue
        if s[i] == "g" and i + 1 < n and s[i + 1] in _IT_CG_PALATAL:
            out.append("d͡ʒ")
            i += 2
            continue
        ch = s[i]
        if ch == "h":
            i += 1
            continue
        if (i + 1 < n and s[i + 1] == ch and ch not in _IT_VOWELS):
            if ch in "bcdfglmnpstv":
                out.append(ch + ch)
            else:
                out.append(ch)
            i += 2
            continue
        if ch == "c":
            out.append("k")
            i += 1
            continue
        if ch == "g":
            out.append("ɡ")
            i += 1
            continue
        if ch == "q":
            if i + 1 < n and s[i + 1] == "u":
                k = i + 2
                while k < n and s[k] == "h":
                    k += 1
                if k < n and s[k] in _IT_VOWELS:
                    out.append("k")
                    i += 2
                    continue
            out.append("k")
            i += 1
            continue
        if ch == "s":
            prev_v = i > 0 and s[i - 1] in _IT_VOWELS
            k = i + 1
            while k < n and s[k] == "h":
                k += 1
            next_v = k < n and s[k] in _IT_VOWELS
            out.append("z" if (prev_v and next_v) else "s")
            i += 1
            continue
        if ch == "z":
            prev_v = i > 0 and s[i - 1] in _IT_VOWELS
            k = i + 1
            while k < n and s[k] == "h":
                k += 1
            next_v = k < n and s[k] in _IT_VOWELS
            out.append("d͡ʒ" if (prev_v and next_v) else "t͡s")
            i += 1
            continue
        if ch == "x":
            out.append("ks")
            i += 1
            continue
        if ch in "jwk":
            out.append({"j": "j", "w": "w", "k": "k"}[ch])
            i += 1
            continue
        if ch in _IT_VOWELS:
            if i + 1 < n and s[i + 1] in _IT_VOWELS:
                a = _IT_STRIP.get(ch, ch)
                b = s[i + 1]
                bb = _IT_STRIP.get(b, b)
                pair = None
                if a == "a" and bb == "u":
                    pair = "aw"
                elif a == "a" and bb == "i":
                    pair = "aj"
                elif ch in "eéè" and bb == "i":
                    pair = "ej"
                elif a == "o" and bb == "i":
                    pair = "oj"
                elif ch in "eéè" and bb == "u":
                    pair = "ɛw"
                elif a == "o" and bb == "u":
                    pair = "ow"
                if pair:
                    out.append(pair)
                    i += 2
                    continue
            if ch in "aà":
                out.append("a")
            elif ch in "eé":
                out.append("e")
            elif ch in "èê":
                out.append("ɛ")
            elif ch in "iíìî":
                out.append("i")
            elif ch in "oó":
                out.append("o")
            elif ch == "ò":
                out.append("ɔ")
            elif ch in "uùú":
                out.append("u")
            else:
                out.append("a")
            i += 1
            continue
        if ch in "bdflmnprtv":
            out.append(ch)
        i += 1
    return "".join(out)


class ItalianG2P:
    """Italian G2P mirroring the reference's italian.cpp: orthographic
    syllabification with the Italian hiatus rules, accent/termination
    stress, soft c/g with the vowel-as-marker convention, geminates,
    gn -> double palatal nasal, gli, sc(i), intervocalic s/z voicing,
    fused cardinal forms, and the vocoder stress move."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = it_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = w.lower()
        if lo in self.lexicon:
            return move_stress_to_nucleus(self.lexicon[lo])
        if lo in _IT_FUNCTION_WORDS:
            return move_stress_to_nucleus(_IT_FUNCTION_WORDS[lo])
        wl = "".join(c for c in lo
                     if c == "-" or ("a" <= c <= "z") or c in _IT_ACCENTED)
        if not wl:
            return ""
        syls = it_syllables(wl)
        if not syls:
            return ""
        stress_idx = _it_stress_index(syls, wl)
        parts = []
        for idx, sy in enumerate(syls):
            chunk = _it_syllable_ipa(sy)
            if idx == stress_idx and chunk:
                chunk = _it_insert_stress(chunk)
            parts.append(chunk)
        return move_stress_to_nucleus("".join(parts))


# ---------------------------------------------------------------------------
# Dutch — syllable engine mirroring the reference's dutch.cpp
# ---------------------------------------------------------------------------

_NL_VOWELS = set("aeiouyáéíóúàèêëïöü")
_NL_STRIP_VOWEL = {"á": "a", "à": "a", "é": "e", "è": "e", "ê": "e",
                   "ë": "e", "í": "i", "ï": "i", "ó": "o", "ö": "o",
                   "ú": "u", "ü": "u"}
_NL_NUCLEI_ORTH = ["aai", "eeu", "oei", "ieu", "ij", "ei", "au", "ou",
                   "ui", "eu", "aa", "ee", "oo", "uu", "oe", "ai", "ie"]
_NL_PREFIXES = ["tegen", "tussen", "door", "voor", "ver", "her", "ont",
                "in", "op", "af", "uit", "aan", "be", "ge", "er", "te"]
_NL_STRESS_PATTERNS = ["ɛi", "ʌu", "ʌy", "øː", "aɪ̯", "iː", "eː", "aː",
                       "oː", "uː", "yː", "ɪ", "ʏ", "y", "ø", "a", "ɛ",
                       "ə", "i", "o", "ɔ", "u", "ɑ"]
_NL_DEVOICE = {"b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s",
               "ɣ": "x", "ʒ": "ʃ"}
_NL_DIGITS = ["nul", "een", "twee", "drie", "vier", "vijf", "zes",
              "zeven", "acht", "negen"]
_NL_TENS = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
            "zeventig", "tachtig", "negentig"]
_NL_TEENS = {13: "dertien", 14: "veertien", 15: "vijftien", 16: "zestien",
             17: "zeventien", 18: "achttien", 19: "negentien"}

# Function words (dutch.cpp function_word_ipa:611-621).
_NL_FUNCTION_WORDS = {
    "de": "də", "het": "ɦət", "een": "ən", "te": "tə", "je": "jə",
    "ze": "zə", "we": "ʋə", "me": "mə", "mijn": "mɛin", "zijn": "zɛin",
    "hij": "ɦɛi", "wij": "ʋɛi", "jij": "jɛi",
}


def nl_cardinal_words(s: str) -> str:
    """Digit string -> Dutch words (dutch.cpp:221-369), including the
    teen-hundred year style (1891 -> achttienhonderd eenennegentig)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_NL_DIGITS[int(c)] for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "nul"

    def below_100(n):
        if n < 10:
            return _NL_DIGITS[n]
        if n < 13:
            return ["tien", "elf", "twaalf"][n - 10]
        if n < 20:
            return _NL_TEENS[n]
        t, u = divmod(n, 10)
        if u == 0:
            return _NL_TENS[t]
        stem = _NL_DIGITS[u]
        return stem + "en" + _NL_TENS[t]

    def below_1000(n):
        if n < 100:
            return below_100(n)
        h, r = divmod(n, 100)
        head = "honderd" if h == 1 else _NL_DIGITS[h] + "honderd"
        return head if r == 0 else head + " " + below_100(r)

    if n < 1000:
        return below_1000(n)
    if n < 10_000:
        if n < 1100:
            return "duizend" if n == 1000 else \
                "duizend " + below_100(n - 1000)
        if n < 2000:
            c, r = divmod(n, 100)
            head = _NL_TEENS.get(c, below_100(c)) + "honderd" if c >= 13 \
                else ["elf", "twaalf"][c - 11] + "honderd"
            return head if r == 0 else head + " " + below_100(r)
        q, r = divmod(n, 1000)
        left = "duizend" if q == 1 else below_100(q) + "duizend"
        return left if r == 0 else left + " " + below_1000(r)
    q, r = divmod(n, 1000)
    if q == 1:
        left = "duizend"
    elif q < 10:
        left = _NL_DIGITS[q] + "duizend"
    elif q < 100:
        left = below_100(q) + "duizend"
    else:
        left = below_1000(q) + " duizend"
    return left if r == 0 else left + " " + below_1000(r)


def nl_syllables(w: str) -> list[str]:
    w = w.strip("-")
    while "--" in w:
        w = w.replace("--", "-")
    if not w:
        return []
    if "-" in w:
        out = []
        for chunk in w.split("-"):
            if chunk:
                out.extend(nl_syllables(chunk))
        return out
    spans = []
    i, n = 0, len(w)
    while i < n:
        if w[i] == "-" or w[i] not in _NL_VOWELS:
            i += 1
            continue
        for pat in _NL_NUCLEI_ORTH:
            if w.startswith(pat, i):
                spans.append((i, i + len(pat)))
                i += len(pat)
                break
        else:
            spans.append((i, i + 1))
            i += 1
    if not spans:
        return [w]
    out = []
    cur = w[: spans[0][0]]
    for idx, (s, e) in enumerate(spans):
        cur += w[s:e]
        if idx + 1 < len(spans):
            out.append(cur)
            cur = w[e: spans[idx + 1][0]]
        else:
            out.append(cur + w[e:])
    return [s for s in out if s]


def _nl_stress_index(syls: list[str], w: str) -> int:
    if len(syls) <= 1:
        return 0
    if any(c in "áéíóú" for c in w):
        for i, s in enumerate(syls):
            if any(c in "áéíóú" for c in s):
                return i
    flat = w.replace("-", "")
    for suf in ("atie", "iteit", "isme", "eerd", "eren"):
        if len(flat) > len(suf) + 1 and flat.endswith(suf):
            return len(syls) - 1
    for pref in _NL_PREFIXES:
        if len(flat) > len(pref) and flat.startswith(pref):
            if (syls[0] and syls[0][0] == "g" and len(syls[0]) > 2
                    and syls[0][1] == "e"):
                return 0
            acc = 0
            for idx, sy in enumerate(syls):
                acc += len(sy)
                if acc >= len(pref):
                    return min(idx + 1, len(syls) - 1)
            break
    return 0


def _nl_insert_stress(s: str) -> str:
    s = s.replace("ˈ", "")
    pos = 0
    while pos < len(s):
        for pat in _NL_STRESS_PATTERNS:
            if s.startswith(pat, pos):
                return s[:pos] + "ˈ" + s[pos:]
        pos += 1
    # vowelless chunk: the reference's move-to-nucleus normalization
    # parks the mark after a coda-only tail (dutch.cpp
    # normalize_ipa_stress_for_vocoder: fɪˈts -> fɪtsˈ)
    return s + "ˈ"


def _nl_syllable_ipa(s: str) -> str:
    out = []
    n = len(s)
    i = 0
    while i < n:
        if s[i] == "-":
            i += 1
            continue
        ch = s[i]
        if s[i:i + 3] == "sch":
            out.append("sx")
            i += 3
            continue
        if s[i:i + 2] == "ch":
            out.append("x")
            i += 2
            continue
        if s[i:i + 2] == "ng":
            out.append("ŋ")
            i += 2
            continue
        if s[i:i + 2] == "nk":
            out.append("ŋk")
            i += 2
            continue
        if s[i:i + 2] == "sj":
            out.append("ʃ")
            i += 2
            continue
        if s[i:i + 2] == "tj":
            out.append("tʃ")
            i += 2
            continue
        if s[i:i + 2] in ("ij", "ei"):
            out.append("ɛi")
            i += 2
            continue
        if s[i:i + 3] == "aai":
            out.append("aːi")
            i += 3
            continue
        if s[i:i + 3] == "eeu":
            out.append("eːʏ")
            i += 3
            continue
        if s[i:i + 3] == "oei":
            out.append("ʌi")
            i += 3
            continue
        if s[i:i + 3] == "ieu":
            out.append("ʌu")
            i += 3
            continue
        if s[i:i + 2] in ("au", "ou"):
            out.append("ʌu")
            i += 2
            continue
        if s[i:i + 2] == "ui":
            out.append("ʌy")
            i += 2
            continue
        if s[i:i + 2] == "eu":
            out.append("øː")
            i += 2
            continue
        if s[i:i + 2] == "oe":
            out.append("u")
            i += 2
            continue
        if s[i:i + 2] == "ai":
            out.append("aɪ̯")
            i += 2
            continue
        if s[i:i + 2] == "aa":
            out.append("aː")
            i += 2
            continue
        if s[i:i + 2] == "ee":
            out.append("eː")
            i += 2
            continue
        if s[i:i + 2] == "oo":
            out.append("oː")
            i += 2
            continue
        if s[i:i + 2] == "uu":
            out.append("y")
            i += 2
            continue
        if s[i:i + 2] == "ie":
            nxt = s[i + 2] if i + 2 < n else ""
            nxt_in_tsd = (not nxt) or nxt in "tsd"
            cond2 = i + 3 >= n or s[i + 3] not in _NL_VOWELS
            out.append("i" if (nxt_in_tsd and cond2) else "iː")
            i += 2
            continue
        if s[i:i + 2] == "qu":
            out.append("kv")
            i += 2
            continue
        if ch == "h":
            out.append("ɦ")
            i += 1
            continue
        if ch == "x":
            out.append("ks")
            i += 1
            continue
        if ch == "c" and i + 1 < n and s[i + 1] in "eiéèêë":
            out.append("s")
            i += 1
            continue
        if ch == "c":
            out.append("k")
            i += 1
            continue
        if ch == "q":
            out.append("k")
            i += 1
            continue
        if ch == "j":
            out.append("j")
            i += 1
            continue
        if ch == "y":
            pv = i > 0 and s[i - 1] in _NL_VOWELS
            nv = i + 1 < n and s[i + 1] in _NL_VOWELS
            out.append("j" if (not pv and nv) else "i")
            i += 1
            continue
        if ch == "w":
            out.append("ʋ")
            i += 1
            continue
        if ch in "vz":
            out.append(ch)
            i += 1
            continue
        if ch == "g":
            out.append("ɣ")
            i += 1
            continue
        if ch in _NL_VOWELS:
            plain = _NL_STRIP_VOWEL.get(ch, ch)
            if ch == "é":
                out.append("eː")
            elif ch in "èê":
                out.append("ɛ")
            elif ch == "ë":
                out.append("ə")
            elif ch in "ïü":
                out.append("y")
            elif ch == "ö":
                out.append("ø")
            elif plain == "a":
                out.append("ɑ")
            elif plain == "e":
                out.append("ə" if i == n - 1 else "ɛ")
            elif plain == "i":
                out.append("ɪ")
            elif plain == "o":
                out.append("ɔ")
            elif plain == "u":
                out.append("ʏ")
            else:
                out.append("i")
            i += 1
            continue
        if ch == "r":
            out.append("r")
            i += 1
            continue
        if s[i:i + 2] == "ss":
            out.append("s")
            i += 2
            continue
        if ch == "s":
            pv = i > 0 and s[i - 1] in _NL_VOWELS
            nv = i + 1 < n and s[i + 1] in _NL_VOWELS
            out.append("z" if (pv and nv) else "s")
            i += 1
            continue
        if ch in "bdfklmnpt":
            out.append(ch)
            i += 1
            continue
        if s[i:i + 2] == "ph":
            out.append("f")
            i += 2
            continue
        if s[i:i + 2] == "th":
            out.append("t")
            i += 2
            continue
        i += 1
    ipa = "".join(out)
    stem = s.rstrip("-")
    if (len(stem) >= 3 and stem.endswith("ig")
            and not stem.endswith("lijk")):
        if ipa.endswith(("ɣ", "ɡ")):
            ipa = ipa[:-1] + "x"
    if ipa and ipa[-1] in _NL_DEVOICE:
        ipa = ipa[:-1] + _NL_DEVOICE[ipa[-1]]
    return ipa


class DutchG2P:
    """Dutch G2P mirroring the reference's dutch.cpp: multigraph vowel
    nuclei (ij/ei/ui/eu/oe/aai/eeu/...), suffix/prefix stress heuristics,
    sch -> s+x, soft g as voiced velar fricative, per-syllable final
    devoicing, -ig -> x, and the reference's cardinal expansion with
    teen-hundred years."""

    def __init__(self, lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = nl_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        lo = w.lower().replace("ĳ", "ij")
        if lo in self.lexicon:
            return self.lexicon[lo]
        if lo in _NL_FUNCTION_WORDS:
            return _NL_FUNCTION_WORDS[lo]
        wl = "".join(c for c in lo
                     if c == "-" or ("a" <= c <= "z") or c in _NL_VOWELS)
        if not wl:
            return ""
        syls = nl_syllables(wl)
        if not syls:
            return ""
        stress_idx = _nl_stress_index(syls, wl)
        parts = []
        for idx, sy in enumerate(syls):
            chunk = _nl_syllable_ipa(sy)
            if idx == stress_idx and chunk:
                chunk = _nl_insert_stress(chunk)
            parts.append(chunk)
        return "".join(parts)


# ---------------------------------------------------------------------------
# French — engine mirroring the reference's french.cpp / french-oov.cpp
# ---------------------------------------------------------------------------

_FR_VOWELS = set("aàâäeéèêëiïîoôöuùûüyœæ")
_FR_NUCLEUS_PREFIXES = ["ɑ̃", "ɛ̃", "ɔ̃", "œ̃", "ə", "ɛ", "œ", "ø", "ɔ",
                        "ɑ", "æ", "ɜ", "a", "e", "i", "o", "u", "y", "ɪ",
                        "ʊ"]
_FR_IPA_NUCLEUS_CPS = set("aeiouyøœɔɑɛəɜɪʊʁjwɥ")
_FR_H_ASPIRE = {
    "hareng", "harpagon", "harpe", "hargneux", "hargneusement",
    "hautain", "haut", "hâte", "haïr", "haï", "haïe", "haïes", "haïs",
    "héros", "héroïne", "hérisson", "hérésie", "hiérarchie", "hollande",
    "honte", "honteux", "huit", "huitième", "humble", "humour", "hurler",
    "hutte",
}
_FR_HETERONYM_DEFAULT = {"est": "ɛ", "a": "a"}

# Pre-phonemized cardinal compounds (french-compound-map.cpp; data table).
_FR_COMPOUND_IPA = {
    "cinquante": "sɛ̃kˈɑ̃t", "cinquante-cinq": "sɛ̃kˈɑ̃tsˈɛ̃k",
    "cinquante-deux": "sɛ̃kˈɑ̃tdˈø", "cinquante-et-un": "sɛ̃kˈɑ̃teˈœ̃",
    "cinquante-huit": "sɛ̃kˈɑ̃tyˈit", "cinquante-neuf": "sɛ̃kˈɑ̃tnˈœf",
    "cinquante-quatre": "sɛ̃kˈɑ̃tkˈatʁ", "cinquante-sept": "sɛ̃kˈɑ̃tsˈɛt",
    "cinquante-six": "sɛ̃kˈɑ̃tsˈis", "cinquante-trois": "sɛ̃kˈɑ̃ttʁwˈa",
    "dix-huit": "dˈizyˈit", "dix-neuf": "dˈiznˈœf", "dix-sept": "dˈisˈɛt",
    "quarante": "kaʁˈɑ̃t", "quarante-cinq": "kaʁˈɑ̃tsˈɛ̃k",
    "quarante-deux": "kaʁˈɑ̃tdˈø", "quarante-et-un": "kaʁˈɑ̃teˈœ̃",
    "quarante-huit": "kaʁˈɑ̃tyˈit", "quarante-neuf": "kaʁˈɑ̃tnˈœf",
    "quarante-quatre": "kaʁˈɑ̃tkˈatʁ", "quarante-sept": "kaʁˈɑ̃tsˈɛt",
    "quarante-six": "kaʁˈɑ̃tsˈis", "quarante-trois": "kaʁˈɑ̃ttʁwˈa",
    "quatre-vingt-cinq": "kˈatʁvˈɛ̃tsˈɛ̃k",
    "quatre-vingt-deux": "kˈatʁvˈɛ̃tdˈø",
    "quatre-vingt-dix": "kˈatʁvˈɛ̃dˈis",
    "quatre-vingt-dix-huit": "kˈatʁvˈɛ̃dˈizyˈit",
    "quatre-vingt-dix-neuf": "kˈatʁvˈɛ̃dˈiznˈœf",
    "quatre-vingt-dix-sept": "kˈatʁvˈɛ̃dˈisˈɛt",
    "quatre-vingt-douze": "kˈatʁvˈɛ̃dˈuz",
    "quatre-vingt-huit": "kˈatʁvˈɛ̃tyˈit",
    "quatre-vingt-neuf": "kˈatʁvˈɛ̃tnˈœf",
    "quatre-vingt-onze": "kˈatʁvˈɛ̃tˈɔ̃z",
    "quatre-vingt-quatorze": "kˈatʁvˈɛ̃katˈɔʁz",
    "quatre-vingt-quatre": "kˈatʁvˈɛ̃tkˈatʁ",
    "quatre-vingt-quinze": "kˈatʁvˈɛ̃kˈɛ̃z",
    "quatre-vingt-seize": "kˈatʁvˈɛ̃sˈɛz",
    "quatre-vingt-sept": "kˈatʁvˈɛ̃tsˈɛt",
    "quatre-vingt-six": "kˈatʁvˈɛ̃tsˈis",
    "quatre-vingt-treize": "kˈatʁvˈɛ̃tʁˈɛz",
    "quatre-vingt-trois": "kˈatʁvˈɛ̃ttʁwˈa",
    "quatre-vingt-un": "kˈatʁvˈɛ̃ˈœ̃", "quatre-vingts": "kˈatʁvˈɛ̃",
    "soixante-cinq": "swasˈɑ̃tsˈɛ̃k", "soixante-deux": "swasˈɑ̃tdˈø",
    "soixante-dix": "swasˈɑ̃tdˈis",
    "soixante-dix-huit": "swasˈɑ̃tdˈizyˈit",
    "soixante-dix-neuf": "swasˈɑ̃tdˈiznˈœf",
    "soixante-dix-sept": "swasˈɑ̃tdˈisˈɛt",
    "soixante-douze": "swasˈɑ̃tdˈuz", "soixante-et-onze": "swasˈɑ̃teˈɔ̃z",
    "soixante-huit": "swasˈɑ̃tyˈit", "soixante-neuf": "swasˈɑ̃tnˈœf",
    "soixante-onze": "swasˈɑ̃tˈɔ̃z", "soixante-quatorze": "swasˈɑ̃tkatˈɔʁz",
    "soixante-quatre": "swasˈɑ̃tkˈatʁ", "soixante-quinze": "swasˈɑ̃tkˈɛ̃z",
    "soixante-seize": "swasˈɑ̃tsˈɛz", "soixante-sept": "swasˈɑ̃tsˈɛt",
    "soixante-six": "swasˈɑ̃tsˈis", "soixante-treize": "swasˈɑ̃ttʁˈɛz",
    "soixante-trois": "swasˈɑ̃ttʁwˈa", "soixante-un": "swasˈɑ̃tˈœ̃",
    "trente": "tʁˈɑ̃t", "trente-cinq": "tʁˈɑ̃tsˈɛ̃k",
    "trente-deux": "tʁˈɑ̃tdˈø", "trente-et-un": "tʁˈɑ̃teˈœ̃",
    "trente-huit": "tʁˈɑ̃tyˈit", "trente-neuf": "tʁˈɑ̃tnˈœf",
    "trente-quatre": "tʁˈɑ̃tkˈatʁ", "trente-sept": "tʁˈɑ̃tsˈɛt",
    "trente-six": "tʁˈɑ̃tsˈis", "trente-trois": "tʁˈɑ̃ttʁwˈa",
    "vingt": "vˈɛ̃", "vingt-cinq": "vˈɛ̃tsˈɛ̃k", "vingt-deux": "vˈɛ̃tdˈø",
    "vingt-et-un": "vˈɛ̃teˈœ̃", "vingt-huit": "vˈɛ̃tyˈit",
    "vingt-neuf": "vˈɛ̃tnˈœf", "vingt-quatre": "vˈɛ̃tkˈatʁ",
    "vingt-sept": "vˈɛ̃tsˈɛt", "vingt-six": "vˈɛ̃tsˈis",
    "vingt-trois": "vˈɛ̃ttʁwˈa",
}

_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six",
             "sept", "huit", "neuf", "dix", "onze", "douze", "treize",
             "quatorze", "quinze", "seize"]


def fr_cardinal_words(s: str) -> str:
    """Digit string -> French words (french.cpp:341-516)."""
    if not s.isdigit():
        return s
    if len(s) > 1 and s[0] == "0":
        return " ".join(_FR_UNITS[int(c)] if int(c) < 10 else "" for c in s)
    n = int(s)
    if n > 999_999:
        return s
    if n == 0:
        return "zéro"

    def below_100(n):
        if n < 17:
            return [_FR_UNITS[n]]
        if n < 20:
            return ["dix-" + _FR_UNITS[n - 10]]
        if n < 60:
            tens = (n // 10) * 10
            u = n % 10
            tw = {20: "vingt", 30: "trente", 40: "quarante",
                  50: "cinquante"}.get(tens, "vingt")
            if u == 0:
                return [tw]
            if u == 1:
                return [tw + "-et-un"]
            return [tw + "-" + _FR_UNITS[u]]
        if n < 70:
            return ["soixante-" + _FR_UNITS[n - 60]]
        if n < 80:
            u = n - 70
            if u == 1:
                return ["soixante-et-onze"]
            if u <= 6:
                return ["soixante-" + _FR_UNITS[10 + u]]
            return ["soixante-dix-" + _FR_UNITS[u]]
        u = n - 80
        if u == 0:
            return ["quatre-vingts"]
        if u == 10:
            return ["quatre-vingt-dix"]
        if u < 17:
            return ["quatre-vingt-" + _FR_UNITS[u]]
        return ["quatre-vingt-dix-" + _FR_UNITS[u - 10]]

    def below_1000(n):
        if n == 0:
            return []
        h, r = divmod(n, 100)
        if h == 0:
            return below_100(r)
        if h == 1:
            return ["cent"] + (below_100(r) if r else [])
        if r == 0:
            return [_FR_UNITS[h], "cents"]
        return [_FR_UNITS[h], "cent"] + below_100(r)

    if n < 1000:
        return " ".join(below_1000(n))
    q, r = divmod(n, 1000)
    parts = (["mille"] if q == 1 else below_1000(q) + ["mille"])
    if r:
        parts += below_1000(r)
    return " ".join(parts)


def _fr_letters_only(raw: str) -> str:
    return "".join(c for c in raw.lower() if c in _FR_VOWELS
                   or ("a" <= c <= "z") or c == "ç")


def _fr_scan_graphemes(w: str) -> str:
    """Letter walk of the reference's french-oov.cpp scan_graphemes."""
    out: list[str] = []
    i, n = 0, len(w)

    def v(c):
        return c in _FR_VOWELS

    def next_not_vowel(j):
        return j >= n or not v(w[j])

    soft = set("eéèêëiïy")
    while i < n:
        ch = w[i]
        if ch == "h":
            i += 1
            continue
        if w.startswith("aient", i) and (i == 0 or not v(w[i - 1])):
            out.append("ɛ")
            i += 5
            continue
        if w.startswith("ant", i) and i + 3 >= n:
            out.append("ɑ̃")
            i += 3
            continue
        if w.startswith("eaux", i):
            out.append("o")
            i += 4
            continue
        if w.startswith("eau", i):
            out.append("o")
            i += 3
            continue
        if w.startswith("tion", i) and next_not_vowel(i + 4):
            out.append("sjɔ̃")
            i += 4
            continue
        if w.startswith("sion", i) and next_not_vowel(i + 4):
            out.append("zjɔ̃")
            i += 4
            continue
        if w.startswith("oin", i) and next_not_vowel(i + 3):
            out.append("wɛ̃")
            i += 3
            continue
        if w.startswith("ien", i) and next_not_vowel(i + 3):
            out.append("jɛ̃")
            i += 3
            continue
        if w.startswith("ain", i) and next_not_vowel(i + 3):
            out.append("ɛ̃")
            i += 3
            continue
        if w.startswith("eil", i) and next_not_vowel(i + 3):
            out.append("ɛj")
            i += 3
            continue
        if w.startswith("ail", i) and next_not_vowel(i + 3):
            out.append("aj")
            i += 3
            continue
        if w.startswith("oui", i):
            out.append("wi")
            i += 3
            continue
        if w.startswith("ou", i) or w.startswith("oo", i):
            out.append("u")
            i += 2
            continue
        if w.startswith("oi", i):
            out.append("wa")
            i += 2
            continue
        if w.startswith("ai", i) or w.startswith("ei", i):
            out.append("ɛ")
            i += 2
            continue
        if w.startswith("au", i) and (i + 2 >= n or not v(w[i + 2])):
            out.append("o")
            i += 2
            continue
        if w.startswith("eu", i):
            out.append("ø")
            i += 2
            continue
        if ch == "œ" and i + 1 < n and w[i + 1] == "u":
            out.append("ø")
            i += 2
            continue
        if ch == "œ":
            out.append("œ")
            i += 1
            continue
        if ch == "æ":
            out.append("e")
            i += 1
            continue
        if (w.startswith("an", i) or w.startswith("am", i)) \
                and next_not_vowel(i + 2):
            out.append("ɑ̃")
            i += 2
            continue
        if (w.startswith("en", i) or w.startswith("em", i)) \
                and next_not_vowel(i + 2):
            if i > 0 and w[i - 1] in "iïy":
                out.append("ɛ̃")
            else:
                out.append("ɑ̃")
            i += 2
            continue
        if (w.startswith("in", i) or w.startswith("im", i)
                or w.startswith("yn", i) or w.startswith("ym", i)) \
                and next_not_vowel(i + 2):
            out.append("ɛ̃")
            i += 2
            continue
        if (w.startswith("on", i) or w.startswith("om", i)) \
                and next_not_vowel(i + 2):
            out.append("ɔ̃")
            i += 2
            continue
        if (w.startswith("un", i) or w.startswith("um", i)) \
                and next_not_vowel(i + 2):
            out.append("œ̃")
            i += 2
            continue
        if w.startswith("qu", i) and i + 2 < n and v(w[i + 2]):
            out.append("k")
            i += 2
            continue
        if (ch == "g" and i + 2 < n and w[i + 1] == "u"
                and w[i + 2] in soft):
            out.append("ɡ")
            i += 2
            continue
        if w.startswith("ch", i):
            out.append("ʃ")
            i += 2
            continue
        if w.startswith("gn", i):
            out.append("ɲ")
            i += 2
            continue
        if w.startswith("ph", i):
            out.append("f")
            i += 2
            continue
        if w.startswith("th", i):
            out.append("t")
            i += 2
            continue
        if ch == "c" and i + 1 < n and w[i + 1] == "ç":
            out.append("ks")
            i += 2
            continue
        if ch == "ç":
            out.append("s")
            i += 1
            continue
        if ch == "c":
            nx = w[i + 1] if i + 1 < n else ""
            out.append("s" if nx in soft else "k")
            i += 1
            continue
        if ch == "g":
            nx = w[i + 1] if i + 1 < n else ""
            out.append("ʒ" if nx in soft else "ɡ")
            i += 1
            continue
        if ch == "x":
            if not out:
                out.append("ɡz" if (i + 1 < n and v(w[i + 1])) else "ks")
            else:
                last = out[-1]
                z_link = bool(last) and (last[-1] in "aeiouyøœɔɑɛə"
                                         or last.endswith("̃"))
                out.append("z" if z_link else "ks")
            i += 1
            continue
        if v(ch):
            if ch in "aàâä":
                out.append("a")
            elif ch == "é":
                out.append("e")
            elif ch in "èêë":
                out.append("ɛ")
            elif ch == "e":
                if i + 1 >= n:
                    i += 1
                    continue
                out.append("ə" if not v(w[i + 1]) else "e")
            elif ch in "iïî":
                out.append("i")
            elif ch in "oô":
                out.append("o")
            elif ch == "ö":
                out.append("ø")
            elif ch in "uùûü":
                out.append("y")
            elif ch == "y":
                out.append("i")
            else:
                out.append("a")
            i += 1
            continue
        cons = {"b": "b", "d": "d", "f": "f", "j": "ʒ", "k": "k",
                "l": "l", "m": "m", "n": "n", "p": "p", "q": "k",
                "r": "ʁ", "s": "s", "t": "t", "v": "v", "w": "w",
                "z": "z"}
        if ch in cons:
            out.append(cons[ch])
        i += 1
    return "".join(out)


def _fr_is_nucleus_cp(c: str) -> bool:
    return c in _FR_IPA_NUCLEUS_CPS


def _fr_trim_final(ipa: str, ortho: str) -> str:
    """Silent final consonant trimming driven by orthography
    (french-oov.cpp trim_final_by_orthography)."""
    o = ortho.rstrip("e")
    if not o or not ipa:
        return ipa
    s = list(ipa)

    def prev_is_nucleus(idx):
        if idx < 0:
            return False
        if s[idx] == "̃":
            return True
        return _fr_is_nucleus_cp(s[idx]) or s[idx] in "éèê"

    while s and s[-1] in "td" and prev_is_nucleus(len(s) - 2):
        s.pop()
    while s and s[-1] in "pb" and prev_is_nucleus(len(s) - 2):
        s.pop()
    if o[-1] in "sxz":
        while s and s[-1] in "sz" and prev_is_nucleus(len(s) - 2):
            s.pop()
    return "".join(s)


def fr_nucleus_spans(s: str) -> list[tuple[int, int]]:
    spans = []
    i, n = 0, len(s)
    while i < n:
        for p in _FR_NUCLEUS_PREFIXES:
            if s.startswith(p, i):
                spans.append((i, i + len(p)))
                i += len(p)
                break
        else:
            i += 1
    return spans


def fr_nuclear_stress(ipa: str) -> str:
    """ˈ before the LAST nucleus (french.cpp ensure_french_nuclear_stress)."""
    if not ipa.strip():
        return ipa
    if "-" in ipa:
        return "-".join(fr_nuclear_stress(c) for c in ipa.split("-") if c)
    s = ipa.replace("ˈ", "").replace("ˌ", "")
    if not s:
        return ipa
    spans = fr_nucleus_spans(s)
    if not spans:
        return "ˈ" + s
    at = spans[-1][0]
    return s[:at] + "ˈ" + s[at:]


def fr_liaison_consonant(word: str) -> str | None:
    """Orthographic liaison consonant of *word*
    (french.cpp orthographic_liaison_consonant)."""
    w = "".join(c for c in word.lower()
                if c in _FR_VOWELS or ("a" <= c <= "z") or c in "ç-")
    if not w:
        return None
    if len(w) >= 3 and (w.endswith("ent") or w.endswith("ont")):
        return "t"
    if len(w) > 1 and w[-1] == "e":
        w = w[:-1]
    if not w:
        return None
    return {"s": "z", "x": "z", "z": "z", "d": "t", "t": "t", "n": "n",
            "r": "ʁ", "l": "l", "f": "v", "c": "k", "p": "p", "g": "ɡ",
            "m": "m", "b": "b"}.get(w[-1])


def fr_ipa_starts_with_vowel(ipa: str) -> bool:
    s = ipa.replace("ˈ", "").replace("ˌ", "")
    if not s:
        return False
    c0 = s[0]
    if c0 in "ɥwj":
        if len(s) > 1 and (s[1] in "aeiouyøœɔɑɛɜɪʊ" or s[1] == "ə"):
            return True
        return False
    if c0 in "aeiouyøœɔɑɛəɜɪʊɶ":
        return True
    return False


def fr_ipa_ends_with_audible_consonant(ipa: str) -> bool:
    s = ipa.replace("ˈ", "").replace("ˌ", "")
    if not s or s.endswith("̃"):
        return False
    c = s[-1]
    if c in "aeiouyøœɔɑɛəɜɪʊɶ":
        return False
    return c in "bdfɡɟhjklmnpqʁrstvzʃʒɲŋwɥçc"


def fr_nasal_liaison(word: str, ipa: str) -> str | None:
    w = word.lower()
    s = ipa.replace("ˈ", "").replace("ˌ", "")
    if w in ("mon", "ton", "son", "bon") and s.endswith("ɔ̃"):
        p = ipa.rfind("ɔ̃")
        return ipa[:p] + "ɔn" + ipa[p + 2:]
    if w in ("un", "aucun", "aucune") and s.endswith("œ̃"):
        p = ipa.rfind("œ̃")
        return ipa[:p] + "œn" + ipa[p + 2:]
    if w == "en" and s.endswith("ɑ̃"):
        p = ipa.rfind("ɑ̃")
        return ipa[:p] + "ɑn" + ipa[p + 2:]
    return None


class FrenchG2P:
    """French G2P mirroring the reference's rules tier: the OOV letter
    walk with nasal-vowel digraphs, orthography-driven silent final
    trimming, cardinal compound IPA, final-syllable nuclear stress, and
    the reference's liaison machinery (POS-free tier: obligatory only
    after "et"; POS inventories extend it when loaded, mirroring the
    CSV-gated behavior)."""

    #: closed determiners that force liaison onto a following noun/adj
    CLOSED_LIAISON_DETERMINERS = frozenset({
        "les", "des", "ces", "mes", "tes", "ses", "nos", "vos", "leurs",
        "aux", "quelques", "plusieurs", "certains", "certaines"})
    _POS_SCAN_ORDER = ("DET", "PRON", "PREP", "CONJ", "ADJ", "ADV",
                      "VERB", "NOUN")

    def __init__(self, lexicon: dict[str, str] | None = None,
                 pos_inventory: dict[str, set] | None = None):
        self.lexicon = dict(lexicon or {})
        # POS word lists per category (the reference loads these from its
        # CSV data dir; empty = the rules tier, where only "et" and the
        # closed determiners trigger liaison, french.cpp:923-976).
        self.pos_inventory = {k: set(v)
                              for k, v in (pos_inventory or {}).items()}

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def classify_pos(self, word: str, prev_pos: str | None) -> str | None:
        k = word.lower()
        cands = [cat for cat in self._POS_SCAN_ORDER
                 if k in self.pos_inventory.get(cat, ())]
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        if prev_pos == "DET":
            for want in ("ADJ", "NOUN"):
                if want in cands:
                    return want
        if prev_pos == "PRON" and "VERB" in cands:
            return "VERB"
        for cat in self._POS_SCAN_ORDER:
            if cat in cands:
                return cat
        return cands[0]

    @classmethod
    def liaison_strength(cls, pos_left, pos_right, wleft,
                         formal: bool = False) -> str:
        """'none' | 'optional' | 'obligatory'
        (french.cpp liaison_strength_fn:923-976)."""
        wl = wleft.lower()
        if pos_left == "CONJ" and wl == "et":
            return "obligatory"
        if (pos_left is None and wl in cls.CLOSED_LIAISON_DETERMINERS
                and pos_right in ("NOUN", "ADJ")):
            return "obligatory"
        if pos_right is None and pos_left in ("PRON", "DET"):
            return "obligatory"
        if pos_left is None or pos_right is None:
            return "none"
        if (pos_left, pos_right) in (("NOUN", "VERB"), ("VERB", "NOUN")):
            return "none"
        if pos_left == "PRON" and pos_right in ("VERB", "NOUN"):
            return "obligatory"
        if pos_left == "DET" and pos_right in ("NOUN", "ADJ"):
            return "obligatory"
        if pos_left == "DET" and pos_right == "ADV":
            return "optional" if formal else "none"
        if pos_left == "PREP":
            return "optional" if formal else "none"
        if pos_left == "ADJ" and pos_right == "NOUN":
            return "optional" if formal else "none"
        return "none"

    def _word_ipa_base(self, word: str) -> str:
        """Word IPA before stress (None-able); mirrors word_to_ipa_impl."""
        w = word.strip()
        if not w:
            return ""
        key = "".join(c for c in w.lower()
                      if c in _FR_VOWELS or ("a" <= c <= "z")
                      or c in "ç-'’").replace("’", "'")
        if not key:
            return ""
        hit = self.lexicon.get(key)
        if hit is None and key.endswith("'"):
            hit = self.lexicon.get(key[:-1])
        if hit is not None:
            return fr_nuclear_stress(hit)
        if key in _FR_HETERONYM_DEFAULT:
            return fr_nuclear_stress(_FR_HETERONYM_DEFAULT[key])
        low = w.lower()
        if low in _FR_COMPOUND_IPA:
            return _FR_COMPOUND_IPA[low]
        # OOV rules (hyphen chunks independently)
        if "-" in w:
            parts = []
            for chunk in w.split("-"):
                if not chunk:
                    continue
                p = self._oov(chunk)
                if not p:
                    return ""
                parts.append(p)
            return fr_nuclear_stress("-".join(parts))
        ipa = self._oov(w)
        return fr_nuclear_stress(ipa) if ipa else ""

    @staticmethod
    def _oov(word: str) -> str:
        ortho = _fr_letters_only(word)
        if not ortho:
            return ""
        ipa = _fr_scan_graphemes(ortho)
        return _fr_trim_final(ipa, ortho)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        if w.isdigit():
            phrase = fr_cardinal_words(w)
            if phrase != w:
                return " ".join(
                    p for p in (self.word_to_ipa(t)
                                for t in phrase.split()) if p)
            return w
        return self._word_ipa_base(w)

    def liaison_pair(self, wleft: str, ipa_left: str, wright: str,
                     ipa_right: str) -> str:
        """Return the (possibly liaison-extended) LEFT word IPA,
        mirroring the reference's text pipeline (french.cpp:1278-1304):
        POS-classified strength when inventories are loaded, with the
        POS-free "et" special case."""
        pos_left = self.classify_pos(wleft, None)
        pos_right = self.classify_pos(wright, pos_left)
        strength = self.liaison_strength(pos_left, pos_right, wleft)
        if strength == "none" and wleft.lower() == "et" and pos_left is None:
            strength = "obligatory"
        if strength != "obligatory":
            return ipa_left
        if not ipa_left.strip():
            return ipa_left
        if wright.lower() in _FR_H_ASPIRE:
            return ipa_left
        if not fr_ipa_starts_with_vowel(ipa_right):
            return ipa_left
        nasal = fr_nasal_liaison(wleft, ipa_left)
        if nasal is not None:
            return nasal
        if fr_ipa_ends_with_audible_consonant(ipa_left):
            return ipa_left
        c = fr_liaison_consonant(wleft)
        if c is None:
            return ipa_left
        if ipa_left.rstrip().endswith(c):
            return ipa_left
        out = ipa_left + c
        if out.count("ˈ") <= 1:
            out = fr_nuclear_stress(out)
        return out


# ---------------------------------------------------------------------------
# English — dict-first engine mirroring the reference's english.cpp /
# english-hand-oov.cpp / english-numbers.cpp
# ---------------------------------------------------------------------------

_EN_NUM_UNITS = ["ˈzɪroʊ", "wˈʌn", "tˈu", "θɹˈi", "fˈɔɹ", "fˈaɪv",
                 "sˈɪks", "sˈɛvən", "ˈeɪt", "nˈaɪn"]
_EN_NUM_TEENS = ["tˈɛn", "ɪlˈɛvən", "twˈɛlv", "θɝˈtin", "fɔɹˈtin",
                 "fˈɪftin", "sˈɪkstin", "sˈɛvəntin", "ˈeɪtin", "nˈaɪntin"]
_EN_NUM_TENS = [None, None, "twˈɛnti", "θˈɝdi", "fˈɔɹti", "fˈɪfti",
                "sˈɪksti", "sˈɛvənti", "ˈeɪti", "nˈaɪnti"]
_EN_NUM_DIGITS = ["ˈzɪroʊ", "ˈwʌn", "ˈtu", "ˈθɹi", "ˈfɔɹ", "ˈfaɪv",
                  "ˈsɪks", "ˈsɛvən", "ˈeɪt", "ˈnaɪn"]


def _en_under_1000_ipa(n: int) -> str:
    if n < 10:
        return _EN_NUM_UNITS[n]
    if n < 20:
        return _EN_NUM_TEENS[n - 10]
    if n < 100:
        t, u = divmod(n, 10)
        return _EN_NUM_TENS[t] + (("ˌ" + _EN_NUM_UNITS[u]) if u else "")
    h, r = divmod(n, 100)
    head = _EN_NUM_UNITS[h] + "ˌhˈʌndɹɪd"
    return head + (("ˌ" + _en_under_1000_ipa(r)) if r else "")


def _en_digit_seq_ipa(digits: str) -> str:
    return "ˌ".join(_EN_NUM_DIGITS[int(c)] for c in digits if c.isdigit())


def english_number_token_ipa(token: str) -> str | None:
    """Numeric token -> fused stressed IPA (english-numbers.cpp)."""
    t = token.strip().replace(",", "").replace("_", "").replace(" ", "")
    if not t:
        return None
    neg = False
    if t and t[0] in "+-":
        neg = t[0] == "-"
        t = t[1:]
    if not t or t.count(".") > 1:
        return None

    def cardinal(n: int) -> str | None:
        if n == 0:
            return "ˈzɪroʊ"
        if n >= 10 ** 15:
            return None
        parts = []
        for mag, sfx in [(10 ** 12, "ˌtɹˈɪljən"), (10 ** 9, "ˌbˈɪljən"),
                         (10 ** 6, "ˌmˈɪljən"), (1000, "ˌθˈaʊzənd")]:
            if n >= mag:
                q, n = divmod(n, mag)
                parts.append(_en_under_1000_ipa(q) + sfx)
        if n:
            parts.append(_en_under_1000_ipa(n))
        return "ˌ".join(parts)

    def finish(s: str) -> str:
        return ("nˈɛɡətɪvˌ" + s) if neg else s

    if "." in t:
        whole, frac = t.split(".", 1)
        if (whole and not whole.isdigit()) or (frac and not frac.isdigit()):
            return None
        if not whole:
            left = "ˈzɪroʊ"
        elif len(whole) > 1 and whole[0] == "0":
            left = _en_digit_seq_ipa(whole)
        else:
            left = cardinal(int(whole)) or _en_digit_seq_ipa(whole)
        if not frac:
            return finish(left)
        return finish(left + "ˌˈpɔɪntˌ" + _en_digit_seq_ipa(frac))
    if not t.isdigit():
        return None
    if len(t) > 1 and t[0] == "0":
        return finish(_en_digit_seq_ipa(t))
    return finish(cardinal(int(t)) or _en_digit_seq_ipa(t))


_EN_OOV_LITERALS = [
    ("tch", "tʃ"), ("dge", "dʒ"), ("tion", "ʃən"), ("sion", "ʒən"),
    ("sure", "ʒɚ"), ("ture", "tʃɚ"), ("ough", "oʊ"), ("augh", "ɔː"),
    ("eigh", "eɪ"), ("igh", "aɪ"), ("oar", "ɔɹ"), ("our", "aʊɹ"),
    ("oor", "ɔɹ"), ("ear", "ɪɹ"), ("eer", "ɪɹ"), ("ier", "ɪɹ"),
    ("air", "ɛɹ"), ("are", "ɛɹ"), ("ire", "aɪɹ"), ("ure", "jʊɹ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("au", "ɔː"), ("aw", "ɔː"),
    ("ea", "iː"), ("ee", "iː"), ("ei", "eɪ"), ("ey", "eɪ"),
    ("eu", "juː"), ("ew", "juː"), ("ie", "iː"), ("oa", "oʊ"),
    ("oe", "oʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("oo", "uː"),
    ("ou", "aʊ"), ("ow", "oʊ"), ("ph", "f"), ("gh", ""),
    ("ng", "ŋ"), ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"),
    ("wh", "w"), ("qu", "kw"), ("ck", "k"), ("sch", "sk"),
    ("ss", "s"), ("ll", "l"), ("mm", "m"), ("nn", "n"),
    ("ff", "f"), ("pp", "p"), ("tt", "t"), ("zz", "z"),
    ("rr", "ɹ"), ("dd", "d"), ("bb", "b"), ("gg", "ɡ"),
]
_EN_FUNCTION_WORDS = {
    "the": "ðə", "a": "ə", "an": "æn", "to": "tə", "of": "əv",
    "and": "ænd", "or": "ɔɹ", "are": "ɑɹ", "was": "wəz", "were": "wɝ",
    "from": "fɹʌm", "have": "hæv", "has": "hæz", "been": "bɪn",
    "do": "du", "does": "dʌz", "your": "jɔɹ", "you": "ju", "they": "ðeɪ",
    "their": "ðɛɹ", "there": "ðɛɹ",
}
_EN_TH_VOICED = {"the", "this", "that", "they", "then", "than", "there",
                 "these", "those"}
_EN_IPA_VOWEL_UNITS = {"æ", "ɛ", "ɪ", "ɔ", "ʊ", "ɑ", "ɒ", "ə", "ɚ", "ɝ",
                       "ɨ", "ʉ", "a", "e", "i", "o", "u", "y"}
_EN_STRESS_VOWEL_PREFIXES = [
    "aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "juː", "iː", "uː", "ɑː", "ɔː", "ɜː",
    "ɛɹ", "ɑɹ", "ɔɹ", "ɪɹ", "ʊɹ", "aɪɹ", "ɪə", "eə", "ʊə", "iə", "ə",
    "ɪ", "ɛ", "æ", "ʌ", "ʊ", "ɑ", "ɔ", "i", "u", "e", "o", "ɚ", "ɝ",
    "ɒ"]


def en_add_primary_stress(s: str) -> str:
    """Insert ˈ before the first vowel unit (english-hand-oov.cpp)."""
    if not s or s.startswith(("ˈ", "ˌ")):
        return s
    # Pattern-priority scan (diphthongs before monophthongs), matching
    # the reference's add_primary_stress_if_missing: the FIRST pattern in
    # the list that occurs anywhere wins, at its earliest occurrence.
    for p in _EN_STRESS_VOWEL_PREFIXES:
        k = s.find(p)
        if k != -1:
            return s[:k] + "ˈ" + s[k:]
    return "ˈ" + s


def _en_magic_e(w: str, vi: int) -> bool:
    if vi < 0 or vi >= len(w) or not w or w[-1] != "e":
        return False
    if len(w) < vi + 3:
        return False
    j = vi + 1
    if j >= len(w) - 1:
        return False
    pen = w[-2]
    if not ("a" <= pen <= "z" and pen not in "aeiouy"):
        return False
    mid = w[j: len(w) - 1]
    if not mid or any(c in "aeiouy" for c in mid):
        return False
    return len(mid) == 1


def english_hand_oov_ipa(word: str) -> str:
    """Hand letter-to-sound fallback (english-hand-oov.cpp), with a
    leading primary stress on the first vowel unit."""
    letters = "".join(c for c in word.lower() if "a" <= c <= "z")
    if not letters:
        return ""
    fw = _EN_FUNCTION_WORDS.get(letters)
    if fw is not None:
        return en_add_primary_stress(fw)
    w = letters
    n = len(w)
    parts: list[str] = []
    i = 0

    def next_vowel_index(start):
        for j in range(start, n):
            if w[j] in "aeiouy":
                return j
        return -1

    while i < n:
        if w[i] == "e" and i == n - 1 and parts:
            i += 1
            continue
        matched = False
        for orth, ipa in _EN_OOV_LITERALS:
            L = len(orth)
            if i + L > n or w[i:i + L] != orth:
                continue
            if orth == "gh":
                if parts and parts[-1] and parts[-1][-1] in \
                        "".join(_EN_IPA_VOWEL_UNITS):
                    i += 2
                    matched = True
                    break
                parts.append("ɡ")
                i += 2
                matched = True
                break
            if orth == "th":
                parts.append("ð" if w in _EN_TH_VOICED else "θ")
                i += 2
                matched = True
                break
            parts.append(ipa)
            i += L
            matched = True
            break
        if matched:
            continue
        c = w[i]
        if c in "aeiouy":
            # r-controlled
            if i + 1 < n and w[i + 1] == "r":
                rc = {"a": "ɑɹ", "e": "ɛɹ", "i": "ɪɹ", "o": "ɔɹ",
                      "u": "ʊɹ", "y": "aɪɹ"}.get(c)
                if rc:
                    parts.append(rc)
                    i += 2
                    continue
            magic = _en_magic_e(w, i)
            nv = next_vowel_index(i + 1)
            closed = False
            if nv >= 0:
                between = w[i + 1: nv]
                closed = bool(between) and not any(
                    ch in "aeiouy" for ch in between)
            elif i + 1 < n and w[i + 1] not in "aeiouy":
                closed = True
            if c == "a":
                parts.append("eɪ" if magic else ("æ" if closed else "ɑː"))
            elif c == "e":
                parts.append("iː" if magic
                             else ("ɛ" if (closed or i == n - 1) else "iː"))
            elif c == "i":
                parts.append("aɪ" if magic else ("ɪ" if closed else "aɪ"))
            elif c == "o":
                parts.append("oʊ" if magic else ("ɒ" if closed else "oʊ"))
            elif c == "u":
                parts.append("juː" if magic else ("ʌ" if closed else "uː"))
            else:  # y
                parts.append("ɪ" if closed else "aɪ")
            i += 1
            continue
        if c == "c":
            nxt = w[i + 1] if i + 1 < n else ""
            parts.append("s" if (nxt and nxt in "eiy") else "k")
        elif c == "g":
            nxt = w[i + 1] if i + 1 < n else ""
            parts.append("dʒ" if (nxt and nxt in "eiy") else "ɡ")
        elif c == "j":
            parts.append("dʒ")
        elif c == "q":
            parts.append("k")
        elif c == "x":
            parts.append("ks")
        elif c == "y":
            parts.append("j" if (i == 0 and next_vowel_index(1) >= 0)
                         else "aɪ")
        elif c == "r":
            parts.append("ɹ")
        else:
            parts.append(c)
        i += 1
    return en_add_primary_stress("".join(parts))


class EnglishG2P:
    """English G2P mirroring the reference's english.cpp flow: numeric
    tokens through the fused cardinal IPA, then the shared in-tree
    10,855-word dictionary, then the neural OOV helper (our trained
    g2p_transformer fills the reference's ONNX OOV slot), then the hand
    letter-to-sound rules — every path emitting a primary stress."""

    def __init__(self, lexicon: dict[str, str] | None = None,
                 baked_dict: dict[str, str] | None = None,
                 oov_predict=None):
        self.lexicon = dict(lexicon or {})
        self.baked_dict = baked_dict or {}
        self.oov_predict = oov_predict

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def word_to_ipa(self, word: str) -> str:
        w = word.strip()
        if not w:
            return ""
        num = english_number_token_ipa(w)
        if num is not None:
            return num
        key = "".join(c for c in w.lower().replace("’", "'")
                      if ("a" <= c <= "z") or c == "'")
        gkey = key.replace("'", "")
        if not gkey:
            return ""
        hit = self.lexicon.get(gkey) or self.lexicon.get(key)
        if hit:
            return en_add_primary_stress(hit)
        # Dict keys KEEP apostrophes (aren't, baby's — g2p_dict_data.h
        # stores contractions/possessives verbatim): exact key first.
        hit = self.baked_dict.get(key) or self.baked_dict.get(gkey)
        if hit:
            return hit
        if self.oov_predict is not None:
            pred = self.oov_predict(gkey)
            if pred:
                return en_add_primary_stress(pred)
        return english_hand_oov_ipa(gkey)


# ---------------------------------------------------------------------------
# Japanese — kana conversion mirroring the reference's
# japanese-kana-to-ipa.cpp + lexicon/segmentation word pipeline
# ---------------------------------------------------------------------------

# Hiragana mora -> (onset, nucleus); longer keys first (the reference's
# kMoraDesc table, japanese-kana-to-ipa.cpp:92-138).
_JA_MORA = [
    ("きゃ", "k", "ja"), ("きゅ", "k", "jɯ"), ("きょ", "k", "jo"),
    ("ぎゃ", "g", "ja"), ("ぎゅ", "g", "jɯ"), ("ぎょ", "g", "jo"),
    ("しゃ", "ɕ", "a"), ("しゅ", "ɕ", "ɯ"), ("しょ", "ɕ", "o"),
    ("じゃ", "dʑ", "a"), ("じゅ", "dʑ", "ɯ"), ("じょ", "dʑ", "o"),
    ("ちゃ", "tɕ", "a"), ("ちゅ", "tɕ", "ɯ"), ("ちょ", "tɕ", "o"),
    ("にゃ", "n", "ja"), ("にゅ", "n", "jɯ"), ("にょ", "n", "jo"),
    ("ひゃ", "ç", "a"), ("ひゅ", "ç", "ɯ"), ("ひょ", "ç", "o"),
    ("びゃ", "b", "ja"), ("びゅ", "b", "jɯ"), ("びょ", "b", "jo"),
    ("ぴゃ", "p", "ja"), ("ぴゅ", "p", "jɯ"), ("ぴょ", "p", "jo"),
    ("みゃ", "m", "ja"), ("みゅ", "m", "jɯ"), ("みょ", "m", "jo"),
    ("りゃ", "ɾ", "ja"), ("りゅ", "ɾ", "jɯ"), ("りょ", "ɾ", "jo"),
    ("ふぁ", "ɸ", "a"), ("ふぃ", "ɸ", "i"), ("ふぇ", "ɸ", "e"),
    ("ふぉ", "ɸ", "o"), ("ふゃ", "ɸ", "ja"), ("ふゅ", "ɸ", "jɯ"),
    ("ふょ", "ɸ", "jo"), ("ヴぁ", "v", "a"), ("ヴぃ", "v", "i"),
    ("ヴぇ", "v", "e"), ("ヴぉ", "v", "o"), ("ヴゃ", "v", "ja"),
    ("ヴゅ", "v", "jɯ"), ("ヴょ", "v", "jo"), ("てぃ", "t", "i"),
    ("てゅ", "t", "jɯ"), ("でぃ", "d", "i"), ("でゅ", "d", "jɯ"),
    ("とぅ", "t", "ɯ"), ("どぅ", "d", "ɯ"), ("つぁ", "ts", "a"),
    ("つぃ", "ts", "i"), ("つぇ", "ts", "e"), ("つぉ", "ts", "o"),
    ("うぃ", "ɰ", "i"), ("うぇ", "ɰ", "e"), ("うぉ", "ɰ", "o"),
    ("あ", "", "a"), ("い", "", "i"), ("う", "", "ɯ"),
    ("え", "", "e"), ("お", "", "o"), ("か", "k", "a"),
    ("き", "k", "i"), ("く", "k", "ɯ"), ("け", "k", "e"),
    ("こ", "k", "o"), ("が", "g", "a"), ("ぎ", "g", "i"),
    ("ぐ", "g", "ɯ"), ("げ", "g", "e"), ("ご", "g", "o"),
    ("さ", "s", "a"), ("す", "s", "ɯ"), ("せ", "s", "e"),
    ("そ", "s", "o"), ("し", "ɕ", "i"), ("ざ", "z", "a"),
    ("ず", "z", "ɯ"), ("ぜ", "z", "e"), ("ぞ", "z", "o"),
    ("じ", "dʑ", "i"), ("た", "t", "a"), ("て", "t", "e"),
    ("と", "t", "o"), ("ち", "tɕ", "i"), ("つ", "ts", "ɯ"),
    ("だ", "d", "a"), ("で", "d", "e"), ("ど", "d", "o"),
    ("ぢ", "dʑ", "i"), ("づ", "dz", "ɯ"), ("な", "n", "a"),
    ("に", "n", "i"), ("ぬ", "n", "ɯ"), ("ね", "n", "e"),
    ("の", "n", "o"), ("は", "h", "a"), ("へ", "h", "e"),
    ("ほ", "h", "o"), ("ひ", "ç", "i"), ("ふ", "ɸ", "ɯ"),
    ("ば", "b", "a"), ("び", "b", "i"), ("ぶ", "b", "ɯ"),
    ("べ", "b", "e"), ("ぼ", "b", "o"), ("ぱ", "p", "a"),
    ("ぴ", "p", "i"), ("ぷ", "p", "ɯ"), ("ぺ", "p", "e"),
    ("ぽ", "p", "o"), ("ま", "m", "a"), ("み", "m", "i"),
    ("む", "m", "ɯ"), ("め", "m", "e"), ("も", "m", "o"),
    ("や", "j", "a"), ("ゆ", "j", "ɯ"), ("よ", "j", "o"),
    ("ら", "ɾ", "a"), ("り", "ɾ", "i"), ("る", "ɾ", "ɯ"),
    ("れ", "ɾ", "e"), ("ろ", "ɾ", "o"), ("わ", "ɰ", "a"),
    ("を", "", "o"), ("ん", "", "ɴ"), ("ぁ", "", "a"),
    ("ぃ", "", "i"), ("ぅ", "", "ɯ"), ("ぇ", "", "e"),
    ("ぉ", "", "o"), ("ゎ", "ɰ", "a"), ("ヴ", "v", "ɯ"),
    ("ゐ", "j", "i"), ("ゑ", "j", "e"),
]
_JA_VOWELS_IPA = set("aeiou") | {"ɯ"}


def _ja_kata_to_hira(s: str) -> str:
    out = []
    for ch in s:
        o = ord(ch)
        if 0x30A1 <= o <= 0x30F6:
            out.append(chr(o - 0x60))
        else:
            out.append(ch)
    return "".join(out)


def kana_to_ipa(text: str) -> str:
    """Kana -> IPA (japanese-kana-to-ipa.cpp katakana_hiragana_to_ipa):
    long-vowel ー extends the last vowel, small っ geminates as
    onset + length mark."""
    s = _ja_kata_to_hira(unicodedata.normalize("NFKC", text.strip()))
    parts: list[str] = []
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "ー":
            if not parts:
                parts.append("ː")
            else:
                last = parts[-1]
                for j in range(len(last), 0, -1):
                    if last[j - 1] in _JA_VOWELS_IPA:
                        parts[-1] = last[:j] + "ː" + last[j:]
                        break
                else:
                    parts[-1] = last + "ː"
            i += 1
            continue
        if ch in ("っ", "ッ"):
            j = i + 1
            for key, onset, nuc in _JA_MORA:
                if s.startswith(key, j):
                    parts.append((onset + "ː" + nuc) if onset else nuc)
                    i = j + len(key)
                    break
            else:
                i = j
            continue
        for key, onset, nuc in _JA_MORA:
            if s.startswith(key, i):
                parts.append(onset + nuc)
                i += len(key)
                break
        else:
            i += 1
    return "".join(parts)


def _ja_is_kanji(c: str) -> bool:
    return 0x4E00 <= ord(c) <= 0x9FFF or c in "々〆ヶ"


def ja_is_kana_only(text: str) -> bool:
    s = _ja_kata_to_hira(unicodedata.normalize("NFKC", text.strip()))
    if not s:
        return False
    for c in s:
        if c in " \t\nーっッ":
            continue
        o = ord(c)
        if 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF:
            continue
        return False
    return True


def _ja_default_readings_path():
    from pathlib import Path

    return (Path(__file__).resolve().parents[2] / "tests" / "data"
            / "g2p_ref" / "ja_readings.tsv")


def _ja_data_path(name: str):
    from pathlib import Path

    return Path(__file__).resolve().parent / "data" / name


def _load_kana_tsv(path) -> dict[str, str]:
    out: dict[str, str] = {}
    if path.is_file():
        for line in path.read_text(encoding="utf-8").splitlines():
            if "\t" in line and not line.startswith("#"):
                k, v = line.split("\t", 1)
                out[k] = v.strip()
    return out


_JA_CORE_CACHE: dict[str, str] | None = None
_JA_ONYOMI_CACHE: dict[str, str] | None = None


def ja_core_lexicon() -> dict[str, str]:
    """Hand-authored word→IPA lexicon (tts/data/ja_core_words.tsv,
    original data; readings stored as kana, converted here)."""
    global _JA_CORE_CACHE
    if _JA_CORE_CACHE is None:
        _JA_CORE_CACHE = {
            k: kana_to_ipa(v)
            for k, v in _load_kana_tsv(
                _ja_data_path("ja_core_words.tsv")).items()
        }
    return _JA_CORE_CACHE


def ja_onyomi_table() -> dict[str, str]:
    """Hand-authored kanji→on'yomi kana (tts/data/ja_onyomi.tsv)."""
    global _JA_ONYOMI_CACHE
    if _JA_ONYOMI_CACHE is None:
        _JA_ONYOMI_CACHE = _load_kana_tsv(_ja_data_path("ja_onyomi.tsv"))
    return _JA_ONYOMI_CACHE


_JA_KANA_ONSET = {}
for _row, _cls in (("かきくけこ", "k"), ("がぎぐげご", "g"),
                   ("さしすせそ", "s"), ("ざじずぜぞ", "z"),
                   ("たちつてと", "t"), ("だぢづでど", "d"),
                   ("はひふへほ", "h"), ("ぱぴぷぺぽ", "p"),
                   ("ばびぶべぼ", "b")):
    for _c in _row:
        _JA_KANA_ONSET[_c] = _cls
_JA_H2P = {"は": "ぱ", "ひ": "ぴ", "ふ": "ぷ", "へ": "ぺ", "ほ": "ぽ"}


def ja_compose_onyomi(readings: list[str]) -> str:
    """Concatenate per-kanji on'yomi with sokuon gemination: a reading
    ending in つ/ち geminates before k/s/t/h/p onsets (はつ+ひょう →
    はっぴょう, with the h-row onset fortified to p); く/き geminate
    before k only (がく+こう → がっこう)."""
    out = ""
    for r in readings:
        if out and r:
            onset = _JA_KANA_ONSET.get(r[0], "")
            last = out[-1]
            if ((last in "つち" and onset in ("k", "s", "t", "h", "p"))
                    or (last in "くき" and onset == "k")):
                out = out[:-1] + "っ"
                if onset == "h":
                    r = _JA_H2P[r[0]] + r[1:]
        out += r
    return out


class JapaneseG2P:
    """Japanese G2P: the reference's kana conversion plus a
    surface->IPA reading lexicon with greedy longest-match segmentation
    standing in for the reference's ONNX LUW segmenter + CDN dict
    (japanese-onnx-g2p.cpp).  The default lexicon is harvested from the
    reference's own shipped wiki corpus by kana-anchored alignment
    (scripts/harvest_ja_readings.py)."""

    def __init__(self, lexicon: dict[str, str] | None = None,
                 use_harvested: bool = True, neural=None,
                 use_core: bool = True, use_onyomi: bool = True,
                 tagger=None):
        """``neural``: optional kanji-reading model (a
        ``G2PTransformer`` or a path to its safetensors artifact,
        trained by train/ja_reader.py) — the backstop for kanji spans
        the lexicon misses, mirroring the reference's ONNX helper tier
        (japanese-tok-pos-onnx.h).  None keeps lexicon+kana only.

        ``use_core``: merge the hand-authored word lexicon
        (tts/data/ja_core_words.tsv) under any corpus-harvested entries
        (harvested readings are corpus-verified and win on key clash).
        ``use_onyomi``: read lexicon-missed kanji runs by per-kanji
        on'yomi composition with sokuon gemination
        (tts/data/ja_onyomi.tsv) before falling to the neural tier."""
        self.lexicon = dict(lexicon or {})
        if use_harvested and not self.lexicon:
            p = _ja_default_readings_path()
            if p.is_file():
                for line in p.read_text(encoding="utf-8").splitlines():
                    if "\t" in line and not line.startswith("#"):
                        k, v = line.split("\t", 1)
                        self.lexicon.setdefault(k, v)
        if use_core:
            for k, v in ja_core_lexicon().items():
                self.lexicon.setdefault(k, v)
        self.onyomi = ja_onyomi_table() if use_onyomi else {}
        if isinstance(neural, (str, _PathType)):
            from .g2p_transformer import G2PTransformer

            neural = G2PTransformer.load(neural)
        self.neural = neural
        # LUW tagger (callable text -> [(surface, UPOS)]): text flows
        # through the reference's exact tagger→merge→per-unit pipeline
        # (JaLuwPipeline) — the wiring of the tok_pos tier into ja G2P
        # (japanese-tok-pos-onnx.h:1).  Default None = the deterministic
        # script-run annotator (best measured self-contained tier);
        # pass a TokPosTagger.annotate or other callable to override,
        # or False to disable the LUW path entirely.
        self._luw = None
        if tagger is None:
            tagger = ja_script_run_annotator
        if tagger is not False:
            self._luw = JaLuwPipeline(self.lexicon, tagger,
                                      char_table=self.onyomi)

    def text_to_ipa(self, text: str) -> str | None:
        """LUW-pipeline whole-text conversion; None when no tagger is
        configured (callers fall back to per-token word_to_ipa)."""
        if self._luw is None:
            return None
        return self._luw.text_to_ipa(text)

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    @staticmethod
    def _is_kana_char(c: str) -> bool:
        o = ord(c)
        return (0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF)

    def word_to_ipa(self, word: str) -> str:
        """Greedy segmentation: longest lexicon match, else maximal kana
        run, else skip; words join with spaces (the reference's LUW
        word spacing)."""
        w = unicodedata.normalize("NFKC", word.strip())
        if not w:
            return ""
        if w in self.lexicon:
            return self.lexicon[w]
        if ja_is_kana_only(w):
            return kana_to_ipa(w)
        out: list[str] = []
        i, n = 0, len(w)
        max_key = min(12, max((len(k) for k in self.lexicon), default=0))
        while i < n:
            hit = None
            for L in range(min(max_key, n - i), 0, -1):
                cand = self.lexicon.get(w[i:i + L])
                if cand is not None:
                    hit = (L, cand)
                    break
            if hit is not None:
                out.append(hit[1])
                i += hit[0]
                continue
            c = w[i]
            if self._is_kana_char(c) or c in "ーっッ":
                j = i
                while j < n and (self._is_kana_char(w[j])
                                 or w[j] in "ーっッ"):
                    # stop a kana run where a lexicon entry begins
                    if j > i and any(
                            w[j:j + L2] in self.lexicon
                            for L2 in range(max_key, 0, -1)):
                        break
                    j += 1
                out.append(kana_to_ipa(w[i:j]))
                i = j
                continue
            if (self.onyomi or self.neural is not None) and _ja_is_kanji(c):
                # Maximal kanji run the lexicon missed (stopping where a
                # lexicon entry begins).  Kanji-run-only spans,
                # deliberately: extending into the trailing hiragana
                # (okurigana) was measured at 28.2% vs 55.9% held-out
                # agreement — particles get swallowed
                # (scripts/eval_ja_neural.py, docs/EVAL.md).
                j = i + 1
                while j < n and _ja_is_kanji(w[j]) and not any(
                        w[j:j + L2] in self.lexicon
                        for L2 in range(max_key, 0, -1)):
                    j += 1
                span = w[i:j]
                # On'yomi composition first — how unseen Sino-Japanese
                # compounds are actually read; neural remains the
                # backstop for kanji outside the authored table.
                if self.onyomi and all(ch in self.onyomi for ch in span):
                    out.append(kana_to_ipa(ja_compose_onyomi(
                        [self.onyomi[ch] for ch in span])))
                elif self.neural is not None:
                    out.append(self._neural_reading(span))
                i = j
                continue
            i += 1
        return " ".join(p for p in out if p)

    def _neural_reading(self, span: str) -> str:
        cache = getattr(self, "_neural_cache", None)
        if cache is None:
            cache = self._neural_cache = {}
        hit = cache.get(span)
        if hit is None:
            hit = cache[span] = self.neural.predict(span)
        return hit
