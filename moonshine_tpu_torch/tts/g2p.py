"""Grapheme-to-phoneme engine (IPA output).

Capability mirror of the reference's from-scratch MoonshineG2P (reference:
core/moonshine-tts/src/moonshine-g2p.{h,cpp} + lang-specific rules +
lexicons): per-language engines behind one registry, lexicon lookup first,
rule-based letter-to-sound fallback, with the reference's API shape
(``text_to_ipa``).  English ships a compact context-sensitive rule set
plus optional CMUdict-format lexicon loading; Spanish ships as the
near-phonemic second language; other languages register engines as their
rule sets land.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from .text_normalize import normalize_text

# ARPABET -> IPA (for CMUdict-format lexicons).
ARPA_TO_IPA = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɝ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}


def load_cmudict_lexicon(path: str | Path) -> dict[str, str]:
    """CMUdict format -> {word: ipa} (stress digits dropped, first variant)."""
    lex: dict[str, str] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith(";;;") or not line.strip():
                continue
            parts = line.split()
            word = parts[0].lower()
            if "(" in word:  # alternate pronunciations: keep the first
                continue
            phones = []
            ok = True
            for p in parts[1:]:
                base = re.sub(r"\d", "", p)
                ipa = ARPA_TO_IPA.get(base)
                if ipa is None:
                    ok = False
                    break
                phones.append(ipa)
            if ok:
                lex[word] = "".join(phones)
    return lex


@dataclass
class G2PResult:
    ipa: str
    words: list[tuple[str, str]] = field(default_factory=list)  # (word, ipa)


class RuleG2P:
    """Ordered context-sensitive rewrite rules over a word.

    Each rule is (pattern, ipa): pattern is a regex anchored at the cursor;
    the longest/first match wins.  '#' in patterns marks word edges.
    """

    def __init__(self, rules: list[tuple[str, str]], lexicon: dict[str, str] | None = None):
        self.lexicon = dict(lexicon or {})
        # Pre-compile, preserving order.
        self._rules = [(re.compile(p), ipa) for p, ipa in rules]

    def add_lexicon(self, lexicon: dict[str, str]) -> None:
        self.lexicon.update(lexicon)

    def word_to_ipa(self, word: str) -> str:
        w = word.lower()
        if w in self.lexicon:
            return self.lexicon[w]
        text = "#" + w + "#"
        i = 1  # skip leading '#'
        out: list[str] = []
        while i < len(text) - 1:
            matched = False
            for pat, ipa in self._rules:
                m = pat.match(text, i)
                if m and m.end() > i:
                    out.append(ipa)
                    i = m.end()
                    matched = True
                    break
            if not matched:
                i += 1  # unpronounceable byte: skip
        return "".join(out)



# ---- Spanish (near-phonemic orthography) ----------------------------------


# ---- French -----------------------------------------------------------


# ---- German ------------------------------------------------------------


# ---- Italian -----------------------------------------------------------


# ---- Portuguese --------------------------------------------------------

_PT_RULES: list[tuple[str, str]] = [
    (r"lh", "ʎ"), (r"nh", "ɲ"), (r"ch", "ʃ"), (r"qu(?=[ei])", "k"),
    (r"gu(?=[ei])", "ɡ"), (r"ç", "s"), (r"c(?=[ei])", "s"),
    (r"g(?=[ei])", "ʒ"), (r"j", "ʒ"), (r"h", ""),
    (r"ão(?=#)", "ɐ̃w̃"), (r"õe", "õj̃"), (r"ã", "ɐ̃"),
    (r"ou", "o"), (r"ei", "ej"), (r"s(?=#)", "ʃ"),
    (r"á", "a"), (r"â", "ɐ"), (r"é", "ɛ"), (r"ê", "e"), (r"í", "i"),
    (r"ó", "ɔ"), (r"ô", "o"), (r"ú", "u"),
    (r"x", "ʃ"), (r"z(?=#)", "ʃ"), (r"z", "z"),
    # nasal vowels before m/n + consonant (gente, campo, onde, um)
    (r"am(?=[pbctdgfsvqk])", "ɐ̃"), (r"an(?=[pbctdgfsvqk])", "ɐ̃"),
    (r"em(?=[pbctdgfsvqk]|#)", "ẽ"), (r"en(?=[pbctdgfsvqk])", "ẽ"),
    (r"im(?=[pbctdgfsvqk]|#)", "ĩ"), (r"in(?=[pbctdgfsvqk])", "ĩ"),
    (r"om(?=[pbctdgfsvqk]|#)", "õ"), (r"on(?=[pbctdgfsvqk])", "õ"),
    (r"um(?=[pbctdgfsvqk]|#)", "ũ"), (r"un(?=[pbctdgfsvqk])", "ũ"),
    (r"rr", "ʁ"),
    # single r: tap between vowels and finally, guttural at word start
    # (lookbehind sees INPUT graphemes, hence the orthographic vowels)
    (r"(?<=[aeiouãõáâéêíóôú])r(?=[aeiou])", "ɾ"),
    (r"r(?=#)", "ɾ"), (r"r", "ʁ"),
    # unstressed final vowels reduce (filho -> fiʎu, gente -> ʒẽti)
    (r"o(?=s?#)", "u"), (r"e(?=s?#)", "i"),
    (r"a", "a"), (r"e", "e"), (r"i", "i"), (r"o", "o"), (r"u", "u"),
    (r"b", "b"), (r"c", "k"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"),
    (r"k", "k"), (r"l", "l"), (r"m", "m"), (r"n", "n"), (r"p", "p"),
    (r"s", "s"), (r"t", "t"), (r"v", "v"), (r"w", "w"), (r"y", "i"),
]

_PUNCT_PAUSE = {".": "‖", "!": "‖", "?": "‖", ",": "|", ";": "|", ":": "|"}


def _tokenize_words(text: str) -> list[str]:
    """Words (letters/digits + COMBINING MARKS + apostrophe) and pause
    punctuation.  ``\\w`` alone drops category-M marks, which shreds any
    script that writes vowels as combining signs (Devanagari matras,
    virama, Arabic harakat, decomposed Latin accents)."""
    import unicodedata as _ud

    toks: list[str] = []
    cur: list[str] = []

    def flush():
        if cur:
            t = "".join(cur).strip("-")
            if t:
                toks.append(t)
            cur.clear()

    for i, ch in enumerate(text):
        if ch in "'-" or _ud.category(ch)[0] in ("L", "M", "N"):
            cur.append(ch)
        elif (ch in ".," and cur and cur[-1].isdigit()
              and i + 1 < len(text) and text[i + 1].isdigit()):
            # decimal point / thousands comma INSIDE a number (3.14,
            # 1,000) stays in the token — engines with numeral readers
            # (ko 삼점일사, korean-numbers.cpp:189-284) need it intact
            cur.append(ch)
        else:
            flush()
            if ch in ".,!?;:":
                toks.append(ch)
    flush()
    return toks


class GraphemeToPhonemizer:
    """Public G2P API (reference binding: GraphemeToPhonemizer;
    C ABI: moonshine-c-api.h:1140-1184)."""

    def __init__(
        self,
        language: str = "en",
        lexicon_path: str | None = None,
        oov_model=None,
        use_baked_dict: bool = True,
    ):
        """``oov_model``: a trained ``G2PTransformer`` (or a path to its
        safetensors artifact) consulted for words the lexicon misses —
        the neural-helper slot of the reference's G2P (reference:
        lang-specific/g2p-transformer-model.h, english-hand-oov.h).
        Lexicon hits always stay exact; rules remain the fallback when
        no model is given.

        ``use_baked_dict``: for English, consult the shipped 10,855-word
        real-pronunciation dictionary (tts/g2p_dict.py; reference:
        micro/g2p/src/g2p_dict_data.h) after the hand lexicon and before
        the neural/rule fallbacks.  Loads lazily; silently empty when the
        artifact is not mounted."""
        self.language = language
        self.engine = _make_engine(language)
        if lexicon_path:
            self.engine.add_lexicon(load_cmudict_lexicon(lexicon_path))
        if isinstance(oov_model, (str, Path)):
            from .g2p_transformer import G2PTransformer

            oov_model = G2PTransformer.load(oov_model)
        self.oov_model = oov_model
        self.baked_dict: dict[str, str] = {}
        if use_baked_dict and language.startswith("en"):
            from .g2p_dict import load_baked_dict

            self.baked_dict = load_baked_dict()
        if language.startswith("en") and hasattr(self.engine, "baked_dict"):
            # The English engine owns the reference's dict-first flow
            # (english.cpp text_to_ipa: numbers -> dict -> OOV model ->
            # hand rules).
            self.engine.baked_dict = self.baked_dict
            if oov_model is not None:
                self.engine.oov_predict = oov_model.predict

    def text_to_ipa(self, text: str, with_pauses: bool = True) -> str:
        # Engines owning a whole-text pipeline (ja LUW tagger flow,
        # lang_rules.JaLuwPipeline) take precedence; None = fall through
        # to the per-token path.
        eng_full = getattr(self.engine, "text_to_ipa", None)
        if eng_full is not None:
            full = eng_full(text)
            if full is not None:
                return full
        normalized = normalize_text(text, self.language)
        tokens = _tokenize_words(normalized)
        words = [t for t in tokens if t not in _PUNCT_PAUSE]
        out: list[str] = []
        wi = 0
        prev_word: str | None = None  # last WORD (liaison spans punctuation,
        prev_word_idx = -1            # mirroring the reference's word list)
        liaison = getattr(self.engine, "liaison_pair", None)
        for token in tokens:
            if token in _PUNCT_PAUSE:
                if with_pauses and out:
                    out.append(_PUNCT_PAUSE[token])
                continue
            ipa = None
            if self.language.startswith("en"):
                from .lang_rules import resolve_heteronym

                prev_w = words[wi - 1] if wi > 0 else ""
                next_w = words[wi + 1] if wi + 1 < len(words) else ""
                ipa = resolve_heteronym(token, prev_w, next_w)
            if ipa is None:
                ipa = self.word_to_ipa(token)
            if (liaison is not None and prev_word is not None
                    and prev_word_idx >= 0 and ipa):
                out[prev_word_idx] = liaison(
                    prev_word, out[prev_word_idx], token, ipa)
            wi += 1
            if ipa:
                out.append(ipa)
                prev_word = token
                prev_word_idx = len(out) - 1
        return " ".join(out)

    def word_to_ipa(self, word: str) -> str:
        w = word.lower()
        if hasattr(self.engine, "baked_dict"):
            # dict-first engines (English) own the full fallback chain.
            return self.engine.word_to_ipa(word)
        if w not in self.engine.lexicon:
            if self.baked_dict:
                from .g2p_dict import normalize_word_key

                hit = self.baked_dict.get(normalize_word_key(w))
                if hit:
                    return hit
            if self.oov_model is not None:
                ipa = self.oov_model.predict(w)
                if ipa:
                    return ipa
        return self.engine.word_to_ipa(word)


def _lang_engine(name: str) -> Callable[[], "RuleG2P"]:
    def make():
        from . import lang_rules as lr

        return {
            "ru": lambda: lr.RussianG2P(),
            "uk": lambda: lr.UkrainianG2P(),
            "tr": lambda: lr.TurkishG2P(),
            "nl": lambda: lr.DutchG2P(),
            "vi": lambda: lr.VietnameseG2P(),
            "hi": lambda: lr.DevanagariG2P(),
            "ar": lambda: lr.ArabicG2P(),
            "ja": lambda: lr.JapaneseG2P(),
            "ko": lambda: lr.HangulG2P(),
            "zh": lambda: lr.PinyinG2P(),
        }[name]()

    return make


_ENGINES: dict[str, Callable[[], RuleG2P]] = {
    "en": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["EnglishG2P"]
    ).EnglishG2P(),
    "es": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["SpanishG2P"]
    ).SpanishG2P("es-MX"),
    "fr": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["FrenchG2P"]
    ).FrenchG2P(),
    "de": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["GermanG2P"]
    ).GermanG2P(),
    "it": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["ItalianG2P"]
    ).ItalianG2P(),
    "pt": lambda: __import__(
        "moonshine_tpu_torch.tts.lang_rules", fromlist=["PortugueseG2P"]
    ).PortugueseG2P(is_portugal=False),
    # The reference's remaining ten languages (reference:
    # core/moonshine-tts/src/lang-specific/) — rules in tts/lang_rules.py.
    **{k: _lang_engine(k) for k in ("ru", "uk", "tr", "nl", "vi", "hi", "ar", "ja", "ko", "zh")},
}

SUPPORTED_LANGUAGES = tuple(sorted(_ENGINES))


def _make_engine(language: str) -> RuleG2P:
    norm = language.lower().replace("-", "_")
    if norm in ("pt_pt", "pt_portugal"):
        from .lang_rules import PortugueseG2P

        return PortugueseG2P(is_portugal=True)
    if norm.startswith("es_") and norm != "es_419":
        from .lang_rules import SpanishG2P

        return SpanishG2P(norm)
    if norm == "es_419":
        from .lang_rules import SpanishG2P

        return SpanishG2P("es-419")
    factory = _ENGINES.get(language.split("_")[0].split("-")[0])
    if factory is None:
        raise ValueError(
            f"G2P language {language!r} not available; supported: {SUPPORTED_LANGUAGES}"
        )
    return factory()
