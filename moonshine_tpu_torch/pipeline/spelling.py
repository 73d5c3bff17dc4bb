"""Alphanumeric spelling matcher + smart-router fusion.

Python port with identical semantics to the reference C++ (reference:
core/spelling-fusion.{h,cpp}, core/spelling-fusion-data.cpp — itself a
port of the binding's alphanumeric_listener.py): classify an utterance as
CHARACTER / STOPPED / CLEAR / UNDO / NONE, then fuse with an optional
spelling-CNN prediction using the smart-router defaults
(disagree_threshold 0.5, weak_homonym_override_threshold 0.3).

A copy of the JAX package's ``pipeline/spelling.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from ..models.spelling import SpellingPrediction


class SpellingMatchType(Enum):
    NONE = "none"
    CHARACTER = "character"
    STOPPED = "stopped"
    CLEAR = "clear"
    UNDO = "undo"


@dataclass
class SpellingMatch:
    type: SpellingMatchType = SpellingMatchType.NONE
    character: str = ""

    @property
    def is_character(self) -> bool:
        return self.type == SpellingMatchType.CHARACTER

    @property
    def is_recognized(self) -> bool:
        return self.type != SpellingMatchType.NONE


DISAGREE_THRESHOLD = 0.5
WEAK_HOMONYM_OVERRIDE_THRESHOLD = 0.3

# ---- static vocabulary (reference: spelling-fusion-data.cpp:43-345) ------

_LETTERS = {
    "a": "a", "ay": "a", "hey": "a", "aye": "a",
    "b": "b", "bee": "b",
    "c": "c", "see": "c", "sea": "c",
    "d": "d", "dee": "d",
    "e": "e",
    "f": "f", "ef": "f", "eff": "f",
    "g": "g", "gee": "g",
    "h": "h", "aitch": "h", "haitch": "h",
    "i": "i", "eye": "i",
    "j": "j", "jay": "j",
    "k": "k", "kay": "k", "okay": "k", "ok": "k",
    "l": "l", "el": "l", "ell": "l",
    "m": "m", "em": "m",
    "n": "n", "en": "n", "and": "n",
    "o": "o", "oh": "o",
    "p": "p", "pee": "p",
    "q": "q", "queue": "q", "cue": "q",
    "r": "r", "are": "r", "ar": "r", "ah": "r", "uh-huh": "r", "aww": "r", "awe": "r",
    "s": "s", "es": "s", "ess": "s",
    "t": "t", "tee": "t",
    "u": "u", "you": "u",
    "v": "v", "vee": "v",
    "w": "w", "double u": "w", "double you": "w",
    "x": "x", "ex": "x",
    "y": "y", "why": "y", "wye": "y",
    "z": "z", "zee": "z", "zed": "z", "zet": "z",
}
_NATO = {
    "alpha": "a", "alfa": "a", "bravo": "b", "charlie": "c", "delta": "d",
    "echo": "e", "foxtrot": "f", "fox trot": "f", "golf": "g", "hotel": "h",
    "india": "i", "juliet": "j", "juliett": "j", "kilo": "k", "lima": "l",
    "mike": "m", "november": "n", "oscar": "o", "papa": "p", "quebec": "q",
    "romeo": "r", "sierra": "s", "tango": "t", "uniform": "u", "victor": "v",
    "whiskey": "w", "whisky": "w", "x-ray": "x", "xray": "x", "x ray": "x",
    "yankee": "y", "zulu": "z",
}
_DIGITS = {
    "zero": "0", "0": "0",
    "one": "1", "won": "1", "1": "1",
    "two": "2", "to": "2", "too": "2", "2": "2",
    "three": "3", "3": "3",
    "four": "4", "for": "4", "4": "4",
    "five": "5", "5": "5",
    "six": "6", "6": "6",
    "seven": "7", "7": "7",
    "eight": "8", "ate": "8", "8": "8",
    "nine": "9", "niner": "9", "9": "9",
}
_SPECIALS = {
    "period": ".", "dot": ".", "full stop": ".", "point": ".",
    "comma": ",", "colon": ":", "semicolon": ";", "semi colon": ";",
    "exclamation mark": "!", "exclamation point": "!", "exclamation": "!", "bang": "!",
    "question mark": "?",
    "open parenthesis": "(", "left parenthesis": "(", "open paren": "(", "left paren": "(",
    "close parenthesis": ")", "right parenthesis": ")", "close paren": ")", "right paren": ")",
    "open bracket": "[", "left bracket": "[", "close bracket": "]", "right bracket": "]",
    "open brace": "{", "left brace": "{", "open curly": "{", "left curly": "{",
    "close brace": "}", "right brace": "}", "close curly": "}", "right curly": "}",
    "at sign": "@", "at": "@", "at symbol": "@",
    "hash": "#", "hashtag": "#", "pound sign": "#", "number sign": "#", "pound": "#",
    "dollar sign": "$", "dollar": "$",
    "percent": "%", "percent sign": "%", "per cent": "%",
    "caret": "^", "carrot": "^", "hat": "^",
    "ampersand": "&", "and sign": "&",
    "asterisk": "*", "star": "*",
    "hyphen": "-", "dash": "-", "minus": "-",
    "underscore": "_", "under score": "_",
    "plus": "+", "plus sign": "+",
    "equals": "=", "equal sign": "=", "equals sign": "=",
    "pipe": "|", "vertical bar": "|",
    "backslash": "\\", "back slash": "\\",
    "forward slash": "/", "slash": "/",
    "tilde": "~", "grave": "`", "backtick": "`", "back tick": "`",
    "apostrophe": "'", "single quote": "'",
    "quote": '"', "double quote": '"', "quotation mark": '"',
    "space": " ",
}
_DROP_CHARS = ".,!?\"'" + "\u2018\u2019\u201c\u201d"


def spelling_normalize(text: str) -> str:
    """Lowercase, strip punctuation/quotes, collapse whitespace
    (reference: spelling-fusion.cpp spelling_normalize)."""
    out = []
    for ch in text:
        if ch in _DROP_CHARS:
            continue
        out.append(ch.lower())
    return " ".join("".join(out).split())


# Tables are normalized at build time, same as the reference's build_set/
# build_lookup (reference: spelling-fusion-data.cpp:15-39), so apostrophe
# keys like "that's it" match the normalized runtime text "thats it".


def _norm_keys(d: dict[str, str]) -> dict[str, str]:
    return {spelling_normalize(k): v for k, v in d.items()}


def _norm_set(s: set[str]) -> set[str]:
    return {spelling_normalize(k) for k in s}


LOOKUP: dict[str, str] = _norm_keys({**_LETTERS, **_NATO, **_DIGITS, **_SPECIALS})

UPPER_MODIFIERS = _norm_set({"upper case", "uppercase", "upper", "capital", "cap", "big", "shift"})
_UPPER_BY_LEN = sorted(UPPER_MODIFIERS, key=len, reverse=True)
UNDO_WORDS = _norm_set({"undo", "delete", "backspace", "back space", "erase", "scratch that", "remove"})
CLEAR_WORDS = _norm_set({"clear", "clear all", "reset", "start over"})
STOP_WORDS = _norm_set({
    "stop", "end", "finish", "finished", "done", "complete", "that's it",
    "submit", "confirm", "i'm done", "all done", "go", "enter",
})
WEAK_HOMONYMS = _norm_set({"okay", "ok", "you"})

_ONES = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
         "seven": 7, "eight": 8, "nine": 9}
_TEENS = {"ten": 10, "eleven": 11, "twelve": 12, "thirteen": 13, "fourteen": 14,
          "fifteen": 15, "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19}
_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
         "seventy": 70, "eighty": 80, "ninety": 90}


def parse_number_words(text: str) -> Optional[int]:
    """English number phrases 10-1000 (reference: cpp:86-180)."""
    words = [w for w in text.replace("-", " ").split() if w != "and"]
    if not words:
        return None
    if words[0] == "a":
        words[0] = "one"
    result = 0
    i = 0
    if i < len(words) and words[i] in _ONES and i + 1 < len(words) and words[i + 1] == "hundred":
        result += _ONES[words[i]] * 100
        i += 2
    if i == 0 and words and words[0] == "hundred":
        result += 100
        i += 1
    if i < len(words) and words[i] in _ONES and i + 1 < len(words) and words[i + 1] == "thousand":
        if _ONES[words[i]] == 1:
            result += 1000
            i += 2
            if i == len(words):
                return result
        return None
    if i == 0 and words and words[0] == "thousand":
        result += 1000
        i += 1
        if i == len(words):
            return result
        return None
    if i < len(words) and words[i] in _TEENS:
        result += _TEENS[words[i]]
        i += 1
    elif i < len(words) and words[i] in _TENS:
        result += _TENS[words[i]]
        i += 1
        if i < len(words) and words[i] in _ONES:
            result += _ONES[words[i]]
            i += 1
    elif i < len(words) and words[i] in _ONES:
        result += _ONES[words[i]]
        i += 1
    if i != len(words):
        return None
    if result < 10 or result > 1000:
        return None
    return result


_CONNECTORS = (" as in ", " is for ", " like ", " for ")


class SpellingMatcher:
    """Utterance -> CHARACTER/STOPPED/CLEAR/UNDO/NONE.

    Mirrors the reference's ``AlphanumericMatcher`` construction surface
    (reference: alphanumeric_listener.py:512-567): ``custom_words`` takes
    highest priority over the built-in vocabulary, and the three
    ``accept_*`` flags filter resolved characters by class (a character
    the filter rejects is reported as NONE, exactly as if it had never
    matched).  Default construction shares the module-level table.
    """

    def __init__(
        self,
        *,
        custom_words: Optional[dict[str, str]] = None,
        accept_letters: bool = True,
        accept_digits: bool = True,
        accept_specials: bool = True,
    ):
        if custom_words:
            lookup = dict(LOOKUP)
            for spoken, char in custom_words.items():
                key = spelling_normalize(spoken)
                if key:
                    lookup[key] = char
            self._lookup = lookup
        else:
            self._lookup = LOOKUP
        self._accept_letters = accept_letters
        self._accept_digits = accept_digits
        self._accept_specials = accept_specials

    def _char_accepted(self, char: str) -> bool:
        if not char:
            return False
        if char.isdigit():
            return self._accept_digits
        if char.isalpha():
            return self._accept_letters
        return self._accept_specials

    def classify(self, raw_text: str) -> SpellingMatch:
        text = spelling_normalize(raw_text)
        if not text:
            return SpellingMatch()
        if text in STOP_WORDS:
            return SpellingMatch(SpellingMatchType.STOPPED)
        if text in CLEAR_WORDS:
            return SpellingMatch(SpellingMatchType.CLEAR)
        if text in UNDO_WORDS:
            return SpellingMatch(SpellingMatchType.UNDO)

        make_upper = False
        for mod in _UPPER_BY_LEN:
            prefix = mod + " "
            if len(text) > len(prefix) and text.startswith(prefix):
                text = text[len(prefix):].lstrip(" ")
                make_upper = True
                break
            if text == mod:
                return SpellingMatch()  # bare modifier, not a hit

        resolved = self._resolve(text)
        if not resolved:
            return SpellingMatch()
        if not self._char_accepted(resolved):
            return SpellingMatch()
        if make_upper and len(resolved) == 1 and resolved.isalpha():
            resolved = resolved.upper()
        return SpellingMatch(SpellingMatchType.CHARACTER, resolved)

    def classify_sequence(self, raw_text: str) -> list[SpellingMatch]:
        """Classify a potentially multi-token utterance.

        Whole-utterance classification wins when it recognizes anything;
        otherwise multi-token text falls back to per-token classification
        so "h o m e" resolves to four CHARACTER matches.  Order is
        preserved and the list stops after the first STOPPED (reference:
        alphanumeric_listener.py:606-634).
        """
        whole = self.classify(raw_text)
        if whole.is_recognized:
            return [whole]
        if not raw_text:
            return [SpellingMatch()]
        tokens = raw_text.replace("-", " ").split()
        if len(tokens) <= 1:
            return [SpellingMatch()]
        results: list[SpellingMatch] = []
        for tok in tokens:
            m = self.classify(tok)
            results.append(m)
            if m.type == SpellingMatchType.STOPPED:
                break
        return results

    def is_weak_homonym(self, raw_text: str) -> bool:
        return spelling_normalize(raw_text) in WEAK_HOMONYMS

    def _resolve(self, text: str) -> Optional[str]:
        if text in self._lookup:
            return self._lookup[text]
        spelled = self._resolve_spelled_letter(text)
        if spelled is not None:
            return spelled
        num = parse_number_words(text)
        if num is not None:
            return str(num)
        if text.isdigit():
            return text
        if len(text) == 1 and 0x20 <= ord(text) < 0x7F:
            return text
        return None

    def _resolve_spelled_letter(self, text: str) -> Optional[str]:
        """"A as in Alpha" / "B for Bravo" patterns (reference: cpp:326-365)."""
        for connector in _CONNECTORS:
            idx = text.find(connector)
            if idx <= 0:
                continue
            left = text[:idx].strip()
            right = text[idx + len(connector):].strip()
            if not left or not right:
                continue
            left_char = self._lookup.get(left)
            if left_char is None or len(left_char) != 1 or not left_char.isalpha():
                continue
            right_words = right.split()
            if len(right_words) != 1:
                continue
            if right_words[0][:1].lower() != left_char.lower():
                continue
            return left_char
        return None


def letters_only_matcher(**kwargs) -> SpellingMatcher:
    """Matcher that reports digits/specials as NONE (reference: :716)."""
    return SpellingMatcher(accept_digits=False, accept_specials=False, **kwargs)


def digits_only_matcher(**kwargs) -> SpellingMatcher:
    """Matcher that reports letters/specials as NONE (reference: :720)."""
    return SpellingMatcher(accept_letters=False, accept_specials=False, **kwargs)


# TTS-friendly spoken names for echoing recognized characters back to the
# user (reference: alphanumeric_listener.py:306-330 ``spoken_form``).
# Letter sounds are spelled phonetically so the synthesizer says the
# letter name rather than reading a one-letter word.
_SPELL_OUT_LETTERS = {
    "a": "ay", "b": "bee", "c": "see", "d": "dee", "e": "ee", "f": "eff",
    "g": "gee", "h": "haitch", "i": "eye", "j": "jay", "k": "kay",
    "l": "ell", "m": "em", "n": "en", "o": "oh", "p": "pee", "q": "cue",
    "r": "are", "s": "ess", "t": "tee", "u": "you", "v": "vee",
    "w": "double you", "x": "ex", "y": "why", "z": "zee",
}
_SPELL_OUT_DIGITS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}
_SPELL_OUT_SYMBOLS = {
    ".": "period", ",": "comma", ":": "colon", ";": "semicolon",
    "!": "exclamation mark", "?": "question mark",
    "(": "open parenthesis", ")": "close parenthesis",
    "[": "open bracket", "]": "close bracket",
    "{": "open brace", "}": "close brace",
    "@": "at sign", "#": "hash", "$": "dollar sign", "%": "percent",
    "^": "caret", "&": "ampersand", "*": "asterisk", "-": "dash",
    "_": "underscore", "+": "plus", "=": "equals", "|": "pipe",
    "\\": "backslash", "/": "slash", "~": "tilde", "`": "backtick",
    "'": "apostrophe", '"': "quote", " ": "space",
}


def spoken_form(char: str) -> str:
    """TTS-friendly phrase for one character: letters use their spelling
    sound ("h" -> "haitch"), upper case prefixes "capital ", digits and
    symbols use their word form; anything else passes through unchanged
    so callers never lose information silently."""
    if not isinstance(char, str) or len(char) != 1:
        return char
    if char.isalpha():
        token = _SPELL_OUT_LETTERS.get(char.lower(), char.lower())
        if char.isupper():
            token = f"capital {token}"
        return token
    if char in _SPELL_OUT_DIGITS:
        return _SPELL_OUT_DIGITS[char]
    if char in _SPELL_OUT_SYMBOLS:
        return _SPELL_OUT_SYMBOLS[char]
    return char


@dataclass
class FusedResult:
    type: SpellingMatchType = SpellingMatchType.NONE
    character: str = ""

    @property
    def is_character(self) -> bool:
        return self.type == SpellingMatchType.CHARACTER


def _is_letters(s: str) -> bool:
    return bool(s) and all("a" <= c.lower() <= "z" for c in s)


def _is_digits(s: str) -> bool:
    return bool(s) and s.isdigit()


def _apply_case(ch: str, hint: str) -> str:
    if len(ch) == 1 and ch.isalpha() and len(hint) == 1 and hint.isalpha() and hint.isupper():
        return ch.upper()
    return ch


def fuse_default(
    raw_text: str,
    match: SpellingMatch,
    prediction: Optional[SpellingPrediction],
    matcher: SpellingMatcher,
) -> FusedResult:
    """Smart-router fusion (reference: spelling-fusion.cpp fuse_default)."""
    if match.type in (SpellingMatchType.STOPPED, SpellingMatchType.CLEAR, SpellingMatchType.UNDO):
        return FusedResult(match.type)

    asr_char = match.character if match.type == SpellingMatchType.CHARACTER else None

    if (
        asr_char is not None
        and prediction is not None
        and prediction.probability >= WEAK_HOMONYM_OVERRIDE_THRESHOLD
        and matcher.is_weak_homonym(raw_text)
    ):
        asr_char = None

    if prediction is None:
        if asr_char is not None:
            return FusedResult(SpellingMatchType.CHARACTER, asr_char)
        return FusedResult()
    if asr_char is None:
        return FusedResult(SpellingMatchType.CHARACTER, prediction.character)

    if (asr_char.lower() if _is_letters(asr_char) else asr_char) == (
        prediction.character.lower() if _is_letters(prediction.character) else prediction.character
    ):
        return FusedResult(SpellingMatchType.CHARACTER, asr_char)

    asr_digit = _is_digits(asr_char)
    spell_digit = _is_digits(prediction.character)
    if asr_digit and not spell_digit:
        return FusedResult(SpellingMatchType.CHARACTER, asr_char)
    if spell_digit and not asr_digit:
        return FusedResult(SpellingMatchType.CHARACTER, prediction.character)

    if prediction.probability >= DISAGREE_THRESHOLD:
        return FusedResult(
            SpellingMatchType.CHARACTER, _apply_case(prediction.character, asr_char)
        )
    return FusedResult(SpellingMatchType.CHARACTER, asr_char)
