"""Text normalization for TTS: numbers, ordinals, currency, abbreviations.

Capability mirror of the reference's text-normalize stage (reference:
core/moonshine-tts/src/text-normalize.*): expand everything the G2P rules
can't pronounce into plain words before phonemization.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"), (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

ABBREVIATIONS = {
    "mr": "mister", "mrs": "missus", "ms": "miz", "dr": "doctor",
    "st": "saint", "prof": "professor", "jr": "junior", "sr": "senior",
    "vs": "versus", "etc": "et cetera", "e.g": "for example",
    "i.e": "that is", "hon": "honorable", "gen": "general",
    "rev": "reverend", "capt": "captain", "sgt": "sergeant",
    "lt": "lieutenant", "col": "colonel", "dept": "department",
    "ave": "avenue", "blvd": "boulevard", "rd": "road",
}


def number_to_words(n: int) -> str:
    """Integer -> English words (cardinal)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + ("" if o == 0 else " " + _ONES[o])
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if last in _ORDINAL_SPECIAL:
        parts[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    elif last.endswith("t"):
        parts[-1] = last + "h"
    else:
        parts[-1] = last + "th"
    return " ".join(parts)


def year_to_words(n: int) -> str:
    """1984 -> nineteen eighty four; 2005 -> two thousand five."""
    if 1000 <= n <= 1999 or (2100 <= n <= 9999 and n % 100):
        head, rest = divmod(n, 100)
        if rest == 0:
            return number_to_words(head) + " hundred"
        if rest < 10:
            return number_to_words(head) + " oh " + number_to_words(rest)
        return number_to_words(head) + " " + number_to_words(rest)
    return number_to_words(n)


def decimal_to_words(s: str) -> str:
    int_part, _, frac = s.partition(".")
    out = number_to_words(int(int_part)) if int_part else "zero"
    if frac:
        out += " point " + " ".join(_ONES[int(d)] for d in frac)
    return out


_CURRENCY = {"$": ("dollar", "cent"), "£": ("pound", "penny"), "€": ("euro", "cent")}


def _expand_currency(m: re.Match) -> str:
    sym, amount = m.group(1), m.group(2)
    unit, sub = _CURRENCY[sym]
    if "." in amount:
        whole, _, frac = amount.partition(".")
        frac = (frac + "0")[:2]
        w, f = int(whole or 0), int(frac)
        out = []
        if w or not f:
            out.append(number_to_words(w) + " " + (unit if w == 1 else unit + "s"))
        if f:
            if out:
                out.append("and")
            out.append(number_to_words(f) + " " + (sub if f == 1 else sub + "s"))
        return " ".join(out)
    n = int(amount.replace(",", ""))
    return number_to_words(n) + " " + (unit if n == 1 else unit + "s")


def _expand_number_token(m: re.Match) -> str:
    s = m.group(0)
    if re.fullmatch(r"[12]\d{3}", s):
        return year_to_words(int(s))
    s_plain = s.replace(",", "")
    if "." in s_plain:
        return decimal_to_words(s_plain)
    return number_to_words(int(s_plain))


def normalize_text(text: str, language: str = "en") -> str:
    """Expand digits/symbols/abbreviations into speakable words.

    English gets the full treatment (currency, ordinals, clock times,
    years, decimals, abbreviations); every other supported language
    expands cardinals and percentages in its own orthography via
    :mod:`number_words` (reference: per-language number rules in
    core/moonshine-tts/src/lang-specific/, e.g. chinese-numbers.cpp).
    """
    lang = language.split("_")[0].split("-")[0].lower()
    if lang in ("de", "es", "fr", "it", "ko", "nl", "pt", "ru", "tr", "uk"):
        # These engines expand numerals themselves with the reference's
        # exact wording: Korean attaches counters to the last sino speech
        # unit (1986년 → 천 / 구백 / 팔십육년, korean.cpp:926-1001);
        # Portuguese uses the reference's "mil e oitocentos" phrasing
        # (portuguese.cpp:228-250); Russian uses the reference's
        # gender-aware thousands forms (russian-numbers.cpp); German
        # compounds (einundzwanzig).  Only the percent SIGN is rewritten
        # here (digits stay for the engine).
        from .number_words import PERCENT

        pct = PERCENT.get(lang, PERCENT["en"])
        t = re.sub(r"(\d[\d,]*)\s?[%％]",
                   lambda m: " " + pct.format(n=m.group(1)) + " ", text)
        # Percent-prefix orthography (Turkish %50).
        t = re.sub(r"[%％]\s?(\d[\d,]*)",
                   lambda m: " " + pct.format(n=m.group(1)) + " ", t)
        return re.sub(r"\s+", " ", t).strip()
    if lang != "en":
        from .number_words import PERCENT, number_to_words_lang

        t = text
        pct = PERCENT.get(lang, PERCENT["en"])
        t = re.sub(
            r"(\d[\d,]*)\s?[%％]",
            lambda m: " "
            + pct.format(n=number_to_words_lang(int(m.group(1).replace(",", "")), lang))
            + " ",
            t,
        )
        t = re.sub(
            r"\d[\d,]*",
            lambda m: " " + number_to_words_lang(int(m.group(0).replace(",", "")), lang) + " ",
            t,
        )
        return re.sub(r"\s+", " ", t).strip()
    t = text
    t = re.sub(r"([$£€])\s?(\d[\d,]*(?:\.\d+)?)", _expand_currency, t)
    t = re.sub(r"(\d+)\s?%", lambda m: number_to_words(int(m.group(1))) + " percent", t)
    t = re.sub(r"(\d+)(st|nd|rd|th)\b", lambda m: ordinal_to_words(int(m.group(1))), t)
    # Times like 3:30
    t = re.sub(
        r"\b(\d{1,2}):(\d{2})\b",
        lambda m: number_to_words(int(m.group(1)))
        + (
            " o'clock"
            if m.group(2) == "00"
            else (" oh " if int(m.group(2)) < 10 else " ") + number_to_words(int(m.group(2)))
        ),
        t,
    )
    # Plain cardinals stay as digits: the English engine renders them
    # with the reference's fused stressed IPA (english-numbers.cpp).
    # Abbreviations followed by a period ("Dr. Smith" -> "doctor Smith").
    def abbr(m: re.Match) -> str:
        return ABBREVIATIONS[m.group(1).lower()]

    t = re.sub(
        r"\b(" + "|".join(re.escape(a) for a in sorted(ABBREVIATIONS, key=len, reverse=True)) + r")\.",
        abbr,
        t,
        flags=re.IGNORECASE,
    )
    t = t.replace("&", " and ").replace("+", " plus ").replace("@", " at ")
    t = re.sub(r"\s+", " ", t).strip()
    return t
