"""Per-language number-word expansion for TTS text normalization.

The reference expands digits per language inside its G2P rule sets
(reference: core/moonshine-tts/src/lang-specific/ — e.g.
chinese-numbers.cpp, and number handling inside each language's rules;
micro/g2p number expansion).  Each function emits words in the
orthography that language's G2P engine consumes (kana for ja, hangul for
ko, Devanagari for hi, Arabic script for ar, Cyrillic for ru/uk).

Scope: non-negative cardinals; grammatical agreement is simplified where
a full treatment needs case/gender context (ru/uk thousands use the
feminine forms they govern; ar uses masculine nominative throughout).
"""

from __future__ import annotations

from .text_normalize import number_to_words as _en

# ---------------------------------------------------------------------------
# Romance + Germanic + Turkish + Vietnamese (Latin scripts)
# ---------------------------------------------------------------------------

_ES_ONES = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho",
    "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
    "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
    "veintiséis", "veintisiete", "veintiocho", "veintinueve",
]
_ES_TENS = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta", "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = [
    "", "ciento", "doscientos", "trescientos", "cuatrocientos", "quinientos",
    "seiscientos", "setecientos", "ochocientos", "novecientos",
]


def _es(n: int) -> str:
    if n < 30:
        return _ES_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _ES_TENS[t] + ("" if o == 0 else " y " + _ES_ONES[o])
    if n == 100:
        return "cien"
    if n < 1000:
        h, rest = divmod(n, 100)
        return _ES_HUNDREDS[h] + ("" if rest == 0 else " " + _es(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mil" if k == 1 else _es(k) + " mil"
        return head + ("" if rest == 0 else " " + _es(rest))
    m, rest = divmod(n, 1_000_000)
    head = "un millón" if m == 1 else _es(m) + " millones"
    return head + ("" if rest == 0 else " " + _es(rest))


_PT_ONES = [
    "zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete", "oito",
    "nove", "dez", "onze", "doze", "treze", "catorze", "quinze", "dezesseis",
    "dezessete", "dezoito", "dezenove",
]
_PT_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta", "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = [
    "", "cento", "duzentos", "trezentos", "quatrocentos", "quinhentos",
    "seiscentos", "setecentos", "oitocentos", "novecentos",
]


def _pt(n: int) -> str:
    if n < 20:
        return _PT_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _PT_TENS[t] + ("" if o == 0 else " e " + _PT_ONES[o])
    if n == 100:
        return "cem"
    if n < 1000:
        h, rest = divmod(n, 100)
        return _PT_HUNDREDS[h] + ("" if rest == 0 else " e " + _pt(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mil" if k == 1 else _pt(k) + " mil"
        if rest == 0:
            return head
        joiner = " e " if (rest < 100 or rest % 100 == 0) else " "
        return head + joiner + _pt(rest)
    m, rest = divmod(n, 1_000_000)
    head = "um milhão" if m == 1 else _pt(m) + " milhões"
    return head + ("" if rest == 0 else " e " + _pt(rest))


_IT_ONES = [
    "zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette", "otto",
    "nove", "dieci", "undici", "dodici", "tredici", "quattordici",
    "quindici", "sedici", "diciassette", "diciotto", "diciannove",
]
_IT_TENS = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta", "settanta", "ottanta", "novanta"]


def _it(n: int) -> str:
    if n < 20:
        return _IT_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        tens = _IT_TENS[t]
        if o == 0:
            return tens
        if o in (1, 8):  # vowel elision: ventuno, ventotto
            tens = tens[:-1]
        unit = "tré" if o == 3 else _IT_ONES[o]  # accent in compounds
        return tens + unit
    if n < 1000:
        h, rest = divmod(n, 100)
        head = "cento" if h == 1 else _IT_ONES[h] + "cento"
        return head + ("" if rest == 0 else _it(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mille" if k == 1 else _it(k) + "mila"
        return head + ("" if rest == 0 else _it(rest))
    m, rest = divmod(n, 1_000_000)
    head = "un milione" if m == 1 else _it(m) + " milioni"
    return head + ("" if rest == 0 else " " + _it(rest))


_FR_ONES = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def _fr(n: int) -> str:
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        t, o = divmod(n, 10)
        if o == 1:
            return _FR_TENS[t] + " et un"
        return _FR_TENS[t] + ("" if o == 0 else "-" + _FR_ONES[o])
    if n < 80:  # soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _FR_ONES[n - 60]
    if n < 100:  # quatre-vingts
        if n == 80:
            return "quatre-vingts"
        return "quatre-vingt-" + _FR_ONES[n - 80]
    if n < 1000:
        h, rest = divmod(n, 100)
        head = "cent" if h == 1 else _fr(h) + " cent"
        if rest == 0:
            return head + ("s" if h > 1 else "")
        return head + " " + _fr(rest)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mille" if k == 1 else _fr(k) + " mille"
        return head + ("" if rest == 0 else " " + _fr(rest))
    m, rest = divmod(n, 1_000_000)
    head = "un million" if m == 1 else _fr(m) + " millions"
    return head + ("" if rest == 0 else " " + _fr(rest))


_DE_ONES = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
    "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
    "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig", "siebzig", "achtzig", "neunzig"]


def _de_unit(n: int) -> str:
    # "ein" inside compounds, "eins" standalone.
    return "ein" if n == 1 else _DE_ONES[n]


def _de(n: int) -> str:
    if n < 20:
        return _DE_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        if o == 0:
            return _DE_TENS[t]
        return _de_unit(o) + "und" + _DE_TENS[t]
    if n < 1000:
        h, rest = divmod(n, 100)
        head = _de_unit(h) + "hundert"
        return head + ("" if rest == 0 else _de(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = ("ein" if k == 1 else _de(k)) + "tausend"
        return head + ("" if rest == 0 else _de(rest))
    m, rest = divmod(n, 1_000_000)
    head = "eine Million" if m == 1 else _de(m) + " Millionen"
    return head + ("" if rest == 0 else " " + _de(rest))


_NL_ONES = [
    "nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
    "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
    "zestien", "zeventien", "achttien", "negentien",
]
_NL_TENS = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig", "zeventig", "tachtig", "negentig"]


def _nl(n: int) -> str:
    if n < 20:
        return _NL_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        if o == 0:
            return _NL_TENS[t]
        joiner = "ën" if _NL_ONES[o].endswith("e") else "en"
        return _NL_ONES[o] + joiner + _NL_TENS[t]
    if n < 1000:
        h, rest = divmod(n, 100)
        head = "honderd" if h == 1 else _NL_ONES[h] + "honderd"
        return head + ("" if rest == 0 else _nl(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "duizend" if k == 1 else _nl(k) + "duizend"
        return head + ("" if rest == 0 else " " + _nl(rest))
    m, rest = divmod(n, 1_000_000)
    head = "een miljoen" if m == 1 else _nl(m) + " miljoen"
    return head + ("" if rest == 0 else " " + _nl(rest))


_TR_ONES = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi", "sekiz", "dokuz"]
_TR_TENS = ["", "on", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş", "seksen", "doksan"]


def _tr(n: int) -> str:
    if n < 10:
        return _TR_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TR_TENS[t] + ("" if o == 0 else " " + _TR_ONES[o])
    if n < 1000:
        h, rest = divmod(n, 100)
        head = "yüz" if h == 1 else _TR_ONES[h] + " yüz"
        return head + ("" if rest == 0 else " " + _tr(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "bin" if k == 1 else _tr(k) + " bin"
        return head + ("" if rest == 0 else " " + _tr(rest))
    m, rest = divmod(n, 1_000_000)
    head = _tr(m) + " milyon"
    return head + ("" if rest == 0 else " " + _tr(rest))


_VI_ONES = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy", "tám", "chín"]


def _vi(n: int) -> str:
    if n < 10:
        return _VI_ONES[n]
    if n < 20:
        o = n - 10
        if o == 0:
            return "mười"
        if o == 5:
            return "mười lăm"
        return "mười " + _VI_ONES[o]
    if n < 100:
        t, o = divmod(n, 10)
        out = _VI_ONES[t] + " mươi"
        if o == 0:
            return out
        if o == 1:
            return out + " mốt"
        if o == 4:
            return out + " tư"
        if o == 5:
            return out + " lăm"
        return out + " " + _VI_ONES[o]
    if n < 1000:
        h, rest = divmod(n, 100)
        head = _VI_ONES[h] + " trăm"
        if rest == 0:
            return head
        if rest < 10:
            return head + " lẻ " + _VI_ONES[rest]
        return head + " " + _vi(rest)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = _vi(k) + " nghìn"
        if rest == 0:
            return head
        if rest < 100:
            return head + " không trăm " + (("lẻ " + _VI_ONES[rest]) if rest < 10 else _vi(rest))
        return head + " " + _vi(rest)
    m, rest = divmod(n, 1_000_000)
    head = _vi(m) + " triệu"
    return head + ("" if rest == 0 else " " + _vi(rest))


# ---------------------------------------------------------------------------
# Cyrillic: Russian / Ukrainian (nominative; thousands take feminine forms)
# ---------------------------------------------------------------------------

_RU_ONES = [
    "ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
    "восемь", "девять", "десять", "одиннадцать", "двенадцать",
    "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
    "семнадцать", "восемнадцать", "девятнадцать",
]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def _slavic(n: int, ones, tens, hundreds, thous_forms, fem_one, fem_two) -> str:
    def words(x: int) -> str:
        return _slavic(x, ones, tens, hundreds, thous_forms, fem_one, fem_two)

    if n < 20:
        return ones[n]
    if n < 100:
        t, o = divmod(n, 10)
        return tens[t] + ("" if o == 0 else " " + ones[o])
    if n < 1000:
        h, rest = divmod(n, 100)
        return hundreds[h] + ("" if rest == 0 else " " + words(rest))
    if n < 1_000_000:
        # Thousands agree with the count word: 1 -> fem singular form[0],
        # 2-4 (but not 12-14) -> fem paucal form[1], else genitive form[2].
        k, rest = divmod(n, 1000)
        last2, last1 = k % 100, k % 10
        if last1 in (1, 2, 3, 4) and not 11 <= last2 <= 14:
            unit = {1: fem_one, 2: fem_two}.get(last1, ones[last1])
            form = thous_forms[0] if last1 == 1 else thous_forms[1]
            prefix = words(k - last1) + " " if k - last1 else ""
            head = f"{prefix}{unit} {form}"
        else:
            head = f"{words(k)} {thous_forms[2]}"
        return head + ("" if rest == 0 else " " + words(rest))
    # Millions agree like thousands but are masculine: 1 -> form[3]
    # (singular), 2-4 -> form[4] (paucal), else form[5] (genitive pl).
    m, rest = divmod(n, 1_000_000)
    last2, last1 = m % 100, m % 10
    if last1 == 1 and last2 != 11:
        prefix = words(m - 1) + " " if m > 1 else ""
        head = f"{prefix}{ones[1]} {thous_forms[3]}"
    elif last1 in (2, 3, 4) and not 12 <= last2 <= 14:
        prefix = words(m - last1) + " " if m - last1 else ""
        head = f"{prefix}{ones[last1]} {thous_forms[4]}"
    else:
        head = f"{words(m)} {thous_forms[5]}"
    return head + ("" if rest == 0 else " " + words(rest))


def _ru(n: int) -> str:
    return _slavic(
        n, _RU_ONES, _RU_TENS, _RU_HUNDREDS,
        ("тысяча", "тысячи", "тысяч", "миллион", "миллиона", "миллионов"), "одна", "две",
    )


_UK_ONES = [
    "нуль", "один", "два", "три", "чотири", "п'ять", "шість", "сім",
    "вісім", "дев'ять", "десять", "одинадцять", "дванадцять",
    "тринадцять", "чотирнадцять", "п'ятнадцять", "шістнадцять",
    "сімнадцять", "вісімнадцять", "дев'ятнадцять",
]
_UK_TENS = ["", "", "двадцять", "тридцять", "сорок", "п'ятдесят", "шістдесят", "сімдесят", "вісімдесят", "дев'яносто"]
_UK_HUNDREDS = ["", "сто", "двісті", "триста", "чотириста", "п'ятсот", "шістсот", "сімсот", "вісімсот", "дев'ятсот"]


def _uk(n: int) -> str:
    return _slavic(
        n, _UK_ONES, _UK_TENS, _UK_HUNDREDS,
        ("тисяча", "тисячі", "тисяч", "мільйон", "мільйони", "мільйонів"), "одна", "дві",
    )


# ---------------------------------------------------------------------------
# CJK + Arabic + Hindi (native scripts)
# ---------------------------------------------------------------------------

_JA_ONES = ["ぜろ", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]
_JA_HUNDRED = {1: "ひゃく", 3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"}
_JA_THOUSAND = {1: "せん", 3: "さんぜん", 8: "はっせん"}


def _ja_under_10000(n: int) -> str:
    out = ""
    k, n = divmod(n, 1000)
    if k:
        out += _JA_THOUSAND.get(k, _JA_ONES[k] + "せん")
    h, n = divmod(n, 100)
    if h:
        out += _JA_HUNDRED.get(h, _JA_ONES[h] + "ひゃく")
    t, o = divmod(n, 10)
    if t:
        out += ("じゅう" if t == 1 else _JA_ONES[t] + "じゅう")
    if o:
        out += _JA_ONES[o]
    return out


def _ja(n: int) -> str:
    if n == 0:
        return _JA_ONES[0]
    if n < 10000:
        return _ja_under_10000(n)
    man, rest = divmod(n, 10000)
    head = _ja_under_10000(man) + "まん"
    return head + ("" if rest == 0 else _ja_under_10000(rest))


_KO_ONES = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]


def _ko_under_10000(n: int) -> str:
    out = ""
    for value, name in ((1000, "천"), (100, "백"), (10, "십")):
        d, n = divmod(n, value)
        if d:
            out += ("" if d == 1 else _KO_ONES[d]) + name
    if n:
        out += _KO_ONES[n]
    return out


def _ko(n: int) -> str:
    if n == 0:
        return _KO_ONES[0]
    if n < 10000:
        return _ko_under_10000(n)
    man, rest = divmod(n, 10000)
    head = ("" if man == 1 else _ko_under_10000(man)) + "만"
    return head + ("" if rest == 0 else " " + _ko_under_10000(rest))


def _zh(n: int) -> str:
    from .lang_rules import chinese_number_to_hanzi

    return chinese_number_to_hanzi(str(n))


_AR_ONES = [
    "صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة", "سبعة",
    "ثمانية", "تسعة", "عشرة",
]
_AR_TEENS = [
    "أحد عشر", "اثنا عشر", "ثلاثة عشر", "أربعة عشر", "خمسة عشر",
    "ستة عشر", "سبعة عشر", "ثمانية عشر", "تسعة عشر",
]
_AR_TENS = ["", "", "عشرون", "ثلاثون", "أربعون", "خمسون", "ستون", "سبعون", "ثمانون", "تسعون"]
_AR_HUNDREDS = [
    "", "مئة", "مئتان", "ثلاثمئة", "أربعمئة", "خمسمئة", "ستمئة",
    "سبعمئة", "ثمانمئة", "تسعمئة",
]


def _ar(n: int) -> str:
    # MSA, masculine nominative, units before tens with wa-.
    if n <= 10:
        return _AR_ONES[n]
    if n < 20:
        return _AR_TEENS[n - 11]
    if n < 100:
        t, o = divmod(n, 10)
        if o == 0:
            return _AR_TENS[t]
        return _AR_ONES[o] + " و" + _AR_TENS[t]
    if n < 1000:
        h, rest = divmod(n, 100)
        return _AR_HUNDREDS[h] + ("" if rest == 0 else " و" + _ar(rest))
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        if k == 1:
            head = "ألف"
        elif k == 2:
            head = "ألفان"
        elif k <= 10:
            head = _AR_ONES[k] + " آلاف"
        else:
            head = _ar(k) + " ألف"
        return head + ("" if rest == 0 else " و" + _ar(rest))
    m, rest = divmod(n, 1_000_000)
    head = "مليون" if m == 1 else _ar(m) + " مليون"
    return head + ("" if rest == 0 else " و" + _ar(rest))


# Hindi 0-99 are lexically irregular: full table (Devanagari).
_HI_0_99 = (
    "शून्य एक दो तीन चार पाँच छह सात आठ नौ दस "
    "ग्यारह बारह तेरह चौदह पंद्रह सोलह सत्रह अठारह उन्नीस बीस "
    "इक्कीस बाईस तेईस चौबीस पच्चीस छब्बीस सत्ताईस अट्ठाईस उनतीस तीस "
    "इकतीस बत्तीस तैंतीस चौंतीस पैंतीस छत्तीस सैंतीस अड़तीस उनतालीस चालीस "
    "इकतालीस बयालीस तैंतालीस चवालीस पैंतालीस छियालीस सैंतालीस अड़तालीस उनचास पचास "
    "इक्यावन बावन तिरपन चौवन पचपन छप्पन सत्तावन अट्ठावन उनसठ साठ "
    "इकसठ बासठ तिरसठ चौंसठ पैंसठ छियासठ सड़सठ अड़सठ उनहत्तर सत्तर "
    "इकहत्तर बहत्तर तिहत्तर चौहत्तर पचहत्तर छिहत्तर सतहत्तर अठहत्तर उन्यासी अस्सी "
    "इक्यासी बयासी तिरासी चौरासी पचासी छियासी सतासी अठासी नवासी नब्बे "
    "इक्यानवे बानवे तिरानवे चौरानवे पचानवे छियानवे सत्तानवे अट्ठानवे निन्यानवे"
).split()


def _hi(n: int) -> str:
    if n < 100:
        return _HI_0_99[n]
    if n < 1000:
        h, rest = divmod(n, 100)
        head = _HI_0_99[h] + " सौ"
        return head + ("" if rest == 0 else " " + _hi(rest))
    if n < 100_000:
        k, rest = divmod(n, 1000)
        head = _HI_0_99[k] + " हज़ार" if k < 100 else _hi(k) + " हज़ार"
        return head + ("" if rest == 0 else " " + _hi(rest))
    lakh, rest = divmod(n, 100_000)
    head = _hi(lakh) + " लाख"
    return head + ("" if rest == 0 else " " + _hi(rest))


_FUNCS = {
    "en": _en, "es": _es, "pt": _pt, "it": _it, "fr": _fr, "de": _de,
    "nl": _nl, "tr": _tr, "vi": _vi, "ru": _ru, "uk": _uk, "ja": _ja,
    "ko": _ko, "zh": _zh, "ar": _ar, "hi": _hi,
}

# "<number> percent" per language: (template with {n}, or prefix style).
PERCENT = {
    "en": "{n} percent", "es": "{n} por ciento", "pt": "{n} por cento",
    "it": "{n} per cento", "fr": "{n} pour cent", "de": "{n} Prozent",
    "nl": "{n} procent", "tr": "yüzde {n}", "vi": "{n} phần trăm",
    "ru": "{n} процентов", "uk": "{n} відсотків", "ja": "{n}パーセント",
    "ko": "{n}퍼센트", "zh": "百分之{n}", "ar": "{n} في المئة",
    "hi": "{n} प्रतिशत",
}

MINUS = {
    "en": "minus", "es": "menos", "pt": "menos", "it": "meno", "fr": "moins",
    "de": "minus", "nl": "min", "tr": "eksi", "vi": "âm", "ru": "минус",
    "uk": "мінус", "ja": "マイナス", "ko": "마이너스", "zh": "负",
    "ar": "ناقص", "hi": "ऋण",
}


def supported_number_languages() -> list[str]:
    return sorted(_FUNCS)


def number_to_words_lang(n: int, language: str = "en") -> str:
    """Non-negative (or negative, via the language's minus word) integer ->
    words in the language's G2P orthography.  Unknown languages fall back
    to English."""
    lang = language.split("_")[0].split("-")[0].lower()
    fn = _FUNCS.get(lang, _en)
    if n < 0:
        return MINUS.get(lang, "minus") + " " + fn(-n)
    return fn(n)
