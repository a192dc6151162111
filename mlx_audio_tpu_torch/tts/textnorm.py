"""English text normalization for TTS frontends.

Spoken-form expansion of numbers, currency, time, units, ordinals,
fractions, decades, phone numbers, IPs, scientific notation, roman
numerals, contractions, plus web-noise stripping (URLs / e-mail / HTML /
hashtags) and whitespace/punctuation cleanup.

The port's own copy of mlx_audio_tpu/tts/textnorm.py, kept equal to it
(the port imports nothing of the JAX package). It covers what upstream
kitten_tts's TextPreprocessor and its expand_* helpers do.
The design here is different: every expansion is a named `_Rule`
(regex + substitution callback) held in an ordered registry, and
`TextNormalizer` simply replays the enabled subset in registry order —
adding a rule is one table entry, and tests can address rules by name.

Used by `tts/g2p.py` (so every G2P-driven family reads "1200" as
"twelve hundred" rather than digit-by-digit) and importable standalone::

    from mlx_audio_tpu_torch.tts.textnorm import TextNormalizer, normalize
    normalize("The 7B model costs $2.5M")   # defaults
    TextNormalizer(roman_numerals=True)("Chapter IV")
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

# --------------------------------------------------------------- spell-out

_SMALL = ("zero one two three four five six seven eight nine ten eleven "
          "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
          "nineteen").split()
_TENS_W = ("_ _ twenty thirty forty fifty sixty seventy eighty "
           "ninety").split()
_GROUPS = ["", " thousand", " million", " billion", " trillion",
           " quadrillion"]
_IRREGULAR_ORD = {"one": "first", "two": "second", "three": "third",
                  "five": "fifth", "eight": "eighth", "nine": "ninth",
                  "twelve": "twelfth"}


def _under_1000(n: int) -> str:
    words: List[str] = []
    if n >= 100:
        words.append(_SMALL[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _TENS_W[n // 10]
        words.append(t + "-" + _SMALL[n % 10] if n % 10 else t)
    elif n:
        words.append(_SMALL[n])
    return " ".join(words)


def num_to_words(n: int) -> str:
    """Integer -> English words. 1200 -> "twelve hundred" (colloquial
    hundreds for 4-digit non-multiples of 1000), -42 -> "negative
    forty-two"."""
    n = int(n)
    if n == 0:
        return "zero"
    if n < 0:
        return "negative " + num_to_words(-n)
    if 100 <= n < 10000 and n % 100 == 0 and n % 1000 and n // 100 < 20:
        return _SMALL[n // 100] + " hundred"
    chunks: List[str] = []
    g = 0
    while n and g < len(_GROUPS):
        n, rest = divmod(n, 1000)
        if rest:
            chunks.append(_under_1000(rest) + _GROUPS[g])
        g += 1
    return " ".join(reversed(chunks))


def decimal_to_words(text: str, point: str = "point") -> str:
    """Numeric string/float -> words; fractional digits read one at a
    time so trailing zeros survive ("1.50" -> "one point five zero")."""
    s = text if isinstance(text, str) else repr(float(text))
    neg = s.startswith("-")
    s = s.lstrip("-")
    if "." not in s:
        out = num_to_words(int(s or "0"))
    else:
        whole, frac = s.split(".", 1)
        digits = " ".join(_SMALL[int(c)] for c in frac if c.isdigit())
        out = f"{num_to_words(int(whole or '0'))} {point} {digits}"
    return ("negative " + out) if neg else out


def _num_str_to_words(raw: str) -> str:
    raw = raw.replace(",", "")
    return decimal_to_words(raw) if "." in raw else num_to_words(int(raw))


def ordinal_words(n: int) -> str:
    """1 -> first, 21 -> twenty-first, 100 -> one hundredth."""
    base = num_to_words(n)
    for sep in ("-", " "):
        head, _, tail = base.rpartition(sep)
        if tail != base:
            return head + sep + _ordinalize(tail)
    return _ordinalize(base)


def _ordinalize(word: str) -> str:
    if word in _IRREGULAR_ORD:
        return _IRREGULAR_ORD[word]
    if word.endswith("y"):                 # twenty -> twentieth
        return word[:-1] + "ieth"
    return word + "th"                     # four/hundred/thousand + th


def roman_value(s: str) -> int:
    """Roman numeral -> int (subtractive notation)."""
    vals = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500,
            "M": 1000}
    total = 0
    run = [vals[c] for c in s.upper()]
    for i, v in enumerate(run):
        total += -v if any(later > v for later in run[i + 1:]) else v
    return total


_DIGIT_NAMES = {str(i): _SMALL[i] for i in range(10)}


def _spell_digits(s: str) -> str:
    return " ".join(_DIGIT_NAMES[c] for c in s if c.isdigit())


# --------------------------------------------------------------- rules

@dataclass(frozen=True)
class _Rule:
    name: str
    pattern: re.Pattern
    sub: Callable[[re.Match], str]
    default: bool = True

    def __call__(self, text: str) -> str:
        return self.pattern.sub(self.sub, text)


_CURRENCY = {"$": "dollar", "€": "euro", "£": "pound", "¥": "yen",
             "₹": "rupee", "₩": "won", "₿": "bitcoin"}
_MAGNITUDE = {"K": "thousand", "M": "million", "B": "billion",
              "T": "trillion"}
_UNITS = {"km": "kilometers", "kg": "kilograms", "mg": "milligrams",
          "ml": "milliliters", "gb": "gigabytes", "mb": "megabytes",
          "kb": "kilobytes", "tb": "terabytes", "hz": "hertz",
          "khz": "kilohertz", "mhz": "megahertz", "ghz": "gigahertz",
          "mph": "miles per hour", "kph": "kilometers per hour",
          "ms": "milliseconds", "ns": "nanoseconds",
          "µs": "microseconds", "°c": "degrees Celsius",
          "c°": "degrees Celsius", "°f": "degrees Fahrenheit",
          "f°": "degrees Fahrenheit"}
_DECADE_NAMES = {0: "hundreds", 1: "tens", 2: "twenties", 3: "thirties",
                 4: "forties", 5: "fifties", 6: "sixties",
                 7: "seventies", 8: "eighties", 9: "nineties"}
_ROMAN_CONTEXT = re.compile(
    r"(?:war|chapter|part|volume|act|scene|book|section|article|king|"
    r"queen|pope|louis|henry|edward|george|william|james|phase|round|"
    r"level|stage|class|type|version|episode|season)\s*\Z",
    re.IGNORECASE)


def _currency_sub(m: re.Match) -> str:
    unit = _CURRENCY.get(m.group(1), "")
    raw = m.group(2).replace(",", "")
    mag = m.group(3)
    if mag:
        return (f"{_num_str_to_words(raw)} {_MAGNITUDE[mag]} "
                f"{unit}s").strip()
    if "." in raw:
        whole, frac = raw.split(".", 1)
        cents = int(frac[:2].ljust(2, "0"))
        spoken = f"{num_to_words(int(whole or '0'))} {unit}s"
        if cents:
            spoken += (f" and {num_to_words(cents)} "
                       f"cent{'s' if cents != 1 else ''}")
        return spoken
    n = int(raw)
    plural = "s" if n != 1 else ""
    return f"{num_to_words(n)} {unit}{plural}"


def _time_sub(m: re.Match) -> str:
    h, mins = int(m.group(1)), int(m.group(2))
    ampm = (" " + m.group(4).lower()) if m.group(4) else ""
    hw = num_to_words(h)
    if mins == 0:
        return f"{hw}{ampm}" if ampm else f"{hw} hundred"
    pad = "oh " if mins < 10 else ""
    return f"{hw} {pad}{num_to_words(mins)}{ampm}"


def _fraction_sub(m: re.Match) -> str:
    num, den = int(m.group(1)), int(m.group(2))
    if den == 0:
        return m.group(0)
    one = num == 1
    if den == 2:
        part = "half" if one else "halves"
    elif den == 4:
        part = "quarter" if one else "quarters"
    else:
        part = ordinal_words(den) + ("" if one else "s")
    return f"{num_to_words(num)} {part}"


def _decade_sub(m: re.Match) -> str:
    head = int(m.group(1))
    name = _DECADE_NAMES[head % 10]
    return name if head < 10 else f"{num_to_words(head // 10)} {name}"


def _roman_sub_factory(full_text_ref: List[str]) -> Callable:
    def _sub(m: re.Match) -> str:
        token = m.group(0)
        if not token:
            return token
        if len(token) == 1 and token in "IVX":
            before = full_text_ref[0][max(0, m.start() - 30): m.start()]
            if not _ROMAN_CONTEXT.search(before):
                return token
        try:
            v = roman_value(token)
        except KeyError:
            return token
        return num_to_words(v) if v else token
    return _sub


def _sci_sub(m: re.Match) -> str:
    coeff, exp = m.group(1), int(m.group(2))
    sign = "negative " if exp < 0 else ""
    return (f"{_num_str_to_words(coeff)} times ten to the "
            f"{sign}{num_to_words(abs(exp))}")


def _phone_sub(m: re.Match) -> str:
    return " ".join(_spell_digits(g) for g in m.groups())


def _number_sub(m: re.Match) -> str:
    try:
        return _num_str_to_words(m.group(0))
    except (ValueError, OverflowError):
        return m.group(0)


# Ordered registry — order is the application order and mirrors the
# dependency notes in reference preprocess.py:948-995 (IPs before
# leading-decimal fixup, currency/percent/sci before bare numbers,
# phone before ranges, units before bare magnitude suffixes).
_REGISTRY: List[_Rule] = [
    _Rule("html", re.compile(r"<[^>]+>"), lambda m: " "),
    _Rule("urls", re.compile(r"https?://\S+|www\.\S+"), lambda m: ""),
    _Rule("emails",
          re.compile(r"\b[\w.+-]+@[\w-]+\.[a-z]{2,}\b", re.IGNORECASE),
          lambda m: ""),
    _Rule("hashtags", re.compile(r"#\w+"), lambda m: "", default=False),
    _Rule("mentions", re.compile(r"@\w+"), lambda m: "", default=False),
    _Rule("contractions_fixed",
          re.compile(r"\b(can't|won't|shan't|ain't|let's|it's)\b",
                     re.IGNORECASE),
          lambda m: {"can't": "cannot", "won't": "will not",
                     "shan't": "shall not", "ain't": "is not",
                     "let's": "let us",
                     "it's": "it is"}[m.group(1).lower()]),
    _Rule("contractions_suffix",
          re.compile(r"\b(\w+)(n't|'re|'ve|'ll|'d|'m)\b", re.IGNORECASE),
          lambda m: m.group(1) + {"n't": " not", "'re": " are",
                                  "'ve": " have", "'ll": " will",
                                  "'d": " would",
                                  "'m": " am"}[m.group(2).lower()]),
    _Rule("ip_addresses",
          re.compile(r"\b(\d{1,3})\.(\d{1,3})\.(\d{1,3})\.(\d{1,3})\b"),
          lambda m: " dot ".join(_spell_digits(g) for g in m.groups())),
    _Rule("leading_decimals", re.compile(r"(?<!\d)(-?)\.(\d)"),
          lambda m: f"{m.group(1)}0.{m.group(2)}"),
    _Rule("currency",
          re.compile(r"([$€£¥₹₩₿])\s*([\d,]+(?:\.\d+)?)\s*([KMBT])?"
                     r"(?![a-zA-Z\d])"),
          _currency_sub),
    _Rule("percent", re.compile(r"(-?[\d,]+(?:\.\d+)?)\s*%"),
          lambda m: _num_str_to_words(m.group(1)) + " percent"),
    _Rule("scientific",
          re.compile(r"(?<![a-zA-Z\d])(-?\d+(?:\.\d+)?)[eE]([+-]?\d+)"
                     r"(?![a-zA-Z\d])"),
          _sci_sub),
    _Rule("time",
          re.compile(r"\b(\d{1,2}):(\d{2})(?::(\d{2}))?\s*(am|pm)?\b",
                     re.IGNORECASE),
          _time_sub),
    _Rule("ordinals", re.compile(r"\b(\d+)(?:st|nd|rd|th)\b",
                                 re.IGNORECASE),
          lambda m: ordinal_words(int(m.group(1)))),
    _Rule("units",
          re.compile(r"(\d+(?:\.\d+)?)\s*"
                     r"(km|kg|mg|ml|gb|mb|kb|tb|hz|khz|mhz|ghz|mph|kph"
                     r"|°[cCfF]|[cCfF]°|ms|ns|µs)\b", re.IGNORECASE),
          lambda m: (f"{_num_str_to_words(m.group(1))} "
                     f"{_UNITS.get(m.group(2).lower(), m.group(2))}")),
    _Rule("magnitude",
          re.compile(r"(?<![a-zA-Z])(\d+(?:\.\d+)?)\s*([KMBT])"
                     r"(?![a-zA-Z\d])"),
          lambda m: (f"{_num_str_to_words(m.group(1))} "
                     f"{_MAGNITUDE[m.group(2)]}")),
    _Rule("fractions", re.compile(r"\b(\d+)\s*/\s*(\d+)\b"),
          _fraction_sub),
    _Rule("decades", re.compile(r"\b(\d{1,3})0s\b"), _decade_sub),
    _Rule("phones_11",
          re.compile(r"(?<!\d-)(?<!\d)\b(\d{1,2})-(\d{3})-(\d{3})-"
                     r"(\d{4})\b(?!-\d)"),
          _phone_sub),
    _Rule("phones_10",
          re.compile(r"(?<!\d-)(?<!\d)\b(\d{3})-(\d{3})-(\d{4})\b"
                     r"(?!-\d)"),
          _phone_sub),
    _Rule("phones_7",
          re.compile(r"(?<!\d-)\b(\d{3})-(\d{4})\b(?!-\d)"), _phone_sub),
    _Rule("ranges", re.compile(r"(?<!\w)(\d+)-(\d+)(?!\w)"),
          lambda m: (f"{num_to_words(int(m.group(1)))} to "
                     f"{num_to_words(int(m.group(2)))}")),
    _Rule("model_names",
          re.compile(r"\b([a-zA-Z][a-zA-Z0-9]*)-(\d[\d.]*)(?=[^\d.]|$)"),
          lambda m: f"{m.group(1)} {m.group(2)}"),
    _Rule("roman_numerals",
          re.compile(r"\b(M{0,4})(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})"
                     r"(IX|IV|V?I{0,3})\b"),
          None, default=False),           # bound per-call (needs text)
    _Rule("numbers",
          re.compile(r"(?<![a-zA-Z])-?[\d,]+(?:\.\d+)?"), _number_sub),
]

_RULES: Dict[str, _Rule] = {r.name: r for r in _REGISTRY}

# Post-numeric cleanup stages (not regex-table rules).
_PUNCT = re.compile(r"[^\w\s]")
_WS = re.compile(r"\s+")


def strip_accents(text: str) -> str:
    decomposed = unicodedata.normalize("NFD", text)
    return "".join(c for c in decomposed
                   if unicodedata.category(c) != "Mn")


_STOPWORDS = frozenset(
    "a an the and or but in on at to for of with by from is was are "
    "were be been being have has had do does did will would could "
    "should may might this that these those it its i me my we our you "
    "your he she him her they them their".split())


class TextNormalizer:
    """Replays the enabled rule subset in registry order, then applies
    the cleanup stages.  Flags mirror reference TextPreprocessor
    (preprocess.py:894-933); rule names match `_REGISTRY`."""

    def __init__(self, *, lowercase: bool = True,
                 numbers: bool = True,
                 contractions: bool = True,
                 hashtags: bool = False, mentions: bool = False,
                 roman_numerals: bool = False,
                 punctuation: bool = True,
                 stopwords: bool = False,
                 stopword_set: Optional[set] = None,
                 accents: bool = False,
                 unicode_form: Optional[str] = "NFC",
                 **rule_overrides: bool):
        enabled = {r.name: r.default for r in _REGISTRY}
        enabled["numbers"] = numbers
        enabled["contractions_fixed"] = contractions
        enabled["contractions_suffix"] = contractions
        enabled["hashtags"] = hashtags
        enabled["mentions"] = mentions
        enabled["roman_numerals"] = roman_numerals
        for name, on in rule_overrides.items():
            if name not in enabled:
                raise ValueError(f"unknown textnorm rule: {name!r}")
            enabled[name] = on
        self.enabled = enabled
        self.lowercase = lowercase
        self.punctuation = punctuation
        self.stopwords = stopwords
        self.stopword_set = stopword_set or _STOPWORDS
        self.accents = accents
        self.unicode_form = unicode_form

    def __call__(self, text: str) -> str:
        if self.unicode_form:
            text = unicodedata.normalize(self.unicode_form, text)
        for rule in _REGISTRY:
            if not self.enabled[rule.name]:
                continue
            if rule.name == "roman_numerals":
                holder = [text]
                text = rule.pattern.sub(_roman_sub_factory(holder), text)
            else:
                text = rule(text)
        if self.accents:
            text = strip_accents(text)
        if self.punctuation:
            text = _PUNCT.sub(" ", text)
        if self.lowercase:
            text = text.lower()
        if self.stopwords:
            text = " ".join(w for w in text.split()
                            if w.lower() not in self.stopword_set)
        return _WS.sub(" ", text).strip()


_DEFAULT = None


def normalize(text: str) -> str:
    """Module-level default pipeline (shared instance)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TextNormalizer()
    return _DEFAULT(text)


def normalize_for_g2p(text: str) -> str:
    """Variant for G2P frontends: keeps punctuation/case (the phoneme
    vocab carries prosodic punctuation) but expands all numeric forms."""
    global _G2P_NORM
    if _G2P_NORM is None:
        _G2P_NORM = TextNormalizer(lowercase=False, punctuation=False,
                                   contractions=False)
    return _G2P_NORM(text)


_G2P_NORM = None

__all__ = ["TextNormalizer", "normalize", "normalize_for_g2p",
           "num_to_words", "decimal_to_words", "ordinal_words",
           "roman_value", "strip_accents"]
