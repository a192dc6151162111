"""Soprano text normalization.

The port's own copy of mlx_audio_tpu/tts/models/soprano/text.py, kept
equal to it (tests/test_torch_soprano.py holds the two to the same
outputs): ASCII fold -> number/dollar/ordinal expansion -> abbreviations ->
special characters -> lowercase -> unknown-character strip -> whitespace
collapse -> punctuation dedup. No departures.
"""

from __future__ import annotations

import re
import unicodedata

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen",
         "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
         "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty",
         "seventy", "eighty", "ninety"]
_ORD = {1: "first", 2: "second", 3: "third", 5: "fifth", 8: "eighth",
        9: "ninth", 12: "twelfth", 20: "twentieth", 30: "thirtieth",
        40: "fortieth", 50: "fiftieth", 60: "sixtieth",
        70: "seventieth", 80: "eightieth", 90: "ninetieth"}


def _num_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + _num_to_words(-n)
    parts = []
    for value, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                        (1000, "thousand"), (100, "hundred")):
        if n >= value:
            parts.append(_num_to_words(n // value) + " " + name)
            n %= value
    if n >= 20:
        word = _TENS[n // 10]
        if n % 10:
            word += " " + _ONES[n % 10]
        parts.append(word)
    elif n > 0:
        parts.append(_ONES[n])
    return " ".join(parts)


def _ordinal_to_words(n: int) -> str:
    if n in _ORD:
        return _ORD[n]
    words = _num_to_words(n)
    last = words.split()[-1]
    if last in _ORD.values():
        return words
    if n % 100 and (n % 100) in _ORD:
        return " ".join(words.split()[:-1] + [_ORD[n % 100]])
    if words.endswith("y"):
        return words[:-1] + "ieth"
    return words + "th"


_ABBREV = [(re.compile(rf"\b{a}\.", re.IGNORECASE), b) for a, b in [
    ("mrs", "misses"), ("mr", "mister"), ("dr", "doctor"),
    ("st", "saint"), ("co", "company"), ("jr", "junior"),
    ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
    ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
    ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
    ("ltd", "limited"), ("col", "colonel"), ("ft", "fort")]]

_SPECIAL = [("%", " percent"), ("&", " and "), ("+", " plus "),
            ("=", " equals "), ("@", " at "), ("#", " number ")]


def _expand_dollars(m: re.Match) -> str:
    value = m.group(1).replace(",", "")
    if "." in value:
        d, c = value.split(".", 1)
        dollars = int(d) if d else 0
        cents = int((c + "0")[:2]) if c else 0
    else:
        dollars, cents = int(value), 0
    out = []
    if dollars:
        out.append(_num_to_words(dollars)
                   + (" dollar" if dollars == 1 else " dollars"))
    if cents:
        out.append(_num_to_words(cents)
                   + (" cent" if cents == 1 else " cents"))
    return " ".join(out) or "zero dollars"


def normalize_numbers(text: str) -> str:
    text = re.sub(r"(\d[\d,]+\d)", lambda m: m.group(0).replace(",", ""),
                  text)
    text = re.sub(r"\$([\d.,]*\d+)", _expand_dollars, text)
    text = re.sub(r"(\d+)(st|nd|rd|th)",
                  lambda m: _ordinal_to_words(int(m.group(1))), text)
    text = re.sub(r"(\d+)\.(\d+)",
                  lambda m: _num_to_words(int(m.group(1))) + " point "
                  + " ".join(_ONES[int(d)] if int(d) else "zero"
                             for d in m.group(2)), text)
    return re.sub(r"\d+", lambda m: _num_to_words(int(m.group(0))), text)


def clean_text(text: str) -> str:
    text = unicodedata.normalize("NFKD", text) \
        .encode("ascii", "ignore").decode()
    text = normalize_numbers(text)
    for rx, rep in _ABBREV:
        text = rx.sub(rep, text)
    for ch, rep in _SPECIAL:
        text = text.replace(ch, rep)
    text = text.lower()
    text = re.sub(r"[^a-z !$%&'*+,\-./0-9<>?_]", "", text)
    text = re.sub(r"[<>/_+]", "", text)
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r" ([.?!,])", r"\1", text).strip()
    text = re.sub(r"\.\.\.+", "...", text)
    text = re.sub(r",+", ",", text)
    text = re.sub(r"[.,]*\.[.,]*", ".", text)
    text = re.sub(r"[.,!]*![.,!]*", "!", text)
    text = re.sub(r"[.,!?]*\?[.,!?]*", "?", text)
    return text
