"""Voxtral TTS input-text sanitizer (host-side, pure Python).

The port's own copy of mlx_audio_tpu/tts/models/voxtral_tts/
text_preprocess.py, kept equal to it (tests/test_torch_voxtral_tts.py
holds the two to the same outputs): markdown flattening, invisible-unicode
strip, English number/currency verbalization (years, decimals, dollar-run
shorthand), parenthetical rewrites, dash folding, terminal punctuation.
No departures.
"""

from __future__ import annotations

import re
from html import unescape
from typing import Optional, Tuple

_INVISIBLE_RE = re.compile(
    "[\u200b\u200e-\u200f\u2028-\u2029\u2060-\u2064"
    "\u00ad\u180e\ufeff\ufff9-\ufffb]")
_LINE_BREAK_RE = re.compile(r"(?:\r\n|\r|\n)+")
_REPEATED_PUNCT_RE = re.compile(r"([!?])\1+")
_ELLIPSIS_RE = re.compile(r"\.{3,}")
_U_HYPHEN_RE = re.compile("[‐‑]")
_DASHES = re.escape("-–−")
_CURRENCY_CHARS = "$€£¥₹¢"
_MULTI_HYPHEN_RE = re.compile(rf"[{_DASHES}]{{2,}}")
_LONE_HYPHEN_RE = re.compile(rf"(?<=\s)[{_DASHES}](?=\s)")
_TERMINAL_PUNCT = ".!?…؟。！？"
_PAREN_RE = re.compile(r"\s*\(([^()]+)\)\s*")
_NUMERIC_PAREN_RE = re.compile(
    r"^\s*[$€£¥₹¢]?\s*[+\-−–]?\d+(?:[.,]\d+)?\s*%?\s*$")

_MD_SUBS = [
    (re.compile(r"```[\s\S]*?```|~~~[\s\S]*?~~~"),
     " Code example omitted. "),
    (re.compile(r"(?i)<br\s*/?>"), " "),
]
_MD_IMAGE_RE = re.compile(r"!\[([^\]]*)\]\(([^)]*)\)")
_MD_LINK_RE = re.compile(r"\[([^\]]+)\]\(([^)]*)\)")
_MD_CODE_RE = re.compile(r"`([^`]+)`")
_MD_LINE_RES = [
    re.compile(r"^\s{0,3}#{1,6}\s*", re.M),
    re.compile(r"^\s*[-*+]\s+", re.M),
    re.compile(r"^\s*\d{1,4}[.)]\s+", re.M),
    re.compile(r"^\s{0,3}>\s?", re.M),
]
_MD_AUTOLINK_RE = re.compile(r"<https?://[^>]+>")
_MD_URL_RE = re.compile(r"https?://\S+")
_MD_TAG_RE = re.compile(r"</?[a-zA-Z][^>]*>")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine"]
_TEENS = ["ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
          "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = {20: "twenty", 30: "thirty", 40: "forty", 50: "fifty",
         60: "sixty", 70: "seventy", 80: "eighty", 90: "ninety"}
_SCALES = ["", "thousand", "million", "billion", "trillion", "quadrillion"]

_TOKEN_RE = re.compile(
    r"(?P<currency>(?P<symbol>[$£€¥₹¢])(?P<amount>\d[\d,]*(?:\.\d+)?))"
    r"|(?P<number>(?<!\w)-?\d[\d,]*(?:\.\d+)?\b)")

_CURRENCY_INFO = {
    "$": ("dollar", "dollars", "cent", "cents"),
    "£": ("pound", "pounds", "penny", "pence"),
    "€": ("euro", "euros", "cent", "cents"),
    "¥": ("yen", "yen", None, None),
    "₹": ("rupee", "rupees", "paise", "paise"),
    "¢": ("cent", "cents", None, None),
}


def _flatten_markdown(text: str) -> str:
    for pat, sub in _MD_SUBS[:1]:
        text = pat.sub(sub, text)
    text = unescape(text)
    text = _MD_SUBS[1][0].sub(" ", text)
    text = _MD_IMAGE_RE.sub(lambda m: m.group(1).strip() or "image", text)
    text = _MD_LINK_RE.sub(lambda m: m.group(1), text)
    text = _MD_AUTOLINK_RE.sub("link", text)
    text = _MD_URL_RE.sub("link", text)
    text = _MD_CODE_RE.sub(lambda m: m.group(1), text)
    for pat in _MD_LINE_RES:
        text = pat.sub("", text)
    return _MD_TAG_RE.sub(" ", text)


def _sub_thousand(n: int, use_and: bool = False) -> str:
    parts = []
    h, rem = n // 100, n % 100
    if h:
        parts.append(f"{_ONES[h]} hundred")
        if rem and use_and:
            parts.append("and")
    if rem:
        if rem < 10:
            parts.append(_ONES[rem])
        elif rem < 20:
            parts.append(_TEENS[rem - 10])
        else:
            t, o = (rem // 10) * 10, rem % 10
            parts.append(f"{_TENS[t]}-{_ONES[o]}" if o else _TENS[t])
    return " ".join(parts) if parts else "zero"


def verbalize_integer(num_str: str, use_and: bool = False) -> str:
    n = int(num_str.replace(",", ""))
    if n == 0:
        return "zero"
    groups = []
    while n > 0:
        groups.append(n % 1000)
        n //= 1000
    if len(groups) > len(_SCALES):
        raise ValueError("integer too large")
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        if groups[gi] == 0:
            continue
        w = _sub_thousand(groups[gi],
                          use_and=use_and and gi == 0 and len(groups) > 1)
        parts.append(f"{w} {_SCALES[gi]}".strip())
    return " ".join(parts)


def verbalize_number(num_str: str, use_and: bool = False) -> str:
    s = num_str.strip()
    if s.startswith("-"):
        return "negative " + verbalize_number(s[1:], use_and)
    if re.fullmatch(r"\d{4}", s):
        y = int(s)
        if 1400 <= y < 2100:
            if y == 2000:
                return "two thousand"
            f2, l2 = y // 100, y % 100
            if y <= 1999:
                if l2 == 0:
                    return f"{verbalize_integer(str(f2), use_and)} hundred"
                return f"{verbalize_integer(str(f2), use_and)} " \
                    f"{_sub_thousand(l2)}"
            if 2001 <= y <= 2009:
                return f"two thousand {_ONES[l2]}"
            if 2010 <= y <= 2099:
                return f"twenty {_sub_thousand(l2)}"
    if re.fullmatch(r"\d[\d,]*", s):
        return verbalize_integer(s, use_and)
    m = re.fullmatch(r"(\d[\d,]*)\.(\d+)", s)
    if m:
        frac = "-".join(_ONES[int(c)] for c in m.group(2))
        return f"{verbalize_integer(m.group(1), use_and)} point {frac}"
    raise ValueError(f"unsupported number: {num_str}")


def _parse_currency(tok: str) -> Tuple[str, int, Optional[str]]:
    m = re.fullmatch(r"([$£€¥₹¢])(\d[\d,]*)(?:\.(\d+))?", tok.strip())
    if not m:
        raise ValueError(f"not a currency amount: {tok}")
    return m.group(1), int(m.group(2).replace(",", "")), m.group(3)


def verbalize_currency(tok: str, use_and: bool = True,
                       short: bool = False) -> str:
    sym, whole, frac = _parse_currency(tok)
    sing, plur, minor_s, minor_p = _CURRENCY_INFO[sym]
    if short and sym != "$":
        short = False

    def decimal_form() -> str:
        unit = sing if whole == 1 else plur
        fr = "-".join(_ONES[int(c)] for c in frac)
        return f"{verbalize_integer(str(whole))} point {fr} {unit}"

    if frac is not None and len(frac) > 2:
        return decimal_form()
    minor = int((frac + "00")[:2]) if frac is not None else None
    if not short:
        words = verbalize_integer(str(whole), use_and)
        unit = sing if whole == 1 else plur
        if sym in {"¥", "¢"}:
            if frac is None or set(frac) == {"0"}:
                return f"{words} {unit}"
            return decimal_form()
        if not minor:
            return f"{words} {unit}"
        m_words = verbalize_integer(str(minor))
        m_unit = minor_s if minor == 1 else minor_p
        if whole == 0:
            return f"{m_words} {m_unit}"
        return f"{words} {unit} and {m_words} {m_unit}"
    if not minor:
        return f"{verbalize_integer(str(whole))} " \
            f"{sing if whole == 1 else plur}"
    if whole == 0:
        return f"{verbalize_integer(str(minor))} " \
            f"{minor_s if minor == 1 else minor_p}"
    if minor <= 9:
        return f"{verbalize_integer(str(whole))} oh {_ONES[minor]}"
    return f"{verbalize_integer(str(whole))} {verbalize_integer(str(minor))}"


def _should_verbalize_plain(tok: str) -> bool:
    s = tok.strip().lstrip("-")
    int_part = s.split(".", 1)[0]
    digits = int_part.replace(",", "")
    if not re.fullmatch(r"\d+", digits):
        return False
    return 1_000_000 <= int(digits) < 1e18 and "," in int_part


def _auto_verbalize(text: str) -> str:
    matches = list(_TOKEN_RE.finditer(text))
    symbols = [m.group("symbol") for m in matches
               if m.group("currency") is not None]
    dollar_run = bool(symbols) and set(symbols) == {"$"} and len(symbols) > 1
    state = {"first_done": False}

    def repl(m: re.Match) -> str:
        if m.group("currency") is not None:
            try:
                short = False
                if dollar_run and m.group("symbol") == "$":
                    short = state["first_done"]
                    state["first_done"] = True
                return verbalize_currency(m.group("currency"),
                                          use_and=True, short=short)
            except (ValueError, IndexError):
                return m.group("currency")
        tok = m.group("number")
        try:
            if not _should_verbalize_plain(tok):
                return tok
            return verbalize_number(tok, use_and=True)
        except (ValueError, IndexError):
            return tok

    return _TOKEN_RE.sub(repl, text)


def _rewrite_parentheticals(text: str) -> str:
    def norm(inner: str) -> str:
        s = inner
        s = re.sub(r"(?i)\bN\s*/\s*A\b", "not available", s)
        s = re.sub(r"\s*(?:\+/-|±)\s*", " plus or minus ", s)
        s = re.sub(r"\s*>=\s*", " greater than or equal to ", s)
        s = re.sub(r"\s*<=\s*", " less than or equal to ", s)
        s = re.sub(r"\s*>\s*", " greater than ", s)
        s = re.sub(r"\s*<\s*", " less than ", s)
        s = re.sub(r"\s*~\s*", " about ", s)
        s = re.sub(r"#\s*(\d+)\b", r"number \1", s)
        s = re.sub(r"(\d+(?:\.\d+)?)\s*ms\b", r"\1 milliseconds", s,
                   flags=re.I)
        s = re.sub(r"(\d+(?:\.\d+)?)\s*h\b", r"\1 hours", s, flags=re.I)
        s = re.sub(r"(\d+(?:\.\d+)?)\s*%", r"\1 percent", s)
        s = re.sub(r"\s*\+\s*", " plus ", s)
        s = re.sub(r"\s*=\s*", " equals ", s)
        return re.sub(r"\s+", " ", s).strip()

    def repl(m: re.Match) -> str:
        inner = m.group(1).strip()
        if not inner or _NUMERIC_PAREN_RE.fullmatch(inner):
            return m.group(0)
        return f"—{norm(inner)}—"

    return _PAREN_RE.sub(repl, text)


def _fold_lone_hyphens(text: str) -> str:
    def repl(m: re.Match) -> str:
        i = m.end()
        while i < len(text) and text[i].isspace():
            i += 1
        if i >= len(text):
            return m.group(0)
        nxt = text[i]
        if nxt.isdigit() or nxt in _CURRENCY_CHARS:
            return m.group(0)
        return "—"

    return _LONE_HYPHEN_RE.sub(repl, text)


def sanitize_tts_input_text_for_demo(text: str) -> str:
    """Normalize text before synthesis (reference text_preprocess.py:391)."""
    raw = text
    text = _flatten_markdown(text)
    text = _INVISIBLE_RE.sub("", text)
    text = _LINE_BREAK_RE.sub(" ", text)
    text = _auto_verbalize(text)
    text = _rewrite_parentheticals(text)
    text = _U_HYPHEN_RE.sub("-", text)
    text = _ELLIPSIS_RE.sub("...", text)
    text = _REPEATED_PUNCT_RE.sub(r"\1", text)
    text = _MULTI_HYPHEN_RE.sub("—", text)
    text = _fold_lone_hyphens(text)
    text = re.sub(r"\s+", " ", text).strip()
    if text and text[-1] not in _TERMINAL_PUNCT:
        text += "."
    if not text:
        raise ValueError(f"Speech input is empty after sanitization, "
                         f"got {raw!r}")
    return text
