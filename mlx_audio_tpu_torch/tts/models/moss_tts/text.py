"""MOSS-TTS prompt-text normalization (host side): a copy of
mlx_audio_tpu/tts/models/moss_tts/text.py (`normalize_tts_text`: control
characters, markdown flattened, URLs, e-mails, handles and file-like
tokens protected, CJK/Latin spacing, structural and repeated punctuation
collapsed), held to it by tests/test_torch_moss_tts.py."""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Tuple

_CJK_CHARS = r"㐀-䶿一-鿿぀-ヿ"
_CJK = f"[{_CJK_CHARS}]"
_PROT = r"___PROT\d+___"

_URL_RE = re.compile(
    r"https?://[^\s　，。！？；、）】"
    r"》〉」』]+")
_EMAIL_RE = re.compile(
    r"(?<![\w.+-])[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}(?![\w.-])")
_MENTION_RE = re.compile(r"(?<![A-Za-z0-9_])@[A-Za-z0-9_]{1,32}")
_REDDIT_RE = re.compile(r"(?<![A-Za-z0-9_])(?:u|r)/[A-Za-z0-9_]+")
_HASHTAG_RE = re.compile(r"(?<![A-Za-z0-9_])#(?!\s)[^\s#]+")
_DOT_TOKEN_RE = re.compile(
    r"(?<![A-Za-z0-9_])\.(?=[A-Za-z0-9._-]*[A-Za-z0-9])[A-Za-z0-9._-]+")
_FILELIKE_RE = re.compile(
    r"(?<![A-Za-z0-9_])"
    r"(?=[A-Za-z0-9._/+:-]*[A-Za-z])"
    r"(?=[A-Za-z0-9._/+:-]*[._/+:-])"
    r"[A-Za-z0-9](?:[A-Za-z0-9._/+:-]*[A-Za-z0-9])?"
    r"(?![A-Za-z0-9_])")
_LATINISH = (rf"(?:{_PROT}|(?=[A-Za-z0-9._/+:-]*[A-Za-z])"
             r"[A-Za-z0-9][A-Za-z0-9._/+:-]*)")
_ZERO_WIDTH_RE = re.compile(r"[​-‍﻿]")

_CJK_CLOSE = ("，。！？；：、”’"
              "」』】）》")
_CJK_OPEN = "（【「『《“‘"
_ARROWS = ("→←↔⇒⇐⇔⟶⟵⟷⟹"
           "⟸⟺↦↤↪↩")


def _base_cleanup(text: str) -> str:
    text = (text.replace("\r\n", "\n").replace("\r", "\n")
            .replace("　", " "))
    text = _ZERO_WIDTH_RE.sub("", text)
    return "".join(
        ch for ch in text
        if ch in "\n\t " or not unicodedata.category(ch).startswith("C"))


def _flatten_markdown(text: str) -> str:
    text = re.sub(r"\[([^\[\]]+?)\]\((https?://[^)\s]+)\)", r"\1 \2", text)
    lines: List[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        line = re.sub(r"^#{1,6}\s+", "", line)
        line = re.sub(r"^>\s+", "", line)
        line = re.sub(r"^[-*+]\s+", "", line)
        line = re.sub(r"^\d+[.)]\s+", "", line)
        lines.append(line)
    return "。".join(lines) if lines else ""


def _protect_spans(text: str) -> Tuple[str, List[str]]:
    saved: List[str] = []

    def stash(m: re.Match) -> str:
        saved.append(m.group(0))
        return f"___PROT{len(saved) - 1}___"

    for pat in (_URL_RE, _EMAIL_RE, _MENTION_RE, _REDDIT_RE, _HASHTAG_RE,
                _DOT_TOKEN_RE, _FILELIKE_RE):
        text = pat.sub(stash, text)
    return text, saved


def _restore_spans(text: str, saved: List[str]) -> str:
    for i, original in enumerate(saved):
        text = text.replace(f"___PROT{i}___", original)
    return text


def _fix_spaces(text: str) -> str:
    text = re.sub(r"[ \t\r\f\v]+", " ", text)
    text = re.sub(rf"({_CJK})\s+(?={_CJK})", r"\1", text)
    text = re.sub(rf"({_CJK})\s+(?=\d)", r"\1", text)
    text = re.sub(rf"(\d)\s+(?={_CJK})", r"\1", text)
    text = re.sub(rf"({_CJK})(?=({_LATINISH}))", r"\1 ", text)
    text = re.sub(rf"(({_LATINISH}))(?={_CJK})", r"\1 ", text)
    text = re.sub(r" {2,}", " ", text)
    text = re.sub(rf"\s+([{_CJK_CLOSE}])", r"\1", text)
    text = re.sub(rf"([{_CJK_OPEN}])\s+", r"\1", text)
    text = re.sub(r"([，。！？；：、])\s*",
                  r"\1", text)
    text = re.sub(r"\s+([,.;!?])", r"\1", text)
    return re.sub(r" {2,}", " ", text).strip()


def _fix_structural_punct(text: str) -> str:
    # 【…】/〖…〗/『…』/「…」 headers at clause starts -> plain text + 。
    for _ in range(2):
        text = re.sub(
            r"(^|[。！？!?；;]\s*)[【〖『「]"
            r"([^】〗』」]+)[】〗』」]\s*",
            "\\1\\2。", text)
    # 《…》 titles standing alone -> unwrapped
    text = re.sub(
        r"(^|[。！？!?；;]\s*)《([^》]+)》"
        r"(?=\s*(?:___PROT\d+___|[—–―-]{2,}|$"
        r"|[。！？!?；;,，]))",
        r"\1\2", text)
    # ASCII/unicode arrows -> ，
    text = re.sub(
        rf"\s*(?:<[-=]+>|[-=]+>|<[-=]+|[{_ARROWS}])\s*", "，", text)
    # long dashes -> 。
    return re.sub(r"\s*(?:—|–|―|-){2,}\s*", "。", text)


def _fix_repeated_punct(text: str) -> str:
    text = re.sub(r"(?:\.{3,}|…{2,}|……+)", "。", text)
    text = re.sub(r"[。．]{2,}", "。", text)
    text = re.sub(r"[，,]{2,}", "，", text)
    text = re.sub(r"[!！]{2,}", "！", text)
    text = re.sub(r"[?？]{2,}", "？", text)

    def collapse(m: re.Match) -> str:
        v = m.group(0)
        q = any(c in v for c in "?？")
        e = any(c in v for c in "!！")
        if q and e:
            return "？！"
        return "？" if q else "！"

    return re.sub(r"[!?！？]{2,}", collapse, text)


def normalize_tts_text(text: Optional[str]) -> Optional[str]:
    """Upstream v1.5 cleanup pipeline (ref text.py:34-47)."""
    if text is None:
        return None
    text = _base_cleanup(str(text))
    text = _flatten_markdown(text)
    text, saved = _protect_spans(text)
    text = _fix_spaces(text)
    text = _fix_structural_punct(text)
    text = _fix_repeated_punct(text)
    text = _fix_spaces(text)
    return _restore_spans(text, saved).strip()


__all__ = ["normalize_tts_text"]
