"""Aligned-token containers + chunk-overlap merge for long-audio ASR.

A copy of mlx_audio_tpu/stt/models/nemo/alignment.py (host code only, no
device work): the containers `AlignedToken`, `AlignedSentence` and
`AlignedResult`, `tokens_to_sentences`, `sentences_to_result`, and the two
merges of neighbouring windows by matching token identities inside the
overlap region:

- ``merge_longest_contiguous``: find the longest run of identical
  (id, ~same start time) tokens shared by both windows; strict — raises
  if the run covers less than half the overlap.
- ``merge_longest_common_subsequence``: classic LCS over the overlap
  (order-preserving, gaps allowed); lenient fallback.

Both fall back to a midpoint cut when the overlap is too thin to match.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

__all__ = [
    "AlignedToken",
    "AlignedSentence",
    "AlignedResult",
    "tokens_to_sentences",
    "sentences_to_result",
    "merge_longest_contiguous",
    "merge_longest_common_subsequence",
]

_SENTENCE_ENDERS = ("!", "?", "。", "？", "！")


@dataclass
class AlignedToken:
    """One decoded token with absolute timing (seconds)."""

    id: int
    text: str
    start: float
    duration: float
    end: float = field(default=0.0)

    def __post_init__(self) -> None:
        self.end = self.start + self.duration


@dataclass
class AlignedSentence:
    """A sentence grouping of tokens, timed by its first/last token."""

    text: str
    tokens: List[AlignedToken]
    start: float = 0.0
    end: float = 0.0
    duration: float = 0.0

    def __post_init__(self) -> None:
        self.tokens = sorted(self.tokens, key=lambda t: t.start)
        self.start = self.tokens[0].start
        self.end = self.tokens[-1].end
        self.duration = self.end - self.start


@dataclass
class AlignedResult:
    """Full transcription: flat text + per-sentence alignments."""

    text: str
    sentences: List[AlignedSentence]

    def __post_init__(self) -> None:
        self.text = self.text.strip()


def _ends_sentence(tokens: List[AlignedToken], idx: int) -> bool:
    text = tokens[idx].text
    if any(ch in text for ch in _SENTENCE_ENDERS):
        return True
    # '.' only ends a sentence at end-of-stream or before a space
    # (guards against decimals/abbreviations mid-word).
    if "." in text:
        return idx == len(tokens) - 1 or " " in tokens[idx + 1].text
    return False


def tokens_to_sentences(tokens: List[AlignedToken]) -> List[AlignedSentence]:
    """Group a flat token stream into punctuation-delimited sentences."""
    sentences: List[AlignedSentence] = []
    current: List[AlignedToken] = []
    for idx, token in enumerate(tokens):
        current.append(token)
        if _ends_sentence(tokens, idx):
            sentences.append(
                AlignedSentence("".join(t.text for t in current), current))
            current = []
    if current:
        sentences.append(
            AlignedSentence("".join(t.text for t in current), current))
    return sentences


def sentences_to_result(sentences: List[AlignedSentence]) -> AlignedResult:
    return AlignedResult("".join(s.text for s in sentences), sentences)


def _overlap_windows(a, b, overlap_duration):
    a_end = a[-1].end
    b_start = b[0].start
    ov_a = [t for t in a if t.end > b_start - overlap_duration]
    ov_b = [t for t in b if t.start < a_end + overlap_duration]
    return ov_a, ov_b


def _midpoint_cut(a, b):
    cutoff = (a[-1].end + b[0].start) / 2
    return [t for t in a if t.end <= cutoff] + [t for t in b if t.start >= cutoff]


def _match_matrix(ov_a, ov_b, tol):
    """Boolean [len_a, len_b] matrix: same id AND starts within tol."""
    ids_a = np.array([t.id for t in ov_a])[:, None]
    ids_b = np.array([t.id for t in ov_b])[None, :]
    st_a = np.array([t.start for t in ov_a])[:, None]
    st_b = np.array([t.start for t in ov_b])[None, :]
    return (ids_a == ids_b) & (np.abs(st_a - st_b) < tol)


def _splice(a, b, ov_a, pairs):
    """Rebuild the merged stream from matched (i, j) index pairs.

    Keeps everything in ``a`` before the first match and in ``b`` after
    the last; for gaps between matches, keeps whichever window decoded
    more tokens (the richer hypothesis).
    """
    a_off = len(a) - len(ov_a)
    idx_a = [a_off + i for i, _ in pairs]
    idx_b = [j for _, j in pairs]

    out = list(a[: idx_a[0]])
    for k in range(len(pairs)):
        out.append(a[idx_a[k]])
        if k + 1 < len(pairs):
            gap_a = a[idx_a[k] + 1: idx_a[k + 1]]
            gap_b = b[idx_b[k] + 1: idx_b[k + 1]]
            out.extend(gap_b if len(gap_b) > len(gap_a) else gap_a)
    out.extend(b[idx_b[-1] + 1:])
    return out


def merge_longest_contiguous(
    a: List[AlignedToken],
    b: List[AlignedToken],
    *,
    overlap_duration: float,
) -> List[AlignedToken]:
    """Merge on the longest contiguous run of matching tokens.

    Raises ``RuntimeError`` when no run covers at least half the overlap
    (caller falls back to :func:`merge_longest_common_subsequence`).
    """
    if not a or not b:
        return a if a else b
    if a[-1].end <= b[0].start:
        return a + b

    ov_a, ov_b = _overlap_windows(a, b, overlap_duration)
    if len(ov_a) < 2 or len(ov_b) < 2:
        return _midpoint_cut(a, b)

    match = _match_matrix(ov_a, ov_b, overlap_duration / 2)
    # DP for the longest diagonal run ending at (i, j).
    run = np.zeros((len(ov_a) + 1, len(ov_b) + 1), dtype=np.int32)
    for i in range(1, len(ov_a) + 1):
        for j in range(1, len(ov_b) + 1):
            if match[i - 1, j - 1]:
                run[i, j] = run[i - 1, j - 1] + 1
    best_len = int(run.max())
    need = len(ov_a) // 2
    if best_len < max(need, 1):
        if best_len == 0:
            return _midpoint_cut(a, b)
        raise RuntimeError(
            f"longest contiguous match {best_len} < required {need}")

    i_end, j_end = np.unravel_index(int(run.argmax()), run.shape)
    pairs = [(i_end - k - 1, j_end - k - 1) for k in range(best_len)][::-1]
    return _splice(a, b, ov_a, pairs)


def merge_longest_common_subsequence(
    a: List[AlignedToken],
    b: List[AlignedToken],
    *,
    overlap_duration: float,
) -> List[AlignedToken]:
    """Merge on the LCS of matching tokens inside the overlap window."""
    if not a or not b:
        return a if a else b
    if a[-1].end <= b[0].start:
        return a + b

    ov_a, ov_b = _overlap_windows(a, b, overlap_duration)
    if len(ov_a) < 2 or len(ov_b) < 2:
        return _midpoint_cut(a, b)

    match = _match_matrix(ov_a, ov_b, overlap_duration / 2)
    n, m = len(ov_a), len(ov_b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(1, n + 1):
        row_m = match[i - 1]
        for j in range(1, m + 1):
            dp[i, j] = (dp[i - 1, j - 1] + 1 if row_m[j - 1]
                        else max(dp[i - 1, j], dp[i, j - 1]))

    pairs = []
    i, j = n, m
    while i > 0 and j > 0:
        if match[i - 1, j - 1] and dp[i, j] == dp[i - 1, j - 1] + 1:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif dp[i - 1, j] >= dp[i, j - 1]:
            i -= 1
        else:
            j -= 1
    if not pairs:
        return _midpoint_cut(a, b)
    pairs.reverse()
    return _splice(a, b, ov_a, pairs)
