"""Word-error-rate with per-operation counts.

The port's copy of mlx_audio_tpu/stt/eval/wer.py (no departure). Parity:
reference mlx_audio/stt/eval/wer.py:36 (compute_wer) and :99
(aggregate_wer). Deterministic tie-break between equal-cost edit paths:
fewer total edits, then fewer insertions, then fewer deletions, then fewer
substitutions — so sub/del/ins splits are reproducible across runs.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Iterable, List, Tuple, Union


@dataclass(frozen=True)
class WERResult:
    substitutions: int
    deletions: int
    insertions: int
    reference_tokens: int
    hypothesis_tokens: int
    wer: float

    @property
    def edits(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    def to_dict(self) -> dict:
        d = asdict(self)
        d["edits"] = self.edits
        return d


# DP cell: (cost, subs, dels, ins). Ordering key for tie-breaks.
_Cell = Tuple[int, int, int, int]


def _key(c: _Cell) -> Tuple[int, int, int, int]:
    cost, subs, dels, ins = c
    return (cost, ins, dels, subs)


def compute_wer(reference: Union[str, Iterable[str]],
                hypothesis: Union[str, Iterable[str]]) -> WERResult:
    """Levenshtein alignment over whitespace tokens (or pre-tokenized lists)."""
    ref = reference.split() if isinstance(reference, str) else list(reference)
    hyp = hypothesis.split() if isinstance(hypothesis, str) else list(hypothesis)
    n, m = len(ref), len(hyp)

    # Rolling single-row DP keeps memory O(m).
    prev: List[_Cell] = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        row: List[_Cell] = [(i, 0, i, 0)] + [None] * m  # type: ignore[list-item]
        ri = ref[i - 1]
        for j in range(1, m + 1):
            if ri == hyp[j - 1]:
                best = prev[j - 1]
            else:
                c, s, d, k = prev[j - 1]
                best = (c + 1, s + 1, d, k)
            c, s, d, k = prev[j]
            cand = (c + 1, s, d + 1, k)
            if _key(cand) < _key(best):
                best = cand
            c, s, d, k = row[j - 1]
            cand = (c + 1, s, d, k + 1)
            if _key(cand) < _key(best):
                best = cand
            row[j] = best
        prev = row

    edits, subs, dels, ins = prev[m]
    wer = (edits / n) if n else (0.0 if edits == 0 else 1.0)
    return WERResult(substitutions=subs, deletions=dels, insertions=ins,
                     reference_tokens=n, hypothesis_tokens=m, wer=wer)


def aggregate_wer(results: Iterable[WERResult]) -> dict:
    rs = list(results)
    total_ref = sum(r.reference_tokens for r in rs)
    subs = sum(r.substitutions for r in rs)
    dels = sum(r.deletions for r in rs)
    ins = sum(r.insertions for r in rs)
    edits = subs + dels + ins

    def rate(x: int) -> float:
        return x / total_ref if total_ref else 0.0

    return {
        "wer_micro": rate(edits),
        "wer_macro": sum(r.wer for r in rs) / len(rs) if rs else 0.0,
        "substitution_rate": rate(subs),
        "deletion_rate": rate(dels),
        "insertion_rate": rate(ins),
        "total_reference_tokens": total_ref,
        "total_hypothesis_tokens": sum(r.hypothesis_tokens for r in rs),
        "total_substitutions": subs,
        "total_deletions": dels,
        "total_insertions": ins,
        "total_edits": edits,
    }
