"""Rule-based duration estimation from script-weighted character counts.

The port's own copy of mlx_audio_tpu/tts/models/omnivoice/duration.py,
kept equal to it (tests/test_torch_omnivoice.py holds the two to the same
outputs): a phonetic weight per Unicode script, a reference-anchored speed
factor, a power-curve boost for short outputs. No departures.
"""

from __future__ import annotations

import bisect
import unicodedata
from functools import lru_cache
from typing import Optional

_WEIGHTS = {
    "cjk": 3.0, "hangul": 2.5, "kana": 2.2, "ethiopic": 3.0, "yi": 3.0,
    "indic": 1.8, "thai_lao": 1.5, "khmer_myanmar": 1.8, "arabic": 1.5,
    "hebrew": 1.5, "latin": 1.0, "cyrillic": 1.0, "greek": 1.0,
    "armenian": 1.0, "georgian": 1.0, "punctuation": 0.5, "space": 0.2,
    "digit": 3.5, "mark": 0.0, "default": 1.0,
}

# (last codepoint of range, script key) — compact major-script table
_RANGES = [
    (0x02AF, "latin"), (0x03FF, "greek"), (0x052F, "cyrillic"),
    (0x058F, "armenian"), (0x05FF, "hebrew"), (0x08FF, "arabic"),
    (0x0DFF, "indic"), (0x0EFF, "thai_lao"), (0x0FFF, "indic"),
    (0x109F, "khmer_myanmar"), (0x10FF, "georgian"), (0x11FF, "hangul"),
    (0x139F, "ethiopic"), (0x17FF, "khmer_myanmar"), (0x1CFF, "default"),
    (0x1EFF, "latin"), (0x2FFF, "default"), (0x309F, "kana"),
    (0x30FF, "kana"), (0x318F, "hangul"), (0x9FFF, "cjk"),
    (0xA4CF, "yi"), (0xA69F, "cyrillic"), (0xA7FF, "latin"),
    (0xABFF, "indic"), (0xD7AF, "hangul"), (0xFAFF, "cjk"),
    (0xFEFF, "arabic"), (0xFFEF, "latin"),
]
_BREAKS = [r[0] for r in _RANGES]


class RuleDurationEstimator:
    """Estimate speech duration of `target_text` given a reference pace."""

    @lru_cache(maxsize=4096)
    def _char_weight(self, ch: str) -> float:
        code = ord(ch)
        if (65 <= code <= 90) or (97 <= code <= 122):
            return _WEIGHTS["latin"]
        if code == 32:
            return _WEIGHTS["space"]
        if code == 0x0640:  # arabic tatweel
            return _WEIGHTS["mark"]
        cat = unicodedata.category(ch)
        if cat.startswith("M"):
            return _WEIGHTS["mark"]
        if cat.startswith(("P", "S")):
            return _WEIGHTS["punctuation"]
        if cat.startswith("Z"):
            return _WEIGHTS["space"]
        if cat.startswith("N"):
            return _WEIGHTS["digit"]
        idx = bisect.bisect_left(_BREAKS, code)
        if idx < len(_RANGES):
            return _WEIGHTS.get(_RANGES[idx][1], _WEIGHTS["default"])
        if code > 0x20000:
            return _WEIGHTS["cjk"]
        return _WEIGHTS["default"]

    def calculate_total_weight(self, text: str) -> float:
        return sum(self._char_weight(c) for c in text)

    def estimate_duration(self, target_text: str, ref_text: str,
                          ref_duration: float,
                          low_threshold: Optional[float] = 50,
                          boost_strength: float = 3) -> float:
        if ref_duration <= 0 or not ref_text:
            return 0.0
        ref_weight = self.calculate_total_weight(ref_text)
        if ref_weight == 0:
            return 0.0
        est = self.calculate_total_weight(target_text) * (
            ref_duration / ref_weight)
        if low_threshold is not None and est < low_threshold:
            return low_threshold * (est / low_threshold) ** (
                1.0 / boost_strength)
        return est
