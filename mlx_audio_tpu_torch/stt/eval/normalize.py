"""Minimal English text normalization for WER scoring.

The port's copy of mlx_audio_tpu/stt/eval/normalize.py (no departure).
Parity: reference mlx_audio/stt/eval/normalize.py — lowercase, strip
punctuation (keeping apostrophes inside contractions, with curly variants
folded to ASCII), collapse whitespace.
"""

from __future__ import annotations

import re
import unicodedata

_WS = re.compile(r"\s+")
_CURLY = str.maketrans({"‘": "'", "’": "'", "‛": "'",
                        "′": "'"})


def normalize_for_wer(text: str) -> str:
    if not text:
        return ""
    text = text.translate(_CURLY)
    kept = [c for c in text
            if c == "'" or not unicodedata.category(c).startswith("P")]
    return _WS.sub(" ", "".join(kept).lower()).strip()
