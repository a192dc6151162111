"""LID families ported: `ecapa_tdnn` and `wav2vec2`."""
