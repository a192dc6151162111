"""Codec families ported so far: `higgs_audio` (the Higgs Audio v2
acoustic tokenizer)."""
