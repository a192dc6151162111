"""Codec families ported so far: `higgs_audio` (the Higgs Audio v2
acoustic tokenizer) and `mimi` (Moshi's streaming codec, shared by
Qwen3-TTS's reference encoder and Sesame CSM)."""
