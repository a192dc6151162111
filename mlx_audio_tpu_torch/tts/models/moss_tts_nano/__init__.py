"""MOSS-TTS-Nano (counterpart of mlx_audio_tpu/tts/models/moss_tts_nano):
only its GPT-2 stack (`gpt2.py`) is ported, the local head of MOSS-TTS
v1.5. The Nano model itself is not ported yet, and the TTS loader does
not route it."""

from .gpt2 import GPT2, GPT2Config, gpt2_forward, gpt2_make_caches, init_gpt2

__all__ = ["GPT2", "GPT2Config", "gpt2_forward", "gpt2_make_caches",
           "init_gpt2"]
