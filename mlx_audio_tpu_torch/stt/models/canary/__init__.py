"""Canary (counterpart of mlx_audio_tpu/stt/models/canary): so far the
tokenizer and the transformer decoder, which Cohere ASR runs; the Canary
`Model` is not ported yet."""

from .canary import CanaryTokenizer, DecoderConfig

__all__ = ["CanaryTokenizer", "DecoderConfig"]
