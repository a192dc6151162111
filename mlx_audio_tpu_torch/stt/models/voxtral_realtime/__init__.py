"""Voxtral Mini Realtime speech-to-text (counterpart of
mlx_audio_tpu/stt/models/voxtral_realtime)."""

from .voxtral_realtime import Model, ModelConfig, TekkenTokenizer

__all__ = ["Model", "ModelConfig", "TekkenTokenizer"]
