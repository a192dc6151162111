"""TADA (counterpart of mlx_audio_tpu/tts/models/tada)."""

from .tada import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
