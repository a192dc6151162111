"""Whisper speech-to-text (counterpart of mlx_audio_tpu/stt/models/whisper)."""

from .whisper import Model, ModelConfig, ModelDimensions

__all__ = ["Model", "ModelConfig", "ModelDimensions"]
