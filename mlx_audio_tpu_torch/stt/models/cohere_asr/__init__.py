"""Cohere ASR speech-to-text (counterpart of
mlx_audio_tpu/stt/models/cohere_asr)."""

from .cohere_asr import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
