"""Nemotron ASR speech-to-text (counterpart of
mlx_audio_tpu/stt/models/nemotron_asr)."""

from .nemotron_asr import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
