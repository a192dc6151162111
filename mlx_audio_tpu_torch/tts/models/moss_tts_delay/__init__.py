"""Alias family: `moss_tts_delay` checkpoints load the shared MOSS-TTS model
(counterpart of mlx_audio_tpu/tts/models/moss_tts_delay)."""

from ..moss_tts import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
