"""Alias family: `moss_tts_local` (v1.5 local transformer) checkpoints load
the shared MOSS-TTS model (counterpart of
mlx_audio_tpu/tts/models/moss_tts_local)."""

from ..moss_tts import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
