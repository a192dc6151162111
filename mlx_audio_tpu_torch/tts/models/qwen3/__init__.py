"""VyvoTTS (counterpart of mlx_audio_tpu/tts/models/qwen3): a Qwen3 LM
emitting SNAC codes."""

from .qwen3 import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
