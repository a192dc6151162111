"""Qwen2-Audio (counterpart of mlx_audio_tpu/stt/models/qwen2_audio): the
Whisper-style tower with a 2x pool and a Qwen2 LM on the llama
backbone."""

from .qwen2_audio import Model, ModelConfig, sinusoids

__all__ = ["Model", "ModelConfig", "sinusoids"]
