"""GLM-ASR (counterpart of mlx_audio_tpu/stt/models/glmasr): a Whisper
encoder with interleaved RoPE, a merge adapter and a llama decoder."""

from .glmasr import LlamaConfig, Model, ModelConfig, WhisperConfig

__all__ = ["Model", "ModelConfig", "WhisperConfig", "LlamaConfig"]
