"""Offline Voxtral (counterpart of mlx_audio_tpu/stt/models/voxtral): a
Whisper-style audio tower and a Mistral LM on the llama backbone."""

from .voxtral import AudioConfig, Model, ModelConfig, TekkenEncoder

__all__ = ["Model", "ModelConfig", "AudioConfig", "TekkenEncoder"]
