"""Canary (counterpart of mlx_audio_tpu/stt/models/canary): the model, its
tokenizer and its transformer decoder, which Cohere ASR shares."""

from .canary import CanaryTokenizer, DecoderConfig, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "CanaryTokenizer", "DecoderConfig"]
