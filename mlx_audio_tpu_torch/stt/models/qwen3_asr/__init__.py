"""Qwen3-ASR (counterpart of mlx_audio_tpu/stt/models/qwen3_asr): the
chunked audio encoder and Qwen3 LM decoder, and its forced aligner."""

from .config import AudioEncoderConfig, ModelConfig, TextConfig
from .qwen3_asr import Model, StreamingResult

__all__ = ["Model", "ModelConfig", "AudioEncoderConfig", "TextConfig",
           "StreamingResult"]
