"""MegaASR (counterpart of mlx_audio_tpu/stt/models/mega_asr): Qwen3-ASR
with an audio-quality router and a LoRA adapter toggled per request."""

from .lora import apply_deltas, load_lora_factors
from .mega_asr import Model, ModelConfig
from .router import AudioQualityRouter

__all__ = ["Model", "ModelConfig", "AudioQualityRouter", "apply_deltas",
           "load_lora_factors"]
