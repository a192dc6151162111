"""VibeVoice-ASR (counterpart of mlx_audio_tpu/stt/models/vibevoice_asr):
two causal tokenizer encoders and a Qwen2.5 LM on the llama backbone,
transcribing to JSON segments."""

from .vibevoice_asr import Model, ModelConfig, TokenizerConfig

__all__ = ["Model", "ModelConfig", "TokenizerConfig"]
