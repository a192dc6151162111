"""Qwen3-ASR configuration (counterpart of
mlx_audio_tpu/stt/models/qwen3_asr/config.py, copied): the audio encoder's
and the text LM's configs, and `ModelConfig`, which flattens an HF
checkpoint's `thinker_config` nesting into audio_config / text_config and
the audio token ids (:67-76)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ....base import BaseModelArgs


@dataclass
class AudioEncoderConfig(BaseModelArgs):
    num_mel_bins: int = 128
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    d_model: int = 1024
    activation_function: str = "gelu"
    scale_embedding: bool = False
    max_source_positions: int = 1500
    n_window: int = 50
    output_dim: int = 2048
    n_window_infer: int = 800
    conv_chunksize: int = 500
    downsample_hidden_size: int = 480


@dataclass
class TextConfig(BaseModelArgs):
    model_type: str = "qwen3"
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 65536
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    rope_theta: float = 1000000.0
    attention_bias: bool = False


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "qwen3_asr"
    model_path: str = ""
    audio_config: Optional[Dict] = None
    text_config: Optional[Dict] = None
    audio_token_id: int = 151676
    audio_start_token_id: int = 151669
    audio_end_token_id: int = 151670
    support_languages: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not isinstance(self.audio_config, AudioEncoderConfig):
            self.audio_config = AudioEncoderConfig.from_dict(
                self.audio_config or {})
        if not isinstance(self.text_config, TextConfig):
            self.text_config = TextConfig.from_dict(self.text_config or {})

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "ModelConfig":
        params = dict(params)
        thinker = params.pop("thinker_config", None)
        if thinker:
            for key in ("audio_config", "text_config", "audio_token_id",
                        "audio_start_token_id", "audio_end_token_id"):
                if key in thinker:
                    params[key] = thinker[key]
        return super().from_dict(params)


__all__ = ["AudioEncoderConfig", "TextConfig", "ModelConfig"]
