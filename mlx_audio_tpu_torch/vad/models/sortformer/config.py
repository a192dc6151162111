"""Sortformer configs (a copy of
mlx_audio_tpu/vad/models/sortformer/config.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ....base import BaseModelArgs


@dataclass
class FCEncoderConfig(BaseModelArgs):
    model_type: str = "sortformer_fc_encoder"
    hidden_size: int = 512
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    num_mel_bins: int = 80
    conv_kernel_size: int = 9
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256
    subsampling_conv_kernel_size: int = 3
    subsampling_conv_stride: int = 2
    max_position_embeddings: int = 5000
    attention_bias: bool = True
    scale_input: bool = True


@dataclass
class TFEncoderConfig(BaseModelArgs):
    model_type: str = "sortformer_tf_encoder"
    d_model: int = 192
    encoder_layers: int = 18
    encoder_attention_heads: int = 8
    encoder_ffn_dim: int = 768
    layer_norm_eps: float = 1e-5
    max_source_positions: int = 1500
    k_proj_bias: bool = False


@dataclass
class ModulesConfig(BaseModelArgs):
    model_type: str = "sortformer_modules"
    num_speakers: int = 4
    fc_d_model: int = 512
    tf_d_model: int = 192
    subsampling_factor: int = 8
    chunk_len: int = 188
    fifo_len: int = 0
    spkcache_len: int = 188
    spkcache_update_period: int = 188
    chunk_left_context: int = 1
    chunk_right_context: int = 1
    sil_threshold: float = 0.1
    use_aosc: bool = False
    # AOSC (v2.1) compression parameters (reference config.py:69-86)
    spkcache_sil_frames_per_spk: int = 5
    pred_score_threshold: float = 1e-6
    max_index: int = 10000
    scores_boost_latest: float = 0.5
    strong_boost_rate: float = 0.3
    weak_boost_rate: float = 0.7
    min_pos_scores_rate: float = 0.5


@dataclass
class ProcessorConfig(BaseModelArgs):
    feature_size: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    n_fft: int = 512
    win_length: int = 400
    preemphasis: float = 0.97


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "sortformer"
    num_speakers: int = 4
    fc_encoder_config: Optional[FCEncoderConfig] = None
    tf_encoder_config: Optional[TFEncoderConfig] = None
    modules_config: Optional[ModulesConfig] = None
    processor_config: Optional[ProcessorConfig] = None

    def __post_init__(self):
        for name, cls in (("fc_encoder_config", FCEncoderConfig),
                          ("tf_encoder_config", TFEncoderConfig),
                          ("modules_config", ModulesConfig),
                          ("processor_config", ProcessorConfig)):
            v = getattr(self, name)
            if isinstance(v, dict):
                setattr(self, name, cls.from_dict(v))
            elif v is None:
                setattr(self, name, cls())
