"""VibeVoice configuration: the port's own copy of
mlx_audio_tpu/tts/models/vibevoice/config.py, kept equal to it.

Nested configs: Qwen2 decoder backbone (split into a lower text LM and an
upper TTS LM, config.py:89-108), diffusion prediction head (:44-61), and the
causal-conv acoustic tokenizer / VAE decoder (:9-42).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ....base import BaseModelArgs


@dataclass
class AcousticTokenizerConfig(BaseModelArgs):
    model_type: str = "vibevoice_acoustic_tokenizer"
    channels: int = 1
    causal: bool = True
    vae_dim: int = 64
    fix_std: float = 0.5
    std_dist_type: str = "gaussian"
    conv_norm: str = "none"
    pad_mode: str = "constant"
    layernorm: str = "RMSNorm"
    layernorm_eps: float = 1e-5
    conv_bias: bool = True
    layer_scale_init_value: float = 1e-6
    encoder_n_filters: int = 32
    encoder_ratios: List[int] = field(
        default_factory=lambda: [8, 5, 5, 4, 2, 2])
    encoder_depths: str = "3-3-3-3-3-3-8"
    decoder_n_filters: int = 32
    decoder_ratios: Optional[List[int]] = None
    decoder_depths: Optional[str] = None
    mixer_kernel: int = 7

    @property
    def ratios(self) -> List[int]:
        return self.decoder_ratios or self.encoder_ratios

    @property
    def depths(self) -> List[int]:
        d = self.decoder_depths
        if d:
            return [int(x) for x in d.split("-")] if isinstance(d, str) else d
        e = self.encoder_depths
        e = [int(x) for x in e.split("-")] if isinstance(e, str) else e
        return list(reversed(e))

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.ratios:
            hop *= r
        return hop


@dataclass
class DiffusionHeadConfig(BaseModelArgs):
    model_type: str = "vibevoice_diffusion_head"
    hidden_size: int = 896
    head_layers: int = 4
    head_ffn_ratio: float = 3.0
    rms_norm_eps: float = 1e-5
    latent_size: int = 64
    speech_vae_dim: Optional[int] = 64
    prediction_type: str = "v_prediction"
    diffusion_type: str = "ddpm"
    ddpm_num_steps: int = 1000
    ddpm_num_inference_steps: int = 20
    ddpm_beta_schedule: str = "cosine"
    ddpm_batch_mul: int = 4
    freq_embed_size: int = 256


@dataclass
class Qwen2DecoderConfig(BaseModelArgs):
    model_type: str = "qwen2"
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_attention_heads: int = 14
    num_hidden_layers: int = 24
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    vocab_size: int = 151936
    max_position_embeddings: int = 8192
    head_dim: Optional[int] = None
    tie_word_embeddings: bool = False
    logits_scaling: float = 1.0


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "vibevoice_streaming"
    model_path: Optional[str] = None
    sample_rate: int = 24000
    acoustic_tokenizer_config: Optional[Dict] = None
    decoder_config: Optional[Dict] = None
    diffusion_head_config: Optional[Dict] = None
    acoustic_vae_dim: int = 64
    tts_backbone_num_hidden_layers: int = 20

    def __post_init__(self):
        if not isinstance(self.acoustic_tokenizer_config,
                          AcousticTokenizerConfig):
            self.acoustic_tokenizer_config = \
                AcousticTokenizerConfig.from_dict(
                    self.acoustic_tokenizer_config or {})
        if not isinstance(self.decoder_config, Qwen2DecoderConfig):
            self.decoder_config = Qwen2DecoderConfig.from_dict(
                self.decoder_config or {})
        if not isinstance(self.diffusion_head_config, DiffusionHeadConfig):
            self.diffusion_head_config = DiffusionHeadConfig.from_dict(
                self.diffusion_head_config or {})
