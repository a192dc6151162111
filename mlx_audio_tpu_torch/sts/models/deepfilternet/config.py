"""DeepFilterNet 2/3 configs: the port's copy of
mlx_audio_tpu/sts/models/deepfilternet/config.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ....base import BaseModelArgs


@dataclass
class DeepFilterNetConfig(BaseModelArgs):
    model_version: str = "DeepFilterNet3"
    model_type: str = "deepfilternet"
    sample_rate: int = 48000
    fft_size: int = 960
    hop_size: int = 480

    nb_erb: int = 32
    erb_widths: Optional[List[int]] = None
    nb_df: int = 96
    df_order: int = 5
    df_lookahead: int = 0
    conv_lookahead: int = 0

    conv_ch: int = 16
    conv_kernel: List[int] = field(default_factory=lambda: [1, 3])
    convt_kernel: List[int] = field(default_factory=lambda: [1, 3])
    conv_kernel_inp: List[int] = field(default_factory=lambda: [3, 3])

    emb_hidden_dim: int = 256
    emb_num_layers: int = 2
    df_hidden_dim: int = 256
    df_num_layers: int = 3
    df_pathway_kernel_size_t: int = 5

    emb_gru_skip: str = "none"
    df_gru_skip: str = "none"
    linear_groups: int = 8
    enc_linear_groups: int = 16
    enc_concat: bool = False          # True for DeepFilterNet2
    lsnr_max: int = 35
    lsnr_min: int = -15

    mask_pf: bool = False
    pf_beta: float = 0.02


def config_for_version(d: dict) -> DeepFilterNetConfig:
    version = d.get("model_version", "DeepFilterNet3")
    cfg = DeepFilterNetConfig.from_dict(d)
    if version == "DeepFilterNet2" and "enc_concat" not in d:
        cfg.enc_concat = True
    cfg.model_version = version
    return cfg
