"""FSMN-VAD configs (a copy of mlx_audio_tpu/vad/models/fsmn/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ....base import BaseModelArgs


@dataclass
class FSMNEncoderConfig(BaseModelArgs):
    input_dim: int = 400
    input_affine_dim: int = 140
    fsmn_layers: int = 4
    linear_dim: int = 250
    proj_dim: int = 128
    lorder: int = 20
    rorder: int = 0
    lstride: int = 1
    rstride: int = 0
    output_affine_dim: int = 140
    output_dim: int = 248


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "fsmn"
    architecture: str = "fsmn_vad"
    encoder: Optional[FSMNEncoderConfig] = None

    # frontend
    sample_rate: int = 16000
    n_mels: int = 80
    frame_length: int = 25          # ms
    frame_shift: int = 10           # ms
    lfr_m: int = 5
    lfr_n: int = 1

    # post-processing
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_noise_thres: float = 0.6
    sil_pdf_ids: List[int] = field(default_factory=lambda: [0])
    frame_in_ms: int = 10

    def __post_init__(self):
        if isinstance(self.encoder, dict):
            self.encoder = FSMNEncoderConfig.from_dict(self.encoder)
        if self.encoder is None:
            self.encoder = FSMNEncoderConfig()
