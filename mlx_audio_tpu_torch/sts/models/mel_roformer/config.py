"""Mel-Band-RoFormer config and checkpoint-family presets.

The port's copy of mlx_audio_tpu/sts/models/mel_roformer/config.py: the
same hyperparameters and the same explicit presets (no silently-default
checkpoint family; the weight licenses differ by family).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class MelRoFormerConfig:
    dim: int = 384
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    num_bands: int = 60
    num_stems: int = 1
    ff_mult: int = 4
    mlp_expansion_factor: int = 4
    mask_estimator_depth: int = 2

    n_fft: int = 2048
    hop_length: int = 441
    win_length: int = 2048
    sample_rate: int = 44100

    chunk_size: int = 352800        # 8 s at 44.1 kHz
    num_overlap: int = 2            # 50% overlap

    checkpoint_family: Optional[str] = None
    model_type: str = "mel_band_roformer"

    @property
    def dim_inner(self) -> int:
        return self.heads * self.dim_head

    @property
    def ff_dim(self) -> int:
        return self.dim * self.ff_mult

    @property
    def mlp_hidden(self) -> int:
        return self.dim * self.mlp_expansion_factor

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    @classmethod
    def from_dict(cls, params: dict) -> "MelRoFormerConfig":
        import inspect
        valid = set(inspect.signature(cls).parameters)
        return cls(**{k: v for k, v in params.items() if k in valid})

    # checkpoint-family presets

    @classmethod
    def kim_vocal_2(cls) -> "MelRoFormerConfig":
        """KimberleyJSN/melbandroformer (GPL-3 weights)."""
        return cls(depth=6, checkpoint_family="kim_vocal_2")

    @classmethod
    def viperx_vocals(cls) -> "MelRoFormerConfig":
        """viperx vocals (undeclared weight license)."""
        return cls(depth=12, checkpoint_family="viperx_vocals")

    @classmethod
    def zfturbo_bs_roformer(cls) -> "MelRoFormerConfig":
        """ZFTurbo MSS-Training release assets (MIT weights)."""
        return cls(depth=12, checkpoint_family="zfturbo_bs_roformer")

    @classmethod
    def zfturbo_vocals_v1(cls) -> "MelRoFormerConfig":
        """ZFTurbo v1.0.0 vocals (MIT; mask_estimator_depth=1, hop 512)."""
        return cls(dim=192, depth=8, hop_length=512,
                   mask_estimator_depth=1,
                   checkpoint_family="zfturbo_vocals_v1")

    @classmethod
    def custom(cls, *, depth: int, **kwargs) -> "MelRoFormerConfig":
        return cls(depth=depth, checkpoint_family="custom", **kwargs)
