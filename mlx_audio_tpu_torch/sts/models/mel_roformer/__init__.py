from .config import MelRoFormerConfig
from .model import (BandLayout, MelRoFormer, MelRoFormerResult, Model,
                    band_split, mask_estimator, mel_roformer_forward)

ModelConfig = MelRoFormerConfig     # loader convention

__all__ = ["MelRoFormerConfig", "ModelConfig", "MelRoFormer",
           "MelRoFormerResult", "Model", "BandLayout", "band_split",
           "mask_estimator", "mel_roformer_forward"]
