"""Qwen3-ForcedAligner (counterpart of
mlx_audio_tpu/stt/models/qwen3_forced_aligner: the qwen3_asr alignment
stack under its own model type)."""

from ..qwen3_asr.forced_aligner import (
    ForceAlignProcessor,
    ForcedAlignItem,
    ForcedAlignResult,
    ForcedAlignerConfig as ModelConfig,
    ForcedAlignerModel as Model,
)

__all__ = ["Model", "ModelConfig", "ForcedAlignItem", "ForcedAlignResult",
           "ForceAlignProcessor"]
