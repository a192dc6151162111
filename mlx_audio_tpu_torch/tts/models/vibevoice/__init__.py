from .config import (AcousticTokenizerConfig, DiffusionHeadConfig,
                     ModelConfig, Qwen2DecoderConfig)
from .vibevoice import Model

__all__ = ["Model", "ModelConfig", "AcousticTokenizerConfig",
           "DiffusionHeadConfig", "Qwen2DecoderConfig"]
