from .soprano import DecoderConfig, Model, ModelConfig
from .text import clean_text

__all__ = ["DecoderConfig", "Model", "ModelConfig", "clean_text"]
