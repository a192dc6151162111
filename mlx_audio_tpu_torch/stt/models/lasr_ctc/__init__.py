from .lasr import LasrEncoderConfig, Model, ModelConfig

__all__ = ["LasrEncoderConfig", "Model", "ModelConfig"]
