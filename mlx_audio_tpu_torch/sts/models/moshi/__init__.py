from .moshi import Lm, LmConfig, LmGen, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "Lm", "LmConfig", "LmGen"]
