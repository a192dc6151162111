from .fireredasr2 import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
