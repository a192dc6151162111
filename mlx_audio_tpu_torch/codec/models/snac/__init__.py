from .snac import SNAC, Model, ModelConfig

__all__ = ["SNAC", "Model", "ModelConfig"]
