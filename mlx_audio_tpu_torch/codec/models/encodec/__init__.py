from .encodec import Encodec, Model, ModelConfig

__all__ = ["Encodec", "Model", "ModelConfig"]
