from .ecapa_tdnn import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
