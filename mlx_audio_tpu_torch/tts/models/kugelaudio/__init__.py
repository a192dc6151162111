from .kugelaudio import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
