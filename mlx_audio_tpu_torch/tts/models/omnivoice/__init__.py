from .omnivoice import BackboneConfig, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "BackboneConfig"]
