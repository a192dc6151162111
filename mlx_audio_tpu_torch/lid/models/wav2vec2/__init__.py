from .wav2vec2 import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
