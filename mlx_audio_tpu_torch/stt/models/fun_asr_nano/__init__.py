from .fun_asr_nano import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
