from .moonshine import Model, ModelConfig, encoder_forward, encoder_frames

__all__ = ["Model", "ModelConfig", "encoder_forward", "encoder_frames"]
