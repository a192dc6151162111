from .silero_vad import Model, ModelConfig, SileroVADState, VADOutput

__all__ = ["Model", "ModelConfig", "SileroVADState", "VADOutput"]
