from .voxtral_tts import VOICE_MAP, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "VOICE_MAP"]
