from .sensevoice import (EncoderConfig, FrontendConfig, Model, ModelConfig,
                         SenseVoiceSmall)

__all__ = ["EncoderConfig", "FrontendConfig", "Model", "ModelConfig",
           "SenseVoiceSmall"]
