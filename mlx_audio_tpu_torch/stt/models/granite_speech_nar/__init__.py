from .granite_speech_nar import (EncoderConfig, Model, ModelConfig,
                                 ProjectorConfig, TextConfig)

__all__ = ["EncoderConfig", "Model", "ModelConfig", "ProjectorConfig",
           "TextConfig"]
