"""Granite Speech (counterpart of mlx_audio_tpu/stt/models/granite_speech):
a conformer CTC encoder, a Q-Former projector and a Granite LM on the
llama backbone."""

from .granite_speech import (EncoderConfig, Model, ModelConfig,
                             ProjectorConfig, StreamingResult)

__all__ = ["Model", "ModelConfig", "EncoderConfig", "ProjectorConfig",
           "StreamingResult"]
