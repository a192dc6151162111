from .config import (FCEncoderConfig, ModelConfig, ModulesConfig,
                     ProcessorConfig, TFEncoderConfig)
from .sortformer import (DiarizationOutput, DiarizationSegment, Model,
                         StreamingState)

__all__ = ["FCEncoderConfig", "ModelConfig", "ModulesConfig",
           "ProcessorConfig", "TFEncoderConfig", "DiarizationOutput",
           "DiarizationSegment", "Model", "StreamingState"]
