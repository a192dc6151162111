from .moss_music import (AudioEncoderConfig, Model, ModelConfig,
                         StreamingResult, conv3_downsample_len)

__all__ = ["AudioEncoderConfig", "Model", "ModelConfig", "StreamingResult",
           "conv3_downsample_len"]
