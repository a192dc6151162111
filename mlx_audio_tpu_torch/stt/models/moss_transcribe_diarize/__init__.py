from .moss_transcribe_diarize import (AudioConfig, Model, ModelConfig,
                                      StreamingResult)

__all__ = ["AudioConfig", "Model", "ModelConfig", "StreamingResult"]
