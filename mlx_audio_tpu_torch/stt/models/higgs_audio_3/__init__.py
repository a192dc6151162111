from .higgs_audio_3 import (AudioEncoderConfig, Model, ModelConfig,
                            split_long, vad_chunk_ranges)

__all__ = ["AudioEncoderConfig", "Model", "ModelConfig", "split_long",
           "vad_chunk_ranges"]
