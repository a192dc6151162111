from .detokenizer import DetokenizerConfig, LFM2AudioDetokenizer
from .lfm2 import LFM2Config
from .lfm_audio import (
    AUDIO_EOS_TOKEN,
    AUDIO_START_TOKEN,
    IM_END_TOKEN,
    TEXT_END_TOKEN,
    DepthformerConfig,
    GenerationConfig,
    LFM2AudioConfig,
    LFM2AudioModel,
    Model,
    ModelConfig,
)
from .processor import (
    AudioPreprocessor,
    ChatState,
    LFM2AudioProcessor,
    LFMModality,
    PreprocessorConfig,
)

__all__ = [
    "LFM2AudioConfig",
    "LFM2Config",
    "DepthformerConfig",
    "PreprocessorConfig",
    "DetokenizerConfig",
    "LFM2AudioModel",
    "LFMModality",
    "GenerationConfig",
    "LFM2AudioProcessor",
    "AudioPreprocessor",
    "LFM2AudioDetokenizer",
    "ChatState",
    "Model",
    "ModelConfig",
    "AUDIO_EOS_TOKEN",
    "AUDIO_START_TOKEN",
    "IM_END_TOKEN",
    "TEXT_END_TOKEN",
]
