"""MOSS-TTS (counterpart of mlx_audio_tpu/tts/models/moss_tts): the model
in its delay, legacy local and v1.5 local layouts (`Model`,
`ModelConfig`), its prompt processors and delay pattern, and the Qwen3 LM
that the Qwen3 LM families share (`Qwen3LMConfig`, `Qwen3LM`,
`qwen3_lm_forward`). The MOSS audio tokenizer codec is not ported: a
caller binds its own as `model.audio_tokenizer`."""

from .config import ModelConfig, Qwen3LMConfig
from .moss_tts import Model, Qwen3LM, init_qwen3_lm, lm_logits, qwen3_lm_forward
from .processor import (MossTTSDelayProcessor, MossTTSLocalProcessor,
                        MossTTSLocalV15Processor, apply_de_delay_pattern,
                        apply_delay_pattern)

__all__ = ["Model", "ModelConfig", "Qwen3LMConfig", "Qwen3LM",
           "init_qwen3_lm", "qwen3_lm_forward", "lm_logits",
           "MossTTSDelayProcessor", "MossTTSLocalProcessor",
           "MossTTSLocalV15Processor", "apply_delay_pattern",
           "apply_de_delay_pattern"]
