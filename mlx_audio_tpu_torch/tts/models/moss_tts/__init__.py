"""MOSS-TTS (counterpart of mlx_audio_tpu/tts/models/moss_tts), only what
the Qwen3 LM families need: `Qwen3LMConfig` and the Qwen3 LM it builds
(`Qwen3LM`, `qwen3_lm_forward`), on which VyvoTTS and Qwen3-ASR run. The
rest of MOSS-TTS (the delay-pattern and local-transformer heads, the
processors, the model itself) is not ported yet."""

from .config import Qwen3LMConfig
from .moss_tts import Qwen3LM, init_qwen3_lm, lm_logits, qwen3_lm_forward

__all__ = ["Qwen3LMConfig", "Qwen3LM", "init_qwen3_lm", "qwen3_lm_forward",
           "lm_logits"]
