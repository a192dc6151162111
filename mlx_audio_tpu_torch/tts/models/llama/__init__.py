"""The llama family, as the JAX package exports it
(mlx_audio_tpu/tts/models/llama/__init__.py): the loadable `Model` and
`ModelConfig` (model_type "llama") are the Orpheus token-TTS; the backbone
is `BackboneModel` and `BackboneConfig`, with its functions."""

from .llama import Model as BackboneModel
from .llama import ModelConfig as BackboneConfig
from .llama import decode_step, init_caches, llama_forward, logits_from_hidden
from .orpheus import Model, ModelConfig

__all__ = ["Model", "ModelConfig", "BackboneModel", "BackboneConfig",
           "llama_forward", "logits_from_hidden", "init_caches",
           "decode_step"]
