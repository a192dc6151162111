"""The llama backbone (the JAX package's `BackboneModel`). The loadable
family `llama` there is the Orpheus token-TTS, which is not ported yet."""

from .llama import (Model, ModelConfig, decode_step, init_caches,
                    llama_forward, logits_from_hidden)

__all__ = ["Model", "ModelConfig", "llama_forward", "logits_from_hidden",
           "init_caches", "decode_step"]
