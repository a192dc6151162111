from ....model import load_jax_params
from .kokoro import FRAME_BUCKETS, TOKEN_BUCKETS, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "load_jax_params", "TOKEN_BUCKETS",
           "FRAME_BUCKETS"]
