from ....model import load_jax_params
from .config import ModelConfig
from .qwen3_tts import Model

__all__ = ["Model", "ModelConfig", "load_jax_params"]
