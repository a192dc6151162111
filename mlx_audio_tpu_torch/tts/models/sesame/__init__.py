from ....model import load_jax_params
from .sesame import Model, ModelConfig, Segment

__all__ = ["Model", "ModelConfig", "Segment", "load_jax_params"]
