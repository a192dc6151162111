from .config import FSMNEncoderConfig, ModelConfig
from .fsmn import Model

__all__ = ["FSMNEncoderConfig", "ModelConfig", "Model"]
