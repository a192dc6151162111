from .config import DeepFilterNetConfig
from .config import DeepFilterNetConfig as ModelConfig
from .model import DeepFilterNetModel, DeepFilterNetStreamer, Model

__all__ = ["DeepFilterNetConfig", "ModelConfig", "DeepFilterNetModel",
           "DeepFilterNetStreamer", "Model"]
