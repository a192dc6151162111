from .outetts import Model, ModelConfig
from .prompt import PromptProcessor, SpecialTokens

__all__ = ["Model", "ModelConfig", "PromptProcessor", "SpecialTokens"]
