from .dac import DAC, Model, ModelConfig

__all__ = ["DAC", "Model", "ModelConfig"]
