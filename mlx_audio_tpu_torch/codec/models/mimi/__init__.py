from .mimi import Mimi, MimiConfig, Model, ModelConfig, exact_f32, mimi_202407

__all__ = ["Mimi", "MimiConfig", "Model", "ModelConfig", "mimi_202407",
           "exact_f32"]
