from .model import (ANCHOR_DICT, Model, ModelConfig, SAMAudio,
                    SeparationResult)

__all__ = ["Model", "ModelConfig", "SAMAudio", "SeparationResult",
           "ANCHOR_DICT"]
