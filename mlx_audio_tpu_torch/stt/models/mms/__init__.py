from ..wav2vec import ModelConfig
from .mms import Model, ctc_collapse

__all__ = ["Model", "ModelConfig", "ctc_collapse"]
