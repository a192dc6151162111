from .higgs_audio import HiggsAudioTokenizer, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "HiggsAudioTokenizer"]
