from .higgs_audio import HiggsAudioServer, Model, ModelConfig

__all__ = ["Model", "ModelConfig", "HiggsAudioServer"]
