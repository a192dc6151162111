from .wav2vec import (ModelConfig, Wav2Vec2Model, feature_lengths,
                      sanitize_wav2vec2, wav2vec2_forward)

__all__ = ["ModelConfig", "Wav2Vec2Model", "feature_lengths",
           "sanitize_wav2vec2", "wav2vec2_forward"]
