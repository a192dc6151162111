"""NVIDIA Parakeet (counterpart of mlx_audio_tpu/stt/models/parakeet): the
FastConformer encoder that Parakeet, Canary, Cohere ASR and Nemotron ASR
share (`conformer.py`), the greedy transducer loop (`transducer.py`) and
the Parakeet TDT / RNN-T / CTC models (`parakeet.py`)."""

from .parakeet import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
