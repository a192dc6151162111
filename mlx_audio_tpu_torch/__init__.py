"""mlx_audio_tpu_torch: the PyTorch/CUDA port of mlx_audio_tpu.

The JAX package `mlx_audio_tpu` is the reference; this package mirrors its
layout (`nn/`, `ops/`, `dsp.py`, `model.py`, `tts/models/...`) so each module
has its counterpart at the same relative path. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper under `csrc/`, built on first use (see `ops/cuda_build.py`).

Ported so far: Kokoro-82M text -> audio (`tts.models.kokoro`) and
Qwen3-TTS text ids -> audio, dense or 8/4-bit quantized
(`tts.models.qwen3_tts`).

This package never imports jax. Host code that is already jax-free
(`mlx_audio_tpu.base`, `mlx_audio_tpu.tts.g2p`, `mlx_audio_tpu.audio_io`) is
imported from the JAX package rather than copied.
"""

__all__ = ["load_model"]


def load_model(model_path, **kwargs):
    """Load a local TTS checkpoint directory into the port (see tts.utils)."""
    from .tts.utils import load_model as _load

    return _load(model_path, **kwargs)
