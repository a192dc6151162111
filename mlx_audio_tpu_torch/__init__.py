"""mlx_audio_tpu_torch: the PyTorch/CUDA port of mlx_audio_tpu.

The JAX package `mlx_audio_tpu` is the reference; this package mirrors its
layout (`nn/`, `ops/`, `dsp.py`, `model.py`, `tts/models/...`) so each module
has its counterpart at the same relative path. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper under `csrc/`, built on first use (see `ops/cuda_build.py`).

Ported so far: Kokoro-82M text -> audio (`tts.models.kokoro`) and
Qwen3-TTS text ids -> audio, dense or 8/4-bit quantized
(`tts.models.qwen3_tts`).

This package never imports jax, nor anything of the JAX package, not even
its jax-free host code: it keeps its own copies (`base.py`, `tts/g2p.py`,
`tts/textnorm.py`), each of which names the module it mirrors.

The entry points (`load_model`, each family's `Model`) build on the card
(`device="cuda"`) unless the caller passes another device, and raise
without CUDA: pass `device="cpu"` to run on the CPU.
"""

__all__ = ["load_model"]


def load_model(model_path, **kwargs):
    """Load a local TTS checkpoint directory into the port (see tts.utils)."""
    from .tts.utils import load_model as _load

    return _load(model_path, **kwargs)
