"""mlx_audio_tpu_torch: the PyTorch/CUDA port of mlx_audio_tpu.

The JAX package `mlx_audio_tpu` is the reference; this package mirrors its
layout (`nn/`, `ops/`, `dsp.py`, `model.py`, `tts/models/...`) so each module
has its counterpart at the same relative path. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper under `csrc/`, built on first use (see `ops/cuda_build.py`).

Ported so far: Kokoro-82M text -> audio (`tts.models.kokoro`);
Qwen3-TTS text ids -> audio, dense or 8/4-bit quantized, whole, streamed
or continuously batched (`tts.models.qwen3_tts`); Whisper speech -> text
with timestamps, word timestamps and a streaming session
(`stt.models.whisper`), its log-mel front end (`dsp.py`), WAV I/O
(`audio_io.py`) and the STT CLI (`python -m mlx_audio_tpu_torch.stt.generate`);
Voxtral Mini Realtime live and offline speech -> text
(`stt.models.voxtral_realtime`); Cohere ASR long-file speech -> text
(`stt.models.cohere_asr`) with the FastConformer encoder
(`stt.models.parakeet.conformer`) and the Canary decoder
(`stt.models.canary`) it shares with Parakeet and Canary.

This package never imports jax, nor anything of the JAX package, not even
its jax-free host code: it keeps its own copies (`base.py`, `audio_io.py`,
`tts/g2p.py`, `tts/textnorm.py`, `stt/models/base.py`,
`stt/models/whisper/tokenizer.py`, the tekken and Canary tokenizers, ...),
each of which names the module it mirrors.

The entry points (`load_model`, each family's `Model`) build on the card
(`device="cuda"`) unless the caller passes another device, and raise
without CUDA: pass `device="cpu"` to run on the CPU.
"""

__all__ = ["load_model"]


def load_model(model_path, device="cuda", **kwargs):
    """Load a local checkpoint directory into the port, routed by category
    as mlx_audio_tpu.utils.load_model does: a config whose model_type (or
    directory name) is an STT type goes to `stt.utils.load_model`, anything
    else to `tts.utils.load_model`. Without CUDA it raises before reading
    anything unless given `device="cpu"`."""
    from pathlib import Path

    from .model import check_device
    from .stt.utils import model_family
    from .utils import load_config

    device = check_device(device)
    path = Path(model_path).expanduser()
    try:
        config = load_config(path)
    except FileNotFoundError:
        config = {}
    if model_family(config, path) is not None:
        from .stt.utils import load_model as _load
    else:
        from .tts.utils import load_model as _load
    return _load(model_path, device=device, **kwargs)
