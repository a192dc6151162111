"""mlx_audio_tpu_torch: the PyTorch/CUDA port of mlx_audio_tpu.

The JAX package `mlx_audio_tpu` is the reference; this package mirrors its
layout (`nn/`, `ops/`, `dsp.py`, `model.py`, `tts/models/...`) so each module
has its counterpart at the same relative path. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper under `csrc/`, built on first use (see `ops/cuda_build.py`).

Ported so far: Kokoro-82M text -> audio (`tts.models.kokoro`);
Qwen3-TTS text ids -> audio, dense or 8/4-bit quantized, whole, streamed
or continuously batched, with voice cloning by ICL or by the x-vector
(`tts.models.qwen3_tts`); the Mimi codec (`codec.models.mimi`) and Sesame
CSM-1B on it (`tts.models.sesame`); Whisper speech -> text
with timestamps, word timestamps and a streaming session
(`stt.models.whisper`), its log-mel front end (`dsp.py`), WAV I/O
(`audio_io.py`) and the STT CLI (`python -m mlx_audio_tpu_torch.stt.generate`);
Voxtral Mini Realtime live and offline speech -> text
(`stt.models.voxtral_realtime`); Cohere ASR long-file speech -> text
(`stt.models.cohere_asr`) with the FastConformer encoder
(`stt.models.parakeet.conformer`) and the Canary decoder
(`stt.models.canary`) it shares with Parakeet and Canary; Higgs Audio
v2, KugelAudio and VibeVoice text -> audio; the Silero VAD
(`vad.models.silero_vad`) with the realtime turn detection
(`realtime_vad.py`); the OpenAI-style server (`server.py`, its studio UI in
`ui/`, the voice library `voice_store.py`) and the TTS CLI
(`python -m mlx_audio_tpu_torch.tts.generate`).

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


def load_model(model_path, category=None, device="cuda", **kwargs):
    """Load a local checkpoint directory into the port, routed by category
    as mlx_audio_tpu.load_model does (`utils.load_model`): tts, stt or vad
    by the config's model_type or the directory name. Without CUDA it
    raises before reading anything unless given `device="cpu"`."""
    from .utils import load_model as _load

    return _load(model_path, category=category, device=device, **kwargs)
