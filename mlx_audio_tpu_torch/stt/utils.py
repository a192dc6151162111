"""STT loader of the port (subset of mlx_audio_tpu/stt/utils.py).

`MODEL_REMAPPING` is the JAX package's registry of STT model types, kept
whole so that a type the port does not have yet is named as such; the
families in `PORTED` are ported. `load_model` reads a local checkpoint
directory (config.json + npz or safetensors weights), maps its names onto
the JAX tree's with the family's `sanitize`, fills the model through
`model.load_jax_params`, the one place where layouts are converted, and
runs the family's `post_load_hook` (Voxtral's reads `tekken.json`, Cohere
ASR's its tokenizer and mel filterbank).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..model import check_device, load_jax_params
from ..utils import load_audio, load_config, load_weights

__all__ = ["MODEL_REMAPPING", "PORTED", "load_model", "load_audio"]

MODEL_REMAPPING = {
    "whisper": "whisper",
    "distil": "whisper",
    "voxtral_realtime": "voxtral_realtime",
    "parakeet": "parakeet",
    "parakeet_ctc": "parakeet",
    "parakeet_encoder": "parakeet",
    "wav2vec2": "mms",
    "wav2vec": "mms",
    "mms": "mms",
    "moonshine": "moonshine",
    "sensevoice": "sensevoice",
    "sense_voice": "sensevoice",
    "canary": "canary",
    "qwen3_asr": "qwen3_asr",
    "qwen3_omni_moe": "qwen3_asr",
    "mega_asr": "mega_asr",
    "glmasr": "glmasr",
    "glm_asr": "glmasr",
    "nemotron_asr": "nemotron_asr",
    "voxtral_realtime": "voxtral_realtime",
    "voxtral": "voxtral",
    "qwen2_audio": "qwen2_audio",
    "qwen2audio": "qwen2_audio",
    "cohere_asr": "cohere_asr",
    "cohere": "cohere_asr",
    "cohere2": "cohere_asr",
    "qwen3_forced_aligner": "qwen3_forced_aligner",
    "forced_aligner": "qwen3_forced_aligner",
    "lasr": "lasr_ctc",
    "lasr_ctc": "lasr_ctc",
    "fireredasr2": "fireredasr2",
    "firered_asr2": "fireredasr2",
    "fireredasr": "fireredasr2",
    "granite_speech": "granite_speech",
    "granite": "granite_speech",
    "fun_asr_nano": "fun_asr_nano",
    "funasr_nano": "fun_asr_nano",
    "fun_asr": "fun_asr_nano",
    "vibevoice_asr": "vibevoice_asr",
    "vibevoiceasr": "vibevoice_asr",
    "moss_transcribe_diarize": "moss_transcribe_diarize",
    "moss_transcribe": "moss_transcribe_diarize",
    "moss_music": "moss_music",
    "higgs_audio_3": "higgs_audio_3",
    "higgs_audio3": "higgs_audio_3",
    "granite_speech_nar": "granite_speech_nar",
    "granitespeech_nar": "granite_speech_nar",
}

# families of MODEL_REMAPPING's values that the port has
PORTED = ("whisper", "voxtral_realtime", "cohere_asr")


def model_family(config: dict, path: Path):
    """The STT family of a checkpoint: config's model_type (or
    architecture), else the directory name's first part, through
    MODEL_REMAPPING; None when it is no STT type."""
    model_type = config.get("model_type") or config.get("architecture")
    if model_type is None:
        model_type = path.name.lower().replace("_", "-").split("-")[0]
    return MODEL_REMAPPING.get(str(model_type).lower())


def load_model(model_path: Union[str, Path], device="cuda",
               **config_overrides):
    """Load a local STT model directory onto `device`: the card by
    default; without CUDA it raises, before reading anything, unless given
    `device="cpu"`. Weights load as f32; `model.astype` casts them."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    family = model_family(config, path)
    if family not in PORTED:
        raise ValueError(
            f"STT model type {config.get('model_type')!r} (family "
            f"{family!r}) is not ported to mlx_audio_tpu_torch yet (ported: "
            f"{', '.join(PORTED)})")
    if family == "whisper":
        from .models.whisper import Model, ModelDimensions

        model = Model(ModelDimensions.from_dict(config), device=device)
    elif family == "cohere_asr":
        from .models.cohere_asr import Model, ModelConfig

        model = Model(ModelConfig.from_dict(config), device=device)
    else:
        from .models.voxtral_realtime import Model, ModelConfig

        model = Model(ModelConfig.from_dict(config), device=device)
    model = load_jax_params(model, model.sanitize(load_weights(path)))
    post_load_hook = getattr(type(model), "post_load_hook", None)
    return model if post_load_hook is None else post_load_hook(model, path)
