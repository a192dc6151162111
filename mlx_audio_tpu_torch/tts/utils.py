"""TTS loader of the port (subset of mlx_audio_tpu/tts/utils.py): local
checkpoint directories of the families ported so far (Kokoro, Qwen3-TTS,
Higgs Audio v2)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..model import check_device
from ..utils import apply_quantization, load_config, load_weights

MODEL_REMAPPING = {"style_tts": "kokoro", "kokoro": "kokoro",
                   "qwen3_tts": "qwen3_tts", "higgs_audio": "higgs_audio",
                   "higgs": "higgs_audio_v3",
                   "higgs_audio_v3": "higgs_audio_v3"}
PORTED = ("kokoro", "qwen3_tts", "higgs_audio")


def load_model(model_path: Union[str, Path], device="cuda", **config_overrides):
    """Load a local model directory (config.json + weights) onto `device`:
    the card by default; without CUDA it raises, before reading the
    weights, unless given `device="cpu"`.

    The weights are the published torch-layout checkpoint; the family's
    `sanitize` maps them onto the port's parameter names. Qwen3-TTS also
    reads the codec from a `speech_tokenizer/` subfolder when there is one,
    and quantizes its AR path per config["quantization"]."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    model_type = config.get("model_type") or config.get("architecture")
    if model_type is None and "kokoro" in path.name.lower():
        model_type = "kokoro"
    family = MODEL_REMAPPING.get(str(model_type).lower())
    if family not in PORTED:
        raise ValueError(f"Model type {model_type!r} (family {family!r}) is "
                         f"not ported to mlx_audio_tpu_torch yet (ported: "
                         f"{', '.join(PORTED)})")
    if family == "qwen3_tts":
        return _load_qwen3_tts(path, config, device)
    if family == "higgs_audio":
        return _load_higgs_audio(path, config, device)
    from .models.kokoro import Model, ModelConfig

    model = Model(ModelConfig.from_dict(config), device=device)
    return model.bind(model.sanitize(load_weights(path)))


def _load_qwen3_tts(path: Path, config: dict, device):
    from .models.qwen3_tts import Model, ModelConfig

    weights = load_weights(path)
    if any(k.endswith(".scales") for k in weights):
        raise NotImplementedError("pre-quantized (MLX-packed) checkpoints are "
                                  "not ported yet; load the dense one")
    codec_dir = path / "speech_tokenizer"
    if codec_dir.is_dir():
        weights.update({f"speech_tokenizer.{k}": v
                        for k, v in load_weights(codec_dir).items()})
    model = Model(ModelConfig.from_dict(config), device=device)
    model.bind(model.sanitize(weights))
    return apply_quantization(model, config, model.model_quant_predicate)


def _load_higgs_audio(path: Path, config: dict, device):
    from .models.higgs_audio import Model, ModelConfig

    weights = load_weights(path)
    if any(k.endswith(".scales") for k in weights):
        raise NotImplementedError("pre-quantized (MLX-packed) checkpoints are "
                                  "not ported yet; load the dense one")
    model = Model(ModelConfig.from_dict(config), device=device)
    model.bind(model.sanitize(weights))
    apply_quantization(model, config, model.model_quant_predicate,
                       getattr(model, "model_i8_predicate", None))
    return Model.post_load_hook(model, path)
