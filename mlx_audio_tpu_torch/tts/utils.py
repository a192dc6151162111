"""TTS loader of the port (subset of mlx_audio_tpu/tts/utils.py): local
checkpoint directories of the families ported so far (Kokoro)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..utils import load_config, load_weights

MODEL_REMAPPING = {"style_tts": "kokoro", "kokoro": "kokoro"}


def load_model(model_path: Union[str, Path], device="cpu", **config_overrides):
    """Load a local model directory (config.json + weights) onto `device`.

    The weights are the published torch-layout checkpoint; the family's
    `sanitize` maps them onto the port's parameter names."""
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
    if family != "kokoro":
        raise ValueError(f"Model type {model_type!r} is not ported to "
                         f"mlx_audio_tpu_torch yet (ported: kokoro)")
    from .models.kokoro import Model, ModelConfig

    model = Model(ModelConfig.from_dict(config), device=device)
    return model.bind(model.sanitize(load_weights(path)))

