"""VAD loader of the port (counterpart of mlx_audio_tpu/vad/utils.py).

`MODEL_REMAPPING` is the JAX package's registry of VAD model types, kept
whole; the families in `PORTED` are ported (all four of them).
`load_model` reads a local checkpoint directory (config.json + npz or
safetensors weights), maps its names onto the JAX tree's with the family's
`sanitize`, fills the model through `model.load_jax_params` and runs the
family's `post_load_hook` (FSMN's reads `cmvn.json` or `am.mvn`). Smart
Turn's and Sortformer's `sanitize` give the JAX tree from HF-Whisper-style
and NeMo names.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Union

from ..model import check_device, load_jax_params
from ..utils import (get_model_name_parts, load_config, load_weights,
                     resolve_family)

__all__ = ["MODEL_REMAPPING", "PORTED", "load_model"]

MODEL_REMAPPING = {
    "silero": "silero_vad",
    "silero_vad": "silero_vad",
    "vad": "silero_vad",
    "sortformer": "sortformer",
    "fsmn": "fsmn",
    "smart_turn": "smart_turn",
}

# families of MODEL_REMAPPING's values that the port has
PORTED = ("silero_vad", "fsmn", "smart_turn", "sortformer")


def load_model(model_path: Union[str, Path], device="cuda",
               model_name_parts=None, **config_overrides):
    """Load a local VAD model directory onto `device`: the card by
    default; without CUDA it raises, before reading anything, unless given
    `device="cpu"`. A directory without config.json takes the family's
    default config (Silero's checkpoints carry none)."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path) if (path / "config.json").is_file() else {}
    config["model_path"] = str(path)
    config.update(config_overrides)
    model_type = config.get("model_type") or config.get("architecture")
    family = resolve_family(model_type, model_name_parts
                            or get_model_name_parts(path), MODEL_REMAPPING)
    if family not in PORTED:
        raise ValueError(
            f"VAD model type {model_type!r} (family {family!r}) is not ported "
            f"to mlx_audio_tpu_torch yet (ported: {', '.join(PORTED)})")
    module = importlib.import_module(f".models.{family}", __package__)
    model = module.Model(module.ModelConfig.from_dict(config), device=device)
    load_jax_params(model, model.sanitize(load_weights(path)))
    post_load_hook = getattr(type(model), "post_load_hook", None)
    return model if post_load_hook is None else post_load_hook(model, path)
