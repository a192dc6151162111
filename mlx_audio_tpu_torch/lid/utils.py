"""LID loader of the port (counterpart of mlx_audio_tpu/lid/utils.py).

`MODEL_REMAPPING` is the JAX package's registry of LID model types, whole;
both of its families are ported. `load_model` reads a local checkpoint
directory (config.json + npz or safetensors weights): a wav2vec2 one (HF
`Wav2Vec2ForSequenceClassification` names) through the family's
`sanitize` and `utils.bind_checkpoint`; an ECAPA one, which the JAX
package binds with no sanitize, as the JAX tree. Either is bound by
`model.load_jax_params`, strictly.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Union

from ..model import check_device, load_jax_params
from ..utils import (bind_checkpoint, get_model_name_parts, load_config,
                     load_weights, resolve_family)

__all__ = ["MODEL_REMAPPING", "PORTED", "load_model"]

MODEL_REMAPPING = {
    "ecapa": "ecapa_tdnn",
    "ecapa_tdnn": "ecapa_tdnn",
    "wav2vec2": "wav2vec2",
    "mms_lid": "wav2vec2",
}

# families of MODEL_REMAPPING's values that the port has
PORTED = ("ecapa_tdnn", "wav2vec2")


def load_model(model_path: Union[str, Path], device="cuda",
               model_name_parts=None, **config_overrides):
    """Load a local LID model directory onto `device`: the card by
    default; without CUDA it raises, before reading anything, unless given
    `device="cpu"`. The family comes from the config's model_type, else
    the directory name's parts."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    model_type = config.get("model_type") or config.get("architecture")
    family = resolve_family(model_type, model_name_parts
                            or get_model_name_parts(path), MODEL_REMAPPING)
    if family not in PORTED:
        raise ValueError(
            f"LID model type {model_type!r} (family {family!r}) is not "
            f"ported to mlx_audio_tpu_torch yet (ported: "
            f"{', '.join(PORTED)})")
    module = importlib.import_module(f".models.{family}", __package__)
    model = module.Model(module.ModelConfig.from_dict(config), device=device)
    weights = load_weights(path)
    if family == "ecapa_tdnn":
        return load_jax_params(model, weights)
    return bind_checkpoint(model, config, weights,
                           bind=lambda w: load_jax_params(model, w))


load = load_model
