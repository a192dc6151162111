"""Codec loader of the port: a local codec directory (config.json +
weights) -> the codec model, the counterpart of the JAX package's
`base_load_model(path, category="codec", model_remapping=...)`
(mlx_audio_tpu/utils.py:288-403), which Orpheus calls for its `snac/` or
`codec/` subfolder (mlx_audio_tpu/tts/models/llama/orpheus.py:389-398) and
OuteTTS for its `codec/` DAC (tts/models/outetts/outetts.py:300-310).

Local only (a missing directory raises FileNotFoundError: the port never
downloads) and strict: the family's `sanitize` gives the JAX tree, which
`model.load_jax_params` binds; a parameter the checkpoint lacks, or a
leaf it has over, raises. A directory the convert CLI wrote is bound with
no sanitize.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict, Optional, Union

from ..model import check_device, load_jax_params
from ..utils import (get_model_name_parts, is_converted, load_config,
                     load_weights, resolve_family)

# codec families the port has, by model type
MODEL_REMAPPING = {"snac": "snac", "dac": "descript", "descript": "descript",
                   "encodec": "encodec", "dacvae": "dacvae"}
PORTED = ("snac", "descript", "encodec", "dacvae")


def load_model(model_path: Union[str, Path], device="cuda",
               model_remapping: Optional[Dict[str, str]] = None,
               model_name_parts=None, **config_overrides):
    """Load a local codec directory onto `device` (the card by default;
    without CUDA it raises unless given `device="cpu"`). The family comes
    from the config's model_type, else the directory name's parts, through
    `model_remapping` (default MODEL_REMAPPING)."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path} "
                                f"(the port never downloads)")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    remapping = MODEL_REMAPPING if model_remapping is None else model_remapping
    family = resolve_family(config.get("model_type"), model_name_parts
                            or get_model_name_parts(path), remapping)
    if family not in PORTED:
        raise ValueError(f"codec model type {config.get('model_type')!r} "
                         f"(family {family!r}) is not ported to "
                         f"mlx_audio_tpu_torch (ported: {', '.join(PORTED)})")
    module = importlib.import_module(f".models.{family}", __package__)
    model = module.Model(module.ModelConfig.from_dict(config), device=device)
    weights = load_weights(path)
    if not is_converted(config):
        weights = model.sanitize(weights)
    return load_jax_params(model, weights)
