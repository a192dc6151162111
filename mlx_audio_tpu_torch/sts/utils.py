"""STS loader of the port (counterpart of mlx_audio_tpu/sts/utils.py).

`MODEL_REMAPPING` is the JAX package's registry of STS model types (its
:14-23), kept whole; every family in it is in `PORTED`.
`infer_model_type_from_config` guesses a family from a config's
characteristic keys when it has no model_type (raw kyutai Moshi configs),
as the JAX loader does before dispatch (:26-58).

`load_model` reads a local checkpoint directory (config.json + npz or
safetensors weights), maps its names onto the JAX tree's with the family's
`sanitize` (an MLX pre-quantized checkpoint's packed leaves then unpacked,
`utils.unpack_prequantized`), fills the model through
`model.load_jax_params`, the one place where layouts are converted, then
quantizes the linears a config's `quantization` entry names on their
device (`utils.apply_quantization` with the family's
`model_quant_predicate`; none of a pre-quantized checkpoint's), and runs
the family's `post_load_hook`. A directory the
convert CLI wrote holds the JAX tree and skips `sanitize` and the
quantization (`utils.bind_checkpoint`). Loading is
strict: a parameter the checkpoint lacks, or a leaf it has over, raises.
A Moshi loads without a Mimi codec bound, as in the JAX package: its
`generate` then raises until a caller sets `model.mimi`. An LFM2-Audio's
hook builds its processor (the directory's tokenizer; its Mimi and
detokenizer read from their files when first used).
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Optional, Union

from ..model import check_device, load_jax_params
from ..utils import (bind_checkpoint, get_model_name_parts, load_audio,
                     load_config, load_weights, resolve_family)

__all__ = ["MODEL_REMAPPING", "PORTED", "infer_model_type_from_config",
           "model_family", "load_model", "load", "load_audio"]

MODEL_REMAPPING = {
    "sam_audio": "sam_audio",
    "moshi": "moshi",
    "deepfilternet": "deepfilternet",
    "mossformer2": "mossformer2_se",
    "mossformer2_se": "mossformer2_se",
    "mel_roformer": "mel_roformer",
    "mel_band_roformer": "mel_roformer",
    "lfm_audio": "lfm_audio",
}

# families of MODEL_REMAPPING's values that the port has
PORTED = ("sam_audio", "moshi", "mel_roformer", "deepfilternet",
          "mossformer2_se", "lfm_audio")


def infer_model_type_from_config(config: dict) -> Optional[str]:
    """Guess the STS architecture from characteristic config keys (the JAX
    package's sts/utils.py:26-38)."""
    keys = set(config.keys())
    if {"audio_encoder_args", "text_encoder_args"} & keys or "sam" in str(
            config.get("model_type", "")):
        return "sam_audio"
    if {"depformer", "dep_q"} & keys:
        return "moshi"
    if "df_order" in keys or "erb_bands" in keys:
        return "deepfilternet"
    if "mossformer" in str(config.get("model_type", "")):
        return "mossformer2_se"
    return config.get("model_type")


def model_family(config: dict, path: Path, name_parts=None):
    """The STS family of a checkpoint: its model_type (or one inferred
    from its keys), else the first of the directory name's parts, through
    MODEL_REMAPPING; None when none is an STS type."""
    model_type = (config.get("model_type") or config.get("architecture")
                  or infer_model_type_from_config(config))
    return resolve_family(model_type, name_parts or get_model_name_parts(path),
                          MODEL_REMAPPING)


def load_model(model_path: Union[str, Path], device="cuda",
               model_name_parts=None, **config_overrides):
    """Load a local STS model directory onto `device`: the card by
    default; without CUDA it raises, before reading anything, unless given
    `device="cpu"`. Weights load as f32; `model.astype` casts them."""
    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(f"Local model path not found: {model_path}")
    config = load_config(path)
    config["model_path"] = str(path)
    config.update(config_overrides)
    family = model_family(config, path, model_name_parts)
    if family not in PORTED:
        raise ValueError(
            f"STS model type {config.get('model_type')!r} (family "
            f"{family!r}) is not ported to mlx_audio_tpu_torch yet (ported: "
            f"{', '.join(PORTED)})")
    module = importlib.import_module(f".models.{family}", __package__)
    model = module.Model(module.ModelConfig.from_dict(config), device=device)
    bind_checkpoint(model, config, load_weights(path),
                    bind=lambda flat: load_jax_params(model, flat))
    post_load_hook = getattr(type(model), "post_load_hook", None)
    return model if post_load_hook is None else post_load_hook(model, path)


load = load_model
