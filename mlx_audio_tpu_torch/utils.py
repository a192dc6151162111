"""Checkpoint and audio helpers (subset of mlx_audio_tpu/utils.py): flat/
nested parameter names, config.json, weight files read with numpy,
on-the-fly quantization of a model's linears (affine, and the W8A8 opt-in),
and audio files read into numpy (mono mix, polyphase resample)."""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np


def unflatten(flat: Dict[str, Any], sep: str = ".") -> dict:
    """{'a.b.c': v} -> {'a': {'b': {'c': v}}}."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten(tree: dict, prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = v
    return out


def load_config(model_path: Union[str, Path]) -> dict:
    config_file = Path(model_path) / "config.json"
    if not config_file.exists():
        raise FileNotFoundError(f"Config not found at {model_path}")
    return json.loads(config_file.read_text(encoding="utf-8"))


def load_weights(model_path: Union[str, Path],
                 keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """All *.safetensors (read with safetensors, imported only here) or,
    failing those, *.npz under model_path, as one flat {name: array}. With
    `keys`, only those of them that the files hold are read."""
    model_path = Path(model_path)
    wanted = None if keys is None else set(keys)
    weights: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(str(model_path / "*.safetensors")))
    if files:
        from safetensors import safe_open

        for wf in files:
            with safe_open(wf, framework="numpy") as f:
                for k in f.keys():
                    if wanted is None or k in wanted:
                        weights[k] = f.get_tensor(k)
        return weights
    files = sorted(glob.glob(str(model_path / "*.npz")))
    if not files:
        raise FileNotFoundError(
            f"No weight files (safetensors or npz) found in {model_path}")
    for wf in files:
        with np.load(wf) as data:
            for k in data.files:
                if wanted is None or k in wanted:
                    weights[k] = data[k]
    return weights


def apply_quantization(model, config: dict,
                       predicate: Optional[Callable] = None,
                       i8_predicate: Optional[Callable] = None):
    """Quantize `model`'s linears per config['quantization']
    (mlx_audio_tpu/utils.py:148-206): each `Linear` whose dotted name
    passes `predicate(name, weight)` and a per-name entry in the
    quantization dict (False leaves that linear dense) becomes a
    `QuantizedLinear` of `bits` and `group_size`. With bits 8 and the W8A8
    opt-in (the quantization dict's `mxu_int8`, else the environment
    variable MLX_AUDIO_TPU_MXU_INT8 set to 1, true or yes, as
    mlx_audio_tpu/utils.py:195-199 reads it), each of those whose name passes
    `i8_predicate(name)` (all when it is None; JAX's model_i8_predicate)
    then becomes an `Int8Linear`. One linear at a time, so the model never
    holds a second copy of its weights. Returns the model; without a
    quantization entry it is unchanged."""
    import torch

    from .model import replace_module
    from .nn import Int8Linear, Linear, QuantizedLinear
    from .ops.quant import maybe_quantize_tree

    quantization = config.get("quantization") or config.get(
        "quantization_config")
    if quantization is None:
        return model
    group_size = quantization.get("group_size", 64)
    bits = quantization.get("bits", 4)
    mxu_int8 = quantization.get("mxu_int8")
    if mxu_int8 is None:
        mxu_int8 = os.environ.get("MLX_AUDIO_TPU_MXU_INT8",
                                  "").strip().lower() in ("1", "true", "yes")
    to_i8 = bits == 8 and bool(mxu_int8)

    def verdict(path, w):
        if predicate is not None and not predicate(path, w):
            return False
        q = quantization.get(path, True)
        return bool(q) if isinstance(q, bool) else True

    linears = [(name, m) for name, m in model.named_modules()
               if isinstance(m, Linear)]
    with torch.no_grad():
        for name, m in linears:
            quantized = maybe_quantize_tree({"weight": m.weight.detach()},
                                            group_size, bits, verdict, name)
            if "w_q" not in quantized:
                continue
            q = QuantizedLinear(m.in_features, m.weight.shape[0], group_size,
                                bias=m.bias is not None).to(m.weight.device)
            for k in ("w_q", "scales", "biases"):
                getattr(q, k).copy_(quantized[k])
            if m.bias is not None:
                q.bias.copy_(m.bias)
            if to_i8 and (i8_predicate is None or i8_predicate(name)):
                q = Int8Linear.from_quantized(q)
            replace_module(model, name, q)
    return model


def resample_audio(audio: np.ndarray, orig_sr: int,
                   target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy `resample_poly`, kaiser window), as
    mlx_audio_tpu/utils.py:541-556."""
    if orig_sr == target_sr:
        return np.asarray(audio)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(np.asarray(audio, dtype=np.float64), up, down).astype(
        np.float32)


def load_audio(path: Union[str, Path],
               sample_rate: Optional[int] = None) -> np.ndarray:
    """Read an audio file, mix it to mono and resample it to `sample_rate`
    -> float32 numpy (mlx_audio_tpu/utils.py:555-579, which returns a jax
    array; its segment and loudness options are not ported)."""
    from . import audio_io

    audio, sr = audio_io.read(path, dtype="float32")
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        audio = resample_audio(audio, sr, sample_rate)
    return np.asarray(audio, dtype=np.float32)
