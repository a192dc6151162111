"""Checkpoint helpers (subset of mlx_audio_tpu/utils.py): flat/nested
parameter names, config.json, and weight files read with numpy."""

from __future__ import annotations

import glob
import json
from pathlib import Path
from typing import Any, Dict, Union

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


def load_weights(model_path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """All *.safetensors (read with safetensors, imported only here) or,
    failing those, *.npz under model_path, as one flat {name: array}."""
    model_path = Path(model_path)
    weights: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(str(model_path / "*.safetensors")))
    if files:
        from safetensors import safe_open

        for wf in files:
            with safe_open(wf, framework="numpy") as f:
                for k in f.keys():
                    weights[k] = f.get_tensor(k)
        return weights
    files = sorted(glob.glob(str(model_path / "*.npz")))
    if not files:
        raise FileNotFoundError(
            f"No weight files (safetensors or npz) found in {model_path}")
    for wf in files:
        with np.load(wf) as data:
            for k in data.files:
                weights[k] = data[k]
    return weights
