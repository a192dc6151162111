"""Checkpoint and audio helpers (subset of mlx_audio_tpu/utils.py): flat/
nested parameter names, config.json, weight files read with numpy,
on-the-fly quantization of a model's linears (affine, and the W8A8 opt-in),
audio files read into numpy (mono mix, polyphase resample), and the
category auto-router `load_model` (mlx_audio_tpu/utils.py:413-481) with
its name-part and category guessing (:246-285, :418-448).

Paths are local only: where the JAX package's `get_model_path` downloads a
Hugging Face snapshot (:52-80), the port raises FileNotFoundError."""

from __future__ import annotations

import glob
import importlib
import json
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

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
    """All *.safetensors (read with safetensors, imported only here;
    bfloat16 tensors as float32) or, failing those, *.npz under model_path,
    as one flat {name: numpy array}. With `keys`, only those of them that
    the files hold are read."""
    model_path = Path(model_path)
    wanted = None if keys is None else set(keys)
    weights: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(str(model_path / "*.safetensors")))
    if files:
        import torch
        from safetensors import safe_open

        for wf in files:
            # read through torch, which holds bfloat16 (numpy needs
            # ml_dtypes for it); bfloat16 arrives as float32
            with safe_open(wf, framework="pt") as f:
                for k in f.keys():
                    if wanted is None or k in wanted:
                        t = f.get_tensor(k)
                        weights[k] = (t.float() if t.dtype == torch.bfloat16
                                      else t).numpy()
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


# the marker the convert CLI writes into a config.json (the JAX package's,
# so that one converted directory loads in both packages)
CONVERTED_BY = "mlx_audio_tpu.convert"


def is_converted(config: dict) -> bool:
    """A directory the convert CLI wrote: its weights are the JAX tree,
    bound with no sanitize and no quantization (mlx_audio_tpu/utils.py:
    373-382)."""
    return config.get("converted_by") == CONVERTED_BY


def _quantization(config: dict) -> Optional[dict]:
    return config.get("quantization") or config.get("quantization_config")


def unpack_prequantized(model, config: dict,
                        weights: Dict[str, Any]) -> Dict[str, Any]:
    """The flat, sanitized tree `weights` of a pre-quantized checkpoint,
    ready to bind into `model` (the pre-quantized branch of the JAX
    package's `maybe_quantize_tree`, mlx_audio_tpu/ops/quant.py:402-413):
    each MLX-packed leaf (integer `weight` words with `scales` beside them)
    is unpacked at config['quantization']'s group size
    (`ops.quant.unpack_mlx_quantized`), an embedding-like one to a dense
    weight, and the `Linear` it belongs to is swapped for a module of its
    shapes. Every other leaf is passed on as it is. A packed leaf that is
    no linear of the model raises."""
    import torch

    from .model import _tensor, swap_quantized_linears
    from .nn import Linear
    from .ops.quant import maybe_quantize_tree

    def packed(w) -> bool:
        if isinstance(w, torch.Tensor):
            return not w.is_floating_point()
        return np.asarray(w).dtype.kind in "iu"

    quantization = _quantization(config)
    if quantization is None:
        return weights
    group_size = quantization.get("group_size", 64)
    mode = quantization.get("mode", "affine")
    out = dict(weights)
    for key in [k for k in weights if k.endswith(".scales")]:
        name = key[:-len(".scales")]
        w = weights.get(f"{name}.weight")
        if w is None or not packed(w):
            continue
        leaf = {k: _tensor(out.pop(f"{name}.{k}"))
                for k in ("weight", "scales", "biases", "bias")
                if f"{name}.{k}" in out}
        leaf = maybe_quantize_tree(leaf, group_size, path=name, mode=mode)
        out.update((f"{name}.{k}", v) for k, v in leaf.items())
    linears = {name for name, m in model.named_modules()
               if isinstance(m, Linear)}
    stray = sorted(k for k in out if k.endswith(".w_q")
                   and k[:-len(".w_q")] not in linears)
    if stray:
        raise ValueError(f"pre-quantized leaves that are not linears of "
                         f"this model: {stray[:10]}")
    swap_quantized_linears(model, out)
    return out


def apply_quantization(model, config: dict,
                       predicate: Optional[Callable] = None,
                       i8_predicate: Optional[Callable] = None,
                       pre_quantized: bool = False):
    """Quantize the bound `model`'s linears per config['quantization'] (its
    mode, group_size and bits; mlx_audio_tpu/utils.py:148-206): each
    `Linear` whose dotted name passes `predicate(name, weight)` and a
    per-name entry in the quantization dict (False leaves that linear
    dense) becomes a `QuantizedLinear` (affine) or an `FpQuantizedLinear`
    (mxfp4, nvfp4, mxfp8), one linear at a time, on its device, so the
    model never holds a second copy of its weights. With `pre_quantized`
    (the checkpoint held `*.scales`, bound by `unpack_prequantized`) no
    dense linear is quantized, as in the JAX package.

    Then, with 8-bit affine codes and the W8A8 opt-in (the quantization
    dict's `mxu_int8`, else the environment variable MLX_AUDIO_TPU_MXU_INT8
    set to 1, true or yes, as mlx_audio_tpu/utils.py:195-199 reads it),
    each `QuantizedLinear` whose name passes `i8_predicate(name)` (all when
    it is None; JAX's model_i8_predicate) becomes an `Int8Linear`. Returns
    the model; without a quantization entry it is unchanged."""
    import torch

    from .model import replace_module
    from .nn import FpQuantizedLinear, Int8Linear, Linear, QuantizedLinear
    from .ops.quant import maybe_quantize_tree

    quantization = _quantization(config)
    if quantization is None:
        return model
    group_size = quantization.get("group_size", 64)
    bits = quantization.get("bits", 4)
    mode = quantization.get("mode", "affine")
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

    with torch.no_grad():
        for name, m in list(model.named_modules()):
            if isinstance(m, Linear) and not pre_quantized:
                leaf = maybe_quantize_tree({"weight": m.weight.detach()},
                                           group_size, bits, verdict, name,
                                           mode)
                if "weight" in leaf:
                    continue
                if m.bias is not None:
                    leaf["bias"] = m.bias.detach()
                m = (QuantizedLinear if "w_q" in leaf
                     else FpQuantizedLinear).from_params(leaf)
                replace_module(model, name, m)
            if isinstance(m, QuantizedLinear) and to_i8 and (
                    i8_predicate is None or i8_predicate(name)):
                replace_module(model, name, Int8Linear.from_quantized(m))
    return model


def bind_checkpoint(model, config: dict, weights: Dict[str, Any],
                    bind: Optional[Callable] = None):
    """Bind a checkpoint's flat `weights` into `model` as the JAX package's
    `base_load_model` does (mlx_audio_tpu/utils.py:373-399): a directory
    the convert CLI wrote holds the JAX tree, bound by `load_jax_params`
    with no sanitize and no quantization. Any other goes through the
    family's `sanitize`, `unpack_prequantized` when the checkpoint holds
    `*.scales`, `bind` (default `model.bind`, the port's torch-layout
    names; a family whose `sanitize` gives the JAX tree passes
    `load_jax_params`) and then `apply_quantization` on the model's device
    with the family's predicates. Returns the model."""
    from .model import load_jax_params

    if is_converted(config):
        return load_jax_params(model, weights)
    weights = model.sanitize(weights)
    pre_quantized = any(k.endswith(".scales") for k in weights)
    if pre_quantized:
        weights = unpack_prequantized(model, config, weights)
    (bind or model.bind)(weights)
    return apply_quantization(
        model, config, getattr(model, "model_quant_predicate", None),
        getattr(model, "model_i8_predicate", None), pre_quantized)


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


# ---------------------------------------------------------------------------
# Category auto-router (mlx_audio_tpu/utils.py:246-285, 413-481)
# ---------------------------------------------------------------------------

# the JAX package's categories, in its order of precedence; the port has
# a loader for each
CATEGORIES = ("tts", "stt", "sts", "lid", "vad")


def is_valid_module_name(name: Optional[str]) -> bool:
    return bool(name) and bool(re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", name))


def get_model_name_parts(model_path: Union[str, Path]) -> List[str]:
    """Fuzzy name parts of a checkpoint's directory name, for guessing its
    architecture: dash parts, their underscore sub-parts, alphanumeric
    forms and joined n-grams ("qwen3-tts-..." -> "qwen3_tts")."""
    if isinstance(model_path, str):
        model_name = model_path.lower().split("/")[-1]
    elif isinstance(model_path, Path):
        try:
            index = model_path.parts.index("hub")
            model_name = model_path.parts[index + 1].lower().split("--")[-1]
        except ValueError:
            model_name = model_path.name.lower()
    else:
        raise ValueError(f"Invalid model path type: {type(model_path)}")

    parts: List[str] = []
    seen = set()
    dash_parts = [p for p in model_name.split("-") if p]
    for part in dash_parts:
        if part in seen:
            continue
        parts.append(part)
        seen.add(part)
        if "_" in part:
            for sub in part.split("_"):
                if sub and sub not in seen:
                    parts.append(sub)
                    seen.add(sub)
        norm = re.sub(r"[^a-z0-9]+", "", part)
        if norm and norm not in seen:
            parts.append(norm)
            seen.add(norm)
    for start in range(len(dash_parts)):
        for end in range(start + 2, len(dash_parts) + 1):
            joined = "_".join(dash_parts[start:end])
            joined = re.sub(r"[^a-z0-9_]+", "", joined)
            if joined and joined not in seen:
                parts.append(joined)
                seen.add(joined)
    return parts


def category_remapping(category: str) -> Dict[str, str]:
    """The JAX package's registry {model type: family} of `category`."""
    module = importlib.import_module(f".{category}.utils", __package__)
    return module.MODEL_REMAPPING


def resolve_family(model_type: Optional[str], name_parts: Iterable[str],
                   remapping: Dict[str, str]) -> Optional[str]:
    """The family that `model_type`, else the first of `name_parts`, names
    through `remapping` (a key, or a family itself), as the JAX package's
    `get_model_class` resolves it (utils.py:220-243); None when none does."""
    families = set(remapping.values())
    for hint in [model_type, *name_parts]:
        if hint is None:
            continue
        hint = str(hint).lower()
        family = remapping.get(hint, hint)
        if family in families:
            return family
    return None


def get_model_category(model_type: Optional[str],
                       model_name: List[str]) -> Optional[str]:
    """The category of a checkpoint, from its model_type and name parts.

    A model_type that one category's registry names (as a key or a
    family) decides. Otherwise, and where two categories' registries name
    it (`wav2vec2`: MMS's STT and MMS-LID's LID), the JAX package's
    precedence (utils.py:418-448) over the model_type and the name parts:
    a category word among them, then a registry key, then a family name.
    (The JAX package lets a name part outrank the model_type: a Voxtral
    Realtime checkpoint in a directory whose name holds "voxtral", a TTS
    key, goes to its TTS loader and fails there.)"""
    cats = [(c, category_remapping(c)) for c in CATEGORIES]
    if model_type:
        named = [category for category, remap in cats
                 if model_type in remap or model_type in set(remap.values())]
        if len(named) == 1:
            return named[0]
    candidates = ([model_type] if model_type else []) + list(model_name or [])
    for category, remap in cats:
        if category in candidates and resolve_family(
                None, candidates, remap) is not None:
            return category
    for category, remap in cats:
        if any(hint in remap for hint in candidates):
            return category
    families = [(c, set(remap.values())) for c, remap in cats]
    for category, fams in families:
        if any(is_valid_module_name(h) and h in fams for h in candidates):
            return category
    return None


def load_model(model_path: Union[str, Path], category: Optional[str] = None,
               device="cuda", **kwargs):
    """Load a local checkpoint directory into the port, its category found
    as mlx_audio_tpu.utils.load_model finds it (config's model_type, then
    the directory name's parts) unless `category` is given, then its
    family by that category's loader (`tts.utils`, `stt.utils`,
    `sts.utils`, `lid.utils` or `vad.utils`). Without CUDA it raises before
    reading anything unless given `device="cpu"`. A path that is not a local
    directory raises FileNotFoundError (the port never downloads); a family
    the port lacks, or a category that is none, raises ValueError naming
    it."""
    from .model import check_device

    device = check_device(device)
    path = Path(model_path).expanduser()
    if not path.is_dir():
        raise FileNotFoundError(
            f"Local model path not found: {model_path} (the port loads local "
            f"checkpoint directories only; it never downloads)")
    name_parts = get_model_name_parts(path)
    model_type = kwargs.get("model_type")
    if model_type is None and (path / "config.json").is_file():
        config = load_config(path)
        model_type = config.get("model_type") or config.get("architecture")
    category = category or get_model_category(model_type, name_parts)
    if category is None:
        raise ValueError(f"Could not determine model category for "
                         f"'{model_path}' (model_type={model_type})")
    if category not in CATEGORIES:
        raise ValueError(f"Unknown model category {category!r} (categories: "
                         f"{', '.join(CATEGORIES)})")
    loader = importlib.import_module(f".{category}.utils", __package__)
    return loader.load_model(path, device=device, model_name_parts=name_parts,
                             **kwargs)
