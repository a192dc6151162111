"""LoRA deltas applied to and removed from a model's dense linears.

Counterpart of mlx_audio_tpu/stt/models/mega_asr/lora.py: a delta is
scaling x (B @ A) (`materialize_delta`, :33-36); factor files hold
`<module>.lora_A` / `.lora_B` pairs with the scaling folded in
(`load_lora_factors`, :39-49); `apply_deltas` (:99-110) adds or subtracts
each delta at its dotted module path. JAX's PEFT directory reader
(`load_lora_adapter`, :52-87) is not ported: no loader calls it.

Where the JAX package rebuilds its parameter tree, the port writes the
module's weight in place, computing the delta in f32 on the weight's
device and adding it in the weight's dtype. `check_deltas` names, before
any request, an adapter path that is no dense linear of the model or whose
delta has the wrong shape (JAX's `_leaf` raises TypeError on a quantized
linear only when the first routed request applies it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ....nn import Linear

LoraModule = Dict[str, object]      # {"A": (r, in), "B": (out, r),
#                                      "scaling": float}


def materialize_delta(module: LoraModule, device=None) -> torch.Tensor:
    """scaling x (B @ A) in f32 on `device` (the factors' own device when
    None)."""
    a = torch.as_tensor(module["A"], dtype=torch.float32, device=device)
    b = torch.as_tensor(module["B"], dtype=torch.float32, device=device)
    return float(module["scaling"]) * (b @ a)


def to_device(adapter: Dict[str, LoraModule],
              device) -> Dict[str, LoraModule]:
    """The adapter with its factors as f32 tensors on `device`."""
    return {p: {"A": torch.as_tensor(m["A"], dtype=torch.float32,
                                     device=device),
                "B": torch.as_tensor(m["B"], dtype=torch.float32,
                                     device=device),
                "scaling": float(m["scaling"])}
            for p, m in adapter.items()}


def load_lora_factors(path) -> Dict[str, LoraModule]:
    """<module>.lora_A/.lora_B safetensors -> adapter dict (scaling 1)."""
    from safetensors.numpy import load_file
    raw = load_file(str(path))
    a = {k[:-len(".lora_A")]: v for k, v in raw.items()
         if k.endswith(".lora_A")}
    b = {k[:-len(".lora_B")]: v for k, v in raw.items()
         if k.endswith(".lora_B")}
    return {m: {"A": np.asarray(v, np.float32),
                "B": np.asarray(b[m], np.float32), "scaling": 1.0}
            for m, v in a.items()}


def _leaf(model: torch.nn.Module, path: str) -> Linear:
    try:
        m = model.get_submodule(path)
    except AttributeError:
        raise TypeError(f"LoRA path {path!r} names no module of the "
                        f"model") from None
    if not isinstance(m, Linear):
        raise TypeError(f"LoRA path {path!r} does not resolve to a dense "
                        f"linear ({type(m).__name__})")
    return m


def check_deltas(model: torch.nn.Module,
                 adapter: Dict[str, LoraModule]) -> None:
    """Raise, naming the path, where an adapter's module is no dense
    linear of `model` or its delta's shape is not the weight's."""
    for path, module in adapter.items():
        w = _leaf(model, path).weight
        shape = (np.shape(module["B"])[0], np.shape(module["A"])[1])
        if shape != tuple(w.shape):
            raise ValueError(f"{path}: delta {shape} != weight "
                             f"{tuple(w.shape)}")


@torch.no_grad()
def apply_deltas(model: torch.nn.Module, adapter: Dict[str, LoraModule],
                 sign: float = 1.0) -> torch.nn.Module:
    """Add sign x scaling x (B @ A) to the weight at each path, in place;
    returns the model."""
    check_deltas(model, adapter)
    for path, module in adapter.items():
        w = _leaf(model, path).weight
        delta = materialize_delta(module, w.device).to(w.dtype)
        w.add_(delta if sign > 0 else -delta)
    return model


__all__ = ["materialize_delta", "to_device", "load_lora_factors",
           "check_deltas", "apply_deltas"]
