"""Affine group-wise weight quantization (8-bit / 4-bit).

Counterpart of the affine part of mlx_audio_tpu/ops/quant.py:
w ~= scales * q + biases per contiguous group of `group_size` input
features; codes are stored one per byte (uint8) at either width
(quant.py:48), scales and biases in f32.

`qmatmul` dispatches on the device of x: a CPU tensor takes the plain
version (`qmatmul_reference`), a CUDA tensor launches the hand-written
kernel K2 (ops/qmm.py, csrc/qmm.cu), which raises on what it does not take.
Both follow K2's own contract (qmm_pallas.py:31-39, 72-73, 105-107): the
weight is dequantized in f32, products are summed in f32, the optional bias
is added, and the result is rounded once to x's dtype. The JAX `qmatmul`
instead rounds the scales to x's dtype and factors out the bias term; the
two agree at f32.

The fp (mxfp4/nvfp4/mxfp8) modes, the W8A8 `qmatmul_i8` layout and the
unpacking of MLX pre-quantized checkpoints are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .qmm import qmm_kernel

__all__ = ["quantize_weight", "dequantize_weight", "qmatmul",
           "qmatmul_reference", "maybe_quantize_tree"]


def quantize_weight(w: torch.Tensor, group_size: int = 64,
                    bits: int = 4) -> Dict[str, torch.Tensor]:
    """Quantize an (out, in) weight -> {'w_q' uint8 (out, in), 'scales',
    'biases' f32 (out, in/gs)}; the arithmetic of quant.py:27-55 in f32."""
    out_f, in_f = w.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not a multiple of group size "
                         f"{group_size}")
    g = w.reshape(out_f, in_f // group_size, group_size).float()
    wmax = g.amax(dim=-1)
    wmin = g.amin(dim=-1)
    n_levels = (1 << bits) - 1
    scales = torch.clamp((wmax - wmin) / n_levels, min=1e-8)
    biases = wmin
    q = torch.clamp(torch.round((g - biases[..., None]) / scales[..., None]),
                    0, n_levels)
    return {"w_q": q.reshape(out_f, in_f).to(torch.uint8),
            "scales": scales, "biases": biases}


def dequantize_weight(params: Dict[str, torch.Tensor],
                      dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense (out, in) weight; stacked (L, out, in) leaves
    dequantize layer by layer."""
    q = params["w_q"].float()
    scales, biases = params["scales"].float(), params["biases"].float()
    ng = scales.shape[-1]
    gs = q.shape[-1] // ng
    qg = q.reshape(q.shape[:-1] + (ng, gs))
    w = qg * scales[..., None] + biases[..., None]
    return w.reshape(q.shape).to(dtype)


def qmatmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                      scales: torch.Tensor, biases: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2: x (..., in) @ dequant(w_q)^T [+ bias], f32
    inside, returned in x's dtype."""
    w = dequantize_weight({"w_q": w_q, "scales": scales, "biases": biases})
    y = x.float() @ w.T
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
            biases: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ dequant(w_q (out, in))^T [+ bias] -> (..., out).

    A CPU tensor takes `qmatmul_reference`; any other device launches K2
    or raises."""
    if x.device.type == "cpu":
        return qmatmul_reference(x, w_q, scales, biases, bias)
    lead = x.shape[:-1]
    y = qmm_kernel(x.reshape(-1, x.shape[-1]).contiguous(), w_q, scales,
                   biases, bias)
    return y.reshape(lead + (w_q.shape[0],))


def _is_embedding(path: str) -> bool:
    leaf = path.rsplit(".", 1)[-1].lower()
    return any(tag in leaf for tag in ("embed", "codebook", "positional"))


def maybe_quantize_tree(params, group_size: int = 64, bits: int = 4,
                        predicate: Optional[Callable] = None,
                        path: str = ""):
    """Quantize every linear-like {'weight': (out, in)} dict of a nested
    tree of tensors (quant.py:368-453, affine mode).

    `predicate(path, weight) -> bool | int` gates each layer; an int
    overrides the bit width. Embedding-like leaves and widths not divisible
    by `group_size` are skipped. A 3-D leaf (a stacked-layer linear
    (L, out, in), or a conv kernel) is quantized layer by layer, and only
    when an explicit predicate vouches for its path."""
    if not isinstance(params, dict):
        return params
    w = params.get("weight")
    if isinstance(w, torch.Tensor) and w.ndim in (2, 3) \
            and "w_q" not in params:
        ok = w.shape[-1] % group_size == 0 and not _is_embedding(path)
        if w.ndim == 3 and predicate is None:
            ok = False
        verdict = True if predicate is None else predicate(path, w)
        if not (ok and verdict):
            return params
        layer_bits = verdict if isinstance(verdict, int) \
            and not isinstance(verdict, bool) else bits
        if w.ndim == 3:
            parts = [quantize_weight(w2, group_size, layer_bits) for w2 in w]
            q = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        else:
            q = quantize_weight(w, group_size, layer_bits)
        q.update({k: v for k, v in params.items() if k != "weight"})
        return q
    return {k: maybe_quantize_tree(v, group_size, bits, predicate,
                                   f"{path}.{k}" if path else k)
            for k, v in params.items()}
