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

The W8A8 layout (quant.py:110-225): `to_i8_layout` re-quantizes affine
codes onto a per-output-channel symmetric int8 grid, and `qmatmul_i8`
quantizes the activation per token (symmetric, round half to even, clip to
+-127), multiplies s8 x s8 -> s32 and scales the (M, out) result by the
two rank-1 scales. The JAX package computes the product with
`lax.dot_general`, not a Pallas kernel, so on the card it is
`torch._int_mm` (cuBLASLt); `qmatmul_i8_reference`, whose product is
exact (`int_mm_reference`), is what a CPU tensor takes.

The fp (mxfp4/nvfp4/mxfp8) modes and the unpacking of MLX pre-quantized
checkpoints are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .qmm import qmm_kernel

__all__ = ["quantize_weight", "dequantize_weight", "qmatmul",
           "qmatmul_reference", "maybe_quantize_tree", "to_i8_layout",
           "quantize_activation_i8", "int_mm", "int_mm_reference",
           "qmatmul_i8", "qmatmul_i8_reference", "tree_to_i8_layout"]

# torch._int_mm on CUDA takes more than 16 rows, and K and N multiples of 8;
# fewer rows are zero-padded up to this many
INT_MM_MIN_ROWS = 32


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


# ---------------------------------------------------------------------------
# W8A8: per-channel symmetric int8 weights, per-token int8 activations
# ---------------------------------------------------------------------------


def _to_i8_core(core: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    wd = dequantize_weight(core, torch.float32)
    scale = torch.clamp(wd.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wd / scale[..., None]), -127, 127)
    return {"w_i8": q.to(torch.int8), "scale": scale}


def to_i8_layout(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Affine per-group codes {w_q, scales, biases[, bias]} -> per-output-
    channel symmetric int8 {w_i8 (out, in) int8, scale (out,) f32[, bias]}:
    w_i8[o, i] = round(dequant(w)[o, i] / scale[o]), scale = max|row| / 127.
    A stacked (L, out, in) leaf converts layer by layer (the reductions are
    per row, so the arithmetic is the same)."""
    rest = {k: v for k, v in params.items()
            if k not in ("w_q", "scales", "biases")}
    out = _to_i8_core({k: params[k] for k in ("w_q", "scales", "biases")})
    out.update(rest)
    return out


def quantize_activation_i8(x: torch.Tensor):
    """x (M, in) -> (int8 codes (M, in), f32 per-row scale (M, 1)): the
    dynamic per-token symmetric quantization of qmatmul_i8."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int_mm_reference(xq: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Plain version of the s8 x s8 -> s32 product: xq (M, in) @ w_i8
    (out, in)^T, returned in int32. Summed in float64, which holds every
    partial sum exactly (each |sum| <= 127 * 127 * in < 2**53), on any
    device: CUDA has no integer matmul."""
    return (xq.double() @ w_i8.double().T).to(torch.int32)


def int_mm(xq: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """xq (M, in) int8 @ w_i8 (out, in)^T -> int32 (M, out). A CPU tensor
    takes `int_mm_reference`; a CUDA one `torch._int_mm`, with the rows
    zero-padded up to INT_MM_MIN_ROWS where there are fewer (a decode step
    has M = 1)."""
    if xq.device.type == "cpu":
        return int_mm_reference(xq, w_i8)
    m = xq.shape[0]
    if m < INT_MM_MIN_ROWS:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, w_i8.T)[:m]


def _qmatmul_i8(x, w_i8, scale, bias, mm) -> torch.Tensor:
    lead = x.shape[:-1]
    xq, sx = quantize_activation_i8(x.reshape(-1, x.shape[-1]))
    y = mm(xq, w_i8).float() * sx * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.reshape(lead + (w_i8.shape[0],)).to(x.dtype)


def qmatmul_i8_reference(x: torch.Tensor, w_i8: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of qmatmul_i8 (its product exact, int_mm_reference)."""
    return _qmatmul_i8(x, w_i8, scale, bias, int_mm_reference)


def qmatmul_i8(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ (scale * w_i8 (out, in))^T [+ bias] in W8A8
    (qmatmul_i8, quant.py:148-183): x quantized per token, the product s8
    x s8 -> s32, then both scales (and the bias) in f32; returned in x's
    dtype. A CPU tensor takes the exact plain product, a CUDA one
    torch._int_mm."""
    return _qmatmul_i8(x, w_i8, scale, bias, int_mm)


def tree_to_i8_layout(params, predicate: Optional[Callable] = None,
                      path: str = ""):
    """Convert every affine-quantized leaf {w_q, scales, ...} of a nested
    tree of tensors to the W8A8 layout (`to_i8_layout`); `predicate(path)`
    gates each leaf (quant.py:186-225). The JAX package's `consume` option,
    which deletes each source buffer as it converts, has no counterpart: a
    source tensor is freed once the caller drops the old tree."""
    if isinstance(params, dict):
        if "w_q" in params and "scales" in params:
            if predicate is None or predicate(path):
                return to_i8_layout(params)
            return params
        return {k: tree_to_i8_layout(v, predicate,
                                     f"{path}.{k}" if path else k)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_to_i8_layout(v, predicate, path)
                            for v in params)
    return params
