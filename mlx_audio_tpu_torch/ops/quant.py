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

The microscaling fp modes (quant.py:224-320): mxfp4 and mxfp8 take a
power-of-two (E8M0) scale per group of 32, nvfp4 an E4M3-rounded scale per
group of 16; fp4 codes are E2M1 (sign << 3 | magnitude index) one per
byte, fp8 codes the uint8 bitcast of torch.float8_e4m3fn, as the JAX
package stores them. JAX's `fp_matmul` is plain XLA, not a Pallas kernel,
so the port's dequantizes the codes and calls `F.linear` on any device.

MLX pre-quantized checkpoints (quant.py:323-413): `unpack_mlx_quantized`
takes the uint32 words that hold 32/bits codes each (LSB first) at 2, 4 or
8 bits into the one-code-per-byte layout above; `maybe_quantize_tree`
unpacks such a leaf, and makes embedding-like leaves dense.
`dequantize_tree` and `mixed_quant_predicate` (:456-503) serve the
convert CLI.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .qmm import qmm_kernel

__all__ = ["quantize_weight", "dequantize_weight", "qmatmul",
           "qmatmul_reference", "maybe_quantize_tree", "to_i8_layout",
           "quantize_activation_i8", "int_mm", "int_mm_reference",
           "qmatmul_i8", "qmatmul_i8_reference", "tree_to_i8_layout",
           "FP_MODE_DEFAULTS", "quantize_weight_fp", "dequantize_weight_fp",
           "fp_matmul", "unpack_mlx_quantized", "dequantize_tree",
           "mixed_quant_predicate"]

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


def _is_prequantized_leaf(params: dict) -> bool:
    """An MLX-packed leaf: integer `weight` words with `scales` beside them
    (quant.py:359-365)."""
    w = params.get("weight")
    return ("scales" in params and isinstance(w, torch.Tensor)
            and not w.is_floating_point())


def _stack_layers(w: torch.Tensor, fn) -> Dict[str, torch.Tensor]:
    parts = [fn(w2) for w2 in w]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def maybe_quantize_tree(params, group_size: int = 64, bits: int = 4,
                        predicate: Optional[Callable] = None,
                        path: str = "", mode: str = "affine"):
    """Quantize every linear-like {'weight': (out, in)} dict of a nested
    tree of tensors (quant.py:368-453).

    `predicate(path, weight) -> bool | int` gates each layer; an int
    overrides the bit width (affine mode). `mode` is "affine" or one of
    FP_MODE_DEFAULTS, whose own group size then applies. Embedding-like
    leaves and widths not divisible by the group size are skipped. A 3-D
    leaf (a stacked-layer linear (L, out, in), or a conv kernel) is
    quantized layer by layer, and only when an explicit predicate vouches
    for its path. An MLX-packed leaf is unpacked at `group_size`
    (`unpack_mlx_quantized`), never re-quantized; an embedding-like one
    is dequantized to a dense f32 weight (:402-413)."""
    if not isinstance(params, dict):
        return params
    if _is_prequantized_leaf(params):
        q = unpack_mlx_quantized(
            params["weight"], params["scales"],
            params.get("biases", torch.zeros_like(params["scales"])),
            group_size)
        rest = {k: v for k, v in params.items()
                if k not in ("weight", "scales", "biases")}
        if _is_embedding(path):
            return {"weight": dequantize_weight(q), **rest}
        q.update(rest)
        return q
    w = params.get("weight")
    if isinstance(w, torch.Tensor) and w.ndim in (2, 3) \
            and not {"w_q", "w_fp4", "w_fp8"} & set(params):
        gs = group_size if mode == "affine" else FP_MODE_DEFAULTS.get(
            mode, group_size)
        ok = w.shape[-1] % gs == 0 and not _is_embedding(path)
        if w.ndim == 3 and predicate is None:
            ok = False
        verdict = True if predicate is None else predicate(path, w)
        if not (ok and verdict):
            return params
        if mode == "affine":
            layer_bits = verdict if isinstance(verdict, int) \
                and not isinstance(verdict, bool) else bits
            fn = lambda w2: quantize_weight(w2, gs, layer_bits)  # noqa: E731
        else:
            fn = lambda w2: quantize_weight_fp(w2, mode, gs)  # noqa: E731
        q = _stack_layers(w, fn) if w.ndim == 3 else fn(w)
        q.update({k: v for k, v in params.items() if k != "weight"})
        return q
    return {k: maybe_quantize_tree(v, group_size, bits, predicate,
                                   f"{path}.{k}" if path else k, mode)
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


# ---------------------------------------------------------------------------
# Microscaling fp formats (quant.py:224-320)
# ---------------------------------------------------------------------------

# E2M1 magnitudes; a code is sign << 3 | magnitude index
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP_MODE_DEFAULTS = {"mxfp4": 32, "nvfp4": 16, "mxfp8": 32}


def _fp4_encode(g: torch.Tensor) -> torch.Tensor:
    """float (..., gs) -> uint8 E2M1 codes, the nearest magnitude (the
    first of two equally near)."""
    table = torch.tensor(_FP4_VALUES, device=g.device)
    idx = torch.argmin((g.abs()[..., None] - table).abs(), dim=-1)
    return ((g < 0).to(torch.uint8) << 3) | idx.to(torch.uint8)


def _fp4_decode(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    table = torch.tensor(_FP4_VALUES, dtype=dtype, device=codes.device)
    mag = table[(codes & 7).long()]
    return torch.where((codes >> 3) > 0, -mag, mag)


def _fp8_decode(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return codes.view(torch.float8_e4m3fn).to(dtype)


def quantize_weight_fp(w: torch.Tensor, mode: str,
                       group_size: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Quantize an (out, in) weight to a microscaling fp format
    (quant.py:249-283): {'w_fp4' | 'w_fp8' uint8 (out, in), 'scales' f32
    (out, in/gs)}. mxfp4/mxfp8 scale each group by 2^(floor(log2 amax) -
    emax) (emax 2 and 8); nvfp4 by amax/6 rounded to E4M3 (at least
    2^-20). mxfp8 clips to E4M3's +-448 before the cast."""
    if mode not in FP_MODE_DEFAULTS:
        raise ValueError(f"unknown fp quant mode: {mode}")
    gs = group_size or FP_MODE_DEFAULTS[mode]
    out_f, in_f = w.shape
    if in_f % gs:
        raise ValueError(f"in_features {in_f} not a multiple of group size "
                         f"{gs}")
    g = w.reshape(out_f, in_f // gs, gs).float()
    amax = g.abs().amax(dim=-1)
    if mode == "nvfp4":
        scales = (amax / 6.0).to(torch.float8_e4m3fn).float()
        scales = torch.clamp(scales, min=2.0 ** -20)
        return {"w_fp4": _fp4_encode(g / scales[..., None]).reshape(
            out_f, in_f), "scales": scales}
    emax = 2.0 if mode == "mxfp4" else 8.0
    exp = torch.floor(torch.log2(torch.clamp(amax, min=2.0 ** -126))) - emax
    scales = torch.exp2(torch.clamp(exp, -127, 127))
    if mode == "mxfp4":
        return {"w_fp4": _fp4_encode(g / scales[..., None]).reshape(
            out_f, in_f), "scales": scales}
    q = torch.clamp(g / scales[..., None], -448.0, 448.0).to(
        torch.float8_e4m3fn)
    return {"w_fp8": q.view(torch.uint8).reshape(out_f, in_f),
            "scales": scales}


def dequantize_weight_fp(params: Dict[str, torch.Tensor],
                         dtype=torch.float32) -> torch.Tensor:
    """The dense (..., out, in) weight of an fp leaf (quant.py:291-300)."""
    q = (_fp4_decode(params["w_fp4"], dtype) if "w_fp4" in params
         else _fp8_decode(params["w_fp8"], dtype))
    scales = params["scales"].to(dtype)
    ng = scales.shape[-1]
    qg = q.reshape(q.shape[:-1] + (ng, q.shape[-1] // ng))
    return (qg * scales[..., None]).reshape(q.shape)


def fp_matmul(params: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """x (..., in) @ dequant(w)^T [+ bias] in x's dtype (quant.py:303-320).
    The codes and the scales are exact in bf16, so the weight is decoded in
    x's dtype and multiplied by `F.linear` on any device."""
    w = dequantize_weight_fp(params, x.dtype)
    bias = params.get("bias")
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


# ---------------------------------------------------------------------------
# MLX pre-quantized checkpoints, dequantization, mixed recipes
# (quant.py:323-356, 456-503)
# ---------------------------------------------------------------------------


def unpack_mlx_quantized(weight, scales, biases, group_size: int = 64
                         ) -> Dict[str, torch.Tensor]:
    """An MLX-packed leaf -> {'w_q' uint8 (out, in), 'scales', 'biases'
    f32}. MLX stores `weight` as uint32 (out, in * bits / 32), 32/bits
    codes a word, least significant first, and w = scales * q + biases.
    Only 2-, 4- and 8-bit packings are taken; a 3- or 6-bit one raises
    (its codes straddle words)."""
    scales, biases = (torch.as_tensor(np.array(a)) if isinstance(
        a, np.ndarray) else a for a in (scales, biases))
    if isinstance(weight, np.ndarray):
        weight = torch.from_numpy(weight.astype(np.int64))
    out_f, packed = weight.shape
    in_f = scales.shape[1] * group_size
    if packed == 0 or in_f % packed != 0:
        raise ValueError(
            f"cannot infer MLX quant bits: packed weight "
            f"{tuple(weight.shape)}, scales {tuple(scales.shape)}, "
            f"group_size {group_size}")
    per = in_f // packed
    if 32 % per != 0:
        raise ValueError(
            f"unsupported MLX packing: {per} codes per word "
            f"(weight {tuple(weight.shape)}, in_features {in_f})")
    bits = 32 // per
    if bits not in (2, 4, 8):
        raise ValueError(
            f"pre-quantized checkpoint uses {bits}-bit MLX packing; only "
            "2/4/8-bit supported (3/6-bit use a mixed word layout)")
    w = weight.to(torch.int64)
    shifts = torch.arange(per, device=w.device) * bits
    codes = (w[..., None] >> shifts) & ((1 << bits) - 1)
    return {"w_q": codes.reshape(out_f, in_f).to(torch.uint8),
            "scales": scales.float(), "biases": biases.float()}


def dequantize_tree(params, dtype=torch.float32):
    """Dense `weight` leaves back from the quantized subtrees of a nested
    tree (affine w_q, fp w_fp4/w_fp8): the convert CLI's --dequantize
    (quant.py:456-474)."""
    if isinstance(params, dict):
        if "w_q" in params and "scales" in params:
            out = {k: v for k, v in params.items()
                   if k not in ("w_q", "scales", "biases")}
            out["weight"] = dequantize_weight(params, dtype)
            return out
        if ("w_fp4" in params or "w_fp8" in params) and "scales" in params:
            out = {k: v for k, v in params.items()
                   if k not in ("w_fp4", "w_fp8", "scales")}
            out["weight"] = dequantize_weight_fp(params, dtype)
            return out
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_tree(v, dtype) for v in params)
    return params


def mixed_quant_predicate(recipe: str) -> Callable:
    """The `mixed_L_H` recipes (quant.py:477-503): H bits for embeddings
    and heads, and for the down/o/out projections of layer 0 and of every
    layer i with i % 6 == 5; L bits everywhere else."""
    try:
        low, high = (int(x) for x in recipe.split("_")[1:3])
    except (ValueError, IndexError):
        raise ValueError(f"unknown quant recipe: {recipe!r} "
                         "(expected e.g. 'mixed_3_6')")

    def predicate(path: str, w) -> int:
        p = path.lower()
        if any(t in p for t in ("embed", "lm_head", "head")):
            return high
        m = re.search(r"layers\.(\d+)\.", p)
        if m:
            idx = int(m.group(1))
            if idx == 0 or idx % 6 == 5:
                if "down_proj" in p or "o_proj" in p or "out_proj" in p:
                    return high
        return low

    return predicate
