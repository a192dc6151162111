"""Binding of the fused dequantize + matmul kernel K2 (csrc/qmm.cu).

Counterpart of mlx_audio_tpu/ops/qmm_pallas.py. The plain version of the
same contract is `ops.quant.qmatmul_reference`; `ops.quant.qmatmul`
dispatches between the two on the device of x. Unlike the JAX package's
`qmm_auto` (qmm_pallas.py:110-137) nothing here falls back: a tensor the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["QmmKernel", "qmm_kernel", "ROWS_PER_TILE"]

# Rows of x per block when M > 1 (MT in csrc/qmm.cu); the block holds them
# in shared memory as f32.
ROWS_PER_TILE = 4
# Dynamic shared memory one block may use on Hopper.
MAX_SMEM = 227 * 1024


class QmmKernel:
    """ctypes binding of csrc/qmm.cu.

    `launches` counts kernel launches (a plain int; callers may reset it).
    The library is built with nvcc on the first call."""

    _FUNCS = {torch.float32: "qmm_f32", torch.bfloat16: "qmm_bf16"}

    def __init__(self):
        self.launches = 0
        self._lib = None

    def build(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load

            lib = load("qmm")
            for name in self._FUNCS.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w_q: torch.Tensor,
                 scales: torch.Tensor, biases: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (M, K) @ dequant(w_q (N, K))^T [+ bias] -> (M, N) in x.dtype."""
        if x.device.type != "cuda":
            raise ValueError(f"qmm kernel needs a CUDA tensor, got {x.device}")
        if x.dtype not in self._FUNCS:
            raise TypeError(f"qmm kernel takes float32 or bfloat16 x, got "
                            f"{x.dtype}")
        if x.ndim != 2 or w_q.ndim != 2:
            raise ValueError(f"x must be (M, K) and w_q (N, K), got "
                             f"{tuple(x.shape)} and {tuple(w_q.shape)}")
        m, k = x.shape
        n = w_q.shape[0]
        if m < 1 or n < 1:
            raise ValueError(f"empty product: M={m}, N={n}")
        if w_q.shape[1] != k:
            raise ValueError(f"x has {k} columns, w_q {w_q.shape[1]}")
        if scales.ndim != 2 or scales.shape[0] != n or scales.shape[1] < 1 \
                or k % scales.shape[1]:
            raise ValueError(f"scales {tuple(scales.shape)} do not divide "
                             f"K={k} into groups")
        gs = k // scales.shape[1]
        if gs % 4:
            raise ValueError(f"group size {gs} is not a multiple of 4")
        tile = 1 if m == 1 else ROWS_PER_TILE
        if tile * k * 4 > MAX_SMEM:
            raise ValueError(f"K={k}: {tile} rows of x do not fit in shared "
                             f"memory")
        if (m + tile - 1) // tile > 65535:
            raise ValueError(f"M={m} exceeds the grid")
        want = {"w_q": (w_q, torch.uint8, (n, k)),
                "scales": (scales, torch.float32, (n, k // gs)),
                "biases": (biases, torch.float32, (n, k // gs))}
        if bias is not None:
            want["bias"] = (bias, torch.float32, (n,))
        for name, (v, dtype, shape) in want.items():
            if v.device != x.device or v.dtype != dtype:
                raise TypeError(f"{name}: want {dtype} on {x.device}, got "
                                f"{v.dtype} on {v.device}")
            if tuple(v.shape) != shape or not v.is_contiguous():
                raise ValueError(f"{name}: want contiguous {shape}, got "
                                 f"{tuple(v.shape)}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if w_q.data_ptr() % 4:
            raise ValueError("w_q must be 4-byte aligned")
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        fn = getattr(self.build(), self._FUNCS[x.dtype])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                    biases.data_ptr(), None if bias is None else bias.data_ptr(),
                    out.data_ptr(), m, n, k, gs, stream)
        if rc != 0:
            raise RuntimeError(f"qmm kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


qmm_kernel = QmmKernel()
