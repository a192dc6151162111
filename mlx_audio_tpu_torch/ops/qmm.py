"""Binding of the fused dequantize + matmul kernel K2 (csrc/qmm.cu).

Counterpart of mlx_audio_tpu/ops/qmm_pallas.py. The plain version of the
same contract is `ops.quant.qmatmul_reference`; `ops.quant.qmatmul`
dispatches between the two on the device of x. Unlike the JAX package's
`qmm_auto` (qmm_pallas.py:110-137) nothing here falls back: a tensor the
kernel does not take raises.

K2 has three paths (csrc/qmm.cu says how each is built), and `choose_path`
picks one by a static rule on (dtype, M, group size):

* "gemv": M = 1 (the decode step), f32 or bf16 x;
* "mma": bf16 x at M >= MMA_MIN_ROWS, on the tensor cores;
* "simt": the first design, for f32 x at M > 1 and for a group size that is
  not a multiple of 16.

A caller may name a path (`path=`) to time or test it; the path then
raises on what it does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["QmmKernel", "qmm_kernel", "choose_path", "gemv_ksplit",
           "mma_splits", "PATHS"]

PATHS = ("gemv", "mma", "simt")
# bf16 x with at least this many rows takes the tensor-core path. Measured
# on an H100 80GB HBM3 at 700 W (PERF.md, K2 per shape), bf16, 8-bit codes,
# group 64, over the six Qwen3-TTS linear shapes: at M = 2 mma 4.67-7.77
# us, simt 7.51-14.55 us; at M = 1 gemv 2.98-5.00 us, mma 4.63-7.89, simt
# 4.89-11.03, hence M = 1 goes to the gemv.
MMA_MIN_ROWS = 2
# Rows of x per block of the simt path when M > 1 (MT in csrc/qmm.cu); the
# block holds them in shared memory as f32, all of K or tiles of it.
SIMT_ROWS = 4
# gemv and simt: warps per block; mma: weight rows per block, k columns per
# stage, tokens per block tile
WARPS, MMA_ROWS, MMA_STAGE_K, MMA_TOKENS = 8, 64, 64, 64
# blocks the mma path aims to launch, three per SM of the H100's 132: over
# forced splits of 1-16 at the six shapes and M = 2, 16, 64, 120, this rule
# came within 10% of the best split at all 24, within 5% at 19 (PERF.md)
MMA_TARGET_BLOCKS = 396
# blocks the gemv aims to launch (two per SM): over forced warps per row of
# 1, 2, 4, 8 at the six shapes this rule came within about 3% of the best
GEMV_TARGET_BLOCKS = 264


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mma_takes(gs: int) -> bool:
    return gs in (16, 32) or gs % MMA_STAGE_K == 0


def choose_path(dtype: torch.dtype, m: int, gs: int) -> str:
    """The path K2 takes for x of `dtype` with `m` rows at group size
    `gs`."""
    if m == 1 and gs % 16 == 0:
        return "gemv"
    if dtype == torch.bfloat16 and m >= MMA_MIN_ROWS and _mma_takes(gs):
        return "mma"
    return "simt"


def gemv_ksplit(n: int, k: int) -> int:
    """Warps that share one output row on the gemv path: enough that the
    grid reaches GEMV_TARGET_BLOCKS, at most 8, and each warp keeps at
    least one 16-byte code vector per lane."""
    ks = 1
    while (ks < WARPS and _cdiv(n * ks, WARPS) < GEMV_TARGET_BLOCKS
           and k // 16 >= 2 * ks * 32):
        ks *= 2
    return ks


def mma_splits(m: int, n: int, k: int, gs: int) -> int:
    """Ranges of K on the mma path (gridDim.z): enough that the grid
    reaches MMA_TARGET_BLOCKS; each range is whole groups and whole
    stages, and none is empty."""
    unit = max(gs, MMA_STAGE_K)
    units = _cdiv(k, unit)
    base = _cdiv(n, MMA_ROWS) * _cdiv(m, MMA_TOKENS)
    want = min(units, _cdiv(MMA_TARGET_BLOCKS, base))
    return _cdiv(units, _cdiv(units, want))


class QmmKernel:
    """ctypes binding of csrc/qmm.cu.

    `launches` counts calls that launched K2 (a plain int; callers may
    reset it): one per call, whatever the path. The library is built with
    nvcc on the first call."""

    _SIMT = {torch.float32: "qmm_simt_f32", torch.bfloat16: "qmm_simt_bf16"}
    _GEMV = {torch.float32: "qmm_gemv_f32", torch.bfloat16: "qmm_gemv_bf16"}

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._devices = set()   # devices whose qmm_init has run

    def build(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load

            lib = load("qmm")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in self._SIMT.values():
                getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            for name in self._GEMV.values():
                getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            lib.qmm_mma_bf16.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            for name in (*self._SIMT.values(), *self._GEMV.values(),
                         "qmm_mma_bf16", "qmm_init"):
                getattr(lib, name).restype = ctypes.c_int
            lib.qmm_init.argtypes = []
            self._lib = lib
        return self._lib

    def _lib_on(self, device: torch.device) -> ctypes.CDLL:
        """The library, with qmm_init run once on `device` (current)."""
        lib = self.build()
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        if idx not in self._devices:
            rc = lib.qmm_init()
            if rc != 0:
                raise RuntimeError(f"qmm_init failed: CUDA error {rc}")
            self._devices.add(idx)
        return lib

    def __call__(self, x: torch.Tensor, w_q: torch.Tensor,
                 scales: torch.Tensor, biases: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 path: Optional[str] = None) -> torch.Tensor:
        """x (M, K) @ dequant(w_q (N, K))^T [+ bias] -> (M, N) in x.dtype,
        by `path` (default: `choose_path`)."""
        if x.device.type != "cuda":
            raise ValueError(f"qmm kernel needs a CUDA tensor, got {x.device}")
        if x.dtype not in self._SIMT:
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
        path = choose_path(x.dtype, m, gs) if path is None else path
        args = self._check(path, x, w_q, m, n, k, gs)
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        ptrs = [x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                biases.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr()]
        with torch.cuda.device(x.device):
            lib = self._lib_on(x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if path == "simt":
                rc = getattr(lib, self._SIMT[x.dtype])(*ptrs, m, n, k, gs,
                                                       stream)
            elif path == "gemv":
                rc = getattr(lib, self._GEMV[x.dtype])(*ptrs, n, k, gs, *args,
                                                       stream)
            else:
                (splits,) = args
                ws = (torch.empty(splits * m * n, dtype=torch.float32,
                                  device=x.device) if splits > 1 else None)
                rc = lib.qmm_mma_bf16(*ptrs, None if ws is None
                                      else ws.data_ptr(), m, n, k, gs, splits,
                                      stream)
        if rc != 0:
            raise RuntimeError(f"qmm kernel ({path}) launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        return out

    @staticmethod
    def _check(path: str, x: torch.Tensor, w_q: torch.Tensor, m: int, n: int,
               k: int, gs: int) -> tuple:
        """Raise unless `path` takes this call; -> its tuning arguments."""
        if path == "simt":
            if _cdiv(m, 1 if m == 1 else SIMT_ROWS) > 65535:
                raise ValueError(f"M={m} exceeds the grid")
            if w_q.data_ptr() % 4:
                raise ValueError("w_q must be 4-byte aligned")
            return ()
        if path not in PATHS:
            raise ValueError(f"unknown qmm path {path!r}; one of {PATHS}")
        if gs % 16:
            raise ValueError(f"the {path} path needs a group size that is a "
                             f"multiple of 16, got {gs}")
        if w_q.data_ptr() % 16 or x.data_ptr() % 16:
            raise ValueError(f"the {path} path needs x and w_q 16-byte "
                             f"aligned")
        if path == "gemv":
            if m != 1:
                raise ValueError(f"the gemv path takes M = 1, got M={m}")
            return (gemv_ksplit(n, k),)
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the mma path takes bfloat16 x, got {x.dtype}")
        if not _mma_takes(gs):
            raise ValueError(f"the mma path takes a group size of 16, 32 or "
                             f"a multiple of 64, got {gs}")
        if _cdiv(m, MMA_TOKENS) > 65535:
            raise ValueError(f"M={m} exceeds the grid")
        return (mma_splits(m, n, k, gs),)


qmm_kernel = QmmKernel()
