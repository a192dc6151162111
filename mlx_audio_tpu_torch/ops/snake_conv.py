"""Fused AdaIN -> Snake -> dilated conv1d (ISTFTNet generator legs).

Counterpart of mlx_audio_tpu/ops/snake_conv_pallas.py. Pieces:

* `fold_adain`: instance-norm statistics and the AdaIN affine folded into
  one per-(batch, channel) scale/shift pair.
* `adain_snake_conv1d_reference`: the plain PyTorch version (snake in f32,
  rounded to x.dtype, conv with f32 accumulation, f32 bias, masks in and
  out), the composition of tests/test_snake_conv_pallas.py:83-102.
* `snake_conv_kernel`: the binding of the hand-written CUDA kernel K1
  (csrc/snake_conv.cu), with its launch counts.
* `pack_weight` / `kernel_weight`: the weight layout each kernel path
  takes, made once when a model binds its weights (the generator's
  `AdaINResBlock1.pack_kernel_weights`), never per call.

K1 has three paths (csrc/snake_conv.cu says how each is built), and
`choose_path` picks one by a static rule on (dtype, C):

* "wgmma": bf16 x with C a multiple of 64 up to 256 (Kokoro's 128 and
  256): warp-specialised wgmma over all C output channels per block, w
  streamed as pre-packed tiles (`pack_weight`);
* "wmma": the first design, for other bf16 C (a multiple of 32);
* "f32": f32 x, CUDA-core FMAs.

A caller may name a path (`path=`) to time or test it; the path then
raises on what it does not take. Every path takes a halo (k-1)/2*dil of at
most MAX_HALO.

`adain_snake_conv1d` dispatches on the device of `x`: a CPU tensor takes
the plain version; any other tensor goes to the kernel, which raises on a
device, dtype or shape it does not take. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["fold_adain", "adain_snake_conv1d", "adain_snake_conv1d_reference",
           "snake_conv_kernel", "SnakeConvKernel", "choose_path",
           "pack_weight", "unpack_weight", "kernel_weight", "PATHS"]

PATHS = ("wgmma", "wmma", "f32")
# Largest (k-1)/2*dilation the kernels' shared-memory slabs hold
# (MAX_HALO in csrc/snake_conv.cu). Kokoro's largest is k=11, dil=5: 25.
MAX_HALO = 32
# wmma and f32: input channels per chunk (CK in csrc/snake_conv.cu)
CHANNEL_CHUNK = 32
# wgmma: input channels per weight tile and slab chunk, and the widest C
# one block holds (the wgmma's N)
WGMMA_CHUNK, WGMMA_MAX_C = 64, 256


def choose_path(dtype: torch.dtype, c: int) -> str:
    """The path K1 takes for x of `dtype` with `c` channels."""
    if dtype == torch.float32:
        return "f32"
    if c % WGMMA_CHUNK == 0 and c <= WGMMA_MAX_C:
        return "wgmma"
    return "wmma"


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """WIO (k, C, C) -> the wgmma path's tiles (C/64, k, 8, C, 8):
    packed[cc, j, q, o, e] = w[j, cc*64 + q*8 + e, o]. Each (cc, j) tile is
    one contiguous copy into shared memory, in the wgmma's no-swizzle
    K-major form (16-byte core-matrix rows of 8 input channels, output
    channels 16 bytes apart)."""
    k, c, o = w.shape
    if c != o or c % WGMMA_CHUNK:
        raise ValueError(f"w must be (k, C, C) with C a multiple of "
                         f"{WGMMA_CHUNK}, got {tuple(w.shape)}")
    return (w.reshape(k, c // 64, 8, 8, o).permute(1, 0, 2, 4, 3)
            .contiguous())


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_weight`: (C/64, k, 8, C, 8) -> WIO (k, C, C)."""
    nch, k, _, c, _ = packed.shape
    return packed.permute(1, 0, 2, 4, 3).reshape(k, nch * 64, c)


def kernel_weight(w: torch.Tensor, path: str) -> torch.Tensor:
    """The weight `path` takes, from WIO `w` (k, C, C): packed tiles for
    wgmma, WIO contiguous for wmma and f32. A copy: callers on the main
    path make it once, when the weights are bound."""
    if path == "wgmma":
        return pack_weight(w)
    if path not in PATHS:
        raise ValueError(f"unknown snake_conv path {path!r}; one of {PATHS}")
    return w.contiguous()


def fold_adain(mean, var, gamma, beta, eps: float = 1e-5):
    """(1+gamma)*(x-mean)*rsqrt(var+eps) + beta == x*scale + shift (f32)."""
    r = torch.rsqrt(var.float() + eps)
    scale = (1.0 + gamma.float()) * r
    shift = beta.float() - mean.float() * scale
    return scale, shift


def adain_snake_conv1d_reference(
    x: torch.Tensor,                 # (B, T, C)
    scale: torch.Tensor,             # (B, C) f32
    shift: torch.Tensor,             # (B, C) f32
    alpha: torch.Tensor,             # (C,)
    w: torch.Tensor,                 # (k, C, C) WIO
    bias: Optional[torch.Tensor] = None,   # (C,)
    *,
    dilation: int = 1,
    valid_len: Optional[torch.Tensor] = None,  # (B,) int
) -> torch.Tensor:
    """conv1d(snake(x*scale + shift), w, padding='same', dilation) + bias,
    rows at/after valid_len zeroed on the way in and out. Returns x.dtype."""
    t = x.shape[1]
    k = w.shape[0]
    a = alpha.float().reshape(-1)
    h = x.float() * scale.float()[:, None, :] + shift.float()[:, None, :]
    h = h + (1.0 / a) * torch.sin(a * h) ** 2
    keep = None
    if valid_len is not None:
        keep = (torch.arange(t, device=x.device)[None, :]
                < valid_len.to(x.device)[:, None])[..., None]
        h = torch.where(keep, h, 0.0)
    # round h and w to the compute dtype, then convolve in f32: products of
    # bf16 values are exact in f32, so this is f32 accumulation
    h = h.to(x.dtype).float()
    wt = w.to(x.dtype).float().permute(2, 1, 0)          # WIO -> (O, I, k)
    pad = (k - 1) // 2 * dilation
    out = F.conv1d(h.transpose(1, 2), wt, padding=pad,
                   dilation=dilation).transpose(1, 2)
    if bias is not None:
        out = out + bias.float()
    if keep is not None:
        out = torch.where(keep, out, 0.0)
    return out.to(x.dtype)


class SnakeConvKernel:
    """ctypes binding of csrc/snake_conv.cu.

    `launches` counts kernel launches and `path_launches` counts them by
    path (plain ints; callers may reset them). The library is built with
    nvcc on the first call."""

    _FUNCS = {"f32": "snake_conv1d_f32", "wmma": "snake_conv1d_bf16",
              "wgmma": "snake_conv1d_wgmma"}

    def __init__(self):
        self.launches = 0
        self.path_launches = dict.fromkeys(PATHS, 0)
        self._lib = None
        self._devices = set()   # devices whose snake_conv_init has run

    def build(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load

            lib = load("snake_conv")
            for name in self._FUNCS.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            lib.snake_conv_init.argtypes = []
            lib.snake_conv_init.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _lib_on(self, device: torch.device) -> ctypes.CDLL:
        """The library, with snake_conv_init run once on `device`
        (current)."""
        lib = self.build()
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        if idx not in self._devices:
            rc = lib.snake_conv_init()
            if rc != 0:
                raise RuntimeError(f"snake_conv_init failed: CUDA error {rc}")
            self._devices.add(idx)
        return lib

    def __call__(self, x, scale, shift, alpha, w, bias=None, *,
                 dilation: int = 1, valid_len=None,
                 path: Optional[str] = None) -> torch.Tensor:
        """K1 by `path` (default: `choose_path`); `w` in that path's layout
        (`kernel_weight`)."""
        if x.device.type != "cuda":
            raise ValueError(f"snake_conv kernel needs a CUDA tensor, got "
                             f"{x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"snake_conv kernel takes float32 or bfloat16, "
                            f"got {x.dtype}")
        if x.ndim != 3:
            raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
        b, t, c = x.shape
        path = choose_path(x.dtype, c) if path is None else path
        k = self._check(path, x.dtype, c, w)
        if not 1 <= b <= 65535:
            raise ValueError(f"batch {b} outside [1, 65535]")
        if (k - 1) // 2 * dilation > MAX_HALO or dilation < 1:
            raise ValueError(f"k={k}, dilation={dilation}: halo above "
                             f"{MAX_HALO}")
        if bias is None:
            bias = torch.zeros(c, dtype=torch.float32, device=x.device)
        if valid_len is None:
            valid_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
        want = {"scale": (scale, torch.float32, (b, c)),
                "shift": (shift, torch.float32, (b, c)),
                "alpha": (alpha, torch.float32, (c,)),
                "w": (w, x.dtype, tuple(w.shape)),
                "bias": (bias, torch.float32, (c,)),
                "valid_len": (valid_len, torch.int32, (b,))}
        for name, (v, dtype, shape) in want.items():
            if v.device != x.device or v.dtype != dtype:
                raise TypeError(f"{name}: want {dtype} on {x.device}, got "
                                f"{v.dtype} on {v.device}")
            if tuple(v.shape) != shape or not v.is_contiguous():
                raise ValueError(f"{name}: want contiguous {shape}, got "
                                 f"{tuple(v.shape)}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        out = torch.empty_like(x)
        if t == 0:
            return out
        for v in (x, w, out):
            if v.data_ptr() % 16:
                raise ValueError("x, w and out must be 16-byte aligned")
        with torch.cuda.device(x.device):
            fn = getattr(self._lib_on(x.device), self._FUNCS[path])
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                    alpha.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    valid_len.data_ptr(), out.data_ptr(), b, t, c, k,
                    dilation, stream)
        if rc != 0:
            raise RuntimeError(f"snake_conv kernel ({path}) launch failed: "
                               f"CUDA error {rc}")
        self.launches += 1
        self.path_launches[path] += 1
        return out

    @staticmethod
    def _check(path: str, dtype: torch.dtype, c: int, w) -> int:
        """Raise unless `path` takes (dtype, C) and `w` is in its layout;
        -> k."""
        if path not in PATHS:
            raise ValueError(f"unknown snake_conv path {path!r}; one of "
                             f"{PATHS}")
        if (path == "f32") != (dtype == torch.float32):
            raise TypeError(f"the {path} path does not take {dtype}")
        if path == "wgmma":
            if c % WGMMA_CHUNK or c > WGMMA_MAX_C:
                raise ValueError(f"the wgmma path takes C a multiple of "
                                 f"{WGMMA_CHUNK} up to {WGMMA_MAX_C}, got {c}")
            if (w.ndim != 5 or w.shape[0] != c // 64
                    or w.shape[2:] != (8, c, 8) or w.shape[1] % 2 == 0):
                raise ValueError(f"w must be pack_weight's (C/64, k, 8, C, "
                                 f"8) with odd k, got {tuple(w.shape)}")
            return w.shape[1]
        if c % CHANNEL_CHUNK:
            raise ValueError(f"channels {c} not a multiple of {CHANNEL_CHUNK}")
        if w.ndim != 3 or w.shape[1:] != (c, c) or w.shape[0] % 2 == 0:
            raise ValueError(f"w must be (k, {c}, {c}) with odd k, got "
                             f"{tuple(w.shape)}")
        return w.shape[0]


snake_conv_kernel = SnakeConvKernel()


def adain_snake_conv1d(x, scale, shift, alpha, w, bias=None, *,
                       dilation: int = 1, valid_len=None,
                       kernel_w: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Same contract as `adain_snake_conv1d_reference`, with w in WIO.

    A CPU tensor takes the plain version; any other device launches the
    CUDA kernel by `choose_path` or raises. `kernel_w` is w already in that
    path's layout (`kernel_weight`), as the generator keeps it; without it
    the layout is made here, a copy per call."""
    if x.device.type == "cpu":
        return adain_snake_conv1d_reference(
            x, scale, shift, alpha, w, bias, dilation=dilation,
            valid_len=valid_len)
    path = choose_path(x.dtype, x.shape[-1])
    if kernel_w is None:
        kernel_w = kernel_weight(w.to(x.dtype), path)
    return snake_conv_kernel(
        x.contiguous(), scale.float().contiguous(), shift.float().contiguous(),
        alpha.float().reshape(-1).contiguous(), kernel_w,
        None if bias is None else bias.float().contiguous(),
        dilation=dilation, path=path,
        valid_len=None if valid_len is None else valid_len.to(torch.int32))
