"""Fused AdaIN -> Snake -> dilated conv1d (ISTFTNet generator legs).

Counterpart of mlx_audio_tpu/ops/snake_conv_pallas.py. Three pieces:

* `fold_adain`: instance-norm statistics and the AdaIN affine folded into
  one per-(batch, channel) scale/shift pair.
* `adain_snake_conv1d_reference`: the plain PyTorch version (snake in f32,
  rounded to x.dtype, conv with f32 accumulation, f32 bias, masks in and
  out), the composition of tests/test_snake_conv_pallas.py:83-102.
* `snake_conv_kernel`: the binding of the hand-written CUDA kernel
  csrc/snake_conv.cu, with its launch count.

`adain_snake_conv1d` dispatches on the device of `x`: a CPU tensor takes the
plain version; any other tensor goes to the kernel, which raises on a
device, dtype or shape it does not take. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["fold_adain", "adain_snake_conv1d", "adain_snake_conv1d_reference",
           "snake_conv_kernel", "SnakeConvKernel"]

# Largest (k-1)/2*dilation the kernel's shared-memory slab holds
# (MAX_HALO in csrc/snake_conv.cu). Kokoro's largest is k=11, dil=5: 25.
MAX_HALO = 32
# Input channels per chunk in the kernel (CK in csrc/snake_conv.cu).
CHANNEL_CHUNK = 32


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

    `launches` counts kernel launches (a plain int; callers may reset it).
    The library is built with nvcc on the first call."""

    _FUNCS = {torch.float32: "snake_conv1d_f32",
              torch.bfloat16: "snake_conv1d_bf16"}

    def __init__(self):
        self.launches = 0
        self._lib = None

    def build(self) -> ctypes.CDLL:
        if self._lib is None:
            from .cuda_build import load

            lib = load("snake_conv")
            for name in self._FUNCS.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x, scale, shift, alpha, w, bias=None, *,
                 dilation: int = 1, valid_len=None) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"snake_conv kernel needs a CUDA tensor, got "
                             f"{x.device}")
        if x.dtype not in self._FUNCS:
            raise TypeError(f"snake_conv kernel takes float32 or bfloat16, "
                            f"got {x.dtype}")
        if x.ndim != 3:
            raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
        b, t, c = x.shape
        if c % CHANNEL_CHUNK:
            raise ValueError(f"channels {c} not a multiple of {CHANNEL_CHUNK}")
        if not 1 <= b <= 65535:
            raise ValueError(f"batch {b} outside [1, 65535]")
        if w.ndim != 3 or w.shape[1:] != (c, c) or w.shape[0] % 2 == 0:
            raise ValueError(f"w must be (k, {c}, {c}) with odd k, got "
                             f"{tuple(w.shape)}")
        k = w.shape[0]
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
                "w": (w, x.dtype, (k, c, c)),
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
        fn = getattr(self.build(), self._FUNCS[x.dtype])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                    alpha.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    valid_len.data_ptr(), out.data_ptr(), b, t, c, k,
                    dilation, stream)
        if rc != 0:
            raise RuntimeError(f"snake_conv kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return out


snake_conv_kernel = SnakeConvKernel()


def adain_snake_conv1d(x, scale, shift, alpha, w, bias=None, *,
                       dilation: int = 1, valid_len=None) -> torch.Tensor:
    """Same contract as `adain_snake_conv1d_reference`.

    A CPU tensor takes the plain version; any other device launches the
    CUDA kernel or raises."""
    if x.device.type == "cpu":
        return adain_snake_conv1d_reference(
            x, scale, shift, alpha, w, bias, dilation=dilation,
            valid_len=valid_len)
    return snake_conv_kernel(
        x.contiguous(), scale.float().contiguous(), shift.float().contiguous(),
        alpha.float().reshape(-1).contiguous(), w.to(x.dtype).contiguous(),
        None if bias is None else bias.float().contiguous(),
        dilation=dilation,
        valid_len=None if valid_len is None else valid_len.to(torch.int32))
