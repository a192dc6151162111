"""1-D interpolate (nearest / linear) on channel-last tensors.

Counterpart of mlx_audio_tpu/ops/interpolate.py. The output size is
`int(T * scale_factor)`, computed exactly as the JAX function does (not
with F.interpolate's sizing), and positions are computed in float32 in the
same order of operations.
"""

from __future__ import annotations

from typing import Optional

import torch


def interpolate1d(x: torch.Tensor, scale_factor: Optional[float] = None,
                  size: Optional[int] = None, mode: str = "nearest",
                  align_corners: bool = False) -> torch.Tensor:
    """Resize the time axis of (..., T, C) to int(T*scale) or `size`."""
    t = x.shape[-2]
    if size is None:
        size = int(t * scale_factor)
    if size == t:
        return x
    ar = torch.arange(size, dtype=torch.float32, device=x.device)
    if mode == "nearest":
        idx = torch.floor(ar * (t / size)).long().clamp(0, t - 1)
        return x.index_select(-2, idx)
    if mode == "linear":
        if align_corners and size > 1:
            pos = ar * ((t - 1) / (size - 1))
        else:
            pos = (ar + 0.5) * (t / size) - 0.5
        pos = pos.clamp(0.0, t - 1)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp(max=t - 1)
        w = (pos - lo).unsqueeze(-1)
        return (1 - w) * x.index_select(-2, lo) + w * x.index_select(-2, hi)
    raise ValueError(f"Unsupported mode: {mode}")
