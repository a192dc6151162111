"""SNAC's three code layers as the flat 7-a-frame stream that the token-TTS
LMs emit (Orpheus, VyvoTTS).

Counterpart of `flat_codes_to_layers` / `layers_to_flat_codes` in
mlx_audio_tpu/tts/models/llama/orpheus.py (:57-86), which are also
VyvoTTS's `deinterleave_snac_codes` / `interleave_snac_codes`
(mlx_audio_tpu/tts/models/qwen3/qwen3.py:57-98): a frame is one code of
layer 1, two of layer 2 and four of layer 3, in the slot order
l1, l2, l3, l3, l2, l3, l3, each slot k offset by k x 4096.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def flat_codes_to_layers(codes) -> List[np.ndarray]:
    """Flat 7-per-frame codes (7F,), the slot offsets k x 4096 still on ->
    the 3 SNAC layers (1, F), (1, 2F), (1, 4F)."""
    frames = np.asarray(codes).reshape(-1, 7).astype(np.int64)
    l1 = frames[:, 0]
    l2 = np.stack([frames[:, 1] - 4096, frames[:, 4] - 4 * 4096],
                  axis=1).reshape(-1)
    l3 = np.stack([frames[:, 2] - 2 * 4096, frames[:, 3] - 3 * 4096,
                   frames[:, 5] - 5 * 4096, frames[:, 6] - 6 * 4096],
                  axis=1).reshape(-1)
    return [l1[None], l2[None], l3[None]]


def layers_to_flat_codes(layers: Sequence) -> np.ndarray:
    """The 3 SNAC layers (F, 2F, 4F codes) -> flat 7-per-frame codes with
    the slot offsets."""
    l1, l2, l3 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x
                             ).reshape(-1) for x in layers[:3])
    out = np.empty((len(l1), 7), np.int64)
    out[:, 0] = l1
    out[:, 1] = l2[0::2] + 4096
    out[:, 2] = l3[0::4] + 2 * 4096
    out[:, 3] = l3[1::4] + 3 * 4096
    out[:, 4] = l2[1::2] + 4 * 4096
    out[:, 5] = l3[2::4] + 5 * 4096
    out[:, 6] = l3[3::4] + 6 * 4096
    return out.reshape(-1)


__all__ = ["flat_codes_to_layers", "layers_to_flat_codes"]
