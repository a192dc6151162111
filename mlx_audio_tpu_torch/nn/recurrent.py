"""Masked bidirectional LSTM.

Counterpart of mlx_audio_tpu/nn/recurrent.py (`apply_lstm`, :72-107), which
scans with a validity mask: on masked steps the carry passes through, so a
bucket-padded row gives the same valid outputs as a tight one. Every mask
on the Kokoro path is a prefix (the first `length` steps are valid), so
`nn.LSTM` over a packed sequence computes the same valid outputs: the
forward direction stops at `length`, and the backward direction starts
from a zero state at `length - 1`, as the JAX scan does after passing its
zero carry through the padded tail.

The padded steps differ: the JAX scan emits the carried h there, packing
emits zeros. Every caller masks or discards them.

Packing needs the lengths on the host, so each call with a mask syncs once
on `mask.sum(-1)`.

Parameter names are torch's (`weight_ih_l0`, `weight_ih_l0_reverse`, ...),
the names the published checkpoint uses; the JAX tree's `forward`/`backward`
sub-trees map onto them in `model.load_jax_params`. Gate order (i, f, g, o)
is the same in both.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiLSTM(nn.LSTM):
    """Single-layer bidirectional LSTM on (B, T, I) -> (B, T, 2H)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, num_layers=1, bias=True,
                         batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask (B, T) bool, True on the valid prefix of each row; padded
        steps come out as zeros."""
        if mask is None:
            return super().forward(x)[0]
        t = x.shape[1]
        lengths = mask.sum(-1).clamp(min=1).cpu()  # packing wants host lengths
        packed = pack_padded_sequence(x, lengths, batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        return pad_packed_sequence(out, batch_first=True, total_length=t)[0]
