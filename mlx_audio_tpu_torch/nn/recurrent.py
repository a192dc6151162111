"""Masked bidirectional LSTM, and the LSTM cell a recurrent step carries.

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

`LSTMCell` is the unidirectional single step (the JAX package's
`init_lstm` leaf, whose names `weight_ih`, `weight_hh`, `bias_ih`,
`bias_hh` are torch's `nn.LSTMCell`'s): a caller that carries (h, c)
across calls, as a streaming model does, steps it itself.

`LSTM` is one unidirectional LSTM layer run over a whole sequence.

`GRU` is one unidirectional torch-semantics GRU layer (gate order r, z, n;
n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), as the JAX package's
`_gru_cell` in sts/models/deepfilternet/network.py), `nn.GRU` itself, so
the card runs cuDNN's; it carries its final state out for a streaming
caller. Its JAX leaf `{weight_ih, weight_hh, bias_ih, bias_hh}` maps onto
torch's `weight_ih_l0`, ... in `model.load_jax_params`.

BiLSTM's parameter names are torch's (`weight_ih_l0`, `weight_ih_l0_reverse`, ...),
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


class LSTMCell(nn.LSTMCell):
    """One LSTM step (B, I), (h, c) (B, H) each -> (h, c); gate order
    (i, f, g, o), as the JAX package's cell step."""


class LSTM(nn.LSTM):
    """Single-layer unidirectional LSTM on (B, T, I) from a zero state ->
    (B, T, H): the JAX package's `apply_lstm` of one `init_lstm` leaf
    (EnCodec stacks them), `nn.LSTM` itself, so the card runs cuDNN's. Its
    JAX leaf maps onto `weight_ih_l0`, ... as GRU's does."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, num_layers=1, bias=True,
                         batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class GRU(nn.GRU):
    """Single-layer GRU on (B, T, I) with a (B, H) state -> ((B, T, H),
    final state (B, H))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, num_layers=1, bias=True,
                         batch_first=True)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
        out, h = super().forward(x, None if h0 is None else h0[None])
        return out, h[0]
