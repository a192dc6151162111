"""Greedy transducer decoding (TDT and RNN-T) with its state on the device.

The port's loop for the label loops of
mlx_audio_tpu/stt/models/parakeet/parakeet.py (`decode_tdt`, :288-329,
which reads the joint's logits back to the host on every step) and
mlx_audio_tpu/stt/models/nemotron_asr/nemotron_asr.py (`greedy_rnnt`,
:412-465, one `lax.while_loop`):

* the encoder side of the joint runs over the whole window as one product
  before the loop (`enc_proj`; the same row-wise math);
* the state stays on the device: the frame `t`, the symbols emitted on it,
  the prediction network's projected output and LSTM states after the last
  emitted token, the token and frame buffers and their count;
* the loop runs chunks of `JOINT_CHUNK` eager joint steps. A step is gated
  by the device's `finished` flag (t past the last frame), so a step after
  the end changes nothing. Each chunk's flag is copied to the host without
  blocking (`ops/host_flags.py`), and chunk i+1 is launched only once
  chunk i-1's flag is read: the loop stops at most one chunk late, with the
  same tokens;
* every step runs the prediction network on the step's token and keeps the
  result where the token is not blank. The JAX loops run it on emission
  only (Parakeet) or on every step from the last token (Nemotron); the
  values kept are the same.

The rules, each a `torch.where` on the device:

* TDT: the joint's logits split into `[: blank + 1]` (the token) and the
  next `len(durations)` (the duration). A non-blank token is emitted; with
  duration 0 it stays on the frame, with duration d > 0 it advances d. A
  blank advances max(d, 1).
* RNN-T: a blank advances one frame.
* Both: the `max_symbols`-th token emitted on one frame forces an advance
  of one frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ....ops.host_flags import FinishedFlags

# joint steps a chunk runs between reads of the finished flag
JOINT_CHUNK = 32

Predict = Callable[[torch.Tensor, Sequence[torch.Tensor],
                    Sequence[torch.Tensor]],
                   Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]]


def lstm_step(cells, x: torch.Tensor, h: Sequence[torch.Tensor],
              c: Sequence[torch.Tensor]):
    """One step of stacked LSTM cells (gates i, f, g, o) on x (B, H), in
    x's dtype. -> (output (B, H), [h], [c])."""
    hs, cs = [], []
    for cell, h_i, c_i in zip(cells, h, c):
        h_i, c_i = cell(x, (h_i, c_i))
        hs.append(h_i)
        cs.append(c_i)
        x = h_i
    return x, hs, cs


@dataclass
class TransducerState:
    """The decoder state after the last emitted token: the prediction
    network's output through the joint's `pred_proj` (1, J) and its LSTM
    states, one (1, H) each per layer. It carries across a long file's
    chunks."""

    pred: torch.Tensor
    h: List[torch.Tensor]
    c: List[torch.Tensor]


def initial_state(predict: Predict, blank: int, n_layers: int, hidden: int,
                  dtype: torch.dtype, device) -> TransducerState:
    """The state before any token: the prediction network on blank from
    zero LSTM states."""
    zeros = [torch.zeros(1, hidden, dtype=dtype, device=device)
             for _ in range(n_layers)]
    last = torch.full((1,), blank, dtype=torch.long, device=device)
    return TransducerState(*predict(last, zeros, zeros))


def greedy_transducer(predict: Predict,
                      joint: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                      enc_proj: torch.Tensor, n_frames: int,
                      state: TransducerState, blank: int,
                      max_symbols: int,
                      durations: Optional[Sequence[int]] = None
                      ) -> Tuple[List[int], List[int], TransducerState,
                                 Dict[str, int]]:
    """Greedy decode of `n_frames` rows of `enc_proj` (T, J), the encoder
    side of the joint. `predict(tokens (1,), h, c)` -> (pred_proj output
    (1, J), h, c); `joint(enc row (1, J), pred (1, J))` -> logits (1, C).
    `durations` set: TDT, else RNN-T. -> (tokens, their frames, the state
    after the last emitted token, {"joint_steps", "chunks", "reads"})."""
    dev = enc_proj.device
    run = {"joint_steps": 0, "chunks": 0, "reads": 0}
    if n_frames <= 0:
        return [], [], state, run
    cap = n_frames * max_symbols + 1
    toks = torch.zeros(cap, dtype=torch.long, device=dev)
    frames = torch.zeros(cap, dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    t, sym, n, steps = zero, zero, zero, zero
    pred, h, c = state.pred, list(state.h), list(state.c)
    dur_table = (None if durations is None else
                 torch.tensor(list(durations), dtype=torch.long, device=dev))
    n_dur = 0 if durations is None else len(durations)
    chunk = JOINT_CHUNK
    n_chunks = -(-n_frames * (max_symbols + 1) // chunk)
    flags = FinishedFlags(n_chunks, t >= n_frames)
    lag = 2
    for i in range(n_chunks):
        if i >= lag:
            run["reads"] += 1
            if bool(flags.read(i - lag)):
                break
        for _ in range(chunk):
            active = t < n_frames
            row = enc_proj.index_select(0, t.clamp(max=n_frames - 1)[None])
            logits = joint(row, pred)[0]
            tok = logits[:blank + 1].argmax()
            pred2, h2, c2 = predict(tok[None], h, c)
            is_blank = tok == blank
            emit = active & ~is_blank
            pred = torch.where(emit, pred2, pred)
            h = [torch.where(emit, a, b) for a, b in zip(h2, h)]
            c = [torch.where(emit, a, b) for a, b in zip(c2, c)]
            # slot n is the next free one: a step that emits nothing writes
            # there too, and the next emission overwrites it
            slot = n.clamp(max=cap - 1)[None]
            toks.index_copy_(0, slot, tok[None])
            frames.index_copy_(0, slot, t[None])
            n = n + emit
            sym = sym + emit
            if dur_table is None:
                advance, by = is_blank, 1
            else:
                dur = dur_table[logits[blank + 1:blank + 1 + n_dur].argmax()]
                advance, by = is_blank | (dur > 0), dur.clamp(min=1)
            forced = ~advance & (sym >= max_symbols)
            moved = active & (advance | forced)
            t = t + torch.where(active, torch.where(advance, by, forced.long()),
                                0)
            sym = torch.where(moved, 0, sym)
            steps = steps + active
        flags.record(i, t >= n_frames)
        run["chunks"] += 1
    host = torch.cat([torch.stack([n, steps]), toks, frames]).cpu()
    count = int(host[0])
    run["joint_steps"] = int(host[1])
    run["reads"] += 1
    tokens = host[2:2 + count].tolist()
    at = host[2 + cap:2 + cap + count].tolist()
    return tokens, at, TransducerState(pred, h, c), run


__all__ = ["JOINT_CHUNK", "TransducerState", "initial_state",
           "greedy_transducer", "lstm_step"]
