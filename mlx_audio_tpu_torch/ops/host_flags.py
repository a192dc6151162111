"""Per-step finished flags copied to the host without blocking.

An autoregressive loop that the JAX package runs as one `lax.while_loop`
(stop when every row has finished) runs here as a Python loop of eager
steps. Reading each step's flag at once would stall the host on the
device; instead each step's flag is copied into pinned host memory behind
an event, and the loop tests the flag of an earlier step before launching
a later one, so the host stays ahead of the device and the loop stops a
fixed number of steps late.
"""

from __future__ import annotations

import torch


class FinishedFlags:
    """The finished flags (B,) of up to `n_steps` steps, copied to the host
    without blocking (pinned memory and one event per step on a GPU)."""

    def __init__(self, n_steps: int, finished: torch.Tensor):
        cuda = finished.device.type == "cuda"
        self.host = torch.empty((n_steps,) + tuple(finished.shape),
                                dtype=torch.bool, pin_memory=cuda)
        self.events = ([torch.cuda.Event() for _ in range(n_steps)]
                       if cuda else None)

    def record(self, i: int, finished: torch.Tensor) -> None:
        self.host[i].copy_(finished, non_blocking=True)
        if self.events is not None:
            self.events[i].record()

    def read(self, i: int) -> torch.Tensor:
        """Step i's flags (B,), once the device has written them."""
        if self.events is not None:
            self.events[i].synchronize()
        return self.host[i]
