"""Profile the host side of a Moshi v0.1 step of the PyTorch port on one GPU.

    python3 tools/profile_torch_moshi.py

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's phase 33 (`config_v0_1()` drawn on the card in
bf16 from seed 0) and times the host's cost to enqueue one call of each
of a step's 337 linears at M = 1 (bf16 x; the card synchronised before and
after each pass, so the queue never fills; the median of five passes):
first `F.linear` on the bf16 weights, then, after affine q8 at group 64,
K2 through `qmatmul`. For each of the two models it then runs eight
LmGen steps warm, times eight more, and runs one more under
torch.profiler: the wall a step, the device time and kernels of the
profiled step, and the kernels that take the time.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_whisper import _dev_time  # noqa: E402

TOP, STEPS, PASSES = 10, 8, 5


def _enqueue_us(calls) -> float:
    """Host µs a call to enqueue `calls` (thunks), the median over PASSES
    passes."""
    import torch

    times = []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            call()
        times.append((time.perf_counter() - t0) * 1e6 / len(calls))
        torch.cuda.synchronize()
    return statistics.median(times)


def _linear_calls(lm, kind):
    """One M = 1 bf16 call of each of `lm`'s modules of type `kind`."""
    import torch

    xs, calls = {}, []
    for m in lm.modules():
        if isinstance(m, kind):
            if m.in_features not in xs:
                xs[m.in_features] = torch.randn(1, 1, m.in_features,
                                                device=lm.device,
                                                dtype=torch.bfloat16)
            calls.append(lambda m=m, x=xs[m.in_features]: m(x))
    return calls


def _steps(lm, label: str, card: str) -> None:
    """STEPS warm LmGen steps, STEPS timed, one profiled."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlx_audio_tpu_torch.sts.models.moshi import LmGen

    gen = LmGen(lm, max_steps=2 * STEPS + 8)
    other = np.zeros((1, lm.config.other_codebooks), np.int64)
    for _ in range(STEPS):
        gen.step(other)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        gen.step(other)
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen.step(other)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(_dev_time(e) for e in kernels) / 1e3
    print(f"[{label}] {wall_ms:.2f} ms a step unprofiled (mean of {STEPS}); "
          f"one profiled step: {device_ms:.2f} ms of device time, "
          f"{sum(e.count for e in kernels)} kernels ({card})", flush=True)
    print(f"[{label}: device time by kernel] us, calls, name")
    for e in sorted(kernels, key=_dev_time, reverse=True)[:TOP]:
        print(f"  {_dev_time(e):12.1f} {e.count:8d}  {e.key[:100]}")


def main() -> int:
    import torch

    import chip_smoke
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization

    card = chip_smoke.phase_device()
    print(card, flush=True)
    model = chip_smoke.build_moshi_full()
    lm = model.lm
    dense = _linear_calls(lm, Linear)
    n, dense_us = len(dense), _enqueue_us(dense)
    del dense       # its closures hold the bf16 linears
    _steps(lm, "bf16 step", card)
    apply_quantization(lm, {"quantization": {"bits": 8, "group_size": 64}})
    torch.cuda.empty_cache()
    k2_us = _enqueue_us(_linear_calls(lm, QuantizedLinear))
    print(f"[enqueue] host µs to enqueue one linear at M = 1 over the {n} "
          f"linears of a step (median of {PASSES} passes): F.linear bf16 "
          f"{dense_us:.1f}, K2 through qmatmul {k2_us:.1f} ({card})",
          flush=True)
    _steps(lm, "q8 step", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
