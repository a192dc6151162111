"""Profile Whisper large-v3-turbo (bf16) of the PyTorch port on one GPU.

    python3 tools/profile_torch_whisper.py

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's Whisper phase (large-v3-turbo dims, seeded random
weights drawn in f32 on the card, cast to bf16) and the first 30-s window
of its workload (600 s of `randn * 0.1`, seed 0). It times, warm, the
encoder on that window and one whole decode of it (`DecodingTask.run` with
the workload's options: greedy, timestamps, `sample_len` 100), then runs
each once more under torch.profiler with CPU and CUDA activities, and
prints for each the wall, the device's busy time and share of the
unprofiled wall, and device time by kernel; for the decode also the wall
per step.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 15


def _dev_time(evt) -> float:
    """Self device time of a profiler aggregate, in us."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _wall(fn) -> float:
    """Seconds of one warm call of fn, synchronised (the second call)."""
    import torch

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled(fn, label: str, wall: float, card: str):
    """fn under the profiler; print its device busy time against `wall`
    (fn's unprofiled wall) and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(_dev_time(e) for e in kernels) / 1e3
    print(f"[{label}] wall {wall * 1e3:.3f} ms unprofiled, {pwall * 1e3:.3f} "
          f"ms profiled; device time {device_ms:.3f} ms, "
          f"{100 * device_ms / (wall * 1e3):.1f}% of the unprofiled wall "
          f"({card})", flush=True)
    print(f"[{label}: device time by kernel] us, calls, name")
    for e in sorted(kernels, key=_dev_time, reverse=True)[:TOP]:
        if _dev_time(e) <= 0:
            break
        print(f"  {_dev_time(e):12.1f} {e.count:8d}  {e.key[:100]}")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from mlx_audio_tpu_torch.stt.models.whisper.audio import pad_or_trim
    from mlx_audio_tpu_torch.stt.models.whisper.decoding import (
        DecodingOptions, DecodingTask)

    card = chip_smoke.phase_device()
    print(card, flush=True)
    f32, model = chip_smoke.build_whisper_turbo()
    del f32
    torch.cuda.empty_cache()
    audio = (np.random.RandomState(0).randn(model.window_samples) * 0.1
             ).astype(np.float32)
    mel, _ = model._prepare_audio(audio, padding=0)
    win = pad_or_trim(mel, model.window_frames)[None]
    kw = chip_smoke.WHISPER_KW
    task = DecodingTask(model, DecodingOptions(
        language=kw["language"], sample_len=kw["sample_len"],
        without_timestamps=not kw["return_timestamps"]))
    encode = lambda: model.embed_audio(win)  # noqa: E731
    decode = lambda: task.run(win, [], temperature=0.0)  # noqa: E731
    # both walls before any profiling: timed after a profiling session,
    # the decode once ran about twice as long
    enc_wall, dec_wall = _wall(encode), _wall(decode)
    steps = task.last_steps
    print(f"[decode] {steps} steps: {dec_wall * 1e3 / steps:.3f} ms a step, "
          f"the window's encoder and prefill included; encoder alone "
          f"{enc_wall * 1e3:.3f} ms ({card})", flush=True)
    _profiled(encode, "encoder, one window", enc_wall, card)
    _profiled(decode, "decode, one window", dec_wall, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
