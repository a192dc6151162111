"""Profile one warm Qwen3-TTS q8 request of the PyTorch port on one GPU.

    python3 tools/profile_torch_qwen3_tts.py

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit. Builds the model of chip_smoke.py's Qwen3-TTS main path (the
1.7B lane's dims, seeded random bf16 weights, AR path quantized to 8 bits),
runs the JAX lane's request (`np.arange(100, 150)`, temperature 0.9) once
to warm up and once timed, then once more under torch.profiler with CPU
and CUDA activities. Prints the wall per frame, the device's busy time and
share of the wall, device time by kernel, and host time by op.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_TOKENS = 40


def _dev_time(evt) -> float:
    """Self device time of a profiler aggregate, in us."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    chip_smoke.phase_build()
    model = chip_smoke.build_qwen3()
    kw = dict(text_ids=np.arange(100, 150)[None], temperature=0.9,
              max_tokens=MAX_TOKENS, seed=0)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (r,) = list(model.generate(**kw))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    run()
    r, wall = run()
    steps = model.last_run["decode_steps"]
    print(f"[warm] {r.token_count} frames ({steps} decode steps): wall "
          f"{wall * 1e3:.2f} ms, {wall * 1e3 / (steps + 1):.2f} ms/frame "
          f"({card})", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r, pwall = run()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(_dev_time(e) for e in kernels)
    print(f"[profiled] wall {pwall * 1e3:.2f} ms, device time "
          f"{device_us / 1e3:.2f} ms ({100 * device_us / 1e3 / (pwall * 1e3):.1f}% "
          f"of the wall) ({card})")
    by_device = sorted(kernels, key=_dev_time, reverse=True)
    print("[device time by kernel] us, calls, name")
    for e in by_device[:30]:
        if _dev_time(e) <= 0:
            break
        print(f"  {_dev_time(e):12.1f} {e.count:8d}  {e.key[:110]}")
    print("[host time by op] self CPU us, calls, name")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:30]:
        print(f"  {e.self_cpu_time_total:12.1f} {e.count:8d}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
