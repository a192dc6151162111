"""Profile Cohere ASR (bf16, the cohere_asr_10min lane's dims) of the
PyTorch port on one GPU.

    python3 tools/profile_torch_cohere.py

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's phase 18 (seeded random weights drawn in f32 on
the card, cast to bf16) and the lane's first batch: the 8 longest segments
of 600 s of `randn * 0.1` (seed 0), in the 3,584-frame mel bucket. It
times the host mel of one segment, then, warm, the encoder on that batch
and one whole greedy decode of it (150 steps), and runs each once more
under torch.profiler with CPU and CUDA activities: for each the wall, the
device's busy time and share of the unprofiled wall, the kernels launched
(a step for the decode), and device time by kernel.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_voxtral import _profiled  # noqa: E402
from tools.profile_torch_whisper import _wall  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    card = chip_smoke.phase_device()
    print(card, flush=True)
    model = Model(ModelConfig.from_dict(chip_smoke.COHERE_FULL),
                  device="cuda").init_params(seed=0, on_device=True)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    audio = (np.random.RandomState(0).randn(chip_smoke.COHERE_SECONDS * 16000)
             * 0.1).astype(np.float32)
    segs, _ = model._prepare_segments([audio])
    batch = sorted(segs, key=len, reverse=True)[:8]
    t0 = time.perf_counter()
    model._log_mel(batch[0])
    print(f"[host mel] one {len(batch[0]) / 16000:.2f}-s segment: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms ({card})", flush=True)
    feats, lens = model.features(batch)

    def encode():
        return model.encode(feats, lens)

    enc, mask = _profiled(encode, "encoder, one 8-row batch", _wall(encode),
                          card, (1, "batch"))
    prompt = list(range(9))
    steps = chip_smoke.COHERE_MAX_TOKENS

    def decode():
        return model.decode(enc, mask, prompt, steps, 9)

    _profiled(decode, f"decode, 8 rows x {steps} steps", _wall(decode), card,
              (steps, "step"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
