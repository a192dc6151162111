"""Profile Voxtral-Mini-3B-Realtime (bf16) of the PyTorch port on one GPU.

    python3 tools/profile_torch_voxtral.py

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's phase 16 (ModelConfig() dims, seeded random
weights drawn in f32 on the card, cast to bf16) and drives a live session
with its workload (`randn * 0.1`, seed 0, 1-s feeds each followed by
`step(max_decode_tokens=16)`). After eight warm steps it times three
steady steps, then runs one more step under torch.profiler with CPU and
CUDA activities; then, alone, one decode token (`decoder_forward` at
position 100, the logits and the argmax) and one ENC_CHUNK encoder step,
timed warm, then profiled. For each it prints the wall, the device's busy
time and share of the unprofiled wall, the kernels launched, and device
time by kernel.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_whisper import _dev_time, _wall  # noqa: E402

TOP = 12


def _profiled(fn, label: str, wall: float, card: str, per=None):
    """fn under the profiler: its device busy time against `wall` (fn's
    unprofiled wall), the kernels launched (per `per` units if given) and
    the kernels that take the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(_dev_time(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    unit = f", {launches / per[0]:.0f} a {per[1]}" if per else ""
    print(f"[{label}] wall {wall * 1e3:.3f} ms unprofiled; device time "
          f"{device_ms:.3f} ms, {100 * device_ms / (wall * 1e3):.1f}% of the "
          f"unprofiled wall; {launches} kernels launched{unit} ({card})",
          flush=True)
    print(f"[{label}: device time by kernel] us, calls, name")
    for e in sorted(kernels, key=_dev_time, reverse=True)[:TOP]:
        if _dev_time(e) <= 0:
            break
        print(f"  {_dev_time(e):12.1f} {e.count:8d}  {e.key[:100]}")
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        TekkenTokenizer, voxtral_realtime as vr)
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime.streaming import (
        ENC_CHUNK, RING_CAP, encoder_stream_step)

    card = chip_smoke.phase_device()
    print(card, flush=True)
    model = chip_smoke.build_voxtral_full().astype(torch.bfloat16)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_tekken(Path(tmp) / "tekken.json", 1000,
                                model.config.decoder.vocab_size)
        model._tokenizer = TekkenTokenizer(str(Path(tmp) / "tekken.json"))
    audio = (np.random.RandomState(0).randn(16000 * 16) * 0.1).astype(
        np.float32)
    sess = model.create_streaming_session()
    second = iter(range(16))

    def one_step():
        i = next(second)
        sess.feed(audio[i * 16000:(i + 1) * 16000])
        sess.step(max_decode_tokens=16)
        return len(sess.generated), sess._enc_off

    for _ in range(8):
        one_step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    tok0, enc0 = len(sess.generated), sess._enc_off
    tok1, enc1 = _profiled(one_step, "one steady 1-s step",
                           sorted(walls)[1], card)
    print(f"[one steady 1-s step] {tok1 - tok0} tokens, "
          f"{(enc1 - enc0) / ENC_CHUNK:.2f} encoder steps of {ENC_CHUNK} "
          f"frames; unprofiled walls {[round(w * 1e3, 2) for w in walls]} ms",
          flush=True)

    # one decode token alone, at position 100 of a fresh cache
    caches = model.decoder_caches(2048)
    ffn_w = model.ffn_norm_weights(6)
    emb = torch.randn(1, 1, model.config.decoder.dim, device="cuda",
                      dtype=model.dtype)

    def token():
        with torch.inference_mode():
            h = vr.decoder_forward(model, emb, ffn_w, caches, 100)
            return vr.logits(model, h[0]).argmax(-1)

    _profiled(token, "one decode token", _wall(token), card, (1, "token"))

    # one ENC_CHUNK encoder step alone
    e = model.config.encoder_args
    x = torch.randn(1, ENC_CHUNK, e.dim, device="cuda", dtype=model.dtype)
    rings = KVCache.init(1, RING_CAP, e.n_heads, e.head_dim,
                         dtype=torch.float32, device="cuda",
                         n_layers=e.n_layers)

    def enc_step():
        with torch.inference_mode():
            return encoder_stream_step(model, x, rings, 0, ENC_CHUNK)

    _profiled(enc_step, "one encoder step", _wall(enc_step), card,
              (1, "step"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
