"""Time KugelAudio's frame loop (the kugelaudio_7b lane) of the PyTorch
port against the number of frames a chunk runs between two status reads.

    python3 tools/kugel_chunk_sweep.py [--chunks 32,8,4,2,1] [--end 40]
                                       [--reps 3]

Run from the repository root on a machine with an NVIDIA GPU. Builds the
model of chip_smoke.py's phase 23 (the lane's 8.64 B parameters drawn
N(0, 0.02) on the card in f32 from seed 0, cast to bf16, every frame forced
to diffusion by the lanes' +1e4 lm_head bias) and, for each chunk size
(`kugelaudio.CHUNK_FRAMES`), runs two requests of the lane's text at 10
SDE steps and cfg_scale 3.0 after one warm-up, `--reps` rounds that each
run every chunk size once (interleaved, so the host's drift falls on all
alike):

* the lane's: 64 frames, all diffusion, cache 512 columns; what reading
  the status more often costs when no frame is wasted;
* an END-terminated one at the default budget (max_tokens 2,048, cache
  4,096 columns): `--end` diffusion frames, then SPEECH_END wins the pick
  (its logit raised by 3e4 from that frame on), as a real request ends.
  The frames the device runs past the END are counted (`frames_run` minus
  `frames` of `last_run`), with the wall they cost.

For each it prints the best and median wall, the best run's frame loop
seconds, ms a frame run, chunks (status reads), frames counted and run,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="32,8,4,2,1",
                    help="chunk sizes to time, comma-separated")
    ap.add_argument("--end", type=int, default=40,
                    help="diffusion frames before the END of the second "
                         "request")
    ap.add_argument("--reps", type=int, default=3,
                    help="rounds over the chunk sizes")
    args = ap.parse_args()
    chunks = [int(c) for c in args.chunks.split(",")]

    import numpy as np
    import torch

    import chip_smoke as cs
    from mlx_audio_tpu_torch.tts.models.kugelaudio import kugelaudio

    card = cs.phase_device()
    print(card, flush=True)
    model = cs.build_kugel_full().astype(torch.bfloat16)
    torch.cuda.empty_cache()
    cs.tts_fixtures().force_diffusion(model)
    pick = model._pick4_logits
    end_bias = torch.tensor([0.0, 3e4, 0.0, 0.0], device="cuda")
    state = {"frame": 0, "end": None}

    def pick_with_end(h):
        out = pick(h)
        state["frame"] += 1
        if state["end"] is not None and state["frame"] > state["end"]:
            out = out + end_bias
        return out

    model._pick4_logits = pick_with_end

    def request(end, max_tokens, seed):
        state["frame"], state["end"] = 0, end
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = next(model.generate(cs.KUGEL_TEXT, cfg_scale=cs.KUGEL_CFG,
                                max_tokens=max_tokens,
                                ddpm_steps=cs.KUGEL_STEPS, seed=seed))
        wall = time.perf_counter() - t0
        run = dict(model.last_run)
        if not np.isfinite(r.audio).all() or run["frames_run"] != \
                state["frame"]:
            raise AssertionError(f"audio not finite, or {run['frames_run']} "
                                 f"frames run against {state['frame']} picks")
        return wall, run

    cases = (("lane, 64 frames", None, cs.KUGEL_FRAMES),
             (f"END after {args.end} latents", args.end, 2048))
    request(None, cs.KUGEL_FRAMES, 0)               # warm-up
    runs = {(chunk, i): [] for chunk in chunks for i in range(len(cases))}
    for rep in range(args.reps):
        for chunk in chunks:
            kugelaudio.CHUNK_FRAMES = chunk
            for i, (_, end, max_tokens) in enumerate(cases):
                runs[(chunk, i)].append(request(end, max_tokens, rep + 1))
    for chunk in chunks:
        for i, (label, end, _) in enumerate(cases):
            walls = sorted(w for w, _ in runs[(chunk, i)])
            wall, run = min(runs[(chunk, i)], key=lambda x: x[0])
            if end is not None and (run["latents"], run["frames"]) != \
                    (end, end + 1):
                raise AssertionError(f"{run['latents']} latents over "
                                     f"{run['frames']} frames, want {end} "
                                     f"over {end + 1}")
            wasted = run["frames_run"] - run["frames"]
            per = run["frames_s"] * 1e3 / run["frames_run"]
            print(f"[chunk {chunk:2d}] {label}: wall best {wall:.3f} s, "
                  f"median {walls[len(walls) // 2]:.3f} s (runs "
                  f"{', '.join(f'{w:.3f}' for w, _ in runs[(chunk, i)])}), "
                  f"frame loop {run['frames_s']:.3f} s, {per:.2f} ms a frame "
                  f"run, {run['chunks']} status reads, {run['frames']} frames "
                  f"counted, {run['frames_run']} run ({wasted} past the end, "
                  f"about {wasted * per:.0f} ms), {run['latents']} latents, "
                  f"cache {run['cache_len']} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
