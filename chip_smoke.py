"""Drive the PyTorch port's Kokoro-82M text -> audio path once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN convolutions, so every f32 reference below
   is full f32.
2. build: compiles the hand-written kernel (csrc/snake_conv.cu) with nvcc
   into build/kernels/ and reports the seconds it took.
3. kernel vs plain: the fused AdaIN -> snake -> conv1d kernel against its
   plain PyTorch version at every (C, k, dilation) the generator runs
   (C in {256, 128} x k in {3, 7, 11} x dil in {1, 3, 5}), B=2 with ragged
   valid lengths, at the time lengths of a 1024-frame bucket, in f32 and
   bf16; relative error and median times (CUDA events).
4. main path: Kokoro at the published dims with seeded random weights.
   First a small-input check, fed the same durations: the CUDA path against
   the same seeded model on the CPU (plain versions) at f32, and the bf16
   CUDA decoder against that f32 CPU one. Then three
   `generate()` requests through the pipeline, the built-in G2P and a
   seeded .npy voice pack, in the default bf16, twice over (cold, then
   warm): audio length, finiteness, and 48 kernel launches per synth.

The last two lines of stdout are a JSON line about the kernel and the
result line {"ok": true, "device": {...}}. Any failure exits non-zero
before either is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# relative error max|a-b| / max|b| allowed against the plain version:
# f32 sums the same exact products in another order (~1e-6 seen); bf16
# output rounds to 8 mantissa bits, so one bf16 ulp at the largest value is
# 2**-8 = 3.9e-3, and an h element may round the other way where sinf and
# torch.sin differ in the last f32 bit
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# small-input end-to-end check, CUDA vs CPU at f32 with the same durations:
# the NSF phase is a cumsum over thousands of samples, summed in another
# order on the GPU
E2E_TOL = 1e-3
# the bf16 decoder on the GPU against the f32 CPU path: the bound of
# tests/test_kokoro.py:123-149 (relative error, and correlation)
BF16_TOL, BF16_CORR = 0.15, 0.999
# the generator's legs at the 1024-frame bucket: stage 0 runs 2F*10 rows at
# C=256, stage 1 2F*60+1 rows at C=128 (istftnet.py reflection pad)
KERNEL_FRAMES = 1024
TEXTS = (
    "Hello world.",
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Machine learning systems now synthesize natural speech in real time, "
    "streaming audio to listeners across the planet with very low latency.",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return card


def phase_build():
    from mlx_audio_tpu_torch.ops.cuda_build import library_path
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    snake_conv_kernel.build()
    log(f"[build] snake_conv.cu -> {library_path('snake_conv').name} in "
        f"{time.perf_counter() - t0:.2f} s")


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_kernels(reps: int = 5):
    """Every (C, k, dil) of the main path, f32 and bf16. Returns per-shape
    results {(dtype, C, k, dil): (rel, abs, ms, plain_ms)}."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, snake_conv_kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for c, t in ((256, 2 * KERNEL_FRAMES * 10), (128, 2 * KERNEL_FRAMES * 60 + 1)):
        vlen = torch.tensor([t, (t * 3) // 5], dtype=torch.int32, device=dev)
        x32 = torch.randn(2, t, c, generator=g, device=dev)
        scale = 1.0 + 0.5 * torch.randn(2, c, generator=g, device=dev)
        shift = 0.1 * torch.randn(2, c, generator=g, device=dev)
        alpha = torch.rand(c, generator=g, device=dev) + 0.5
        bias = 0.05 * torch.randn(c, generator=g, device=dev)
        for k in (3, 7, 11):
            w32 = torch.randn(k, c, c, generator=g, device=dev) / (k * c) ** 0.5
            for dil in (1, 3, 5):
                for dtype in (torch.float32, torch.bfloat16):
                    x, w = x32.to(dtype), w32.to(dtype).contiguous()

                    def kern():
                        return snake_conv_kernel(x, scale, shift, alpha, w,
                                                 bias, dilation=dil,
                                                 valid_len=vlen)

                    def plain():
                        return adain_snake_conv1d_reference(
                            x, scale, shift, alpha, w, bias, dilation=dil,
                            valid_len=vlen)

                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    if got.dtype != dtype or got.shape != x.shape:
                        raise AssertionError(f"kernel output {got.dtype} "
                                             f"{tuple(got.shape)}")
                    if not torch.isfinite(got).all():
                        raise AssertionError("kernel output not finite")
                    rel = rel_err(got, want)
                    ab = float((got.float() - want.float()).abs().max())
                    name = str(dtype).split(".")[-1]
                    ms = _time_ms(kern, reps)
                    plain_ms = _time_ms(plain, reps)
                    results[(name, c, k, dil)] = (rel, ab, ms, plain_ms)
                    flop = 2.0 * 2 * t * c * c * k
                    log(f"[kernel] {name:8s} C={c} k={k:2d} dil={dil} T={t} "
                        f"rel={rel:.3e} abs={ab:.3e} (tol {KERNEL_TOL[name]:g}) "
                        f"kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) "
                        f"plain {plain_ms:.3f} ms")
                    if not rel <= KERNEL_TOL[name]:
                        raise AssertionError(
                            f"kernel vs plain {name} C={c} k={k} dil={dil}: "
                            f"rel {rel:.3e} > {KERNEL_TOL[name]}")
    return results


def synth_legs(cfg):
    """(C, k, dil) of the 48 generator legs of one synth."""
    ch0 = cfg.upsample_initial_channel
    legs = []
    for i in range(len(cfg.upsample_rates)):
        c = ch0 // 2 ** (i + 1)
        blocks = [(int(k), [int(d) for d in ds]) for k, ds in
                  zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
        blocks.append((7 if i + 1 < len(cfg.upsample_rates) else 11, [1, 3, 5]))
        for k, ds in blocks:
            for d in ds:
                legs += [(c, k, d), (c, k, 1)]
    return legs


def kokoro_config(compute_dtype="bfloat16", transfer_dtype="float16"):
    """Kokoro-82M at the published dims (hexgrad/Kokoro-82M config.json,
    as tests/real_configs.py)."""
    from mlx_audio_tpu_torch.tts.models.kokoro import ModelConfig

    vocab = {ch: i + 1 for i, ch in enumerate(
        "abcdefghijklmnopqrstuvwxyz ˈˌəɹʃʒðθæɑɔɛɜɪʊʌiuAIOWY.,!?;:'\"-")}
    return ModelConfig(
        istftnet=dict(
            resblock_kernel_sizes=[3, 7, 11], upsample_rates=[10, 6],
            upsample_initial_channel=512,
            resblock_dilation_sizes=[[1, 3, 5]] * 3,
            upsample_kernel_sizes=[20, 12], gen_istft_n_fft=20,
            gen_istft_hop_size=5),
        dim_in=64, hidden_dim=512, max_conv_dim=512, max_dur=50, n_layer=3,
        n_mels=80, n_token=178, style_dim=128, text_encoder_kernel_size=5,
        plbert=dict(num_hidden_layers=12, num_attention_heads=12,
                    hidden_size=768, intermediate_size=2048,
                    max_position_embeddings=512, embedding_size=128,
                    dropout=0.1),
        vocab=vocab, compute_dtype=compute_dtype, transfer_dtype=transfer_dtype)


def phase_reference_check():
    """Small input, f32: CUDA path vs the same seeded model on the CPU."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.kokoro import FRAME_BUCKETS, Model
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import _bucket

    cfg = kokoro_config("float32", "float32")
    gpu = Model(cfg, device="cuda").init_params(seed=0)
    cpu = Model(cfg, device="cpu").init_params(seed=0)
    bf16 = Model(kokoro_config("bfloat16", "float32"),
                 device="cuda").init_params(seed=0)
    ids_list = [0, *gpu.phonemes_to_ids("hɛlO"), 0]
    ids = torch.tensor([ids_list])
    valid = torch.ones_like(ids, dtype=torch.bool)
    ref_s = torch.from_numpy(
        (np.random.RandomState(1).randn(1, 256) * 0.1).astype(np.float32))
    with torch.inference_mode():
        dg, tg, pdg, totg = gpu._run_frontend(ids.cuda(), valid.cuda(),
                                              ref_s.cuda(), 1.0)
        dc, tc, _, _ = cpu._run_frontend(ids, valid, ref_s, 1.0)
        pred_dur = pdg.cpu()
        fb = _bucket(int(totg.item()), FRAME_BUCKETS)
        ag, _ = gpu._run_acoustic(dg, tg, pdg, ref_s.cuda(), fb)
        ac, _ = cpu._run_acoustic(dc, tc, pred_dur, ref_s, fb)
        ab, _ = bf16._run_acoustic(dg, tg, pdg, ref_s.cuda(), fb)
    errs = {"d": rel_err(dg.cpu(), dc), "t_en": rel_err(tg.cpu(), tc),
            "audio": rel_err(ag.cpu(), ac)}
    n = int(totg) * gpu.samples_per_frame
    b_rel = rel_err(ab[0, :n].cpu(), ac[0, :n])
    b_corr = float(torch.corrcoef(torch.stack(
        [ab[0, :n].cpu().double(), ac[0, :n].double()]))[0, 1])
    log(f"[reference] f32 {len(ids_list)} tokens, {int(totg)} frames "
        f"(bucket {fb}), CUDA vs CPU rel err: "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {E2E_TOL:g}); bf16 CUDA vs f32 CPU audio rel err "
        f"{b_rel:.3e} (tol {BF16_TOL:g}), corr {b_corr:.6f} "
        f"(min {BF16_CORR:g})")
    if not (torch.isfinite(ag).all() and torch.isfinite(ab).all()):
        raise AssertionError("CUDA audio not finite")
    if not (b_rel <= BF16_TOL and b_corr >= BF16_CORR):
        raise AssertionError(f"bf16 vs f32: rel {b_rel:.3e}, corr {b_corr}")
    for name, err in errs.items():
        if not err <= E2E_TOL:
            raise AssertionError(f"CUDA vs CPU {name}: rel {err:.3e}")


def phase_main_path(card: str, voice_dir: Path):
    """Three generate() requests at the published dims, bf16, cold and warm.
    Returns the kernel's launch count over the run."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel
    from mlx_audio_tpu_torch.tts.models.kokoro import Model

    class Recording(Model):
        """Keeps each synth's total frame count."""

        def __call__(self, *args, **kwargs):
            audio, pred_dur = super().__call__(*args, **kwargs)
            self.frames.append(int(pred_dur.sum()))
            return audio, pred_dur

    t0 = time.perf_counter()
    model = Recording(kokoro_config(), device="cuda").init_params(seed=0)
    model.frames = []
    torch.cuda.synchronize()
    log(f"[main] Kokoro {model.num_params():,} params on cuda, decoder "
        f"{model.compute_dtype}, built in {time.perf_counter() - t0:.2f} s")
    (voice_dir / "voices").mkdir()
    pack = (np.random.RandomState(0).randn(510, 1, 256) * 0.1).astype(np.float32)
    np.save(voice_dir / "voices" / "af_smoke.npy", pack)
    model.config.model_path = str(voice_dir)
    legs_per_synth = len(synth_legs(model.istft_cfg))

    snake_conv_kernel.launches = 0
    total_launches = 0
    for run in ("cold", "warm"):
        for text in TEXTS:
            before = snake_conv_kernel.launches
            results = list(model.generate(text, voice="af_smoke"))
            launches = snake_conv_kernel.launches - before
            total_launches += launches
            if len(results) != 1:
                raise AssertionError(f"{len(results)} segments for one line")
            r = results[0]
            frames = model.frames[-1]
            audio = np.asarray(r.audio)
            if r.samples != frames * model.samples_per_frame:
                raise AssertionError(f"{r.samples} samples for {frames} frames")
            if audio.shape != (r.samples,) or not np.isfinite(audio).all():
                raise AssertionError("audio has the wrong shape or is not finite")
            if launches != legs_per_synth:
                raise AssertionError(f"{launches} kernel launches, want "
                                     f"{legs_per_synth}")
            audio_s = r.samples / r.sample_rate
            wall = r.processing_time_seconds
            log(f"[main] {run} {r.token_count:3d} phonemes {frames:5d} frames "
                f"{audio_s:7.2f} s audio: wall {wall * 1e3:9.2f} ms, "
                f"xRT {audio_s / wall:8.2f}, {launches} kernel launches, "
                f"peak {r.peak_memory_usage:.2f} GB ({card})")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return total_launches, legs_per_synth, model.istft_cfg


def main() -> int:
    if not (ROOT / "mlx_audio_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(mlx_audio_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    card = phase_device()
    log(card)
    phase_build()
    kres = phase_kernels()
    phase_reference_check()
    with tempfile.TemporaryDirectory() as tmp:
        launches, legs_per_synth, icfg = phase_main_path(card, Path(tmp))

    # the kernel's time for the 48 legs of one synth of two rows (B=2) at
    # the 1024-frame bucket, summed from the per-shape medians of phase 3
    # (bf16, the main path's dtype)
    legs = synth_legs(icfg)
    ms = sum(kres[("bfloat16", c, k, d)][2] for c, k, d in legs)
    plain_ms = sum(kres[("bfloat16", c, k, d)][3] for c, k, d in legs)
    max_abs = max(v[1] for key, v in kres.items() if key[0] == "bfloat16")
    log(f"[kernel] the {len(legs)} legs of one B=2 synth at the "
        f"{KERNEL_FRAMES}-frame bucket, bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms ({card})")
    import torch

    print(json.dumps({"kernels": [{
        "name": "adain_snake_conv1d",
        "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/snake_conv.cu",
        "replaces": "mlx_audio_tpu/ops/snake_conv_pallas.py:159",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
