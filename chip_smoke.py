"""Drive the PyTorch port's main paths once on one GPU: Kokoro-82M text ->
audio; Qwen3-TTS text ids -> audio with an 8-bit quantized talker, one
request at a time (whole and streamed) and through the continuous-batching
session and its broker; Whisper large-v3-turbo speech -> text, through
`generate`, its streaming session, `load_model` and the STT CLI; and
Voxtral-Mini-3B-Realtime streaming speech -> text (the model behind the
server's /v1/realtime), through its live session, offline `generate`,
`load_model` and the STT CLI; Cohere ASR long-file speech -> text
(a FastConformer encoder and a Canary decoder), through `generate`,
`load_model` and the STT CLI; and Higgs Audio v2 text -> audio with its
acoustic codec, in bf16, in W8A8 (`qmatmul_i8`) and on an affine-q8
backbone (kernel K2), through its frame loop, `generate` and
`load_model`.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN convolutions, so every f32 reference below
   is full f32.
2. build: compiles the hand-written kernels (csrc/snake_conv.cu, K1, and
   csrc/qmm.cu, K2) with nvcc into build/kernels/, one nvcc per source, all
   started together, and reports the seconds.
3. K1 vs plain: the fused AdaIN -> snake -> conv1d kernel against its
   plain PyTorch version at every (C, k, dilation) the generator runs
   (C in {256, 128} x k in {3, 7, 11} x dil in {1, 3, 5}), B=2 with ragged
   valid lengths, at the time lengths of a 1024-frame bucket, by each path:
   f32 on f32 x, wgmma (the dispatched bf16 path) and wmma (the first
   design) on bf16 x; relative error, device time per launch (CUDA graph
   replay, so the host's launch cost is left out), the plain version's
   time (CUDA events), and beside each bf16 shape its bound and the time of
   cuDNN `F.conv1d` alone on a precomputed bf16 h (a yardstick: the conv
   without the affine, snake and masks). wgmma must beat wmma at every
   shape. Then wgmma where alpha*u reaches about 1e4 (its reduced sine).
4. Kokoro main path at the published dims with seeded random weights.
   First a small-input check, fed the same durations: the CUDA path against
   the same seeded model on the CPU (plain versions) at f32, and the bf16
   CUDA decoder against that f32 CPU one. Then three `generate()` requests
   through the pipeline, the built-in G2P and a seeded .npy voice pack, in
   the default bf16, twice over (cold, then warm): audio length,
   finiteness, and 48 K1 launches per synth, all by the wgmma path.
5. K2 vs plain: the fused dequantize + matmul kernel against
   `qmatmul_reference` at every linear shape of the Qwen3-TTS slice,
   M in {1, 2, 8, 16, 64, 120} (8 and 16: the b = 8 session's decode
   frame), bits in {8, 4}, x in f32 and bf16, by every path of K2 that
   takes the case (gemv at M = 1, mma for bf16, the first design, simt,
   for all); relative error, median device time per launch over a
   rotation of weight copies larger than the L2 cache (replayed as one CUDA
   graph, so host launch cost is left out), GB/s and the byte bound; then
   one line per M > 1 path with its times summed over the shapes.
6. Qwen3-TTS checks: on a small config at f32 from one seeded weight set,
   the CUDA path against the CPU path (prefill logits, the greedy codes of
   one chunk, decode_full audio); at full dims, the q8 model's prefill
   logits with K2 against the same model through `qmatmul_reference`.
7. Qwen3-TTS main path at the published dims of the 1.7B lane (bench.py
   qwen3_tts_1b7), seeded random bf16 weights quantized to affine 8-bit
   (group 64): two `generate(text_ids=...)` requests (20 ids / 60 frames,
   the JAX lane's 50 ids / 100 frames), cold then warm: audio length and
   finiteness, and K2's launch count against the count the config gives
   for the steps that ran (722 per decode step; the model must hold
   exactly the quantized linears the config gives), and the decode steps
   against the chunk schedule with its early exit. (Until the streaming
   phases came, a third request of 120 ids / 200 frames ran here; it was
   dropped to keep the run's time.)
8. K2 (the dispatched path) vs plain at each (M, out, in) that phases 7,
   10, 11 and 21 launched it with, run after phase 21 (the prefill bucket,
   the code predictor's first sub-step, text_projection over the text
   ids, the session's M = 8 and 16 decode frame and its burst prefill at
   M = 8 x 16, Higgs's four shapes at M = 1 and 512), 8-bit codes, x in
   f32 and bf16.
9. Qwen3-TTS streaming on the small config at f32 from one seeded q8
   weight set, CUDA against the CPU path: the greedy streamed chunks (same
   chunk sizes, audio), `streaming_step` over uneven chunks against
   `decode_full` on the card, and a greedy two-slot session with a request
   admitted mid-stream (same codes, audio).
10. Full dims q8, `generate(stream=True)`: the JAX lane's streamed request
   (`np.arange(100, 150)`, max_tokens 100, streaming_interval 2.0, seed 1;
   bench.py:303-305), cold then warm: time to first audio, wall, xRT,
   chunks, reads and the host's wait in them, finite audio of whole
   frames, and K2's launches against the config's count.
11. Full dims q8, the continuous-batching session at b = 8 (bench.py:
   761-803: 100 frames, streaming_interval 0.4, max_cache_len 1024,
   `warmup()` first) with a cold burst of 8 requests
   `np.arange(100 + i, 150 + i)`: aggregate xRT, time to first audio p50
   and max, wall per `step()`, K2's launches per step (against the
   config's count) and per path; every request ends `done` with finite
   audio of whole frames. Then three requests through the port's
   `InferenceBroker` and an adapter that routes TTS to the session as the
   server's does (mlx_audio_tpu/server.py:117-146).
12. Whisper, the small config of tests/test_whisper.py at f32 from one
   seeded weight set, CUDA against the CPU: the whole-file log-mel (cuFFT
   against the CPU's FFT, within 1e-4) and greedy `generate()` on 6 s of
   seeded noise with timestamps and word timestamps (tokens, segment and
   word times equal).
13. Whisper large-v3-turbo at full width (the JAX lane's dims, bench.py:
   892-895; 807 M parameters drawn on the card from seed 0 in f32, then
   cast to bf16): the bf16 encoder against f32 on one 30-s window (relative
   Frobenius error under 2e-2), the encoder's time a window (CUDA events)
   and its share of 989 TFLOP/s, the JAX lane's workload (600 s of
   `randn * 0.1`, greedy, thresholds off, timestamps, `sample_len` 100;
   bench.py:898-905) cold then warm (wall, xRT, windows, segments, tokens,
   decode steps, ms a step), and the streaming session over ten 1-s chunks
   then `close()` (step latency p50 and max; a final event must arrive).
   Neither K1 nor K2 may launch in phases 12-14.
14. The STT entry points on the card: a small checkpoint written with HF
   names and config (npz) and a 5-s WAV written with the port's audio_io;
   `python -m mlx_audio_tpu_torch.stt.generate --format json` in a
   subprocess must equal `mlx_audio_tpu_torch.load_model(...).generate()`
   in process (text and segments). Then the same for a small Voxtral
   Realtime checkpoint (mistral's consolidated names, torch conv layout,
   npz, a tekken.json) and a 3-s WAV, and for a small Cohere ASR checkpoint
   (NeMo's names, torch conv layouts, npz with the preprocessor's
   filterbank and window, a tokens.json) and a 5-s WAV. Last, a small
   Higgs Audio v2 checkpoint (HF names, config.json with model_type
   "higgs_audio", npz, no text head): `load_model(...)` on the card must
   tie the text head to embed_tokens and give the in-process model's
   greedy frames.
15. Voxtral Realtime, the small config of tests/test_voxtral_realtime.py
   with a 2-layer encoder, at f32 from one seeded weight set, CUDA against
   the CPU: offline adapter frames (relative error within 1e-4) at 1 s,
   whose mel bucket's padding lies past the encoder's window (the JAX
   package's encoder gives NaN there), and at 4.5 s; greedy offline tokens
   equal; on the card the session fed in uneven pieces gives the offline
   tokens and text; everything finite.
16. Voxtral-Mini-3B-Realtime at full width (`ModelConfig()`, as bench.py:
   701; 4.43 B parameters drawn on the card in f32 from seed 0, then cast
   to bf16 in place): one ENC_CHUNK encoder step in bf16 against f32
   (relative Frobenius under 2e-2) and its time; the JAX lane's workload
   (bench.py:708-747: 30 s of `randn * 0.1` at seed 0 after a 6-s warm
   drive, 1-s feeds each followed by `step(max_decode_tokens=16)`, then
   `close()` and `step(32)` until done): step p50, p95 and max, EOT to
   final, xRT, decoded tokens, p95 < 1 s, peak device memory; a final
   event must arrive. Then an offline `generate()` of 20 s, a length where
   the JAX package's encoder gives NaN: its adapter frames must be finite.
   Neither K1 nor K2 may launch in phases 15-16.
17. Cohere ASR, the small config of tests/test_cohere_asr.py at f32 from
   one seeded weight set, CUDA against the CPU: the encoder rows of a
   ragged batch with a row of length 0 (relative error within 1e-4, all
   finite; the JAX package's length-0 row is NaN) and greedy `generate()`
   on 5 s of seeded noise (3 segments, a partial last batch): texts and
   segments equal.
18. Cohere ASR at the cohere_asr_10min lane's dims (bench.py:831-842:
   FastConformer 48 x d1280, decoder 8 x d1024, vocabulary 16,384; 2.07 B
   parameters drawn on the card in f32 from seed 0, then cast in place to
   bf16): the bf16 encoder against f32 on one 8-row batch of the 3,584-
   frame bucket (relative Frobenius under 2e-2), the encoder's time a
   batch (CUDA events) and its share of 989 TFLOP/s; the lane's workload
   (bench.py:856-869: 600 s of `randn * 0.1` at seed 0, language "en",
   max_tokens 150) cold, then warm best of 3: wall, xRT, segments (19),
   tokens, decode steps and ms a step, the host mel's time, peak device
   memory; every batch's encoder rows finite, the runs' texts equal.
   Neither K1 nor K2 may launch in phases 17-18.
19. Higgs Audio v2, the small config of tests/test_higgs_audio_v2.py at
   f32 from one seeded weight set, CUDA against the CPU: the cached
   prefill's hidden states of a mixed text/audio prompt (within 1e-4),
   greedy `generate_frames` with the EOS rows of the audio head scaled so
   that EOS comes after the delay ramp-in and the ramp-out runs (frames
   equal), and a greedy `generate()` through a small bound codec (same
   length, audio within 1e-4). Then `qmatmul_i8` on the card
   (`torch._int_mm`, rows padded where it refuses few) against its plain
   version at M in {1, 17, 512} and the four Higgs shapes: int32
   accumulators equal, the output within 1e-5.
20. Higgs Audio v2 at `ModelConfig()` dims (5.771 B parameters drawn
   N(0, 0.02) on the card in f32 from seed 0, as bench.py:369-390 draws
   every floating leaf, then cast in place to bf16): bf16 against f32 on
   the lane's 512-bucket prefill (relative Frobenius under 2e-2); the
   `higgs_v2_3b_bf16` workload (bench.py:428-464: 480 embeds of
   `randn * 0.02` at seed 0, cache 1,024, temperature 0.7, top_p 0.95, RAS
   7/2; 250 frames in 16-frame chunks through `prefill` and `chunk`
   whatever `done` says, then the codec at `CodecConfig()` dims in bf16 on
   the first 242 frames mod 1,024), a warm-up then best of 3: wall, ms a
   frame, xRT over 10 s, the prefill's and the codec's time, peak device
   memory, and from one profiled chunk the kernels a frame, device time
   and busy share against the frame's byte bound (1.72 ms). Then, after
   phase 21, the same model's affine codes converted in place to W8A8
   (`tree_to_i8_layout`, as bench.py:414-426), its audio logits on the
   prefill's last row against bf16 (relative Frobenius under 1e-1), and
   the `higgs_v2_3b_q8` workload the same way against its int8 bound.
   Audio finite and 232,320 samples in each. Neither K1 nor K2 may launch.
21. On phase 20's weights, between its two lanes: the backbone quantized
   through `apply_quantization` to affine 8 bits (group 64, no mxu_int8),
   one 32-frame request through `generate_frames` with a voice-clone-like
   mask. K2's launches must equal 28 x (4 + 3 + 3) = 280 for the prefill
   (both paths) plus 196 (28 layers x 7, the audio path) for each decode
   step run; every quantized linear the config gives must be one. Then K2
   (checked against `qmatmul_reference`), W8A8 and dense bf16 cuBLAS at
   the four Higgs shapes at M = 1 and 512, by CUDA graph replay, with the
   sums over one decode frame's 196 linears. These launches join K2's
   count in the `kernels` line, and the shapes phase 8's final check.

The last two lines of stdout are a JSON line about the kernels and the
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
# the H100 SXM's dense bf16 tensor-core rate and device-memory bandwidth at
# its full 700 W (NVIDIA's data sheet), for the kernels' bounds
PEAK_BF16, HBM_BPS = 989e12, 3.35e12
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
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mlx_audio_tpu_torch.ops.cuda_build import build
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    t0 = time.perf_counter()
    names = ("snake_conv", "qmm")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build, names))
    snake_conv_kernel.build()
    qmm_kernel.build()
    log(f"[build] {', '.join(f'{n}.cu -> {lib.name}' for n, lib in zip(names, libs))} "
        f"in {time.perf_counter() - t0:.2f} s")


def _time_ms(fn, reps: int) -> float:
    """Median ms of one call of `fn` between CUDA events (host cost
    included: for calls far longer than their launch, the plain version)."""
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


def k1_bound(c: int, k: int, t: int, vlen) -> tuple:
    """(ms, "operations" or "bytes") the card needs at least for one leg:
    the bf16 products of the rows this run's valid lengths keep, against
    989 TFLOP/s, or the bytes (those rows of x read once, w read once, all
    of out written once) against 3.35 TB/s, whichever is larger."""
    rows = sum(min(max(int(v), 0), t) for v in vlen)
    ops_ms = 2.0 * rows * c * c * k / PEAK_BF16 * 1e3
    bytes_ms = 2.0 * (rows * c + k * c * c + len(vlen) * t * c) / HBM_BPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def k1_bound_full(c: int, k: int) -> float:
    """k1_bound's ms for a leg of phase 3's shapes were every row valid."""
    t = 2 * KERNEL_FRAMES * (10 if c == 256 else 60) + (c == 128)
    return k1_bound(c, k, t, [t, t])[0]


def phase_kernels(card: str, reps: int = 5):
    """Every (C, k, dil) of the main path, by each path of K1 (f32 on f32
    x; wgmma, the dispatched bf16 path, and wmma, the first design, on bf16
    x) against the plain version, B=2 with ragged valid lengths. Kernel
    times are device times per launch from a CUDA graph replay (the host's
    launch cost left out); the plain version is timed by events. Beside
    each bf16 shape: the leg's bound and cuDNN `F.conv1d` alone on a
    precomputed bf16 h (the conv without the affine, snake and masks; a
    yardstick the port never calls). Returns ({(path, C, k, dil): (rel,
    abs, ms, plain_ms)}, {(C, k, dil): (cudnn_ms, bound_ms, bound_by)})."""
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, choose_path, kernel_weight,
        snake_conv_kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results, extra = {}, {}
    for c, t in ((256, 2 * KERNEL_FRAMES * 10), (128, 2 * KERNEL_FRAMES * 60 + 1)):
        vlen = torch.tensor([t, (t * 3) // 5], dtype=torch.int32, device=dev)
        x32 = torch.randn(2, t, c, generator=g, device=dev)
        scale = 1.0 + 0.5 * torch.randn(2, c, generator=g, device=dev)
        shift = 0.1 * torch.randn(2, c, generator=g, device=dev)
        alpha = torch.rand(c, generator=g, device=dev) + 0.5
        bias = 0.05 * torch.randn(c, generator=g, device=dev)
        h16 = torch.randn(2, c, t, generator=g, device=dev).to(torch.bfloat16)
        if choose_path(torch.bfloat16, c) != "wgmma":
            raise AssertionError(f"bf16 C={c} dispatches to "
                                 f"{choose_path(torch.bfloat16, c)}")
        for k in (3, 7, 11):
            w32 = torch.randn(k, c, c, generator=g, device=dev) / (k * c) ** 0.5
            for dil in (1, 3, 5):
                for path in ("f32", "wgmma", "wmma"):
                    dtype = torch.float32 if path == "f32" else torch.bfloat16
                    x, w = x32.to(dtype), w32.to(dtype).contiguous()
                    kw = kernel_weight(w, path)

                    def kern():
                        return snake_conv_kernel(x, scale, shift, alpha, kw,
                                                 bias, dilation=dil,
                                                 valid_len=vlen, path=path)

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
                    ms = _time_graph([kern] * 5, reps)
                    plain_ms = (results[("wgmma", c, k, dil)][3]
                                if path == "wmma" else _time_ms(plain, reps))
                    results[(path, c, k, dil)] = (rel, ab, ms, plain_ms)
                    line = (f"[kernel] {path:5s} C={c} k={k:2d} dil={dil} "
                            f"T={t} rel={rel:.3e} abs={ab:.3e} (tol "
                            f"{KERNEL_TOL[name]:g}) kernel {ms:.4f} ms, "
                            f"plain {plain_ms:.3f} ms")
                    if path == "wgmma":
                        wt = w.permute(2, 1, 0).contiguous()
                        b16 = bias.to(torch.bfloat16)
                        pad = (k - 1) // 2 * dil
                        lib_ms = _time_graph([lambda: F.conv1d(
                            h16, wt, b16, padding=pad, dilation=dil)] * 5,
                            reps)
                        bound_ms, by = k1_bound(c, k, t, vlen.tolist())
                        extra[(c, k, dil)] = (lib_ms, bound_ms, by)
                        line += (f", cuDNN conv1d alone {lib_ms:.4f} ms, "
                                 f"bound {bound_ms:.4f} ms ({by}), "
                                 f"{100 * bound_ms / ms:.1f}% of it")
                    log(line + f" ({card})")
                    if not rel <= KERNEL_TOL[name]:
                        raise AssertionError(
                            f"kernel vs plain {path} C={c} k={k} dil={dil}: "
                            f"rel {rel:.3e} > {KERNEL_TOL[name]}")
                fast, slow = (results[(p, c, k, dil)][2]
                              for p in ("wgmma", "wmma"))
                if not fast < slow:
                    raise AssertionError(f"wgmma {fast:.4f} ms not faster "
                                         f"than wmma {slow:.4f} ms at C={c} "
                                         f"k={k} dil={dil}")
    _k1_large_arguments()
    return results, extra


def _k1_large_arguments():
    """The wgmma path's reduced sine (csrc/snake_conv.cu::sin_sq) against
    the plain version's torch.sin where alpha*u reaches about 1e4."""
    import torch

    from mlx_audio_tpu_torch.ops.snake_conv import (
        adain_snake_conv1d_reference, kernel_weight, snake_conv_kernel)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    c, t, k = 256, 1000, 3
    x = torch.randn(2, t, c, generator=g, device=dev).to(torch.bfloat16)
    scale = 2500.0 * (1.0 + 0.5 * torch.rand(2, c, generator=g, device=dev))
    shift = torch.zeros(2, c, device=dev)
    alpha = torch.rand(c, generator=g, device=dev) + 0.5
    w = (torch.randn(k, c, c, generator=g, device=dev) / (k * c) ** 0.5
         ).to(torch.bfloat16)
    vlen = torch.tensor([t, 601], dtype=torch.int32, device=dev)
    got = snake_conv_kernel(x, scale, shift, alpha, kernel_weight(w, "wgmma"),
                            None, valid_len=vlen, path="wgmma")
    want = adain_snake_conv1d_reference(x, scale, shift, alpha, w,
                                        valid_len=vlen)
    u = float((x.float() * scale[:, None]).abs().max() * alpha.max())
    rel = rel_err(got, want)
    log(f"[kernel] wgmma C={c} k={k}, |alpha*u| up to {u:.3g}: rel={rel:.3e} "
        f"(tol {KERNEL_TOL['bfloat16']:g})")
    if not (rel <= KERNEL_TOL["bfloat16"] and u >= 1e4):
        raise AssertionError(f"wgmma at large arguments: rel {rel:.3e}, "
                             f"|alpha*u| {u:.3g}")


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
    snake_conv_kernel.path_launches = dict.fromkeys(
        snake_conv_kernel.path_launches, 0)
    total_launches = 0
    for run in ("cold", "warm"):
        for text in TEXTS:
            before = snake_conv_kernel.launches
            by_path = dict(snake_conv_kernel.path_launches)
            results = list(model.generate(text, voice="af_smoke"))
            launches = snake_conv_kernel.launches - before
            wgmma = snake_conv_kernel.path_launches["wgmma"] - by_path["wgmma"]
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
            if launches != legs_per_synth or wgmma != legs_per_synth:
                raise AssertionError(f"{launches} kernel launches, {wgmma} "
                                     f"by wgmma; want {legs_per_synth}")
            audio_s = r.samples / r.sample_rate
            wall = r.processing_time_seconds
            log(f"[main] {run} {r.token_count:3d} phonemes {frames:5d} frames "
                f"{audio_s:7.2f} s audio: wall {wall * 1e3:9.2f} ms, "
                f"xRT {audio_s / wall:8.2f}, {launches} K1 launches "
                f"({wgmma} wgmma), "
                f"peak {r.peak_memory_usage:.2f} GB ({card})")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return total_launches, legs_per_synth, model.istft_cfg


# ---------------------------------------------------------------------------
# Qwen3-TTS with the 8-bit talker (kernel K2)
# ---------------------------------------------------------------------------

# every linear (out, in) of the slice: q; k, v; o; gate, up, codec_head;
# down; text_projection fc1 and fc2 (fc2 is o's shape)
QMM_SHAPES = ((2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024),
              (1024, 3072), (2048, 2048))
QMM_ROWS = (1, 2, 8, 16, 64, 120)
QMM_GROUP = 64
# quantized linears of one qwen3 layer: q, k, v, o, gate, up, down
LINEARS_PER_LAYER = 7
# K2 launches at the qwen3_tts_1b7 dims: a talker pass 28*7 + 1
# (codec_head); step 0 the code predictor's 15 passes of 5*7; a decode step
# both (722); a text_projection call fc1 and fc2
K2_LAUNCHES_FULL_DIMS = {"prefill": 197, "step0": 525, "decode step": 722,
                         "text_projection": 2}
# K2 is timed over a rotation of weight copies of at least twice the 50 MB
# L2, as the decode step finds its weights: each read once per frame
L2_BYTES = 50 * 2 ** 20
HBM_GBS = 3350.0
# small config at f32, CUDA vs CPU: summation order only
QWEN3_E2E_TOL = 1e-4
# full-dims q8 prefill logits, K2 vs qmatmul_reference, both bf16: each
# linear rounds its f32 sum to bf16 (2**-8 relative), in another order, and
# 28 layers carry the difference on; bound and correlation as the Kokoro
# bf16 check's style
Q8_PREFILL_TOL, Q8_PREFILL_CORR = 0.05, 0.999
# (text ids, max_tokens) of phase 7: a short request and the JAX lane's
# (bench.py:285); temperature 0.9, seed 0
QWEN3_SEED = 0


def qwen3_requests():
    import numpy as np

    rng = np.random.RandomState(1)
    return ((rng.randint(0, 151936, 20), 60),
            (np.arange(100, 150), 100))


def qwen3_config():
    """The qwen3_tts_1b7 lane's dims (bench.py:208-217, equal to the
    qwen3_tts/config.py defaults); codec decoder at its defaults."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import ModelConfig

    return ModelConfig(talker_config=dict(
        vocab_size=3072, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, num_code_groups=16, text_hidden_size=2048,
        text_vocab_size=151936,
        code_predictor_config=dict(
            vocab_size=2048, hidden_size=1024, intermediate_size=3072,
            num_hidden_layers=5, num_attention_heads=16,
            num_key_value_heads=8, head_dim=128, num_code_groups=16)))


def qwen3_small_config():
    """tests/test_qwen3_tts.py::tiny_cfg, tts ids inside its text vocab."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import ModelConfig

    return ModelConfig(
        talker_config=dict(
            vocab_size=300, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, num_code_groups=4, text_hidden_size=48,
            text_vocab_size=500, codec_eos_token_id=280, codec_think_id=284,
            codec_nothink_id=285, codec_think_bos_id=286,
            codec_think_eos_id=287, codec_pad_id=278, codec_bos_id=279,
            code_predictor_config=dict(
                vocab_size=256, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, num_code_groups=4)),
        tokenizer_config=dict(decoder_config=dict(
            latent_dim=32, codebook_dim=16, codebook_size=256, decoder_dim=64,
            hidden_size=24, intermediate_size=48, head_dim=8,
            num_attention_heads=3, num_hidden_layers=2, num_key_value_heads=3,
            num_quantizers=4, num_semantic_quantizers=1, sliding_window=16,
            upsample_rates=[4, 3], upsampling_ratios=[2, 2])),
        tts_bos_token_id=497, tts_eos_token_id=498, tts_pad_token_id=499)


def _time_graph(fns, reps: int) -> float:
    """Median device ms per call of `fns` run back to back: the round is
    captured once in a CUDA graph and replayed between CUDA events, so the
    host's launch cost (tens of us per call here) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    times.sort()
    return times[len(times) // 2]


def qmm_paths(dtype, m: int):
    """The paths of K2 that take x of `dtype` with `m` rows at group 64,
    the dispatched one first."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import PATHS, choose_path

    chosen = choose_path(dtype, m, QMM_GROUP)
    takes = [p for p in PATHS if (p != "gemv" or m == 1)
             and (p != "mma" or dtype == torch.bfloat16)]
    return [chosen] + [p for p in takes if p != chosen]


def phase_qmm(card: str, reps: int = 7):
    """K2 against qmatmul_reference at every shape of the slice, by every
    path that takes the shape. Returns {(dtype, out, in, bits, M, path):
    (rel, abs, ms, plain_ms, GB/s)}; the dispatched path is
    qmm_paths(...)[0]."""
    from functools import partial

    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference, quantize_weight

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for n, k in QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
        bias = (0.01 * torch.randn(n, generator=g, device=dev)
                if (n, k) == (2048, 2048) else None)
        for bits in (8, 4):
            q = quantize_weight(w, QMM_GROUP, bits)
            wbytes = n * k + 2 * n * (k // QMM_GROUP) * 4
            copies = [q] + [{name: v.clone() for name, v in q.items()}
                            for _ in range(-(-2 * L2_BYTES // wbytes) - 1)]
            for m in QMM_ROWS:
                x32 = torch.randn(m, k, generator=g, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    x = x32.to(dtype)
                    name = str(dtype).split(".")[-1]
                    plain_ms = _time_graph(
                        [partial(qmatmul_reference, x, c["w_q"], c["scales"],
                                 c["biases"], bias) for c in copies], reps)
                    for path in qmm_paths(dtype, m):
                        rel, ab = _qmm_case(
                            x, q, bias, f"({n},{k}) q{bits} M={m} {path}",
                            path)
                        ms = _time_graph(
                            [partial(qmm_kernel, x, c["w_q"], c["scales"],
                                     c["biases"], bias, path=path)
                             for c in copies], reps)
                        nbytes = wbytes + (m * k + m * n) * x.element_size()
                        gbs = nbytes / (ms * 1e-3) / 1e9
                        results[(name, n, k, bits, m, path)] = (
                            rel, ab, ms, plain_ms, gbs)
                        log(f"[qmm] {name:8s} ({n:4d},{k:4d}) q{bits} "
                            f"M={m:3d} {path:4s} rel={rel:.3e} abs={ab:.3e} "
                            f"(tol {KERNEL_TOL[name]:g}) kernel "
                            f"{ms * 1e3:8.2f} us ({gbs:7.1f} GB/s, "
                            f"{100 * gbs / HBM_GBS:5.1f}% of 3.35 TB/s, bound "
                            f"{nbytes / HBM_BPS * 1e6:.3f} us) plain "
                            f"{plain_ms * 1e3:8.2f} us ({card})")
            del copies
    rows = [m for m in QMM_ROWS if m > 1]
    for path in ("mma", "simt"):
        ms, plain = (sum(results[("bfloat16", n, k, 8, m, path)][i]
                         for n, k in QMM_SHAPES for m in rows)
                     for i in (2, 3))
        log(f"[qmm] path {path}: bf16 x, 8-bit codes, M in {rows} at the "
            f"{len(QMM_SHAPES)} shapes, summed: kernel {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us ({card})")
    return results


def _qmm_case(x, q, bias, label: str, path=None):
    """K2 (by `path`, default the dispatched one) vs qmatmul_reference on
    one input: output dtype, shape, finiteness and the relative tolerance
    of x's dtype. -> (rel, abs)."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import qmatmul_reference

    args = (x, q["w_q"], q["scales"], q["biases"], bias)
    got, want = qmm_kernel(*args, path=path), qmatmul_reference(*args)
    torch.cuda.synchronize()
    if got.dtype != x.dtype or got.shape != (x.shape[0], q["w_q"].shape[0]):
        raise AssertionError(f"K2 {label}: output {got.dtype} "
                             f"{tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K2 {label}: output not finite")
    rel = rel_err(got, want)
    name = str(x.dtype).split(".")[-1]
    if not rel <= KERNEL_TOL[name]:
        raise AssertionError(f"K2 vs plain {name} {label}: rel {rel:.3e} > "
                             f"{KERNEL_TOL[name]}")
    return rel, float((got.float() - want.float()).abs().max())


def _codes_fed_to_codec(model, **kw):
    """generate() -> (result, the codes it handed decode_full)."""
    seen = []
    hook = model.speech_tokenizer.decoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        (r,) = list(model.generate(**kw))
    finally:
        hook.remove()
    return r, seen[0].cpu()


def phase_qwen3_reference():
    """Small config, f32, one seeded q8 weight set: CUDA vs CPU."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import FIRST_CHUNK
    from mlx_audio_tpu_torch.utils import apply_quantization

    cpu = Model(qwen3_small_config(), device="cpu").init_params(seed=0)
    apply_quantization(cpu, {"quantization": {"bits": 8, "group_size": 16}},
                       cpu.model_quant_predicate)
    gpu = copy.deepcopy(cpu).to("cuda")
    ids = np.arange(10, 40)[None]
    logits = []
    with torch.inference_mode():
        for m in (cpu, gpu):
            emb, _, _ = m.prepare_inputs(text_ids=ids)
            plen = emb.shape[1]
            logits.append(m._prefill(F.pad(emb, (0, 0, 0, 16 - plen)), plen,
                                     64)[0].cpu())
    kw = dict(text_ids=ids, temperature=0.0, max_tokens=1 + FIRST_CHUNK)
    (rc, cc), (rg, cg) = (_codes_fed_to_codec(m, **kw) for m in (cpu, gpu))
    with torch.inference_mode():
        audio_g = gpu.speech_tokenizer.decoder(cc.cuda()).cpu()
        audio_c = cpu.speech_tokenizer.decoder(cc)
    errs = {"prefill logits": rel_err(logits[1], logits[0]),
            "decode_full audio": rel_err(audio_g, audio_c)}
    log(f"[qwen3 reference] small config f32, q8 gs16: CUDA vs CPU rel err "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {QWEN3_E2E_TOL:g}); greedy codes of one chunk "
        f"({tuple(cc.shape)}) equal: {torch.equal(cc, cg)}")
    for name, err in errs.items():
        if not err <= QWEN3_E2E_TOL:
            raise AssertionError(f"CUDA vs CPU {name}: rel {err:.3e}")
    if not torch.equal(cc, cg):
        raise AssertionError(f"greedy codes differ:\n{cc}\n{cg}")
    if not (np.isfinite(rg.audio).all() and rg.samples == rc.samples):
        raise AssertionError("CUDA audio not finite or of another length")


def build_qwen3():
    """Full dims, bf16 weights drawn on the card from seed 0, then the AR
    path quantized to affine 8-bit, group 64 (bench.py:225-279's order)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    model = Model(qwen3_config(), device="cuda").astype(torch.bfloat16)
    model.init_params(seed=0, on_device=True)
    n_dense = model.num_params()
    apply_quantization(model, {"quantization": {"bits": 8,
                                                "group_size": QMM_GROUP}},
                       model.model_quant_predicate)
    torch.cuda.synchronize()
    log(f"[qwen3] {n_dense:,} params, bf16 on cuda, AR path q8 gs{QMM_GROUP}, "
        f"built in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return model


def phase_qwen3_q8_prefill(model):
    """Full dims: prefill logits with K2 vs the same q8 model through
    qmatmul_reference, on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops import quant

    ids = np.arange(100, 150)[None]
    out = []
    with torch.inference_mode():
        emb, _, _ = model.prepare_inputs(text_ids=ids)
        plen = emb.shape[1]
        emb = F.pad(emb, (0, 0, 0, 16 - plen))
        out.append(model._prefill(emb, plen, 256)[0].float())
        kernel_qmatmul = quant.qmatmul
        quant.qmatmul = quant.qmatmul_reference
        try:
            out.append(model._prefill(emb, plen, 256)[0].float())
        finally:
            quant.qmatmul = kernel_qmatmul
    rel = rel_err(out[0], out[1])
    corr = float(torch.corrcoef(torch.stack(out)[:, 0].double())[0, 1])
    log(f"[qwen3 q8 prefill] full dims, bf16: K2 vs qmatmul_reference logits "
        f"rel err {rel:.3e} (tol {Q8_PREFILL_TOL:g}), corr {corr:.6f} "
        f"(min {Q8_PREFILL_CORR:g})")
    if not (torch.isfinite(out[0]).all() and rel <= Q8_PREFILL_TOL
            and corr >= Q8_PREFILL_CORR):
        raise AssertionError(f"q8 prefill: rel {rel:.3e}, corr {corr}")


def k2_per_pass(model):
    """K2 launches of (one talker pass, one code-predictor pass, one
    text_projection call), derived from the config: every qwen3 layer runs
    LINEARS_PER_LAYER quantized linears, the talker pass adds codec_head,
    text_projection is fc1 and fc2. Raises unless the model holds exactly
    that many QuantizedLinear modules in each part: a linear left dense
    would run through cuBLAS, and the launch count would not see it."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    tc = model.tcfg
    want = (LINEARS_PER_LAYER * tc.num_hidden_layers + 1,
            LINEARS_PER_LAYER * tc.code_predictor_config.num_hidden_layers,
            2)

    def count(*modules):
        return sum(isinstance(m, QuantizedLinear)
                   for module in modules for m in module.modules())

    t = model.talker
    have = (count(t.model.layers, t.codec_head), count(t.code_predictor),
            count(t.text_projection))
    if have != want or count(model) != sum(want):
        raise AssertionError(
            f"quantized linears (talker, code predictor, text_projection) "
            f"{have}, {count(model)} in all; the config gives {want}")
    return want


def expected_k2_launches(model, run):
    """K2 launches of one generate(): the prefill is one talker pass; step 0
    runs the code predictor's G-1 passes; each decode step one talker pass
    and G-1 code-predictor passes; each text_projection call its two
    linears."""
    talker, cp, tp = k2_per_pass(model)
    g1 = model.tcfg.num_code_groups - 1
    return (talker + g1 * cp + (talker + g1 * cp) * run["decode_steps"]
            + tp * run["text_projection_calls"])


def expected_decode_steps(frames: int, max_tokens: int) -> int:
    """Steps the chunk loop runs for `frames` kept frames: FIRST_CHUNK, then
    CHUNK_TOKENS, each cut to the token budget; EOS at decode step s (then
    frames == s < max_tokens) stops the loop STEPS_AFTER_EOS steps later,
    or at the end of its chunk if that comes first."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import (
        CHUNK_TOKENS, FIRST_CHUNK, STEPS_AFTER_EOS)

    total, end = 1, 0
    while total < max_tokens:
        chunk = min(FIRST_CHUNK if total <= 1 else CHUNK_TOKENS,
                    max_tokens - total)
        end += chunk
        if total + chunk > frames:      # EOS in this chunk, at step frames
            return min(frames + STEPS_AFTER_EOS, end)
        total += chunk
    return end


class K2Recorder:
    """While active, counts K2's launches through `ops.quant.qmatmul` by
    (M, out, in, has bias) and by the path `choose_path` gives them."""

    def __init__(self):
        from collections import Counter

        self.calls, self.paths = Counter(), Counter()

    def __enter__(self):
        from mlx_audio_tpu_torch.ops import quant
        from mlx_audio_tpu_torch.ops.qmm import choose_path, qmm_kernel

        def recording(x, w_q, scales, biases, bias=None):
            self.calls[(x.shape[0], *w_q.shape, bias is not None)] += 1
            self.paths[choose_path(x.dtype, x.shape[0],
                                   w_q.shape[1] // scales.shape[1])] += 1
            return qmm_kernel(x, w_q, scales, biases, bias)

        quant.qmm_kernel = recording
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.ops import quant
        from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

        quant.qmm_kernel = qmm_kernel


def phase_qwen3_main(model, card: str, recorder: K2Recorder) -> int:
    """Two generate(text_ids=...) requests, q8, cold then warm. Returns
    K2's launch count over the four; `recorder` gathers the (M, out, in,
    has bias) K2 was launched with."""
    talker, cp, tp = k2_per_pass(model)
    g1 = model.tcfg.num_code_groups - 1
    counts = {"prefill": talker, "step0": g1 * cp,
              "decode step": talker + g1 * cp, "text_projection": tp}
    log(f"[qwen3 main] K2 launches per decode step: {talker} (talker) + "
        f"{g1} x {cp} (code predictor) = {counts['decode step']}")
    if counts != K2_LAUNCHES_FULL_DIMS:
        raise AssertionError(f"K2 launches {counts}, want "
                             f"{K2_LAUNCHES_FULL_DIMS} at full dims")
    with recorder:
        total = _qwen3_requests(model, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return total


def _qwen3_requests(model, card: str) -> int:
    """The four requests of phase 7; returns K2's launches over them."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    qmm_kernel.launches = 0
    total = 0
    for run in ("cold", "warm"):
        for ids, max_tokens in qwen3_requests():
            before = qmm_kernel.launches
            torch.cuda.reset_peak_memory_stats()
            (r,) = list(model.generate(text_ids=ids[None], temperature=0.9,
                                       max_tokens=max_tokens,
                                       seed=QWEN3_SEED))
            launches = qmm_kernel.launches - before
            total += launches
            frames, steps = r.token_count, model.last_run["decode_steps"]
            want = expected_k2_launches(model, model.last_run)
            if launches != want:
                raise AssertionError(f"{launches} K2 launches, want {want} "
                                     f"({model.last_run})")
            if frames > 1 and steps != expected_decode_steps(frames,
                                                             max_tokens):
                raise AssertionError(f"{steps} decode steps for {frames} "
                                     f"frames of {max_tokens}")
            audio = np.asarray(r.audio)
            if r.samples != frames * model.total_upsample:
                raise AssertionError(f"{r.samples} samples for {frames} "
                                     f"frames")
            if audio.shape != (r.samples,) or not np.isfinite(audio).all():
                raise AssertionError("audio has the wrong shape or is not "
                                     "finite")
            audio_s = r.samples / r.sample_rate
            wall = r.processing_time_seconds
            log(f"[qwen3 main] {run} {len(ids):3d} text ids max_tokens "
                f"{max_tokens:3d}: {frames:3d} frames ({steps} decode steps) "
                f"{audio_s:6.2f} s audio: wall {wall * 1e3:9.2f} ms "
                f"({wall * 1e3 / max(steps + 1, 1):6.2f} ms/frame), xRT "
                f"{audio_s / wall:6.3f}, {launches} K2 launches, peak "
                f"{r.peak_memory_usage:.2f} GB ({card})")
    return total


def phase_qmm_path(shapes) -> float:
    """K2 against qmatmul_reference at every (M, out, in, bias) the main
    paths launched it with (the prefill bucket, the code predictor's first
    sub-step at M=2, text_projection over the text ids, the session's
    frame at M=8 and 16 and its burst prefill, ...), 8-bit codes, group
    64, x in f32 and bf16. Returns the largest bf16 abs error."""
    import torch

    from mlx_audio_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    weights = {}
    worst = 0.0
    for m, n, k, has_bias in sorted(shapes):
        if (n, k) not in weights:
            weights[(n, k)] = quantize_weight(
                torch.randn(n, k, generator=g, device=dev) * k ** -0.5,
                QMM_GROUP, 8)
        q = weights[(n, k)]
        bias = (0.01 * torch.randn(n, generator=g, device=dev)
                if has_bias else None)
        x32 = torch.randn(m, k, generator=g, device=dev)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            errs.append(_qmm_case(x32.to(dtype), q, bias,
                                  f"({n},{k}) q8 M={m}"))
        worst = max(worst, errs[1][1])
        log(f"[qmm path] ({n:4d},{k:4d}) q8 M={m:3d} bias={has_bias!s:5s} "
            f"rel f32 {errs[0][0]:.3e} bf16 {errs[1][0]:.3e}")
    return worst


# ---------------------------------------------------------------------------
# Qwen3-TTS streaming and continuous batching (phases 9-11)
# ---------------------------------------------------------------------------

# phase 10: the JAX lane's streamed request (bench.py:303-305)
STREAM_IDS, STREAM_TOKENS, STREAM_INTERVAL, STREAM_SEED = (100, 150), 100, \
    2.0, 1
# phase 11: the JAX lane's batched session (bench.py:761-803)
SESSION_B, SESSION_TOKENS, SESSION_INTERVAL, SESSION_CACHE = 8, 100, 0.4, \
    1024
# the broker's three requests: frames each, and the session's slots (the
# server's default MLX_AUDIO_TTS_MAX_BATCH_SIZE)
BROKER_TOKENS, BROKER_SLOTS = 40, 4
# streamed against one-shot decode on the card, f32: the CPU tests' bound
STREAM_FULL_ATOL = 2e-4


def _small_pair():
    """The small config at f32 from one seeded q8 weight set: (CPU model,
    the same weights on the card)."""
    import copy

    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model
    from mlx_audio_tpu_torch.utils import apply_quantization

    cpu = Model(qwen3_small_config(), device="cpu").init_params(seed=0)
    apply_quantization(cpu, {"quantization": {"bits": 8, "group_size": 16}},
                       cpu.model_quant_predicate)
    return cpu, copy.deepcopy(cpu).to("cuda")


def _session_run(model, options, requests, admit_after=()):
    """Submit `requests` (text-id ranges) to a new session of `model`, the
    ones whose index is in `admit_after` after the first step; step until
    idle. -> ({slot: codes}, [audio of each request])."""
    import numpy as np

    from mlx_audio_tpu_torch.server_inference import InferenceRequest

    sess = model.create_tts_batch_session(options)
    seen = {}
    decode = type(sess)._decode_batch.__get__(sess)

    def recording(rows):
        for slot, _ in rows:
            seen[slot] = np.concatenate(sess.codes[slot], axis=0).copy()
        return decode(rows)

    sess._decode_batch = recording
    reqs = [InferenceRequest(endpoint_kind="tts", model_name="smoke",
                             payload=None,
                             normalized_kwargs={"text_ids": np.arange(*r)[None]})
            for r in requests]
    for i, r in enumerate(reqs):
        if i not in admit_after:
            sess.submit(r)
    sess.step()
    for i in admit_after:
        sess.submit(reqs[i])
    for _ in range(200):
        if sess.idle:
            break
        sess.step()
    if not sess.idle:
        raise AssertionError("session did not finish")
    audio = []
    for r in reqs:
        kinds, parts = [], []
        while not r.result_queue.empty():
            c = r.result_queue.get()
            kinds.append(c.kind)
            if c.kind == "data":
                parts.append(c.payload["audio"])
        if kinds[-1:] != ["done"] or "error" in kinds:
            raise AssertionError(f"request ended {kinds}")
        audio.append(np.concatenate(parts) if parts else np.zeros(0))
    return seen, audio


def phase_qwen3_streaming_reference():
    """Small config, f32, one seeded q8 weight set: the streaming path and
    the session on the card against the CPU."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    cpu, gpu = _small_pair()
    kw = dict(text_ids=np.arange(10, 40)[None], temperature=0.0,
              max_tokens=30, stream=True, streaming_interval=0.4)
    rc, rg = (list(m.generate(**kw)) for m in (cpu, gpu))
    sizes = [r.samples for r in rc]
    if [r.samples for r in rg] != sizes or not rc[-1].is_final_chunk \
            or not rg[-1].is_final_chunk:
        raise AssertionError(f"streamed chunks differ: "
                             f"{[r.samples for r in rg]} vs {sizes}")
    ac, ag = (np.concatenate([r.audio for r in rs]) for rs in (rc, rg))
    stream_rel = rel_err(torch.from_numpy(ag), torch.from_numpy(ac))
    # the streaming codec on the card against its one-shot decode
    dec = gpu.speech_tokenizer.decoder
    codes = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 4, 24))).to(gpu.device)
    with torch.inference_mode():
        full = dec(codes)
        state = init_stream_state(gpu.dcfg, 2, device=gpu.device)
        parts = []
        for a, b in ((0, 5), (5, 6), (6, 14), (14, 24)):
            state, chunk = dec.streaming_step(state, codes[:, :, a:b])
            parts.append(chunk)
    codec_abs = float((torch.cat(parts, -1) - full).abs().max())
    opts = dict(max_batch_size=2, max_tokens=16, temperature=0.0,
                repetition_penalty=1.0, streaming_interval=0.4,
                max_cache_len=256)
    (cc, sa_c), (cg, sa_g) = (
        _session_run(m, TTSBatchOptions(**opts), [(10, 25), (30, 42)],
                     admit_after=(1,)) for m in (cpu, gpu))
    codes_equal = sorted(cc) == sorted(cg) and all(
        np.array_equal(cc[s], cg[s]) for s in cc)
    sess_rel = max(rel_err(torch.from_numpy(g), torch.from_numpy(c))
                   for g, c in zip(sa_g, sa_c))
    log(f"[qwen3 stream reference] small config f32, q8 gs16, CUDA vs CPU: "
        f"greedy stream chunks {sizes} equal, audio rel {stream_rel:.3e} "
        f"(tol {QWEN3_E2E_TOL:g}); streaming_step over uneven chunks vs "
        f"decode_full on the card abs {codec_abs:.3e} (tol "
        f"{STREAM_FULL_ATOL:g}); two-slot session, one admitted mid-stream: "
        f"codes equal {codes_equal}, audio rel {sess_rel:.3e}")
    if not (stream_rel <= QWEN3_E2E_TOL and codec_abs <= STREAM_FULL_ATOL
            and codes_equal and sess_rel <= QWEN3_E2E_TOL):
        raise AssertionError("streaming or session: CUDA vs CPU")
    if not all(len(a) > 0 and np.isfinite(a).all() for a in sa_g + [ag]):
        raise AssertionError("CUDA streamed audio empty or not finite")


def phase_qwen3_stream(model, card: str, recorder: K2Recorder) -> int:
    """The JAX lane's streamed request, cold then warm. Returns K2's
    launches over the two."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel

    spf = model.total_upsample
    qmm_kernel.launches = 0
    total = 0
    with recorder:
        for run in ("cold", "warm"):
            before = qmm_kernel.launches
            t0 = time.perf_counter()
            ttfa, results = None, []
            for r in model.generate(text_ids=np.arange(*STREAM_IDS)[None],
                                    temperature=0.9, max_tokens=STREAM_TOKENS,
                                    stream=True,
                                    streaming_interval=STREAM_INTERVAL,
                                    seed=STREAM_SEED):
                if ttfa is None and r.samples > 0:
                    ttfa = time.perf_counter() - t0
                results.append(r)
            wall = time.perf_counter() - t0
            launches = qmm_kernel.launches - before
            total += launches
            run_info = model.last_run
            want = expected_k2_launches(model, run_info)
            if launches != want:
                raise AssertionError(f"{launches} K2 launches, want {want} "
                                     f"({run_info})")
            frames = results[-1].token_count
            samples = sum(r.samples for r in results)
            audio = np.concatenate([r.audio for r in results])
            if not (results[-1].is_final_chunk and samples == frames * spf
                    and 0 < frames <= STREAM_TOKENS
                    and np.isfinite(audio).all()):
                raise AssertionError(f"stream: {samples} samples for "
                                     f"{frames} frames, final "
                                     f"{results[-1].is_final_chunk}")
            if frames == STREAM_TOKENS and \
                    run_info["decode_steps"] != STREAM_TOKENS - 1:
                raise AssertionError(f"{run_info['decode_steps']} decode "
                                     f"steps for {frames} frames")
            stats = model._last_stream_stats
            audio_s = samples / model.sample_rate
            log(f"[qwen3 stream] {run} {STREAM_IDS[1] - STREAM_IDS[0]} ids "
                f"max_tokens {STREAM_TOKENS} interval {STREAM_INTERVAL}: "
                f"{frames} frames {audio_s:.2f} s audio in "
                f"{sum(r.samples > 0 for r in results)} chunks: time to "
                f"first audio {ttfa * 1e3:.2f} ms, wall {wall * 1e3:.2f} ms "
                f"({wall * 1e3 / frames:.2f} ms/frame), xRT "
                f"{audio_s / wall:.3f}; {stats['n_fetches']} reads, host "
                f"wait {stats['stall_s'] * 1e3:.2f} ms; "
                f"{run_info['decode_steps']} decode steps, "
                f"{run_info['codec_blocks']} codec blocks run; {launches} K2 "
                f"launches ({card})")
    return total


class _SessionCounts:
    """Counts the frames a session's chunks ran and its admission groups,
    by wrapping the session class's methods while active."""

    def __enter__(self):
        from mlx_audio_tpu_torch.tts.models.qwen3_tts.continuous_batching \
            import Qwen3TTSBatchSession as S

        self.frames = self.groups = 0
        self._orig = (S._chunk, S._admit_many)
        chunk, admit = self._orig

        def counting_chunk(sess, k):
            self.frames += k
            return chunk(sess, k)

        def counting_admit(sess, group):
            self.groups += 1
            return admit(sess, group)

        S._chunk, S._admit_many = counting_chunk, counting_admit
        return self

    def __exit__(self, *exc):
        from mlx_audio_tpu_torch.tts.models.qwen3_tts.continuous_batching \
            import Qwen3TTSBatchSession as S

        S._chunk, S._admit_many = self._orig


def session_k2_launches(model, frames: int, groups: int, tp_calls: int):
    """K2 launches the config gives for a session: a decode frame and an
    admission group (its prefill and batched step 0) are each one talker
    pass and G-1 code-predictor passes; each text_projection call is two."""
    talker, cp, tp = k2_per_pass(model)
    per_frame = talker + (model.tcfg.num_code_groups - 1) * cp
    return per_frame * (frames + groups) + tp * tp_calls


def phase_qwen3_session(model, card: str, recorder: K2Recorder) -> int:
    """One session at b = 8 and a cold burst of 8 requests; then three
    requests through the broker. Returns K2's launches over both."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server_inference import InferenceRequest
    from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions

    spf = model.total_upsample
    t0 = time.perf_counter()
    sess = model.create_tts_batch_session(TTSBatchOptions(
        max_batch_size=SESSION_B, max_tokens=SESSION_TOKENS,
        streaming_interval=SESSION_INTERVAL, max_cache_len=SESSION_CACHE))
    sess.warmup()
    k = sess.frames_per_step
    log(f"[qwen3 session] b={SESSION_B}, {k} frames a step, timeline "
        f"{SESSION_CACHE}, codec stream KV "
        f"{sess.codec_state['tf_caches'][0].k.shape[1]} frames: built and "
        f"warmed up in {(time.perf_counter() - t0) * 1e3:.2f} ms")
    reqs = [InferenceRequest(
        endpoint_kind="tts", model_name="smoke", payload=None,
        normalized_kwargs={"text_ids": np.arange(100 + i, 150 + i)[None]})
        for i in range(SESSION_B)]
    ttfa, audio, kinds = {}, [[] for _ in reqs], [[] for _ in reqs]
    step_walls, per_path = [], {}
    qmm_kernel.launches = 0
    tp0 = model._text_projection_calls
    with recorder, _SessionCounts() as counts:
        t0 = time.perf_counter()
        for r in reqs:
            sess.submit(r)
        want = session_k2_launches(model, 0, 0,
                                   model._text_projection_calls - tp0)
        if qmm_kernel.launches != want:
            raise AssertionError(f"submit: {qmm_kernel.launches} K2 "
                                 f"launches, want {want}")
        for step in range(4 * SESSION_TOKENS):
            if sess.idle:
                break
            before = (qmm_kernel.launches, counts.frames, counts.groups,
                      dict(recorder.paths))
            ts = time.perf_counter()
            sess.step()
            now = time.perf_counter()
            step_walls.append(now - ts)
            for i, r in enumerate(reqs):
                while not r.result_queue.empty():
                    c = r.result_queue.get()
                    kinds[i].append(c.kind)
                    if c.kind == "data":
                        ttfa.setdefault(i, now - t0)
                        audio[i].append(c.payload["audio"])
            launches = qmm_kernel.launches - before[0]
            want = session_k2_launches(model, counts.frames - before[1],
                                       counts.groups - before[2], 0)
            if launches != want:
                raise AssertionError(f"step {step}: {launches} K2 launches, "
                                     f"want {want}")
            paths = {p: n - before[3].get(p, 0)
                     for p, n in recorder.paths.items()
                     if n != before[3].get(p, 0)}
            per_path[tuple(sorted(paths.items()))] = \
                per_path.get(tuple(sorted(paths.items())), 0) + 1
        wall = time.perf_counter() - t0
    launches = qmm_kernel.launches
    if not sess.idle:
        raise AssertionError("the b=8 session did not finish")
    total_s = 0.0
    for i in range(SESSION_B):
        a = np.concatenate(audio[i]) if audio[i] else np.zeros(0)
        if kinds[i][-1:] != ["done"] or "error" in kinds[i] or not len(a) \
                or len(a) % spf or not np.isfinite(a).all():
            raise AssertionError(f"request {i}: {kinds[i]}, {len(a)} "
                                 f"samples")
        total_s += len(a) / model.sample_rate
    if "mma" not in recorder.paths or not any(
            m == 8 for m, *_ in recorder.calls):
        raise AssertionError(f"no mma launch at M = 8: {recorder.paths}")
    tt = sorted(ttfa.values())
    walls = sorted(step_walls)
    log(f"[qwen3 session] cold burst of {SESSION_B} x {SESSION_TOKENS} "
        f"frames: {total_s:.2f} s of audio in {wall * 1e3:.2f} ms, aggregate "
        f"xRT {total_s / wall:.3f}; time to first audio p50 "
        f"{tt[len(tt) // 2] * 1e3:.2f} ms, max {tt[-1] * 1e3:.2f} ms; "
        f"{len(walls)} steps, wall per step median "
        f"{walls[len(walls) // 2] * 1e3:.2f} ms, max {walls[-1] * 1e3:.2f} "
        f"ms ({wall * 1e3 / counts.frames:.2f} ms per frame of all rows); "
        f"{launches} K2 launches ({card})")
    for paths, n in sorted(per_path.items(), key=lambda kv: -kv[1]):
        log(f"[qwen3 session] K2 launches per path in {n} step(s): "
            f"{dict(paths)}")
    launches += _broker_requests(model, card, recorder)
    return launches


class SmokeTTSAdapter:
    """The continuous-batch routing of the server's TTS adapter
    (mlx_audio_tpu/server.py:117-146) for one model: every request the
    model can batch goes to a session made from the request's options,
    warmed up before the first request joins it."""

    max_batch_size = 1

    def __init__(self, model):
        self.model = model

    def supports_batch(self, request) -> bool:
        return False

    def batch_key(self, request):
        return None

    def supports_continuous_batch(self, request) -> bool:
        checker = getattr(self.model, "supports_tts_continuous_batch", None)
        return bool(checker and checker())

    def continuous_batch_key(self, request):
        return None

    def create_continuous_batch_session(self, request):
        from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions

        kw = request.normalized_kwargs
        sess = self.model.create_tts_batch_session(TTSBatchOptions(
            max_batch_size=BROKER_SLOTS,
            temperature=float(kw.get("temperature", 0.9)),
            top_k=int(kw.get("top_k", 50)),
            max_tokens=int(kw.get("max_tokens", 1200)),
            streaming_interval=float(kw.get("streaming_interval", 2.0)),
            max_cache_len=SESSION_CACHE))
        sess.warmup()
        return sess

    def run_serial(self, request) -> None:
        raise AssertionError("a TTS request took the serial path")


def _broker_requests(model, card: str, recorder: K2Recorder) -> int:
    """Three requests through the port's InferenceBroker; its worker thread
    creates the session, steps it and answers them. Returns K2's
    launches."""
    import numpy as np

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.server_inference import InferenceBroker

    qmm_kernel.launches = 0
    tp0 = model._text_projection_calls
    with recorder, _SessionCounts() as counts:
        t0 = time.perf_counter()
        broker = InferenceBroker(idle_poll_s=0.01)
        try:
            broker.register_adapter("tts", SmokeTTSAdapter(model))
            handles = [broker.submit(
                endpoint_kind="tts", model_name="smoke", payload=None,
                normalized_kwargs={
                    "text_ids": np.arange(100 + i, 130 + i)[None],
                    "max_tokens": BROKER_TOKENS,
                    "streaming_interval": SESSION_INTERVAL})
                for i in range(3)]
            done = []
            for h in handles:
                kinds, parts = [], []
                while kinds[-1:] != ["done"]:
                    c = h.result_queue.get(timeout=300)
                    kinds.append(c.kind)
                    if c.kind == "data":
                        parts.append(c.payload["audio"])
                    elif c.kind == "error":
                        raise AssertionError(f"broker request: {c.error!r}")
                a = np.concatenate(parts) if parts else np.zeros(0)
                if not len(a) or len(a) % model.total_upsample \
                        or not np.isfinite(a).all():
                    raise AssertionError(f"broker audio {len(a)} samples")
                done.append(len(a) / model.sample_rate)
                wall = time.perf_counter() - t0
        finally:
            broker.stop_and_join(timeout=60)
        launches = qmm_kernel.launches
    want = session_k2_launches(model, counts.frames, counts.groups,
                               model._text_projection_calls - tp0)
    if launches != want:
        raise AssertionError(f"broker: {launches} K2 launches, want {want}")
    log(f"[qwen3 broker] 3 requests x {BROKER_TOKENS} frames through "
        f"InferenceBroker (a session of {BROKER_SLOTS} slots, warmed up on "
        f"the broker thread): all done, {sum(done):.2f} s of audio, last "
        f"answered {wall * 1e3:.2f} ms after submit; {launches} K2 launches "
        f"({counts.frames} session frames, {counts.groups} admissions, warm-up "
        f"included) ({card})")
    return launches


def _qlinear_shapes(module):
    """(out, in) of each quantized linear in `module`, in module order."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    return [tuple(m.w_q.shape) for m in module.modules()
            if isinstance(m, QuantizedLinear)]


def frame_linears(model):
    """(out, in) of every K2 launch of one decode step."""
    t = model.talker
    g1 = model.tcfg.num_code_groups - 1
    return (_qlinear_shapes(t.model.layers) + _qlinear_shapes(t.codec_head)
            + g1 * _qlinear_shapes(t.code_predictor))


def session_frame_linears(model, b: int):
    """(M, out, in) of every K2 launch of one decode frame of a session of
    b slots: the talker's linears at M = b, the code predictor's first
    sub-step ([hidden, code 0]) at M = 2b and its other sub-steps at b."""
    t = model.talker
    talker = _qlinear_shapes(t.model.layers) + _qlinear_shapes(t.codec_head)
    cp = _qlinear_shapes(t.code_predictor)
    g1 = model.tcfg.num_code_groups - 1
    return ([(b, n, k) for n, k in talker] + [(2 * b, n, k) for n, k in cp]
            + (g1 - 1) * [(b, n, k) for n, k in cp])


# ---------------------------------------------------------------------------
# Whisper (phases 12-14)
# ---------------------------------------------------------------------------

# tests/test_whisper.py:14-17: the small config of the CUDA-vs-CPU check
WHISPER_SMALL = dict(n_mels=80, n_audio_ctx=100, n_audio_state=32,
                     n_audio_head=2, n_audio_layer=2, n_vocab=51865,
                     n_text_ctx=64, n_text_state=32, n_text_head=2,
                     n_text_layer=2)
# large-v3-turbo, the JAX lane's dims (bench.py:892-895)
WHISPER_TURBO = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280,
                     n_audio_head=20, n_audio_layer=32, n_vocab=51866,
                     n_text_ctx=448, n_text_state=1280, n_text_head=20,
                     n_text_layer=4)
# the JAX lane's workload (bench.py:898-905): 600 s of randn * 0.1, seed 0
WHISPER_SECONDS = 600
WHISPER_KW = dict(language="en", temperature=0.0,
                  compression_ratio_threshold=None, logprob_threshold=None,
                  no_speech_threshold=None, return_timestamps=True,
                  sample_len=100)
# CUDA against the CPU at f32: log-mel (cuFFT against the CPU's FFT, f64)
MEL_ATOL = 1e-4
# bf16 encoder against f32 on one 30-s window, relative Frobenius error
WHISPER_BF16_REL = 2e-2
WHISPER_HF_NAMES = (
    (".blocks.", ".layers."),
    (".cross_attn.query.", ".encoder_attn.q_proj."),
    (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".attn.query.", ".self_attn.q_proj."), (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."), (".attn.out.", ".self_attn.out_proj."),
    (".attn_ln.", ".self_attn_layer_norm."), (".mlp_ln.", ".final_layer_norm."),
    (".mlp1.", ".fc1."), (".mlp2.", ".fc2."),
    ("encoder.ln_post.", "encoder.layer_norm."),
    ("decoder.ln.", "decoder.layer_norm."),
    ("decoder.token_embedding.", "decoder.embed_tokens."),
    ("decoder.positional_embedding", "decoder.embed_positions.weight"))


def _whisper(dims: dict, device: str, like=None):
    """A Whisper model on `device`: seeded (seed 0, drawn on the CPU) or
    with the parameters of `like`."""
    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    model = Model(ModelDimensions(**dims), device=device)
    if like is None:
        return model.init_params(seed=0)
    model.load_state_dict(like.state_dict())
    return model


def _segments_equal(a, b, what: str) -> None:
    """Tokens, texts, seeks, segment times and word times equal."""
    if a.text != b.text or len(a.segments) != len(b.segments):
        raise AssertionError(f"{what}: texts or segment counts differ")
    for x, y in zip(a.segments, b.segments):
        for k in ("seek", "tokens", "text", "start", "end"):
            if x[k] != y[k]:
                raise AssertionError(f"{what}: segment {k} {x[k]!r} != "
                                     f"{y[k]!r}")
        wx = [(w["word"], w["start"], w["end"]) for w in x.get("words", [])]
        wy = [(w["word"], w["start"], w["end"]) for w in y.get("words", [])]
        if wx != wy:
            raise AssertionError(f"{what}: word times differ: {wx} != {wy}")


def phase_whisper_reference() -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the whole-file log-mel, then greedy generate() on 6 s of seeded
    noise with timestamps and word timestamps."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper.audio import (
        log_mel_spectrogram)

    cpu = _whisper(WHISPER_SMALL, "cpu")
    gpu = _whisper(WHISPER_SMALL, "cuda", like=cpu)
    audio = (np.random.RandomState(0).randn(16000 * 6) * 0.05).astype(
        np.float32)
    mel_c = log_mel_spectrogram(audio, 80, padding=cpu.window_samples)
    mel_g = log_mel_spectrogram(audio, 80, padding=cpu.window_samples,
                                device="cuda")
    mel_err = float((mel_g.cpu() - mel_c).abs().max())
    if not mel_err <= MEL_ATOL:
        raise AssertionError(f"log-mel CUDA vs CPU {mel_err:.3e} > {MEL_ATOL}")
    kw = dict(language="en", temperature=0.0, word_timestamps=True)
    want = cpu.generate(audio, **kw)
    got = gpu.generate(audio, **kw)
    _segments_equal(got, want, "small Whisper CUDA vs CPU")
    n_words = sum(len(s["words"]) for s in got.segments)
    if not got.segments or not n_words:
        raise AssertionError("small Whisper: no segments or no words")
    log(f"[whisper-ref] small config f32, 6 s: log-mel CUDA vs CPU "
        f"{mel_err:.2e} abs (tol {MEL_ATOL}); {len(got.segments)} segments, "
        f"{sum(len(s['tokens']) for s in got.segments)} tokens, {n_words} "
        f"words: tokens, segment and word times equal; "
        f"{gpu.last_run['windows']} windows, {gpu.last_run['decode_steps']} "
        f"decode steps on the card")


def whisper_encoder_flops(d: dict) -> float:
    """Operations (2 per multiply-add) of one window through the encoder:
    the two stem convs, then per layer q, k, v, out, the two attention
    products and the MLP."""
    t, c, w = d["n_audio_ctx"], d["n_audio_state"], 2 * d["n_audio_ctx"]
    stem = 2 * w * d["n_mels"] * c * 3 + 2 * t * c * c * 3
    layer = 4 * 2 * t * c * c + 2 * 2 * t * t * c + 2 * 2 * t * c * 4 * c
    return stem + d["n_audio_layer"] * layer


def build_whisper_turbo():
    """(f32, bf16) large-v3-turbo models on the card with one weight set:
    drawn there in f32 from seed 0, the bf16 copy cast from it."""
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper import Model, ModelDimensions

    f32 = Model(ModelDimensions(**WHISPER_TURBO), device="cuda").init_params(
        seed=0, on_device=True)
    return f32, _whisper(WHISPER_TURBO, "cuda", like=f32).astype(
        torch.bfloat16)


def phase_whisper_turbo(card: str) -> dict:
    """Whisper large-v3-turbo at full width on the card: the bf16 encoder
    against f32 on one window, the encoder's time per window, the JAX
    lane's 600-s transcription cold then warm, and the streaming session
    over ten 1-s chunks."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.whisper.audio import pad_or_trim

    t0 = time.perf_counter()
    f32, model = build_whisper_turbo()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[whisper] large-v3-turbo dims (32 x d1280 encoder, 4-layer "
        f"decoder, 128 mels): {n_params / 1e6:.1f} M parameters drawn on the "
        f"card from seed 0, cast to bf16 ({time.perf_counter() - t0:.2f} s)")
    audio = (np.random.RandomState(0).randn(WHISPER_SECONDS * 16000) * 0.1
             ).astype(np.float32)

    # one 30-s window, bf16 against f32
    mel, _ = model._prepare_audio(audio[:model.window_samples], padding=0)
    win = pad_or_trim(mel, model.window_frames)[None]
    with torch.inference_mode():
        ref = f32.embed_audio(win).float()
        got = model.embed_audio(win).float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not rel < WHISPER_BF16_REL:
        raise AssertionError(f"bf16 encoder vs f32: {rel:.3e} >= "
                             f"{WHISPER_BF16_REL}")
    del f32, ref
    torch.cuda.empty_cache()
    enc_ms = _time_ms(lambda: model.embed_audio(win), 10)
    flops = whisper_encoder_flops(WHISPER_TURBO)
    bound_ms = flops / PEAK_BF16 * 1e3
    log(f"[whisper] bf16 encoder vs f32 on one 30-s window: relative "
        f"Frobenius {rel:.3e} (limit {WHISPER_BF16_REL}); encoder "
        f"{enc_ms:.3f} ms a window (CUDA events, median of 10), "
        f"{flops / 1e12:.3f} TFLOP: {flops / enc_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound_ms / enc_ms:.1f}% of 989 TFLOP/s ({card})")

    out = {}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = model.generate(audio, **WHISPER_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        run = dict(model.last_run)
        n_tok = sum(len(s["tokens"]) for s in res.segments)
        if not res.segments or not all(
                np.isfinite([s["start"], s["end"], s["avg_logprob"]]).all()
                for s in res.segments):
            raise AssertionError("turbo transcription: no segments, or "
                                 "non-finite times or log-probabilities")
        if run["decodes"] != run["windows"]:
            raise AssertionError(f"{run}: a fallback ran with every "
                                 f"threshold off")
        step_ms = (wall * 1e3 - run["windows"] * enc_ms) / run["decode_steps"]
        log(f"[whisper] {label}: {WHISPER_SECONDS} s in {wall:.3f} s, xRT "
            f"{WHISPER_SECONDS / wall:.2f}; {run['windows']} windows, "
            f"{len(res.segments)} segments, {n_tok} tokens; "
            f"{run['decode_steps']} decode steps, {step_ms:.3f} ms a step "
            f"(wall less the windows' encoder time, per step); encoder "
            f"{run['windows'] * enc_ms / 1e3:.3f} s of it ({card})")
        out[label] = (wall, run, res)
    if out["warm"][2].text != out["cold"][2].text:
        raise AssertionError("turbo: warm transcription differs from cold")

    # the streaming session: ten 1-s chunks, then close()
    sess = model.create_streaming_session(language="en")
    lat, events = [], []
    chunks = [audio[i * 16000:(i + 1) * 16000] for i in range(10)]
    for chunk in chunks + [None]:
        if chunk is None:
            sess.close()
        else:
            sess.feed(chunk)
        while True:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            evs = sess.step()
            lat.append(time.perf_counter() - t1)
            events += evs
            if chunk is not None or sess.done:
                break
    lat_ms = sorted(1e3 * v for v in lat)
    if not events or events[-1].kind != "final":
        raise AssertionError(f"streaming session: no final event "
                             f"({[e.kind for e in events]})")
    log(f"[whisper] streaming session, ten 1-s chunks then close(): "
        f"{len(lat)} steps, p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max "
        f"{lat_ms[-1]:.2f} ms a step; {len(events)} events, the last "
        f"'final' ({len(events[-1].text)} chars) ({card})")
    del model
    torch.cuda.empty_cache()
    return {"enc_ms": enc_ms, "rel": rel, "warm": out["warm"][:2]}


def write_whisper_checkpoint(model, path: Path) -> None:
    """`model` as an HF-style checkpoint directory: config.json in HF keys
    and the weights under HF names in one npz (no safetensors needed)."""
    import numpy as np

    d = model.dims
    state = {}
    for k, v in model.state_dict().items():
        for a, b in WHISPER_HF_NAMES:
            k = k.replace(a, b)
        state["model." + k] = v.float().cpu().numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "weights.npz", **state)
    (path / "config.json").write_text(json.dumps(dict(
        model_type="whisper", d_model=d.n_audio_state,
        encoder_layers=d.n_audio_layer, decoder_layers=d.n_text_layer,
        encoder_attention_heads=d.n_audio_head,
        decoder_attention_heads=d.n_text_head, num_mel_bins=d.n_mels,
        vocab_size=d.n_vocab, max_source_positions=d.n_audio_ctx,
        max_target_positions=d.n_text_ctx)))


def phase_whisper_cli(tmp: Path) -> None:
    """The normal entry points on the card: a small checkpoint (HF names,
    npz) and a 5-s WAV written with the port's audio_io, the STT CLI in a
    subprocess, and its JSON against load_model(...).generate(...) here."""
    import numpy as np

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io

    ckpt, wav, out = tmp / "whisper-small", tmp / "speech.wav", tmp / "out"
    write_whisper_checkpoint(_whisper(WHISPER_SMALL, "cpu"), ckpt)
    audio_io.write(wav, (np.random.RandomState(5).randn(16000 * 5) * 0.05
                         ).astype(np.float32), 16000)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_audio_tpu_torch.stt.generate", "--model",
         str(ckpt), "--audio", str(wav), "--format", "json", "--output-path",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"STT CLI failed: {proc.stderr[-2000:]}")
    got = json.loads((out / "transcription.json").read_text())
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda":
        raise AssertionError("load_model did not load onto the card")
    want = model.generate(str(wav), temperature=0.0)
    want_segs = json.loads(json.dumps(want.segments))
    if got["text"] != want.text or got["language"] != want.language:
        raise AssertionError("STT CLI text differs from load_model(...)")
    if len(got["segments"]) != len(want_segs) or not want_segs:
        raise AssertionError("STT CLI segment count differs")
    for a, b in zip(got["segments"], want_segs):
        for k in b:
            same = (abs(a[k] - b[k]) <= 1e-6 if isinstance(b[k], float)
                    else a[k] == b[k])
            if not same:
                raise AssertionError(f"STT CLI segment {k}: {a[k]!r} != "
                                     f"{b[k]!r}")
    log(f"[whisper-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small HF-named npz checkpoint and a 5-s WAV, on the card "
        f"({cli_s:.2f} s with its start-up): language {got['language']}, "
        f"{len(got['segments'])} segments, equal to "
        f"mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Voxtral Realtime (phases 15-16, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_voxtral_realtime.py:17-28 with a 2-layer encoder: its window of
# 64 conv frames ends inside a 512-frame mel bucket's padding for inputs
# under about 3.8 s, where the JAX package's bucketed encoder gives NaN
VOXTRAL_SMALL = dict(
    model_type="voxtral_realtime",
    encoder_args=dict(dim=16, n_layers=2, n_heads=2, head_dim=8,
                      hidden_dim=32, n_kv_heads=2, sliding_window=64,
                      downsample_factor=4,
                      audio_encoding_args=dict(num_mel_bins=16)),
    decoder=dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=8,
                 hidden_dim=32, vocab_size=64, ada_rms_norm_t_cond_dim=4),
    transcription_delay_ms=160, n_left_pad_tokens=2)
# CUDA against the CPU at f32: adapter frames, relative error max|a-b|/max|b|
VOXTRAL_REL = 1e-4
# the JAX lane's workload (bench.py:708-747): 30 s of randn * 0.1 at seed
# 0 after a 6-s warm drive, 1-s feeds each followed by step(16), then
# close() and step(32) until done; then an offline generate() of 20 s, a
# length in the band where the JAX package's 32-layer bucketed encoder
# gives NaN
VOXTRAL_SECONDS, VOXTRAL_WARM_SECONDS, VOXTRAL_OFFLINE_SECONDS = 30, 6, 20
# the published consolidated checkpoint's prefixes (voxtral_realtime.py:609)
VOXTRAL_ENC = "mm_streams_embeddings.embedding_module.whisper_encoder"
VOXTRAL_AD = "mm_streams_embeddings.embedding_module"


def voxtral_consolidated_names(flat: dict) -> dict:
    """A flat tree under the port's names (the JAX tree's) -> mistral's
    consolidated-checkpoint names, which `_remap_consolidated` maps back."""
    out = {}
    for key, v in flat.items():
        part, rest = key.split(".", 1)
        rest = rest.replace("feed_forward_w", "feed_forward.w")
        if key == "decoder.tok_embeddings.weight":
            key = f"{VOXTRAL_AD}.tok_embeddings.weight"
        elif key == "decoder.norm.weight":
            key = "norm.weight"
        elif part == "decoder":         # layers.N...
            key = rest.replace(".ada_down.", ".0.").replace(".ada_up.", ".2.")
        elif rest.startswith("conv_layers_"):       # conv_layers_I_conv.conv.p
            key = f"{VOXTRAL_ENC}.conv_layers.{rest[12]}.{rest[19:]}"
        elif rest.startswith("transformer_layers."):
            key = f"{VOXTRAL_ENC}.transformer.layers.{rest[19:]}"
        elif rest.startswith("transformer_norm."):
            key = f"{VOXTRAL_ENC}.transformer.norm.{rest[17:]}"
        else:                           # audio_language_projection_I.p
            key = f"{VOXTRAL_AD}.audio_language_projection.{rest[26:]}"
        out[key] = v
    return out


def write_tekken(path: Path, n_special: int, n_vocab: int) -> None:
    """A tekken.json (the format voxtral_realtime.py:155-176 reads): ids
    below `n_special` are special, id i above them decodes to f"{i} "."""
    import base64

    vocab = [{"token_bytes": base64.b64encode(f"{i} ".encode()).decode()}
             for i in range(n_special, n_vocab)]
    path.write_text(json.dumps({
        "vocab": vocab, "config": {"default_num_special_tokens": n_special},
        "special_tokens": [{"rank": 1}, {"rank": 2}, {"rank": 32}]}))


def write_voxtral_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json (audio_encoding_args
    nested in encoder_args, as published), the weights under the
    consolidated names in one npz with the convs in torch's (O, I, k)
    layout, and a tekken.json of 3 special ids (random weights favour low
    ids)."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.asdict(model.config)
    cfg["encoder_args"]["audio_encoding_args"] = cfg.pop(
        "audio_encoding_args")
    del cfg["model_path"]
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "consolidated.npz", **voxtral_consolidated_names(
        {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}))
    (path / "config.json").write_text(json.dumps(cfg))
    write_tekken(path / "tekken.json", 3, model.config.decoder.vocab_size)


def _voxtral_tokens(model, audio) -> list:
    """The offline decode's kept tokens."""
    return [t for new, _, _ in model._run(audio, 4096, None) for t in new]


def phase_voxtral_reference(tmp: Path) -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the offline adapter frames (1 s, whose bucket padding lies past
    the window, and 4.5 s), the greedy offline tokens, and on the card the
    session's tokens and text from uneven feeds against the offline ones;
    everything finite."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig, TekkenTokenizer, voxtral_realtime as vr)

    cfg = ModelConfig.from_dict(VOXTRAL_SMALL)
    cpu = Model(cfg, device="cpu").init_params(seed=0)
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    write_tekken(tmp / "tekken.json", 3, 64)
    for m in (cpu, gpu):
        m._tokenizer = TekkenTokenizer(str(tmp / "tekken.json"))
    n_delay = vr._num_delay_tokens(cfg.transcription_delay_ms)
    errs = []
    for seconds in (1.0, 4.5):
        audio = (np.random.RandomState(0).randn(int(16000 * seconds))
                 ).astype(np.float32)
        padded = vr._pad_audio_streaming(audio, cfg.n_left_pad_tokens,
                                         n_delay + 11)
        (want, n), (got, n_g) = cpu.encode(padded), gpu.encode(padded)
        if n_g != n or not torch.isfinite(got).all():
            raise AssertionError(f"Voxtral {seconds} s: adapter frames not "
                                 f"finite or counts differ ({n_g}, {n})")
        errs.append(rel_err(got.cpu(), want))
        if not errs[-1] <= VOXTRAL_REL:
            raise AssertionError(f"Voxtral adapter CUDA vs CPU "
                                 f"{errs[-1]:.3e} > {VOXTRAL_REL}")
        toks = _voxtral_tokens(gpu, audio)
        if toks != _voxtral_tokens(cpu, audio) or not toks:
            raise AssertionError(f"Voxtral {seconds} s: offline tokens "
                                 f"differ between CUDA and the CPU, or none")
        sess = gpu.create_streaming_session()
        for i in range(0, len(audio), 3001):
            sess.feed(audio[i:i + 3001])
        sess.close()
        events = []
        while not sess.done:
            events += sess.step(max_decode_tokens=8)
        s_text = "".join(e.text for e in events if e.kind == "delta")
        text = gpu.generate(audio).text
        if events[-1].kind != "final" or not text:
            raise AssertionError("Voxtral session: no final event, or no "
                                 "text")
        if sess.generated != toks or s_text.strip() != text:
            raise AssertionError(f"Voxtral {seconds} s: session tokens or "
                                 f"text differ from offline on the card")
    log(f"[voxtral-ref] small config (2-layer encoder, window 64) f32: "
        f"adapter frames CUDA vs CPU {max(errs):.2e} relative (tol "
        f"{VOXTRAL_REL}), finite at 1 s (bucket padding past the window) "
        f"and 4.5 s; offline tokens equal ({len(toks)} at 4.5 s); the "
        f"session's tokens and text from uneven feeds equal offline")


def voxtral_bytes(model) -> tuple:
    """(encoder step, decode token) bytes of bf16 weights read: the
    encoder's transformer layers per ENC_CHUNK step; the decoder's layers
    and the tied embeddings (the logits) per token."""
    enc = sum(p.numel() for p in model.encoder.transformer_layers.parameters())
    dec = sum(p.numel() for p in model.decoder.parameters())
    return 2 * enc, 2 * dec


def build_voxtral_full():
    """Voxtral-Mini-3B-Realtime (ModelConfig() defaults) on the card, its
    4.43 B parameters drawn there in f32 from seed 0."""
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    return Model(ModelConfig(), device="cuda").init_params(seed=0,
                                                          on_device=True)


def phase_voxtral_full(card: str, tmp: Path) -> dict:
    """Voxtral-Mini-3B-Realtime at full width (ModelConfig() defaults, as
    bench.py:701), 4.43 B parameters drawn on the card in f32 from seed 0:
    one ENC_CHUNK encoder step in bf16 against f32, then in bf16 the JAX
    lane's workload and an offline generate() of 20 s."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        TekkenTokenizer, voxtral_realtime as vr)
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime.streaming import (
        ENC_CHUNK, RING_CAP, encoder_stream_step)

    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    model = build_voxtral_full()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[voxtral] Voxtral-Mini-3B-Realtime dims (encoder 32 x d1280, "
        f"decoder 26 x d3072 GQA 32/8, vocabulary 131,072 tied): "
        f"{n_params / 1e9:.3f} B parameters drawn on the card in f32 from "
        f"seed 0 ({time.perf_counter() - t0:.2f} s)")
    e = model.config.encoder_args
    audio = (np.random.RandomState(0).randn(VOXTRAL_SECONDS * 16000) * 0.1
             ).astype(np.float32)

    # one ENC_CHUNK encoder step, bf16 against f32, on the conv stem's
    # frames of the workload's first 2 s
    def enc_step(x):
        caches = KVCache.init(1, RING_CAP, e.n_heads, e.head_dim,
                              dtype=torch.float32, device=x.device,
                              n_layers=e.n_layers)
        return encoder_stream_step(model, x, caches, 0, ENC_CHUNK)

    with torch.inference_mode():
        mel = vr.voxtral_mel(torch.from_numpy(audio[:32000]).to(model.device),
                             model.config.audio_encoding_args)
        x = vr.conv_stem(model.encoder, mel[None])[:, :ENC_CHUNK]
        ref = enc_step(x).float()
        model.astype(torch.bfloat16)
        torch.cuda.empty_cache()
        got = enc_step(x.to(torch.bfloat16)).float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not rel < WHISPER_BF16_REL:
        raise AssertionError(f"Voxtral bf16 encoder step vs f32: {rel:.3e} "
                             f">= {WHISPER_BF16_REL}")
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        enc_ms = _time_ms(lambda: enc_step(xb), 10)
    enc_b, dec_b = voxtral_bytes(model)
    ring_b = 2 * e.n_layers * RING_CAP * e.n_heads * e.head_dim * 4
    log(f"[voxtral] bf16 ENC_CHUNK encoder step vs f32: relative Frobenius "
        f"{rel:.3e} (limit {WHISPER_BF16_REL}); {enc_ms:.3f} ms a step "
        f"(CUDA events, median of 10), bound {(enc_b + ring_b) / HBM_BPS * 1e3:.3f}"
        f" ms (weights and f32 ring caches read once) ({card})")

    write_tekken(tmp / "tekken.json", 1000, model.config.decoder.vocab_size)
    model._tokenizer = TekkenTokenizer(str(tmp / "tekken.json"))

    def drive(seconds: int):
        sess = model.create_streaming_session(max_tokens=4096)
        lat, events = [], []
        for i in range(seconds):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sess.feed(audio[i * 16000:(i + 1) * 16000])
            events += sess.step(max_decode_tokens=16)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        sess.close()
        for _ in range(500):
            events += sess.step(max_decode_tokens=32)
            if sess.done:
                break
        torch.cuda.synchronize()
        eot = time.perf_counter() - t1
        if not events or events[-1].kind != "final":
            raise AssertionError(f"Voxtral session: no final event "
                                 f"({[ev.kind for ev in events][-3:]})")
        return lat, eot, sess

    t1 = time.perf_counter()
    drive(VOXTRAL_WARM_SECONDS)
    warm_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    lat, eot, sess = drive(VOXTRAL_SECONDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ls = sorted(lat)
    p50, p95 = ls[len(ls) // 2], ls[min(len(ls) - 1, int(len(ls) * 0.95))]
    xrt = VOXTRAL_SECONDS / (sum(lat) + eot)
    n_tok = len(sess.generated)
    log(f"[voxtral] realtime_stt lane: {VOXTRAL_SECONDS} x 1-s feeds, each "
        f"then step(16), after a {VOXTRAL_WARM_SECONDS}-s warm drive "
        f"({warm_s:.2f} s): step p50 {p50 * 1e3:.2f} ms, p95 "
        f"{p95 * 1e3:.2f} ms, max {ls[-1] * 1e3:.2f} ms; EOT to final "
        f"{eot * 1e3:.2f} ms; xRT {xrt:.3f}; {n_tok} tokens decoded "
        f"({(sum(lat) + eot) * 1e3 / n_tok:.2f} ms a token, the encoder "
        f"included); realtime (p95 < 1 s): {p95 < 1.0}; peak device memory "
        f"{peak_gb:.2f} GB, {peak_gb - base / 1e9:.2f} GB of it this phase's "
        f"(model and session); weights read a token {dec_b / 1e9:.3f} GB, "
        f"bound {dec_b / HBM_BPS * 1e3:.3f} ms ({card})")

    # offline generate() of 20 s: a length where JAX's encoder gives NaN
    off = audio[:VOXTRAL_OFFLINE_SECONDS * 16000]
    n_delay = vr._num_delay_tokens(model.config.transcription_delay_ms)
    adapter, n_audio = model.encode(vr._pad_audio_streaming(
        off, model.config.n_left_pad_tokens, n_delay + 11))
    if not torch.isfinite(adapter).all():
        raise AssertionError("Voxtral offline adapter frames not finite")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = model.generate(off)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    log(f"[voxtral] offline generate() of {VOXTRAL_OFFLINE_SECONDS} s: "
        f"{n_audio} adapter frames, all finite; {res.generation_tokens} "
        f"tokens in {wall:.3f} s, xRT {VOXTRAL_OFFLINE_SECONDS / wall:.2f} "
        f"({card})")
    del model, sess
    torch.cuda.empty_cache()
    return {"p95": p95, "xrt": xrt}


def phase_voxtral_cli(tmp: Path) -> None:
    """A small Voxtral checkpoint (consolidated names, npz, tekken.json)
    and a 3-s WAV: the STT CLI in a subprocess on the card, its JSON
    against load_model(...).generate(...) here."""
    import numpy as np

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        Model, ModelConfig)

    ckpt, wav, out = tmp / "voxtral-small", tmp / "speech.wav", tmp / "out"
    write_voxtral_checkpoint(Model(ModelConfig.from_dict(VOXTRAL_SMALL),
                                   device="cpu").init_params(seed=0), ckpt)
    audio_io.write(wav, (np.random.RandomState(6).randn(16000 * 3) * 0.1
                         ).astype(np.float32), 16000)
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_audio_tpu_torch.stt.generate", "--model",
         str(ckpt), "--audio", str(wav), "--format", "json", "--output-path",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"STT CLI on Voxtral failed: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads((out / "transcription.json").read_text())
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda" or not isinstance(model, Model):
        raise AssertionError("load_model did not load Voxtral on the card")
    want = model.generate(str(wav))
    if (got["text"], got["language"], got["segments"]) != (
            want.text, want.language, json.loads(json.dumps(want.segments))):
        raise AssertionError("STT CLI on Voxtral differs from load_model")
    if not want.text:
        raise AssertionError("Voxtral CLI check: empty transcript")
    log(f"[voxtral-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small consolidated-name npz checkpoint with tekken.json "
        f"and a 3-s WAV, on the card: {len(want.text.split())} words, equal "
        f"to mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Cohere ASR (phases 17-18, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_cohere_asr.py:21-36: 2 conformer layers at d32, a 2-layer
# decoder at d24 (so `encoder_proj` runs), 2-s clips and batches of 2
COHERE_SMALL = dict(
    model_type="cohere_asr", vocab_size=64,
    encoder=dict(feat_in=20, n_layers=2, d_model=32, n_heads=4,
                 ff_expansion_factor=2, subsampling_factor=8,
                 subsampling_conv_channels=8, conv_kernel_size=9),
    transf_decoder=dict(config_dict=dict(
        hidden_size=24, inner_size=48, num_attention_heads=4, num_layers=2,
        max_sequence_length=128)),
    head=dict(hidden_size=24, num_classes=64, log_softmax=True),
    preprocessor=dict(features=20, n_fft=128, window_size=0.008,
                      window_stride=0.004),
    max_audio_clip_s=2.0, overlap_chunk_second=0.5,
    min_energy_window_samples=160, batch_size=2)
# the cohere_asr_10min lane's dims (bench.py:831-842): FastConformer 48 x
# d1280, 8 heads, FF x4, subsampling 8 with 256 channels, kernel 9; decoder
# 8 x d1024, 8 heads, inner 4096, max length 1024; vocabulary 16384
COHERE_FULL = dict(
    model_type="cohere_asr", vocab_size=16384,
    encoder=dict(feat_in=128, n_layers=48, d_model=1280, n_heads=8,
                 ff_expansion_factor=4, subsampling_factor=8,
                 subsampling_conv_channels=256, conv_kernel_size=9),
    transf_decoder=dict(config_dict=dict(
        hidden_size=1024, inner_size=4096, num_attention_heads=8,
        num_layers=8, max_sequence_length=1024)),
    head=dict(hidden_size=1024, num_classes=16384), batch_size=8)
# the lane's prompt pieces (bench.py:845-849); the ids after them decode to
# "▁<id>"
COHERE_SPECIALS = ("<|startofcontext|>", "<|startoftranscript|>",
                   "<|emo:undefined|>", "<|en|>", "<|pnc|>", "<|nopnc|>",
                   "<|noitn|>", "<|notimestamp|>", "<|nodiarize|>",
                   "<|endoftext|>")
# the lane's workload (bench.py:856-869): 600 s of randn * 0.1 at seed 0,
# language "en", max_tokens 150, cold then warm best of 3
COHERE_SECONDS, COHERE_MAX_TOKENS, COHERE_SEGMENTS = 600, 150, 19
# CUDA against the CPU at f32: encoder rows, max|a-b| / max|b|
COHERE_REL = 1e-4
# NeMo's subsampling indices (torch.nn.Sequential, ReLUs between) of the
# JAX tree's named layers
COHERE_PRE_ENCODE = {"00_conv": 0, "01_dw": 2, "02_pw": 3, "03_dw": 5,
                     "04_pw": 6}
# the port's names (the JAX tree's) outside the encoder -> NeMo's, which
# `sanitize` maps back
COHERE_NEMO_NAMES = (
    ("decoder.blocks.", "transf_decoder._decoder.layers."),
    ("decoder.final_norm.", "transf_decoder._decoder.final_layer_norm."),
    ("decoder.embedding_layer_norm.", "transf_decoder._embedding.layer_norm."),
    ("decoder.embedding.", "transf_decoder._embedding.token_embedding."),
    (".self_attn_norm.", ".layer_norm_1."),
    (".cross_attn_norm.", ".layer_norm_2."), (".ff_norm.", ".layer_norm_3."),
    (".self_attn.", ".first_sub_layer."), (".cross_attn.", ".second_sub_layer."),
    (".q_proj.", ".query_net."), (".k_proj.", ".key_net."),
    (".v_proj.", ".value_net."), (".out_proj.", ".out_projection."),
    (".ff1.", ".third_sub_layer.dense_in."),
    (".ff2.", ".third_sub_layer.dense_out."),
    ("decoder.output_proj.", "log_softmax.mlp.layer0."),
    ("encoder_proj.", "encoder_decoder_proj."))


def cohere_pieces(vocab: int) -> list:
    """A tokens.json piece list: COHERE_SPECIALS, then "▁<id>"."""
    return list(COHERE_SPECIALS) + [f"▁{i}" for i in
                                    range(len(COHERE_SPECIALS), vocab)]


def cohere_nemo_names(state: dict) -> dict:
    """A flat tree under the port's names -> NeMo's checkpoint names."""
    out = {}
    pre = "encoder.pre_encode.layers."
    for k, v in state.items():
        if k.startswith(pre):
            name, rest = k[len(pre):].split(".", 1)
            k = f"encoder.pre_encode.conv.{COHERE_PRE_ENCODE[name]}.{rest}"
        elif not k.startswith("encoder."):
            for a, b in COHERE_NEMO_NAMES:
                k = k.replace(a, b)
        out[k] = v
    return out


def write_cohere_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json, the weights under
    NeMo's names in torch's conv layouts in one npz (with a
    num_batches_tracked and the preprocessor's filterbank and window, as
    NeMo saves them), and a tokens.json piece list."""
    import dataclasses

    import numpy as np

    from mlx_audio_tpu_torch.dsp import hanning

    state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}
    state = cohere_nemo_names(state)
    state["encoder.layers.0.conv.batch_norm.num_batches_tracked"] = np.zeros(
        (), np.int64)
    state["preprocessor.featurizer.fb"] = model._fb()[None]
    pp = model.config.preprocessor
    state["preprocessor.featurizer.window"] = hanning(pp.win_length).numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **state)
    (path / "config.json").write_text(json.dumps(
        dataclasses.asdict(model.config)))
    (path / "tokens.json").write_text(json.dumps(
        cohere_pieces(model.config.head.num_classes)))


def _cohere_small(device: str, like=None):
    """The small Cohere model on `device`: seeded (seed 0, drawn on the
    CPU) or with the parameters of `like`; a piece-list tokenizer."""
    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    model = Model(ModelConfig.from_dict(COHERE_SMALL), device=device)
    if like is None:
        model.init_params(seed=0)
    else:
        model.load_state_dict(like.state_dict())
    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(64))
    return model


def phase_cohere_reference() -> None:
    """The small config at f32 from one seeded weight set, CUDA against the
    CPU: the encoder rows of a ragged batch with a row of length 0, and
    greedy generate() on 5 s of seeded noise (3 segments, a partial last
    batch): texts and segments equal, everything finite."""
    import numpy as np
    import torch

    cpu = _cohere_small("cpu")
    gpu = _cohere_small("cuda", like=cpu)
    audio = (np.random.RandomState(0).randn(16000 * 5) * 0.5).astype(
        np.float32)
    segs, _ = cpu._prepare_segments([audio])
    feats, lens = cpu.features(segs + [audio[:0]])
    want, _ = cpu.encode(feats, lens)
    got, _ = gpu.encode(feats.cuda(), lens.cuda())
    err = rel_err(got.cpu(), want)
    if not torch.isfinite(got).all() or not err <= COHERE_REL:
        raise AssertionError(f"Cohere encoder CUDA vs CPU {err:.3e} > "
                             f"{COHERE_REL}, or rows not finite")
    kw = dict(language="en", max_tokens=24)
    want, got = cpu.generate(audio, **kw), gpu.generate(audio, **kw)
    if (got.text, got.segments) != (want.text, want.segments) or not got.text:
        raise AssertionError("small Cohere generate: CUDA differs from the "
                             "CPU, or no text")
    if len(got.segments) < 3 or gpu.last_run["batches"] < 2:
        raise AssertionError(f"small Cohere: {gpu.last_run}, wanted 3+ "
                             f"segments in 2+ batches")
    log(f"[cohere-ref] small config f32, 5 s: encoder rows CUDA vs CPU "
        f"{err:.2e} relative (tol {COHERE_REL}) over {len(segs)} segments "
        f"and a row of length 0, all finite; {len(got.segments)} segments "
        f"in {gpu.last_run['batches']} batches, {got.generation_tokens} "
        f"tokens, {gpu.last_run['decode_steps']} decode steps: texts and "
        f"segments equal")


def cohere_encoder_flops(cfg: dict, rows: int, frames: int) -> float:
    """Operations (2 per multiply-add) of `rows` rows of `frames` mel frames
    through the encoder: the subsampling convs and `out`, then per layer
    the two FFs, q/k/v/out, linear_pos over the 2T-1 positions, the three
    attention products and the conv module; then `encoder_proj` if any."""
    e = cfg["encoder"]
    d, ch, ff = e["d_model"], e["subsampling_conv_channels"], \
        e["d_model"] * e["ff_expansion_factor"]
    t, f = frames, e["feat_in"]
    sub = 0
    for stage in range(3):
        t, f = (t - 1) // 2 + 1, (f - 1) // 2 + 1
        sub += 2 * t * f * ch * 9 + (2 * t * f * ch * ch if stage else 0)
    sub += 2 * t * f * ch * d
    per_frame = (2 * 2 * 2 * d * ff + 4 * 2 * d * d + 2 * d * 2 * d
                 + 2 * d * e["conv_kernel_size"] + 2 * d * d
                 + 2 * (t + (2 * t - 1) + t) * d)
    layer = rows * t * per_frame + 2 * (2 * t - 1) * d * d
    hidden = cfg["transf_decoder"]["config_dict"]["hidden_size"]
    proj = 2 * rows * t * d * hidden if hidden != d else 0
    return rows * sub + e["n_layers"] * layer + proj


def phase_cohere_full(card: str) -> dict:
    """Cohere ASR at the cohere_asr_10min lane's dims (2.05 B parameters
    drawn on the card in f32 from seed 0, then cast in place to bf16): the
    bf16 encoder against f32 on one 8-row batch of the 3,584-frame bucket,
    the encoder's time a batch, then the lane's 600-s file cold and warm
    (best of 3)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.stt.models.canary import CanaryTokenizer
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model, ModelConfig

    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    model = Model(ModelConfig.from_dict(COHERE_FULL), device="cuda")
    model.init_params(seed=0, on_device=True)
    torch.cuda.synchronize()
    log(f"[cohere] cohere_asr_10min dims (FastConformer 48 x d1280, decoder "
        f"8 x d1024, vocabulary 16,384): {model.num_params() / 1e9:.3f} B "
        f"parameters drawn on the card in f32 from seed 0 "
        f"({time.perf_counter() - t0:.2f} s)")
    audio = (np.random.RandomState(0).randn(COHERE_SECONDS * 16000) * 0.1
             ).astype(np.float32)

    # the 8 longest segments, one batch of the 3,584-frame bucket
    segs, _ = model._prepare_segments([audio])
    batch = sorted(segs, key=len, reverse=True)[:8]
    feats, lens = model.features(batch)
    if feats.shape[:2] != (8, 3584):
        raise AssertionError(f"Cohere batch {tuple(feats.shape)}: not 8 rows "
                             f"of the 3,584-frame bucket")
    ref = model.encode(feats, lens)[0].float()
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    got = model.encode(feats, lens)[0].float()
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    if not torch.isfinite(got).all() or not rel < WHISPER_BF16_REL:
        raise AssertionError(f"Cohere bf16 encoder vs f32: {rel:.3e} >= "
                             f"{WHISPER_BF16_REL}, or not finite")
    del ref, got
    torch.cuda.empty_cache()
    enc_ms = _time_ms(lambda: model.encode(feats, lens), 5)
    flops = cohere_encoder_flops(COHERE_FULL, 8, 3584)
    log(f"[cohere] bf16 encoder vs f32 on one 8-row batch of the 3,584-frame "
        f"bucket: relative Frobenius {rel:.3e} (limit {WHISPER_BF16_REL}); "
        f"{enc_ms:.3f} ms a batch (CUDA events, median of 5), "
        f"{flops / 1e12:.3f} TFLOP: {flops / enc_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / PEAK_BF16 * 1e3 / enc_ms:.1f}% of 989 TFLOP/s "
        f"({card})")

    model._tokenizer = CanaryTokenizer(piece_list=cohere_pieces(
        model.config.head.num_classes))
    t1 = time.perf_counter()
    for s in segs:
        model._log_mel(s)
    mel_s = time.perf_counter() - t1
    encode, finite = model.encode, []

    def checked_encode(f, n):              # every batch's rows finite
        enc, mask = encode(f, n)
        finite.append(bool(torch.isfinite(enc).all()))
        return enc, mask

    kw = dict(language="en", max_tokens=COHERE_MAX_TOKENS)
    walls, outs = [], []
    for i in range(4):
        model.encode = checked_encode if i == 0 else encode
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs.append(model.generate(audio, **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    del model.encode
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run, res = dict(model.last_run), outs[-1]
    if len(res.segments) != COHERE_SEGMENTS or not all(finite) \
            or len(finite) != run["batches"]:
        raise AssertionError(f"Cohere lane: {len(res.segments)} segments "
                             f"(want {COHERE_SEGMENTS}), encoder rows finite "
                             f"{finite}")
    if any(o.text != res.text for o in outs) or not res.text:
        raise AssertionError("Cohere lane: the runs' texts differ, or none")
    warm = min(walls[1:])
    for label, wall in (("cold", walls[0]), ("warm (best of 3)", warm)):
        enc_s = run["batches"] * enc_ms / 1e3
        log(f"[cohere] {label}: {COHERE_SECONDS} s in {wall:.3f} s, xRT "
            f"{COHERE_SECONDS / wall:.2f}; {len(res.segments)} segments in "
            f"{run['batches']} batches, {res.generation_tokens} tokens, "
            f"{run['decode_steps']} decode steps, "
            f"{(wall - mel_s - enc_s) * 1e3 / run['decode_steps']:.3f} ms a "
            f"step (wall less the host mel's {mel_s:.3f} s and the batches' "
            f"encoder time at 8 rows, {enc_s:.3f} s) ({card})")
    log(f"[cohere] warm walls {[round(w, 3) for w in walls[1:]]} s; peak "
        f"device memory {peak_gb:.2f} GB in the warm runs, "
        f"{peak_gb - base / 1e9:.2f} GB of it this phase's (bf16 weights "
        f"{2 * model.num_params() / 1e9:.2f} GB); every batch's encoder rows "
        f"finite ({card})")
    del model
    torch.cuda.empty_cache()
    return {"warm": warm, "enc_ms": enc_ms, "rel": rel}


def phase_cohere_cli(tmp: Path) -> None:
    """A small Cohere checkpoint (NeMo names, torch conv layouts, npz with
    the preprocessor buffers, tokens.json) and a 5-s WAV: the STT CLI in a
    subprocess on the card, its JSON against load_model(...).generate(...)
    here."""
    import numpy as np

    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model

    ckpt, wav, out = tmp / "cohere-small", tmp / "speech.wav", tmp / "out"
    write_cohere_checkpoint(_cohere_small("cpu"), ckpt)
    audio_io.write(wav, (np.random.RandomState(7).randn(16000 * 5) * 0.5
                         ).astype(np.float32), 16000)
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_audio_tpu_torch.stt.generate", "--model",
         str(ckpt), "--audio", str(wav), "--format", "json", "--output-path",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"STT CLI on Cohere failed: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads((out / "transcription.json").read_text())
    model = mlx_audio_tpu_torch.load_model(ckpt)
    if model.device.type != "cuda" or not isinstance(model, Model):
        raise AssertionError("load_model did not load Cohere on the card")
    want = model.generate(str(wav))
    if (got["text"], got["language"], got["segments"]) != (
            want.text, want.language, json.loads(json.dumps(want.segments))):
        raise AssertionError("STT CLI on Cohere differs from load_model")
    if not want.text or len(want.segments) < 3:
        raise AssertionError("Cohere CLI check: empty transcript or fewer "
                             "than 3 segments")
    log(f"[cohere-cli] python -m mlx_audio_tpu_torch.stt.generate --format "
        f"json on a small NeMo-name npz checkpoint with tokens.json and a "
        f"5-s WAV, on the card: {len(want.segments)} segments, "
        f"{len(want.text.split())} words, equal to "
        f"mlx_audio_tpu_torch.load_model(...).generate(...) in process")


# ---------------------------------------------------------------------------
# Higgs Audio v2 (phases 19-21, and the checkpoint of phase 14)
# ---------------------------------------------------------------------------

# tests/test_higgs_audio_v2.py:20-32: 2 dual-FFN layers at d32, GQA 4/2,
# llama3 RoPE scaling, 4 codebooks of 64
HIGGS_SMALL = dict(
    text_config=dict(hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     intermediate_size=64, vocab_size=300,
                     rope_theta=500000.0,
                     rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0,
                                   "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 8192}),
    audio_num_codebooks=4, audio_codebook_size=64, audio_stream_bos_id=64,
    audio_stream_eos_id=65)
# a codec with the small model's 4 books of 64 (hop 6)
HIGGS_CODEC_SMALL = dict(
    codebook_size=64, codebook_dim=4, dac_num_codebooks=4,
    dac_encoder_ratios=[2, 3], dac_encoder_hidden=4, dac_decoder_hidden=16,
    latent_dim=24, fusion_dim=8, downsample_factor=20)
# the small model's EOS rows of audio_lm_head scaled by this make greedy
# decoding sample EOS at frame 4 (seed 0), after the delay ramp-in, and run
# the ramp-out
HIGGS_EOS_SCALE = 2.5
HIGGS_TEXT = "hello world, this is a check"
# small config at f32, CUDA vs CPU: summation order only
HIGGS_REL = 1e-4
# W8A8 on the card: the int32 product is exact, the two f32 scale products
# round alike
I8_REL = 1e-5
I8_ROWS = (1, 17, 512)
# the linear shapes (out, in) of a layer at ModelConfig() dims: q and o; k
# and v; gate and up; down. A decode frame runs 28 x (2, 2, 2, 1) of them
HIGGS_SHAPES = ((3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192))
HIGGS_FRAME_LINEARS = (2, 2, 2, 1)
# the higgs_v2_3b_* lanes (bench.py:428-464): a 480-token prompt of
# randn * 0.02 embeds (seed 0) in the 512 bucket, a 1,024-column cache,
# temperature 0.7, top_p 0.95, RAS 7/2; 250 frames (10 s at 25 frames a
# second) in 16-frame chunks, then the first 242 delayed frames mod 1,024
# through the codec at CodecConfig() dims in bf16
HIGGS_PLEN, HIGGS_FRAMES, HIGGS_FPS, HIGGS_CODEC_FRAMES = 480, 250, 25, 242
HIGGS_BF16_REL = 2e-2
# W8A8 against bf16 audio logits on the prefill's last row (per-channel
# int8 weights and per-token int8 activations, 28 layers deep)
HIGGS_I8_LOGITS_REL = 1e-1
# phase 21: one request of 32 frames on the affine-q8 backbone, with a
# voice-clone-like mask (rows 100-299 audio), so the prefill runs both paths
HIGGS_K2_FRAMES = 32
HIGGS_AUDIO_ROWS = (100, 300)


class HiggsTok:
    """A stand-in text tokenizer (tests/test_higgs_audio_v2.py's FakeTok):
    the HF tokenizer is not in the repository."""

    def encode(self, text, add_special_tokens=False):
        return [ord(c) % 290 for c in text][:80]


def _higgs_small(device: str, eos_scale=None):
    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model

    import torch

    model = Model(HIGGS_SMALL, device=device).init_params(seed=0)
    model.tokenizer = HiggsTok()
    if eos_scale is not None:
        cfg = model.config
        rows = (torch.arange(cfg.audio_num_codebooks, device=device)
                * cfg.stride + cfg.audio_stream_eos_id)
        model.audio_decoder_proj.audio_lm_head.weight[rows] *= eos_scale
    return model


def _higgs_codec_small(device: str):
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model

    return Model(HIGGS_CODEC_SMALL, device=device).init_params(seed=1)


def _frames(gen):
    import numpy as np

    return np.concatenate(list(gen), axis=0)


def phase_higgs_reference() -> None:
    """Phase 19: the small configs at f32 from one seeded weight set, CUDA
    against the CPU: the cached prefill's hidden states, greedy frames with
    EOS reached and its ramp-out run, a generate() through a bound small
    codec; then qmatmul_i8 (torch._int_mm) against its plain version at the
    four Higgs shapes."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.ops.quant import (int_mm, int_mm_reference,
                                               qmatmul_i8,
                                               qmatmul_i8_reference)
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    t0 = time.perf_counter()
    models = [_higgs_small(d, HIGGS_EOS_SCALE) for d in ("cpu", "cuda")]
    cfg = models[0].config
    t = cfg.text
    rs = np.random.RandomState(0)
    emb = (rs.randn(1, 64, t.hidden_size) * 0.5).astype(np.float32)
    mask = np.zeros((1, 64), bool)
    mask[0, 10:40] = True
    plen, cache_len = 60, 128
    hidden = []
    for m in models:
        dev = m.device
        caches = KVCache.init(1, cache_len, t.num_key_value_heads,
                              t.head_dim, torch.float32, dev,
                              n_layers=t.num_hidden_layers)
        pad = torch.zeros(cache_len, device=dev).masked_fill(
            torch.arange(cache_len, device=dev) >= plen,
            float("-inf"))[None, None, None, :]
        h, _ = higgs_forward(m, torch.from_numpy(emb).to(dev),
                             torch.from_numpy(mask).to(dev), caches, 0,
                             pad_mask=pad)
        hidden.append(h[:, :plen].cpu())
    rel = rel_err(hidden[1], hidden[0])
    if not (torch.isfinite(hidden[1]).all() and rel <= HIGGS_REL):
        raise AssertionError(f"Higgs prefill hidden CUDA vs CPU rel {rel:.3e}")
    frames = [_frames(m.generate_frames(*m.build_prompt(HIGGS_TEXT),
                                        max_new_frames=64, temperature=0.0))
              for m in models]
    eos, k = cfg.audio_stream_eos_id, cfg.audio_num_codebooks
    if frames[0].shape != frames[1].shape or (frames[0] != frames[1]).any():
        raise AssertionError("Higgs greedy frames differ CUDA vs CPU")
    first_eos = int(np.argmax((frames[1] == eos).any(axis=1)))
    if not ((frames[1][-1] == eos).all() and len(frames[1]) < 65
            and first_eos >= k):
        raise AssertionError(f"Higgs frames: EOS at {first_eos} of "
                             f"{len(frames[1])}, no ramp-out seen")
    plain = [_higgs_small(d) for d in ("cpu", "cuda")]
    for m, d in zip(plain, ("cpu", "cuda")):
        m.codec = _higgs_codec_small(d)
    res = [next(m.generate(HIGGS_TEXT, temperature=0.0, max_new_frames=48))
           for m in plain]
    a_rel = rel_err(torch.from_numpy(res[1].audio),
                    torch.from_numpy(res[0].audio))
    if not (res[0].samples == res[1].samples > 0 and a_rel <= HIGGS_REL
            and np.isfinite(res[1].audio).all()):
        raise AssertionError(f"Higgs generate() audio CUDA vs CPU: "
                             f"{res[1].samples} vs {res[0].samples} samples, "
                             f"rel {a_rel:.3e}")
    log(f"[higgs small] f32 CUDA vs CPU: prefill hidden rel {rel:.3e} (tol "
        f"{HIGGS_REL:g}); greedy frames equal ({len(frames[1])}, EOS at "
        f"frame {first_eos}, ramp-out run); generate() through a small codec "
        f"{res[1].samples} samples, rel {a_rel:.3e}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for n, kin in HIGGS_SHAPES:
        w = torch.randint(-127, 128, (n, kin), dtype=torch.int8, device=dev,
                          generator=g)
        scale = torch.rand(n, device=dev, generator=g) * 1e-3
        for m in I8_ROWS:
            xq = torch.randint(-127, 128, (m, kin), dtype=torch.int8,
                               device=dev, generator=g)
            if not torch.equal(int_mm(xq, w), int_mm_reference(xq, w)):
                raise AssertionError(f"_int_mm ({n},{kin}) M={m}: int32 "
                                     f"accumulators differ")
            x = torch.randn(m, kin, device=dev, generator=g)
            r = rel_err(qmatmul_i8(x, w, scale),
                        qmatmul_i8_reference(x, w, scale))
            worst = max(worst, r)
            if not r <= I8_REL:
                raise AssertionError(f"qmatmul_i8 ({n},{kin}) M={m}: rel "
                                     f"{r:.3e}")
    log(f"[higgs w8a8] torch._int_mm at {len(HIGGS_SHAPES)} shapes x M in "
        f"{I8_ROWS}: int32 accumulators equal to the exact plain product; "
        f"qmatmul_i8 rel <= {worst:.3e} (tol {I8_REL:g}); phase 19 in "
        f"{time.perf_counter() - t0:.1f} s")


def write_higgs_checkpoint(model, path: Path) -> None:
    """`model` as a checkpoint directory: config.json with model_type
    "higgs_audio" and the weights under their HF names in one npz, without
    the text head (tied to embed_tokens) and with a rotary buffer that
    sanitize drops."""
    import dataclasses

    import numpy as np

    state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()
             if k != "audio_decoder_proj.text_lm_head.weight"}
    state["layers.0.self_attn.rotary_emb.inv_freq"] = \
        model.inv_freq.cpu().numpy()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **state)
    cfg = dataclasses.asdict(model.config)
    cfg.pop("model_path")
    (path / "config.json").write_text(json.dumps(cfg))


def phase_higgs_load(tmp: Path) -> None:
    """Phase 14's Higgs checkpoint: load_model(...) on the card gives the
    in-process model's greedy frames."""
    import numpy as np
    import torch

    import mlx_audio_tpu_torch

    ckpt = tmp / "higgs-small"
    here = _higgs_small("cuda")
    write_higgs_checkpoint(here, ckpt)
    loaded = mlx_audio_tpu_torch.load_model(ckpt)
    if loaded.device.type != "cuda":
        raise AssertionError("load_model did not load Higgs onto the card")
    head = loaded.audio_decoder_proj.text_lm_head.weight
    if not torch.equal(head, loaded.embed_tokens.weight):
        raise AssertionError("Higgs text head not tied to embed_tokens")
    loaded.tokenizer = HiggsTok()
    want, got = (_frames(m.generate_frames(*m.build_prompt(HIGGS_TEXT),
                                           max_new_frames=32,
                                           temperature=0.0))
                 for m in (here, loaded))
    if want.shape != got.shape or (want != got).any():
        raise AssertionError("Higgs load_model frames differ from the "
                             "in-process model's")
    log(f"[higgs-load] mlx_audio_tpu_torch.load_model on a small Higgs "
        f"checkpoint (HF names, npz, tied text head): {len(got)} greedy "
        f"frames on the card, equal to the in-process model's "
        f"({np.count_nonzero(got == HIGGS_SMALL['audio_stream_eos_id'])} "
        f"EOS codes)")


def build_higgs_full():
    """Higgs Audio v2 at ModelConfig() dims on the card, every floating
    parameter drawn N(0, 0.02) there in f32 from seed 0, as the lane draws
    them (bench.py:369-390)."""
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio import Model, ModelConfig

    model = Model(ModelConfig(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return model


def higgs_frame_bytes(model, kv_cols: float) -> float:
    """Bytes a decode frame must read: per layer the attention, the audio
    norms and the audio MLP (parameters and quantized buffers), then the
    final norm and the audio head, and the K/V of the kv_cols cache columns
    it attends to."""
    t = model.config.text
    mods = [model.norm, model.audio_decoder_proj.audio_lm_head]
    for lp in model.layers:
        mods += [lp.self_attn, lp.audio_input_layernorm,
                 lp.audio_post_attention_layernorm, lp.audio_mlp]
    weights = sum(v.numel() * v.element_size() for m in mods
                  for v in list(m.parameters()) + list(m.buffers()))
    kv = (2 * t.num_hidden_layers * kv_cols * t.num_key_value_heads
          * t.head_dim * model.embed_tokens.weight.element_size())
    return weights + kv


def _higgs_run(model, emb, mask, sampling, cache_len: int):
    """The lane's generation: prefill, then HIGGS_FRAMES frames in chunks
    of 16 (the last 10), each chunk's frames copied to the host once.
    -> (frames (N, K), prefill s, generation s)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        CHUNK_FRAMES

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = model.prefill(emb, mask, HIGGS_PLEN, cache_len, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blocks, left = [], HIGGS_FRAMES
    while left:
        frames, _ = model.chunk(carry, sampling, min(CHUNK_FRAMES, left))
        blocks.append(frames.cpu().numpy())
        left -= len(blocks[-1])
    return np.concatenate(blocks), t1 - t0, time.perf_counter() - t0


def _profile_chunk(model, emb, mask, sampling, cache_len: int) -> tuple:
    """One 16-frame chunk under torch.profiler after a prefill. -> (kernels
    a frame, device ms a frame, wall ms a frame unprofiled, busy share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    carry, _ = model.prefill(emb, mask, HIGGS_PLEN, cache_len, seed=0)
    model.chunk(carry, sampling)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.chunk(carry, sampling)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 16
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.chunk(carry, sampling)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    device = sum(dev_us(e) for e in kernels) / 1e3 / 16
    launches = sum(e.count for e in kernels) / 16
    return launches, device, wall, device / wall


def _higgs_lane(model, codec, name: str, emb, mask, card: str,
                bytes_frame: float) -> dict:
    """The lane's workload: a warm-up, then best of 3 (generation and the
    codec, as bench.py:438-475), and one profiled chunk. Returns the
    numbers it logs."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        Sampling, cache_length, prompt_bucket)

    sampling = Sampling(0.7, 0.95, 0, 7, 2, 0)
    k = model.config.audio_num_codebooks
    cache_len = cache_length(prompt_bucket(HIGGS_PLEN), HIGGS_FRAMES, k)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _higgs_run(model, emb, mask, sampling, cache_len)          # warm-up
    runs = [_higgs_run(model, emb, mask, sampling, cache_len)
            for _ in range(3)]
    frames, prefill_s, gen_s = min(runs, key=lambda r: r[2])
    if frames.shape != (HIGGS_FRAMES, k):
        raise AssertionError(f"{name}: frames {frames.shape}")
    codes = np.ascontiguousarray(frames.T)[:, :HIGGS_CODEC_FRAMES] % 1024
    codec.decode(codes.T)                                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = codec.decode(codes.T)
    codec_s = time.perf_counter() - t0
    want = HIGGS_CODEC_FRAMES * codec.config.acoustic_hop
    if audio.shape != (want,) or not np.isfinite(audio).all():
        raise AssertionError(f"{name}: audio {audio.shape}, want ({want},), "
                             f"or not finite")
    peak = torch.cuda.max_memory_allocated()
    launches, device_ms, wall_ms, busy = _profile_chunk(
        model, emb, mask, sampling, cache_len)
    frame_ms = gen_s / HIGGS_FRAMES * 1e3
    bound_ms = bytes_frame / HBM_BPS * 1e3
    audio_s = HIGGS_FRAMES / HIGGS_FPS
    out = dict(wall_s=gen_s + codec_s, frame_ms=frame_ms,
               xrt=audio_s / (gen_s + codec_s), codec_s=codec_s,
               prefill_ms=prefill_s * 1e3, peak_gb=peak / 1e9,
               own_gb=(peak - base) / 1e9, launches=launches,
               device_ms=device_ms, busy=busy, bound_ms=bound_ms,
               walls=[r[2] for r in runs])
    log(f"[higgs {name}] {HIGGS_FRAMES} frames (the lane's {audio_s:.0f} s) + "
        f"codec of {HIGGS_CODEC_FRAMES} frames -> {want} samples: wall "
        f"{out['wall_s']:.3f} s best of 3 (generation "
        f"{', '.join(f'{w:.3f}' for w in out['walls'])} s), "
        f"{frame_ms:.2f} ms a frame, xRT {out['xrt']:.3f}; prefill "
        f"{out['prefill_ms']:.2f} ms, codec {codec_s * 1e3:.2f} ms; peak "
        f"device memory {out['peak_gb']:.2f} GB ({out['own_gb']:.2f} GB "
        f"above the model and what earlier phases hold); profiled chunk: "
        f"{launches:.0f} kernels a frame, {device_ms:.3f} ms of device time "
        f"a frame against {wall_ms:.2f} ms of wall ({100 * busy:.1f}% busy); "
        f"bound {bound_ms:.3f} ms a frame ({bytes_frame / 1e9:.3f} GB), "
        f"{100 * bound_ms / frame_ms:.1f}% of it reached ({card})")
    return out


def phase_higgs_full(card: str):
    """Phase 20, first half: Higgs v2 at ModelConfig() dims (5.771 B
    parameters drawn on the card in f32 from seed 0, then cast in place to
    bf16): bf16 against f32 on the lane's 512-bucket prefill, then the
    higgs_v2_3b_bf16 workload. -> (model, codec, lane inputs, bf16 audio
    logits of the prefill's last row, the lane's numbers)."""
    import numpy as np
    import torch

    from mlx_audio_tpu_torch.codec.models.higgs_audio import (
        Model as Codec, ModelConfig as CodecConfig)
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import (
        higgs_forward, prompt_bucket)

    t0 = time.perf_counter()
    model = build_higgs_full()
    torch.cuda.synchronize()
    t = model.config.text
    n_params = model.num_params()
    log(f"[higgs] Higgs Audio v2 ModelConfig() dims (28 dual-FFN layers x "
        f"d3072, GQA 24/8 of 128, FFN 8192, 8 books of 1,026): "
        f"{n_params / 1e9:.3f} B parameters drawn N(0, 0.02) on the card in "
        f"f32 from seed 0 ({time.perf_counter() - t0:.2f} s)")
    pb = prompt_bucket(HIGGS_PLEN)
    emb32 = torch.from_numpy((np.random.RandomState(0).randn(
        1, pb, t.hidden_size) * 0.02).astype(np.float32)).cuda()
    mask = torch.zeros(1, pb, dtype=torch.bool, device="cuda")
    pad = torch.zeros(1024, device="cuda").masked_fill(
        torch.arange(1024, device="cuda") >= HIGGS_PLEN,
        float("-inf"))[None, None, None, :]

    def prefill_hidden(emb):
        dtype = model.embed_tokens.weight.dtype
        caches = KVCache.init(1, 1024, t.num_key_value_heads, t.head_dim,
                              dtype, "cuda", n_layers=t.num_hidden_layers)
        h, _ = higgs_forward(model, emb.to(dtype), mask, caches, 0,
                             pad_mask=pad)
        return h[:, :HIGGS_PLEN].float()

    ref = prefill_hidden(emb32)
    model.astype(torch.bfloat16)
    torch.cuda.empty_cache()
    got = prefill_hidden(emb32)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    del ref
    logits = model._audio_logits(got[0, -1].to(torch.bfloat16)).float()
    if not (torch.isfinite(got).all() and rel < HIGGS_BF16_REL):
        raise AssertionError(f"Higgs bf16 vs f32 prefill hidden: relative "
                             f"Frobenius {rel:.3e}")
    log(f"[higgs] bf16 vs f32 on the lane's 512-bucket prefill ({HIGGS_PLEN} "
        f"rows): relative Frobenius {rel:.3e} (limit {HIGGS_BF16_REL:g})")
    codec = Codec(CodecConfig(), device="cuda").init_params(seed=0,
                                                            on_device=True)
    codec.astype(torch.bfloat16)
    emb = emb32.to(torch.bfloat16)
    lane = _higgs_lane(model, codec, "higgs_v2_3b_bf16", emb, mask, card,
                       higgs_frame_bytes(model, HIGGS_PLEN + 1
                                         + HIGGS_FRAMES / 2))
    return model, codec, emb, mask, logits, lane


def higgs_k2_launches(model, mask) -> tuple:
    """K2 launches of (the prefill, a decode frame) on the affine-q8
    backbone, from the config and the prompt's mask: each layer runs q, k,
    v, o and, for each path some row takes, gate, up and down (28 x (4 +
    3 + 3) = 280 with both, 196 with one); a decode frame runs the audio
    path only (196). The audio head stays dense, the text head never runs.
    Raises unless the model holds exactly the quantized linears the config
    gives (28 x 10 + the text head)."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    layers = model.config.text.num_hidden_layers
    have = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    if have != layers * 10 + 1:
        raise AssertionError(f"{have} quantized linears, the config gives "
                             f"{layers * 10 + 1}")
    paths = int(bool(mask.any())) + int(bool((~mask).any()))
    return layers * (4 + 3 * paths), layers * 7


def phase_higgs_k2(model, emb, mask, card: str, recorder) -> int:
    """Phase 21, on phase 20's weights: the backbone quantized to affine 8
    bits (group 64, the model's predicate, no mxu_int8) through
    apply_quantization, one 32-frame request through generate_frames with
    K2's launches against the count higgs_k2_launches gives, then K2 at the
    four Higgs shapes, M = 1 (gemv) and 512 (mma), against
    qmatmul_reference, timed beside W8A8 (torch._int_mm) and dense bf16
    cuBLAS. Returns K2's launches in the request."""
    import torch

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.utils import apply_quantization

    t0 = time.perf_counter()
    apply_quantization(model, {"quantization": {"bits": 8, "group_size": 64}},
                       model.model_quant_predicate)
    torch.cuda.empty_cache()
    mask = mask.clone()
    mask[0, HIGGS_AUDIO_ROWS[0]:HIGGS_AUDIO_ROWS[1]] = True
    prefill, frame = higgs_k2_launches(model, mask[:, :HIGGS_PLEN])
    before = qmm_kernel.launches
    with recorder:
        t1 = time.perf_counter()
        frames = _frames(model.generate_frames(
            emb[:, :HIGGS_PLEN], mask[:, :HIGGS_PLEN],
            max_new_frames=HIGGS_K2_FRAMES, temperature=0.7, top_p=0.95,
            seed=0))
        wall = time.perf_counter() - t1
    launches = qmm_kernel.launches - before
    steps = 16 * model.last_run["chunks"]
    want = prefill + frame * steps
    if launches != want:
        raise AssertionError(f"Higgs q8: {launches} K2 launches, want "
                             f"{prefill} + {frame} x {steps} = {want}")
    want_calls = {(m, n, k, False) for n, k in HIGGS_SHAPES for m in (1, 512)}
    if not want_calls <= set(recorder.calls):
        raise AssertionError(f"K2 not launched at {want_calls}")
    log(f"[higgs q8 K2] affine 8-bit backbone (group 64): one request, "
        f"{len(frames)} frames ({steps} decode steps) in {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / (steps + 1):.2f} ms a step), {launches} K2 launches "
        f"= {prefill} (prefill, both paths) + {frame} x {steps} ({card})")
    _higgs_linear_times(card)
    log(f"[higgs q8 K2] phase 21 in {time.perf_counter() - t0:.1f} s")
    return launches


def _higgs_linear_times(card: str, reps: int = 7) -> None:
    """Each Higgs linear shape at M = 1 and 512: K2 (dispatched path,
    checked against qmatmul_reference), W8A8 qmatmul_i8 and dense bf16
    F.linear, each timed by CUDA graph replay over a rotation of weight
    copies larger than the L2 cache; then the sums over one decode frame's
    196 linears with their byte bounds."""
    from functools import partial

    import torch
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.quant import (qmatmul_i8, quantize_weight,
                                               to_i8_layout)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    frame = {"K2": 0.0, "W8A8": 0.0, "bf16": 0.0}
    bounds = {"K2": 0.0, "W8A8": 0.0, "bf16": 0.0}
    layers = 28
    for (n, k), per_layer in zip(HIGGS_SHAPES, HIGGS_FRAME_LINEARS):
        w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
        q = quantize_weight(w, QMM_GROUP, 8)
        i8 = to_i8_layout(q)
        wb = w.to(torch.bfloat16)
        sizes = {"K2": n * k + 2 * n * (k // QMM_GROUP) * 4,
                 "W8A8": n * k + 4 * n, "bf16": 2 * n * k}
        reps_of = {name: -(-2 * L2_BYTES // size)
                   for name, size in sizes.items()}
        qs = [q] + [{a: v.clone() for a, v in q.items()}
                    for _ in range(reps_of["K2"] - 1)]
        i8s = [i8] + [{a: v.clone() for a, v in i8.items()}
                      for _ in range(reps_of["W8A8"] - 1)]
        wbs = [wb] + [wb.clone() for _ in range(reps_of["bf16"] - 1)]
        for m in (1, 512):
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            rel, _ = _qmm_case(x, q, None, f"higgs ({n},{k}) q8 M={m}")
            ms = {"K2": _time_graph([partial(qmm_kernel, x, c["w_q"],
                                             c["scales"], c["biases"])
                                     for c in qs], reps),
                  "W8A8": _time_graph([partial(qmatmul_i8, x, c["w_i8"],
                                               c["scale"]) for c in i8s],
                                      reps),
                  "bf16": _time_graph([partial(F.linear, x, c)
                                       for c in wbs], reps)}
            bound = {name: (size + 2 * m * (n + k)) / HBM_BPS * 1e3
                     for name, size in sizes.items()}
            log(f"[higgs linear] ({n:4d},{k:4d}) M={m:3d} bf16 x: K2 "
                f"{ms['K2'] * 1e3:8.2f} us (rel {rel:.2e}), W8A8 "
                f"{ms['W8A8'] * 1e3:8.2f} us, dense bf16 "
                f"{ms['bf16'] * 1e3:8.2f} us; byte bounds "
                f"{bound['K2'] * 1e3:.2f} / {bound['W8A8'] * 1e3:.2f} / "
                f"{bound['bf16'] * 1e3:.2f} us ({card})")
            if m == 1:
                for name in frame:
                    frame[name] += layers * per_layer * ms[name]
                    bounds[name] += layers * per_layer * bound[name]
        del qs, i8s, wbs
    n_frame = layers * sum(HIGGS_FRAME_LINEARS)
    log(f"[higgs linear] one decode frame's {n_frame} linears at M = 1, "
        f"summed: " + ", ".join(
            f"{name} {frame[name]:.3f} ms (bound {bounds[name]:.3f} ms, "
            f"{100 * bounds[name] / frame[name]:.1f}%)" for name in frame)
        + f" ({card})")


def phase_higgs_w8a8(model, codec, emb, mask, logits_bf16, card: str):
    """Phase 20, second half: the same model's affine codes converted in
    place to W8A8 (tree_to_i8_layout, as bench.py:414-426), its audio
    logits on the prefill's last row against bf16, then the higgs_v2_3b_q8
    workload."""
    import torch

    from mlx_audio_tpu_torch.model import replace_module
    from mlx_audio_tpu_torch.nn import Int8Linear, QuantizedLinear
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.tts.models.higgs_audio.higgs_audio import \
        higgs_forward

    for name, m in list(model.named_modules()):
        if isinstance(m, QuantizedLinear):
            replace_module(model, name, Int8Linear.from_quantized(m))
    torch.cuda.empty_cache()
    t = model.config.text
    caches = KVCache.init(1, 1024, t.num_key_value_heads, t.head_dim,
                          torch.bfloat16, "cuda", n_layers=t.num_hidden_layers)
    pad = torch.zeros(1024, device="cuda").masked_fill(
        torch.arange(1024, device="cuda") >= HIGGS_PLEN,
        float("-inf"))[None, None, None, :]
    h, _ = higgs_forward(model, emb, mask, caches, 0, pad_mask=pad)
    logits = model._audio_logits(h[0, HIGGS_PLEN - 1]).float()
    del caches
    rel = float(torch.linalg.norm(logits - logits_bf16)
                / torch.linalg.norm(logits_bf16))
    if not (torch.isfinite(logits).all() and rel < HIGGS_I8_LOGITS_REL):
        raise AssertionError(f"W8A8 vs bf16 audio logits: relative Frobenius "
                             f"{rel:.3e}")
    log(f"[higgs] W8A8 vs bf16 audio logits on the prefill's last row: "
        f"relative Frobenius {rel:.3e} (limit {HIGGS_I8_LOGITS_REL:g}); "
        f"{sum(isinstance(m, Int8Linear) for m in model.modules())} W8A8 "
        f"linears")
    return _higgs_lane(model, codec, "higgs_v2_3b_q8", emb, mask, card,
                       higgs_frame_bytes(model, HIGGS_PLEN + 1
                                         + HIGGS_FRAMES / 2))


def main() -> int:
    if not (ROOT / "mlx_audio_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(mlx_audio_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    card = phase_device()
    log(card)
    phase_build()
    kres, kextra = phase_kernels(card)
    phase_reference_check()
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches, legs_per_synth, icfg = phase_main_path(card, Path(tmp))
    qres = phase_qmm(card)
    phase_qwen3_reference()
    model = build_qwen3()
    phase_qwen3_q8_prefill(model)
    recorder = K2Recorder()
    k2_launches = phase_qwen3_main(model, card, recorder)
    phase_qwen3_streaming_reference()
    k2_launches += phase_qwen3_stream(model, card, recorder)
    k2_launches += phase_qwen3_session(model, card, recorder)
    # Whisper: dense bf16 products, neither K1 nor K2 on its path
    from mlx_audio_tpu_torch.ops.qmm import qmm_kernel
    from mlx_audio_tpu_torch.ops.snake_conv import snake_conv_kernel

    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    phase_whisper_reference()
    phase_whisper_turbo(card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_whisper_cli(Path(tmp))
        phase_voxtral_cli(Path(tmp))
        phase_cohere_cli(Path(tmp))
        phase_higgs_load(Path(tmp))
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Whisper phases or the CLI launched K1 or "
                             "K2")
    # Voxtral Realtime: dense bf16 products, neither K1 nor K2 on its path
    with tempfile.TemporaryDirectory() as tmp:
        phase_voxtral_reference(Path(tmp))
        phase_voxtral_full(card, Path(tmp))
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Voxtral phases launched K1 or K2")
    # Cohere ASR: dense bf16 products, neither K1 nor K2 on its path
    phase_cohere_reference()
    phase_cohere_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Cohere phases launched K1 or K2")
    log(f"[time] phases 1-18 in {time.perf_counter() - t_start:.1f} s")
    # Higgs Audio v2: dense bf16 and W8A8 (torch._int_mm) products in
    # phases 19-20, neither K1 nor K2; K2 in phase 21, on the affine-q8
    # backbone between phase 20's two lanes
    t_higgs = time.perf_counter()
    phase_higgs_reference()
    model_h, codec_h, emb_h, mask_h, logits_h, bf16_lane = \
        phase_higgs_full(card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the Higgs bf16 phases launched K1 or K2")
    k2_launches += phase_higgs_k2(model_h, emb_h, mask_h, card, recorder)
    before = (snake_conv_kernel.launches, qmm_kernel.launches)
    q8_lane = phase_higgs_w8a8(model_h, codec_h, emb_h, mask_h, logits_h,
                               card)
    if (snake_conv_kernel.launches, qmm_kernel.launches) != before:
        raise AssertionError("the W8A8 lane launched K1 or K2")
    del model_h, codec_h
    log(f"[higgs] W8A8 against bf16 on this card: {q8_lane['frame_ms']:.2f} "
        f"vs {bf16_lane['frame_ms']:.2f} ms a frame, xRT "
        f"{q8_lane['xrt']:.3f} vs {bf16_lane['xrt']:.3f}, "
        f"{q8_lane['launches']:.0f} vs {bf16_lane['launches']:.0f} kernels a "
        f"frame ({card})")
    log(f"[time] phases 19-21 in {time.perf_counter() - t_higgs:.1f} s; "
        f"phases 1-21 in {time.perf_counter() - t_start:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    k2_path_abs = phase_qmm_path(set(recorder.calls))

    # K1: the 48 legs of one synth of two rows (B=2) at the 1024-frame
    # bucket, summed from the per-shape times of phase 3, by the dispatched
    # bf16 path (wgmma) and the first design (wmma)
    legs = synth_legs(icfg)
    k1_ms, k1_plain, k1_wmma = (
        sum(kres[(path, c, k, d)][i] for c, k, d in legs)
        for path, i in (("wgmma", 2), ("wgmma", 3), ("wmma", 2)))
    k1_lib, k1_bound = (sum(kextra[leg][i] for leg in legs) for i in (0, 1))
    k1_ops = sum(kextra[leg][1] for leg in legs
                 if kextra[leg][2] == "operations")
    k1_abs = max(v[1] for key, v in kres.items() if key[0] == "wgmma")
    full_bound = sum(k1_bound_full(c, k) for c, k, _ in legs)
    log(f"[kernel] K1: the {len(legs)} legs of one B=2 synth at the "
        f"{KERNEL_FRAMES}-frame bucket, bf16: wgmma {k1_ms:.3f} ms, wmma "
        f"{k1_wmma:.3f} ms, plain {k1_plain:.3f} ms, cuDNN conv1d alone "
        f"{k1_lib:.3f} ms; bound {k1_bound:.3f} ms for this run's rows "
        f"({100 * k1_bound / k1_ms:.1f}% of it reached), {full_bound:.3f} ms "
        f"were every row valid ({card})")
    if not k1_ms < k1_wmma:
        raise AssertionError(f"wgmma {k1_ms:.3f} ms not faster than wmma "
                             f"{k1_wmma:.3f} ms over the 48 legs")
    # K2: the linears of one decode step at M=1 (bf16 x, 8-bit codes),
    # summed from the per-shape medians of phase 5, by the dispatched path
    # and by the first design (simt); the error over every dispatched case
    import torch

    step = frame_linears(model)
    m1 = qmm_paths(torch.bfloat16, 1)[0]
    k2_ms, k2_plain, simt_ms = (
        sum(qres[("bfloat16", n, k, 8, 1, path)][i] for n, k in step)
        for path, i in ((m1, 2), (m1, 3), ("simt", 2)))
    k2_abs = max([k2_path_abs] + [
        v[1] for (name, _, _, _, m, path), v in qres.items()
        if name == "bfloat16" and path == qmm_paths(torch.bfloat16, m)[0]])
    # bytes of one M=1 launch: the codes, their f32 scales and biases, the
    # bf16 row of x in and of y out (and an f32 bias where there is one)
    k2_bound = sum(n * k + 2 * n * (k // QMM_GROUP) * 4 + 2 * (k + n)
                   for n, k in step) / HBM_BPS * 1e3
    log(f"[kernel] K2: the {len(step)} linears of one decode step, M=1, "
        f"bf16 x, 8-bit codes: kernel ({m1}) {k2_ms:.3f} ms, simt "
        f"{simt_ms:.3f} ms, plain {k2_plain:.3f} ms; bound {k2_bound:.3f} ms "
        f"(bytes) ({card})")
    # the same frame in the b = 8 session (phase 11): M = 8 and 16
    frame8 = session_frame_linears(model, SESSION_B)
    b8_ms, b8_plain = (
        sum(qres[("bfloat16", n, k, 8, m, qmm_paths(torch.bfloat16, m)[0])][i]
            for m, n, k in frame8) for i in (2, 3))
    b8_bound = sum(n * k + 2 * n * (k // QMM_GROUP) * 4 + 2 * m * (k + n)
                   for m, n, k in frame8) / HBM_BPS * 1e3
    log(f"[kernel] K2: the {len(frame8)} linears of one b={SESSION_B} "
        f"session frame (M = {SESSION_B} and {2 * SESSION_B}, mma), bf16 x, "
        f"8-bit codes: kernel {b8_ms:.3f} ms, plain {b8_plain:.3f} ms; bound "
        f"{b8_bound:.3f} ms (bytes); {b8_ms / k2_ms:.2f}x the M=1 frame "
        f"({card})")

    print(json.dumps({"kernels": [{
        "name": "adain_snake_conv1d",
        "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/snake_conv.cu",
        "replaces": "mlx_audio_tpu/ops/snake_conv_pallas.py:159",
        "launches": k1_launches,
        "max_abs_err": k1_abs,
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound,
        "bound_by": "operations" if 2 * k1_ops >= k1_bound else "bytes",
        "library_ms": k1_lib,
    }, {
        "name": "qmm_pallas",
        "route": "cuda",
        "source": "mlx_audio_tpu_torch/csrc/qmm.cu",
        "replaces": "mlx_audio_tpu/ops/qmm_pallas.py:82",
        "launches": k2_launches,
        "max_abs_err": k2_abs,
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
