"""What sets the pace of K1's wgmma path: time it with one part removed.

    python3 -m mlx_audio_tpu_torch.tools.snake_conv_ablation

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit. Builds csrc/snake_conv.cu as it is and in variants, each with one
part of the wgmma kernel taken out by a text substitution (the outputs of a
variant are wrong; only its time means something):

* no_sin: the hardware sine of the snake (sin_sq's __sinf);
* snake_copy: the snake's arithmetic (the slab is only copied in place);
* no_wload: the TMA copies of w (the ring's barriers still complete);
* no_mma: the wgmma products.

Each is timed at C = 256 and C = 128 with k = 3 and 11, dil = 1, B = 2 at
the time lengths of phase 3 of chip_smoke.py (a 1,024-frame bucket), with
the second row's valid length at 60% (as there) and at 100%. Times are
device times per launch from a CUDA graph replay. A part whose removal
saves much is on the critical path; one whose removal saves nothing is
hidden under the others.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops import cuda_build

_W_COPY = """            bulk_g2s(ring + stage * S::TILE_BYTES, src + (size_t)i * S::TILE_BYTES,
                     S::TILE_BYTES, &w_full[stage]);"""
VARIANTS = {
    "base": [],
    "no_sin": [("  const float s = __sinf(r);", "  const float s = r;")],
    "snake_copy": [("        h2[e] = __floats2bfloat162_rn(h0, h1);",
                    "        (void)h0; (void)h1;")],
    "no_wload": [("mbar_expect_tx(&w_full[stage], S::TILE_BYTES);",
                  "mbar_arrive(&w_full[stage]);"), (_W_COPY, "")],
    "no_mma": [("            wgmma_nc<N>(acc[m], da, db, (cc | j | s) != 0);",
                "")],
}
SHAPES = ((256, 2 * 1024 * 10), (128, 2 * 1024 * 60 + 1))


def build(name: str) -> ctypes.CDLL:
    """csrc/snake_conv.cu with variant `name`'s substitutions, compiled
    into the build directory and loaded."""
    src = (cuda_build.CSRC / "snake_conv.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old.strip()[:60]!r} is no "
                               f"longer in csrc/snake_conv.cu")
        src = src.replace(old, new)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"ablation_{name}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.snake_conv1d_wgmma.argtypes = ([ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.snake_conv1d_wgmma.restype = ctypes.c_int
    lib.snake_conv_init.argtypes = []
    lib.snake_conv_init.restype = ctypes.c_int
    if lib.snake_conv_init() != 0:
        raise RuntimeError(f"snake_conv_init failed for {name}")
    return lib


def _graph_ms(fn, reps: int = 7, calls: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[reps // 2]


def main() -> int:
    import torch

    from ..ops.snake_conv import pack_weight

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for c, t in SHAPES:
        x = torch.randn(2, t, c, generator=g, device=dev).to(torch.bfloat16)
        scale = 1.0 + 0.5 * torch.randn(2, c, generator=g, device=dev)
        shift = 0.1 * torch.randn(2, c, generator=g, device=dev)
        alpha = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.zeros(c, device=dev)
        out = torch.empty_like(x)
        for k in (3, 11):
            wp = pack_weight((torch.randn(k, c, c, generator=g, device=dev)
                              / (k * c) ** 0.5).to(torch.bfloat16))
            for second in ((t * 3) // 5, t):
                vlen = torch.tensor([t, second], dtype=torch.int32, device=dev)
                times = {}
                for name, lib in libs.items():
                    def launch(lib=lib):
                        rc = lib.snake_conv1d_wgmma(
                            x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                            alpha.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                            vlen.data_ptr(), out.data_ptr(), 2, t, c, k, 1,
                            torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"launch failed: {rc}")
                    times[name] = _graph_ms(launch)
                print(f"C={c} k={k:2d} T={t} valid [{t}, {second}]: "
                      + ", ".join(f"{n} {ms:.4f} ms" for n, ms in times.items())
                      + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
