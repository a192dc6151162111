// Fused AdaIN -> Snake -> dilated conv1d for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mlx_audio_tpu/ops/snake_conv_pallas.py::adain_snake_conv1d (:107-177,
//   body _kernel :67-104),
// which runs every residual conv leg of Kokoro's ISTFTNet generator
// (48 legs per synth: C=256 at upsample stage 0, C=128 at stage 1).
//
// What it computes (x, out: (B, T, C) channel-last; w: (k, C, C) WIO):
//   h[b,r,c]   = 0 <= r < vlen[b] ? round_T(snake(x[b,r,c]*scale[b,c] + shift[b,c])) : 0
//   snake(u)   = u + sin(alpha[c]*u)^2 / alpha[c]            (f32, sinf)
//   out[b,t,o] = t < vlen[b] ? bias[o] + sum_j sum_c h[b, t+(j-(k-1)/2)*dil, c] * w[j,c,o] : 0
// with the products accumulated in f32. `scale`/`shift` fold the instance
// norm statistics and the AdaIN affine (ops/snake_conv.py::fold_adain).
//
// What bounds it on the H100. One leg does about 2*T*C*C*k FLOP for about
// 4*T*C bytes of bf16 activations in and out, i.e. about C*k/2 FLOP per
// byte, against a bf16 ridge of about 295 FLOP/byte (989 TFLOP/s over
// 3.35 TB/s). C=128 with k=3 (192 FLOP/byte) sits on the memory side;
// every other leg the main path runs is on the compute side. Besides the
// products, every element of h costs an accurate sinf and the affine, about
// 30 FP32 instructions: at C=256, k=3 that is close to the SM time of the
// 1,536 tensor-core FLOP the element feeds, so the snake has to be computed
// once per element and overlapped with the products.
//
// Three kernels, picked in ops/snake_conv.py::choose_path:
//
// * wgmma (bf16, C a multiple of 64 up to 256): the main path. A block
//   covers (time tile, batch row) tiles with ALL C output channels, so the
//   snake of each x element is computed once per tile, as the TPU kernel
//   does with its whole-w block. Blocks are persistent (one per SM) and
//   walk the tiles, so one tile's epilogue overlaps the next tile's snake
//   and weight loads; a tile that starts at or past vlen is written as
//   zeros without any products. Warp roles, in one block of 384 threads:
//   - two consumer warpgroups own 64*MT rows each (MT = 1 at C > 128, 2 at
//     C <= 128: 128 f32 accumulators a thread at C = 128 and 256) and run
//     wgmma m64nCk16 with both operands in shared memory; setmaxnreg gives
//     them the registers the other warps do not need;
//   - a producer thread streams w as (64-input-channel chunk, tap) tiles
//     with TMA bulk copies through a ring of mbarrier-guarded stages; the
//     tiles are laid out once on the host (ops/snake_conv.py::pack_weight)
//     in the wgmma's canonical no-swizzle K-major form, so one contiguous
//     copy lands a tile ready for the tensor cores;
//   - three snake warps fill the h slab of each chunk (the tile's rows plus
//     the conv halo, 64 channels): x requested with cp.async one chunk
//     ahead, then the affine and snake in f32 in place, rounded once to
//     bf16, handed over through a full/empty mbarrier pair per slab.
//   The slab keeps the wgmma's no-swizzle form with core matrices
//   contiguous along time, so the tap shift j*dil is a 16-byte step of the
//   descriptor's start address: every tap reads the one slab. The
//   epilogue adds the bias, zeroes rows >= vlen and writes bf16 through a
//   16 x 64 staging tile per warp in 16-byte stores.
//   What set the pace while this was built (on an H100, removing each part
//   in turn; tools/snake_conv_ablation.py in the package repeats it): the
//   snake, not the products or the weight stream. Accurate sinf, x read
//   from device memory inside the snake, bank conflicts on per-element
//   parameter loads and shared-memory reads waiting behind the wgmma
//   operand traffic each cost more than the products at C = 256, k = 3;
//   hence the reduced sine (sin_sq), the cp.async prefetch, parameters in
//   registers, batched reads, and the snake in warps of its own.
// * wmma (bf16, C a multiple of 32): the first design, kept so the two can
//   be timed in one run: one block per (time tile, 128-output-channel tile,
//   batch row), single-buffered loads, WMMA 16x16x16.
// * f32: CUDA-core FMAs (f32 must stay exact to the plain version, which
//   TF32 tensor cores would not be), the first design's tiling.
//
// Built without --use_fast_math. The wmma and f32 kernels use sinf; the
// wgmma kernel reduces the argument itself before __sinf (sin_sq), since at
// random init the generator's activations can be huge, where __sinf alone
// is wrong.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TT = 128;        // output time rows per block
constexpr int TO = 128;        // output channels per block
constexpr int CK = 32;         // input channels per chunk
constexpr int MAX_HALO = 32;   // (k-1)/2*dil; the wrapper checks
constexpr int SLAB = TT + 2 * MAX_HALO;
constexpr int NTHREADS = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Per-chunk AdaIN/snake parameters into shared memory.
__device__ __forceinline__ void load_params(float* s_scale, float* s_shift,
                                            float* s_alpha, float* s_inv,
                                            const float* scale, const float* shift,
                                            const float* alpha, int b, int C, int c0) {
  const int t = threadIdx.x;
  if (t < CK) {
    const float a = alpha[c0 + t];
    s_scale[t] = scale[(size_t)b * C + c0 + t];
    s_shift[t] = shift[(size_t)b * C + c0 + t];
    s_alpha[t] = a;
    s_inv[t] = 1.0f / a;
  }
}

// x slab rows [t0-halo, t0+TT+halo) x channels [c0, c0+CK) -> affine ->
// snake -> zero outside [0, vl) -> round to T -> As (row stride LDA).
template <typename T, int LDA>
__device__ __forceinline__ void load_slab(T* As, const T* xb, const float* s_scale,
                                          const float* s_shift, const float* s_alpha,
                                          const float* s_inv, int t0, int halo,
                                          int vl, int C, int c0) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte vector
  constexpr int VPR = CK / V;           // vectors per slab row
  const int rows = TT + 2 * halo;
  for (int i = threadIdx.x; i < rows * VPR; i += NTHREADS) {
    const int row = i / VPR;
    const int cv = (i % VPR) * V;
    const int r = t0 - halo + row;
    alignas(16) T vals[V];
    if (r >= 0 && r < vl) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(xb + (size_t)r * C + c0 + cv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = cv + e;
        float h = to_f32(vals[e]) * s_scale[c] + s_shift[c];
        const float s = sinf(s_alpha[c] * h);
        h = h + s_inv[c] * (s * s);
        vals[e] = from_f32<T>(h);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = from_f32<T>(0.0f);
    }
    *reinterpret_cast<uint4*>(&As[row * LDA + cv]) = *reinterpret_cast<const uint4*>(vals);
  }
}

// w[j, c0:c0+CK, o0:o0+TO] -> Ws (row stride LDB); columns past C are zero.
template <typename T, int LDB>
__device__ __forceinline__ void load_weights(T* Ws, const T* w, int j, int c0,
                                             int o0, int C) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPW = TO / V;
  const T* wj = w + ((size_t)j * C + c0) * C + o0;
  for (int i = threadIdx.x; i < CK * VPW; i += NTHREADS) {
    const int c = i / VPW;
    const int ov = (i % VPW) * V;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (o0 + ov < C) v = *reinterpret_cast<const uint4*>(wj + (size_t)c * C + ov);
    *reinterpret_cast<uint4*>(&Ws[c * LDB + ov]) = v;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, 8x8 outputs per thread.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
snake_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ alpha,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      const int* __restrict__ vlen, float* __restrict__ out,
                      int T, int C, int k, int dil) {
  constexpr int LDA = CK + 4;
  constexpr int LDB = TO + 4;
  __shared__ __align__(16) float As[SLAB * LDA];
  __shared__ __align__(16) float Ws[CK * LDB];
  __shared__ float s_scale[CK], s_shift[CK], s_alpha[CK], s_inv[CK];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * TO;
  const int halo = (k - 1) / 2 * dil;
  const int vl = min(max(vlen[b], 0), T);
  const float* xb = x + (size_t)b * T * C;
  const int tx = threadIdx.x % 16;   // columns tx + 16*q
  const int ty = threadIdx.x / 16;   // rows ty*8 + i

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk's readers are done
    load_params(s_scale, s_shift, s_alpha, s_inv, scale, shift, alpha, b, C, c0);
    __syncthreads();
    load_slab<float, LDA>(As, xb, s_scale, s_shift, s_alpha, s_inv, t0, halo, vl, C, c0);
    for (int j = 0; j < k; ++j) {
      __syncthreads();  // slab written (j == 0), previous tap's Ws readers done
      load_weights<float, LDB>(Ws, w, j, c0, o0, C);
      __syncthreads();
      const float* Aj = As + (j * dil + ty * 8) * LDA;
#pragma unroll 4
      for (int c = 0; c < CK; ++c) {
        float a[8], bb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = Aj[i * LDA + c];
#pragma unroll
        for (int q = 0; q < 8; ++q) bb[q] = Ws[c * LDB + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a[i], bb[q], acc[i][q]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + ty * 8 + i;
    if (t >= T) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + tx + 16 * q;
      if (o >= C) continue;
      out[((size_t)b * T + t) * C + o] = t < vl ? acc[i][q] + bias[o] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through WMMA (16x16x16, f32 accumulate). 8 warps in a
// 4 x 2 grid; each warp owns a 32 x 64 block of the 128 x 128 output tile.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
snake_conv_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ shift, const float* __restrict__ alpha,
                       const bf16* __restrict__ w, const float* __restrict__ bias,
                       const int* __restrict__ vlen, bf16* __restrict__ out,
                       int T, int C, int k, int dil) {
  using namespace nvcuda;
  // Row strides in elements: 48 bf16 = 96 bytes and 144 bf16 = 288 bytes,
  // multiples of the 32 bytes WMMA needs at every row a fragment starts on
  // (the tap shift j*dil starts fragments on any slab row).
  constexpr int LDA = CK + 16;
  constexpr int LDB = TO + 16;
  __shared__ __align__(128) bf16 As[SLAB * LDA];
  __shared__ __align__(128) bf16 Ws[CK * LDB];
  __shared__ __align__(128) float stage[NTHREADS / 32][16 * 16];
  __shared__ float s_scale[CK], s_shift[CK], s_alpha[CK], s_inv[CK];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * TO;
  const int halo = (k - 1) / 2 * dil;
  const int vl = min(max(vlen[b], 0), T);
  const bf16* xb = x + (size_t)b * T * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) wmma::fill_fragment(acc[i][q], 0.0f);

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    load_params(s_scale, s_shift, s_alpha, s_inv, scale, shift, alpha, b, C, c0);
    __syncthreads();
    load_slab<bf16, LDA>(As, xb, s_scale, s_shift, s_alpha, s_inv, t0, halo, vl, C, c0);
    for (int j = 0; j < k; ++j) {
      __syncthreads();
      load_weights<bf16, LDB>(Ws, w, j, c0, o0, C);
      __syncthreads();
      const bf16* Aj = As + (j * dil + wr) * LDA;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], Aj + 16 * i * LDA + kk, LDA);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wmma::load_matrix_sync(bfr[q], Ws + kk * LDB + wc + 16 * q, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) wmma::mma_sync(acc[i][q], af[i], bfr[q], acc[i][q]);
      }
    }
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wmma::store_matrix_sync(st, acc[i][q], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = t0 + wr + 16 * i + e / 16;
        const int o = o0 + wc + 16 * q + e % 16;
        if (t < T && o < C)
          out[((size_t)b * T + t) * C + o] =
              __float2bfloat16_rn(t < vl ? st[e] + bias[o] : 0.0f);
      }
      __syncwarp();
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma, warp-specialised (see the head of this file).
// ---------------------------------------------------------------------------

constexpr int WG_CONSUMERS = 256;      // threads 0-255: wgmma
constexpr int WG_SNAKE = 96;           // the next 96: the snake (a multiple of 8)
constexpr int WG_SNAKE_BATCH = 4;      // slab vectors a snake thread reads at once
constexpr int WG_THREADS = WG_CONSUMERS + WG_SNAKE + 32;  // the last warp's lane 0: TMA
// registers a thread after setmaxnreg: the snake and producer warps hand
// theirs to the consumers' accumulators (launched at 65536 / 384 = 168)
constexpr int WG_REG_CONSUMER = 200, WG_REG_OTHER = 104;
constexpr int WG_STAGING_BYTES = 8 * 16 * 72 * 2;  // a 16 x 64 bf16 tile per consumer warp
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_MAX_SMEM = 232448;    // 227 KB, the most a block may use
constexpr int WG_SLABS = 3;            // h slabs: products, snake, x landing

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` contiguous bytes, completion on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy stores to shared memory made visible to the async proxy
// (the wgmma reads of the h slab).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes, rows 16 bytes apart; `lbo` bytes between the core matrices
// along K, `sbo` bytes between those along M/N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


// d = A*B + (accumulate ? d : 0). The first product of a tile passes 0, so
// no other instruction writes the accumulators while products are in
// flight (ptxas would serialise the wgmmas otherwise).
template <int N>
__device__ __forceinline__ void wgmma_nc(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_n64(d, da, db, accumulate);
  else if constexpr (N == 128) wgmma_n128(d, da, db, accumulate);
  else if constexpr (N == 192) wgmma_n192(d, da, db, accumulate);
  else wgmma_n256(d, da, db, accumulate);
}

// Rows of one consumer warpgroup in units of 64 (the wgmma's M).
template <int N> struct WgShape {
  static constexpr int MT = N <= 128 ? 2 : 1;
  static constexpr int TT = 2 * MT * 64;                  // time rows per block
  static constexpr uint32_t TILE_BYTES = (uint32_t)N * 128;  // one (chunk, tap) of w
};

// sin(u)^2 for the snake. sin^2 has period pi, so u is reduced by pi:
// n = rint(u/pi), r = u - n*pi in two FMAs (Cody-Waite, pi split into its
// f32 value and the remainder), |r| <= pi/2, where the hardware sine
// __sinf is within about 2^-21 of sin. The reduction is exact to an ulp of
// r while n*pi's product is exact in the FMA, far past the |u| <= 1e4 the
// tests hold it to; about 8 instructions against some 40 for sinf.
__device__ __forceinline__ float sin_sq(float u) {
  const float n = rintf(u * 0.318309886183790671538f);
  float r = fmaf(-n, 3.14159274101257324219f, u);
  r = fmaf(-n, -8.74227800037247605e-8f, r);
  const float s = __sinf(r);
  return s * s;
}

// The h slab of one 64-channel chunk: vector v (16 bytes, 8 channels) is
// slab row v/8, time t0 - halo + v/8, input channels cc*64 + (v%8)*8 .. +8.
// Layout: 16-byte column q = v%8 holds all rows, 16 bytes apart; columns are
// `col` bytes apart (an odd number of 16-byte rows, so the eight columns of
// one row fall on distinct banks). Snake thread st handles the vectors
// v = st (mod WG_SNAKE), all of channel group st % 8, both when it requests
// them and when it computes them, so it waits on its own copies only.

// Raw x of one chunk into `slab` with cp.async (16 bytes each, through L2);
// rows outside [0, vl) are written as zeros. The caller commits the group.
__device__ __forceinline__ void load_slab(uint8_t* slab, uint32_t col, const bf16* __restrict__ xc,
                                          int C, int t0h, int vl, int nvec, int st) {
  for (int v = st; v < nvec; v += WG_SNAKE) {
    const int row = v >> 3, q = v & 7;
    const int r = t0h + row;
    uint8_t* dst = slab + q * col + row * 16;
    if (r >= 0 && r < vl)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                   "l"(xc + (size_t)r * C + q * 8)
                   : "memory");
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// Snake in place over the slab load_slab filled: f32 affine and snake,
// rounded once to bf16; rows outside [0, vl) stay zero. p[e] holds
// (scale, shift, alpha, 1/alpha) of the thread's channel e of its group.
// Vectors go in batches of WG_SNAKE_BATCH, all read before any is
// computed: while the tensor cores stream their operands, a shared-memory
// read waits a long time, and one at a time the snake would wait on each.
__device__ __forceinline__ void snake_slab(uint8_t* slab, uint32_t col, const float4 (&p)[8],
                                           int t0h, int vl, int nvec, int st) {
  const int q = st & 7;
  for (int v0 = st; v0 < nvec; v0 += WG_SNAKE_BATCH * WG_SNAKE) {
    uint4 raw[WG_SNAKE_BATCH];
    uint4* ptr[WG_SNAKE_BATCH];
    bool live[WG_SNAKE_BATCH];
#pragma unroll
    for (int u = 0; u < WG_SNAKE_BATCH; ++u) {
      const int v = v0 + u * WG_SNAKE;
      const int row = v >> 3;
      const int r = t0h + row;
      live[u] = v < nvec && r >= 0 && r < vl;
      ptr[u] = reinterpret_cast<uint4*>(slab + q * col + row * 16);
      if (live[u]) raw[u] = *ptr[u];
    }
#pragma unroll
    for (int u = 0; u < WG_SNAKE_BATCH; ++u) {
      if (!live[u]) continue;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float4 p0 = p[2 * e], p1 = p[2 * e + 1];
        float h0 = f.x * p0.x + p0.y;
        float h1 = f.y * p1.x + p1.y;
        h0 = h0 + p0.w * sin_sq(p0.z * h0);
        h1 = h1 + p1.w * sin_sq(p1.z * h1);
        h2[e] = __floats2bfloat162_rn(h0, h1);
      }
      *ptr[u] = raw[u];
    }
  }
}

// The tiles of one launch: (batch row, time tile) pairs in row-major order,
// walked by the persistent blocks in a stride of gridDim.x. A tile that
// starts at or past its row's valid length is all zeros and runs no products.
struct TileWalk {
  int tiles_per_row, total, T, TT;
  const int* vlen;
  __device__ int vl(int b) const { return min(max(vlen[b], 0), T); }
  __device__ bool real(int ti) const {
    return (ti % tiles_per_row) * TT < vl(ti / tiles_per_row);
  }
  // the first real tile at or after `ti` in this block's stride, or -1
  __device__ int next_real(int ti) const {
    for (; ti < total; ti += gridDim.x)
      if (real(ti)) return ti;
    return -1;
  }
};

template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
snake_conv_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, const float* __restrict__ alpha,
                        const bf16* __restrict__ wp, const float* __restrict__ bias,
                        const int* __restrict__ vlen, bf16* __restrict__ out, int B, int T,
                        int k, int dil, int stages) {
  using S = WgShape<N>;
  constexpr int MT = S::MT, TT = S::TT, NCH = N / 64, R = N / 2;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int halo = (k - 1) / 2 * dil;
  const TileWalk walk{(T + TT - 1) / TT, B * ((T + TT - 1) / TT), T, TT, vlen};
  const int SR = TT + 2 * halo;             // slab rows
  const int V = SR * 8;                      // 16-byte vectors of one slab
  const uint32_t col = 16u * (SR + 1);       // bytes between slab columns
  const uint32_t slab_bytes = 8u * col;

  // shared memory: barriers, bias, per-warp epilogue staging, slabs, ring
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* w_empty = w_full + WG_MAX_STAGES;
  uint64_t* h_full = w_empty + WG_MAX_STAGES;
  uint64_t* h_empty = h_full + WG_SLABS;
  float* s_bias = reinterpret_cast<float*>(smem + 256);
  bf16* staging = reinterpret_cast<bf16*>(smem + 256 + 4 * N);
  uint8_t* slabs = smem + 256 + 4 * N + WG_STAGING_BYTES;
  uint8_t* ring = slabs + WG_SLABS * slab_bytes;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], WG_CONSUMERS / 32);
    }
    for (int s = 0; s < WG_SLABS; ++s) {
      mbar_init(&h_full[s], WG_SNAKE);
      mbar_init(&h_empty[s], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < N; i += WG_THREADS) s_bias[i] = bias[i];
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_REG_OTHER));
    if (warp == WG_THREADS / 32 - 1) {
      // producer: the (chunk, tap) tiles of w, once per real tile
      if (lane == 0) {
        const uint8_t* src = reinterpret_cast<const uint8_t*>(wp);
        int stage = 0;
        uint32_t phase = 0;
        for (int ti = walk.next_real(blockIdx.x); ti >= 0;
             ti = walk.next_real(ti + gridDim.x)) {
          for (int i = 0; i < NCH * k; ++i) {
            mbar_wait(&w_empty[stage], phase ^ 1);
            mbar_expect_tx(&w_full[stage], S::TILE_BYTES);
            bulk_g2s(ring + stage * S::TILE_BYTES, src + (size_t)i * S::TILE_BYTES,
                     S::TILE_BYTES, &w_full[stage]);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      return;
    }
    // snake warps: the stream of (real tile, chunk), one chunk ahead of the
    // products; chunk n uses slab n % WG_SLABS
    const int st = tid - WG_CONSUMERS;
    const int q = st & 7;
    int ti = walk.next_real(blockIdx.x);
    if (ti < 0) return;
    int n = 0;
    {
      const int b = ti / walk.tiles_per_row;
      const int t0 = (ti % walk.tiles_per_row) * TT;
      load_slab(slabs, col, x + (size_t)b * T * N, N, t0 - halo, walk.vl(b), V, st);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    while (ti >= 0) {
      const int b = ti / walk.tiles_per_row;
      const int t0h = (ti % walk.tiles_per_row) * TT - halo;
      const int vl = walk.vl(b);
      const int nti = walk.next_real(ti + gridDim.x);
      for (int cc = 0; cc < NCH; ++cc, ++n) {
        // request the next chunk of the stream, then wait for this one
        const int pti = cc + 1 < NCH ? ti : nti;
        if (pti >= 0) {
          const int pcc = cc + 1 < NCH ? cc + 1 : 0;
          const int pb = pti / walk.tiles_per_row;
          const int s = (n + 1) % WG_SLABS;
          mbar_wait(&h_empty[s], (((n + 1) / WG_SLABS) & 1) ^ 1);
          load_slab(slabs + s * slab_bytes, col, x + (size_t)pb * T * N + pcc * 64, N,
                    (pti % walk.tiles_per_row) * TT - halo, walk.vl(pb), V, st);
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        float4 p[8];
        const int c0 = cc * 64 + q * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = alpha[c0 + e];
          p[e] = make_float4(scale[(size_t)b * N + c0 + e], shift[(size_t)b * N + c0 + e], a,
                             1.0f / a);
        }
        snake_slab(slabs + (n % WG_SLABS) * slab_bytes, col, p, t0h, vl, V, st);
        fence_proxy_async();
        mbar_arrive(&h_full[n % WG_SLABS]);
      }
      ti = nti;
    }
    return;
  }

  // consumers: products of each real tile, then its epilogue; zero tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_REG_CONSUMER));
  const int wg = warp / 4;
  float acc[MT][R];  // written first by each tile's first product
  int stage = 0, prev = -1, n = 0;
  uint32_t phase = 0;
  bf16* stg = staging + warp * (16 * 72);  // this warp's 16 x 64 staging tile
  for (int ti = blockIdx.x; ti < walk.total; ti += gridDim.x) {
    const int b = ti / walk.tiles_per_row;
    const int t0 = (ti % walk.tiles_per_row) * TT;
    const int vl = walk.vl(b);
    bf16* outb = out + (size_t)b * T * N;
    if (t0 >= vl) {  // the whole tile lies past the valid length: zeros
      const int rows = min(TT, T - t0);
      for (int i = tid; i < rows * (N / 8); i += WG_CONSUMERS)
        *reinterpret_cast<uint4*>(outb + (size_t)(t0 + i / (N / 8)) * N + (i % (N / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    for (int cc = 0; cc < NCH; ++cc, ++n) {
      mbar_wait(&h_full[n % WG_SLABS], (n / WG_SLABS) & 1);
      const uint32_t a_base = smem_u32(slabs + (n % WG_SLABS) * slab_bytes);
      for (int j = 0; j < k; ++j) {
        mbar_wait(&w_full[stage], phase);
        const uint32_t b_base = smem_u32(ring + stage * S::TILE_BYTES);
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t db = make_desc(b_base + s * 2 * N * 16, N * 16, 128);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int row0 = (wg * MT + m) * 64 + j * dil;
            const uint64_t da = make_desc(a_base + row0 * 16 + s * 2 * col, col, 128);
            wgmma_nc<N>(acc[m], da, db, (cc | j | s) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
        // the previous group is done: its weight stage, and at a chunk's
        // first tap the previous chunk's slab, are free
        if (lane == 0) {
          if (prev >= 0) mbar_arrive(&w_empty[prev]);
          if (j == 0 && cc > 0) mbar_arrive(&h_empty[(n - 1) % WG_SLABS]);
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
    if (lane == 0) {
      mbar_arrive(&w_empty[prev]);
      mbar_arrive(&h_empty[(n - 1) % WG_SLABS]);
    }
    prev = -1;

    // epilogue: bias, rows >= vl to zero, bf16; through this warp's
    // staging tile, 16 rows x 64 channels at a time, in 16-byte stores
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r0 = (wg * MT + m) * 64 + (warp % 4) * 16;  // the warp's first row
      const bool ok0 = t0 + r0 + lane / 4 < vl, ok1 = t0 + r0 + lane / 4 + 8 < vl;
#pragma unroll
      for (int nb = 0; nb < N / 64; ++nb) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * (lane % 4);
          const int f = 4 * (nb * 8 + i);
          const float b0 = s_bias[nb * 64 + c], b1 = s_bias[nb * 64 + c + 1];
          *reinterpret_cast<__nv_bfloat162*>(&stg[(lane / 4) * 72 + c]) =
              __floats2bfloat162_rn(ok0 ? acc[m][f] + b0 : 0.0f, ok0 ? acc[m][f + 1] + b1 : 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(&stg[(lane / 4 + 8) * 72 + c]) =
              __floats2bfloat162_rn(ok1 ? acc[m][f + 2] + b0 : 0.0f,
                                    ok1 ? acc[m][f + 3] + b1 : 0.0f);
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = lane + 32 * u;  // 16 rows x 8 vectors
          const int t = t0 + r0 + i / 8;
          if (t < T)
            *reinterpret_cast<uint4*>(outb + (size_t)t * N + nb * 64 + (i % 8) * 8) =
                *reinterpret_cast<const uint4*>(&stg[(i / 8) * 72 + (i % 8) * 8]);
        }
        __syncwarp();
      }
    }
  }
}

template <int N>
int wgmma_launch(const void* x, const void* scale, const void* shift, const void* alpha,
                 const void* wp, const void* bias, const void* vlen, void* out, int B, int T,
                 int k, int dil, cudaStream_t stream) {
  using S = WgShape<N>;
  const int halo = (k - 1) / 2 * dil;
  const long slabs = (long)WG_SLABS * 8 * 16 * (S::TT + 2 * halo + 1);
  const long fixed = 256 + 4L * N + WG_STAGING_BYTES;
  const int stages =
      (int)std::min<long>(WG_MAX_STAGES, (WG_MAX_SMEM - fixed - slabs) / S::TILE_BYTES);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const long smem = fixed + slabs + (long)stages * S::TILE_BYTES;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = (long)B * ((T + S::TT - 1) / S::TT);
  const int grid = (int)std::min<long>(tiles, std::max(sms, 1));
  snake_conv_wgmma_kernel<N><<<grid, WG_THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)shift, (const float*)alpha,
      (const bf16*)wp, (const float*)bias, (const int*)vlen, (bf16*)out, B, T, k, dil, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Each returns cudaGetLastError() after the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" {

int snake_conv1d_f32(const void* x, const void* scale, const void* shift,
                     const void* alpha, const void* w, const void* bias,
                     const void* vlen, void* out, int B, int T, int C, int k,
                     int dil, void* stream) {
  const dim3 grid((T + TT - 1) / TT, (C + TO - 1) / TO, B);
  snake_conv_f32_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)alpha, (const float*)w, (const float*)bias,
      (const int*)vlen, (float*)out, T, C, k, dil);
  return (int)cudaGetLastError();
}

int snake_conv1d_bf16(const void* x, const void* scale, const void* shift,
                      const void* alpha, const void* w, const void* bias,
                      const void* vlen, void* out, int B, int T, int C, int k,
                      int dil, void* stream) {
  const dim3 grid((T + TT - 1) / TT, (C + TO - 1) / TO, B);
  snake_conv_bf16_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)shift,
      (const float*)alpha, (const bf16*)w, (const float*)bias,
      (const int*)vlen, (bf16*)out, T, C, k, dil);
  return (int)cudaGetLastError();
}

// Sets the wgmma kernels' dynamic shared memory limit on the current device;
// call once per device before snake_conv1d_wgmma. Returns cudaGetLastError().
int snake_conv_init() {
  cudaFuncSetAttribute(snake_conv_wgmma_kernel<64>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_MAX_SMEM);
  cudaFuncSetAttribute(snake_conv_wgmma_kernel<128>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_MAX_SMEM);
  cudaFuncSetAttribute(snake_conv_wgmma_kernel<192>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_MAX_SMEM);
  cudaFuncSetAttribute(snake_conv_wgmma_kernel<256>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_MAX_SMEM);
  return (int)cudaGetLastError();
}

// `wp` is w packed by ops/snake_conv.py::pack_weight: (C/64, k, 8, C, 8).
int snake_conv1d_wgmma(const void* x, const void* scale, const void* shift,
                       const void* alpha, const void* wp, const void* bias,
                       const void* vlen, void* out, int B, int T, int C, int k,
                       int dil, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return wgmma_launch<64>(x, scale, shift, alpha, wp, bias, vlen, out, B, T, k, dil, s);
    case 128: return wgmma_launch<128>(x, scale, shift, alpha, wp, bias, vlen, out, B, T, k, dil, s);
    case 192: return wgmma_launch<192>(x, scale, shift, alpha, wp, bias, vlen, out, B, T, k, dil, s);
    case 256: return wgmma_launch<256>(x, scale, shift, alpha, wp, bias, vlen, out, B, T, k, dil, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
