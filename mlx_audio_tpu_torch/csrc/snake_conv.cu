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
// every other leg the main path runs (C=128 with k=7, 11; C=256 with any k)
// is on the compute side.
//
// What the design does about it. The unfused PyTorch path writes the
// AdaIN output and the snake output to device memory and reads them back
// before the conv; here each block reads its x slab (its TT time rows plus
// the conv halo) once per input-channel chunk, applies the affine and the
// snake in f32 registers, and keeps the result in shared memory, so h never
// touches device memory. The bf16 products run on the tensor cores
// (WMMA 16x16x16, f32 accumulators) for the compute-bound legs; f32 inputs
// run on the CUDA cores (f32 must stay exact to the plain version, which
// TF32 tensor cores would not be). This is the simple first version: one
// block per (time tile, output-channel tile, batch row), single-buffered
// loads that do not overlap the products, weights re-read per tap from L2.
// TMA, wgmma and a pipelined ring of tiles are left for later work.
//
// Built without --use_fast_math and with sinf (not __sinf): at random init
// the generator's activations can be huge, where the fast sine is wrong.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // extern "C"
