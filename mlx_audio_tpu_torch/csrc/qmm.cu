// Fused dequantize + matmul for affine group-quantized weights (K2).
//
// Replaces the Pallas TPU kernel `qmm_pallas` (mlx_audio_tpu/ops/qmm_pallas.py,
// `_qmm_kernel` :24-39, pallas_call :82). Contract, as there:
//
//     y[m, n] = sum_k x[m, k] * (scales[n, k/gs] * q[n, k] + biases[n, k/gs])
//               [+ bias[n]]
//
// x (M, K) f32 or bf16; q uint8 (N, K), one code per byte at 8 or 4 bits;
// scales, biases f32 (N, K/gs); bias f32 (N) or null. The weight is
// dequantized in registers in f32, products are summed in f32, and y is
// written in x's dtype. The grouped-contiguous layout (column k belongs to
// group k/gs) is read as stored: the TPU kernel's interleaved layout existed
// only for Mosaic's tile repeat and has no counterpart here.
//
// What bounds it on an H100: the decode path runs it at M = 1, a GEMV over
// ~1.1 bytes per weight (codes plus 8 bytes of scale/bias per group), so it
// is bound by device-memory bandwidth (3.35 TB/s) and, at these sizes (1-6 MB
// per call), by launch latency. Design: one warp per output row n; the block's
// MT rows of x sit in shared memory as f32; each lane reads 4 codes (one
// 32-bit word) per chunk, four chunks in flight per iteration, so a warp
// streams 512 contiguous bytes of its row per iteration, fully coalesced;
// the group's scale and bias come from L1; a warp-shuffle sum ends the row.
// Larger M (the prefill) runs the same kernel over tiles of MT = 4 rows of x
// (gridDim.y), re-reading the weight from L2 once per tile. Tensor cores,
// TMA and a split over K are later work.
//
// Plain C interface for ctypes (mlx_audio_tpu_torch/ops/qmm.py). Each entry
// point launches on the given stream, never synchronises, and returns
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // output rows per block, one per warp
constexpr int UNROLL = 4;    // 4-byte code words in flight per lane
constexpr int SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int MT>
__global__ void __launch_bounds__(WARPS * 32)
qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ scales, const float* __restrict__ biases,
           const float* __restrict__ bias, T* __restrict__ y, int M, int N,
           int K, int gs) {
  extern __shared__ float xs[];  // [MT][K], f32
  const int m0 = blockIdx.y * MT;
  for (int i = threadIdx.x; i < MT * K; i += blockDim.x) {
    const int m = m0 + i / K;
    xs[i] = m < M ? to_f32(x[(size_t)m * K + (i % K)]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // no barrier follows
  const int ng = K / gs;
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(q + (size_t)n * K);
  const float* srow = scales + (size_t)n * ng;
  const float* brow = biases + (size_t)n * ng;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  // word w covers columns 4w..4w+3; gs % 4 == 0, so one group per word
  const int words = K / 4;
  for (int w0 = lane; w0 < words; w0 += 32 * UNROLL) {
    uint32_t code[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u * 32;
      code[u] = w < words ? __ldg(qrow + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u * 32;
      if (w < words) {
        const int k = 4 * w;
        const int g = k / gs;
        const float s = __ldg(srow + g);
        const float b = __ldg(brow + g);
        float wt[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wt[j] = fmaf((float)((code[u] >> (8 * j)) & 0xffu), s, b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + m * K + k);
          acc[m] = fmaf(wt[0], xv.x, acc[m]);
          acc[m] = fmaf(wt[1], xv.y, acc[m]);
          acc[m] = fmaf(wt[2], xv.z, acc[m]);
          acc[m] = fmaf(wt[3], xv.w, acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (lane == 0) {
    const float bn = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < M) y[(size_t)(m0 + m) * N + n] = from_f32<T>(acc[m] + bn);
  }
}

template <typename T, int MT>
int launch(const void* x, const void* q, const void* scales,
           const void* biases, const void* bias, void* y, int M, int N, int K,
           int gs, void* stream) {
  const size_t smem = (size_t)MT * K * sizeof(float);
  if (smem > SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + WARPS - 1) / WARPS, (M + MT - 1) / MT);
  qmm_kernel<T, MT><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scales), static_cast<const float*>(biases),
      static_cast<const float*>(bias), static_cast<T*>(y), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* q, const void* scales,
             const void* biases, const void* bias, void* y, int M, int N,
             int K, int gs, void* stream) {
  if (M == 1)
    return launch<T, 1>(x, q, scales, biases, bias, y, M, N, K, gs, stream);
  return launch<T, 4>(x, q, scales, biases, bias, y, M, N, K, gs, stream);
}

}  // namespace

extern "C" {

// Shapes are checked by the Python wrapper: M >= 1, K % gs == 0, gs % 4 == 0,
// q 4-byte aligned, 4 * K * 4 bytes of shared memory at most 227 KB.
int qmm_f32(const void* x, const void* q, const void* scales,
            const void* biases, const void* bias, void* y, int M, int N, int K,
            int gs, void* stream) {
  return dispatch<float>(x, q, scales, biases, bias, y, M, N, K, gs, stream);
}

int qmm_bf16(const void* x, const void* q, const void* scales,
             const void* biases, const void* bias, void* y, int M, int N,
             int K, int gs, void* stream) {
  return dispatch<__nv_bfloat16>(x, q, scales, biases, bias, y, M, N, K, gs,
                                 stream);
}

}  // extern "C"
