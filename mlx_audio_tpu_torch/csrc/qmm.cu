// Fused dequantize + matmul for affine group-quantized weights (K2).
//
// Replaces the Pallas TPU kernel `qmm_pallas` (mlx_audio_tpu/ops/qmm_pallas.py,
// `_qmm_kernel` :24-39, pallas_call :82). Contract, as there:
//
//     y[m, n] = sum_k x[m, k] * (scales[n, k/gs] * q[n, k] + biases[n, k/gs])
//               [+ bias[n]]
//
// x (M, K) f32 or bf16; q uint8 (N, K), one code per byte at 8 or 4 bits;
// scales, biases f32 (N, K/gs); bias f32 (N) or null. Products are exact
// and summed in f32, and y is rounded once to x's dtype. The grouped-
// contiguous layout (column k belongs to group k/gs) is read as stored: the
// TPU kernel's interleaved layout existed only for Mosaic's tile repeat.
//
// Three paths; ops/qmm.py picks one by a static rule on (dtype, M, gs).
//
// gemv (M = 1, the decode step). A GEMV over ~1.1 bytes per weight, bound
// by device-memory bandwidth (3.35 TB/s) and, at 1-6 MB a call, by how many
// bytes are in flight: one DRAM round trip is ~1 us, so each SM must keep
// ~20 KB requested. Each lane loads 16-byte code vectors (16 codes of one
// group, so one scale and one bias per vector), GEMV_VEC of them in flight;
// `ksplit` warps share a row, each summing a strided slice of its vectors,
// so a 1,024-row weight still gives 2-4 blocks per SM; the warps' partial
// sums are added in shared memory in a fixed order (deterministic). Each
// lane reads the 16 x values of a vector itself, through L1 (x is 2-12 KB
// and every warp of the block reads it), so no barrier holds back the first
// code loads.
//
// mma (bf16 x, M > 1: the prefill, text_projection, the code predictor's
// first sub-step). Weight rows fill the MMA's M slot and tokens its N slot
// (A and B swapped), so a block that owns 64 weight rows reads them once
// for up to 64 tokens. Codes 0-255 are exact in bf16: they are converted in
// registers (byte permute into 2^23 + c, subtract, pack) and multiplied
// with bf16 x on the tensor cores (mma.sync m16n8k16, f32 accumulators).
// The affine part stays out of the inner loop:
//     y[m,n] = sum_g s[n,g] * (sum_{k in g} x[m,k] q[n,k])
//            + sum_g b[n,g] * (sum_{k in g} x[m,k])  + bias[n]
// Each group's integer-code product goes into a fresh fragment, folded
// with s[n,g] at the group's end; the group sums of x come from the same
// bf16 B fragments (f32 adds and two warp shuffles). Within each k16 step
// the k order is permuted (lane t takes columns 4t..4t+3 as the fragment's
// 2t, 2t+1, 2t+8, 2t+9, for A and B alike), so a lane reads one 32-bit word
// of codes per row and one 64-bit word of x per token. Codes, x and the
// stage's scales and biases stream through a ring of shared-memory stages
// with cp.async (zero-filled past N, M and K); rows are XOR-swizzled so
// every fragment read is free of bank conflicts. K is split across blocks
// (gridDim.z, on group boundaries) when the (N/64, M/64) grid alone would
// leave SMs idle; a second kernel then adds the f32 partials in a fixed
// order, adds the bias and rounds.
//
// simt (the first design; f32 x at M > 1, and any gs not a multiple of 16).
// One warp per output row, x tile of MT rows in shared memory as f32, four
// 4-byte code words per lane in flight; M > 1 runs over tiles of MT = 4 rows
// of x, re-reading the weight once per tile. It keeps the f32 contract
// exact, which the bf16 tensor cores cannot.
//
// Plain C interface for ctypes (mlx_audio_tpu_torch/ops/qmm.py). qmm_init
// sets the dynamic shared-memory limits once per device; each other entry
// point launches on the given stream, never synchronises, and returns
// cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;      // simt and gemv: warps per block
constexpr int UNROLL = 4;     // simt: 4-byte code words in flight per lane
constexpr int GEMV_VEC = 4;   // gemv: 16-byte code vectors in flight per lane
constexpr int MMA_WARPS = 4;  // mma: each warp owns 16 weight rows
constexpr int BN = 16 * MMA_WARPS;  // mma: weight rows per block
constexpr int KS = 64;              // mma: k columns per pipeline stage
constexpr int MAX_SMEM = 227 * 1024;

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

// code byte J of w as an exact f32: 0x4b0000cc is 2^23 + c
template <int J>
__device__ __forceinline__ float code_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540u | J)) -
         8388608.f;
}

// ---------------------------------------------------------------------------
// simt: one warp per output row, row tiles of x
// ---------------------------------------------------------------------------

template <typename T, int MT>
__global__ void __launch_bounds__(WARPS * 32)
simt_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
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
int launch_simt(const void* x, const void* q, const void* scales,
                const void* biases, const void* bias, void* y, int M, int N,
                int K, int gs, void* stream) {
  const size_t smem = (size_t)MT * K * sizeof(float);
  dim3 grid((N + WARPS - 1) / WARPS, (M + MT - 1) / MT);
  simt_kernel<T, MT><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scales), static_cast<const float*>(biases),
      static_cast<const float*>(bias), static_cast<T*>(y), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename T>
int simt(const void* x, const void* q, const void* scales, const void* biases,
         const void* bias, void* y, int M, int N, int K, int gs,
         void* stream) {
  if (M == 1)
    return launch_simt<T, 1>(x, q, scales, biases, bias, y, M, N, K, gs,
                             stream);
  return launch_simt<T, 4>(x, q, scales, biases, bias, y, M, N, K, gs, stream);
}

// ---------------------------------------------------------------------------
// gemv: M = 1, 16-byte code vectors, K split across the warps of a block
// ---------------------------------------------------------------------------

// the 16 values x[16v .. 16v+15] as f32, read through L1 (every warp of
// the block reads the same x)
__device__ __forceinline__ void load_x16(const float* x, int v, float (&o)[16]) {
  const float4* p = reinterpret_cast<const float4*>(x) + 4 * v;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(p + i);
    o[4 * i] = f.x;
    o[4 * i + 1] = f.y;
    o[4 * i + 2] = f.z;
    o[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, int v,
                                         float (&o)[16]) {
  const uint4* p = reinterpret_cast<const uint4*>(x) + 2 * v;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 h = __ldg(p + i);
    const uint32_t w[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      o[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ scales, const float* __restrict__ biases,
            const float* __restrict__ bias, T* __restrict__ y, int N, int K,
            int gs, int ksplit) {
  __shared__ float part[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = WARPS / ksplit;
  const int n = blockIdx.x * rows + warp / ksplit;
  const int slice = warp % ksplit;
  float acc = 0.f;
  if (n < N) {
    const int ng = K / gs;
    const uint4* qrow = reinterpret_cast<const uint4*>(q + (size_t)n * K);
    const float* srow = scales + (size_t)n * ng;
    const float* brow = biases + (size_t)n * ng;
    const int vecs = K / 16;
    const int stride = ksplit * 32;
    for (int v0 = slice * 32 + lane; v0 < vecs; v0 += stride * GEMV_VEC) {
      uint4 code[GEMV_VEC];
      float s[GEMV_VEC], b[GEMV_VEC];
#pragma unroll
      for (int u = 0; u < GEMV_VEC; ++u) {
        const int v = v0 + u * stride;
        if (v < vecs) {
          code[u] = __ldg(qrow + v);
          const int g = 16 * v / gs;  // gs % 16 == 0: one group per vector
          s[u] = __ldg(srow + g);
          b[u] = __ldg(brow + g);
        }
      }
#pragma unroll
      for (int u = 0; u < GEMV_VEC; ++u) {
        const int v = v0 + u * stride;
        if (v < vecs) {
          float xv[16];
          load_x16(x, v, xv);
          const uint32_t w[4] = {code[u].x, code[u].y, code[u].z, code[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc = fmaf(fmaf(code_f32<0>(w[i]), s[u], b[u]), xv[4 * i], acc);
            acc = fmaf(fmaf(code_f32<1>(w[i]), s[u], b[u]), xv[4 * i + 1],
                       acc);
            acc = fmaf(fmaf(code_f32<2>(w[i]), s[u], b[u]), xv[4 * i + 2],
                       acc);
            acc = fmaf(fmaf(code_f32<3>(w[i]), s[u], b[u]), xv[4 * i + 3],
                       acc);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const int nr = blockIdx.x * rows + threadIdx.x;
    if (nr < N) {
      float sum = 0.f;
      for (int j = 0; j < ksplit; ++j) sum += part[threadIdx.x * ksplit + j];
      if (bias != nullptr) sum += bias[nr];
      y[nr] = from_f32<T>(sum);
    }
  }
}

template <typename T>
int gemv(const void* x, const void* q, const void* scales, const void* biases,
         const void* bias, void* y, int N, int K, int gs, int ksplit,
         void* stream) {
  if (ksplit < 1 || ksplit > WARPS || WARPS % ksplit)
    return (int)cudaErrorInvalidValue;
  const int rows = WARPS / ksplit;
  dim3 grid((N + rows - 1) / rows);
  gemv_kernel<T><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scales), static_cast<const float*>(biases),
      static_cast<const float*>(bias), static_cast<T*>(y), N, K, gs, ksplit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mma: bf16 x, tensor cores, weight rows in the MMA's M slot
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: 8-token MMA tiles per block (block tile BM = 8 * NT tokens);
// GPS: groups per 64-column stage (4 at gs 16, 2 at gs 32, 1 at gs % 64 == 0)
template <int NT, int GPS>
__global__ void __launch_bounds__(MMA_WARPS * 32)
mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ scales, const float* __restrict__ biases,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
           float* __restrict__ ws, int M, int N, int K, int gs,
           int units_per_split) {
  constexpr int BM = 8 * NT;
  constexpr int STAGES = NT >= 8 ? 3 : 4;  // static shared memory <= 48 KB
  constexpr int SPG = 4 / GPS;             // k16 steps per group per stage
  __shared__ __align__(16) uint8_t qs[STAGES][BN * KS];
  __shared__ __align__(16) __nv_bfloat16 xsm[STAGES][BM * KS];
  __shared__ float sc[STAGES][GPS][2][BN];  // [.][group][scale, bias][row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ng = K / gs;
  // a split covers whole stages and whole groups
  const int unit = gs > KS ? gs : KS;
  const int k_begin = blockIdx.z * units_per_split * unit;
  const int k_end = min(K, k_begin + units_per_split * unit);
  const int nst = (k_end - k_begin + KS - 1) / KS;

  auto load_stage = [&](int st, int slot) {
    const int k0 = k_begin + st * KS;
    // codes: BN rows x four 16-byte chunks; chunk c of row r is stored at
    // c ^ ((r >> 1) & 3)
    for (int c = tid; c < BN * 4; c += MMA_WARPS * 32) {
      const int r = c >> 2, ch = c & 3;
      const int n = n0 + r, k = k0 + 16 * ch;
      const bool ok = n < N && k < k_end;
      cp_async(&qs[slot][r * KS + ((ch ^ ((r >> 1) & 3)) << 4)],
               ok ? q + (size_t)n * K + k : q, 16, ok ? 16 : 0);
    }
    // x: BM rows x eight 16-byte chunks; chunk c of row r at c ^ 2(r & 3)
    for (int c = tid; c < BM * 8; c += MMA_WARPS * 32) {
      const int r = c >> 3, ch = c & 7;
      const int m = m0 + r, k = k0 + 8 * ch;
      const bool ok = m < M && k < k_end;
      cp_async(&xsm[slot][r * KS + ((ch ^ ((r & 3) << 1)) << 3)],
               ok ? x + (size_t)m * K + k : x, 16, ok ? 16 : 0);
    }
    // the scales and biases of the stage's groups
    for (int c = tid; c < GPS * 2 * BN; c += MMA_WARPS * 32) {
      const int r = c % BN, sb = (c / BN) & 1, g = c / (2 * BN);
      const int n = n0 + r, kg = k0 + g * (KS / GPS);
      const bool ok = n < N && kg < k_end;
      const float* src = (sb ? biases : scales) + (size_t)n * ng + kg / gs;
      cp_async(&sc[slot][g][sb][r], ok ? src : scales, 4, ok ? 4 : 0);
    }
  };

  float acc[NT][4], accg[NT][4], xg[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xg[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = accg[j][i] = 0.f;
  }

  const int ra = warp * 16 + (lane >> 2);  // rows ra, ra + 8 of the tile
  const int swz = (ra >> 1) & 3;           // the same for ra + 8

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; slot (it - 1) % STAGES is free
    if (it + STAGES - 1 < nst)
      load_stage(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();

    const int slot = it % STAGES;
    const uint8_t* qsl = qs[slot];
    const __nv_bfloat16* xsl = xsm[slot];
    const bool group_ends =
        GPS > 1 || (k_begin + (it + 1) * KS) % gs == 0 || it == nst - 1;
#pragma unroll
    for (int g = 0; g < GPS; ++g) {
#pragma unroll
      for (int ss = 0; ss < SPG; ++ss) {
        const int s = g * SPG + ss;  // k16 step within the stage
        const int off = ((s ^ swz) << 4) + 4 * t;
        const uint32_t wa = *reinterpret_cast<const uint32_t*>(
            qsl + ra * KS + off);
        const uint32_t wb = *reinterpret_cast<const uint32_t*>(
            qsl + (ra + 8) * KS + off);
        // codes at columns 4t..4t+3 as the fragment's k = 2t, 2t+1, 2t+8,
        // 2t+9
        const uint32_t a[4] = {pack_bf16(code_f32<0>(wa), code_f32<1>(wa)),
                               pack_bf16(code_f32<0>(wb), code_f32<1>(wb)),
                               pack_bf16(code_f32<2>(wa), code_f32<3>(wa)),
                               pack_bf16(code_f32<2>(wb), code_f32<3>(wb))};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = 8 * j + (lane >> 2);  // token row of the B fragment
          const int ch = (2 * s + (t >> 1)) ^ ((r & 3) << 1);
          const uint2 bv = *reinterpret_cast<const uint2*>(
              xsl + r * KS + 8 * ch + 4 * (t & 1));
          mma_bf16(accg[j], a, bv.x, bv.y);
          xg[j] += (bf16_lo(bv.x) + bf16_hi(bv.x)) +
                   (bf16_lo(bv.y) + bf16_hi(bv.y));
        }
      }
      if (group_ends) {
        const float sa = sc[slot][g][0][ra], sb8 = sc[slot][g][0][ra + 8];
        const float ba = sc[slot][g][1][ra], bb8 = sc[slot][g][1][ra + 8];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // the group sum of x for token row 8j + lane/4, then for the
          // accumulator's tokens 8j + 2t and 8j + 2t + 1
          float xsum = xg[j];
          xsum += __shfl_xor_sync(0xffffffffu, xsum, 1);
          xsum += __shfl_xor_sync(0xffffffffu, xsum, 2);
          const float x0 = __shfl_sync(0xffffffffu, xsum, 8 * t);
          const float x1 = __shfl_sync(0xffffffffu, xsum, 8 * t + 4);
          acc[j][0] = fmaf(sa, accg[j][0], fmaf(ba, x0, acc[j][0]));
          acc[j][1] = fmaf(sa, accg[j][1], fmaf(ba, x1, acc[j][1]));
          acc[j][2] = fmaf(sb8, accg[j][2], fmaf(bb8, x0, acc[j][2]));
          acc[j][3] = fmaf(sb8, accg[j][3], fmaf(bb8, x1, acc[j][3]));
          xg[j] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) accg[j][i] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator i of tile j: weight row ra + 8 (i >> 1), token 8j + 2t + (i & 1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ra + 8 * (i >> 1);
      const int m = m0 + 8 * j + 2 * t + (i & 1);
      if (n < N && m < M) {
        if (ws != nullptr) {
          ws[((size_t)blockIdx.z * M + m) * N + n] = acc[j][i];
        } else {
          const float v = acc[j][i] + (bias != nullptr ? bias[n] : 0.f);
          y[(size_t)m * N + n] = __float2bfloat16(v);
        }
      }
    }
  }
}

// sum the splits' partials in order, add the bias, round once
__global__ void reduce_kernel(const float* __restrict__ ws,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ y, int splits, int M,
                              int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  if (bias != nullptr) s += bias[i % N];
  y[i] = __float2bfloat16(s);
}

template <int NT, int GPS>
int launch_mma(const void* x, const void* q, const void* scales,
               const void* biases, const void* bias, void* y, void* ws, int M,
               int N, int K, int gs, int splits, void* stream) {
  const int unit = gs > KS ? gs : KS;
  const int units = (K + unit - 1) / unit;
  const int per_split = (units + splits - 1) / splits;
  if (splits < 1 || (splits > 1 && ws == nullptr) ||
      (per_split * (splits - 1) >= units))
    return (int)cudaErrorInvalidValue;  // every split must own a stage
  dim3 grid((N + BN - 1) / BN, (M + 8 * NT - 1) / (8 * NT), splits);
  mma_kernel<NT, GPS><<<grid, MMA_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scales), static_cast<const float*>(biases),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, gs, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0,
                  (cudaStream_t)stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), splits, M, N);
  return (int)cudaGetLastError();
}

template <int NT>
int mma_gs(const void* x, const void* q, const void* scales,
           const void* biases, const void* bias, void* y, void* ws, int M,
           int N, int K, int gs, int splits, void* stream) {
  if (gs == 16)
    return launch_mma<NT, 4>(x, q, scales, biases, bias, y, ws, M, N, K, gs,
                             splits, stream);
  if (gs == 32)
    return launch_mma<NT, 2>(x, q, scales, biases, bias, y, ws, M, N, K, gs,
                             splits, stream);
  if (gs % KS == 0)
    return launch_mma<NT, 1>(x, q, scales, biases, bias, y, ws, M, N, K, gs,
                             splits, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Fn>
cudaError_t allow_smem(Fn* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MAX_SMEM);
}

}  // namespace

extern "C" {

// Once per device, before the first launch: lets the simt kernel take up to
// 227 KB of dynamic shared memory (its tile of x as f32).
int qmm_init(void) {
  cudaError_t err;
  if ((err = allow_smem(simt_kernel<float, 1>)) != cudaSuccess ||
      (err = allow_smem(simt_kernel<float, 4>)) != cudaSuccess ||
      (err = allow_smem(simt_kernel<__nv_bfloat16, 1>)) != cudaSuccess ||
      (err = allow_smem(simt_kernel<__nv_bfloat16, 4>)) != cudaSuccess)
    return (int)err;
  return 0;
}

// Shapes are checked by the Python wrapper. simt: M >= 1, K % gs == 0,
// gs % 4 == 0, q 4-byte aligned, MT * K * 4 bytes of shared memory at most
// 227 KB (MT = 1 at M = 1, else 4).
int qmm_simt_f32(const void* x, const void* q, const void* scales,
                 const void* biases, const void* bias, void* y, int M, int N,
                 int K, int gs, void* stream) {
  return simt<float>(x, q, scales, biases, bias, y, M, N, K, gs, stream);
}

int qmm_simt_bf16(const void* x, const void* q, const void* scales,
                  const void* biases, const void* bias, void* y, int M, int N,
                  int K, int gs, void* stream) {
  return simt<__nv_bfloat16>(x, q, scales, biases, bias, y, M, N, K, gs,
                             stream);
}

// gemv: M = 1, gs % 16 == 0, x and q 16-byte aligned; ksplit in {1, 2, 4, 8} warps per output row.
int qmm_gemv_f32(const void* x, const void* q, const void* scales,
                 const void* biases, const void* bias, void* y, int N, int K,
                 int gs, int ksplit, void* stream) {
  return gemv<float>(x, q, scales, biases, bias, y, N, K, gs, ksplit, stream);
}

int qmm_gemv_bf16(const void* x, const void* q, const void* scales,
                  const void* biases, const void* bias, void* y, int N, int K,
                  int gs, int ksplit, void* stream) {
  return gemv<__nv_bfloat16>(x, q, scales, biases, bias, y, N, K, gs, ksplit,
                             stream);
}

// mma: bf16 x, gs in {16, 32} or a multiple of 64, x and q 16-byte
// aligned; K split into `splits` ranges of whole groups and stages, each
// non-empty; ws holds splits * M * N f32 when splits > 1.
int qmm_mma_bf16(const void* x, const void* q, const void* scales,
                 const void* biases, const void* bias, void* y, void* ws,
                 int M, int N, int K, int gs, int splits, void* stream) {
  if (M <= 8)
    return mma_gs<1>(x, q, scales, biases, bias, y, ws, M, N, K, gs, splits,
                     stream);
  if (M <= 16)
    return mma_gs<2>(x, q, scales, biases, bias, y, ws, M, N, K, gs, splits,
                     stream);
  if (M <= 32)
    return mma_gs<4>(x, q, scales, biases, bias, y, ws, M, N, K, gs, splits,
                     stream);
  return mma_gs<8>(x, q, scales, biases, bias, y, ws, M, N, K, gs, splits,
                   stream);
}

}  // extern "C"
