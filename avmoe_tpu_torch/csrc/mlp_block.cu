// Swin MLP sub-block for Hopper (sm_90a):
//   pre_norm  (V1): out = x + fc2(gelu(fc1(LN(x))))
//   post_norm (V2): out = x + LN(fc2(gelu(fc1(x))))
//
// Replaces the TPU kernel `_run_mlp_only` (experiments/pallas/fused_block.py
// :315, inline `kernel` :340), which does the same per token row: [V1 LN] ->
// fc1 + bias -> exact-erf GELU -> fc2 + bias -> [V2 LN] -> + residual, with
// float32 accumulation. Weights are nn.Linear layout: w1 (Hd, C), w2 (C, Hd).
//
// What bounds it on the H100. The two products do 4*R*C*Hd operations
// (Hd = 4C) on R*C*2 bytes of stream in bf16: for the Swin-V2-L stage-1
// shape (R=92160, C=192) that is about 770 operations per stream byte, so
// the tensor cores, not device memory, are the limit at every main-path
// shape (989 TFLOP/s bf16; float32 runs on the CUDA cores).
//
// What the design does about that. The bf16 products run on the tensor
// cores through WMMA (16x16x16 bf16 fragments, float32 accumulators): a
// block of 8 warps computes a 128x128 output tile from 128x32 A and B
// tiles in shared memory, each warp a 32x64 sub-tile. The bias and GELU
// are the epilogue of fc1, the bias that of fc2, so the products' outputs
// are written once. The LayerNorms and the residual add are row kernels,
// one warp per row, with float32 statistics (mean of squares minus squared
// mean, as the TPU kernel). float32 inputs take a CUDA-core tiled product
// (64x64 tiles, 4x4 outputs per thread) so that float32 stays float32.
// This first version is simple and right: there is no cp.async / TMA
// pipelining and no wgmma yet, and the hidden (R, Hd) activations make one
// round trip through device memory. Both are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace avmoe;
using namespace nvcuda;

template <int ACT>
__device__ __forceinline__ float epilogue(float acc, float b) {
  const float v = acc + b;
  return ACT ? gelu_erf(v) : v;
}

// ---------------------------------------------------------------------------
// bf16 product on the tensor cores: C[m, n] = act(sum_k A[m, k] B[n, k] + bias[n])
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kLd = kBK + 8;
constexpr int kGemmThreads = 256;

__device__ __forceinline__ void load_chunk8(bf16* dst, const bf16* __restrict__ src, int row,
                                            int rows, int k, int K, bool vec) {
  if (row < rows && vec && k + 8 <= K) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)row * K + k);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      dst[t] = (row < rows && k + t < K) ? src[(size_t)row * K + k + t] : __float2bfloat16(0.f);
  }
}

template <int ACT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
             const float* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K,
             int vec) {
  __shared__ __align__(128) bf16 As[kBM * kLd];
  __shared__ __align__(128) bf16 Bs[kBN * kLd];
  __shared__ __align__(128) float Cs[8][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;  // 4 warp rows of 32
  const int wn = warp & 1;   // 2 warp columns of 64
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int c = tid; c < kBM * kBK / 8; c += kGemmThreads) {
      const int r = c >> 2;
      const int kc = (c & 3) * 8;
      load_chunk8(As + r * kLd + kc, A, m0 + r, M, k0 + kc, K, vec);
      load_chunk8(Bs + r * kLd + kc, B, n0 + r, N, k0 + kc, K, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 64 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 32 + i * 16 + (e >> 4);
        const int gn = n0 + wn * 64 + j * 16 + (e & 15);
        if (gm < M && gn < N)
          C[(size_t)gm * N + gn] = __float2bfloat16(epilogue<ACT>(cs[e], bias[gn]));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32 product on the CUDA cores (same contract)
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

template <int ACT>
__global__ void __launch_bounds__(256)
gemm_nt_f32(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kSBK][kSBM + 4];
  __shared__ float Bs[kSBK][kSBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kSBM;
  const int n0 = blockIdx.y * kSBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSBK) {
    for (int c = tid; c < kSBM * kSBK; c += 256) {
      const int r = c / kSBK;
      const int kk = c - r * kSBK;
      const int gk = k0 + kk;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[kk][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      Bs[kk][r] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
    // per-tile partial sums, added to the running sums once per tile: the
    // rounding error then grows with K / kSBK instead of with K
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) C[(size_t)gm * N + gn] = epilogue<ACT>(acc[i][j], bias[gn]);
    }
  }
}

// ---------------------------------------------------------------------------
// Row kernels, one warp per row:
//   MODE 0: out = LN(src)            (V1 pre-norm; src = x)
//   MODE 1: out = x + src            (V1 residual; src = fc2 output)
//   MODE 2: out = x + LN(src)        (V2 post-norm + residual; src = fc2 output)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

template <typename T, int MODE>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const T* __restrict__ x, const T* __restrict__ src,
            const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ out,
            int R, int C, float eps) {
  const int row = (blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const T* s = src + (size_t)row * C;
  float mean = 0.f, inv = 1.f;
  if (MODE != 1) {
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_float(s[c]);
      sum += v;
      sq += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    mean = sum / C;
    const float var = fmaxf(sq / C - mean * mean, 0.f);
    inv = rsqrtf(var + eps);
  }
  for (int c = lane; c < C; c += 32) {
    float v = to_float(s[c]);
    if (MODE != 1) v = (v - mean) * inv * w[c] + b[c];
    if (MODE != 0) v += to_float(x[(size_t)row * C + c]);
    out[(size_t)row * C + c] = from_float<T>(v);
  }
}

template <typename T, int MODE>
int launch_rows(const void* x, const void* src, const float* w, const float* b, void* out,
                int R, int C, float eps, cudaStream_t stream) {
  const int rows_per_block = kRowThreads / 32;
  const int grid = (R + rows_per_block - 1) / rows_per_block;
  rows_kernel<T, MODE><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(src), w, b, static_cast<T*>(out), R, C,
      eps);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_gemm(int dtype, const void* A, const void* B, const float* bias, void* C, int M,
                int N, int K, cudaStream_t stream) {
  if (dtype == 1) {
    const bool vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(B) % 16 == 0);
    dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    gemm_nt_bf16<ACT><<<grid, kGemmThreads, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), bias, static_cast<bf16*>(C),
        M, N, K, vec ? 1 : 0);
  } else {
    dim3 grid((M + kSBM - 1) / kSBM, (N + kSBN - 1) / kSBN);
    gemm_nt_f32<ACT><<<grid, 256, 0, stream>>>(static_cast<const float*>(A),
                                               static_cast<const float*>(B), bias,
                                               static_cast<float*>(C), M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int mlp_block(const void* x, const float* ln_w, const float* ln_b, const void* w1,
              const float* b1, const void* w2, const float* b2, void* h_ln, void* hid,
              void* f, void* out, int R, int C, int Hd, int pre_norm, int dtype, float eps,
              cudaStream_t s) {
  int err;
  const void* a1 = x;
  if (pre_norm) {
    if ((err = launch_rows<T, 0>(x, x, ln_w, ln_b, h_ln, R, C, eps, s))) return err;
    a1 = h_ln;
  }
  if ((err = launch_gemm<1>(dtype, a1, w1, b1, hid, R, Hd, C, s))) return err;
  if ((err = launch_gemm<0>(dtype, hid, w2, b2, f, R, C, Hd, s))) return err;
  if (pre_norm) return launch_rows<T, 1>(x, f, ln_w, ln_b, out, R, C, eps, s);
  return launch_rows<T, 2>(x, f, ln_w, ln_b, out, R, C, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h_ln (R, C) is scratch for the V1
// pre-norm (may be null when pre_norm is 0), hid (R, Hd) and f (R, C) are
// scratch for the two products. Returns a cudaError_t (0 on success).
extern "C" int mlp_block_fwd(const void* x, const void* ln_w, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* h_ln, void* hid, void* f, void* out, int R, int C, int Hd,
                             int pre_norm, int dtype, float eps, void* stream) {
  if (R < 1 || C < 1 || Hd < 1 || (pre_norm && h_ln == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype == 0)
    return mlp_block<float>(x, lw, lb, w1, fb1, w2, fb2, h_ln, hid, f, out, R, C, Hd,
                            pre_norm, 0, eps, s);
  if (dtype == 1)
    return mlp_block<bf16>(x, lw, lb, w1, fb1, w2, fb2, h_ln, hid, f, out, R, C, Hd,
                           pre_norm, 1, eps, s);
  return (int)cudaErrorInvalidValue;
}
