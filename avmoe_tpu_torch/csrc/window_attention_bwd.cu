// Window-attention backward for Hopper (sm_90a): the input gradients dq, dk,
// dv of out = softmax(q k^T + bias[bw % nW]) v, the bias frozen.
//
// K1 (csrc/window_attention.cu) replaces the TPU kernel
// `fused_window_attention` (experiments/pallas/window_attn.py:55), which has
// no backward: the JAX package differentiates its XLA attention. This is the
// backward of K1's contract, for the train step whose backbones are frozen
// (the bias comes from a frozen table or CPB MLP, so no bias gradient):
//
//   P   = softmax(q k^T + bias)        recomputed in float32
//   D_i = sum_d dO_id O_id             O: the forward's output
//   dv  = P^T dO
//   dP  = dO v^T
//   dS  = P o (dP - D)
//   dq  = dS k,  dk = dS^T q
//
// q arrives already scaled (V1) or row-normalised times the logit scale
// (V2); that scaling stays in PyTorch autograd outside the kernel.
//
// What bounds it on the H100. Per (window, head) the five products do
// 10 N^2 D operations on 5 N D inputs and 3 N D outputs; with N=144, D=32 in
// bf16 that is about 70 operations per byte, under the ~295 at which the
// tensor cores set the pace, so device memory bounds it in principle. This
// first version runs the products on the CUDA cores in float32 (about
// 67 TFLOP/s at most), so the CUDA cores bound it in practice.
//
// The design. One CTA of 16 warps owns one (window, head) and holds all of
// it in shared memory as float32: k and v rows padded to D + 1 (lanes that
// walk keys hit distinct banks), q and dO, the N x N probabilities, and D.
// Four passes, separated by barriers, each one product:
//   A  rows i (a warp a row, lanes over keys): logits, softmax -> P; D_i
//   B  keys j (a warp a key, lanes over d):   dv_j = sum_i P_ij dO_i
//   C  rows i: dP_ij, dS_ij = P_ij (dP_ij - D_i) written over P; dq_i = dS_i k
//   D  keys j: dk_j = sum_i dS_ij q_i
// At N=144, D=64 that is 232,128 bytes of shared memory, one CTA per SM;
// the wrapper refuses shapes outside N <= 144, D <= 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace avmoe;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 144;
constexpr int kMaxD = 64;

size_t shared_bytes(int N, int D) {
  return sizeof(float) * (2 * (size_t)N * (D + 1) + 2 * (size_t)N * D + (size_t)N * N + N);
}

// KPL: keys a lane holds in passes A and C (N <= 32 KPL)
template <typename T, int KPL>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const T* __restrict__ out, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H,
                            int N, int D, int nW) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* Ks = smem;                     // [N][D + 1]
  float* Vs = Ks + (size_t)N * ldk;     // [N][D + 1]
  float* Qs = Vs + (size_t)N * ldk;     // [N][D]
  float* Gs = Qs + (size_t)N * D;       // dO [N][D]
  float* Ps = Gs + (size_t)N * D;       // [N][N]: P, then dS
  float* Ds = Ps + (size_t)N * N;       // [N]

  const int bh = blockIdx.x;  // bw * H + h
  const int bw = bh / H, h = bh - bw * H;
  const size_t base = (size_t)bh * N * D;
  const float* bias_h = bias + ((size_t)(bw % nW) * H + h) * N * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < N * D; e += kThreads) {
    const int n = e / D, d = e - n * D;
    Ks[n * ldk + d] = to_float(k[base + e]);
    Vs[n * ldk + d] = to_float(v[base + e]);
    Qs[e] = to_float(q[base + e]);
    Gs[e] = to_float(dout[base + e]);
  }
  __syncthreads();

  // A: P row i and D_i
  for (int i = warp; i < N; i += kWarps) {
    const float* qi = Qs + (size_t)i * D;
    float s[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) s[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qi[d];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < N) s[t] = fmaf(qd, Ks[j * ldk + d], s[t]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < N ? s[t] + bias_h[(size_t)i * N + j] : -INFINITY;
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < N ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    const float inv = 1.f / warp_sum(sum);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      if (j < N) Ps[(size_t)i * N + j] = s[t] * inv;
    }
    float dsum = 0.f;
    for (int d = lane; d < D; d += 32)
      dsum = fmaf(Gs[(size_t)i * D + d], to_float(out[base + (size_t)i * D + d]), dsum);
    dsum = warp_sum(dsum);
    if (lane == 0) Ds[i] = dsum;
  }
  __syncthreads();

  // B: dv_j = sum_i P_ij dO_i
  for (int j = warp; j < N; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(Ps[(size_t)i * N + j], Gs[(size_t)i * D + d], acc);
      dv[base + (size_t)j * D + d] = from_float<T>(acc);
    }
  }
  __syncthreads();

  // C: dS row i over P row i, then dq_i = sum_j dS_ij k_j
  for (int i = warp; i < N; i += kWarps) {
    const float* gi = Gs + (size_t)i * D;
    float dp[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) dp[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float gd = gi[d];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < N) dp[t] = fmaf(gd, Vs[j * ldk + d], dp[t]);
      }
    }
    const float Di = Ds[i];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        float* p = Ps + (size_t)i * N + j;
        *p = *p * (dp[t] - Di);
      }
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(Ps[(size_t)i * N + j], Ks[j * ldk + d], acc);
      dq[base + (size_t)i * D + d] = from_float<T>(acc);
    }
  }
  __syncthreads();

  // D: dk_j = sum_i dS_ij q_i
  for (int j = warp; j < N; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(Ps[(size_t)i * N + j], Qs[(size_t)i * D + d], acc);
      dk[base + (size_t)j * D + d] = from_float<T>(acc);
    }
  }
}

template <typename T, int KPL>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* out,
           const void* dout, void* dq, void* dk, void* dv, int BW, int H, int N, int D, int nW,
           cudaStream_t stream) {
  auto kernel = window_attention_bwd_kernel<T, KPL>;
  // the most the shapes of this instantiation take, set once
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes(std::min(32 * KPL, kMaxN), kMaxD));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<BW * H, kThreads, shared_bytes(N, D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, N, D, nW);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_n(const void* q, const void* k, const void* v, const float* bias, const void* out,
                const void* dout, void* dq, void* dk, void* dv, int BW, int H, int N, int D,
                int nW, cudaStream_t s) {
  if (N <= 32) return launch<T, 1>(q, k, v, bias, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
  if (N <= 64) return launch<T, 2>(q, k, v, bias, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
  if (N <= 96) return launch<T, 3>(q, k, v, bias, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
  return launch<T, 5>(q, k, v, bias, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of
// it; bias float32). Returns a cudaError_t (0 on success).
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* out, const void* dout,
                                    void* dq, void* dk, void* dv, int BW, int H, int N, int D,
                                    int nW, int dtype, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || D > kMaxD || nW < 1 || BW % nW != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_by_n<float>(q, k, v, b, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
  if (dtype == 1)
    return launch_by_n<bf16>(q, k, v, b, out, dout, dq, dk, dv, BW, H, N, D, nW, s);
  return (int)cudaErrorInvalidValue;
}
