// Window-attention core for Hopper (sm_90a): out = softmax(q k^T + bias) v.
//
// Replaces the TPU kernel `fused_window_attention`
// (experiments/pallas/window_attn.py:55, body `_attn_kernel` :30), with the
// same contract: q, k, v (BW, H, N, D) in float32 or bfloat16, bias
// (nW, H, N, N) float32 with the shift mask folded in, window bw reading
// bias[bw % nW]; logits, softmax and the PV sum in float32; the output in
// q's dtype.
//
// What bounds it on the H100. Per (window, head) the work is 4*N*N*D
// operations on 3*N*D inputs: with N=144, D=32 that is about 28 operations
// per input byte in bf16, under the ~295 at which the tensor cores stop
// being the limit, so the kernel is bound by device-memory bytes. The
// bytes are q, k, v and the output, read and written once, plus the bias
// (nW*H*N*N*4 bytes), which every frame of a batch reads again from L2.
//
// What the design does about that. One block of 4 warps owns one
// (window, head): it stages that head's K (row stride D+1, so lanes that
// read different keys hit different banks) and V in shared memory as
// float32, and the N x N logits never leave the SM. Each warp walks query
// rows: lanes split the keys (at most 8 per lane for N <= 256) and keep
// their logits in registers, the row max and sum are warp shuffles, the
// probabilities go through a per-warp shared row, and lanes then split D
// for the PV sum. Tails of N that are not a multiple of 32 (N=144, 36) are
// masked. The products run on the CUDA cores in float32, not on the
// tensor cores: this first version is simple and right, and a wgmma/TMA
// version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 256;
constexpr int kMaxD = 64;
constexpr int kKeysPerLane = kMaxN / 32;

using namespace avmoe;

size_t shared_bytes(int N, int D) {
  // Ks[N][D+1], Vs[N][D], per-warp q row [D] and probability row [N]
  return sizeof(float) * ((size_t)N * (D + 1) + (size_t)N * D + kWarps * (size_t)D +
                          kWarps * (size_t)N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, int H, int N, int D, int nW) {
  extern __shared__ float smem[];
  const int kstride = D + 1;
  float* Ks = smem;
  float* Vs = Ks + (size_t)N * kstride;
  float* Qs = Vs + (size_t)N * D;
  float* Ps = Qs + kWarps * D;

  const int bh = blockIdx.x;  // bw * H + h
  const int bw = bh / H;
  const int h = bh - bw * H;
  const size_t base = (size_t)bh * N * D;
  const float* bias_h = bias + ((size_t)(bw % nW) * H + h) * N * N;

  for (int i = threadIdx.x; i < N * D; i += kThreads) {
    const int n = i / D;
    const int d = i - n * D;
    Ks[n * kstride + d] = to_float(k[base + i]);
    Vs[i] = to_float(v[base + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qs = Qs + warp * D;
  float* ps = Ps + warp * N;

  for (int n = warp; n < N; n += kWarps) {
    for (int d = lane; d < D; d += 32) qs[d] = to_float(q[base + (size_t)n * D + d]);
    __syncwarp();

    const float* bias_row = bias_h + (size_t)n * N;
    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int m = lane + 32 * j;
      float logit = -INFINITY;
      if (m < N) {
        const float* kr = Ks + m * kstride;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qs[d], kr[d], acc);
        logit = acc + bias_row[m];
      }
      s[j] = logit;
      mx = fmaxf(mx, logit);
    }
    mx = warp_max(mx);

    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int m = lane + 32 * j;
      const float p = (m < N) ? expf(s[j] - mx) : 0.f;
      s[j] = p;
      sum += p;
    }
    const float inv = 1.f / warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int m = lane + 32 * j;
      if (m < N) ps[m] = s[j] * inv;
    }
    __syncwarp();

    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc = fmaf(ps[m], Vs[m * D + d], acc);
      out[base + (size_t)n * D + d] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int BW, int H, int N, int D, int nW, cudaStream_t stream) {
  const size_t smem = shared_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<T><<<BW * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), H, N, D, nW);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int BW, int H, int N,
                                    int D, int nW, int dtype, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || D > kMaxD || nW < 1 || BW % nW != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return launch<float>(q, k, v, b, out, BW, H, N, D, nW, s);
  if (dtype == 1) return launch<bf16>(q, k, v, b, out, BW, H, N, D, nW, s);
  return (int)cudaErrorInvalidValue;
}
