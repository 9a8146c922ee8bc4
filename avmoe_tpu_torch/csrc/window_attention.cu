// Window-attention core for Hopper (sm_90a): out = softmax(q k^T + bias) v.
//
// Replaces the TPU kernel `fused_window_attention`
// (experiments/pallas/window_attn.py:55, body `_attn_kernel` :30), with the
// same contract: q, k, v (BW, H, N, D) in float32 or bfloat16, bias
// (nW, H, N, N) float32 with the shift mask folded in, window bw reading
// bias[bw % nW]; logits, softmax and the sums in float32; the output in q's
// dtype.
//
// What bounds it on the H100. Per (window, head) the work is 4*N*N*D
// operations on 3*N*D inputs: with N=144, D=32 that is about 28 operations
// per input byte in bf16, far under the ~295 at which the tensor cores set
// the pace, so the kernel is bound by bytes: q, k, v and the output, read and
// written once, plus the float32 bias (nW*H*N*N*4 bytes), which every frame
// of a batch would read again from L2 (83 KB per (window, head) at N=144,
// three times the head's q, k, v and output).
//
// What the design does about that (bf16). The products run on the tensor
// cores (mma.sync m16n8k16, csrc/attention_mma.cuh): a warp owns 16 query
// rows of a head, its logits stay in registers, and the probabilities go to
// p v in registers, rounded to bf16 as the JAX package's XLA attention
// rounds them. The windows bw = c, c + nW, c + 2 nW, ... share one bias
// tile, so a block owns one (head, window class c) and a run of its windows,
// with one warp per 16-row block (9 at N=144, 4 at N=64, 3 at N=36). Each
// warp reads its rows of the bias from L2 once, straight into the
// accumulator layout, and keeps them in registers for the run; every window
// then starts its logits from them, ahead of the q k^T products. The
// windows' q, k and v (N x D bf16 each, 9 KB at 144 x 32) stream in by
// cp.async through a ring of three shared-memory buffers, two windows ahead
// of the one being computed (two buffers past N=144, where three do not
// fit). The output goes out through this warp's rows of the q buffer as
// 16-byte stores. Float32 inputs keep the CUDA-core kernel below (lanes
// split the keys of one query row, float32 FMA): the float32 checks need the
// full mantissa, which TF32 and bf16 operands do not keep.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "common.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 256;
constexpr int kMaxD = 64;
constexpr int kKeysPerLane = kMaxN / 32;

using namespace avmoe;

// ---------------------------------------------------------------------------
// float32: CUDA cores, one block of 4 warps per (window, head)
// ---------------------------------------------------------------------------

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

int launch_f32(const void* q, const void* k, const void* v, const float* bias, void* out,
               int BW, int H, int N, int D, int nW, cudaStream_t stream) {
  const size_t smem = shared_bytes(N, D);
  static size_t smem_set = 0;  // the attribute is set again only to raise it
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<float>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  window_attention_kernel<float><<<BW * H, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), H, N, D, nW);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (attention_mma.cuh). KT16: key 16-tiles the registers
// hold (N <= 16 KT16); KD: 16-wide steps of the head width (D <= 16 KD).
//
// A block owns one (head h, window class c = bw % nW), whose windows share
// one bias tile, and a run of those windows: bw = c + nW j, j0 <= j < j1.
// Warp w owns query rows 16 w .. 16 w + 15 (one warp per 16-row block) and
// keeps its rows of the bias in registers, in the accumulator layout, for
// the whole run. Shared memory: a ring of ring_buffers<KT16>() buffers of q,
// k, v, each [16 ceil(N/16)][16 KD + 8] bf16, filled by cp.async one buffer
// short of the ring ahead (three buffers up to N=144; two above, to fit).
// ---------------------------------------------------------------------------

template <int KT16> __host__ __device__ constexpr int ring_buffers() { return KT16 <= 9 ? 3 : 2; }

template <int KT16, int KD>
__global__ void __launch_bounds__(32 * KT16)
window_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            bf16* __restrict__ out, int H, int N, int D, int nW, int windows,
                            int runs, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = 16 * KD + 8, kBufs = ring_buffers<KT16>();
  const int nkt16 = (N + 15) >> 4;
  const size_t tile = (size_t)16 * nkt16 * ld;
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);  // [kBufs][q, k, v][16 nkt16][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ndt8 = (D + 7) >> 3;
  const bool vec = (D & 7) == 0;

  // block = (group, run): group = (h, c), run = windows j0 .. j1 - 1 of the class
  const int group = blockIdx.x / runs, run = blockIdx.x - group * runs;
  const int h = group / nW, c = group - h * nW;
  const int j0 = run * chunk, j1 = min(windows, j0 + chunk);
  if (j0 >= j1) return;

  // q, k, v of window j of the class into buffer b; zeros past N rows and D columns
  auto load = [&](int b, int j) {
    if (j < j1) {
      bf16* dst = bufs + (size_t)b * 3 * tile;
      const size_t base = ((size_t)(c + nW * j) * H + h) * N * D;
      const int rows = 16 * nkt16;
      if (vec) {
        const int per = rows * 2 * KD;  // 16-byte chunks of one tensor
        for (int e = threadIdx.x; e < 3 * per; e += blockDim.x) {
          const int ts = e / per, rem = e - ts * per, r = rem / (2 * KD), cc = rem - r * 2 * KD;
          const bf16* src = (ts == 0 ? q : ts == 1 ? k : v) + base;
          const bool ok = r < N && cc * 8 < D;
          cp_async16(dst + ts * tile + (size_t)r * ld + cc * 8,
                     ok ? src + (size_t)r * D + cc * 8 : src, ok);
        }
      } else {
        const int per = rows * 16 * KD;
        for (int e = threadIdx.x; e < 3 * per; e += blockDim.x) {
          const int ts = e / per, rem = e - ts * per, r = rem / (16 * KD), d = rem - r * 16 * KD;
          const bf16* src = (ts == 0 ? q : ts == 1 ? k : v) + base;
          dst[ts * tile + (size_t)r * ld + d] =
              r < N && d < D ? src[(size_t)r * D + d] : __float2bfloat16(0.f);
        }
      }
    }
    cp_async_commit();  // one group per window, empty past the run
  };

  for (int i = 0; i < kBufs - 1; ++i) load(i, j0 + i);
  // this warp's rows of the bias, once for the whole run
  float bias_r[2 * KT16][4];
  mma::load_logit_bias<2 * KT16>(bias_r, bias + ((size_t)c * H + h) * N * N, nullptr, N,
                                 16 * warp, 2 * nkt16);

  for (int j = j0; j < j1; ++j) {
    const int b = (j - j0) % kBufs;
    cp_async_wait<kBufs - 2>();
    // window j has landed, and every warp is done with window j - 1, whose
    // buffer the next load refills
    __syncthreads();
    load((j - j0 + kBufs - 1) % kBufs, j + kBufs - 1);

    bf16* Qs = bufs + (size_t)b * 3 * tile;
    const bf16* Ks = Qs + tile;
    const bf16* Vs = Ks + tile;
    float s[2 * KT16][4];
#pragma unroll
    for (int jj = 0; jj < 2 * KT16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = bias_r[jj][e];
    mma::qk_bf16<2 * KT16, KD>(s, Qs, Ks, ld, 16 * warp, nkt16);
    float inv0, inv1;
    mma::softmax_rows<2 * KT16>(s, 2 * nkt16, inv0, inv1);
    float o[2 * KD][4];
    mma::pv_bf16<2 * KT16, KD>(o, s, Vs, ld, nkt16, ndt8);

    // out, through this warp's own rows of the q buffer (its q is in registers)
    bf16* Ow = Qs + (size_t)16 * warp * ld;
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt) {
      if (dt >= ndt8) continue;
      const int col = 8 * dt + 2 * t;
      *reinterpret_cast<unsigned*>(Ow + g * ld + col) =
          mma::pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
      *reinterpret_cast<unsigned*>(Ow + (g + 8) * ld + col) =
          mma::pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
    __syncwarp();
    const int rows = min(16, N - 16 * warp);
    bf16* dst = out + ((size_t)(c + nW * j) * H + h) * N * D + (size_t)16 * warp * D;
    if (vec) {
      const int per_row = D >> 3;
      for (int e = lane; e < rows * per_row; e += 32) {
        const int r = e / per_row, cc = e - r * per_row;
        *reinterpret_cast<uint4*>(dst + (size_t)r * D + cc * 8) =
            *reinterpret_cast<const uint4*>(Ow + r * ld + cc * 8);
      }
    } else {
      for (int e = lane; e < rows * D; e += 32) dst[e] = Ow[(e / D) * ld + e % D];
    }
  }
  cp_async_wait<0>();
}

template <int KT16, int KD>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
               int BW, int H, int N, int D, int nW, cudaStream_t stream) {
  auto kernel = window_attention_mma_kernel<KT16, KD>;
  constexpr int kBufs = ring_buffers<KT16>();
  const int nkt16 = (N + 15) >> 4;
  const int threads = 32 * nkt16;
  const size_t smem = sizeof(bf16) * kBufs * 3 * 16 * nkt16 * (16 * KD + 8);
  // the kernel's shared-memory limit and the card's SMs are set and read
  // once, the blocks an SM holds once per row-block count: the forward is
  // host-bound, and these calls would run on every launch
  static int per_sm_of[KT16 + 1] = {};
  static int sms = 0;
  cudaError_t err;
  if (sms == 0) {
    const size_t most = sizeof(bf16) * kBufs * 3 * 16 * KT16 * (16 * KD + 8);
    int dev = 0, count = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)most)) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    sms = count;
  }
  if (per_sm_of[nkt16] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_of[nkt16], kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_sm = per_sm_of[nkt16];
  // (head, window class) groups, each split in runs so that one round of
  // resident blocks covers the call
  const int groups = H * nW, windows = BW / nW;
  const int resident = std::max(1, per_sm * sms);
  const int wanted = std::max(1, std::min(windows, resident / groups));
  const int chunk = (windows + wanted - 1) / wanted;
  const int runs = (windows + chunk - 1) / chunk;
  kernel<<<groups * runs, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(out), H, N, D, nW, windows, runs, chunk);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int BW, int H, int N, int D, int nW, cudaStream_t s) {
  if (D <= 32) {
    if (N <= 64) return launch_mma<4, 2>(q, k, v, bias, out, BW, H, N, D, nW, s);
    if (N <= 144) return launch_mma<9, 2>(q, k, v, bias, out, BW, H, N, D, nW, s);
    return launch_mma<16, 2>(q, k, v, bias, out, BW, H, N, D, nW, s);
  }
  if (N <= 64) return launch_mma<4, 4>(q, k, v, bias, out, BW, H, N, D, nW, s);
  if (N <= 144) return launch_mma<9, 4>(q, k, v, bias, out, BW, H, N, D, nW, s);
  return launch_mma<16, 4>(q, k, v, bias, out, BW, H, N, D, nW, s);
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
  if (dtype == 0) return launch_f32(q, k, v, b, out, BW, H, N, D, nW, s);
  if (dtype == 1) return launch_bf16(q, k, v, b, out, BW, H, N, D, nW, s);
  return (int)cudaErrorInvalidValue;
}
