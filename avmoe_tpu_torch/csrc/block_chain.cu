// K3 for Hopper (sm_90a): K consecutive Swin blocks of one (window, shift)
// over windowed tokens (G, N, C), in ONE launch per chain call.
//
// Replaces the TPU kernel `fused_block_chain`
// (experiments/pallas/fused_block.py:237; body `_chain_kernel` :191,
// `_attn_sub` :121, `_mlp_sub` :176), with its arithmetic: qkv is float32
// through the V2 cosine normalisation (t * rsqrt(max(|t|^2, 1e-24)));
// logits, softmax and every product sum are float32; LayerNorm statistics
// are float32 (mean of squares minus squared mean); the shift mask is the
// (nW, N, N) table of -100 / 0. Version 'v1' is pre-norm (HTS-AT), 'v2'
// post-norm cosine attention (Swin-V2). `full` runs both sub-blocks of every
// block, otherwise the attention sub-block only (the MLP-only part is K2,
// csrc/mlp_block.cu).
//
// Rounding in bf16. This kernel rounds to bf16 only the A operands of its
// tensor-core products (the [V1 norm] input of qkv and fc1, each head's p v
// before proj, GELU(fc1) before fc2) and the chain's output. The residual
// stream stays float32 in scratch from the first sub-block to the last, and
// attention keeps q, k, v and p float32, as K1 does. The Pallas body rounds
// the stream after every sub-block and q, k, v, p, fc1 + bias and the norm
// outputs as well. On seeded Swin-V2 stage-2 / stage-3 chains (K=2),
// chip_smoke.py measures this kernel at about 2.5e-2 (1 + |ref|) from the
// float32 result and the Pallas rounding (the plain version in bf16) at 7e-2
// to 8.5e-2: cosine attention scales q.k by up to 100, and the V2 post-norm
// rescales every sub-block's output to unit size.
//
// What bounds it on the H100. Per window and block the products do
// 2 N (4 C^2 + 8 C^2) operations on N C stream elements: at N=144 that is
// ~1700 operations per stream byte, so the tensor cores bound it, not device
// memory (989 TFLOP/s bf16; float32 runs on the CUDA cores). The weights,
// 12 C^2 elements a block (14 MB in bf16 at C=768), come from L2.
//
// What the design does about that. Windows are independent through the
// whole chain, so one thread-block CLUSTER of `cs` CTAs owns one window for
// all K blocks and both sub-blocks. `cs` (1 to 8) is picked at launch from
// the clusters the card holds at once (cudaOccupancyMaxActiveClusters) and
// how evenly each phase's tiles and heads split, so that a few windows (40
// at batch 4 in Swin-V2 stages 2 and 3) still fill the card in one round. A
// phase that needs all of a window's rows or heads (LayerNorm rows,
// attention heads, the next product's A operand) starts after a cluster
// barrier, never after a second launch. Inside a phase the cluster's CTAs
// split the work: a product's 128-column output tiles (each holds all N
// rows of the window), the attention heads, the token rows. Products in
// bf16 run on the tensor cores through WMMA (16x16x16, float32
// accumulators) from a 4-stage cp.async ring of shared-memory tiles; float32
// products run on the CUDA cores. Attention runs on the CUDA cores in
// float32, one (window, head) at a time with K and V in shared memory and
// four query rows per warp pass. A window's activations do not fit one SM's 227 KB (144 x 768
// bf16 is 221 KB), so they live in device-memory scratch that the wrapper
// allocates (mostly L2-resident); data another CTA wrote is read through L2
// (cp.async.cg, ld.global.cg), after a __threadfence and the cluster
// barrier. Two CTAs fit an SM (128 registers a thread).
//
// Where its time goes (tools/k3_phase_ablation.py times it with each phase
// removed): the products at Swin-V2 stages 1 to 3 and HTS-AT, the CUDA-core
// attention at Swin-V2 stage 0. A weight tile is read once per window, so
// at 36-token windows (Swin-V2 stage 3) the products stream each block's
// weights G times a call (40 at batch 4). Later work: wgmma + TMA, several
// windows per cluster where N is small, tensor-core attention, the hidden
// activations kept on chip.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

using namespace avmoe;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 144;                     // window tokens (12 x 12)
constexpr int kMaxFr = kMaxN / 16;             // 16-row fragments of a product tile
constexpr int kMaxD = 64;                      // head width
constexpr int kKeysPerLane = (kMaxN + 31) / 32;
constexpr int kBN = 128;                       // output columns of a product tile
constexpr int kBK = 32;                        // bf16 product: depth of a stage
constexpr int kStages = 4;                     // bf16 product: stages in flight
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBN + 8;
constexpr int kFK = 16;                        // float32 product: depth of a stage
constexpr int kFLdA = kFK + 1;
constexpr int kFLdB = kBN + 4;

// Epilogues of a product: out = acc + bias as float32, or GELU(acc + bias)
// rounded to T.
constexpr int kEpiF32 = 0, kEpiGelu = 1;

struct Params {
  const void* x;          // (G, N, C) windowed input
  void* out;              // (G, N, C) output
  const void* n1s;        // (K, C) norm1 scale / bias
  const void* n1b;
  const void* qkvk;       // (K, C, 3C)
  const void* qkvb;       // (K, 3C)
  const float* lsc;       // (K, nH) clamped exp logit scale (V2)
  const void* projk;      // (K, nH, D, C) = (K, C, C)
  const void* projb;      // (K, C)
  const void* n2s;        // (K, C)
  const void* n2b;
  const void* fc1k;       // (K, C, Hd)
  const void* fc1b;       // (K, Hd)
  const void* fc2k;       // (K, Hd, C)
  const void* fc2b;       // (K, C)
  const float* bias;      // (K, nH, N, N) position bias
  const float* mask;      // (nW, N, N) shift mask
  void* h;                // scratch (G, N, C): [V1 norm](stream), A of qkv and fc1
  float* qkv;             // scratch (G, N, 3C) float32
  void* o;                // scratch (G, N, C): heads' p v, concatenated, A of proj
  float* a;               // scratch (G, N, C) float32: proj / fc2 output
  void* hid;              // scratch (G, N, Hd): GELU(fc1), A of fc2
  float* xs;              // scratch (G, N, C) float32: the residual stream
  int G, N, C, nH, Hd, K, nW, v2, full, shifted, cs;
  float eps;
};

// loads of data another CTA of the cluster wrote: through L2, never a stale L1 line
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }

// Every CTA of the cluster has finished the phase and its writes are visible.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

template <int EPI, typename T>
__device__ __forceinline__ void store_epi(void* out, size_t idx, float v) {
  if (EPI == kEpiF32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<T*>(out)[idx] = from_float<T>(gelu_erf(v));
}

// ---------------------------------------------------------------------------
// Products of one window: out[r, n] = epi(sum_k A[r, k] W[k, n] + bias[n]),
// r < M (all rows of the window in one tile), n < Nout split in 128-column
// tiles over the cluster's CTAs. A (M, Kd) and W (Kd, Nout) are row-major.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI>
__device__ void gemm_bf16(const bf16* A, int M, int Kd, const bf16* W, int Nout,
                          const bf16* bias, void* out, int rank, int cs, unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);                            // [kStages][kMaxN][kLdA]
  bf16* Bs = As + kStages * kMaxN * kLdA;                              // [kStages][kBK][kLdB]
  float* stage = reinterpret_cast<float*>(Bs + kStages * kBK * kLdB);  // [kWarps][16 * 16]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nfr = (M + 15) >> 4;
  const int ntiles = (Nout + kBN - 1) / kBN;
  const int nk = (Kd + kBK - 1) / kBK;
  float* st = stage + warp * 256;

  for (int t = rank; t < ntiles; t += cs) {
    const int n0 = t * kBN;
    const bool active = n0 + warp * 16 < Nout;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFr];
#pragma unroll
    for (int i = 0; i < kMaxFr; ++i) wmma::fill_fragment(acc[i], 0.f);

    auto load = [&](int buf, int k0) {
      bf16* as = As + buf * kMaxN * kLdA;
      bf16* bs = Bs + buf * kBK * kLdB;
      for (int c = tid; c < nfr * 16 * (kBK / 8); c += kThreads) {
        const int r = c >> 2, kc = (c & 3) * 8;
        const bool ok = r < M && k0 + kc < Kd;
        cp_async16(as + r * kLdA + kc, ok ? A + (size_t)r * Kd + k0 + kc : A, ok);
      }
      for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
        const int r = c >> 4, nc = (c & 15) * 8;
        const bool ok = k0 + r < Kd && n0 + nc < Nout;
        cp_async16(bs + r * kLdB + nc, ok ? W + (size_t)(k0 + r) * Nout + n0 + nc : W, ok);
      }
      cp_async_commit();
    };

    // kStages - 1 stages in flight ahead of the one in use; a group is
    // committed for every stage, empty past the end, so that the count of
    // pending groups says which stage has landed
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s * kBK);
      else cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      // stage kt has landed, and every warp is done with stage kt - 1, whose
      // buffer the next load refills
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < nk) load(next % kStages, next * kBK);
      else cp_async_commit();
      const bf16* as = As + (kt % kStages) * kMaxN * kLdA;
      const bf16* bs = Bs + (kt % kStages) * kBK * kLdB;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, bs + kk * kLdB + warp * 16, kLdB);
#pragma unroll
          for (int i = 0; i < kMaxFr; ++i) {
            if (i < nfr) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
              wmma::load_matrix_sync(a, as + i * 16 * kLdA + kk, kLdA);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile's loads refill every buffer

    if (active) {
#pragma unroll
      for (int i = 0; i < kMaxFr; ++i) {
        if (i < nfr) {
          wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = i * 16 + (e >> 4);
            const int n = n0 + warp * 16 + (e & 15);
            if (r < M && n < Nout)
              store_epi<EPI, bf16>(out, (size_t)r * Nout + n, st[e] + to_float(bias[n]));
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int EPI>
__device__ void gemm_f32(const float* A, int M, int Kd, const float* W, int Nout,
                         const float* bias, void* out, int rank, int cs, unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);  // [kMaxN][kFLdA]
  float* Bs = As + kMaxN * kFLdA;              // [kFK][kFLdB]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nfr = (M + 15) >> 4;
  const int ntiles = (Nout + kBN - 1) / kBN;

  for (int t = rank; t < ntiles; t += cs) {
    const int n0 = t * kBN;
    float acc[kMaxFr][8];
#pragma unroll
    for (int i = 0; i < kMaxFr; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < Kd; k0 += kFK) {
      for (int c = tid; c < nfr * 16 * kFK; c += kThreads) {
        const int r = c / kFK, kk = c - r * kFK;
        As[r * kFLdA + kk] = (r < M && k0 + kk < Kd) ? ld_l2(A + (size_t)r * Kd + k0 + kk) : 0.f;
      }
      for (int c = tid; c < kFK * kBN; c += kThreads) {
        const int kk = c / kBN, n = c - kk * kBN;
        Bs[kk * kFLdB + n] =
            (k0 + kk < Kd && n0 + n < Nout) ? __ldg(W + (size_t)(k0 + kk) * Nout + n0 + n) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * kFLdB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMaxFr; ++i) {
          if (i < nfr) {
            const float a = As[(ty + 16 * i) * kFLdA + kk];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kMaxFr; ++i) {
      const int r = ty + 16 * i;
      if (i < nfr && r < M) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < Nout) store_epi<EPI, float>(out, (size_t)r * Nout + n, acc[i][j] + bias[n]);
        }
      }
    }
  }
}

template <typename T, int EPI>
__device__ __forceinline__ void gemm(const T* A, int M, int Kd, const T* W, int Nout,
                                     const T* bias, void* out, int rank, int cs,
                                     unsigned char* smem) {
  if constexpr (std::is_same<T, bf16>::value)
    gemm_bf16<EPI>(A, M, Kd, W, Nout, bias, out, rank, cs, smem);
  else
    gemm_f32<EPI>(A, M, Kd, W, Nout, bias, out, rank, cs, smem);
}

// ---------------------------------------------------------------------------
// Token rows of one window, one warp per row, rows split over the cluster:
//   xs  = (x_in ? x_in : xs) + (delta ? (post_w ? LN_post(delta) : delta) : 0)
//   h   = ln_w ? LN(xs) : xs, rounded to T      (when h is given)
//   out = xs rounded to T                       (when out is given)
// A row is always handled by the same warp and each element by the same
// lane, so xs is read back only by the lane that wrote it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void row_stats(const float* row, int C, float eps, float& mean,
                                          float& inv) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = ld_l2(row + c);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mean = sum / C;
  inv = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
}

template <typename T>
__device__ void rows_phase(const Params& p, int rank, const T* x_in, float* xs,
                           const float* delta, const T* post_w, const T* post_b,
                           const T* ln_w, const T* ln_b, T* h, T* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C;
  for (int r = rank * kWarps + warp; r < p.N; r += p.cs * kWarps) {
    const size_t base = (size_t)r * C;
    float dm = 0.f, dinv = 1.f;
    if (post_w) row_stats(delta + base, C, p.eps, dm, dinv);
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = x_in ? to_float(x_in[base + c]) : xs[base + c];
      if (delta) {
        const float d = ld_l2(delta + base + c);
        v += post_w ? (d - dm) * dinv * to_float(post_w[c]) + to_float(post_b[c]) : d;
      }
      xs[base + c] = v;
      if (out) out[base + c] = from_float<T>(v);
      if (h && !ln_w) h[base + c] = from_float<T>(v);
      sum += v;
      sq += v * v;
    }
    if (h && ln_w) {
      const float mean = warp_sum(sum) / C;
      const float inv = rsqrtf(fmaxf(warp_sum(sq) / C - mean * mean, 0.f) + p.eps);
      for (int c = lane; c < C; c += 32)
        h[base + c] = from_float<T>((xs[base + c] - mean) * inv * to_float(ln_w[c]) +
                                    to_float(ln_b[c]));
    }
  }
}

// ---------------------------------------------------------------------------
// Attention of one window, block k: heads split over the cluster's CTAs.
// o[n, h*D + d] = sum_m softmax_m(q_n . k_m + bias + mask) v_m in float32, stored as T.
// K is stored transposed with row stride N + 1 (lane m reads key m, conflict
// free); each warp pass takes kRows query rows, so every K or V value read
// from shared memory serves kRows rows, and q and p are read as float4
// broadcasts. N and D are multiples of 4.
// ---------------------------------------------------------------------------

constexpr int kRows = 4;

size_t attention_floats(int N, int D) {
  return (size_t)D * (N + 1) + (((size_t)N * (D + 1) + 3) & ~(size_t)3) +
         kWarps * kRows * (kMaxD + kMaxN);
}

template <typename T>
__device__ void attention_phase(const Params& p, int k, int rank, const float* qkv, T* o,
                                int win, unsigned char* smem) {
  const int N = p.N, C = p.C, nH = p.nH, D = C / nH, ldk = N + 1, ldv = D + 1;
  float* Kt = reinterpret_cast<float*>(smem);                 // [D][N + 1]
  float* Vs = Kt + D * ldk;                                   // [N][D + 1]
  float* Qs = Vs + ((N * ldv + 3) & ~3);                      // [kWarps][kRows][kMaxD]
  float* Ps = Qs + kWarps * kRows * kMaxD;                    // [kWarps][kRows][kMaxN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mask = p.shifted ? p.mask + (size_t)(win % p.nW) * N * N : nullptr;
  const float v1_scale = (float)(1.0 / sqrt((double)D));
  float* qs = Qs + warp * kRows * kMaxD;
  float* ps = Ps + warp * kRows * kMaxN;

  for (int hh = rank; hh < nH; hh += p.cs) {
    const float* bias = p.bias + ((size_t)k * nH + hh) * N * N;
    // K (row-normalised for V2) and V of this head, one warp per key
    for (int n = warp; n < N; n += kWarps) {
      const float* row = qkv + (size_t)n * 3 * C + hh * D;
      float kv[2], vv[2], ss = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        kv[t] = d < D ? ld_l2(row + C + d) : 0.f;
        vv[t] = d < D ? ld_l2(row + 2 * C + d) : 0.f;
        ss += kv[t] * kv[t];
      }
      const float scale = p.v2 ? rsqrtf(fmaxf(warp_sum(ss), 1e-24f)) : 1.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          Kt[d * ldk + n] = kv[t] * scale;
          Vs[n * ldv + d] = vv[t];
        }
      }
    }
    __syncthreads();

    const float lsc = p.v2 ? p.lsc[k * nH + hh] : 1.f;
    for (int n0 = warp * kRows; n0 < N; n0 += kWarps * kRows) {
      // q rows n0 .. n0 + kRows - 1 (zeros past N), scaled
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r;
        const float* row = qkv + (size_t)n * 3 * C + hh * D;
        float qv[2], ss = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int d = lane + 32 * t;
          qv[t] = n < N && d < D ? ld_l2(row + d) : 0.f;
          ss += qv[t] * qv[t];
        }
        const float scale = p.v2 ? rsqrtf(fmaxf(warp_sum(ss), 1e-24f)) * lsc : v1_scale;
#pragma unroll
        for (int t = 0; t < 2; ++t) qs[r * kMaxD + lane + 32 * t] = qv[t] * scale;
      }
      __syncwarp();

      // logits: lane m takes keys m, m + 32, ...
      float s[kRows][kKeysPerLane];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int m = lane + 32 * j;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        if (m < N) {
          for (int d = 0; d < D; d += 4) {
            const float k0 = Kt[d * ldk + m], k1 = Kt[(d + 1) * ldk + m];
            const float k2 = Kt[(d + 2) * ldk + m], k3 = Kt[(d + 3) * ldk + m];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 q = *reinterpret_cast<const float4*>(qs + r * kMaxD + d);
              acc[r] = fmaf(q.w, k3, fmaf(q.z, k2, fmaf(q.y, k1, fmaf(q.x, k0, acc[r]))));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = n0 + r;
          float logit = -INFINITY;
          if (m < N && n < N) {
            logit = acc[r] + bias[(size_t)n * N + m];
            if (mask) logit += mask[(size_t)n * N + m];
          }
          s[r][j] = logit;
        }
      }
      // softmax of each row, p into this warp's rows of Ps
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (n0 + r >= N) continue;                      // uniform over the warp
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) mx = fmaxf(mx, s[r][j]);
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          const float e = lane + 32 * j < N ? expf(s[r][j] - mx) : 0.f;
          s[r][j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          const int m = lane + 32 * j;
          if (m < N) ps[r * kMaxN + m] = s[r][j] / sum;
        }
      }
      __syncwarp();

      // p v: lane d takes dims d, d + 32
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        if (d >= D) continue;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int m = 0; m < N; m += 4) {
          const float v0 = Vs[m * ldv + d], v1 = Vs[(m + 1) * ldv + d];
          const float v2 = Vs[(m + 2) * ldv + d], v3 = Vs[(m + 3) * ldv + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 pr = *reinterpret_cast<const float4*>(ps + r * kMaxN + m);
            acc[r] = fmaf(pr.w, v3, fmaf(pr.z, v2, fmaf(pr.y, v1, fmaf(pr.x, v0, acc[r]))));
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (n0 + r < N) o[(size_t)(n0 + r) * C + hh * D + d] = from_float<T>(acc[r]);
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The chain: cluster c = blockIdx.x / cs owns window c for all K blocks.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) block_chain_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int win = blockIdx.x / p.cs;
  const int N = p.N, C = p.C, Hd = p.Hd, cs = p.cs;
  const bool v1 = !p.v2;
  const size_t wc = (size_t)win * N * C;
  const T* x = static_cast<const T*>(p.x) + wc;
  T* out = static_cast<T*>(p.out) + wc;
  T* h = static_cast<T*>(p.h) + wc;
  T* o = static_cast<T*>(p.o) + wc;
  float* a = p.a + wc;
  float* xs = p.xs + wc;
  float* qkv = p.qkv + (size_t)win * N * 3 * C;
  T* hid = p.full ? static_cast<T*>(p.hid) + (size_t)win * N * Hd : nullptr;
  const T* n1s = static_cast<const T*>(p.n1s);
  const T* n1b = static_cast<const T*>(p.n1b);
  const T* n2s = static_cast<const T*>(p.n2s);
  const T* n2b = static_cast<const T*>(p.n2b);
  const T* qkvk = static_cast<const T*>(p.qkvk);
  const T* qkvb = static_cast<const T*>(p.qkvb);
  const T* projk = static_cast<const T*>(p.projk);
  const T* projb = static_cast<const T*>(p.projb);
  const T* fc1k = static_cast<const T*>(p.fc1k);
  const T* fc1b = static_cast<const T*>(p.fc1b);
  const T* fc2k = static_cast<const T*>(p.fc2k);
  const T* fc2b = static_cast<const T*>(p.fc2b);

  // xs = x; h = [V1 norm1_0](x)
  rows_phase<T>(p, rank, x, xs, nullptr, nullptr, nullptr, v1 ? n1s : nullptr, n1b, h, nullptr);
  cluster_barrier();
  for (int k = 0; k < p.K; ++k) {
    const size_t kc = (size_t)k * C;
    const bool last_block = k + 1 == p.K;

    // attention sub-block: xs += [V2 norm1](proj(attn(h)))
    gemm<T, kEpiF32>(h, N, C, qkvk + kc * 3 * C, 3 * C, qkvb + 3 * kc, qkv, rank, cs, smem);
    cluster_barrier();
    attention_phase<T>(p, k, rank, qkv, o, win, smem);
    cluster_barrier();
    gemm<T, kEpiF32>(o, N, C, projk + kc * C, C, projb + kc, a, rank, cs, smem);
    cluster_barrier();
    // h for the next product: [V1 norm2 | norm1 of block k+1](xs); the output after the last
    const bool last = !p.full && last_block;
    const T* next_w = !v1 ? nullptr : p.full ? n2s + kc : n1s + kc + C;
    const T* next_b = !v1 ? nullptr : p.full ? n2b + kc : n1b + kc + C;
    rows_phase<T>(p, rank, nullptr, xs, a, p.v2 ? n1s + kc : nullptr, n1b + kc, next_w, next_b,
                  last ? nullptr : h, last ? out : nullptr);
    cluster_barrier();
    if (!p.full) continue;

    // MLP sub-block: xs += [V2 norm2](fc2(gelu(fc1(h))))
    gemm<T, kEpiGelu>(h, N, C, fc1k + kc * Hd, Hd, fc1b + (size_t)k * Hd, hid, rank, cs, smem);
    cluster_barrier();
    gemm<T, kEpiF32>(hid, N, Hd, fc2k + kc * Hd, C, fc2b + kc, a, rank, cs, smem);
    cluster_barrier();
    next_w = v1 ? n1s + kc + C : nullptr;
    next_b = v1 ? n1b + kc + C : nullptr;
    rows_phase<T>(p, rank, nullptr, xs, a, p.v2 ? n2s + kc : nullptr, n2b + kc, next_w, next_b,
                  last_block ? nullptr : h, last_block ? out : nullptr);
    cluster_barrier();
  }
}

size_t shared_bytes(int dtype, int N, int D) {
  const size_t attn = sizeof(float) * attention_floats(N, D);
  const size_t prod = dtype == 1
      ? sizeof(bf16) * kStages * (kMaxN * kLdA + kBK * kLdB) + sizeof(float) * kWarps * 256
      : sizeof(float) * (kMaxN * kFLdA + kFK * kFLdB);
  return attn > prod ? attn : prod;
}

cudaLaunchConfig_t launch_config(const Params& p, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.G * p.cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cs` CTAs the card holds at once, by (dtype, cs, shared bytes).
template <typename T>
int max_active_clusters(Params p, size_t smem) {
  struct Entry { int cs; size_t smem; int clusters; };
  static Entry cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].cs == p.cs && cache[i].smem == smem) return cache[i].clusters;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, block_chain_kernel<T>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    clusters = 0;
  }
  if (used < 64) cache[used++] = {p.cs, smem, clusters};
  return clusters;
}

// CTAs per window: the cluster size with the least estimated time, counted
// in k-steps of one product tile (about the cost of one head's attention on
// the CUDA cores at N=144, D=32 is 19 of them): the rounds of clusters the
// card runs one after another, times the largest share of each phase's
// tiles or heads one CTA gets.
template <typename T>
int pick_cluster(Params p, size_t smem) {
  const int D = p.C / p.nH;
  const double kq = (p.C + kBK - 1) / kBK, kh = (p.Hd + kBK - 1) / kBK;
  const double head = 19.0 * p.N * p.N * D / (144.0 * 144.0 * 32.0);
  const int tq = (3 * p.C + kBN - 1) / kBN, tc = (p.C + kBN - 1) / kBN;
  const int th = (p.Hd + kBN - 1) / kBN;
  int best = 1;
  double best_t = 0.0;
  for (int cs = 1; cs <= 8; ++cs) {
    p.cs = cs;
    const int clusters = max_active_clusters<T>(p, smem);
    if (clusters < 1) continue;
    auto share = [cs](int n) { return (double)((n + cs - 1) / cs); };
    double t = share(tq) * kq + share(p.nH) * head + share(tc) * kq;
    if (p.full) t += share(th) * kq + share(tc) * kh;
    t *= (double)((p.G + clusters - 1) / clusters);
    if (cs == 1 || t < best_t) {
      best = cs;
      best_t = t;
    }
  }
  return best;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  const size_t smem = shared_bytes(std::is_same<T, bf16>::value ? 1 : 0, p.N, p.C / p.nH);
  cudaError_t err = cudaFuncSetAttribute(block_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  p.cs = pick_cluster<T>(p, smem);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, block_chain_kernel<T>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: x, out, norm1 scale, norm1 bias, qkv kernel, qkv bias, logit scale,
//      proj kernel, proj bias, norm2 scale, norm2 bias, fc1 kernel, fc1 bias,
//      fc2 kernel, fc2 bias, bias table, mask, and the scratch h, qkv (float32),
//      o, a (float32), hid, xs (float32) (23 pointers; hid may be null for
//      the attention part, mask when the chain is not shifted);
// dim: G, N, C, nH, Hd, K, nW, v2, full, shifted, dtype (0 float32, 1 bf16).
// Returns a cudaError_t (0 on success).
extern "C" int block_chain_fwd(const void* const* ptr, const int* dim, float eps, void* stream) {
  Params p;
  p.x = ptr[0];
  p.out = const_cast<void*>(ptr[1]);
  p.n1s = ptr[2];
  p.n1b = ptr[3];
  p.qkvk = ptr[4];
  p.qkvb = ptr[5];
  p.lsc = static_cast<const float*>(ptr[6]);
  p.projk = ptr[7];
  p.projb = ptr[8];
  p.n2s = ptr[9];
  p.n2b = ptr[10];
  p.fc1k = ptr[11];
  p.fc1b = ptr[12];
  p.fc2k = ptr[13];
  p.fc2b = ptr[14];
  p.bias = static_cast<const float*>(ptr[15]);
  p.mask = static_cast<const float*>(ptr[16]);
  p.h = const_cast<void*>(ptr[17]);
  p.qkv = static_cast<float*>(const_cast<void*>(ptr[18]));
  p.o = const_cast<void*>(ptr[19]);
  p.a = static_cast<float*>(const_cast<void*>(ptr[20]));
  p.hid = const_cast<void*>(ptr[21]);
  p.xs = static_cast<float*>(const_cast<void*>(ptr[22]));
  p.G = dim[0];
  p.N = dim[1];
  p.C = dim[2];
  p.nH = dim[3];
  p.Hd = dim[4];
  p.K = dim[5];
  p.nW = dim[6];
  p.v2 = dim[7];
  p.full = dim[8];
  p.shifted = dim[9];
  p.cs = 1;
  const int dtype = dim[10];
  p.eps = eps;

  if (p.G < 1 || p.N < 1 || p.N > kMaxN || p.N % 4 || p.C < 8 || p.C % 8 || p.nH < 1 ||
      p.C % p.nH || p.C / p.nH > kMaxD || (p.C / p.nH) % 4 || p.K < 1 || p.nW < 1 || p.G % p.nW ||
      (p.full && (p.Hd < 8 || p.Hd % 8 || !p.hid)) || (p.shifted && !p.mask))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i)
    if (ptr[i] == nullptr) return (int)cudaErrorInvalidValue;
  if (!p.h || !p.qkv || !p.o || !p.a || !p.xs) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<bf16>(p, s);
  return (int)cudaErrorInvalidValue;
}
