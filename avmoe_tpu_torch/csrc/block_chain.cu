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
// before proj, GELU(fc1) before fc2) and the chain's output; its attention
// runs on TF32 operands (10-bit mantissa) rounded from the float32 q, k, v
// and p it keeps. The residual stream stays float32 in scratch from the
// first sub-block to the last. The Pallas body rounds the stream after
// every sub-block and q, k, v, p, fc1 + bias and the norm outputs to bf16 as
// well: on seeded Swin-V2 stage-2 / stage-3 chains (K=2) the plain version
// in bf16, which rounds as Pallas does, lands 7e-2 to 8.5e-2 (1 + |ref|)
// from the float32 result (PERF.md): cosine attention scales q.k by up to
// 100, and the V2 post-norm rescales every sub-block's output to unit size.
//
// What bounds it on the H100. Per window and block the products do
// 2 N (4 C^2 + 8 C^2) operations on N C stream elements: at N=144 that is
// ~1700 operations per stream byte, so the tensor cores bound it, not device
// memory (989 TFLOP/s bf16; float32 runs on the CUDA cores). The weights,
// 12 C^2 elements a block (14 MB in bf16 at C=768), come from L2.
//
// What the design does about that. Windows are independent through the
// whole chain, so one thread-block CLUSTER of `cs` CTAs owns W consecutive
// windows for all K blocks and both sub-blocks: W N <= 144 (W up to 1 at
// N=144, 2 at N=64, 4 at N=36), so that a product tile has up to 144 rows
// and each weight tile read from L2 serves W windows (a ragged last cluster
// skips the windows past G). W and `cs` (1 to 8) are picked together at
// launch from the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), how evenly each phase's tiles and
// (window, head) pairs split, and the bytes each product step moves
// (`pick_cluster`). A phase that needs all of a
// window's rows or heads (LayerNorm rows, attention heads, the next
// product's A operand) starts after a cluster barrier, never after a second
// launch. Inside a phase the cluster's CTAs split the work: a product's
// 128-column output tiles (each holds all W N rows), the (window, head)
// pairs, the token rows.
//
// bf16 products run on the tensor cores as mma.sync m16n8k16 from a 4-stage
// cp.async ring of shared-memory tiles (A: the tile's rows x 64, B: 64 x 128),
// fed to the warps by ldmatrix (.trans for the row-major weights). The 8
// warps tile the output 2 x 4: a warp owns half of the 16-row fragments and
// a 32-column strip, so every A fragment serves 4 MMAs and every B fragment
// up to 5. Per 64-deep step a CTA moves 34 KB from L2 for 2.4 MFLOP; a wgmma
// version of the same ring ran no faster (PERF.md), so that traffic, not the
// tensor cores' rate, is what the next design has to cut (one A tile shared
// by the cluster's CTAs). The bf16
// attention is csrc/attention_mma.cuh on TF32 operands (mma.sync
// m16n8k8): a CTA stages the q (normalised and scaled), k
// (normalised) and v of as many (window, head) pairs as its shared memory
// holds, and its warps walk the (pair, 16-query-row block) units, with the
// logits and probabilities in registers. Float32 chains keep the CUDA cores
// (products and attention): their checks need the full mantissa. A window's
// activations do not fit one SM's 227 KB (144 x 768 bf16 is 221 KB), so they
// live in device-memory scratch that the wrapper allocates (mostly
// L2-resident); data another CTA wrote is read through L2 (cp.async.cg,
// ld.global.cg), after a __threadfence and the cluster barrier. One CTA of 8 warps per SM, with up
// to 255 registers a thread (at 128, two CTAs per SM, and at 168, 12 warps,
// the logits and the product accumulators spilled to local memory) and
// 204 KB of shared memory.
//
// Where its time goes: tools/k3_phase_ablation.py times it with each phase
// removed (PERF.md). Later work: wgmma + TMA for the products, the hidden
// activations kept on chip.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace avmoe;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 144;                     // rows of a product tile: W windows of N tokens
constexpr int kMaxFr = kMaxN / 16;             // 16-row fragments of a product tile
constexpr int kWarpFr = (kMaxFr + 1) / 2;      // bf16 product: fragments of one warp
constexpr int kMaxD = 64;                      // head width
constexpr int kKeysPerLane = (kMaxN + 31) / 32;
constexpr int kKT8 = kMaxN / 8;                // bf16 attention: 8-key tiles in registers
constexpr int kBN = 128;                       // output columns of a product tile
constexpr int kBK = 64;                        // bf16 product: depth of a stage
constexpr int kStages = 4;                     // bf16 product: stages in flight
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBN + 8;
constexpr int kFK = 16;                        // float32 product: depth of a stage
constexpr int kFLdA = kFK + 1;
constexpr int kFLdB = kBN + 4;
constexpr size_t kSmemBf16 = 204 * 1024;       // bf16 kernel: one CTA per SM
constexpr int kRowsInFlight = 8;               // bf16 attention: rows a warp stages at once

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
  int G, N, C, nH, Hd, K, nW, v2, full, shifted;
  int cs;                 // CTAs per cluster
  int W;                  // windows per cluster
  int S;                  // bf16 attention: (window, head) pairs staged at once
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

// two neighbouring columns of one row (idx even)
template <int EPI>
__device__ __forceinline__ void store_epi_pair(void* out, size_t idx, float v0, float v1) {
  if (EPI == kEpiF32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
  else
    *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + idx) =
        mma::pack_bf16(gelu_erf(v0), gelu_erf(v1));
}

// ---------------------------------------------------------------------------
// Products of the cluster's rows: out[r, n] = epi(sum_k A[r, k] W[k, n] +
// bias[n]), r < M (all W N rows of the cluster's windows in one tile),
// n < Nout split in 128-column tiles over the cluster's CTAs. A (M, Kd) and
// W (Kd, Nout) are row-major.
// ---------------------------------------------------------------------------

template <int EPI>
__device__ void gemm_bf16(const bf16* A, int M, int Kd, const bf16* W, int Nout,
                          const bf16* bias, void* out, int rank, int cs, unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);                            // [kStages][kMaxN][kLdA]
  bf16* Bs = As + kStages * kMaxN * kLdA;                              // [kStages][kBK][kLdB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nfr = (M + 15) >> 4;
  // warps 2 x 4: fragments [f0, f0 + nf) of the rows, columns wn * 32 .. + 31
  const int wm = warp >> 2, wn = warp & 3;
  const int f0 = wm ? (nfr + 1) >> 1 : 0, nf = wm ? nfr >> 1 : (nfr + 1) >> 1;
  const int ntiles = (Nout + kBN - 1) / kBN;
  const int nk = (Kd + kBK - 1) / kBK;
  // ldmatrix row addresses of this lane: A (x4) and B (x4.trans, two n8 tiles)
  const int a_off = (lane & 15) * kLdA + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + wn * 32 + (lane >> 4) * 8;

  // this CTA's tiles are rank, rank + cs, ...; one ring runs over all their
  // k-steps, so the next tile's first stages load while the current one ends
  const int mine = ntiles > rank ? (ntiles - rank + cs - 1) / cs : 0;
  const int steps = mine * nk;
  float acc[kWarpFr][4][4];
#pragma unroll
  for (int i = 0; i < kWarpFr; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int buf, int it) {
    const int n0 = (rank + cs * (it / nk)) * kBN, k0 = (it % nk) * kBK;
    bf16* as = As + buf * kMaxN * kLdA;
    bf16* bs = Bs + buf * kBK * kLdB;
    for (int c = tid; c < nfr * 16 * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = c % (kBK / 8) * 8;
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
    if (s < steps) load(s, s);
    else cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    // stage it has landed, and every warp is done with stage it - 1, whose
    // buffer the next load refills
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < steps) load(next % kStages, next);
    else cp_async_commit();
    const bf16* as = As + (it % kStages) * kMaxN * kLdA + f0 * 16 * kLdA + a_off;
    const bf16* bs = Bs + (it % kStages) * kBK * kLdB + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned b[2][4];
      mma::ldsm_x4_trans(b[0], bs + kk * kLdB);
      mma::ldsm_x4_trans(b[1], bs + kk * kLdB + 16);
#pragma unroll
      for (int i = 0; i < kWarpFr; ++i) {
        if (i < nf) {
          unsigned a[4];
          mma::ldsm_x4(a, as + i * 16 * kLdA + kk);
          mma::mma_bf16(acc[i][0], a, b[0][0], b[0][1]);
          mma::mma_bf16(acc[i][1], a, b[0][2], b[0][3]);
          mma::mma_bf16(acc[i][2], a, b[1][0], b[1][1]);
          mma::mma_bf16(acc[i][3], a, b[1][2], b[1][3]);
        }
      }
    }
    if (it % nk != nk - 1) continue;

    // the tile's last k-step: bias, epilogue, stores; the accumulators restart
    const int n0 = (rank + cs * (it / nk)) * kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + 8 * j + 2 * t;
      if (col >= Nout) continue;
      const float b0 = to_float(bias[col]), b1 = to_float(bias[col + 1]);
#pragma unroll
      for (int i = 0; i < kWarpFr; ++i) {
        if (i >= nf) continue;
        const int r = (f0 + i) * 16 + g;
        if (r < M)
          store_epi_pair<EPI>(out, (size_t)r * Nout + col, acc[i][j][0] + b0, acc[i][j][1] + b1);
        if (r + 8 < M)
          store_epi_pair<EPI>(out, (size_t)(r + 8) * Nout + col, acc[i][j][2] + b0,
                              acc[i][j][3] + b1);
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpFr; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // the next product's loads refill every buffer
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
// Token rows of the cluster's windows (M = W N rows), one warp per row, rows
// split over the cluster:
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
__device__ void rows_phase(const Params& p, int rank, int M, const T* x_in, float* xs,
                           const float* delta, const T* post_w, const T* post_b,
                           const T* ln_w, const T* ln_b, T* h, T* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C;
  for (int r = rank * kWarps + warp; r < M; r += p.cs * kWarps) {
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
// Attention of the cluster's windows, block k: (window, head) pairs split
// over the cluster's CTAs.
// o[n, h*D + d] = sum_m softmax_m(q_n . k_m + bias + mask) v_m in float32, stored as T.
//
// Float32 chains: CUDA cores, one pair at a time. K is stored transposed
// with row stride N + 1 (lane m reads key m, conflict free); each warp pass
// takes kRows query rows, so every K or V value read from shared memory
// serves kRows rows, and q and p are read as float4 broadcasts. N and D are
// multiples of 4.
// ---------------------------------------------------------------------------

constexpr int kRows = 4;

size_t attention_floats(int N, int D) {
  return (size_t)D * (N + 1) + (((size_t)N * (D + 1) + 3) & ~(size_t)3) +
         kWarps * kRows * (kMaxD + kMaxN);
}

template <typename T>
__device__ void attention_phase_f32(const Params& p, int k, int rank, const float* qkv_c, T* o_c,
                                    int win0, int nwin, unsigned char* smem) {
  const int N = p.N, C = p.C, nH = p.nH, D = C / nH, ldk = N + 1, ldv = D + 1;
  float* Kt = reinterpret_cast<float*>(smem);                 // [D][N + 1]
  float* Vs = Kt + D * ldk;                                   // [N][D + 1]
  float* Qs = Vs + ((N * ldv + 3) & ~3);                      // [kWarps][kRows][kMaxD]
  float* Ps = Qs + kWarps * kRows * kMaxD;                    // [kWarps][kRows][kMaxN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float v1_scale = (float)(1.0 / sqrt((double)D));
  float* qs = Qs + warp * kRows * kMaxD;
  float* ps = Ps + warp * kRows * kMaxN;

  for (int pi = rank; pi < nwin * nH; pi += p.cs) {
    const int w = pi / nH, hh = pi - w * nH;
    const float* qkv = qkv_c + (size_t)w * N * 3 * C;
    T* o = o_c + (size_t)w * N * C;
    const float* mask = p.shifted ? p.mask + (size_t)((win0 + w) % p.nW) * N * N : nullptr;
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

// bf16 chains: tensor cores on TF32 operands (attention_mma.cuh). A stage
// holds the q (normalised and scaled), k (row-normalised for V2) and v of
// up to p.S pairs, staged by warps that each keep kRowsInFlight rows' loads
// in flight; then the warps walk the stage's (pair, 16-query-row block)
// units. Layout per pair, in floats: Qs [16 nrb][ldk], Ks [8 nkt][ldk],
// Vs [8 nkt][ldv]. DT8 >= ceil(D / 8): 8-column tiles of a head the
// registers hold.

__host__ __device__ __forceinline__ int attn_ldk(int nd8) { return (8 * nd8 + 23) / 32 * 32 + 8; }
__host__ __device__ __forceinline__ int attn_ldv(int nd8) { return (8 * nd8 + 27) / 32 * 32 + 4; }

// floats of one staged pair
__host__ __device__ __forceinline__ int attn_pair_floats(int N, int D) {
  const int nd8 = (D + 7) / 8;
  return 16 * ((N + 15) / 16) * attn_ldk(nd8) + 8 * ((N + 7) / 8) * (attn_ldk(nd8) + attn_ldv(nd8));
}

template <int DT8>
__device__ void attention_phase_mma(const Params& p, int k, int rank, const float* qkv, bf16* o,
                                    int win0, int nwin, unsigned char* smem) {
  constexpr int R = kRowsInFlight;
  const int N = p.N, C = p.C, nH = p.nH, D = C / nH, cs = p.cs;
  const int nd8 = (D + 7) >> 3, nkt = (N + 7) >> 3, np = 8 * nkt, nrb = (N + 15) >> 4;
  const int qrows = 16 * nrb, ldk = attn_ldk(nd8), ldv = attn_ldv(nd8);
  const int pair_floats = attn_pair_floats(N, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* stage = reinterpret_cast<float*>(smem);
  const float v1_scale = (float)(1.0 / sqrt((double)D));
  const int pairs = nwin * nH;
  const int mine = pairs > rank ? (pairs - rank + cs - 1) / cs : 0;  // pairs rank + cs i

  for (int i0 = 0; i0 < mine; i0 += p.S) {
    const int ns = min(p.S, mine - i0);
    // q, k, v of ns pairs; zeros past N and D. Rows outside read element 0 of
    // the window's qkv (every load is issued; the select zeroes it)
    for (int rr0 = warp * R; rr0 < ns * qrows; rr0 += kWarps * R) {
      float qv[R][2], kv[R][2], vv[R][2], lsc[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int rr = rr0 + b, s = rr / qrows, n = rr - s * qrows;
        const int pi = rank + cs * (i0 + s), w = pi / nH, hh = pi - w * nH;
        const bool row_ok = rr < ns * qrows && n < N;
        const float* row = qkv + (row_ok ? ((size_t)w * N + n) * 3 * C + hh * D : 0);
        lsc[b] = p.v2 ? p.lsc[k * nH + (rr < ns * qrows ? hh : 0)] : 1.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = lane + 32 * u;
          const bool ok = row_ok && d < D;
          const float qx = ld_l2(row + (ok ? d : 0));
          const float kx = ld_l2(row + (ok ? C + d : 0)), vx = ld_l2(row + (ok ? 2 * C + d : 0));
          qv[b][u] = ok ? qx : 0.f;
          kv[b][u] = ok ? kx : 0.f;
          vv[b][u] = ok ? vx : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int rr = rr0 + b, s = rr / qrows, n = rr - s * qrows;
        if (rr >= ns * qrows) break;  // uniform over the warp
        float* Qs = stage + (size_t)s * pair_floats;
        float* Ks = Qs + qrows * ldk;
        float* Vs = Ks + np * ldk;
        const float sq = qv[b][0] * qv[b][0] + qv[b][1] * qv[b][1];
        const float sk = kv[b][0] * kv[b][0] + kv[b][1] * kv[b][1];
        const float qscale = p.v2 ? rsqrtf(fmaxf(warp_sum(sq), 1e-24f)) * lsc[b] : v1_scale;
        const float kscale = p.v2 ? rsqrtf(fmaxf(warp_sum(sk), 1e-24f)) : 1.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = lane + 32 * u;
          if (d >= 8 * nd8) continue;
          Qs[n * ldk + d] = qv[b][u] * qscale;
          if (n < np) {
            Ks[n * ldk + d] = kv[b][u] * kscale;
            Vs[n * ldv + d] = __uint_as_float(mma::tf32(vv[b][u]));
          }
        }
      }
    }
    __syncthreads();

    for (int u = warp; u < ns * nrb; u += kWarps) {
      const int s = u / nrb, rb = u - s * nrb;
      const int pi = rank + cs * (i0 + s), w = pi / nH, hh = pi - w * nH;
      const float* Qs = stage + (size_t)s * pair_floats;
      const float* Ks = Qs + qrows * ldk;
      const float* Vs = Ks + np * ldk;
      // the logits start as bias (+ mask)
      float sacc[kKT8][4];
      const float* mask = p.shifted ? p.mask + (size_t)((win0 + w) % p.nW) * N * N : nullptr;
      mma::load_logit_bias<kKT8>(sacc, p.bias + ((size_t)k * nH + hh) * N * N, mask, N, 16 * rb,
                                 nkt);
      mma::qk_tf32<kKT8>(sacc, Qs + 16 * rb * ldk, Ks, ldk, nkt, nd8);
      float inv0, inv1;
      mma::softmax_rows<kKT8>(sacc, nkt, inv0, inv1);
      float oacc[DT8][4];
      mma::pv_tf32<kKT8, DT8>(oacc, sacc, Vs, ldv, nkt, nd8);

      const int r0 = 16 * rb + g;
      bf16* ob = o + (size_t)w * N * C + hh * D;
#pragma unroll
      for (int dt = 0; dt < DT8; ++dt) {
        const int d = 8 * dt + 2 * t;
        if (dt >= nd8 || d >= D) continue;
        if (r0 < N)
          *reinterpret_cast<unsigned*>(ob + (size_t)r0 * C + d) =
              mma::pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
        if (r0 + 8 < N)
          *reinterpret_cast<unsigned*>(ob + (size_t)(r0 + 8) * C + d) =
              mma::pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
      }
    }
    __syncthreads();  // the next stage rewrites the buffers
  }
}

template <typename T>
__device__ __forceinline__ void attention_phase(const Params& p, int k, int rank, const float* qkv,
                                                T* o, int win0, int nwin, unsigned char* smem) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.C / p.nH <= 32)
      attention_phase_mma<4>(p, k, rank, qkv, o, win0, nwin, smem);
    else
      attention_phase_mma<8>(p, k, rank, qkv, o, win0, nwin, smem);
  } else {
    attention_phase_f32<T>(p, k, rank, qkv, o, win0, nwin, smem);
  }
}

// ---------------------------------------------------------------------------
// The chain: cluster c = blockIdx.x / cs owns windows c W .. c W + W - 1
// (those below G) for all K blocks.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    block_chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int win0 = (int)(blockIdx.x / p.cs) * p.W;
  const int nwin = min(p.W, p.G - win0);
  const int N = p.N, C = p.C, Hd = p.Hd, cs = p.cs;
  const int M = nwin * N;
  const bool v1 = !p.v2;
  const size_t wc = (size_t)win0 * N * C;
  const T* x = static_cast<const T*>(p.x) + wc;
  T* out = static_cast<T*>(p.out) + wc;
  T* h = static_cast<T*>(p.h) + wc;
  T* o = static_cast<T*>(p.o) + wc;
  float* a = p.a + wc;
  float* xs = p.xs + wc;
  float* qkv = p.qkv + (size_t)win0 * N * 3 * C;
  T* hid = p.full ? static_cast<T*>(p.hid) + (size_t)win0 * N * Hd : nullptr;
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
  rows_phase<T>(p, rank, M, x, xs, nullptr, nullptr, nullptr, v1 ? n1s : nullptr, n1b, h,
                nullptr);
  cluster_barrier();
  for (int k = 0; k < p.K; ++k) {
    const size_t kc = (size_t)k * C;
    const bool last_block = k + 1 == p.K;

    // attention sub-block: xs += [V2 norm1](proj(attn(h)))
    gemm<T, kEpiF32>(h, M, C, qkvk + kc * 3 * C, 3 * C, qkvb + 3 * kc, qkv, rank, cs, smem);
    cluster_barrier();
    attention_phase<T>(p, k, rank, qkv, o, win0, nwin, smem);
    cluster_barrier();
    gemm<T, kEpiF32>(o, M, C, projk + kc * C, C, projb + kc, a, rank, cs, smem);
    cluster_barrier();
    // h for the next product: [V1 norm2 | norm1 of block k+1](xs); the output after the last
    const bool last = !p.full && last_block;
    const T* next_w = !v1 ? nullptr : p.full ? n2s + kc : n1s + kc + C;
    const T* next_b = !v1 ? nullptr : p.full ? n2b + kc : n1b + kc + C;
    rows_phase<T>(p, rank, M, nullptr, xs, a, p.v2 ? n1s + kc : nullptr, n1b + kc, next_w,
                  next_b, last ? nullptr : h, last ? out : nullptr);
    cluster_barrier();
    if (!p.full) continue;

    // MLP sub-block: xs += [V2 norm2](fc2(gelu(fc1(h))))
    gemm<T, kEpiGelu>(h, M, C, fc1k + kc * Hd, Hd, fc1b + (size_t)k * Hd, hid, rank, cs, smem);
    cluster_barrier();
    gemm<T, kEpiF32>(hid, M, Hd, fc2k + kc * Hd, C, fc2b + kc, a, rank, cs, smem);
    cluster_barrier();
    next_w = v1 ? n1s + kc + C : nullptr;
    next_b = v1 ? n1b + kc + C : nullptr;
    rows_phase<T>(p, rank, M, nullptr, xs, a, p.v2 ? n2s + kc : nullptr, n2b + kc, next_w,
                  next_b, last_block ? nullptr : h, last_block ? out : nullptr);
    cluster_barrier();
  }
}

size_t shared_bytes(int dtype, int N, int D) {
  if (dtype == 1) {
    const size_t prod = sizeof(bf16) * kStages * (kMaxN * kLdA + kBK * kLdB);
    const size_t attn = sizeof(float) * attn_pair_floats(N, D);
    return std::max(std::max(prod, attn), kSmemBf16);
  }
  const size_t attn = sizeof(float) * attention_floats(N, D);
  const size_t prod = sizeof(float) * (kMaxN * kFLdA + kFK * kFLdB);
  return std::max(attn, prod);
}

// bf16 attention: (window, head) pairs whose q, k and v fit the shared memory at once
int attention_pairs(size_t smem, int N, int D) {
  return (int)std::max<size_t>(1, smem / sizeof(float) / attn_pair_floats(N, D));
}

cudaLaunchConfig_t launch_config(const Params& p, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.G + p.W - 1) / p.W * p.cs));
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
cudaError_t max_active_clusters(Params p, size_t smem, int* clusters) {
  struct Entry { int cs; size_t smem; int clusters; };
  static Entry cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].cs == p.cs && cache[i].smem == smem) {
      *clusters = cache[i].clusters;
      return cudaSuccess;
    }
  p.W = 1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, smem, nullptr, &attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, block_chain_kernel<T>, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = {p.cs, smem, *clusters};
  return cudaSuccess;
}

cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// Windows per cluster W (1 .. 144 / N) and CTAs per cluster cs (1 .. 8), with
// the least estimated time. Unit: the KB one CTA moves from L2 into shared
// memory. A product k-step moves the 8 KB weight tile and 1 KB per 16-row
// fragment of the tile's W N rows; a (window, head) pair's attention moves
// its bias (and mask) tile and q, k, v and o. A cluster's path sums, over the
// phases, the largest share of the phase's tiles or pairs one CTA gets; the
// card runs the clusters in rounds of as many as it holds at once, and two
// CTAs on one SM are counted as taking 1.5 times as long each. W > 0 fixes
// the windows per cluster (capped at 144 / N and G) and picks cs alone.
template <typename T>
cudaError_t pick_cluster(Params& p, size_t smem, int W_fixed = 0) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int D = p.C / p.nH;
  const double kq = (p.C + kBK - 1) / kBK, kh = (p.Hd + kBK - 1) / kBK;
  const double head = (p.N * p.N * 4.0 * (p.shifted ? 2 : 1) + 4.0 * p.N * D * 4) / 1024;
  const int tq = (3 * p.C + kBN - 1) / kBN, tc = (p.C + kBN - 1) / kBN;
  const int th = (p.Hd + kBN - 1) / kBN;
  const int wmax = std::max(1, std::min(kMaxN / p.N, p.G));
  const int wlo = W_fixed > 0 ? std::min(W_fixed, wmax) : 1;
  const int whi = W_fixed > 0 ? wlo : wmax;
  int best_w = wlo, best_cs = 1;
  double best_t = -1.0;
  for (int W = wlo; W <= whi; ++W) {
    const int nclus = (p.G + W - 1) / W;
    const double step = 8.0 + (W * p.N + 15) / 16;
    for (int cs = 1; cs <= 8; ++cs) {
      p.cs = cs;
      int clusters = 0;
      if ((err = max_active_clusters<T>(p, smem, &clusters)) != cudaSuccess) return err;
      if (clusters < 1) continue;
      auto share = [cs](int n) { return (double)((n + cs - 1) / cs); };
      double path = (share(tq) + share(tc)) * kq * step + share(W * p.nH) * head;
      if (p.full) path += share(th) * kq * step + share(tc) * kh * step;
      const double ctas = (double)std::min(nclus, clusters) * cs;
      const double t = path * ((nclus + clusters - 1) / clusters) *
                       std::max(1.0, 0.5 + 0.5 * ctas / sms);
      if (best_t < 0.0 || t < best_t) {
        best_w = W;
        best_cs = cs;
        best_t = t;
      }
    }
  }
  p.W = best_w;
  p.cs = best_cs;
  return cudaSuccess;
}

template <typename T>
int launch(Params p, int W_fixed, cudaStream_t stream) {
  const int D = p.C / p.nH;
  const size_t smem = shared_bytes(std::is_same<T, bf16>::value ? 1 : 0, p.N, D);
  static size_t smem_set = 0;  // the attribute is set again only to raise it
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(block_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if ((err = pick_cluster<T>(p, smem, W_fixed)) != cudaSuccess) return (int)err;
  p.S = attention_pairs(smem, p.N, D);
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
// dim: G, N, C, nH, Hd, K, nW, v2, full, shifted, dtype (0 float32, 1 bf16),
//      windows per cluster (0: the kernel picks).
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
  p.W = 1;
  p.S = 1;
  const int dtype = dim[10];
  if (dim[11] < 0) return (int)cudaErrorInvalidValue;
  p.eps = eps;

  if (p.G < 1 || p.N < 1 || p.N > kMaxN || p.N % 4 || p.C < 8 || p.C % 8 || p.nH < 1 ||
      p.C % p.nH || p.C / p.nH > kMaxD || (p.C / p.nH) % 4 || p.K < 1 || p.nW < 1 || p.G % p.nW ||
      (p.full && (p.Hd < 8 || p.Hd % 8 || !p.hid)) || (p.shifted && !p.mask))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i)
    if (ptr[i] == nullptr) return (int)cudaErrorInvalidValue;
  if (!p.h || !p.qkv || !p.o || !p.a || !p.xs) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, dim[11], s);
  if (dtype == 1) return launch<bf16>(p, dim[11], s);
  return (int)cudaErrorInvalidValue;
}
