// Window-attention backward for Hopper (sm_90a): the gradients dq, dk, dv
// of out = softmax(q k^T + bias[bw % nW]) v and, where the bias trains, dbias.
//
// K1 (csrc/window_attention.cu) replaces the TPU kernel
// `fused_window_attention` (experiments/pallas/window_attn.py:55), which has
// no backward: the JAX package differentiates its XLA attention. This is the
// backward of K1's contract:
//
//   P   = softmax(q k^T + bias)        recomputed in float32
//   D_i = sum_d dO_id O_id             O: the forward's output
//   dv  = P^T dO
//   dP  = dO v^T
//   dS  = P o (dP - D)
//   dq  = dS k,  dk = dS^T q
//   dbias[w, h] = sum_b dS[b nW + w, h]   (a trainable backbone: its table
//                                          or CPB MLP makes the bias)
//
// The bias gradient. dS exists only here, so where the bias trains each
// CTA also writes its (window, head)'s float32 dS, the value before K1b
// rounds it to bf16 as a product operand, into an N x N slab of a
// (BW, H, N, N) partial buffer; a second pass (column_sums.cuh) sums the
// frames' slabs of each window in frame order. No atomics: the sum repeats
// bit for bit, and an unshifted block (nW = 1: every window of every frame
// into one slab) would serialize on them. With a frozen bias the CTAs write
// nothing and no second pass runs (a null pointer; the bf16 kernel is
// another instantiation, so the frozen one is unchanged).
//
// q arrives already scaled (V1) or row-normalised times the logit scale
// (V2); that scaling stays in PyTorch autograd outside the kernel.
//
// What bounds it on the H100. Per (window, head) the five products do
// 10 N^2 D operations on 5 N D inputs and 3 N D outputs; with N=144, D=32 in
// bf16 that is about 70 operations per byte, under the ~295 at which the
// tensor cores set the pace, so device memory bounds it. Each CTA also reads
// its head's N x N float32 bias (83 KB at N=144) from L2, more than its
// inputs and outputs together.
//
// bf16: tensor cores (FlashAttention-2's backward, cut to a window that fits
// in one CTA). One CTA of ceil(N / 16) warps per (window, head), built on
// csrc/attention_mma.cuh's m16n8k16 fragments; warp w owns query rows
// 16 w .. 16 w + 15 and, in the column passes, keys 16 w .. 16 w + 15:
//   1. q, k, v, dO into shared memory as bf16 (cp.async; rows of 16 KD + 8,
//      zero past N and past D); D_i from global O and dO, summed in the quad;
//   2. per row warp S = bias + q k^T in registers, P = softmax(S) in float32
//      (load_logit_bias, qk_bf16, softmax_rows), written as bf16 into one
//      N x (N + 8) buffer;                                             barrier
//   3. per key warp dv = P^T dO: P^T by ldmatrix.trans from the buffer, dO
//      by ldmatrix.trans as pv_bf16 takes v;                          barrier
//   4. per row warp, one 16-key chunk at a time: dP = dO v^T (q k^T's
//      fragments), dS = P o (dP - D_i) in float32 from the staged bf16 P,
//      dS written as bf16 over P, dq += dS k (p v's fragments);     barrier
//   5. per key warp dk = dS^T q, as step 3.
// Rounding: P and dS are rounded to bf16 as product operands, as K1 rounds P
// for p v; every sum accumulates in float32; the outputs are rounded to bf16
// once. No atomics: every output element is one warp's sum, in one order, so
// the result is bitwise deterministic. Walking dP and dS in 16-key chunks
// keeps only S (2 ceil(N/16) m16n8 tiles) live at the peak, so at N=144,
// D=32 two CTAs of 9 warps fit an SM (<= 112 registers, 88 KB of shared
// memory each).
//
// float32: the CUDA cores, exact within float32 rounding (the float32
// gradient checks need the full mantissa, which bf16 operands do not keep).
// One CTA of 16 warps owns one (window, head) and holds all of it in shared
// memory as float32: k and v rows padded to D + 1 (lanes that walk keys hit
// distinct banks), q and dO, the N x N probabilities, and D. Four passes,
// separated by barriers, each one product:
//   A  rows i (a warp a row, lanes over keys): logits, softmax -> P; D_i
//   B  keys j (a warp a key, lanes over d):   dv_j = sum_i P_ij dO_i
//   C  rows i: dP_ij, dS_ij = P_ij (dP_ij - D_i) written over P; dq_i = dS_i k
//   D  keys j: dk_j = sum_i dS_ij q_i
// At N=144, D=64 that is 232,128 bytes of shared memory, one CTA per SM;
// the wrapper refuses shapes outside N <= 144, D <= 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "column_sums.cuh"
#include "common.cuh"
#include "cp_async.cuh"

namespace {

using namespace avmoe;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 144;
constexpr int kMaxD = 64;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

size_t shared_bytes(int N, int D) {
  return sizeof(float) * (2 * (size_t)N * (D + 1) + 2 * (size_t)N * D + (size_t)N * N + N);
}

// KPL: keys a lane holds in passes A and C (N <= 32 KPL)
template <int KPL>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, float* __restrict__ ds_part, int H, int N,
                            int D, int nW) {
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
    Ks[n * ldk + d] = k[base + e];
    Vs[n * ldk + d] = v[base + e];
    Qs[e] = q[base + e];
    Gs[e] = dout[base + e];
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
      dsum = fmaf(Gs[(size_t)i * D + d], out[base + (size_t)i * D + d], dsum);
    dsum = warp_sum(dsum);
    if (lane == 0) Ds[i] = dsum;
  }
  __syncthreads();

  // B: dv_j = sum_i P_ij dO_i
  for (int j = warp; j < N; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(Ps[(size_t)i * N + j], Gs[(size_t)i * D + d], acc);
      dv[base + (size_t)j * D + d] = acc;
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
        if (ds_part) ds_part[(size_t)bh * N * N + (size_t)i * N + j] = *p;
      }
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(Ps[(size_t)i * N + j], Ks[j * ldk + d], acc);
      dq[base + (size_t)i * D + d] = acc;
    }
  }
  __syncthreads();

  // D: dk_j = sum_i dS_ij q_i
  for (int j = warp; j < N; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(Ps[(size_t)i * N + j], Qs[(size_t)i * D + d], acc);
      dk[base + (size_t)j * D + d] = acc;
    }
  }
}

template <int KPL>
int launch_f32(const void* q, const void* k, const void* v, const float* bias, const void* out,
               const void* dout, void* dq, void* dk, void* dv, float* ds, int BW, int H, int N,
               int D, int nW, cudaStream_t stream) {
  auto kernel = window_attention_bwd_kernel<KPL>;
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
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), ds, H, N, D,
      nW);
  return (int)cudaGetLastError();
}

int launch_f32_by_n(const void* q, const void* k, const void* v, const float* bias,
                    const void* out, const void* dout, void* dq, void* dk, void* dv, float* ds,
                    int BW, int H, int N, int D, int nW, cudaStream_t s) {
  if (N <= 32) return launch_f32<1>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
  if (N <= 64) return launch_f32<2>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
  if (N <= 96) return launch_f32<3>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
  return launch_f32<5>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. KT16: key 16-tiles the registers hold (N <= 16 KT16);
// KD: 16-wide steps of the head width (D <= 16 KD). nkt16 = ceil(N / 16)
// warps. Shared memory: q, k, v, dO as [16 nkt16][16 KD + 8] bf16, then P
// (later dS) as [16 nkt16][16 nkt16 + 8] bf16, row-major (query, key): both
// row strides are an odd number of 16-byte units, so ldmatrix's eight row
// reads, plain or transposed, hit distinct banks, and so do the quad's 4-byte
// reads and writes of P and dS.
// ---------------------------------------------------------------------------

size_t mma_shared_bytes(int nkt16, int KD) {
  const size_t rows = 16 * (size_t)nkt16;
  return sizeof(bf16) * (4 * rows * (16 * KD + 8) + rows * (rows + 8));
}

// CTAs an SM must hold at once: two of 9 warps at N=144, D <= 32 (registers
// capped at 112), one at D=64 (its q, k, v, dO take 81 KB)
template <int KT16, int KD> __host__ __device__ constexpr int min_blocks() {
  return KT16 <= 4 ? 4 : (KD <= 2 ? 2 : 1);
}

// acc = X^T B over the row 16-tiles < nkt16: X, the staged P or dS, at key
// columns c0 .. c0 + 15 of its row-major (query, key) buffer, read transposed
// (ldmatrix.trans: A[m = key][k = query]); B = rows of Bs (dO or q), read
// transposed as pv_bf16 reads v.
template <int KD>
__device__ __forceinline__ void xt_b(float (&acc)[2 * KD][4], const bf16* Xs, int ldx, int c0,
                                     const bf16* Bs, int ld, int nkt16, int ndt8) {
  const int lane = threadIdx.x & 31;
  const int xrow = (lane & 7) + ((lane >> 4) << 3), xcol = ((lane >> 3) & 1) * 8;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8, bcol = (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  for (int it = 0; it < nkt16; ++it) {
    unsigned a[4];
    mma::ldsm_x4_trans(a, Xs + (size_t)(16 * it + xrow) * ldx + c0 + xcol);
#pragma unroll
    for (int dp = 0; dp < KD; ++dp) {
      if (2 * dp >= ndt8) continue;
      unsigned b[4];
      mma::ldsm_x4_trans(b, Bs + (size_t)(16 * it + brow) * ld + dp * 16 + bcol);
      mma::mma_bf16(acc[2 * dp], a, b[0], b[1]);
      if (2 * dp + 1 < ndt8) mma::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of an (N, D) row-major bf16 output from m16n8
// accumulator tiles over D; rows past N and columns past D are not stored
template <int KD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[2 * KD][4],
                                           int r0, int N, int D, int ndt8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= N) continue;
    bf16* row = dst + (size_t)r * D;
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt) {
      if (dt >= ndt8) continue;
      const int d = 8 * dt + 2 * t;
      const float x = acc[dt][2 * half], y = acc[dt][2 * half + 1];
      if ((D & 1) == 0) {
        // D even: d < D means d + 1 < D, and the pair is 4-byte aligned
        if (d < D) *reinterpret_cast<unsigned*>(row + d) = mma::pack_bf16(x, y);
      } else {
        if (d < D) row[d] = __float2bfloat16(x);
        if (d + 1 < D) row[d + 1] = __float2bfloat16(y);
      }
    }
  }
}

// rows r and r + 8 of dS in float32, keys m and m + 1 (the accumulator
// layout), into a (window, head)'s N x N slab of the bias gradient's partials
__device__ __forceinline__ void store_ds(float* __restrict__ slab, int N, int r, int m, float a,
                                         float b, float c, float d) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= N || m >= N) continue;
    float* p = slab + (size_t)row * N + m;
    const float x = half ? c : a, y = half ? d : b;
    if ((N & 1) == 0) {
      // N even: m < N means m + 1 < N, and the pair is 8-byte aligned
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    } else {
      p[0] = x;
      if (m + 1 < N) p[1] = y;
    }
  }
}

// DB: the bias trains, dS goes to ds_part too
template <int KT16, int KD, bool DB>
__global__ void __launch_bounds__(32 * KT16, min_blocks<KT16, KD>())
window_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                bf16* __restrict__ dq, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, float* __restrict__ ds_part, int H, int N,
                                int D, int nW, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = 16 * KD + 8;
  const int nkt16 = (N + 15) >> 4, rows = 16 * nkt16, ldp = rows + 8;
  const size_t tile = (size_t)rows * ld;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + tile;
  bf16* Vs = Ks + tile;
  bf16* Gs = Vs + tile;  // dO
  bf16* Ps = Gs + tile;  // [rows][ldp]: P, then dS
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's query rows and, in steps 3 and 5, keys
  const int ndt8 = (D + 7) >> 3;

  const int bh = blockIdx.x;  // bw * H + h
  const int bw = bh / H, h = bh - bw * H;
  const size_t base = (size_t)bh * N * D;

  // 1. q, k, v, dO into shared memory, zero past N rows and D columns
  if (vec) {
    const int per = rows * 2 * KD;  // 16-byte chunks of one tensor
    for (int e = threadIdx.x; e < 4 * per; e += blockDim.x) {
      const int ts = e / per, rem = e - ts * per, r = rem / (2 * KD), cc = rem - r * 2 * KD;
      const bf16* src = (ts == 0 ? q : ts == 1 ? k : ts == 2 ? v : dout) + base;
      const bool ok = r < N && cc * 8 < D;
      cp_async16(Qs + ts * tile + (size_t)r * ld + cc * 8, ok ? src + (size_t)r * D + cc * 8 : src,
                 ok);
    }
  } else {
    const int per = rows * 16 * KD;
    for (int e = threadIdx.x; e < 4 * per; e += blockDim.x) {
      const int ts = e / per, rem = e - ts * per, r = rem / (16 * KD), d = rem - r * 16 * KD;
      const bf16* src = (ts == 0 ? q : ts == 1 ? k : ts == 2 ? v : dout) + base;
      Qs[ts * tile + (size_t)r * ld + d] =
          r < N && d < D ? src[(size_t)r * D + d] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();

  // D_i of rows r0 + g (D0) and r0 + g + 8 (D1), in the accumulator layout
  float D0 = 0.f, D1 = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= N) continue;
    const size_t row = base + (size_t)r * D;
    float acc = 0.f;
    for (int d = 2 * t; d < D; d += 8) {
      acc = fmaf(__bfloat162float(dout[row + d]), __bfloat162float(out[row + d]), acc);
      if (d + 1 < D)
        acc = fmaf(__bfloat162float(dout[row + d + 1]), __bfloat162float(out[row + d + 1]), acc);
    }
    (half ? D1 : D0) = acc;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    D0 += __shfl_xor_sync(0xffffffffu, D0, off);
    D1 += __shfl_xor_sync(0xffffffffu, D1, off);
  }

  // 2. S = bias + q k^T, P = softmax(S), staged as bf16
  {
    float s[2 * KT16][4];
    mma::load_logit_bias<2 * KT16>(s, bias + ((size_t)(bw % nW) * H + h) * N * N, nullptr, N,
                                   r0, 2 * nkt16);
    cp_async_wait<0>();
    __syncthreads();
    mma::qk_bf16<2 * KT16, KD>(s, Qs, Ks, ld, r0, nkt16);
    float inv0, inv1;
    mma::softmax_rows<2 * KT16>(s, 2 * nkt16, inv0, inv1);
    unsigned* p0 = reinterpret_cast<unsigned*>(Ps + (size_t)(r0 + g) * ldp + 2 * t);
    unsigned* p1 = reinterpret_cast<unsigned*>(Ps + (size_t)(r0 + g + 8) * ldp + 2 * t);
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j) {
      if (j >= 2 * nkt16) continue;
      p0[4 * j] = mma::pack_bf16(s[j][0] * inv0, s[j][1] * inv0);
      p1[4 * j] = mma::pack_bf16(s[j][2] * inv1, s[j][3] * inv1);
    }
  }
  __syncthreads();

  // 3. dv = P^T dO for keys r0 .. r0 + 15
  {
    float acc[2 * KD][4];
    xt_b<KD>(acc, Ps, ldp, r0, Gs, ld, nkt16, ndt8);
    store_rows<KD>(dv + base, acc, r0, N, D, ndt8);
  }
  __syncthreads();

  // 4. per 16-key chunk: dP = dO v^T, dS = P o (dP - D) over P, dq += dS k
  {
    unsigned ga[KD][4];
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
      mma::ldsm_x4(ga[kc], Gs + (size_t)(r0 + (lane & 15)) * ld + kc * 16 + (lane >> 4) * 8);
    const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 8;
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
    unsigned* p0 = reinterpret_cast<unsigned*>(Ps + (size_t)(r0 + g) * ldp + 2 * t);
    unsigned* p1 = reinterpret_cast<unsigned*>(Ps + (size_t)(r0 + g + 8) * ldp + 2 * t);
    float acc[2 * KD][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    for (int jc = 0; jc < nkt16; ++jc) {
      float dp[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        unsigned b[4];
        mma::ldsm_x4(b, Vs + (size_t)(16 * jc + krow) * ld + kc * 16 + kcol);
        mma::mma_bf16(dp[0], ga[kc], b[0], b[1]);
        mma::mma_bf16(dp[1], ga[kc], b[2], b[3]);
      }
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int w = 4 * (2 * jc + hh);  // the n8 tile's word offset
        const float2 pa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p0 + w));
        const float2 pb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p1 + w));
        const float s0 = pa.x * (dp[hh][0] - D0), s1 = pa.y * (dp[hh][1] - D0);
        const float s2 = pb.x * (dp[hh][2] - D1), s3 = pb.y * (dp[hh][3] - D1);
        if (DB)
          store_ds(ds_part + (size_t)bh * N * N, N, r0 + g, 16 * jc + 8 * hh + 2 * t, s0, s1, s2,
                   s3);
        a[2 * hh] = mma::pack_bf16(s0, s1);
        a[2 * hh + 1] = mma::pack_bf16(s2, s3);
        p0[w] = a[2 * hh];
        p1[w] = a[2 * hh + 1];
      }
#pragma unroll
      for (int dpp = 0; dpp < KD; ++dpp) {
        if (2 * dpp >= ndt8) continue;
        unsigned b[4];
        mma::ldsm_x4_trans(b, Ks + (size_t)(16 * jc + vrow) * ld + dpp * 16 + vcol);
        mma::mma_bf16(acc[2 * dpp], a, b[0], b[1]);
        if (2 * dpp + 1 < ndt8) mma::mma_bf16(acc[2 * dpp + 1], a, b[2], b[3]);
      }
    }
    store_rows<KD>(dq + base, acc, r0, N, D, ndt8);
  }
  __syncthreads();

  // 5. dk = dS^T q for keys r0 .. r0 + 15
  {
    float acc[2 * KD][4];
    xt_b<KD>(acc, Ps, ldp, r0, Qs, ld, nkt16, ndt8);
    store_rows<KD>(dk + base, acc, r0, N, D, ndt8);
  }
}

template <int KT16, int KD, bool DB>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, const void* out,
               const void* dout, void* dq, void* dk, void* dv, float* ds, int BW, int H, int N,
               int D, int nW, cudaStream_t stream) {
  auto kernel = window_attention_bwd_mma_kernel<KT16, KD, DB>;
  static bool smem_set = false;  // the most this instantiation takes, set once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_shared_bytes(KT16, KD));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nkt16 = (N + 15) >> 4;
  // 16-byte cp.async copies where every row and source allows them
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const bool vec = D % 8 == 0 && (addr & 15) == 0;
  kernel<<<BW * H, 32 * nkt16, mma_shared_bytes(nkt16, KD), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), ds, H, N, D, nW, vec);
  return (int)cudaGetLastError();
}

template <bool DB>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, const void* out,
                const void* dout, void* dq, void* dk, void* dv, float* ds, int BW, int H, int N,
                int D, int nW, cudaStream_t s) {
  if (D <= 32) {
    if (N <= 64)
      return launch_mma<4, 2, DB>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
    return launch_mma<9, 2, DB>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
  }
  if (N <= 64)
    return launch_mma<4, 4, DB>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
  return launch_mma<9, 4, DB>(q, k, v, bias, out, dout, dq, dk, dv, ds, BW, H, N, D, nW, s);
}

// floats of the workspace window_attention_bwd needs for a bias gradient:
// the (BW, H, N, N) partials and the column sums' scratch
size_t workspace_floats(int BW, int H, int N, int nW) {
  const long long slab = (long long)nW * H * N * N;
  return (size_t)BW * H * N * N + colsum::scratch_floats(BW / nW, slab);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of
// it; bias float32). dbias: null (a frozen bias), or the float32 (nW, H, N,
// N) bias gradient, with ws holding window_attention_bwd_workspace(...)
// floats. Returns a cudaError_t (0 on success).
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* out, const void* dout,
                                    void* dq, void* dk, void* dv, void* dbias, void* ws, int BW,
                                    int H, int N, int D, int nW, int dtype, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || D > kMaxD || nW < 1 || BW % nW != 0 ||
      (dbias && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* part = dbias ? static_cast<float*>(ws) : nullptr;
  int err;
  if (dtype == 0)
    err = launch_f32_by_n(q, k, v, b, out, dout, dq, dk, dv, part, BW, H, N, D, nW, s);
  else if (dtype == 1)
    err = part ? launch_bf16<true>(q, k, v, b, out, dout, dq, dk, dv, part, BW, H, N, D, nW, s)
               : launch_bf16<false>(q, k, v, b, out, dout, dq, dk, dv, part, BW, H, N, D, nW, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err || !part) return err;
  // the frames' slabs of each (window, head), summed in frame order
  return colsum::column_sums(part, static_cast<float*>(dbias), part + (size_t)BW * H * N * N,
                             BW / nW, (long long)nW * H * N * N, s);
}

extern "C" long long window_attention_bwd_workspace(int BW, int H, int N, int nW) {
  if (N < 1 || nW < 1 || BW % nW != 0) return -1;
  return (long long)workspace_floats(BW, H, N, nW);
}
