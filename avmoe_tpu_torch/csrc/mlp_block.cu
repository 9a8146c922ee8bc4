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
// What the design does about that. Both bf16 products are one NT kernel,
// C[m, n] = epi(sum_k A[m, k] B[n, k] + bias[n]), on mma.sync m16n8k16 (bf16
// operands, float32 accumulators). A CTA of 8 warps owns a 128 x BN output
// tile and walks k in 64-deep steps through a 3-stage cp.async ring, so the
// loads of step s + 2 are in flight while step s is multiplied; two CTAs
// share an SM (at most 128 registers a thread). Both operands are
// k-contiguous in shared memory (rows padded by 8 elements, so ldmatrix's
// eight 16-byte row reads hit distinct banks) and reach the warps by
// ldmatrix.x4, without .trans for B (the nn.Linear weight is (N, K)). BN is
// 128 (warps 2 x 4 of 64 x 32: an A fragment serves 4 MMAs, a B fragment 4)
// or 96 (warps 4 x 2 of 32 x 48: 6 and 2); the wrapper picks it per product
// (kernels/mlp_block.py `pick_tile`) from the SM count, the SMs' load and
// the operand bytes through L2, which bound these products (PERF.md). The
// epilogues add the bias, on fc1 the exact-erf GELU, stage the tile in
// shared memory as float32 and store 16-byte chunks of bf16 rows; fc2 adds
// b2, and on V1 also the residual x there, writing `out` directly. Every
// output rounds to bf16 once (fc1's hidden activations too). V2's LayerNorm
// needs whole rows of fc2's output, so it stays a row pass (x + LN(f)), as
// does V1's pre-norm; the row passes move 16 bytes a lane and keep float32
// statistics (mean of squares minus squared mean, as the TPU kernel).
// float32 inputs take a CUDA-core tiled product (64x64 tiles, 4x4 outputs
// per thread) so that float32 stays float32. The hidden (R, Hd) activations
// make one round trip through device memory (about 1 ms per forward at
// 3.35 TB/s); keeping them on chip is later work.
//
// The bf16 path requires C % 8 == 0 and 16-byte aligned x, w1, w2 (every
// row of every operand then starts on a 16-byte boundary); the wrapper
// checks it and raises otherwise.
//
// DropPath scale (train). With a per-frame float32 scale s (row r belongs to
// frame r / rows_per_frame) the block is out = x + s (.) branch: V1 scales in
// fc2's epilogue, V2 in the LN row pass. Without one, the kernels and
// numbers above are unchanged (the scaled ones are other instantiations).
//
// K2b, the backward (mlp_block_bwd): dx, from what the forward kept in
// training: fc1's pre-activation h1 (fc1's kEpiGeluSave epilogue writes it
// beside gelu(h1); eval forwards keep kEpiGelu) and, on V2, fc2's output f.
// With g = s (.) dy:
//   V2: d_h2 = LN-backward(g; f) (row pass); d_h1 = (d_h2 w2) (.) gelu'(h1);
//       dx = dy + d_h1 w1
//   V1: d_h1 = (g w2) (.) gelu'(h1); dx = dy + LN-backward(d_h1 w1; x) (row
//       pass, x's statistics recomputed)
// Two products, 4 R C Hd operations, and no forward product run again. What
// bounds K2b: at every main-path shape but Swin-V2 stage 1 and HTS-AT stages
// 1-2 (bound by their bytes: h1 is read once, (R, Hd)) the two products
// bound it, so in bf16 they run on the wgmma kernel of gemm_wgmma.cuh
// (persistent, TMA ring, two consumer warpgroups, 128 x BN tiles picked per
// product by the wrapper), the only route to the tensor cores' full rate; their B operands
// are the transposed copies w1t = w1^T (C, Hd) and w2t = w2^T (Hd, C), which
// the wrapper keeps once per model and dtype, so both operands are K-major.
// Their epilogues: x gelu'(h1) (and x s on V1); + dy without a bias; none.
// float32 takes the CUDA-core product (exact, for the gradient checks).
//
// Where the weights train (a trainable backbone), K2b also gives the column
// sums of the parameter gradients, float32, in the passes it runs anyway:
//   db1 = sum_r d_h1                      the d_h1 product's epilogue
//   V1: d ln_w = sum_r (d_h1 w1) o xh, d ln_b = sum_r d_h1 w1, db2 = sum_r g
//   V2: d ln_w = sum_r g o fh, d ln_b = sum_r g, db2 = sum_r d_h2
//                                         the LayerNorm-backward row pass
// (xh, fh: the normalized x or f). Each tile of the product and each CTA of
// the row pass writes its float32 partial sums to a row of a buffer, which
// column_sums.cuh sums in row order: no atomics, the same bits every run.
// On V1 with a DropPath scale the row pass also writes g for dW2. The two
// weight products, dW2 = g^T gelu(h1) (V2: d_h2^T gelu(h1)) and dW1 = d_h1^T
// LN(x) (V2: d_h1^T x), reduce over the rows; the wrapper runs them as
// float32-output products on the buffers above. With frozen weights none of
// this runs (null pointers; the summing kernels are other instantiations).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "column_sums.cuh"
#include "common.cuh"
#include "cp_async.cuh"
#include "gemm_wgmma.cuh"

namespace {

using namespace avmoe;

// epilogues of a product, v = sum_k A[m, k] B[n, k]:
//   kEpiBias       v + bias
//   kEpiGelu       gelu(v + bias)
//   kEpiResid      v + bias + resid
//   kEpiResidScale s[m / rpf] (v + bias) + resid          (V1 fc2, DropPath)
//   kEpiGeluSave   gelu(v + bias), and v + bias into out2  (fc1 in training)
//   kEpiGeluGrad   v gelu'(aux) [s[m / rpf]], aux in resid (K2b)
//   kEpiAdd        v + resid                               (K2b dx)
//   kEpiPlain      v                                       (K2b)
constexpr int kEpiBias = 0, kEpiGelu = 1, kEpiResid = 2, kEpiResidScale = 3, kEpiGeluSave = 4,
              kEpiGeluGrad = 5, kEpiAdd = 6, kEpiPlain = 7;

template <int EPI> __host__ __device__ constexpr bool has_bias() { return EPI <= kEpiGeluSave; }

// what the epilogues beyond bias and resid read: the per-frame scale (null:
// none), rows per frame, kEpiGeluSave's second output, and the float32
// product's column partial sums of kEpiGeluGrad (null: none; K2b's db1)
template <typename T> struct EpiExtra {
  const float* scale;
  int rpf;
  T* out2;
  float* colsum = nullptr;
};

__device__ __forceinline__ float gelu_erf_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  return fmaf(x * 0.39894228040143268f, expf(-0.5f * x * x), cdf);
}

// the element epilogue after bias / GELU: resid (or aux) and scale applied
template <int EPI, typename T>
__device__ __forceinline__ float finish(float v, float r, int row, const EpiExtra<T>& ex) {
  if (EPI == kEpiResid || EPI == kEpiAdd) return v + r;
  if (EPI == kEpiResidScale) return fmaf(ex.scale[row / ex.rpf], v, r);
  if (EPI == kEpiGeluGrad) {
    v *= gelu_erf_grad(r);
    return ex.scale ? v * ex.scale[row / ex.rpf] : v;
  }
  return v;
}

// ---------------------------------------------------------------------------
// bf16 product on the tensor cores: C[m, n] = epi(sum_k A[m, k] B[n, k] + bias[n])
// A (M, K), B (N, K), resid and C (M, N), all row-major; K % 8 == 0, N % 8 == 0.
// ---------------------------------------------------------------------------

constexpr int kBK = 64, kLd = kBK + 8, kStages = 3;
constexpr int kChunksK = kBK / 8;  // 16-byte chunks in a row of a k-step

// A CTA tile: warps WARPS_M x WARPS_N, each MF 16-row fragments by NF
// 8-column tiles; BM x BN outputs, THREADS threads
template <int WM, int WN, int MF_, int NF_> struct Tile {
  static constexpr int WARPS_M = WM, WARPS_N = WN, MF = MF_, NF = NF_;
  static constexpr int BM = WM * MF_ * 16, BN = WN * NF_ * 8, THREADS = 32 * WM * WN;
  static constexpr size_t SMEM = (size_t)kStages * (BM + BN) * kLd * sizeof(bf16);
};
// the tile of each output width (pick_tile's TILE_WIDTHS)
template <int BN> struct TileShape;
template <> struct TileShape<128> : Tile<2, 4, 4, 4> {};
template <> struct TileShape<96> : Tile<4, 2, 2, 6> {};

template <int EPI> __device__ __forceinline__ float act(float v) {
  return EPI == kEpiGelu ? gelu_erf(v) : v;
}

template <int BN, int EPI>
__global__ void __launch_bounds__(TileShape<BN>::THREADS, 2)
mlp_gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
              const float* __restrict__ bias, const bf16* __restrict__ resid,
              bf16* __restrict__ C, int M, int N, int K, EpiExtra<bf16> ex) {
  using S = TileShape<BN>;
  constexpr int MF = S::MF, NF = S::NF, BM = S::BM, THREADS = S::THREADS;
  static_assert(S::BN == BN && NF % 2 == 0 && THREADS % kChunksK == 0,
                "warp tiles must cover the CTA tile");
  // a pass of the CTA's threads copies ROWS rows of a k-step, 16 bytes each
  constexpr int ROWS = THREADS / kChunksK;
  constexpr int A_PASSES = (BM + ROWS - 1) / ROWS, B_PASSES = (BN + ROWS - 1) / ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [kStages][BM][kLd]
  bf16* Bs = As + kStages * BM * kLd;        // [kStages][BN][kLd]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  // N tiles vary fastest over the grid: neighbouring CTAs share their A rows
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + kBK - 1) / kBK;
  // ldmatrix row addresses of this lane. A (x4): rows 0-15, k 0 / 8. B (x4,
  // two n8 tiles): matrices (n 0-7, k 0), (n 0-7, k 8), (n 8-15, k 0),
  // (n 8-15, k 8), the b0 / b1 registers of n tile 0, then of n tile 1
  const int a_off = (wm * MF * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int b_off = (wn * NF * 8 + (lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
  // this thread's copies: row cr + ROWS i of each tile, k chunk kc; bit i of
  // a_rows / b_rows says that row lies inside the matrix
  const int cr = tid / kChunksK, kc = (tid % kChunksK) * 8;
  const bf16* a_src = A + (size_t)(m0 + cr) * K + kc;
  const bf16* b_src = B + (size_t)(n0 + cr) * K + kc;
  unsigned a_rows = 0, b_rows = 0;
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) a_rows |= (unsigned)(m0 + cr + ROWS * i < M) << i;
#pragma unroll
  for (int i = 0; i < B_PASSES; ++i) b_rows |= (unsigned)(n0 + cr + ROWS * i < N) << i;

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group per k-step: its A and B tiles, zero-filled past M, N, K
  auto load = [&](int buf, int kt) {
    const int k0 = kt * kBK;
    const bool kok = k0 + kc < K;
    bf16* as = As + buf * BM * kLd + cr * kLd + kc;
    bf16* bs = Bs + buf * BN * kLd + cr * kLd + kc;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      if (BM % ROWS && cr + ROWS * i >= BM) break;
      const bool ok = kok && (a_rows >> i & 1);
      cp_async16(as + ROWS * i * kLd, ok ? a_src + (size_t)ROWS * i * K + k0 : A, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      if (BN % ROWS && cr + ROWS * i >= BN) break;
      const bool ok = kok && (b_rows >> i & 1);
      cp_async16(bs + ROWS * i * kLd, ok ? b_src + (size_t)ROWS * i * K + k0 : B, ok);
    }
    cp_async_commit();
  };

  // kStages - 1 steps in flight ahead of the one in use; a group is
  // committed for every step, empty past the end, so that the count of
  // pending groups says which step has landed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    else cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // step kt has landed, and every warp is done with step kt - 1, whose
    // buffer the next load refills
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    else cp_async_commit();
    const bf16* as = As + (kt % kStages) * BM * kLd + a_off;
    const bf16* bs = Bs + (kt % kStages) * BN * kLd + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[MF][4], b[NF / 2][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) mma::ldsm_x4(a[i], as + i * 16 * kLd + kk);
#pragma unroll
      for (int j = 0; j < NF / 2; ++j) mma::ldsm_x4(b[j], bs + j * 16 * kLd + kk);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF / 2; ++j) {
          mma::mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma::mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }

  // epilogue: the tile goes through the ring's shared memory as float32
  // (bias and GELU added), so that each thread then stores whole 16-byte
  // chunks of a row, adding the residual there: every output rounds to bf16
  // once
  constexpr int LDC = BN + 8;  // float2 stores of a half-warp hit 32 banks
  static_assert((size_t)BM * LDC * sizeof(float) <= S::SMEM, "the tile must fit the ring");
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int cl = (wn * NF + j) * 8 + 2 * t;
    const float2 bb = has_bias<EPI>() && n0 + cl < N
                          ? *reinterpret_cast<const float2*>(bias + n0 + cl)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      const int rl = (wm * MF + i) * 16 + g;
      *reinterpret_cast<float2*>(cs + rl * LDC + cl) =
          make_float2(act<EPI>(acc[i][j][0] + bb.x), act<EPI>(acc[i][j][1] + bb.y));
      *reinterpret_cast<float2*>(cs + (rl + 8) * LDC + cl) =
          make_float2(act<EPI>(acc[i][j][2] + bb.x), act<EPI>(acc[i][j][3] + bb.y));
    }
  }
  __syncthreads();
  constexpr int CHUNKS = BN / 8;
#pragma unroll
  for (int c = tid; c < BM * CHUNKS; c += THREADS) {
    const int rl = c / CHUNKS, cl = (c % CHUNKS) * 8;
    if (m0 + rl >= M || n0 + cl >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(cs + rl * LDC + cl);
    const float4 hi = *reinterpret_cast<const float4*>(cs + rl * LDC + cl + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t idx = (size_t)(m0 + rl) * N + n0 + cl;
    if (EPI == kEpiResid) {
      const uint4 x = *reinterpret_cast<const uint4*>(resid + idx);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xp[e]);
        v[2 * e] += f.x;
        v[2 * e + 1] += f.y;
      }
    } else if (EPI == kEpiResidScale) {
      const uint4 x = *reinterpret_cast<const uint4*>(resid + idx);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xp[e]);
        v[2 * e] = finish<EPI>(v[2 * e], f.x, m0 + rl, ex);
        v[2 * e + 1] = finish<EPI>(v[2 * e + 1], f.y, m0 + rl, ex);
      }
    } else if (EPI == kEpiGeluSave) {
      uint4 o2;
      unsigned* op2 = reinterpret_cast<unsigned*>(&o2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        op2[e] = mma::pack_bf16(v[2 * e], v[2 * e + 1]);
        v[2 * e] = gelu_erf(v[2 * e]);
        v[2 * e + 1] = gelu_erf(v[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(ex.out2 + idx) = o2;
    }
    uint4 o;
    unsigned* op = reinterpret_cast<unsigned*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) op[e] = mma::pack_bf16(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(C + idx) = o;
  }
}

template <int BN, int EPI>
int launch_bf16(const bf16* A, const bf16* B, const float* bias, const bf16* resid, bf16* C,
                int M, int N, int K, const EpiExtra<bf16>& ex, cudaStream_t stream) {
  const int mtiles = (M + TileShape<BN>::BM - 1) / TileShape<BN>::BM;
  if (mtiles > 65535) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = TileShape<BN>::SMEM;
  // the shared-memory limit is set once per kernel: the forward is
  // host-bound, and the call would run on every launch
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_gemm_bf16<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((N + BN - 1) / BN, mtiles);
  mlp_gemm_bf16<BN, EPI><<<grid, TileShape<BN>::THREADS, smem, stream>>>(A, B, bias, resid, C,
                                                                         M, N, K, ex);
  return (int)cudaGetLastError();
}

template <int EPI>
int gemm_bf16(int tile_n, const void* A, const void* B, const float* bias, const void* resid,
              void* C, int M, int N, int K, cudaStream_t s, const float* scale = nullptr,
              int rpf = 1, void* out2 = nullptr) {
  const bf16 *a = static_cast<const bf16*>(A), *b = static_cast<const bf16*>(B);
  const bf16* r = static_cast<const bf16*>(resid);
  bf16* c = static_cast<bf16*>(C);
  const EpiExtra<bf16> ex{scale, rpf, static_cast<bf16*>(out2)};
  switch (tile_n) {
    case 128: return launch_bf16<128, EPI>(a, b, bias, r, c, M, N, K, ex, s);
    case 96: return launch_bf16<96, EPI>(a, b, bias, r, c, M, N, K, ex, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// float32 product on the CUDA cores (same contract)
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

template <int EPI>
__global__ void __launch_bounds__(256)
mlp_gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ bias, const float* __restrict__ resid,
             float* __restrict__ C, int M, int N, int K, EpiExtra<float> ex) {
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
  float cs[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's columns over its rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm >= M || gn >= N) continue;
      const size_t idx = (size_t)gm * N + gn;
      float v = acc[i][j];
      if (has_bias<EPI>()) v += bias[gn];
      if (EPI == kEpiGelu) v = gelu_erf(v);
      if (EPI == kEpiResid) v += resid[idx];
      if (EPI == kEpiResidScale || EPI == kEpiGeluGrad || EPI == kEpiAdd)
        v = finish<EPI>(v, resid[idx], gm, ex);
      if (EPI == kEpiGeluSave) {
        ex.out2[idx] = v;
        v = gelu_erf(v);
      }
      C[idx] = v;
      cs[j] += v;
    }
  }
  if (EPI == kEpiGeluGrad && ex.colsum) {
    // the tile's column sums: the 16 row groups through As (free since the
    // last k-step's barrier), summed in order; row blockIdx.x of the partials
    float* red = &As[0][0];
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * (kSBM + 4) + tx * 4 + j] = cs[j];
    __syncthreads();
    if (tid < kSBN && n0 + tid < N) {
      float sum = 0.f;
      for (int y = 0; y < 16; ++y) sum += red[y * (kSBM + 4) + tid];
      ex.colsum[(size_t)blockIdx.x * N + n0 + tid] = sum;
    }
  }
}

template <int EPI>
int gemm_f32(const void* A, const void* B, const float* bias, const void* resid, void* C,
             int M, int N, int K, cudaStream_t stream, const float* scale = nullptr,
             int rpf = 1, void* out2 = nullptr, float* colsum = nullptr) {
  dim3 grid((M + kSBM - 1) / kSBM, (N + kSBN - 1) / kSBN);
  const EpiExtra<float> ex{scale, rpf, static_cast<float*>(out2), colsum};
  mlp_gemm_f32<EPI><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), bias,
      static_cast<const float*>(resid), static_cast<float*>(C), M, N, K, ex);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row pass, one warp per row, V elements (16 bytes where the row allows) a
// lane per step:
//   RESID false: out = LN(src)              (V1 pre-norm; src = x)
//   RESID true:  out = x + LN(src)          (V2 post-norm + residual; src = fc2 output)
//   SCALE:       out = x + s[r / rpf] LN(src)  (V2 with a DropPath scale)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

template <int V, typename T>
__device__ __forceinline__ void load_vec(float (&v)[V], const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(p[i]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_float<T>(v[i]);
  }
}

// float32 mean and 1 / sqrt(var + eps) of one row, var = E[v^2] - mean^2
template <int V, typename T>
__device__ __forceinline__ void row_stats(const T* src, int C, int lane, float eps, float& mean,
                                          float& inv) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V];
    load_vec<V>(v, src + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum += v[i];
      sq += v[i] * v[i];
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mean = sum / C;
  inv = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
}

template <typename T, bool RESID, bool SCALE, int V>
__global__ void __launch_bounds__(kRowThreads)
mlp_rows(const T* __restrict__ x, const T* __restrict__ src, const float* __restrict__ w,
         const float* __restrict__ b, T* __restrict__ out, int R, int C, float eps,
         const float* __restrict__ scale, int rpf) {
  const int row = (blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const size_t base = (size_t)row * C;
  float mean, inv;
  row_stats<V>(src + base, C, lane, eps, mean, inv);
  const float s = SCALE ? scale[row / rpf] : 1.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V];
    load_vec<V>(v, src + base + c);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (v[i] - mean) * inv * w[c + i] + b[c + i];
    if (RESID) {
      float r[V];
      load_vec<V>(r, x + base + c);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = SCALE ? fmaf(s, v[i], r[i]) : v[i] + r[i];
    }
    store_vec<V>(out + base + c, v);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool RESID, bool SCALE = false>
int launch_rows(const void* x, const void* src, const float* w, const float* b, void* out,
                int R, int C, float eps, cudaStream_t stream, const float* scale = nullptr,
                int rpf = 1) {
  constexpr int V = 16 / sizeof(T);
  const int grid = (R + kRowThreads / 32 - 1) / (kRowThreads / 32);
  const T* xs = static_cast<const T*>(x);
  const T* ss = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (C % V == 0 && aligned16(x) && aligned16(src) && aligned16(out))
    mlp_rows<T, RESID, SCALE, V><<<grid, kRowThreads, 0, stream>>>(xs, ss, w, b, o, R, C, eps,
                                                                   scale, rpf);
  else
    mlp_rows<T, RESID, SCALE, 1><<<grid, kRowThreads, 0, stream>>>(xs, ss, w, b, o, R, C, eps,
                                                                   scale, rpf);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm-backward row pass (K2b), one warp per row: with y = LN(src) w + b
// and its gradient dy = [s[r / rpf]] g,
//   out = [resid +] inv (dxh - mean(dxh) - xh mean(dxh xh)),
// xh = (src - mean) inv, dxh = dy w; statistics recomputed in float32 as the
// forward computes them.
// ---------------------------------------------------------------------------

template <typename T, bool RESID, bool SCALE, int V>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows(const T* __restrict__ src, const T* __restrict__ g, const float* __restrict__ w,
            const T* __restrict__ resid, T* __restrict__ out, int R, int C, float eps,
            const float* __restrict__ scale, int rpf) {
  const int row = (blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const size_t base = (size_t)row * C;
  float mean, inv;
  row_stats<V>(src + base, C, lane, eps, mean, inv);
  const float s = SCALE ? scale[row / rpf] : 1.f;
  float sd = 0.f, sdx = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V], d[V];
    load_vec<V>(v, src + base + c);
    load_vec<V>(d, g + base + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float dxh = s * d[i] * w[c + i];
      sd += dxh;
      sdx += dxh * (v[i] - mean) * inv;
    }
  }
  sd = warp_sum(sd) / C;
  sdx = warp_sum(sdx) / C;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V], d[V];
    load_vec<V>(v, src + base + c);
    load_vec<V>(d, g + base + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = (v[i] - mean) * inv;
      d[i] = inv * (s * d[i] * w[c + i] - sd - xh * sdx);
    }
    if (RESID) {
      float r[V];
      load_vec<V>(r, resid + base + c);
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] += r[i];
    }
    store_vec<V>(out + base + c, d);
  }
}

template <typename T, bool RESID, bool SCALE>
int launch_ln_bwd(const void* src, const void* g, const float* w, const void* resid, void* out,
                  int R, int C, float eps, const float* scale, int rpf, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int grid = (R + kRowThreads / 32 - 1) / (kRowThreads / 32);
  const T* ss = static_cast<const T*>(src);
  const T* gs = static_cast<const T*>(g);
  const T* rs = static_cast<const T*>(resid);
  T* o = static_cast<T*>(out);
  if (C % V == 0 && aligned16(src) && aligned16(g) && aligned16(out) &&
      (!RESID || aligned16(resid)))
    ln_bwd_rows<T, RESID, SCALE, V><<<grid, kRowThreads, 0, stream>>>(ss, gs, w, rs, o, R, C,
                                                                      eps, scale, rpf);
  else
    ln_bwd_rows<T, RESID, SCALE, 1><<<grid, kRowThreads, 0, stream>>>(ss, gs, w, rs, o, R, C,
                                                                      eps, scale, rpf);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2b's row pass where the weights train: the LayerNorm backward of
// ln_bwd_rows and, beside it, the CTA's float32 partial sums over its rows,
// part[blockIdx.x] = [d ln_w (C), d ln_b (C), db2 (C)]:
//   V1 (resid = dy, g = d_h1 w1, no scale inside the norm):
//       out = dy + LN-backward(g; src),  sums g xh, g, s dy; gs = s dy
//   V2 (g = dy, the scale s inside the norm):
//       out = LN-backward(s dy; src),    sums s dy xh, s dy, out
// A warp walks rpw rows (the CTA's rows w, w + 8, ...), adding into its own
// [3][C] slice of shared memory (a lane owns its columns, so each column is
// summed in row order); the CTA then sums its 8 slices in warp order. rpw
// depends on R alone (sum_rows_per_warp): as few rows a warp as keep about
// two waves of CTAs on the card, at most 16.
// ---------------------------------------------------------------------------

constexpr int kSumWarps = kRowThreads / 32;

int sum_rows_per_warp(int R) {
  const int per = (R + kSumWarps * 264 - 1) / (kSumWarps * 264);
  return per < 1 ? 1 : (per > 16 ? 16 : per);
}
int sum_ctas(int R) {
  const int rows = kSumWarps * sum_rows_per_warp(R);
  return (R + rows - 1) / rows;
}

template <typename T, bool V1, bool SCALE, int V>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_sums(const T* __restrict__ src, const T* __restrict__ g, const float* __restrict__ w,
                 const T* __restrict__ resid, T* __restrict__ out, T* __restrict__ gs,
                 float* __restrict__ part, int R, int C, int rpw, float eps,
                 const float* __restrict__ scale, int rpf) {
  extern __shared__ float acc[];   // [8 warps][3][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = acc + (size_t)warp * 3 * C;
  for (int c = lane; c < 3 * C; c += 32) mine[c] = 0.f;
  __syncwarp();
  for (int i = 0; i < rpw; ++i) {
    const int row = (blockIdx.x * rpw + i) * kSumWarps + warp;
    if (row >= R) break;
    const size_t base = (size_t)row * C;
    float mean, inv;
    row_stats<V>(src + base, C, lane, eps, mean, inv);
    const float s = SCALE ? scale[row / rpf] : 1.f;
    const float s_ln = V1 ? 1.f : s;   // the scale inside the norm's gradient (V2)
    float sd = 0.f, sdx = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float v[V], d[V];
      load_vec<V>(v, src + base + c);
      load_vec<V>(d, g + base + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float dxh = s_ln * d[k] * w[c + k];
        sd += dxh;
        sdx += dxh * (v[k] - mean) * inv;
      }
    }
    sd = warp_sum(sd) / C;
    sdx = warp_sum(sdx) / C;
    for (int c = lane * V; c < C; c += 32 * V) {
      float v[V], d[V], o[V];
      load_vec<V>(v, src + base + c);
      load_vec<V>(d, g + base + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (v[k] - mean) * inv, gk = s_ln * d[k];
        o[k] = inv * (gk * w[c + k] - sd - xh * sdx);
        mine[c + k] += gk * xh;
        mine[C + c + k] += gk;
      }
      if (V1) {
        float r[V];
        load_vec<V>(r, resid + base + c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          o[k] += r[k];
          r[k] *= s;
          mine[2 * C + c + k] += r[k];
        }
        if (SCALE) store_vec<V>(gs + base + c, r);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) mine[2 * C + c + k] += o[k];
      }
      store_vec<V>(out + base + c, o);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * C; c += kRowThreads) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kRowThreads / 32; ++k) sum += acc[(size_t)k * 3 * C + c];
    part[(size_t)blockIdx.x * 3 * C + c] = sum;
  }
}

size_t sums_shared_bytes(int C) { return (size_t)(kRowThreads / 32) * 3 * C * sizeof(float); }

template <typename T, bool V1, bool SCALE, int V>
int launch_ln_sums_v(const void* src, const void* g, const float* w, const void* resid,
                     void* out, void* gs, float* part, int R, int C, float eps,
                     const float* scale, int rpf, cudaStream_t stream) {
  auto kernel = ln_bwd_rows_sums<T, V1, SCALE, V>;
  static size_t smem_set = 48 * 1024;   // what needs no attribute
  const size_t smem = sums_shared_bytes(C);
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  kernel<<<sum_ctas(R), kRowThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(g), w, static_cast<const T*>(resid),
      static_cast<T*>(out), static_cast<T*>(gs), part, R, C, sum_rows_per_warp(R), eps, scale,
      rpf);
  return (int)cudaGetLastError();
}

template <typename T, bool V1, bool SCALE>
int launch_ln_sums(const void* src, const void* g, const float* w, const void* resid, void* out,
                   void* gs, float* part, int R, int C, float eps, const float* scale, int rpf,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (sums_shared_bytes(C) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (C % V == 0 && aligned16(src) && aligned16(g) && aligned16(out) &&
      (!V1 || aligned16(resid)) && (!gs || aligned16(gs)))
    return launch_ln_sums_v<T, V1, SCALE, V>(src, g, w, resid, out, gs, part, R, C, eps, scale,
                                             rpf, stream);
  return launch_ln_sums_v<T, V1, SCALE, 1>(src, g, w, resid, out, gs, part, R, C, eps, scale,
                                           rpf, stream);
}

template <int EPI>
int gemm(int dtype, int tile_n, const void* A, const void* B, const float* bias,
         const void* resid, void* C, int M, int N, int K, cudaStream_t s,
         const float* scale = nullptr, int rpf = 1, void* out2 = nullptr) {
  if (dtype == 1)
    return gemm_bf16<EPI>(tile_n, A, B, bias, resid, C, M, N, K, s, scale, rpf, out2);
  return gemm_f32<EPI>(A, B, bias, resid, C, M, N, K, s, scale, rpf, out2);
}

// gelu'(x) = Phi(x) + x phi(x) for the bf16 products' epilogue, with the
// normal tail from Abramowitz and Stegun 26.2.17: 1 - Phi(|x|) = phi(x)
// (b1 t + ... + b5 t^5), t = 1 / (1 + p |x|), |error| < 7.5e-8, far below
// the output's bf16 rounding. It shares phi's exponential: one ex2 and one
// rcp, no branch (erff's two ranges diverge within a warp). The d_h1
// product's epilogue computes it for every output and is bound by these
// instructions (PERF.md). float32 keeps erff and expf.
__device__ __forceinline__ float gelu_grad_fast(float x) {
  float ph, t;   // phi(x) = 2^(-x^2 log2(e) / 2 + log2(1 / sqrt(2 pi)))
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(ph)
      : "f"(fmaf(x * x, -0.72134752044448170f, -1.3257480647f)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.2316419f, fabsf(x), 1.f)));
  const float poly = fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.330274429f, -1.821255978f),
                                          1.781477937f), -0.356563782f), 0.319381530f);
  const float tail = t * poly * ph;
  return fmaf(x, ph, x >= 0.f ? 1.f - tail : tail);
}

// K2b's products: bf16 on the wgmma kernel (gemm_wgmma.cuh), float32 on
// the CUDA cores. SUMS: the column sums of the output into col_part (db1)
template <int EPI, bool SUMS = false> struct ProductEpi {
  static constexpr bool kReadsAux = EPI != kEpiPlain;
  static constexpr bool kColSums = SUMS;
  EpiExtra<bf16> ex;
  float* col_part;
  __device__ __forceinline__ float pre(float aux) const {
    return EPI == kEpiGeluGrad ? gelu_grad_fast(aux) : aux;
  }
  // the DropPath scale of a row (1 without one), read once a row: a branch
  // or a division per element would keep the elements' chains apart
  __device__ __forceinline__ float row_factor(int row) const {
    return EPI == kEpiGeluGrad && ex.scale ? ex.scale[row / ex.rpf] : 1.f;
  }
  __device__ __forceinline__ float operator()(float v, float pre, float rf) const {
    if (EPI == kEpiGeluGrad) return v * pre * rf;
    return finish<EPI>(v, pre, 0, ex);
  }
};

// col_part: null, or the (M-tiles, N) column partial sums of the output
// (kEpiGeluGrad only; M-tiles of 128 rows in bf16, kSBM in float32)
template <int EPI>
int gemm_bwd(int dtype, int tile_n, const void* A, const void* B, const void* aux, void* C,
             int M, int N, int K, cudaStream_t s, const float* scale = nullptr, int rpf = 1,
             float* col_part = nullptr) {
  if (dtype == 1) {
    if (col_part)
      return wg::gemm(tile_n, A, B, aux, C, M, N, K,
                      ProductEpi<EPI, true>{{scale, rpf, nullptr}, col_part}, s);
    return wg::gemm(tile_n, A, B, aux, C, M, N, K,
                    ProductEpi<EPI>{{scale, rpf, nullptr}, nullptr}, s);
  }
  return gemm_f32<EPI>(A, B, nullptr, aux, C, M, N, K, s, scale, rpf, nullptr, col_part);
}

// rows of a product's column-partial tile (bf16: the wgmma tile; float32: the
// CUDA-core tile)
int partial_tile_rows(int dtype) { return dtype == 1 ? wg::kBM : kSBM; }

template <typename T>
int mlp_block(const void* x, const float* ln_w, const float* ln_b, const void* w1,
              const float* b1, const void* w2, const float* b2, void* h_ln, void* hid,
              void* f, void* out, void* h1, int R, int C, int Hd, int pre_norm, int dtype,
              int tile1, int tile2, float eps, const float* scale, int rpf, cudaStream_t s) {
  int err;
  const void* a1 = x;
  if (pre_norm) {
    if ((err = launch_rows<T, false>(x, x, ln_w, ln_b, h_ln, R, C, eps, s))) return err;
    a1 = h_ln;
  }
  // fc1; in training it also keeps its pre-activation h1 for K2b
  if (h1)
    err = gemm<kEpiGeluSave>(dtype, tile1, a1, w1, b1, nullptr, hid, R, Hd, C, s, nullptr, 1,
                             h1);
  else
    err = gemm<kEpiGelu>(dtype, tile1, a1, w1, b1, nullptr, hid, R, Hd, C, s);
  if (err) return err;
  if (pre_norm) {
    if (scale)
      return gemm<kEpiResidScale>(dtype, tile2, hid, w2, b2, x, out, R, C, Hd, s, scale, rpf);
    return gemm<kEpiResid>(dtype, tile2, hid, w2, b2, x, out, R, C, Hd, s);
  }
  if ((err = gemm<kEpiBias>(dtype, tile2, hid, w2, b2, nullptr, f, R, C, Hd, s))) return err;
  if (scale) return launch_rows<T, true, true>(x, f, ln_w, ln_b, out, R, C, eps, s, scale, rpf);
  return launch_rows<T, true>(x, f, ln_w, ln_b, out, R, C, eps, s);
}

// the floats of K2b's workspace where the weights train: the d_h1
// product's (M-tiles, Hd) column partials, the row pass's (CTAs, 3 C), and
// the column sums' scratch for the larger of the two
struct SumsLayout {
  int tiles, ctas;
  size_t part_h, part_r, scratch;
  SumsLayout(int R, int C, int Hd, int dtype) {
    const int tr = partial_tile_rows(dtype);
    tiles = (R + tr - 1) / tr;
    ctas = sum_ctas(R);
    part_h = (size_t)tiles * Hd;
    part_r = (size_t)ctas * 3 * C;
    const size_t a = colsum::scratch_floats(tiles, Hd), b = colsum::scratch_floats(ctas, 3 * C);
    scratch = a > b ? a : b;
  }
  size_t floats() const { return part_h + part_r + scratch; }
};

// K2b: dx of the block (see the header) from the forward's h1 and src (x on
// V1, f on V2). hA (R, Hd) and cA (R, C) are scratch; tiles: the output tile
// widths of the (R, Hd, C) product (d_h1) and the (R, C, Hd) one. sums:
// null (frozen weights), or [d ln_w, d ln_b, db2] (3, C) float32, with db1
// (Hd) float32, gs (R, C) for s dy on V1 with a scale, and ws the workspace.
template <typename T>
int mlp_block_bwd(const void* dy, const void* h1, const void* src, const float* ln_w,
                  const void* w1t, const void* w2t, const float* scale, int rpf, void* hA,
                  void* cA, void* dx, int R, int C, int Hd, int pre_norm, int dtype, int tile1,
                  int tile2, float eps, float* sums, float* db1, void* gs, float* ws,
                  cudaStream_t s) {
  int err;
  if (sums) {
    const SumsLayout L(R, C, Hd, dtype);
    float* part_h = ws;
    float* part_r = ws + L.part_h;
    float* scratch = part_r + L.part_r;
    if (pre_norm) {
      // hA = d_h1 (its column sums: db1); cA = d_h1 w1; dx = dy + LN-backward(cA; x)
      if ((err = gemm_bwd<kEpiGeluGrad>(dtype, tile1, dy, w2t, h1, hA, R, Hd, C, s, scale, rpf,
                                        part_h)))
        return err;
      if ((err = gemm_bwd<kEpiPlain>(dtype, tile2, hA, w1t, nullptr, cA, R, C, Hd, s)))
        return err;
      err = scale ? launch_ln_sums<T, true, true>(src, cA, ln_w, dy, dx, gs, part_r, R, C, eps,
                                                  scale, rpf, s)
                  : launch_ln_sums<T, true, false>(src, cA, ln_w, dy, dx, nullptr, part_r, R, C,
                                                   eps, nullptr, 1, s);
      if (err) return err;
    } else {
      // cA = d_h2 = LN-backward(s dy; f); hA = d_h1 (db1); dx = dy + d_h1 w1
      err = scale ? launch_ln_sums<T, false, true>(src, dy, ln_w, nullptr, cA, nullptr, part_r,
                                                   R, C, eps, scale, rpf, s)
                  : launch_ln_sums<T, false, false>(src, dy, ln_w, nullptr, cA, nullptr, part_r,
                                                    R, C, eps, nullptr, 1, s);
      if (err) return err;
      if ((err = gemm_bwd<kEpiGeluGrad>(dtype, tile1, cA, w2t, h1, hA, R, Hd, C, s, nullptr, 1,
                                        part_h)))
        return err;
      if ((err = gemm_bwd<kEpiAdd>(dtype, tile2, hA, w1t, dy, dx, R, C, Hd, s))) return err;
    }
    if ((err = colsum::column_sums(part_h, db1, scratch, L.tiles, Hd, s))) return err;
    return colsum::column_sums(part_r, sums, scratch, L.ctas, 3LL * C, s);
  }
  if (pre_norm) {
    // hA = d_h1 = (s dy w2) gelu'(h1); cA = d_h1 w1; dx = dy + LN-backward(cA; x)
    if ((err = gemm_bwd<kEpiGeluGrad>(dtype, tile1, dy, w2t, h1, hA, R, Hd, C, s, scale, rpf)))
      return err;
    if ((err = gemm_bwd<kEpiPlain>(dtype, tile2, hA, w1t, nullptr, cA, R, C, Hd, s))) return err;
    return launch_ln_bwd<T, true, false>(src, cA, ln_w, dy, dx, R, C, eps, nullptr, 1, s);
  }
  // cA = d_h2 = LN-backward(s dy; f); hA = d_h1 = (d_h2 w2) gelu'(h1); dx = dy + d_h1 w1
  if (scale)
    err = launch_ln_bwd<T, false, true>(src, dy, ln_w, nullptr, cA, R, C, eps, scale, rpf, s);
  else
    err = launch_ln_bwd<T, false, false>(src, dy, ln_w, nullptr, cA, R, C, eps, nullptr, 1, s);
  if (err) return err;
  if ((err = gemm_bwd<kEpiGeluGrad>(dtype, tile1, cA, w2t, h1, hA, R, Hd, C, s))) return err;
  return gemm_bwd<kEpiAdd>(dtype, tile2, hA, w1t, dy, dx, R, C, Hd, s);
}

template <int BN>
int ctas_per_sm(int* ctas) {
  cudaError_t e = cudaFuncSetAttribute(mlp_gemm_bf16<BN, kEpiGelu>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)TileShape<BN>::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mlp_gemm_bf16<BN, kEpiGelu>,
                                                      TileShape<BN>::THREADS,
                                                      TileShape<BN>::SMEM);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h_ln (R, C) is scratch for the V1
// pre-norm (null when pre_norm is 0), hid (R, Hd) for fc1's output, f (R, C)
// for V2's fc2 output (null when pre_norm is 1). h1: null, or (R, Hd) for
// fc1's pre-activation, kept for K2b (training). tile1 / tile2: the output
// tile width (128 or 96) of fc1 and fc2 in bf16, ignored in float32. scale:
// null, or the float32 per-frame DropPath scale, row r reading
// scale[r / rows_per_frame]. Returns a cudaError_t (0 on success).
extern "C" int mlp_block_fwd(const void* x, const void* ln_w, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* h_ln, void* hid, void* f, void* out, void* h1, int R, int C,
                             int Hd, int pre_norm, int dtype, int tile1, int tile2, float eps,
                             const void* scale, int rows_per_frame, void* stream) {
  if (R < 1 || C < 1 || Hd < 1 || (pre_norm ? h_ln == nullptr : f == nullptr) ||
      (scale && (rows_per_frame < 1 || R % rows_per_frame)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (C % 8 || Hd % 8 || !aligned16(x) || !aligned16(w1) || !aligned16(w2) ||
                     (h1 && !aligned16(h1))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return mlp_block<float>(x, lw, lb, w1, fb1, w2, fb2, h_ln, hid, f, out, h1, R, C, Hd,
                            pre_norm, 0, tile1, tile2, eps, sc, rows_per_frame, s);
  if (dtype == 1)
    return mlp_block<bf16>(x, lw, lb, w1, fb1, w2, fb2, h_ln, hid, f, out, h1, R, C, Hd,
                           pre_norm, 1, tile1, tile2, eps, sc, rows_per_frame, s);
  return (int)cudaErrorInvalidValue;
}

// K2b: dx (R, C) of mlp_block_fwd's out for the gradient dy (R, C), from
// what the forward kept: h1 (R, Hd), fc1's pre-activation, and src (R, C), x
// on V1 (pre_norm 1) or fc2's output f on V2. w1t (C, Hd) and w2t (Hd, C)
// are the transposed weights; hA (R, Hd) and cA (R, C) scratch, and after
// the call d_h1 and (V1) d_h1 w1 or (V2) d_h2; scale and rows_per_frame as in
// mlp_block_fwd; tile1 for the (R, Hd, C) product, tile2 for the (R, C, Hd)
// one. Trainable weights: sums (3, C) gets [d ln_w, d ln_b, db2] and db1
// (Hd) db1, float32; gs (R, C) s dy (V1 with a scale, else null); ws holds
// mlp_block_bwd_workspace(...) floats. Frozen: sums, db1, gs, ws null.
// Returns a cudaError_t (0 on success).
extern "C" int mlp_block_bwd(const void* dy, const void* h1, const void* src, const void* ln_w,
                             const void* w1t, const void* w2t, const void* scale,
                             int rows_per_frame, void* hA, void* cA, void* dx, int R, int C,
                             int Hd, int pre_norm, int dtype, int tile1, int tile2, float eps,
                             void* sums, void* db1, void* gs, void* ws, void* stream) {
  if (R < 1 || C < 1 || Hd < 1 || (scale && (rows_per_frame < 1 || R % rows_per_frame)) ||
      (sums && (db1 == nullptr || ws == nullptr ||
                (pre_norm && scale) != (gs != nullptr))) ||
      (!sums && (db1 || gs)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && gs && !aligned16(gs)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (C % 8 || Hd % 8 || !aligned16(dy) || !aligned16(h1) || !aligned16(src) ||
                     !aligned16(w1t) || !aligned16(w2t) || !aligned16(hA) || !aligned16(cA) ||
                     !aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(ln_w);
  const float* sc = static_cast<const float*>(scale);
  float* sm = static_cast<float*>(sums);
  float* b1 = static_cast<float*>(db1);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return mlp_block_bwd<float>(dy, h1, src, lw, w1t, w2t, sc, rows_per_frame, hA, cA, dx, R,
                                C, Hd, pre_norm, 0, tile1, tile2, eps, sm, b1, gs, w, s);
  if (dtype == 1)
    return mlp_block_bwd<bf16>(dy, h1, src, lw, w1t, w2t, sc, rows_per_frame, hA, cA, dx, R, C,
                               Hd, pre_norm, 1, tile1, tile2, eps, sm, b1, gs, w, s);
  return (int)cudaErrorInvalidValue;
}

// The floats of mlp_block_bwd's workspace where the weights train, for R
// rows of width C and hidden width Hd in dtype (0 float32, 1 bf16).
extern "C" long long mlp_block_bwd_workspace(int R, int C, int Hd, int dtype) {
  if (R < 1 || C < 1 || Hd < 1 || dtype < 0 || dtype > 1) return -1;
  return (long long)SumsLayout(R, C, Hd, dtype).floats();
}

// One bf16 product of the forward alone, C = epi(A B^T + bias) with one of
// its epilogues (kEpi* codes 0 to 4), at output tile width tile_n: the
// mma.sync kernel mlp_block_fwd launches, exported to time the products
// apart from the row passes. resid is the residual (codes 2 and 3), out2
// code 4's second output, scale / rows_per_frame the per-frame scale (code 3).
extern "C" int mlp_block_gemm_bf16(const void* A, const void* B, const void* bias,
                                   const void* resid, void* C, void* out2, const void* scale,
                                   int rows_per_frame, int M, int N, int K, int epi,
                                   int tile_n, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 8 || epi < 0 || epi > kEpiGeluSave ||
      bias == nullptr || ((epi == kEpiResid || epi == kEpiResidScale) && resid == nullptr) ||
      (epi == kEpiGeluSave && out2 == nullptr) || (epi == kEpiResidScale && scale == nullptr) ||
      (scale && (rows_per_frame < 1 || M % rows_per_frame)) || !aligned16(A) ||
      !aligned16(B) || !aligned16(C) || (resid && !aligned16(resid)) ||
      (out2 && !aligned16(out2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const int r = rows_per_frame;
  switch (epi) {
    case kEpiBias: return gemm_bf16<kEpiBias>(tile_n, A, B, b, resid, C, M, N, K, s);
    case kEpiGelu: return gemm_bf16<kEpiGelu>(tile_n, A, B, b, resid, C, M, N, K, s);
    case kEpiResid: return gemm_bf16<kEpiResid>(tile_n, A, B, b, resid, C, M, N, K, s);
    case kEpiResidScale:
      return gemm_bf16<kEpiResidScale>(tile_n, A, B, b, resid, C, M, N, K, s, sc, r);
    case kEpiGeluSave:
      return gemm_bf16<kEpiGeluSave>(tile_n, A, B, b, resid, C, M, N, K, s, nullptr, 1, out2);
  }
  return (int)cudaErrorInvalidValue;
}

// One bf16 product of K2b alone on the wgmma kernel, C = epi(A B^T, aux), at
// output tile width tile_n (256, 192 or 128): epi kEpiGeluGrad (5; aux = h1,
// scale optional), kEpiAdd (6; aux the residual) or kEpiPlain (7; no aux).
// Exported to time and test the products apart from the row pass.
extern "C" int mlp_block_gemm_wgmma(const void* A, const void* B, const void* aux, void* C,
                                    const void* scale, int rows_per_frame, int M, int N, int K,
                                    int epi, int tile_n, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 8 || epi < kEpiGeluGrad || epi > kEpiPlain ||
      ((epi == kEpiPlain) != (aux == nullptr)) || (scale && epi != kEpiGeluGrad) ||
      (scale && (rows_per_frame < 1 || M % rows_per_frame)) || !aligned16(A) ||
      !aligned16(B) || !aligned16(C) || (aux && !aligned16(aux)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (epi) {
    case kEpiGeluGrad:
      return gemm_bwd<kEpiGeluGrad>(1, tile_n, A, B, aux, C, M, N, K, s, sc, rows_per_frame);
    case kEpiAdd: return gemm_bwd<kEpiAdd>(1, tile_n, A, B, aux, C, M, N, K, s);
    case kEpiPlain: return gemm_bwd<kEpiPlain>(1, tile_n, A, B, aux, C, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// CTAs of the fc1 (GELU) product kernel at tile width tile_n that one SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int mlp_block_ctas_per_sm(int tile_n, int* ctas) {
  switch (tile_n) {
    case 128: return ctas_per_sm<128>(ctas);
    case 96: return ctas_per_sm<96>(ctas);
  }
  return (int)cudaErrorInvalidValue;
}
