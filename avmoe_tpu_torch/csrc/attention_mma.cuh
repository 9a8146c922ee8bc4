// Tensor-core window attention on mma.sync, shared by K1
// (csrc/window_attention.cu, bf16 operands) and K3 (csrc/block_chain.cu,
// TF32 operands).
//
// The register layout is FlashAttention-2's: a warp owns 16 query rows of one
// (window, head) and keeps its logits S = q k^T for every key in registers,
// as m16n8 float32 accumulator tiles (tile j holds keys 8j .. 8j + 7; the
// thread with lane = 4 g + t holds rows g and g + 8, keys 8j + 2t and
// 8j + 2t + 1). S starts as the position bias (plus the shift mask), loaded
// in that layout before the q k^T products accumulate onto it; keys past N
// start at -inf, so they drop out of the row max and get probability 0. The
// row max and sum are shuffles inside the quad of four lanes that share a
// row. The probabilities go from the accumulators straight into the A
// operands of the p v products, without a trip through shared memory.
//
// Operands, per type:
//  - bf16, m16n8k16: q, k, v in shared memory, rows of 16 KD + 8 elements
//    (the 8 spare ones keep ldmatrix's eight 16-byte row reads on distinct
//    banks); q and k tiles by ldmatrix, v by ldmatrix.trans. The head width
//    is zero-padded to 16 KD on the k side of q k^T; on the n side of p v it
//    is ceil(D / 8) n8 tiles. P is rounded to bf16 for p v.
//  - TF32, m16n8k8 (cvt.rna.tf32.f32 on float32 values): q, k, v float32 in
//    shared memory. Inside each 8-wide step of a sum, the k index t stands
//    for element 2t and t + 4 for element 2t + 1. A sum does not care about
//    the order of its terms, so a thread's two A values are one float2 of q
//    (or the two accumulators it already holds of S), its two B values one
//    float2 of a k row, and no shuffle repacks P. k rows have a stride of
//    8 mod 32 words (conflict-free float2 reads), v rows 4 mod 32 (the two
//    scalar reads of a B fragment hit 32 distinct banks).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace avmoe {
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// Shared by both operand types
// ---------------------------------------------------------------------------

// S = bias (+ mask) of query rows r0 + g and r0 + g + 8 in the accumulator
// layout, for key tiles j < nkt. bias and mask are (N, N) float32, row-major;
// mask may be null. Keys past N are -inf; rows past N (padding, never
// stored) read row 0. No load sits behind a branch on its own value, so all
// of a warp's loads are in flight together (behind per-load branches the
// merges made them wait one by one).
template <int KT8, bool MASK>
__device__ __forceinline__ void load_logit_bias_(float (&s)[KT8][4], const float* __restrict__ bias,
                                                 const float* __restrict__ mask, int N, int r0,
                                                 int nkt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t ra = (size_t)(r0 + g < N ? r0 + g : 0) * N;
  const size_t rb = (size_t)(r0 + g + 8 < N ? r0 + g + 8 : 0) * N;
  if ((N & 1) == 0) {
    // N even: key m < N (m even) means m + 1 < N, so a float2 holds both
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
      if (j >= nkt) continue;
      const int m = 8 * j + 2 * t;
      const bool ok = m < N;
      const int mc = ok ? m : 0;
      float2 x = __ldg(reinterpret_cast<const float2*>(bias + ra + mc));
      float2 y = __ldg(reinterpret_cast<const float2*>(bias + rb + mc));
      if (MASK) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(mask + ra + mc));
        const float2 v = __ldg(reinterpret_cast<const float2*>(mask + rb + mc));
        x.x += u.x;
        x.y += u.y;
        y.x += v.x;
        y.y += v.y;
      }
      s[j][0] = ok ? x.x : -INFINITY;
      s[j][1] = ok ? x.y : -INFINITY;
      s[j][2] = ok ? y.x : -INFINITY;
      s[j][3] = ok ? y.y : -INFINITY;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
      if (j >= nkt) continue;
      const int m = 8 * j + 2 * t;
      const bool ok0 = m < N, ok1 = m + 1 < N;
      const int m0 = ok0 ? m : 0, m1 = ok1 ? m + 1 : 0;
      float x0 = __ldg(bias + ra + m0), x1 = __ldg(bias + ra + m1);
      float y0 = __ldg(bias + rb + m0), y1 = __ldg(bias + rb + m1);
      if (MASK) {
        x0 += __ldg(mask + ra + m0);
        x1 += __ldg(mask + ra + m1);
        y0 += __ldg(mask + rb + m0);
        y1 += __ldg(mask + rb + m1);
      }
      s[j][0] = ok0 ? x0 : -INFINITY;
      s[j][1] = ok1 ? x1 : -INFINITY;
      s[j][2] = ok0 ? y0 : -INFINITY;
      s[j][3] = ok1 ? y1 : -INFINITY;
    }
  }
}

template <int KT8>
__device__ __forceinline__ void load_logit_bias(float (&s)[KT8][4], const float* bias,
                                                const float* mask, int N, int r0, int nkt) {
  if (mask)
    load_logit_bias_<KT8, true>(s, bias, mask, N, r0, nkt);
  else
    load_logit_bias_<KT8, false>(s, bias, mask, N, r0, nkt);
}

// In place: s = exp(s - row max), unnormalised; inv0 / inv1 = 1 / row sum
// of rows g and g + 8.
template <int KT8>
__device__ __forceinline__ void softmax_rows(float (&s)[KT8][4], int nkt, float& inv0,
                                             float& inv1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT8; ++j) {
    if (j >= nkt) continue;
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT8; ++j) {
    if (j >= nkt) continue;
    s[j][0] = exp2f(fmaf(s[j][0], kLog2e, -c0));
    s[j][1] = exp2f(fmaf(s[j][1], kLog2e, -c0));
    s[j][2] = exp2f(fmaf(s[j][2], kLog2e, -c1));
    s[j][3] = exp2f(fmaf(s[j][3], kLog2e, -c1));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  inv0 = 1.f / l0;
  inv1 = 1.f / l1;
}

// ---------------------------------------------------------------------------
// bf16 operands (m16n8k16). Qs, Ks, Vs: rows of `ld` bf16 (ld = 16 KD + 8),
// zero past N rows and past D columns (Ks, Qs); KT8 = 2 * (key 16-tiles).
// ---------------------------------------------------------------------------

// s += q k^T for query rows r0 .. r0 + 15 and key 16-tiles < nkt16
template <int KT8, int KD>
__device__ __forceinline__ void qk_bf16(float (&s)[KT8][4], const bf16* Qs, const bf16* Ks, int ld,
                                        int r0, int nkt16) {
  const int lane = threadIdx.x & 31;
  unsigned qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc)
    ldsm_x4(qa[kc], Qs + (size_t)(r0 + (lane & 15)) * ld + kc * 16 + (lane >> 4) * 8);
  const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int jj = 0; jj < KT8 / 2; ++jj) {
    if (jj >= nkt16) continue;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      unsigned b[4];
      ldsm_x4(b, Ks + (size_t)(16 * jj + krow) * ld + kc * 16 + kcol);
      mma_bf16(s[2 * jj], qa[kc], b[0], b[1]);
      mma_bf16(s[2 * jj + 1], qa[kc], b[2], b[3]);
    }
  }
}

// o = p v (unnormalised) over key 16-tiles < nkt16, for ndt8 n8 tiles of D
template <int KT8, int KD>
__device__ __forceinline__ void pv_bf16(float (&o)[2 * KD][4], const float (&s)[KT8][4],
                                        const bf16* Vs, int ld, int nkt16, int ndt8) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KT8 / 2; ++kc) {
    if (kc >= nkt16) continue;
    const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                           pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < KD; ++dp) {
      if (2 * dp >= ndt8) continue;
      unsigned b[4];
      ldsm_x4_trans(b, Vs + (size_t)(16 * kc + vrow) * ld + dp * 16 + vcol);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      if (2 * dp + 1 < ndt8) mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// TF32 operands (m16n8k8). Qw: this warp's 16 query rows, Ks: the keys, both
// float32 with row stride ldk (8 mod 32), zero past D up to 8 * nd8 (and Ks
// past N up to 8 * nkt); Vs with row stride ldv (4 mod 32), already rounded
// to TF32, zero past N rows.
// ---------------------------------------------------------------------------

template <int KT8>
__device__ __forceinline__ void qk_tf32(float (&s)[KT8][4], const float* Qw, const float* Ks,
                                        int ldk, int nkt, int nd8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < nd8; ++kc) {
    const float2 q0 = *reinterpret_cast<const float2*>(Qw + g * ldk + 8 * kc + 2 * t);
    const float2 q1 = *reinterpret_cast<const float2*>(Qw + (g + 8) * ldk + 8 * kc + 2 * t);
    const unsigned qa[4] = {tf32(q0.x), tf32(q1.x), tf32(q0.y), tf32(q1.y)};
    const float* kp = Ks + g * ldk + 8 * kc + 2 * t;
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
      if (j >= nkt) continue;
      const float2 kv = *reinterpret_cast<const float2*>(kp + (size_t)8 * j * ldk);
      mma_tf32(s[j], qa, tf32(kv.x), tf32(kv.y));
    }
  }
}

template <int KT8, int DT8>
__device__ __forceinline__ void pv_tf32(float (&o)[DT8][4], const float (&s)[KT8][4],
                                        const float* Vs, int ldv, int nkt, int nd8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT8; ++kc) {
    if (kc >= nkt) continue;
    const unsigned a[4] = {tf32(s[kc][0]), tf32(s[kc][2]), tf32(s[kc][1]), tf32(s[kc][3])};
    const float* vp = Vs + (size_t)(8 * kc + 2 * t) * ldv + g;
#pragma unroll
    for (int dt = 0; dt < DT8; ++dt) {
      if (dt >= nd8) continue;
      mma_tf32(o[dt], a, __float_as_uint(vp[8 * dt]), __float_as_uint(vp[ldv + 8 * dt]));
    }
  }
}

}  // namespace mma
}  // namespace avmoe
