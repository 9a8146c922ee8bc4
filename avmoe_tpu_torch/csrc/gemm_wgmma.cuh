// bf16 NT product on Hopper's warpgroup tensor cores (sm_90a), fed by TMA:
//   C[m, n] = epi(sum_k A[m, k] B[n, k], aux[m, n], m)
// A (M, K), B (N, K), aux and C (M, N), all row-major bf16 with K % 8 == 0,
// N % 8 == 0 and 16-byte aligned bases (the TMA's 16-byte strides), float32
// sums. K2b's two products (mlp_block.cu) run on it.
//
// What bounds such a product on the H100 is the tensor cores' rate (989
// TFLOP/s bf16), which only wgmma reaches: mma.sync tops out near 360
// (PERF.md, PR 5); and beside it, for K2b's d_h1 product, the epilogue's
// bytes (h1 read, d_h1 written: as many as A and B's) and its exp. The
// design, after the hopper-kernels guide's section 1:
//   - persistent: one CTA an SM walks 128 x BN output tiles (BN of 128, 192
//     or 256, picked per product by the wrapper), N-tiles fastest, so CTAs
//     at work together share their A rows in L2;
//   - K walks in 64-deep steps (one 128-byte swizzle row of bf16) through a
//     ring of shared-memory stages; each stage's A (128 x 64) and B (BN x 64)
//     tiles arrive by two 2-D TMA copies with CU_TENSOR_MAP_SWIZZLE_128B,
//     whose zero fill pads ragged M, N and K; a full and an empty mbarrier a
//     stage. One producer thread keeps the ring full across tiles, so the
//     next tile's first stages land during this tile's epilogue;
//   - warpgroups 0 and 1 are the consumers, each owning 64 rows of a tile
//     (setmaxnreg gives them the producer warpgroup's registers): per stage
//     four wgmma.mma_async m64nBNk16 from shared-memory descriptors, one
//     commit group in flight (wait_group 1) while the next is issued, the
//     stage released when its group retires;
//   - the epilogue works in place in a tile-sized shared buffer (128 x 64
//     boxes, 128-byte swizzled): a second producer thread loads a tile's aux
//     into it by TMA while the tile's products run, each consumer thread
//     reads its accumulator elements' aux there, applies epi, rounds to bf16
//     once and writes the result back, and that thread stores the tile by
//     TMA (which clips the ragged edges) while the consumers go on to the
//     next tile.
//   - column sums (Epi::kColSums, K2b's d_h1 product when the MLP's weights
//     train: db1 = sum over rows of d_h1): each consumer thread adds its two
//     rows of every column pair in float32, before the rounding to bf16;
//     the 8 rows groups of a warp meet by shuffles, the 8 warps in a
//     double-buffered shared 8 x BN array, summed in warp order, and the
//     tile's sums go to its row of an (M-tiles, N) partial buffer, which a
//     second pass sums in tile order (column_sums.cuh): a fixed order, no
//     atomics;
// Not yet: TMA multicast across a cluster, fusing the two products on chip.
// Two consumer warpgroups in ping-pong (each on its own 128 x 128 tiles,
// taking turns at the tensor cores, one's epilogue under the other's
// products) timed within 1% of this kernel on K2b's products (PERF.md).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avmoe {
namespace wg {
// internal linkage, as the sources' own kernels: several builds of one
// library may share a process (tools that time variants), and the static
// locals of external templates would be shared between them
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBK = 64, kConsumerThreads = 256, kThreads = 384;
// the epilogue's tile (aux in, C out) as boxes of 128 rows x 64 columns, one
// 128-byte swizzle row of bf16 each
constexpr int kBoxN = 64, kBox = kBM * kBoxN * 2;
template <int BN> struct Shape {
  static_assert(BN % kBoxN == 0 && BN <= 256, "tile widths: multiples of 64 up to 256");
  static constexpr int STAGE_A = kBM * kBK * 2, STAGE_B = BN * kBK * 2;
  static constexpr int STAGE = STAGE_A + STAGE_B;   // a multiple of 1024 bytes
  static constexpr int IO = kBM * BN * 2;             // the epilogue's tile
  // as many stages as fit beside it in 208 KB, at most 5
  static constexpr int STAGES = (208 * 1024 - IO) / STAGE < 5 ? (208 * 1024 - IO) / STAGE : 5;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  // ring, io tile, then 2 STAGES + 2 mbarriers; 1024 bytes of slack to
  // align the ring
  static constexpr size_t SMEM = RING + IO + (2 * STAGES + 2) * 8 + 1024;
  static_assert(STAGES >= 3 && SMEM <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// --- TMA ----------------------------------------------------------------------
// the (c0, c1) box of `map` (c0 along the contiguous axis) into smem; its bytes
// complete a transaction on `bar`
__device__ __forceinline__ void tma_load_2d(void* smem, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the (c0, c1) box of `map` from smem, in this thread's bulk group; the box's
// part outside the tensor is not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* smem, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(smem)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ------------------------------------------------------------------------
// descriptor of a K-major operand tile whose 8-row groups of 128-byte rows
// (128-byte swizzle, as TMA wrote them) lie 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator across the asm
// that retires the products writing it
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, the m64nNk16 accumulator fragment) += A (64 x 16) B (N x 16)^T
template <int N> __device__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Epi: a functor with `static constexpr bool kReadsAux` and `kColSums`,
// `__device__ float pre(float aux) const`, `float row_factor(int row) const`
// (read once a row), `float operator()(float acc, float pre, float
// row_factor) const` and `float* col_part`: C = epi(acc, pre(aux),
// row_factor(row)), aux 0 when kReadsAux is false; rows past M are computed
// and not stored. With kColSums, col_part[t / ntn][n] is the sum of tile t's
// outputs in column n (float32, rows past M left out). Persistent: CTA c
// takes the tiles c, c + gridDim.x, ..., tile t at N-tile t % ntn and M-tile
// t / ntn.
template <class Epi, int BN> constexpr size_t colsum_bytes() {
  return Epi::kColSums ? 2 * 8 * BN * sizeof(float) : 0;
}

template <int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
mlp_gemm_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_aux,
               const __grid_constant__ CUtensorMap map_c, int M, int N, int K, Epi epi) {
  using S = Shape<BN>;
  constexpr int STAGES = S::STAGES, BOXES = BN / kBoxN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* io = ring + S::RING;   // the epilogue's tile: aux in, C out, in place
  uint64_t* full = reinterpret_cast<uint64_t*>(io + S::IO);
  uint64_t* empty = full + STAGES;
  uint64_t* aux_full = empty + STAGES;   // io holds the tile's aux
  uint64_t* out_ready = aux_full + 1;    // io holds the tile's output
  // kColSums: two 8 x BN arrays of the warps' column sums, a tile's in one
  float* red = reinterpret_cast<float*>(out_ready + 1);
  const int ntn = (N + BN - 1) / BN;
  const int tiles = ntn * ((M + kBM - 1) / kBM);
  const int nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_init(aux_full, 1);
    mbar_init(out_ready, kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumerThreads) {
      // one thread keeps the ring full, across tiles
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % ntn) * BN, m0 = (tile / ntn) * kBM;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + (size_t)s * S::STAGE;
          mbar_expect_tx(&full[s], S::STAGE);
          tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
          tma_load_2d(st + S::STAGE_A, &map_b, &full[s], kt * kBK, n0);
        }
      }
    } else if (threadIdx.x == kConsumerThreads + 32) {
      // one thread moves the epilogue's tiles: a tile's output out by TMA
      // once the consumers have written it, then the next tile's aux in
      int li = 0, prev_n0 = 0, prev_m0 = 0;
      for (int tile = blockIdx.x;; tile += gridDim.x, ++li) {
        if (li > 0) {
          mbar_wait(out_ready, (li - 1) & 1);
          for (int b = 0; b < BOXES && prev_n0 + b * kBoxN < N; ++b)
            tma_store_2d(&map_c, io + b * kBox, prev_n0 + b * kBoxN, prev_m0);
          bulk_commit();
          bulk_wait_read();
        }
        if (tile >= tiles) break;
        const int n0 = (tile % ntn) * BN, m0 = (tile / ntn) * kBM;
        if (Epi::kReadsAux) {
          const int boxes = min(BOXES, (N - n0 + kBoxN - 1) / kBoxN);
          mbar_expect_tx(aux_full, boxes * kBox);
          for (int b = 0; b < boxes; ++b)
            tma_load_2d(io + b * kBox, &map_aux, aux_full, n0 + b * kBoxN, m0);
        } else {
          mbar_arrive(aux_full);
        }
        prev_n0 = n0;
        prev_m0 = m0;
      }
      bulk_wait();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wr = threadIdx.x / 128;   // this warpgroup's 64 rows of the tile
    const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
    int it = 0, li = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++li) {
      const int m0 = (tile / ntn) * kBM;
      const int n0c = (tile % ntn) * BN;
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      // this thread's fragment elements (rows 16 w + g and + 8 of the
      // warpgroup's 64, columns 8 j + 2 q and + 1): each pair's place in io,
      // 128-byte-swizzled in its 64-column box
      unsigned* const p0 = reinterpret_cast<unsigned*>(io + (wr * 64 + 16 * w + g) * 128 + 4 * q);
      auto at = [&](int j, int h) -> unsigned& {
        return p0[((j / 8) * kBox + h * 8 * 128 + (((j % 8) ^ g) << 4)) / 4];
      };
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + (size_t)s * S::STAGE;
        const uint64_t da = smem_desc(st + wr * 64 * kBK * 2), db = smem_desc(st + S::STAGE_A);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) wgmma_bf16<BN>(d, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        // the group of the step before has retired: its stage goes back
        wgmma_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(d);
      if (t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // epilogue, in place in io: all loads first, then epi, then all
      // stores, so that the elements' chains overlap (a store between them
      // would order the next load after it); each output rounded to bf16 once
      mbar_wait(aux_full, li & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // one of the thread's two rows at a time
        const int row = m0 + wr * 64 + 16 * w + g + 8 * h;
        const float rf = row < M ? epi.row_factor(row) : 0.f;
        unsigned ax[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) ax[j] = Epi::kReadsAux ? at(j, h) : 0u;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ax[j]));
          const float v0 = epi(d[4 * j + 2 * h], epi.pre(x.x), rf);
          const float v1 = epi(d[4 * j + 2 * h + 1], epi.pre(x.y), rf);
          if constexpr (Epi::kColSums) {   // the float32 outputs, kept for the sums
            d[4 * j + 2 * h] = row < M ? v0 : 0.f;
            d[4 * j + 2 * h + 1] = row < M ? v1 : 0.f;
          }
          ax[j] = pack2(v0, v1);
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) at(j, h) = ax[j];
      }
      fence_async_smem();
      mbar_arrive(out_ready);
      if constexpr (Epi::kColSums) {
        // this thread's two rows, then the warp's 8 row groups (lanes of one
        // q), into the warp's row of red; then each column over the 8 warps
        float* rb = red + (li & 1) * 8 * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float s0 = d[4 * j] + d[4 * j + 2], s1 = d[4 * j + 1] + d[4 * j + 3];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          if (g == 0)
            *reinterpret_cast<float2*>(rb + (wr * 4 + w) * BN + 8 * j + 2 * q) =
                make_float2(s0, s1);
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
        for (int c = threadIdx.x; c < BN; c += kConsumerThreads) {
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) sum += rb[k * BN + c];
          if (n0c + c < N) epi.col_part[(size_t)(tile / ntn) * N + n0c + c] = sum;
        }
      }
    }
  }
}

// --- host -----------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against the driver
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the tensor map of a row-major (rows, cols) bf16 matrix in (box_rows, 64)
// boxes, 128-byte swizzled
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, class Epi>
int launch(const bf16* A, const bf16* B, const bf16* aux, bf16* C, int M, int N, int K,
           const Epi& epi, cudaStream_t stream) {
  static_assert(Shape<BN>::SMEM + colsum_bytes<Epi, BN>() <= 227 * 1024, "shared memory");
  static int sms = 0;   // set once, with the shared-memory limit
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_gemm_wgmma<BN, Epi>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(Shape<BN>::SMEM + colsum_bytes<Epi, BN>()));
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  CUtensorMap ma, mb, mx, mc;
  // without aux its map is C's, never read
  if (!make_map(&ma, A, M, K, kBM) || !make_map(&mb, B, N, K, BN) ||
      !make_map(&mx, aux ? aux : C, M, N, kBM) || !make_map(&mc, C, M, N, kBM))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + kBM - 1) / kBM);
  if (tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  mlp_gemm_wgmma<BN, Epi><<<grid, kThreads, Shape<BN>::SMEM + colsum_bytes<Epi, BN>(), stream>>>(
      ma, mb, mx, mc, M, N, K, epi);
  return (int)cudaGetLastError();
}

// the output tile widths the wrapper picks from (kernels/mlp_block.py WGMMA_WIDTHS)
template <class Epi>
int gemm(int tile_n, const void* A, const void* B, const void* aux, void* C, int M, int N, int K,
         const Epi& epi, cudaStream_t s) {
  const bf16 *a = static_cast<const bf16*>(A), *b = static_cast<const bf16*>(B);
  const bf16* x = static_cast<const bf16*>(aux);
  bf16* c = static_cast<bf16*>(C);
  switch (tile_n) {
    case 256: return launch<256>(a, b, x, c, M, N, K, epi, s);
    case 192: return launch<192>(a, b, x, c, M, N, K, epi, s);
    case 128: return launch<128>(a, b, x, c, M, N, K, epi, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wg
}  // namespace avmoe
