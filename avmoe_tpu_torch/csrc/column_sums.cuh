// Column sums in a fixed order, with no atomics: out[c] = sum over r < rows
// of in[r * cols + c], float32. The parameter gradients that K1b and K2b
// give are such sums: the bias gradient over the frames of a window (K1b's
// per-(window, head) partials), the MLP's biases and norm over the token
// rows (K2b's per-tile partials).
//
// The rows are summed in chunks of kChunk, each chunk by one thread in row
// order, and then the chunks' sums by one thread in chunk order; so the
// result depends on (rows, cols) alone and repeats bit for bit. A thread
// per column and chunk keeps the device busy where a column has thousands
// of rows and few columns exist (an unshifted HTS-AT stage-0 block sums 1280
// windows into one (4, 64, 64) slab).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace avmoe {
namespace colsum {
namespace {

constexpr int kChunk = 32, kThreads = 256;

// out[y * cols + c] = sum of rows y * chunk .. min(rows, (y + 1) chunk) - 1
__global__ void __launch_bounds__(kThreads)
column_sums_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
                   long long cols, int chunk) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
  const float* p = in + (size_t)r0 * cols + c;
  float acc = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) acc += p[(size_t)(r - r0) * cols];
  out[(size_t)blockIdx.y * cols + c] = acc;
}

// floats of scratch that column_sums needs for (rows, cols)
size_t scratch_floats(int rows, long long cols) {
  return rows > kChunk ? (size_t)((rows + kChunk - 1) / kChunk) * cols : 0;
}

// out (cols) = the column sums of in (rows, cols); scratch holds
// scratch_floats(rows, cols). Returns a cudaError_t.
int column_sums(const float* in, float* out, float* scratch, int rows, long long cols,
                cudaStream_t s) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (rows <= kChunk) {
    column_sums_kernel<<<dim3((unsigned)blocks, 1), kThreads, 0, s>>>(in, out, rows, cols, rows);
    return (int)cudaGetLastError();
  }
  const int chunks = (rows + kChunk - 1) / kChunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  column_sums_kernel<<<dim3((unsigned)blocks, chunks), kThreads, 0, s>>>(in, scratch, rows, cols,
                                                                        kChunk);
  column_sums_kernel<<<dim3((unsigned)blocks, 1), kThreads, 0, s>>>(scratch, out, chunks, cols,
                                                                   chunks);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace colsum
}  // namespace avmoe
