// cp.async (Ampere and later): 16-byte copies from device memory to shared
// memory that run behind the issuing warp, grouped into commit groups that a
// later wait_group retires. Shared by the rings of K1 (window_attention.cu),
// K2 (mlp_block.cu) and K3 (block_chain.cu).
#pragma once

#include <cuda_runtime.h>

namespace avmoe {

// 16 bytes from gmem to smem through L2 (.cg); with ok false the source is
// not read and the 16 bytes are zero-filled (gmem must still be a valid
// address expression, any pointer will do)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's commit groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace avmoe
