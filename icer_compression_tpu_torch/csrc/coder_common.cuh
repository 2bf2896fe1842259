// Device helpers shared by the port's coder kernels (slim_encode.cu,
// full_encode.cu, plane_decode.cu): cp.async copies into shared memory and
// the bin of a context probability.
#pragma once

#include <cstdint>

namespace icer {

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bin of a probability: the number of cutoffs it meets (the ladder
// ascends), comp >= tc * cut[j] taken as the sign bit of
// tc * cut[j] - comp - 1 (tc <= 500 and cut <= 65536 keep it in range) and
// summed in four independent sums, so the 16 terms issue together as a
// multiply-add and a shift-add each (constant indices only: a rolled
// reduction would put the sums in local memory).
__device__ __forceinline__ int bin_of(const int* cut, int comp, int tc) {
  const int nc = ~comp;
  uint32_t a = 0, b = 0, c = 0, d = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a += (uint32_t)(tc * cut[j] + nc) >> 31;
    b += (uint32_t)(tc * cut[4 + j] + nc) >> 31;
    c += (uint32_t)(tc * cut[8 + j] + nc) >> 31;
    d += (uint32_t)(tc * cut[12 + j] + nc) >> 31;
  }
  return (int)((a + b) + (c + d));
}

}  // namespace icer
