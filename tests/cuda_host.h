// Host emulation of the CUDA features csrc/slim_pack.cu uses, so that its
// kernels compile with g++ (-std=c++20) and run on the CPU in the tests:
// each thread of a block is a std::thread, made once a launch, and the
// blocks of a launch run one after another on them; __syncthreads is a
// barrier of the block, a warp shuffle one of the warp; __shared__
// variables are static (one block at a time).  The source's LAUNCH macro
// becomes host_launch.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int2 { int x, y; };
struct uint4 { unsigned x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return cudaSuccess; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

struct HostWarp {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};
thread_local dim3 threadIdx, blockIdx;
thread_local std::barrier<>* host_block_barrier;
thread_local HostWarp* host_warp;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

template <class T>
T host_shuffle(T v, int src, bool inside) {
  unsigned long long u = 0, r;
  std::memcpy(&u, &v, sizeof(T));
  host_warp->slot[threadIdx.x & 31] = u;
  host_warp->bar.arrive_and_wait();
  r = inside ? host_warp->slot[src] : u;
  host_warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return host_shuffle(v, lane + d, lane + d < 32);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return host_shuffle(v, lane - d, lane >= d);
}
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <class T>
T __ldg(const T* p) { return *p; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

// The blocks of grid in turn, each on the same `threads` threads; a block
// ends, at the barrier, before the next starts.
inline void host_launch(dim3 grid, unsigned threads,
                        const std::function<void()>& body) {
  std::barrier<> bar(threads);
  std::vector<std::unique_ptr<HostWarp>> warps;
  for (unsigned w = 0; w < threads / 32; ++w)
    warps.emplace_back(new HostWarp);
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx = dim3(t);
      host_block_barrier = &bar;
      host_warp = warps[t / 32].get();
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = dim3(bx, by);
          body();
          bar.arrive_and_wait();
        }
    });
  for (auto& t : ts) t.join();
}

#define LAUNCH(kernel, grid, block, stream, ...) \
  host_launch(dim3(grid), block, [&] { kernel(__VA_ARGS__); })
