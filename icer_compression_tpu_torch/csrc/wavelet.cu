// Kernel W1 of the ICER port: the inverse lifting DWT's backward
// recurrence over the high-pass index.
//
// Filters B, C, D, E, F and Q predict high-pass value d[n] from the
// restored d[n+1] (beta != 0), and filter C's n = 1 term reads the stored
// high[1]; so their inverse restores a line's d[half-1], ..., d[0] one
// after the other.  W1 replaces no Pallas kernel: the JAX package runs
// this recurrence as an XLA lax.scan inside its compiled decode
// (icer_compression_tpu/ops/wavelet.py:282, _inverse_recurrence_jax, from
// inverse_1d :227).  The plain PyTorch version is inverse_recurrence_plain
// in ops/wavelet.py, which documents the contract:
//
//   d[n] = wrap(high[n] + add[n]), n = half-1 down to 0, where
//   add[0]       = floor(r[1] / 4)
//   add[1]       = floor((2 r[1] + 3 r[2] - 2 d2v + 4) / 8)   (a_n1 != 0;
//                  d2v = high[1], or 0 when N = 5)
//   add[half-1]  = floor(r[half-1] / 4)                  (even N)
//   add[n]       = floor((a_n1 r[n-1] + a_0 r[n] + a_1 r[n+1]
//                         - beta d[n+1] + 8) / 16)       (otherwise)
//
// with r read as 0 past its nL = half + (N odd) entries, wrap the cast to
// int8 / int16 two's complement, and overflow set where some unwrapped
// value leaves [-2^mag_bits, 2^mag_bits - 1].
//
// Bound on this card: a line reads half highs and nL differences and
// writes half values, about 12 bytes and 12 integer operations per step,
// so a 512x512 image's passes are microseconds of either.  The limit is
// the chain: step n needs d[n+1], so a line is half dependent steps of
// about six dependent instructions (multiply-add, shift, add, mask,
// subtract).
//
// Design: one thread per line, d[n+1] carried in a register.  The inputs
// and the output are n-major (element (n, line) at n * lines + line), so
// the 32 lines of a warp read and write 128 contiguous bytes at each step.
// So that a step need not wait on its own loads, the line goes in chunks
// of kChunk steps: the chunk's highs and differences are loaded into
// registers first, all independent loads in flight at once, and then the
// chunk's steps run from registers (unrolled, so every register index is
// a constant).  Floor division by 4, 8 and 16
// is an arithmetic right shift, which rounds toward minus infinity on
// signed int.  The branches on n are the same for every line of a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;          // steps whose inputs load at once

struct Params {
  int lines, half, nL, is_odd;
  int a_n1, a_0, a_1, beta;
  int bits, lo, hi;
};

__device__ __forceinline__ int wrap(int v, int bits) {
  const int w = v & ((1 << bits) - 1);
  return w - ((w >> (bits - 1)) << bits);
}

__global__ void __launch_bounds__(kThreads)
inverse_recurrence_kernel(const int32_t* __restrict__ highs,
                          const int32_t* __restrict__ r,
                          int32_t* __restrict__ d,
                          int32_t* __restrict__ overflow, Params p) {
  const int line = blockIdx.x * kThreads + threadIdx.x;
  if (line >= p.lines) return;
  const size_t L = static_cast<size_t>(p.lines);

  int dn1 = 0;
  bool ov = false;
  // chunk [top - kChunk + 1, top] of n, walked downward; hb[k] holds
  // high[top - k] and rb[j] holds r[top + 1 - j] (0 outside [0, nL)), so
  // step n = top - k reads r[n+1], r[n], r[n-1] at rb[k], rb[k+1], rb[k+2]
  for (int top = p.half - 1; top >= 0; top -= kChunk) {
    int hb[kChunk], rb[kChunk + 2];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int n = top - k;
      hb[k] = n >= 0 ? highs[n * L + line] : 0;
    }
#pragma unroll
    for (int j = 0; j < kChunk + 2; ++j) {
      const int n = top + 1 - j;
      rb[j] = (n >= 0 && n < p.nL) ? r[n * L + line] : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int n = top - k;
      if (n < 0) break;
      int add;
      if (n == 0) {
        add = rb[k] >> 2;                                   // r[1] / 4
      } else if (n == 1 && p.a_n1 != 0) {
        const int d2v = (p.is_odd && p.half == 2) ? 0 : hb[k];
        add = (2 * rb[k + 1] + 3 * rb[k] - 2 * d2v + 4) >> 3;
      } else if (!p.is_odd && n == p.half - 1) {
        add = rb[k + 1] >> 2;                               // r[n] / 4
      } else {
        add = (p.a_n1 * rb[k + 2] + p.a_0 * rb[k + 1] + p.a_1 * rb[k]
               - p.beta * dn1 + 8) >> 4;
      }
      const int v = hb[k] + add;
      ov |= (v < p.lo) | (v > p.hi);
      dn1 = wrap(v, p.bits);
      d[n * L + line] = dn1;
    }
  }
  if (ov) atomicOr(reinterpret_cast<int*>(overflow), 1);
}

}  // namespace

// highs (half, lines), r (nL, lines), d (half, lines) int32, n-major;
// overflow one int32, set to 1 where a line overflows (the caller zeroes
// it).  Returns the launch's cudaError_t.
extern "C" int wavelet_inverse_launch(const void* highs, const void* r,
                                      void* d, void* overflow, int lines,
                                      int half, int nL, int a_n1, int a_0,
                                      int a_1, int beta, int mag_bits,
                                      void* cuda_stream) {
  const int is_odd = nL - half;
  if (lines < 0 || half < 1 || (is_odd != 0 && is_odd != 1)
      || (mag_bits != 7 && mag_bits != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lines == 0) return 0;
  Params p{lines, half, nL, is_odd, a_n1, a_0, a_1, beta,
           mag_bits + 1, -(1 << mag_bits), (1 << mag_bits) - 1};
  const int blocks = (lines + kThreads - 1) / kThreads;
  inverse_recurrence_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(highs), static_cast<const int32_t*>(r),
      static_cast<int32_t*>(d), static_cast<int32_t*>(overflow), p);
  return static_cast<int>(cudaGetLastError());
}
