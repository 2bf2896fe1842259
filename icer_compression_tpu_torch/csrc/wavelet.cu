// Kernel W1 of the ICER port: one axis of one stage of the inverse lifting
// DWT, every filter (A-F, Q).
//
// W1 replaces no Pallas kernel.  The JAX package computes this function in
// XLA inside its compiled decode: inverse_stages
// (icer_compression_tpu/ops/wavelet.py:383) runs inverse_1d (:141) over the
// columns, then the rows, of each stage's block, with the backward
// recurrence of filters B-F and Q as a lax.scan (_inverse_recurrence_jax,
// :282).  The plain PyTorch version is that chain in ops/wavelet.py
// (inverse_pass_plain -> inverse_1d -> inverse_recurrence_plain), which
// documents the contract.  For one line x of N samples, half = N / 2 and
// nL = half + (N odd):
//
//   L = x[:nL], H = x[nL:], r[0] = 1, r[n] = L[n-1] - L[n], r = 0 past nL
//   d[n] = wrap(H[n] + add[n]), n = half-1 down to 0, where
//   add[0]       = floor(r[1] / 4)
//   add[1]       = floor((2 r[1] + 3 r[2] - 2 d2v + 4) / 8)   (a_n1 != 0;
//                  d2v = H[1], the stored value, or 0 when N = 5)
//   add[half-1]  = floor(r[half-1] / 4)                  (even N)
//   add[n]       = floor((a_n1 r[n-1] + a_0 r[n] + a_1 r[n+1]
//                         - beta d[n+1] + 8) / 16)       (otherwise)
//   even[n] = wrap(L[n] + floor((d[n] + 1) / 2)), odd[n] = wrap(even - d)
//   (before the wraps), and an odd line's tail wrap(L[half]);
//
// wrap is the cast to int8 / int16 two's complement, and the overflow word
// is set where d, even or odd leaves [-2^mag_bits, 2^mag_bits - 1] before
// its wrap.  The pairs go straight to their interleaved places: even[n] to
// 2n, odd[n] to 2n + 1 and the tail to N - 1; but for a uint8 line of odd
// length (mag_bits 7) the reference's skewed in-place interleave
// (icer_wavelet.c:599): odd[n] to 2n - 1 for n >= 1, odd[0] to N - 1 and
// the tail to N - 2.
//
// Bound on this card: a pass reads its block once and writes it once (8
// bytes a sample) and does about 27 integer operations a pair, so boat's
// 512x512 stage-1 pass is a fraction of a microsecond of either.  The limit
// is the chain: at filters B-F and Q step n needs d[n+1], so a line is half
// dependent steps of about six dependent instructions.
//
// Design.  One launch is one pass over every canvas of a batch: the
// canvases are (NC, H, W) int32, contiguous, and the stage's block is
// [:low_h, :low_w] of each.  A pass reads one buffer and writes another,
// since an in-place pass would overwrite lows and highs it has not read
// (the caller runs a stage's column pass canvas -> scratch and its row pass
// scratch -> canvas).  Every line walks n from half-1 down in chunks of
// kChunk steps: the chunk's highs and the lows its differences need are
// loaded into registers first, all loads in flight at once, then the
// chunk's steps run from registers (unrolled, so every register index is a
// constant).  Floor division by 2, 4, 8 and 16 is an arithmetic right
// shift, which rounds toward minus infinity on signed int.  The branches
// on n are the same for every line of a launch.
//  - Column pass (axis 0): one thread per column of the block.  Element n
//    of the 32 lines of a warp is 128 contiguous bytes, so loads and stores
//    are coalesced with no transpose.
//  - Row pass (axis 1): a row is contiguous, so a thread per row would
//    stride by W.  A one-warp block takes kRows rows; each chunk's lows and
//    highs are staged through shared memory, loaded by the warp along the
//    rows (coalesced; each thread's share of a tile is a fixed, unrolled
//    count of loads, all in flight before the first shared store), and
//    each thread copies its row's chunk into registers.  The restored
//    pairs go to a shared tile of the chunk's 2 kChunk output columns,
//    which the warp stores along the rows.  A chunk's tiles take 17 KB,
//    whatever the row's length (up to 5120 samples), so static shared
//    memory suffices.  The pitches are odd, so the threads' row accesses
//    hit 32 banks.
//  - The grid is one-dimensional, canvas by canvas, so a batch may hold
//    any number of canvases.
//  - Filter A predicts from the lows alone, so no step waits on the one
//    before: it runs an instance of the same kernels with the chain
//    removed (kChain false drops the beta d[n+1] term at compile time), and
//    the compiler interleaves a chunk's independent steps.
//  - Each launch counts its own run: thread 0 of block 0 adds one to
//    `runs` (W1's slot of the device's run counters, or null), so a
//    launch that a CUDA graph replays is counted too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;              // steps whose inputs load at once
constexpr int kLows = kChunk + 3;       // lows a chunk reads: L[lo-2..top+1]
constexpr int kColThreads = 128;        // column pass: lines per block
constexpr int kRows = 32;               // row pass: rows per (one-warp) block
constexpr int kOutCols = 2 * kChunk;    // output columns a chunk writes

struct Params {
  int H, W;                   // canvas
  int tiles;                  // blocks per canvas: block b takes canvas
                              // b / tiles, tile b % tiles of its lines
  int lines, N, half, nL;     // lines of N samples along the pass's axis
  int is_odd, skew;           // skew: uint8 line of odd length
  int a_n1, a_0, a_1, beta;
  int bits, lo, hi;           // mag_bits + 1 and the sample range
};

__device__ __forceinline__ int wrap(int v, int bits) {
  const int w = v & ((1 << bits) - 1);
  return w - ((w >> (bits - 1)) << bits);
}

__device__ __forceinline__ bool outside(int v, const Params& p) {
  return (v < p.lo) | (v > p.hi);
}

// where odd[n] and the tail land in the line's output
__device__ __forceinline__ int odd_pos(int n, const Params& p) {
  return p.skew ? (n ? 2 * n - 1 : p.N - 1) : 2 * n + 1;
}

__device__ __forceinline__ int tail_pos(const Params& p) {
  return p.skew ? p.N - 2 : p.N - 1;
}

// Steps n = top, top-1, ..., max(top - kChunk + 1, 0) of one line: hb[k]
// holds H[top - k] and lb[j] holds L[top + 1 - j] (any value outside
// [0, nL)); dn1 carries d[n+1] between steps and chunks, ov the overflow.
// emit(n, even, odd) stores a restored pair.
template <bool kChain, class Emit>
__device__ __forceinline__ void chunk_steps(int top, const int (&hb)[kChunk],
                                            const int (&lb)[kLows],
                                            const Params& p, int& dn1,
                                            bool& ov, Emit emit) {
  // rb[j] = r[top + 1 - j]: step n = top - k reads r[n+1], r[n], r[n-1] at
  // rb[k], rb[k+1], rb[k+2]
  int rb[kChunk + 2];
#pragma unroll
  for (int j = 0; j < kChunk + 2; ++j) {
    const int m = top + 1 - j;
    rb[j] = m == 0 ? 1 : (m > 0 && m < p.nL) ? lb[j + 1] - lb[j] : 0;
  }
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int n = top - k;
    if (n < 0) break;
    int add;
    if (n == 0) {
      add = rb[k] >> 2;                                     // r[1] / 4
    } else if (n == 1 && p.a_n1 != 0) {
      const int d2v = (p.is_odd && p.half == 2) ? 0 : hb[k];
      add = (2 * rb[k + 1] + 3 * rb[k] - 2 * d2v + 4) >> 3;
    } else if (!p.is_odd && n == p.half - 1) {
      add = rb[k + 1] >> 2;                                 // r[n] / 4
    } else {
      const int pred = p.a_n1 * rb[k + 2] + p.a_0 * rb[k + 1]
                       + p.a_1 * rb[k] + 8;
      add = (kChain ? pred - p.beta * dn1 : pred) >> 4;
    }
    const int v = hb[k] + add;
    const int d = wrap(v, p.bits);
    if (kChain) dn1 = d;
    const int e = lb[k + 1] + ((d + 1) >> 1);              // L[n] + ...
    const int o = e - d;
    ov |= outside(v, p) | outside(e, p) | outside(o, p);
    emit(n, wrap(e, p.bits), wrap(o, p.bits));
  }
}

// axis 0: line c is column c of the block, sample n at row n
template <bool kChain>
__global__ void __launch_bounds__(kColThreads)
inverse_column_pass(const int32_t* __restrict__ src,
                    int32_t* __restrict__ dst, int* __restrict__ overflow,
                    Params p, unsigned long long* __restrict__ runs) {
  if (runs != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(runs, 1ull);
  const int c = (blockIdx.x % p.tiles) * kColThreads + threadIdx.x;
  if (c >= p.lines) return;
  const size_t plane = static_cast<size_t>(p.H) * p.W;
  const size_t at = blockIdx.x / p.tiles * plane + c;
  const int32_t* s = src + at;
  int32_t* d = dst + at;
  const size_t W = p.W;

  int dn1 = 0;
  bool ov = false;
  for (int top = p.half - 1; top >= 0; top -= kChunk) {
    int hb[kChunk], lb[kLows];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int n = top - k;
      hb[k] = n >= 0 ? s[(p.nL + n) * W] : 0;
    }
#pragma unroll
    for (int j = 0; j < kLows; ++j) {
      const int m = top + 1 - j;
      lb[j] = (m >= 0 && m < p.nL) ? s[m * W] : 0;
    }
    chunk_steps<kChain>(top, hb, lb, p, dn1, ov, [&](int n, int e, int o) {
      d[2 * n * W] = e;
      d[odd_pos(n, p) * W] = o;
    });
  }
  if (p.is_odd) d[tail_pos(p) * W] = wrap(s[p.half * W], p.bits);
  if (ov) atomicOr(overflow, 1);
}

// axis 1: line i is row i of the block, sample n at column n
template <bool kChain>
__global__ void __launch_bounds__(kRows)
inverse_row_pass(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 int* __restrict__ overflow, Params p,
                 unsigned long long* __restrict__ runs) {
  if (runs != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(runs, 1ull);
  // odd pitches: thread t reading or writing its row hits bank (t + j) % 32
  __shared__ int lo_tile[kRows][kLows];              // 35
  __shared__ int hi_tile[kRows][kChunk + 1];         // 33
  __shared__ int out_tile[kRows][kOutCols + 1];      // 65
  const int t = threadIdx.x;
  const int row0 = (blockIdx.x % p.tiles) * kRows;
  const int rows = min(kRows, p.lines - row0);
  const size_t at = blockIdx.x / p.tiles * (static_cast<size_t>(p.H) * p.W)
                    + static_cast<size_t>(row0) * p.W;
  const int32_t* s = src + at;
  int32_t* d = dst + at;
  const bool mine = t < rows;

  int dn1 = 0;
  bool ov = false;
  for (int top = p.half - 1; top >= 0; top -= kChunk) {
    const int lo = max(top - kChunk + 1, 0);
    // the chunk's output columns [c0, c1] (odd[0] of a skewed line, at
    // N - 1, lies past them and is stored directly)
    const int c0 = p.skew ? (lo ? 2 * lo - 1 : 0) : 2 * lo;
    const int c1 = p.skew ? 2 * top : 2 * top + 1;
    // the warp stages the chunk's lows and highs of its rows, along them:
    // thread t loads elements t, t + kRows, ... of each tile, every load
    // in flight before the first shared store
    int lv[kLows], hv[kChunk];
#pragma unroll
    for (int k = 0; k < kLows; ++k) {
      const int i = t + k * kRows, r = i / kLows, m = top + 1 - i % kLows;
      lv[k] = (r < rows && m >= 0 && m < p.nL) ? s[r * p.W + m] : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {                 // row k, step top - t
      const int n = top - t;
      hv[k] = (k < rows && n >= 0) ? s[k * p.W + p.nL + n] : 0;
    }
#pragma unroll
    for (int k = 0; k < kLows; ++k) {
      const int i = t + k * kRows;
      lo_tile[i / kLows][i % kLows] = lv[k];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) hi_tile[k][t] = hv[k];
    __syncwarp();
    if (mine) {
      int hb[kChunk], lb[kLows];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) hb[k] = hi_tile[t][k];
#pragma unroll
      for (int j = 0; j < kLows; ++j) lb[j] = lo_tile[t][j];
      chunk_steps<kChain>(top, hb, lb, p, dn1, ov, [&](int n, int e, int o) {
        out_tile[t][2 * n - c0] = e;
        const int q = odd_pos(n, p);
        if (q <= c1) {
          out_tile[t][q - c0] = o;
        } else {
          d[static_cast<size_t>(t) * p.W + q] = o;
        }
      });
    }
    __syncwarp();
    // thread t stores columns t and t + kRows of each row
    const int width = c1 - c0 + 1;
#pragma unroll
    for (int k = 0; k < 2 * kRows; ++k) {
      const int r = k >> 1, c = t + kRows * (k & 1);
      if (r < rows && c < width)
        d[static_cast<size_t>(r) * p.W + c0 + c] = out_tile[r][c];
    }
    __syncwarp();
  }
  if (mine && p.is_odd)
    d[static_cast<size_t>(t) * p.W + tail_pos(p)] =
        wrap(s[static_cast<size_t>(t) * p.W + p.half], p.bits);
  if (ov) atomicOr(overflow, 1);
}

template <bool kChain>
cudaError_t launch(const int32_t* src, int32_t* dst, int* overflow,
                   int blocks, int axis, const Params& p,
                   unsigned long long* runs, cudaStream_t stream) {
  const dim3 grid(blocks);
  if (axis == 0) {
    inverse_column_pass<kChain><<<grid, kColThreads, 0, stream>>>(
        src, dst, overflow, p, runs);
  } else {
    inverse_row_pass<kChain><<<grid, kRows, 0, stream>>>(src, dst, overflow,
                                                          p, runs);
  }
  return cudaGetLastError();
}

}  // namespace

// One pass of the inverse DWT over block [:low_h, :low_w] of each of the
// nc (H, W) int32 canvases at src, written to the same block of the
// canvases at dst (another buffer; the rest of dst is not touched): axis 0
// restores the block's columns, axis 1 its rows.  overflow is one int32,
// set to 1 where a value leaves the sample range (the caller zeroes it).
// runs: W1's run counter (one unsigned 64-bit word), or null.  Returns the
// launch's cudaError_t.
extern "C" int wavelet_inverse_pass_launch(const void* src, void* dst,
                                           void* overflow, int nc, int H,
                                           int W, int low_h, int low_w,
                                           int axis, int a_n1, int a_0,
                                           int a_1, int beta, int mag_bits,
                                           void* runs, void* cuda_stream) {
  if (nc < 0 || low_h < 2 || low_h > H || low_w < 2 || low_w > W
      || (axis != 0 && axis != 1) || (mag_bits != 7 && mag_bits != 15)
      || src == dst)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return 0;
  const int N = axis == 0 ? low_h : low_w;
  const int lines = axis == 0 ? low_w : low_h;
  const int per = axis == 0 ? kColThreads : kRows;
  const int tiles = (lines + per - 1) / per;
  if (static_cast<long long>(nc) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = N / 2, is_odd = N & 1;
  const Params p{H, W, tiles, lines, N, half, half + is_odd, is_odd,
                 is_odd && mag_bits == 7, a_n1, a_0, a_1, beta,
                 mag_bits + 1, -(1 << mag_bits), (1 << mag_bits) - 1};
  const auto* s = static_cast<const int32_t*>(src);
  auto* d = static_cast<int32_t*>(dst);
  auto* ov = static_cast<int*>(overflow);
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  auto* r = static_cast<unsigned long long*>(runs);
  const cudaError_t err =
      (beta != 0 || a_n1 != 0)
          ? launch<true>(s, d, ov, nc * tiles, axis, p, r, stream)
          : launch<false>(s, d, ov, nc * tiles, axis, p, r, stream);
  return static_cast<int>(err);
}
