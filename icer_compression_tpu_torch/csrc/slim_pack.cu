// Sort and pack of the ICER port's slim coder: kernel 1's records put in
// allocation order, each codeword rebuilt and bit-packed per lane.
//
// Replaces the tail that follows the TPU kernel make_encode_lanes_slim in
// icer_compression_tpu/ops/pallas_entropy.py, which the JAX package leaves to
// XLA as a sort, a gather and elementwise ops: slim_sort_operand_packed,
// slim_decode_packed and order_and_pack_lane_packed (fused-key records),
// slim_sort_operands, slim_decode_op and order_and_pack_lane_slim (two-word
// records), and the packing of ops/entropy_jax2.py (pack_records_tree).  The
// plain PyTorch version is that sort-based tail, order_and_pack_lanes and
// order_and_pack_lanes_two_word in ops/entropy_slim.py; byte for byte, this
// gives its payload, total bits and flag on every lane whose fallback flag
// (misc row 0) is clear, and the caller ORs that flag in.
//
// No sort.  Every allocation ordinal a lane allocates ends in exactly one
// record: a completion, an eviction by the reorder window, or an end-of-plane
// flush.  So the ordinals of a lane's valid records are 0 .. allocations - 1,
// each once, and each record goes straight to its slot.  (A fused-key lane
// past its 32 eviction rows loses records; its fallback flag is set.)
//
// Three kernels, after a memset of the payload:
//  - slim_pack_place_kernel: a block takes 64 rows of 32 lanes (the records,
//    then the 17 flush rows built from the final bin state, then the
//    evictions), read coalesced along the lanes and turned through shared
//    memory, so that a warp rebuilds one lane's codewords and writes each,
//    code | nbits << 16, to scratch[lane][ordinal] for ordinals below
//    slice_to: a warp's ordinals are nearly ascending, so its stores share
//    sectors.
//  - slim_pack_sums_kernel: per lane and chunk of kChunk ordinals, the bits
//    of the chunk's codewords (ordinals below min(allocations, slice_to)).
//  - slim_pack_bits_kernel: per lane and chunk, the chunk's bit offset (the
//    sums of the chunks before it) and a block scan of the kPer codewords
//    each thread holds; each thread stores its run of bits as whole words,
//    ORing in only its two edge words with atomics, and drops the words past
//    max_bits.  The first chunk's block writes the lane's total bits and its
//    flag (more than slice_to allocations, or more than max_bits bits).
// A long lane (1.23 M ordinals in a 5120x3840 stage-1 call) so spreads over
// hundreds of blocks, and a short one takes few.
//
// Bound on this card: the bytes the function has to move.  The records are
// read once (4 bytes a step and lane, 8 in the two-word mode) and the
// payload written once: about 115 MB for a 1024x1024 image's stage-1 bucket,
// some 34 us at 3.35 TB/s; the arithmetic is tens of integer operations a
// record.  The scratch round trip (each codeword's word written once and
// read twice, 12 bytes) is this design's own traffic on top.

#include <cstdint>
#include <cuda_runtime.h>

// kernel<<<grid, block, 0, stream>>>(...); a host build of this file for the
// tests defines its own LAUNCH first.
#ifndef LAUNCH
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kBig = 1 << 30;
constexpr uint32_t kNone15 = 0x7FFF;    // fused-key ordinal of no record
constexpr int32_t kBigPk = 0x7FFF << 16;
constexpr int kRows = 64;               // rows of a place tile
constexpr int kLanes = 32;              // lanes of a place tile
constexpr int kPlaceThreads = 256;
constexpr int kThreads = 128;           // a sums or bits block
constexpr int kPer = 16;                // ordinals a thread holds
constexpr int kChunk = kThreads * kPer; // ordinals a sums or bits block takes

// LUT layout, shared with ops/entropy_slim.py
constexpr int kLutGm = 16;
constexpr int kLutFlv = 289;
constexpr int kLutGl = 2337;
constexpr int kLutGi = 2354;
constexpr int kLutCout = 2371;
constexpr int kLutCobits = 2627;
constexpr int kLutSize = 2883;

// A completed codeword from its (bin, k, cb, nb), as code | nbits << 16
// (_codewords): a golomb bin's remainder, bit-reversed, or '1' for the full
// run; a custom bin's output code of its prefix value; the uncoded bit.
__device__ __forceinline__ uint32_t codeword(const int32_t* __restrict__ lut,
                                             uint32_t bn, uint32_t k,
                                             uint32_t cb, uint32_t nb) {
  if (bn >= 8) {
    const uint32_t m = (uint32_t)__ldg(lut + kLutGm + bn);
    const uint32_t l = (uint32_t)__ldg(lut + kLutGl + bn);
    const uint32_t ii = (uint32_t)__ldg(lut + kLutGi + bn);
    if (cb == 0 && k + 1 >= m) return 1u | 1u << 16;
    const uint32_t adj = k < ii ? k : k + ii;
    const uint32_t len = l + (k >= ii ? 1u : 0u);
    return (__brev(adj & 0xFFFF) >> (32 - len)) | len << 16;
  }
  if (bn >= 1) {
    const uint32_t val = (k | (cb << nb)) & 31;
    return (uint32_t)__ldg(lut + kLutCout + bn * 32 + val)
           | (uint32_t)__ldg(lut + kLutCobits + bn * 32 + val) << 16;
  }
  return cb | 1u << 16;
}

// A fused-key record's codeword (slim_decode_packed).
__device__ __forceinline__ uint32_t fused_codeword(
    const int32_t* __restrict__ lut, uint32_t w) {
  const uint32_t bn = (w >> 11) & 31;
  const bool isg = bn >= 8;
  const bool isc = bn >= 1 && bn <= 7;
  return codeword(lut, bn, isg ? (w >> 1) & 1023 : (w >> 6) & 31, w & 1,
                  isc ? (w >> 3) & 7 : 0);
}

// A two-word record's codeword (slim_decode_op): rebuilt from (bin, k, cb,
// nb), or carried inline on a bit-22 row.
__device__ __forceinline__ uint32_t two_word_codeword(
    const int32_t* __restrict__ lut, uint32_t p) {
  if ((p >> 22) & 1) return ((p >> 1) & 0xFFFF) | ((p >> 17) & 31) << 16;
  return codeword(lut, (p >> 1) & 31, (p >> 6) & 1023, (p >> 16) & 1,
                  (p >> 17) & 7);
}

// Bin b's end-of-plane flush as a fused-key record (slim_sort_operand_packed):
// a golomb bin completes with (k, cb = 1), or (m - 1, cb = 0) for the full
// run; a custom bin with its prefix extended by the flush bits, nb = cb = 0.
__device__ __forceinline__ int32_t fused_flush(const int32_t* __restrict__ lut,
                                               uint32_t b, uint32_t f) {
  const uint32_t op1 = f & 0x1FFFF;
  const uint32_t k = (f >> 17) & 1023;
  const uint32_t nb = (f >> 27) & 31;
  if (op1 == 0 || b == 0) return kBigPk;
  uint32_t pl;
  if (b >= 8) {
    pl = b << 11 | k << 1
         | (k != (uint32_t)__ldg(lut + kLutGm + b) - 1 ? 1u : 0u);
  } else {
    const uint32_t fv =
        (uint32_t)__ldg(lut + kLutFlv + (b * 8 + (nb & 7)) * 32 + (k & 31));
    pl = b << 11 | ((k | fv << nb) & 31) << 6;
  }
  return (int32_t)((op1 - 1) << 16 | pl);
}

// Bin b's flush as a two-word row (slim_sort_operands, _flush_code): the
// codeword inline with bit 22, keyed by the whole open ordinal.
__device__ __forceinline__ int2 two_word_flush(const int32_t* __restrict__ lut,
                                               uint32_t b, uint32_t f,
                                               int32_t op1) {
  if (op1 <= 0) return make_int2(0, kBig);
  const uint32_t k = (f >> 17) & 1023;
  const uint32_t nb = (f >> 27) & 31;
  uint32_t kf = k;
  if (b <= 7) {
    const uint32_t fv =
        (uint32_t)__ldg(lut + kLutFlv + (b * 8 + (nb & 7)) * 32 + (k & 31));
    kf = (k | fv << nb) & 31;
  }
  const uint32_t cw = codeword(lut, b, kf, 0, 0);
  return make_int2((int32_t)(1u | (cw & 0xFFFF) << 1 | (cw >> 16) << 17
                             | 1u << 22),
                   op1 - 1);
}

// Sum of v over the block's threads, which all call it.
template <int kN>
__device__ __forceinline__ long long block_sum(long long v,
                                               long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < kN / 32; ++w) s += red[w];
  return s;
}

// The lane's codewords to scratch[lane * stride + ordinal].
template <bool kTwo>
__global__ void __launch_bounds__(kPlaceThreads)
slim_pack_place_kernel(const int32_t* __restrict__ rec1,
                       const int32_t* __restrict__ rec2,
                       const int32_t* __restrict__ fstate,
                       const int32_t* __restrict__ fop,
                       const int32_t* __restrict__ ev1,
                       const int32_t* __restrict__ ev2,
                       const int32_t* __restrict__ lut, int L, int lanes,
                       int nev, int slice_to, int stride,
                       uint32_t* __restrict__ scratch) {
  __shared__ int32_t t1[kLanes][kRows + 1];
  __shared__ int32_t t2[kTwo ? kLanes : 1][kRows + 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int l0 = blockIdx.y * kLanes;
  const long long rows = (long long)L + 17 + nev;
  const int lane = l0 + ln;

  for (int i = warp; i < kRows; i += kPlaceThreads / 32) {
    const long long r = r0 + i;
    int32_t a = kTwo ? 0 : kBigPk;
    int32_t b = kBig;
    if (r < rows && lane < lanes) {
      if (r < L) {
        a = rec1[r * lanes + lane];
        if constexpr (kTwo) b = rec2[r * lanes + lane];
      } else if (r < L + 17) {
        const int q = (int)(r - L);
        const uint32_t f = (uint32_t)fstate[(size_t)q * lanes + lane];
        if constexpr (kTwo) {
          const int2 row = two_word_flush(lut, q, f,
                                          fop[(size_t)q * lanes + lane]);
          a = row.x;
          b = row.y;
        } else {
          a = fused_flush(lut, q, f);
        }
      } else {
        const long long e = r - L - 17;
        a = ev1[e * lanes + lane];
        if constexpr (kTwo) b = ev2[e * lanes + lane];
      }
    }
    t1[ln][i] = a;
    if constexpr (kTwo) t2[ln][i] = b;
  }
  __syncthreads();

  for (int j = warp; j < kLanes && l0 + j < lanes; j += kPlaceThreads / 32) {
    uint32_t* row = scratch + (size_t)(l0 + j) * stride;
    for (int i = ln; i < kRows; i += 32) {
      const uint32_t a = (uint32_t)t1[j][i];
      if constexpr (kTwo) {
        const uint32_t ord = (uint32_t)t2[j][i];
        if (ord != (uint32_t)kBig && ord < (uint32_t)slice_to)
          row[ord] = two_word_codeword(lut, a);
      } else {
        const uint32_t ord = (a >> 16) & 0x7FFF;
        if (ord != kNone15 && ord < (uint32_t)slice_to)
          row[ord] = fused_codeword(lut, a);
      }
    }
  }
}

// The codewords a lane packs: ordinals below min(allocations, slice_to).
__device__ __forceinline__ int packed_count(const int32_t* __restrict__ misc,
                                            int lanes, int lane,
                                            int slice_to) {
  const int n = misc[(size_t)lanes + lane];
  return n < slice_to ? n : slice_to;
}

// This thread's kPer scratch words of the block's chunk, and how many of
// them the lane packs.
__device__ __forceinline__ int load_run(const uint32_t* __restrict__ row,
                                        long long lo, int n,
                                        uint32_t (&v)[kPer]) {
  if (lo >= n) return 0;
  const uint4* p = reinterpret_cast<const uint4*>(row + lo);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const uint4 x = p[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  const long long m = n - lo;
  return m < kPer ? (int)m : kPer;
}

__global__ void __launch_bounds__(kThreads)
slim_pack_sums_kernel(const uint32_t* __restrict__ scratch,
                      const int32_t* __restrict__ misc, int lanes,
                      int slice_to, int stride, int nch,
                      int32_t* __restrict__ sums) {
  __shared__ long long red[kThreads / 32];
  const int lane = blockIdx.x;
  const int c = blockIdx.y;
  const int n = packed_count(misc, lanes, lane, slice_to);
  uint32_t v[kPer];
  const int m = load_run(scratch + (size_t)lane * stride,
                         (long long)c * kChunk + threadIdx.x * kPer, n, v);
  long long s = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (e < m) s += (v[e] >> 16) & 31;
  s = block_sum<kThreads>(s, red);
  if (threadIdx.x == 0) sums[(size_t)lane * nch + c] = (int32_t)s;
}

// Writes a word of the payload: an edge word that another thread shares is
// ORed in; zero words are left to the memset.
__device__ __forceinline__ void put_word(uint32_t* __restrict__ row,
                                         long long wi, int words,
                                         uint32_t val, bool edge) {
  if (val == 0 || wi >= words) return;
  if (edge)
    atomicOr(row + wi, val);
  else
    row[wi] = val;
}

__global__ void __launch_bounds__(kThreads)
slim_pack_bits_kernel(const uint32_t* __restrict__ scratch,
                      const int32_t* __restrict__ misc,
                      const int32_t* __restrict__ sums, int lanes,
                      int slice_to, int stride, int nch, int words,
                      long long max_bits, uint32_t* __restrict__ payload,
                      long long* __restrict__ total, bool* __restrict__ over,
                      unsigned long long* __restrict__ runs) {
  __shared__ long long red[kThreads / 32];
  __shared__ uint32_t scan[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int c = blockIdx.y;
  if (runs != nullptr && lane == 0 && c == 0 && tid == 0)
    atomicAdd(runs, 1ull);
  const int n = packed_count(misc, lanes, lane, slice_to);
  if (c > 0 && (long long)c * kChunk >= n) return;   // block-uniform

  // the chunk's first bit: the bits of the chunks before it; the first
  // chunk's block sums them all for the lane's total
  long long pre = 0;
  for (int i = tid; i < (c == 0 ? nch : c); i += kThreads)
    pre += sums[(size_t)lane * nch + i];
  pre = block_sum<kThreads>(pre, red);
  if (c == 0) {
    if (tid == 0) {
      total[lane] = pre;
      over[lane] = misc[(size_t)lanes + lane] > slice_to || pre > max_bits;
    }
    pre = 0;
  }

  uint32_t v[kPer];
  const int m = load_run(scratch + (size_t)lane * stride,
                         (long long)c * kChunk + tid * kPer, n, v);
  uint32_t mine = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (e < m) mine += (v[e] >> 16) & 31;

  // exclusive scan of the threads' bits
  uint32_t inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, inc, o);
    if ((tid & 31) >= o) inc += x;
  }
  if ((tid & 31) == 31) scan[tid >> 5] = inc;
  __syncthreads();
  uint32_t before = inc - mine;
  for (int w = 0; w < (tid >> 5); ++w) before += scan[w];

  uint32_t* row = payload + (size_t)lane * words;
  const long long pos = pre + before;
  long long wi = pos >> 5;
  int nacc = (int)(pos & 31);
  unsigned long long acc = 0;
  bool first = true;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (e >= m) break;
    const uint32_t nb = (v[e] >> 16) & 31;
    acc |= (unsigned long long)(v[e] & 0xFFFF & ((1u << nb) - 1u)) << nacc;
    nacc += (int)nb;
    if (nacc >= 32) {
      put_word(row, wi, words, (uint32_t)acc, first);
      first = false;
      acc >>= 32;
      nacc -= 32;
      ++wi;
    }
  }
  put_word(row, wi, words, (uint32_t)acc, true);
}

template <bool kTwo>
int launch(const void* rec1, const void* rec2, const void* fstate,
           const void* fop, const void* ev1, const void* ev2,
           const void* misc, const void* luts, int L, int lanes, int nev,
           int slice_to, int stride, int nch, long long max_bits,
           int lut_size, void* scratch, void* sums, void* payload,
           void* total, void* over, void* runs, void* stream) {
  const long long rows = (long long)L + 17 + nev;
  const long long tiles = (rows + kRows - 1) / kRows;
  if (lut_size != kLutSize || L < 0 || nev < 1 || lanes < 0
      || slice_to < 0 || rows >= kBig || max_bits < 0 || max_bits % 32
      || stride < slice_to || stride % kPer || nch < 1
      || (long long)nch * kChunk < slice_to || nch > 65535
      || (lanes + kLanes - 1) / kLanes > 65535 || tiles > 0x7FFFFFFF
      || (long long)lanes * stride >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int words = (int)(max_bits / 32);
  cudaError_t err = cudaMemsetAsync(payload, 0, (size_t)lanes * words * 4, s);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(slim_pack_place_kernel<kTwo>,
         dim3((unsigned)tiles, (unsigned)((lanes + kLanes - 1) / kLanes)),
         kPlaceThreads, s,
         (const int32_t*)rec1, (const int32_t*)rec2, (const int32_t*)fstate,
         (const int32_t*)fop, (const int32_t*)ev1, (const int32_t*)ev2,
         (const int32_t*)luts, L, lanes, nev, slice_to, stride,
         (uint32_t*)scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)lanes, (unsigned)nch);
  LAUNCH(slim_pack_sums_kernel, grid, kThreads, s,
         (const uint32_t*)scratch, (const int32_t*)misc, lanes, slice_to,
         stride, nch, (int32_t*)sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  LAUNCH(slim_pack_bits_kernel, grid, kThreads, s,
         (const uint32_t*)scratch, (const int32_t*)misc, (const int32_t*)sums,
         lanes, slice_to, stride, nch, words, max_bits, (uint32_t*)payload,
         (long long*)total, (bool*)over, (unsigned long long*)runs);
  return (int)cudaGetLastError();
}

}  // namespace

// Fused-key records: rec (L, lanes), fstate (17, lanes), ev (nev, lanes);
// rec2, fop and ev2 are unused.
extern "C" int slim_pack_launch(
    const void* rec, const void* rec2, const void* fstate, const void* fop,
    const void* ev, const void* ev2, const void* misc, const void* luts,
    int L, int lanes, int nev, int slice_to, int stride, int nch,
    long long max_bits, int lut_size, void* scratch, void* sums,
    void* payload, void* total, void* over, void* runs, void* stream) {
  return launch<false>(rec, rec2, fstate, fop, ev, ev2, misc, luts, L, lanes,
                       nev, slice_to, stride, nch, max_bits, lut_size,
                       scratch, sums, payload, total, over, runs, stream);
}

// Two-word records: rec1, rec2 (L, lanes), fstate, fop (17, lanes), ev1,
// ev2 (nev, lanes).
extern "C" int slim_pack_two_word_launch(
    const void* rec1, const void* rec2, const void* fstate, const void* fop,
    const void* ev1, const void* ev2, const void* misc, const void* luts,
    int L, int lanes, int nev, int slice_to, int stride, int nch,
    long long max_bits, int lut_size, void* scratch, void* sums,
    void* payload, void* total, void* over, void* runs, void* stream) {
  return launch<true>(rec1, rec2, fstate, fop, ev1, ev2, misc, luts, L,
                      lanes, nev, slice_to, stride, nch, max_bits, lut_size,
                      scratch, sums, payload, total, over, runs, stream);
}
