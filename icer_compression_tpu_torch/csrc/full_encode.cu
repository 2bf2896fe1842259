// Kernels 4 and 5 of the ICER port: the full state-machine entropy coder.
//
// Kernel 4 replaces the TPU kernel make_encode_lanes_pallas of
// icer_compression_tpu/ops/pallas_entropy.py:188 (step _coder_step :87,
// end-of-plane flush _tail_flush :382); kernel 5 replaces its tiled variant
// make_encode_lanes_pallas_tiled (:284).  Same I/O contract, bit for bit;
// the plain PyTorch version of both is encode_lanes_full_plain in
// ops/entropy_full.py, which documents it.
//
// Bound on this card: the data moved is three int32 words in and three out
// per emission step (a 512x512 image's stage-1 block, 16,640 steps x 162
// lanes, moves about 65 MB: about 19 us at 3.35 TB/s), and the arithmetic
// is a few tens of integer operations per valid step.  The real limit is
// the serial chain: every step reads the counters and bin state that the
// previous step wrote, so a lane of n valid steps costs n dependent step
// latencies, and a block has only a few hundred lanes for 132 SMs.  With
// one thread on the chain, a step costs about as many cycles as it has
// dependent instructions, so the design takes instructions off the chain.
//
// Design (kernel 1's layout, csrc/slim_encode.cu): one lane per block of
// one warp, so the lanes spread over the SMs and no lane pays another's
// branches.  Thread 0 runs the chain; the warp does everything else.
//  - The three input streams go through a ring of kStages tiles of kTile
//    steps in shared memory with cp.async, kStages - 1 tiles ahead of the
//    chain; the last tile is masked (any L).  Thread i copies step i of a
//    tile and packs it into one word, valid | ctx << 1 | bit << 6 (the
//    packing of ops/encode._split_words; ctx >= 17 is the uncoded
//    context), so the chain reads a step with one shared load.
//  - The chain visits only the tile's valid steps (a ballot of the valid
//    flags), and a tile without one skips the chain: an empty step
//    changes no state.  On compacted, valid-first lanes (the `pallas`
//    backend) each lane's chain ends at its last valid tile.
//  - The 17 context counters sit in shared memory as counts_word (with a
//    constant entry for the uncoded context's (1, 2) counts): the counts
//    and the bin and inversion they give, so a step has its bin with one
//    load and the 16-cutoff count runs for the updated counts, beside the
//    bin-state work.  The chain loads the next step's counters and the
//    word of the step after it ahead; where the next step has this step's
//    context, it takes the updated counters from registers.  The 17 bin
//    states (k | nb << 16 beside the opening emission + 1, 0 = closed) sit
//    in shared memory too, the 16 bin cutoffs in registers.
//  - The chain keeps only what the next step reads.  For a completed
//    codeword it writes a descriptor (bin, golomb run length or custom
//    input prefix, run-done or uncoded bit) and the opening emission; the
//    warp then expands the tile's descriptors into (code, nbits, open)
//    (golomb remainder bit reversal, custom output tables) and stores the
//    tile's three output rows.
//  - After the last tile, 17 threads write the end-of-plane flush rows
//    from the bin states, through the same expansion.
// Kernel 4 steps tiles of 32, one step per thread of the warp (measured no
// slower than kernel 1's 64); kernel 5 is the same kernel with the TPU
// kernel's 8-step tile and a deeper ring.  There is no reorder-window
// eviction here, as on the TPU: the tail detects lanes that need one and
// the caller re-encodes them on the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder_common.cuh"

namespace {

using icer::bin_of;
using icer::cp_async4;
using icer::cp_async_commit;
using icer::cp_async_wait;

constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// LUT layout: kernel 1's LUT (ops/entropy_slim.py), which ops/entropy_full.py
// passes as it is
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutCinb = 33;
constexpr int kLutFlv = 289;
constexpr int kLutGl = 2337;
constexpr int kLutGi = 2354;
constexpr int kLutCout = 2371;
constexpr int kLutCobits = 2627;
constexpr int kLutSize = 2883;

__device__ __forceinline__ int bitrev16(int v, int nbits) {
  return (int)(__brev((unsigned)(v & 0xFFFF)) >> 16) >> (16 - nbits);
}

// A completed codeword's descriptor: 1 | bin << 1 | f << 6 | kv << 7, with
// f the golomb run-done flag (the 1-bit full-run code) or the uncoded bit,
// kv the golomb run length before the step or the custom input prefix.
__device__ __forceinline__ uint32_t descriptor(int bn, uint32_t f,
                                               uint32_t kv) {
  return 1u | (uint32_t)bn << 1 | f << 6 | kv << 7;
}

// A context's counter word: total | zero << 16 | bin << 25 | inv << 30,
// with the bin and the inversion that those counts give, so that a step
// reads its bin with its counts and the 16-cutoff count runs when the
// counts change, beside the rest of the step.
__device__ __forceinline__ uint32_t counts_word(const int* cut, int tc,
                                                int zc) {
  const bool inv = zc < (tc >> 1);
  const int zeff = inv ? tc - zc : zc;
  const int bn = bin_of(cut, zeff << 16, tc);
  return (uint32_t)tc | (uint32_t)zc << 16 | (uint32_t)bn << 25
         | (inv ? 1u << 30 : 0u);
}

// The (code, nbits) of a descriptor.
__device__ __forceinline__ void expand(uint32_t d, const int* lut, int& code,
                                       int& nbits) {
  const int bn = (d >> 1) & 31;
  const int f = (d >> 6) & 1;
  const int kv = (int)(d >> 7);
  if (bn >= 8) {
    const int l = lut[kLutGl + bn], i = lut[kLutGi + bn];
    const int adj = kv < i ? kv : kv + i;
    const int glen = l + (kv >= i);
    code = f ? 1 : bitrev16(adj, glen);
    nbits = f ? 1 : glen;
  } else if (bn >= 1) {
    code = lut[kLutCout + bn * 32 + kv];
    nbits = lut[kLutCobits + bn * 32 + kv];
  } else {
    code = f;
    nbits = 1;
  }
}

template <int kTile, int kStages>
__global__ void __launch_bounds__(32)
full_encode_kernel(const int32_t* __restrict__ valid,
                   const int32_t* __restrict__ ctx,
                   const int32_t* __restrict__ bit,
                   int32_t* __restrict__ code, int32_t* __restrict__ nbits,
                   int32_t* __restrict__ opn,
                   const int32_t* __restrict__ luts, int L, int lanes,
                   unsigned long long* __restrict__ runs) {
  // thread i copies, packs and expands step i of each tile
  static_assert(kTile >= 1 && kTile <= 32 && kStages >= 2, "tile shape");
  __shared__ int32_t lut[kLutSize];
  __shared__ int32_t ring[kStages][3][kTile];   // valid, ctx, bit
  __shared__ uint32_t word[kTile];   // packed step, then its descriptor
  __shared__ int32_t opw[kTile];     // opening emission of a completion
  __shared__ uint32_t zt[18];        // counts_word per context; [17] uncoded
  __shared__ int2 bs[17];            // (k | nb << 16, opening emission + 1)
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  if (runs != nullptr && lane == 0 && tid == 0) atomicAdd(runs, 1ull);
  for (int i = tid; i < kLutSize; i += 32) lut[i] = luts[i];
  if (tid < 17) bs[tid] = make_int2(0, 0);

  const int T = (L + kTile - 1) / kTile;
  auto load_tile = [&](int t) {
    int32_t(*const dst)[kTile] = ring[t % kStages];
    const int r = t * kTile + tid;
    if (tid >= kTile) return;
    if (r < L) {
      const size_t off = (size_t)r * lanes + lane;
      cp_async4(&dst[0][tid], valid + off);
      cp_async4(&dst[1][tid], ctx + off);
      cp_async4(&dst[2][tid], bit + off);
    } else {
      dst[0][tid] = 0;   // past the end: an empty step
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile(s);
    cp_async_commit();
  }
  __syncthreads();

  const int* const gm = lut + kLutGm;
  const int* const cinb = lut + kLutCinb;
  int cut[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) cut[j] = lut[kLutCut + j];
  // the coded contexts start at (zero, total) = (2, 4); the uncoded one
  // codes with (1, 2) and is never updated
  if (tid < 18) zt[tid] = tid < 17 ? counts_word(cut, 4, 2)
                                   : counts_word(cut, 2, 1);
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    // each thread packs the step it copied, so no barrier before it
    cp_async_wait<kStages - 2>();
    if (t + kStages - 1 < T) load_tile(t + kStages - 1);
    cp_async_commit();
    const int32_t(*const src)[kTile] = ring[t % kStages];
    bool v = false;
    if (tid < kTile) {
      v = src[0][tid] != 0;
      const uint32_t c = min((uint32_t)src[1][tid], 17u);
      word[tid] = v ? 1u | c << 1 | ((uint32_t)src[2][tid] & 1u) << 6 : 0u;
    }
    uint32_t todo = __ballot_sync(kFull, v);
    __syncwarp();
    const int base = t * kTile;

    if (tid == 0 && todo) {
      // The tile's valid steps in order.  Each iteration loads the next
      // step's counters and the word of the step after it, so a step
      // starts with its counters at hand; where the next step has this
      // step's context, it takes the updated counters from registers.
      int cur = __ffs(todo) - 1;
      todo &= todo - 1;
      int nxt = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      uint32_t w = word[cur];
      uint32_t wn = nxt >= 0 ? word[nxt] : 0u;
      uint32_t z = zt[(w >> 1) & 31];
      for (;;) {
        const int c = (w >> 1) & 31;
        const uint32_t b = (w >> 6) & 1;
        const int cn = (wn >> 1) & 31;
        const uint32_t zpre = zt[cn];
        int nn = -1;
        uint32_t wnn = 0u;
        if (todo) {
          nn = __ffs(todo) - 1;
          todo &= todo - 1;
          wnn = word[nn];
        }

        // ---- the bin, read with the counts
        const int bn = (z >> 25) & 31;
        const uint32_t cb = b ^ ((z >> 30) & 1);
        const int2 st = bs[bn];
        const uint32_t gmb = (uint32_t)gm[bn];   // loaded beside the state

        // ---- the counter update and the next bin (zt[17] stays)
        int tc2 = (int)(z & 0xFFFF) + 1;
        int zc2 = (int)((z >> 16) & 511) + (b == 0);
        if (tc2 >= kRescaleCap) {
          tc2 >>= 1;
          if (zc2 > tc2) zc2 >>= 1;
        }
        const uint32_t znew = c < 17 ? counts_word(cut, tc2, zc2) : z;
        if (c < 17) zt[c] = znew;

        // ---- the bin's open codeword
        int op1 = st.y;
        uint32_t k = st.x & 0xFFFF;
        uint32_t nb = (uint32_t)st.x >> 16;
        if (op1 == 0) {
          op1 = base + cur + 1;
          k = 0;
          nb = 0;
        }
        const bool isg = bn >= 8;
        const bool isc = bn >= 1 && bn <= 7;
        const uint32_t kz = k + (cb == 0);
        // custom bins hold nb <= 4 (golomb bins count nb up but never read it)
        const uint32_t val = (k | (cb << (nb & 7))) & 31;
        const uint32_t nb2 = nb + 1;
        bool complete = isg ? (cb == 1 || kz >= gmb) : true;
        if (isc) complete = (uint32_t)cinb[bn * 32 + val] == nb2;
        const uint32_t newk = isg ? kz : val;
        bs[bn] = complete ? make_int2(0, 0)
                          : make_int2((int)(newk | nb2 << 16), op1);
        if (complete) {
          // golomb: completing on a zero is a full run
          word[cur] = descriptor(bn, isg ? (uint32_t)(cb == 0) : cb,
                                 isg ? k : val);
          opw[cur] = op1 - 1;
        } else {
          word[cur] = 0u;
        }
        if (nxt < 0) break;
        z = cn == c ? znew : zpre;
        w = wn;
        wn = wnn;
        cur = nxt;
        nxt = nn;
      }
    }
    __syncwarp();

    // ---- the tile's codewords, off the chain
    if (tid < kTile && base + tid < L) {
      const uint32_t d = word[tid];
      int cw = 0, cn = 0, co = kBig;
      if (d & 1u) {
        expand(d, lut, cw, cn);
        co = opw[tid];
      }
      const size_t off = (size_t)(base + tid) * lanes + lane;
      code[off] = cw;
      nbits[off] = cn;
      opn[off] = co;
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  // ---- the 17 end-of-plane flush rows (rows L .. L + 16)
  if (tid < 17) {
    const int2 st = bs[tid];
    int fc = 0, fn = 0, fo = kBig;
    if (tid >= 1 && st.y > 0) {
      const uint32_t k = st.x & 0xFFFF;
      const uint32_t nb = (uint32_t)st.x >> 16;
      uint32_t d;
      if (tid >= 8) {
        d = descriptor(tid, k == (uint32_t)gm[tid] - 1, k);
      } else {
        const uint32_t fv =
            (uint32_t)lut[kLutFlv + (tid * 8 + (nb & 7)) * 32 + (k & 31)];
        d = descriptor(tid, 0u, (k | (fv << nb)) & 31);
      }
      expand(d, lut, fc, fn);
      fo = st.y - 1;
    }
    const size_t off = (size_t)(L + tid) * lanes + lane;
    code[off] = fc;
    nbits[off] = fn;
    opn[off] = fo;
  }
}

template <int kTile, int kStages>
int launch(const void* valid, const void* ctx, const void* bit, void* code,
           void* nbits, void* opn, const void* luts, int L, int lanes,
           int lut_size, void* runs, void* stream) {
  if (lut_size != kLutSize || L < 0 || L + 17 >= kBig)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return (int)cudaSuccess;
  full_encode_kernel<kTile, kStages><<<lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)valid, (const int32_t*)ctx, (const int32_t*)bit,
      (int32_t*)code, (int32_t*)nbits, (int32_t*)opn, (const int32_t*)luts,
      L, lanes, (unsigned long long*)runs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int full_encode_launch(const void* valid, const void* ctx,
                                  const void* bit, void* code, void* nbits,
                                  void* opn, const void* luts, int L,
                                  int lanes, int lut_size, void* runs,
                                  void* stream) {
  return launch<32, 3>(valid, ctx, bit, code, nbits, opn, luts, L, lanes,
                       lut_size, runs, stream);
}

extern "C" int full_encode_tiled_launch(const void* valid, const void* ctx,
                                        const void* bit, void* code,
                                        void* nbits, void* opn,
                                        const void* luts, int L, int lanes,
                                        int lut_size, void* runs,
                                        void* stream) {
  return launch<8, 8>(valid, ctx, bit, code, nbits, opn, luts, L, lanes,
                      lut_size, runs, stream);
}
