// Kernel 1 of the ICER port: the slim interleaved entropy coder.
//
// Replaces the TPU kernel make_encode_lanes_slim of
// icer_compression_tpu/ops/pallas_entropy.py:744 (step _slim_step :513) in
// both its record modes, as two kernels: slim_encode_kernel writes one
// fused-key record per step (pallas_entropy.py:496-510) and serves lanes
// whose allocation ordinals stay below 2^15; slim_encode_wide_kernel writes
// the two-word records (pallas_entropy.py:732-741) for lanes of any length,
// and builds each codeword that the reorder window evicts
// (_evict_flush_code :444).  Where a lane's ordinals fit the TPU kernel's
// 17-bit fields and its evictions its 32 side-buffer rows, both keep the TPU
// kernel's I/O contract bit for bit; the plain PyTorch version is
// encode_lanes_slim_plain in ops/entropy_slim.py.
//
// Bound on this card: the data moved is small (one int32 word in and one
// record out per emission step, two in the two-word mode: about 19 MB each
// way for a 512x512 image, about 11 us at 3.35 TB/s) and so is the
// arithmetic (tens of integer ops per valid step).  The real limit is the
// serial dependency chain: every step reads the counters and bin state the
// previous step wrote, so a lane of L steps costs L dependent step
// latencies, and an image has only a few hundred lanes (702 at 512x512) for
// 132 SMs.  With one thread on the chain, a step costs about as many cycles
// as it has dependent instructions.
//
// Both kernels: one lane per block of one warp, so the lanes of a launch
// spread over the SMs and no lane pays another's branches (lanes that share
// a warp take each other's paths; on the card that costs more than the 31
// threads left idle, PERF.md).  Thread 0 runs the chain.  No step waits on
// device memory: the block's 32 threads stream the lane's words through a
// ring of kStages tiles of kTile steps in shared memory with cp.async,
// kStages - 1 tiles ahead of the chain; the chain writes each step's record
// over its word, and the block then stores the tile's records.  The 16 bin
// cutoffs sit in registers.  The reorder-window check scans the 17 bin
// states only when the allocation count has passed a lower bound of the
// oldest open ordinal by CIRC_BUF_SIZE: open ordinals only grow, so the
// bound from the last scan stays valid and most allocations skip the scan.
//
// The fused-key kernel keeps the TPU kernel's bin-state word,
// (open_alloc + 1) | k << 17 | nb << 27, and visits every step.
//
// The two-word kernel (slim_encode_wide_kernel):
//  - Full-width ordinals: the bin state is (k | nb << 16, open ordinal + 1)
//    in an int2, so lanes past 2^17 steps keep exact ordinals.  It writes
//    the TPU kernel's final state word (the ordinal's low 17 bits) and,
//    beside it, the whole open ordinal per bin.
//  - An eviction side buffer of nev rows, a launch argument: a lane evicts
//    at most 16 * (allocations // 2048 + 1) times (after bin q is evicted,
//    its next codeword opens no earlier than the count then, so it can be
//    evicted again only 2,048 allocations later; bin 0 never stays open),
//    and the encoder sizes the buffer by that bound, so no lane overflows
//    it.  A lane past nev evictions sets the fallback flag.
//  - Kernel 4's chain levers (csrc/full_encode.cu) that measured faster on
//    an H100 (scripts/k1_levers.py, PERF.md): the chain visits only the
//    tile's valid steps (a ballot of the valid flags; slim lanes are not
//    compacted, so padding and absent sign slots are about 45% of the
//    steps), and it loads the next step's counters and the word of the
//    step after it ahead, taking the updated counters from registers where
//    the next step has this step's context.  Kernel 4's counter word that
//    carries its bin and inversion measured slower here: the 16-cutoff
//    count then runs on the counter update, which the next step of the
//    same context waits for, instead of at the step's start.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder_common.cuh"

namespace {

using icer::bin_of;
using icer::cp_async4;
using icer::cp_async_commit;
using icer::cp_async_wait;

constexpr int kNEV = 32;                // the fused-key side buffer
constexpr int kCircBuf = 2048;          // CIRC_BUF_SIZE
constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kBig = 1 << 30;
constexpr int32_t kBigPk = 0x7FFF << 16;
constexpr int kTile = 64;               // steps per tile (divides 256)
constexpr int kStages = 3;              // tiles in the ring
constexpr unsigned kFull = 0xffffffffu;

// LUT layout, shared with ops/entropy_slim.py
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutCinb = 33;
constexpr int kLutFlv = 289;
constexpr int kLutFused = 2337;         // the tables the fused kernel reads
constexpr int kLutGl = 2337;
constexpr int kLutGi = 2354;
constexpr int kLutCout = 2371;
constexpr int kLutCobits = 2627;
constexpr int kLutSize = 2883;

// The codeword that flushes the open codeword (k, nb) of bin b, as the
// two-word records carry it: 1 | code << 1 | nbits << 17 | 1 << 22.  A
// golomb bin sends its partial run (bit-reversed), or '1' for the full run
// at k = m - 1; a custom bin extends its prefix by the flush bits and sends
// the output code of the result (icer_encoding.c:141-189).
__device__ __forceinline__ int32_t flush_record(const int32_t* lut, int b,
                                                uint32_t k, uint32_t nb) {
  uint32_t code, nbits;
  if (b >= 8) {
    const uint32_t m = (uint32_t)lut[kLutGm + b];
    const uint32_t ii = (uint32_t)lut[kLutGi + b];
    if (k == m - 1) {
      code = 1u;
      nbits = 1u;
    } else {
      const uint32_t adj = k < ii ? k : k + ii;
      nbits = (uint32_t)lut[kLutGl + b] + (k >= ii ? 1u : 0u);
      code = __brev(adj) >> (32 - nbits);
    }
  } else {
    const uint32_t fv =
        (uint32_t)lut[kLutFlv + (b * 8 + (nb & 7)) * 32 + (k & 31)];
    const uint32_t fin = (k | (fv << nb)) & 31;
    code = (uint32_t)lut[kLutCout + b * 32 + fin];
    nbits = (uint32_t)lut[kLutCobits + b * 32 + fin];
  }
  return (int32_t)(1u | (code << 1) | (nbits << 17) | (1u << 22));
}

// The fused-key records (rec, fstate, misc, ev), ordinals below 2^15.
__global__ void __launch_bounds__(32)
slim_encode_kernel(const int32_t* __restrict__ words,
                   int32_t* __restrict__ rec, int32_t* __restrict__ fstate,
                   int32_t* __restrict__ misc, int32_t* __restrict__ ev_out,
                   const int32_t* __restrict__ luts, int L, int lanes,
                   unsigned long long* __restrict__ runs) {
  __shared__ int32_t lut[kLutFused];
  __shared__ int32_t ring[kStages][kTile];
  __shared__ uint32_t zt[17];   // total | zero << 16
  __shared__ uint32_t bs[17];   // (open_alloc + 1) | k << 17 | nb << 27
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  if (runs != nullptr && lane == 0 && tid == 0) atomicAdd(runs, 1ull);
  for (int i = tid; i < kLutFused; i += 32) lut[i] = luts[i];
  if (tid < 17) {
    zt[tid] = 4u | (2u << 16);
    bs[tid] = 0u;
  }
  for (int e = tid; e < kNEV; e += 32)
    ev_out[(size_t)e * lanes + lane] = kBigPk;

  const int T = L / kTile;
  auto load_tile = [&](int t) {
    int32_t* const dst = ring[t % kStages];
    const int32_t* const src = words + (size_t)t * kTile * lanes + lane;
    for (int i = tid; i < kTile; i += 32)
      cp_async4(dst + i, src + (size_t)i * lanes);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile(s);
    cp_async_commit();
  }
  __syncthreads();

  const int32_t* const gm = lut + kLutGm;
  const int32_t* const cinb = lut + kLutCinb;
  const int32_t* const flv = lut + kLutFlv;
  int cut[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) cut[j] = lut[kLutCut + j];
  int alloc = 0, flg = 0, ec = 0;
  int lo = 0;   // a lower bound of the oldest open allocation ordinal

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < T) load_tile(t + kStages - 1);
    cp_async_commit();
    int32_t* const tile = ring[t % kStages];
    if (tid == 0) {
      uint32_t wn = (uint32_t)tile[0];
      for (int i = 0; i < kTile; ++i) {
        // the next step's word is loaded a step ahead
        const uint32_t w = wn;
        if (i + 1 < kTile) wn = (uint32_t)tile[i + 1];
        int32_t out = kBigPk;
        if (w & 1u) {
          const int c = (w >> 1) & 31;
          const uint32_t b = (w >> 6) & 1;
          const bool unc = c >= 17;

          // ---- counters & bin
          const uint32_t ztc = unc ? 0u : zt[c];
          const int tc = ztc & 0xFFFF;
          const int zc = ztc >> 16;
          const int zcu = unc ? 1 : zc;
          const int tcu = unc ? 2 : tc;
          const bool inv = zcu < (tcu >> 1);
          const int zeff = inv ? tcu - zcu : zcu;
          const uint32_t cb = b ^ (inv ? 1u : 0u);
          const int bn = bin_of(cut, zeff << 16, tcu);
          if (!unc) {
            int tc2 = tc + 1;
            int zc2 = zc + (b == 0);
            if (tc2 >= kRescaleCap) {
              tc2 >>= 1;
              if (zc2 > tc2) zc2 >>= 1;
            }
            zt[c] = (uint32_t)tc2 | ((uint32_t)zc2 << 16);
          }

          // ---- bin state and reorder-window eviction
          const uint32_t bsb = bs[bn];
          const uint32_t gmb = (uint32_t)gm[bn];   // loaded beside the state
          int op1 = bsb & 0x1FFFF;
          uint32_t k = (bsb >> 17) & 1023;
          uint32_t nb = bsb >> 27;
          if (op1 == 0) {
            if (alloc >= lo + kCircBuf) {
              int amin = kBig;
              for (int q = 0; q < 17; ++q) {
                const int opq = bs[q] & 0x1FFFF;
                if (opq > 0 && opq - 1 < amin) amin = opq - 1;
              }
              if (amin + kCircBuf <= alloc) {
                // force-complete the oldest open codeword
                // (icer_encoding.c:59-64)
                int ebin = 0;
                for (int q = 1; q < 17; ++q)
                  if ((int)(bs[q] & 0x1FFFF) == amin + 1) ebin = q;
                const uint32_t erow = bs[ebin];
                const uint32_t ek = (erow >> 17) & 1023;
                const uint32_t enb = erow >> 27;
                uint32_t pl;
                if (ebin >= 8) {
                  pl = ((uint32_t)ebin << 11) | (ek << 1)
                       | (ek == (uint32_t)gm[ebin] - 1 ? 0u : 1u);
                } else {
                  const uint32_t fv = (uint32_t)
                      flv[(ebin * 8 + (enb & 7)) * 32 + (ek & 31)];
                  const uint32_t fin = (ek | (fv << enb)) & 31;
                  pl = ((uint32_t)ebin << 11) | (fin << 6);
                }
                bs[ebin] = 0u;
                if (ec < kNEV) {
                  ev_out[(size_t)ec * lanes + lane] =
                      (int32_t)(((uint32_t)amin << 16) | pl);
                } else {
                  flg = 1;
                }
                ++ec;
              }
              lo = amin == kBig ? alloc : amin;
            }
            op1 = alloc + 1;
            ++alloc;
            k = 0;
            nb = 0;
          }

          // ---- codeword progress and completion
          const bool isg = bn >= 8;
          const bool isc = bn >= 1 && bn <= 7;
          const uint32_t kz = k + (cb == 0);
          const uint32_t val = (k | (cb << nb)) & 31;
          const uint32_t nb2 = nb + 1;
          bool complete;
          if (isg)
            complete = cb == 1 || kz >= gmb;
          else if (isc)
            complete = (uint32_t)cinb[bn * 32 + val] == nb2;
          else
            complete = true;
          const uint32_t newk = isg ? kz : val;
          bs[bn] = complete ? 0u
                            : ((uint32_t)op1 | (newk << 17) | (nb2 << 27));
          if (complete) {
            uint32_t pl;
            if (isg)
              pl = ((uint32_t)bn << 11) | (k << 1) | cb;
            else if (isc)
              pl = ((uint32_t)bn << 11) | (k << 6) | ((nb & 7) << 3) | cb;
            else
              pl = cb;
            out = (int32_t)(((uint32_t)(op1 - 1) << 16) | pl);
          }
        }
        tile[i] = out;
      }
    }
    __syncthreads();
    // the tile's records
    const size_t row0 = (size_t)t * kTile;
    for (int i = tid; i < kTile; i += 32)
      rec[(row0 + i) * lanes + lane] = tile[i];
  }
  cp_async_wait<0>();

  if (tid == 0) {
    for (int q = 0; q < 17; ++q)
      fstate[(size_t)q * lanes + lane] = (int32_t)bs[q];
    misc[lane] = flg;
    misc[(size_t)lanes + lane] = alloc;
    misc[(size_t)2 * lanes + lane] = ec;
    for (int r = 3; r < 8; ++r) misc[(size_t)r * lanes + lane] = 0;
  }
}

// A valid step's word with every uncoded context (>= 17) as 17, so the
// chain indexes the counters without a clamp; an empty step becomes 0.
__device__ __forceinline__ uint32_t repack(uint32_t w) {
  const uint32_t c = min((w >> 1) & 31u, 17u);
  return (w & 1u) ? 1u | c << 1 | (w & (1u << 6)) : 0u;
}

// The two-word records (rec1, rec2, fstate, misc, ev1, ev2) and the open
// ordinals (fop), at any L; ev1/ev2 have nev rows.
__global__ void __launch_bounds__(32)
slim_encode_wide_kernel(const int32_t* __restrict__ words,
                        int32_t* __restrict__ rec1,
                        int32_t* __restrict__ rec2,
                        int32_t* __restrict__ fstate,
                        int32_t* __restrict__ misc,
                        int32_t* __restrict__ ev1,
                        int32_t* __restrict__ ev2,
                        int32_t* __restrict__ fop,
                        const int32_t* __restrict__ luts, int L, int lanes,
                        int nev, unsigned long long* __restrict__ runs) {
  __shared__ int32_t lut[kLutSize];
  __shared__ uint32_t ring[kStages][kTile];   // words, then rec1
  __shared__ int32_t ord[kTile];              // the tile's rec2
  __shared__ uint32_t zt[18];   // counter word per context; [17] uncoded
  __shared__ int2 bs[17];       // (k | nb << 16, open ordinal + 1)
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  if (runs != nullptr && lane == 0 && tid == 0) atomicAdd(runs, 1ull);
  for (int i = tid; i < kLutSize; i += 32) lut[i] = luts[i];
  if (tid < 17) bs[tid] = make_int2(0, 0);
  for (int e = tid; e < nev; e += 32) {
    ev1[(size_t)e * lanes + lane] = 0;
    ev2[(size_t)e * lanes + lane] = kBig;
  }

  const int T = L / kTile;
  auto load_tile = [&](int t) {
    uint32_t* const dst = ring[t % kStages];
    const int32_t* const src = words + (size_t)t * kTile * lanes + lane;
    for (int i = tid; i < kTile; i += 32)
      cp_async4(dst + i, src + (size_t)i * lanes);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile(s);
    cp_async_commit();
  }

  const int32_t* const gm = lut + kLutGm;
  const int32_t* const cinb = lut + kLutCinb;
  int cut[16];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 16; ++j) cut[j] = lut[kLutCut + j];
  // the coded contexts start at (zero, total) = (2, 4); the uncoded one
  // codes with (1, 2) and is never updated
  if (tid < 18) zt[tid] = tid < 17 ? 4u | 2u << 16 : 2u | 1u << 16;
  int alloc = 0, flg = 0, ec = 0;
  int lo = 0;   // a lower bound of the oldest open allocation ordinal

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < T) load_tile(t + kStages - 1);
    cp_async_commit();
    uint32_t* const tile = ring[t % kStages];
    const uint32_t wa = repack(tile[tid]), wb = repack(tile[tid + 32]);
    tile[tid] = wa;
    tile[tid + 32] = wb;
    const uint64_t valid = (uint64_t)__ballot_sync(kFull, wa & 1u)
                           | (uint64_t)__ballot_sync(kFull, wb & 1u) << 32;
    __syncwarp();

    if (tid == 0 && valid) {
      // The valid steps in order.  Each iteration loads the next step's
      // counters and the word of the step after it, so a step starts with
      // its counters at hand.
      uint64_t todo = valid;
      int cur = __ffsll(todo) - 1;
      todo &= todo - 1;
      int nxt = todo ? __ffsll(todo) - 1 : -1;
      todo &= todo - 1;
      uint32_t w = tile[cur];
      uint32_t wn = nxt >= 0 ? tile[nxt] : 0u;
      uint32_t z = zt[(w >> 1) & 31];
      for (;;) {
        const int c = (w >> 1) & 31;
        const int cn = (wn >> 1) & 31;
        const uint32_t zpre = zt[cn];
        int nn = -1;
        uint32_t wnn = 0u;
        if (todo) {
          nn = __ffsll(todo) - 1;
          todo &= todo - 1;
          wnn = tile[nn];
        }
        uint32_t znew = z;
        uint32_t out = 0u;
        const uint32_t b = (w >> 6) & 1;
        const int tc = (int)(z & 0xFFFF);
        const int zc = (int)((z >> 16) & 511);

        // ---- the bin, read with the counts
        const bool inv = zc < (tc >> 1);
        const int bn = bin_of(cut, (inv ? tc - zc : zc) << 16, tc);
        const uint32_t cb = b ^ (inv ? 1u : 0u);
        const int2 st = bs[bn];
        const uint32_t gmb = (uint32_t)gm[bn];   // loaded beside the state

        // ---- the counter update (zt[17] stays)
        int tc2 = tc + 1;
        int zc2 = zc + (b == 0);
        if (tc2 >= kRescaleCap) {
          tc2 >>= 1;
          if (zc2 > tc2) zc2 >>= 1;
        }
        if (c < 17) {
          znew = (uint32_t)tc2 | (uint32_t)zc2 << 16;
          zt[c] = znew;
        }

        // ---- the bin's open codeword and reorder-window eviction
        int op1 = st.y;
        uint32_t k = st.x & 0xFFFF;
        uint32_t nb = (uint32_t)st.x >> 16;
        if (op1 == 0) {
          if (alloc >= lo + kCircBuf) {
            int amin = kBig;
            for (int q = 0; q < 17; ++q) {
              const int opq = bs[q].y;
              if (opq > 0 && opq - 1 < amin) amin = opq - 1;
            }
            if (amin + kCircBuf <= alloc) {
              // force-complete the oldest open codeword
              // (icer_encoding.c:59-64)
              int ebin = 0;
              for (int q = 1; q < 17; ++q)
                if (bs[q].y == amin + 1) ebin = q;
              const int2 e = bs[ebin];
              const int32_t eo = flush_record(
                  lut, ebin, (uint32_t)e.x & 0xFFFF,
                  ((uint32_t)e.x >> 16) & 31);
              bs[ebin] = make_int2(0, 0);
              if (ec < nev) {
                ev1[(size_t)ec * lanes + lane] = eo;
                ev2[(size_t)ec * lanes + lane] = amin;
              } else {
                flg = 1;
              }
              ++ec;
            }
            lo = amin == kBig ? alloc : amin;
          }
          op1 = alloc + 1;
          ++alloc;
          k = 0;
          nb = 0;
        }

        // ---- codeword progress and completion
        const bool isg = bn >= 8;
        const bool isc = bn >= 1 && bn <= 7;
        const uint32_t kz = k + (cb == 0);
        // custom bins hold nb <= 4 (golomb bins count nb up and read
        // only its low three bits, for the record)
        const uint32_t val = (k | (cb << (nb & 7))) & 31;
        const uint32_t nb2 = nb + 1;
        bool complete = isg ? (cb == 1 || kz >= gmb) : true;
        if (isc) complete = (uint32_t)cinb[bn * 32 + val] == nb2;
        const uint32_t newk = isg ? kz : val;
        bs[bn] = complete ? make_int2(0, 0)
                          : make_int2((int)(newk | nb2 << 16), op1);
        if (complete) {
          out = 1u | ((uint32_t)bn << 1) | (k << 6) | (cb << 16)
                | ((nb & 7) << 17);
          ord[cur] = op1 - 1;
        }
        tile[cur] = out;
        if (nxt < 0) break;
        z = cn == c ? znew : zpre;
        w = wn;
        wn = wnn;
        cur = nxt;
        nxt = nn;
      }
    }
    __syncwarp();

    // the tile's records: empty steps write none
    const size_t row0 = (size_t)t * kTile;
    for (int i = tid; i < kTile; i += 32) {
      const uint32_t r = (valid >> i) & 1 ? tile[i] : 0u;
      rec1[(row0 + i) * lanes + lane] = (int32_t)r;
      rec2[(row0 + i) * lanes + lane] = r ? ord[i] : kBig;
    }
  }
  cp_async_wait<0>();

  if (tid < 17) {
    const int2 st = bs[tid];
    const uint32_t k = (uint32_t)st.x & 0xFFFF;
    const uint32_t nb = (uint32_t)st.x >> 16;
    fstate[(size_t)tid * lanes + lane] =
        (int32_t)(((uint32_t)st.y & 0x1FFFF) | (k << 17) | (nb << 27));
    fop[(size_t)tid * lanes + lane] = st.y;
  }
  if (tid == 0) {
    misc[lane] = flg;
    misc[(size_t)lanes + lane] = alloc;
    misc[(size_t)2 * lanes + lane] = ec;
    for (int r = 3; r < 8; ++r) misc[(size_t)r * lanes + lane] = 0;
  }
}

}  // namespace

extern "C" int slim_encode_launch(const void* words, void* rec, void* fstate,
                                  void* misc, void* ev, const void* luts,
                                  int L, int lanes, int lut_size,
                                  void* runs, void* stream) {
  if (lut_size != kLutSize || L % kTile || L + 17 + kNEV >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || L <= 0) return (int)cudaSuccess;
  slim_encode_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (int32_t*)rec, (int32_t*)fstate, (int32_t*)misc,
      (int32_t*)ev, (const int32_t*)luts, L, lanes,
      (unsigned long long*)runs);
  return (int)cudaGetLastError();
}

extern "C" int slim_encode_two_word_launch(const void* words, void* rec1,
                                           void* rec2, void* fstate,
                                           void* misc, void* ev1, void* ev2,
                                           void* fop, const void* luts,
                                           int L, int lanes, int nev,
                                           int lut_size, void* runs,
                                           void* stream) {
  if (lut_size != kLutSize || L < 0 || L % kTile || nev < 1
      || (long long)L + 17 + nev >= kBig)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || L <= 0) return (int)cudaSuccess;
  slim_encode_wide_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (int32_t*)rec1, (int32_t*)rec2,
      (int32_t*)fstate, (int32_t*)misc, (int32_t*)ev1, (int32_t*)ev2,
      (int32_t*)fop, (const int32_t*)luts, L, lanes, nev,
      (unsigned long long*)runs);
  return (int)cudaGetLastError();
}
