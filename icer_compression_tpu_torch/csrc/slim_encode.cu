// Kernel 1 of the ICER port: the slim interleaved entropy coder.
//
// Replaces the TPU kernel make_encode_lanes_slim of
// icer_compression_tpu/ops/pallas_entropy.py:744 (step _slim_step :513) in
// both its record modes, as two instances of one template:
// slim_encode_kernel<false> writes one fused-key record per step
// (pallas_entropy.py:496-510) and serves lanes whose allocation ordinals
// stay below 2^15; slim_encode_kernel<true> writes the two-word records
// (pallas_entropy.py:732-741) for lanes up to 2^17 steps, and builds each
// codeword that the reorder window evicts (_evict_flush_code :444).  Same
// I/O contract as the TPU kernel; the plain PyTorch version is
// encode_lanes_slim_plain in ops/entropy_slim.py.
//
// Bound on this card: the data moved is small (one int32 word in and one
// record out per emission step: about 19 MB each way for a 512x512 image,
// about 11 us at 3.35 TB/s) and so is the arithmetic (tens of integer ops
// per valid step).  The real limit is the serial dependency chain: every
// step reads the counters and bin state the previous step wrote, so a lane
// of L steps costs L dependent step latencies, and a 512x512 image has
// only a few hundred lanes (702) for 132 SMs.
//
// What a step costs is the latency of its dependent instructions: the
// counters' shared load, the 16-cutoff bin compare, the bin state's
// shared load and the branches of the codeword update.
//
// Design: one lane per block of one warp, so the 162 lanes of a stage-1
// launch spread over the SMs and no lane pays another's branches (lanes
// that share a warp take each other's paths: valid or empty step, custom,
// golomb or uncoded bin, allocation; on the card that costs more than the
// 31 threads left idle, PERF.md).  Thread 0 runs the chain.  No step
// waits on device memory: the block's 32 threads stream the lane's words
// through a ring of kStages tiles of kTile steps in shared memory with
// cp.async, kStages - 1 tiles ahead of the chain; the chain reads each
// word a step ahead and writes the step's record over it (the two-word
// instance writes its second word, the ordinal, to a ring of its own), and
// the block then stores the tile's records to `rec` (and `rec2`).  An empty
// step (padding, an absent sign slot) costs a shared load and store.  The
// 17 counters and 17 bin states sit in shared memory, the 16 bin cutoffs in
// registers.
// The reorder-window check scans the 17 bin states only when the
// allocation count has passed a lower bound of the oldest open ordinal by
// CIRC_BUF_SIZE: open ordinals only grow, so the bound from the last scan
// stays valid and most allocations skip the scan.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder_common.cuh"

namespace {

using icer::bin_of;
using icer::cp_async4;
using icer::cp_async_commit;
using icer::cp_async_wait;

constexpr int kNEV = 32;
constexpr int kCircBuf = 2048;          // CIRC_BUF_SIZE
constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kBig = 1 << 30;
constexpr int32_t kBigPk = 0x7FFF << 16;
constexpr int kMaxL = 1 << 17;          // ordinals are 17-bit fields of bs
constexpr int kTile = 64;               // steps per tile (divides 256)
constexpr int kStages = 3;              // tiles in the ring

// LUT layout, shared with ops/entropy_slim.py
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutCinb = 33;
constexpr int kLutFlv = 289;
constexpr int kLutFused = 2337;         // the tables the fused instance reads
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

// kTwoWord: the two-word records (rec, rec2, ev_out, ev2_out), else the
// fused-key ones (rec, ev_out; rec2 and ev2_out unused).
template <bool kTwoWord>
__global__ void __launch_bounds__(32)
slim_encode_kernel(const int32_t* __restrict__ words,
                   int32_t* __restrict__ rec, int32_t* __restrict__ rec2,
                   int32_t* __restrict__ fstate, int32_t* __restrict__ misc,
                   int32_t* __restrict__ ev_out,
                   int32_t* __restrict__ ev2_out,
                   const int32_t* __restrict__ luts, int L, int lanes) {
  constexpr int kLutUsed = kTwoWord ? kLutSize : kLutFused;
  __shared__ int32_t lut[kLutUsed];
  __shared__ int32_t ring[kStages][kTile];
  __shared__ int32_t ring2[kTwoWord ? kStages : 1][kTile];
  __shared__ uint32_t zt[17];   // total | zero << 16
  __shared__ uint32_t bs[17];   // (open_alloc + 1) | k << 17 | nb << 27
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  for (int i = tid; i < kLutUsed; i += 32) lut[i] = luts[i];
  if (tid < 17) {
    zt[tid] = 4u | (2u << 16);
    bs[tid] = 0u;
  }
  for (int e = tid; e < kNEV; e += 32) {
    ev_out[(size_t)e * lanes + lane] = kTwoWord ? 0 : kBigPk;
    if constexpr (kTwoWord) ev2_out[(size_t)e * lanes + lane] = kBig;
  }

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
    int32_t* const tile2 = ring2[kTwoWord ? t % kStages : 0];
    if (tid == 0) {
      uint32_t wn = (uint32_t)tile[0];
      for (int i = 0; i < kTile; ++i) {
        // the next step's word is loaded a step ahead
        const uint32_t w = wn;
        if (i + 1 < kTile) wn = (uint32_t)tile[i + 1];
        int32_t out = kTwoWord ? 0 : kBigPk;
        int32_t out2 = kBig;
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
                int32_t eo;
                if constexpr (kTwoWord) {
                  eo = flush_record(lut, ebin, ek, enb);
                } else {
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
                  eo = (int32_t)(((uint32_t)amin << 16) | pl);
                }
                bs[ebin] = 0u;
                if (ec < kNEV) {
                  ev_out[(size_t)ec * lanes + lane] = eo;
                  if constexpr (kTwoWord)
                    ev2_out[(size_t)ec * lanes + lane] = amin;
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
          if (kTwoWord && complete) {
            out = (int32_t)(1u | ((uint32_t)bn << 1) | (k << 6) | (cb << 16)
                            | ((nb & 7) << 17));
            out2 = op1 - 1;
          } else if (complete) {
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
        if constexpr (kTwoWord) tile2[i] = out2;
      }
    }
    __syncthreads();
    // the tile's records
    const size_t row0 = (size_t)t * kTile;
    for (int i = tid; i < kTile; i += 32) {
      rec[(row0 + i) * lanes + lane] = tile[i];
      if constexpr (kTwoWord) rec2[(row0 + i) * lanes + lane] = tile2[i];
    }
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

}  // namespace

extern "C" int slim_encode_launch(const void* words, void* rec, void* fstate,
                                  void* misc, void* ev, const void* luts,
                                  int L, int lanes, int lut_size,
                                  void* stream) {
  if (lut_size != kLutSize || L % kTile || L + 17 + kNEV >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || L <= 0) return (int)cudaSuccess;
  slim_encode_kernel<false><<<lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (int32_t*)rec, nullptr, (int32_t*)fstate,
      (int32_t*)misc, (int32_t*)ev, nullptr, (const int32_t*)luts, L, lanes);
  return (int)cudaGetLastError();
}

extern "C" int slim_encode_two_word_launch(const void* words, void* rec1,
                                           void* rec2, void* fstate,
                                           void* misc, void* ev1, void* ev2,
                                           const void* luts, int L,
                                           int lanes, int lut_size,
                                           void* stream) {
  if (lut_size != kLutSize || L % kTile || L >= kMaxL)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || L <= 0) return (int)cudaSuccess;
  slim_encode_kernel<true><<<lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (int32_t*)rec1, (int32_t*)rec2,
      (int32_t*)fstate, (int32_t*)misc, (int32_t*)ev1, (int32_t*)ev2,
      (const int32_t*)luts, L, lanes);
  return (int)cudaGetLastError();
}
