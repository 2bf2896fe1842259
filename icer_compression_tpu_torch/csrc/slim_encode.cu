// Kernel 1 of the ICER port: the slim interleaved entropy coder.
//
// Replaces the TPU kernel make_encode_lanes_slim (fused-key mode) of
// icer_compression_tpu/ops/pallas_entropy.py:744 (step _slim_step :513).
// Same I/O contract and record layout (pallas_entropy.py:496-510); the
// plain PyTorch version is encode_lanes_slim_plain in ops/entropy_slim.py.
//
// Bound on this card: the data moved is small (one int32 word in and one
// record out per emission step: about 19 MB each way for a 512x512 image,
// about 11 us at 3.35 TB/s) and so is the arithmetic (tens of integer ops
// per valid step).  The real limit is the serial dependency chain: every
// step reads the counters and bin state the previous step wrote, so a lane
// of L steps costs L dependent step latencies, and a 512x512 image has
// only a few hundred lanes (702) for 132 SMs.
//
// Design: one thread per lane.  The TPU grid over L-chunks becomes a loop
// over all L steps inside the thread.  The 17 context counters and the 17
// bin states live in per-thread arrays indexed directly (no select trees:
// dynamic per-lane indexing is native here); the constant tables sit in
// shared memory.  Invalid steps (padding, absent sign slots) are no-ops and
// cost one load and one store.  The (L, lanes) layout keeps the word loads
// and record stores of a warp's threads coalesced.  This version is made
// to be right; making the chain shorter is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNEV = 32;
constexpr int kCircBuf = 2048;          // CIRC_BUF_SIZE
constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kBig = 1 << 30;
constexpr int32_t kBigPk = 0x7FFF << 16;

// LUT layout, shared with ops/entropy_slim.py
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutCinb = 33;
constexpr int kLutFlv = 289;
constexpr int kLutSize = 2337;

__global__ void slim_encode_kernel(const int32_t* __restrict__ words,
                                   int32_t* __restrict__ rec,
                                   int32_t* __restrict__ fstate,
                                   int32_t* __restrict__ misc,
                                   int32_t* __restrict__ ev_out,
                                   const int32_t* __restrict__ luts,
                                   int L, int lanes) {
  __shared__ int32_t lut[kLutSize];
  for (int i = threadIdx.x; i < kLutSize; i += blockDim.x) lut[i] = luts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int32_t* cut = lut + kLutCut;
  const int32_t* gm = lut + kLutGm;
  const int32_t* cinb = lut + kLutCinb;
  const int32_t* flv = lut + kLutFlv;

  uint32_t zt[17];   // total | zero << 16
  uint32_t bs[17];   // (open_alloc + 1) | k << 17 | nb << 27; 0 = closed
  for (int q = 0; q < 17; ++q) {
    zt[q] = 4u | (2u << 16);
    bs[q] = 0u;
  }
  for (int j = 0; j < kNEV; ++j) ev_out[(size_t)j * lanes + lane] = kBigPk;
  int alloc = 0, flg = 0, ec = 0;

  for (int i = 0; i < L; ++i) {
    const uint32_t w = (uint32_t)words[(size_t)i * lanes + lane];
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
      const int comp = zeff << 16;
      int bn = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) bn += comp >= tcu * cut[j];
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
      int op1 = bsb & 0x1FFFF;
      uint32_t k = (bsb >> 17) & 1023;
      uint32_t nb = bsb >> 27;
      const bool newly = op1 == 0;
      if (newly) {
        int amin = kBig;
        for (int q = 0; q < 17; ++q) {
          const int opq = bs[q] & 0x1FFFF;
          if (opq > 0 && opq - 1 < amin) amin = opq - 1;
        }
        if (amin + kCircBuf <= alloc) {
          // force-complete the oldest open codeword (icer_encoding.c:59-64)
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
            const uint32_t fv =
                (uint32_t)flv[(ebin * 8 + (enb & 7)) * 32 + (ek & 31)];
            const uint32_t fin = (ek | (fv << enb)) & 31;
            pl = ((uint32_t)ebin << 11) | (fin << 6);
          }
          bs[ebin] = 0u;
          if (ec < kNEV)
            ev_out[(size_t)ec * lanes + lane] =
                (int32_t)(((uint32_t)amin << 16) | pl);
          else
            flg = 1;
          ++ec;
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
        complete = cb == 1 || kz >= (uint32_t)gm[bn];
      else if (isc)
        complete = (uint32_t)cinb[bn * 32 + val] == nb2;
      else
        complete = true;
      const uint32_t newk = isg ? kz : val;
      bs[bn] = complete ? 0u : ((uint32_t)op1 | (newk << 17) | (nb2 << 27));
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
    rec[(size_t)i * lanes + lane] = out;
  }

  for (int q = 0; q < 17; ++q) fstate[(size_t)q * lanes + lane] = (int32_t)bs[q];
  misc[lane] = flg;
  misc[(size_t)lanes + lane] = alloc;
  misc[(size_t)2 * lanes + lane] = ec;
  for (int r = 3; r < 8; ++r) misc[(size_t)r * lanes + lane] = 0;
}

}  // namespace

extern "C" int slim_encode_launch(const void* words, void* rec, void* fstate,
                                  void* misc, void* ev, const void* luts,
                                  int L, int lanes, int lut_size,
                                  void* stream) {
  if (lut_size != kLutSize) return (int)cudaErrorInvalidValue;
  if (lanes <= 0 || L <= 0) return (int)cudaSuccess;
  const int threads = 64;
  const int blocks = (lanes + threads - 1) / threads;
  slim_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (int32_t*)rec, (int32_t*)fstate,
      (int32_t*)misc, (int32_t*)ev, (const int32_t*)luts, L, lanes);
  return (int)cudaGetLastError();
}
