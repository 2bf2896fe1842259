// Kernels 2 and 3 of the ICER port: lane-batched bitplane decoders.
//
// Kernel 2 replaces the TPU kernel make_decode_plane_pallas(nrounds=R) of
// icer_compression_tpu/ops/pallas_decode.py:99 (kernel body :192-1198):
// all R rounds from a zero canvas, with sticky retirement.  Kernel 3
// replaces the same factory's single-plane mode, nrounds=None (the seg_ref
// path, :197 and :273; call :1230): one round from a seeded canvas.  Their
// semantic model is icer_compression_tpu/ops/decode_lanes.py; the plain
// PyTorch versions are decode_planes_plain and decode_plane_seeded_plain
// in ops/plane_decode.py, which documents the I/O contracts.
//
// Bound on this card: the data is small (a 512x512 lossless stream is
// 184 KB, the canvas 1 MB of int32) and so is the arithmetic per pixel, so
// the byte and operation bounds are microseconds.  The real limit is the
// serial chain: every decoded bit updates the counters, the bin stacks and
// the canvas that the next pixel's context reads, so a round of a lane is
// (pixels) dependent steps.  A step's time is the latency of its dependent
// instructions (context, counters' shared load, bin compare, the bin's
// shared load, refill, update; twice for a sign), not its bytes.
//
// Design: one block per segment lane and one warp per plane round.  Lane 0
// of warp k runs round k's chain (bitplane lsb0 - k); the rounds of a lane
// run at once as a wavefront.  Pixel (r, c) of round k reads its own value
// (bits of rounds < k), the current-plane significance and sign of
// (r, c-1), (r-1, c-1..c+1), which its own warp wrote, and the
// previous-plane ones of (r, c+1), (r+1, c-1..c+1).  So round k may take
// row r once round k-1 has finished row min(r+1, h-1); bits that rounds
// behind it write lie below its plane and change nothing it reads.  The
// rows are handed over through per-round progress counters in shared
// memory (volatile stores and loads fenced with __threadfence_block; a
// waiting lane sleeps with __nanosleep).  The critical path is the slowest
// round plus a lag of two rows per round.
//
// Everything the chain touches is in shared memory: the 955-word LUT, each
// round's 17 counters and 17 bin stacks, a window of the round's payload
// (refilled by the warp's 32 threads whenever the next 64 pixels could
// read past it, so a refill's peek is two shared loads and a funnel shift)
// and, where it fits, the lane's canvas, written to `out` once at the end.
// Before the chain walks a chunk of 64 pixels, the warp's 32 threads
// compute each pixel's category and its two candidate contexts and sign
// contexts (left neighbour insignificant or significant, not negative or
// negative; `pixel_info`), so the chain picks a context with one select
// and waits only on its counters and bins.  A canvas too large for shared
// memory (a 256x256 segment is 256 KB of int32) stays in `out` under the
// same wavefront; the launcher picks the placement from the size, and a
// caller may force device memory.
//
// Retirement stays exact.  A missing plane (offs -1) is known before the
// launch: that round and every later one do not run.  A round k that hits
// a stream error stops where the sequential decoder stops and lowers the
// block's `retired` to k, which releases the rounds waiting behind it.  At
// the end every round after the first retired one is discarded: bits below
// that round's plane are cleared, and so is the sign of every pixel whose
// remaining magnitude is 0 (only a discarded round can have set it).  err
// is 1, pos of the retired round is where it stopped, later pos are 0.
//
// Kernel 3 is the same kernel instantiated with kSeeded and R = 1: one
// warp, the lane's seed column loaded into the canvas first.  A lane whose
// offset is -1 keeps its seed and reports err as a missing plane does in
// kernel 2.
//
// Each launch counts its own run: thread 0 of block 0 adds one to
// `run_count` (the kernel's slot of the device's run counters, or null),
// so a launch that a CUDA graph replays is counted too.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder_common.cuh"

namespace {

using icer::bin_of;

constexpr int kCircBuf = 2048;          // CIRC_BUF_SIZE
constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kMaxRounds = 16;          // one warp per round
constexpr int kChunk = 64;              // pixels per window check and per
                                        // context precompute
constexpr int kPixelBytes = 3;          // a pixel reads <= 2 codewords of
                                        // <= 10 bits (golomb l + 1 <= 10)
constexpr int kWinWords = 256;          // payload window per round (1 KB)
constexpr unsigned kFull = 0xffffffffu;

// LUT layout, shared with ops/plane_decode.py
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutGl = 33;
constexpr int kLutGi = 50;
constexpr int kLutChit = 67;
constexpr int kLutCval = 323;
constexpr int kLutCbits = 579;
constexpr int kLutLL = 835;
constexpr int kLutHH = 880;
constexpr int kLutSctx = 905;
constexpr int kLutSpred = 930;
constexpr int kLutSize = 955;

// dynamic shared memory, in 32-bit words
constexpr int kLutPad = 960;            // LUT, padded to 16 bytes
constexpr int kStateWords = 88;         // 5 x 17 round state, padded

// Round k's decoder: its counters and bin stacks in shared memory, its
// payload window in shared memory, its position in registers.
struct Coder {
  int cut[16];           // bin cutoffs, in registers
  int* zero;
  int* total;
  int* bin_n;
  int* bin_low;
  int* bin_index;
  const uint32_t* win;   // payload words from bit wbit on
  int wbit;
  int ebits;             // frozen data_length
  int dw;                // decoded codewords
  int pos;               // bit position in the payload
  bool err;
};

// 32 stream bits from the coder's position, LSB-first.
__device__ __forceinline__ uint32_t peek(const Coder& s) {
  const int rel = s.pos - s.wbit;
  const int wi = rel >> 5;
  return __funnelshift_r(s.win[wi], s.win[wi + 1], rel & 31);
}

// Fill the window with payload bytes [byte0, byte0 + 4 * kWinWords); bytes
// at or past `readable` (the end of the lane's image stream) read as zero.
// Called by all 32 threads of the round's warp.
__device__ __forceinline__ void fill_window(uint32_t* win,
                                            const uint8_t* payload,
                                            int readable, int byte0,
                                            int tid) {
  for (int i = tid; i < kWinWords; i += 32) {
    const int b = byte0 + 4 * i;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b + j < readable) v |= (uint32_t)payload[b + j] << (8 * j);
    win[i] = v;
  }
}

// One context-modelled bit with counts (zc, tc); sets st.err on a stream
// error (and then returns 0 and leaves the state for the caller to stop).
__device__ __forceinline__ int decode_bit(Coder& st, const int* lut, int zc,
                                          int tc) {
  // the stream bits and, once the bin is known, its state and both
  // refill tables' entries are loaded together, so a refill waits on one
  // shared-memory round trip after the bin
  const uint32_t look = peek(st);
  const bool inv = zc < (tc >> 1);
  const int zeff = inv ? tc - zc : zc;
  const int bn = bin_of(st.cut, zeff << 16, tc);
  int n0 = st.bin_n[bn];
  int low0 = st.bin_low[bn];
  const int age = st.dw - st.bin_index[bn];
  const int gm = lut[kLutGm + bn], gl = lut[kLutGl + bn];
  const int gi = lut[kLutGi + bn];
  const int key = (bn & 7) * 32 + (look & 31);
  const int hit = lut[kLutChit + key], cbits = lut[kLutCbits + key];
  const int cval = lut[kLutCval + key];
  if (n0 <= 0 || age >= kCircBuf) {
    int adv;
    if (bn >= 8) {
      if (look & 1) {
        adv = 1;
        n0 = gm;
        low0 = 0;
      } else {
        if (gl > st.ebits) { st.err = true; return 0; }
        const uint32_t rev = __brev(look);     // stream bit i at bit 31-i
        const int kl = rev >> (32 - gl);
        if (kl >= gi) {
          if (gl + 1 > st.ebits) { st.err = true; return 0; }
          adv = gl + 1;
          n0 = (int)(rev >> (31 - gl)) - gi + 1;
        } else {
          adv = gl;
          n0 = kl + 1;
        }
        low0 = 1;
      }
    } else if (bn >= 1) {
      if (hit == 0 || hit >= st.ebits) { st.err = true; return 0; }
      adv = hit;
      n0 = cbits;
      low0 = cval;
    } else {
      if (st.ebits < 1) { st.err = true; return 0; }
      adv = 1;
      n0 = 1;
      low0 = look & 1;
    }
    st.pos += adv;
    st.dw += 1;
    st.bin_index[bn] = st.dw;
  }

  const int n1 = n0 - 1;
  int bit = 0;
  if (n1 < 5) {
    const int sh = n1 > 0 ? n1 : 0;
    bit = (low0 >> sh) & 1;
    low0 &= ~(1 << sh);
  }
  st.bin_n[bn] = n1;
  st.bin_low[bn] = low0;
  return bit ^ (inv ? 1 : 0);
}

__device__ __forceinline__ void update(Coder& st, int ctx, int bit) {
  int tc = st.total[ctx] + 1;
  int zc = st.zero[ctx] + (bit == 0);
  if (tc >= kRescaleCap) {
    tc >>= 1;
    if (zc > tc) zc >>= 1;
  }
  st.total[ctx] = tc;
  st.zero[ctx] = zc;
}

// What the chain needs of pixel (r, c) of round lsb that does not depend
// on its left neighbour, packed into one word: [1:0] category, [6:2] and
// [11:7] the context with (r, c-1) insignificant and significant, [16:12]
// and [17] the sign context and prediction with (r, c-1) not negative,
// [22:18] and [23] with it negative.  Computed by the warp's 32 threads
// for a chunk of pixels before the chain walks it: row r-1 of this round
// and rows r..r+1 of the rounds above are final by then, and (r, c+1) is
// not yet touched by this round.  Neighbours outside the segment read 0.
template <typename Canvas>
__device__ __forceinline__ int pixel_info(Canvas& cv, const int* lut, int r,
                                          int c, int h, int w, int wmax,
                                          int lsb, int mag_bits, bool is_hl,
                                          bool is_hh) {
  const int magmask = (1 << mag_bits) - 1, prev = lsb + 1;
  const int row = r * wmax;
  const int32_t v = cv(row + c);
  const int cat = min(max(31 - __clz((v & magmask) | 1) - lsb, 0), 3);
  if (cat == 3) return 3;
  const bool up = r > 0, down = r + 1 < h, lf = c > 0, rt = c + 1 < w;
  auto sig = [&](int32_t x, int plane) -> int {
    return ((x & magmask) >> plane) != 0;
  };
  auto sgn = [&](int32_t x, int plane) -> int {
    return sig(x, plane) ? -((x >> mag_bits) & 1) : 0;
  };
  const int32_t right = rt ? cv(row + c + 1) : 0;
  const int32_t uc = up ? cv(row - wmax + c) : 0;
  const int32_t dc = down ? cv(row + wmax + c) : 0;
  const int sr = sig(right, prev);
  const int vc = sig(uc, lsb) + sig(dc, prev);
  if (cat == 2) return 2 | 11 << 2 | 11 << 7;
  if (cat == 1) return 1 | (sr + vc == 0 ? 9 : 10) << 2 | 10 << 7;
  const int32_t ul = up && lf ? cv(row - wmax + c - 1) : 0;
  const int32_t ur = up && rt ? cv(row - wmax + c + 1) : 0;
  const int32_t dl = down && lf ? cv(row + wmax + c - 1) : 0;
  const int32_t dr = down && rt ? cv(row + wmax + c + 1) : 0;
  const int dg = sig(ul, lsb) + sig(dl, prev) + sig(ur, lsb) + sig(dr, prev);
  int out = 0;
#pragma unroll
  for (int left = 0; left < 2; ++left) {
    const int hc = left + sr;
    const int hh = is_hl ? vc : hc, vv = is_hl ? hc : vc;
    const int ctx = is_hh ? lut[kLutHH + min(hh + vv, 4) * 5 + dg]
                          : lut[kLutLL + min(hh, 2) * 15 + min(vv, 2) * 5
                                + dg];
    out |= ctx << (2 + 5 * left);
  }
  const int shr = sgn(right, prev);
  const int sv = 2 + sgn(uc, lsb) + sgn(dc, prev);
#pragma unroll
  for (int neg = 0; neg < 2; ++neg) {
    const int sh = 2 - neg + shr;
    const int sh2 = is_hl ? sv : sh, sv2 = is_hl ? sh : sv;
    const int sctx = lut[kLutSctx + sh2 * 5 + sv2];
    const int pred = lut[kLutSpred + sh2 * 5 + sv2] & 1;
    out |= (sctx | pred << 5) << (12 + 6 * neg);
  }
  return out;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}

template <bool kSeeded, bool kSmem>
__global__ void __launch_bounds__(kMaxRounds * 32, 1)
plane_decode_kernel(const uint8_t* __restrict__ stream,
                    const int32_t* __restrict__ offs,
                    const int32_t* __restrict__ ebits,
                    const int32_t* __restrict__ lane_end,
                    const int32_t* __restrict__ geom,
                    const int32_t* __restrict__ luts,
                    const int32_t* __restrict__ seed, int32_t* out,
                    int32_t* __restrict__ err_out,
                    int32_t* __restrict__ pos_out, int R, int n, int hmax,
                    int wmax, int lsb0, int mag_bits,
                    unsigned long long* __restrict__ run_count) {
  extern __shared__ int4 smem4[];
  int* const lut = reinterpret_cast<int*>(smem4);
  int* const state = lut + kLutPad;
  uint32_t* const wins =
      reinterpret_cast<uint32_t*>(state + R * kStateWords);
  int* const infos = reinterpret_cast<int*>(wins + R * kWinWords);
  int32_t* const scv = infos + R * kChunk;
  __shared__ int prog[kMaxRounds];   // rows finished, per round
  __shared__ int posk[kMaxRounds];   // bit position reached, per round
  __shared__ int retired;            // first retired round (R: none)
  __shared__ int runs;               // rounds before the first missing one

  const int lane = blockIdx.x;
  const int tid = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int npx = hmax * wmax;
  int32_t* const gcv = out + lane;   // the lane's column of `out`

  if (run_count != nullptr && lane == 0 && threadIdx.x == 0)
    atomicAdd(run_count, 1ull);

  for (int i = threadIdx.x; i < kLutSize; i += blockDim.x) lut[i] = luts[i];
  if (threadIdx.x < kMaxRounds) {
    prog[threadIdx.x] = 0;
    posk[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    int m = R;
    for (int q = R - 1; q >= 0; --q)
      if (offs[(size_t)q * n + lane] < 0) m = q;
    runs = m;
    retired = m;
  }
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    if constexpr (kSmem)
      scv[p] = kSeeded ? seed[(size_t)p * n + lane] : 0;
    else if constexpr (kSeeded)
      gcv[(size_t)p * n] = seed[(size_t)p * n + lane];
  }
  __syncthreads();

  auto cv = [&](int p) -> int32_t& {
    if constexpr (kSmem)
      return scv[p];
    else
      return gcv[(size_t)p * n];
  };

  // a segment never exceeds the canvas; clamp so that no geometry can
  // write outside it
  const int h = min(geom[lane], hmax), w = min(geom[n + lane], wmax);
  const int sb = geom[2 * n + lane];
  const int magmask = (1 << mag_bits) - 1;

  if (k < runs) {
    int* const sk = state + k * kStateWords;
    if (tid < 17) {
      sk[tid] = 2;          // zero
      sk[17 + tid] = 4;     // total
      sk[34 + tid] = 0;     // bin_n
      sk[51 + tid] = 0;     // bin_low
      sk[68 + tid] = 0;     // bin_index
    }
    uint32_t* const win = wins + k * kWinWords;
    const int off = offs[(size_t)k * n + lane];
    const uint8_t* const payload = stream + off;
    const int readable = lane_end[lane] - off;
    fill_window(win, payload, readable, 0, tid);
    __syncwarp();
    Coder st;
#pragma unroll
    for (int j = 0; j < 16; ++j) st.cut[j] = lut[kLutCut + j];
    st.zero = sk;
    st.total = sk + 17;
    st.bin_n = sk + 34;
    st.bin_low = sk + 51;
    st.bin_index = sk + 68;
    st.win = win;
    st.wbit = 0;
    st.ebits = ebits[(size_t)k * n + lane];
    st.dw = 0;
    st.pos = 0;
    st.err = false;
    const bool is_hl = sb == 1, is_hh = sb == 3;
    const int lsb = lsb0 - k;
    int* const info = infos + k * kChunk;

    bool stop = false;
    for (int r = 0; r < h && !stop; ++r) {
      if (k > 0) {
        // wait for round k-1 to finish row min(r+1, h-1)
        int quit = 0;
        if (tid == 0) {
          const int need = min(r + 2, h);
          while (ld_volatile(&prog[k - 1]) < need) {
            if (ld_volatile(&retired) < k) break;
            __nanosleep(64);
          }
          __threadfence_block();
          quit = ld_volatile(&retired) < k;
        }
        __syncwarp();   // what lane 0 waited for is visible to every lane
        if (__shfl_sync(kFull, quit, 0)) break;
      }
      const int row = r * wmax;
      int ls = 0, lneg = 0;   // (r, c-1) significant, and negative
      for (int c0 = 0; c0 < w && !stop; c0 += kChunk) {
        const int c1 = min(c0 + kChunk, w);
        // keep the next chunk's reads inside the window
        const int pos = __shfl_sync(kFull, st.pos, 0);
        if ((pos >> 3) + kPixelBytes * (c1 - c0) + 8
            > (st.wbit >> 3) + 4 * kWinWords) {
          const int byte0 = (pos >> 3) & ~3;
          fill_window(win, payload, readable, byte0, tid);
          st.wbit = byte0 * 8;
        }
        for (int c = c0 + tid; c < c1; c += 32)
          info[c - c0] = pixel_info(cv, lut, r, c, h, w, wmax, lsb, mag_bits,
                                    is_hl, is_hh);
        __syncwarp();
        if (tid == 0) {
          int32_t cur = cv(row + c0);
          int inf = info[0];
          for (int c = c0; c < c1; ++c) {
            // the next pixel's value and context entry, loaded ahead
            const bool more = c + 1 < c1;
            const int32_t ncur = more ? cv(row + c + 1) : 0;
            const int ninf = more ? info[c + 1 - c0] : 0;
            const int cat = inf & 3;
            int32_t v = cur;
            if (cat == 3) {
              const int bit = decode_bit(st, lut, 1, 2);
              if (st.err) break;
              v |= bit << lsb;
            } else {
              const int ctx = (inf >> (ls ? 7 : 2)) & 31;
              const int bit = decode_bit(st, lut, st.zero[ctx],
                                         st.total[ctx]);
              if (st.err) break;
              v |= bit << lsb;
              update(st, ctx, bit);
              if (cat == 0 && bit) {
                const int sg = inf >> (lneg ? 18 : 12);
                const int sctx = sg & 31, pred = (sg >> 5) & 1;
                const int agree = decode_bit(st, lut, st.zero[sctx],
                                             st.total[sctx]);
                if (st.err) {
                  cv(row + c) = v;
                  break;
                }
                v |= ((agree ^ pred) & 1) << mag_bits;
                update(st, sctx, agree);
              }
            }
            cv(row + c) = v;
            ls = ((v & magmask) >> lsb) != 0;
            lneg = ls & (v >> mag_bits);
            cur = ncur;
            inf = ninf;
          }
          if (st.err) atomicMin(&retired, k);
        }
        __syncwarp();   // the chunk's pixels before the next chunk's reads
        stop = __shfl_sync(kFull, (int)st.err, 0);
      }
      if (!stop && tid == 0) {
        __threadfence_block();
        *(volatile int*)&prog[k] = r + 1;
      }
    }
    if (tid == 0) posk[k] = st.pos;
  }
  __syncthreads();

  // pos and err as the sequential decoder leaves them; discard the rounds
  // after the first retired one
  const int fin = retired, m = runs;
  if (threadIdx.x < R)
    pos_out[(size_t)threadIdx.x * n + lane] =
        threadIdx.x < m && threadIdx.x <= fin ? posk[threadIdx.x] : 0;
  if (threadIdx.x == 0) err_out[lane] = fin < R ? 1 : 0;
  const bool discard = fin + 1 < m;
  const int keep = discard ? magmask & ~((1 << (lsb0 - fin)) - 1) : magmask;
  const int32_t sbit = 1 << mag_bits;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    int32_t v = cv(p);
    if (discard) {
      const int32_t mg = v & keep;
      v = mg ? mg | (v & sbit) : 0;
    }
    if (kSmem || discard) gcv[(size_t)p * n] = v;
  }
}

template <bool kSeeded>
int launch(const void* stream, const void* offs, const void* ebits,
           const void* lane_end, const void* geom, const void* luts,
           const void* seed, void* out, void* err, void* pos, int R, int n,
           int hmax, int wmax, int lsb0, int mag_bits, int force_global,
           int* placement, void* runs, void* cuda_stream) {
  if (R < 1 || R > kMaxRounds || hmax <= 0 || wmax <= 0 || mag_bits < 1
      || mag_bits > 30 || lsb0 < R - 1 || lsb0 >= mag_bits)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t base = 4 * ((size_t)kLutPad + (size_t)R * kStateWords
                           + (size_t)R * (kWinWords + kChunk));
  const size_t with_canvas = base + 4 * (size_t)hmax * wmax;
  // the kernel's own static shared memory: 2 x kMaxRounds + 2 ints
  const size_t fixed = 4 * (2 * kMaxRounds + 2) + 64;
  const bool smem = !force_global && with_canvas + fixed <= (size_t)optin;
  auto kern = smem ? plane_decode_kernel<kSeeded, true>
                   : plane_decode_kernel<kSeeded, false>;
  const size_t bytes = smem ? with_canvas : base;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<n, 32 * R, bytes, (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const int32_t*)offs, (const int32_t*)ebits,
      (const int32_t*)lane_end, (const int32_t*)geom, (const int32_t*)luts,
      (const int32_t*)seed, (int32_t*)out, (int32_t*)err, (int32_t*)pos, R,
      n, hmax, wmax, lsb0, mag_bits, (unsigned long long*)runs);
  *placement = smem ? 1 : 2;
  return (int)cudaGetLastError();
}

}  // namespace

// placement (out): 1 = canvas in shared memory, 2 = in device memory
extern "C" int plane_decode_launch(const void* stream, const void* offs,
                                   const void* ebits, const void* lane_end,
                                   const void* geom, const void* luts,
                                   void* out, void* err, void* pos, int R,
                                   int n, int hmax, int wmax, int lsb0,
                                   int mag_bits, int lut_size,
                                   int force_global, int* placement,
                                   void* runs, void* cuda_stream) {
  if (lut_size != kLutSize) return (int)cudaErrorInvalidValue;
  return launch<false>(stream, offs, ebits, lane_end, geom, luts, nullptr,
                       out, err, pos, R, n, hmax, wmax, lsb0, mag_bits,
                       force_global, placement, runs, cuda_stream);
}

extern "C" int plane_decode_seeded_launch(
    const void* stream, const void* offs, const void* ebits,
    const void* lane_end, const void* geom, const void* seed,
    const void* luts, void* out, void* err, void* pos, int n, int hmax,
    int wmax, int lsb, int mag_bits, int lut_size, int force_global,
    int* placement, void* runs, void* cuda_stream) {
  if (lut_size != kLutSize) return (int)cudaErrorInvalidValue;
  return launch<true>(stream, offs, ebits, lane_end, geom, luts, seed, out,
                      err, pos, 1, n, hmax, wmax, lsb, mag_bits, force_global,
                      placement, runs, cuda_stream);
}
