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
// the canvas that the next pixel's context reads, so a lane costs
// (pixels x planes) dependent steps, and a 512x512 image has only 78
// segment lanes for 132 SMs.
//
// Design: one thread per segment lane runs all R rounds, MSB to LSB.  The
// whole stream sits in global memory and each lane reads its payload in
// place: bits up to the end of the lane's own image stream are real (the
// reference's zero-copy over-read into the following packets), bits past
// it read as zero.  So the TPU kernel's stream windows, and the hazard of a
// window that clipped the over-read, do not arise.  The canvas and the
// neighbour-significance reads go to global memory (L1-cached) in place of
// the TPU kernel's rolling row buffers; lanes of a bucket walk the same
// pixel order, so a warp's canvas accesses stay coalesced in the
// (pixel, lane) layout.  Counters and bin stacks are per-thread arrays;
// the constant tables sit in shared memory.  This version is made to be
// right; making the chain shorter is later work.
//
// Kernel 3 is the same kernel instantiated with kSeeded: each thread first
// copies its lane's column of the seed canvas into the output canvas and
// then runs one round (bitplane lsb) on it.  Its bound is the same serial
// chain, one round of it: (pixels) dependent steps per lane; a lane whose
// offset is -1 keeps its seed and reports err as a missing plane does in
// kernel 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCircBuf = 2048;          // CIRC_BUF_SIZE
constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP

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

struct PlaneState {
  int zero[17];
  int total[17];
  int bin_n[17];
  int bin_low[17];
  int bin_index[17];
  int dw;        // decoded codewords
  int pos;       // bit position in the payload
  bool err;
};

struct Stream {
  const uint8_t* data;   // the lane's payload start
  int readable;          // bytes readable from it (to its image's end)
  int ebits;             // frozen data_length
};

// At least 17 bits from bit position pos, LSB-first, zero past readable.
__device__ __forceinline__ uint32_t peek(const Stream& s, int pos) {
  const int byte = pos >> 3;
  uint32_t win = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (byte + j < s.readable) win |= (uint32_t)s.data[byte + j] << (8 * j);
  return win >> (pos & 7);
}

// One context-modelled bit with counts (zc, tc); sets st.err on a stream
// error (and then returns 0 and leaves the state for the caller to stop).
__device__ int decode_bit(PlaneState& st, const Stream& s, const int* lut,
                          int zc, int tc) {
  const bool inv = zc < (tc >> 1);
  const int zeff = inv ? tc - zc : zc;
  const int comp = zeff << 16;
  int bn = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) bn += comp >= tc * lut[kLutCut + j];

  if (st.bin_n[bn] <= 0 || st.dw - st.bin_index[bn] >= kCircBuf) {
    const uint32_t look = peek(s, st.pos);
    int adv, nbits, low;
    if (bn >= 8) {
      const int gm = lut[kLutGm + bn], gl = lut[kLutGl + bn];
      const int gi = lut[kLutGi + bn];
      const bool first = look & 1;
      if (first) {
        adv = 1;
        nbits = gm;
        low = 0;
      } else {
        if (gl > s.ebits) { st.err = true; return 0; }
        int kl = 0;
        for (int i = 0; i < gl; ++i) kl = (kl << 1) | ((look >> i) & 1);
        if (kl >= gi) {
          if (gl + 1 > s.ebits) { st.err = true; return 0; }
          int klong = 0;
          for (int i = 0; i <= gl; ++i)
            klong = (klong << 1) | ((look >> i) & 1);
          adv = gl + 1;
          nbits = klong - gi + 1;
        } else {
          adv = gl;
          nbits = kl + 1;
        }
        low = 1;
      }
    } else if (bn >= 1) {
      const int key = bn * 32 + (look & 31);
      const int hit = lut[kLutChit + key];
      if (hit == 0 || hit >= s.ebits) { st.err = true; return 0; }
      adv = hit;
      nbits = lut[kLutCbits + key];
      low = lut[kLutCval + key];
    } else {
      if (s.ebits < 1) { st.err = true; return 0; }
      adv = 1;
      nbits = 1;
      low = look & 1;
    }
    st.pos += adv;
    st.bin_n[bn] = nbits;
    st.bin_low[bn] = low;
    st.dw += 1;
    st.bin_index[bn] = st.dw;
  }

  const int n1 = st.bin_n[bn] - 1;
  int bit = 0;
  if (n1 < 5) {
    const int sh = n1 > 0 ? n1 : 0;
    bit = (st.bin_low[bn] >> sh) & 1;
    st.bin_low[bn] &= ~(1 << sh);
  }
  st.bin_n[bn] = n1;
  return bit ^ (inv ? 1 : 0);
}

__device__ __forceinline__ void update(PlaneState& st, int ctx, int bit) {
  int tc = st.total[ctx] + 1;
  int zc = st.zero[ctx] + (bit == 0);
  if (tc >= kRescaleCap) {
    tc >>= 1;
    if (zc > tc) zc >>= 1;
  }
  st.total[ctx] = tc;
  st.zero[ctx] = zc;
}

template <bool kSeeded>
__global__ void plane_decode_kernel(const uint8_t* __restrict__ stream,
                                    const int32_t* __restrict__ offs,
                                    const int32_t* __restrict__ ebits,
                                    const int32_t* __restrict__ lane_end,
                                    const int32_t* __restrict__ geom,
                                    const int32_t* __restrict__ luts,
                                    const int32_t* __restrict__ seed,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ err_out,
                                    int32_t* __restrict__ pos_out,
                                    int R, int n, int hmax, int wmax,
                                    int lsb0, int mag_bits) {
  __shared__ int lut[kLutSize];
  for (int i = threadIdx.x; i < kLutSize; i += blockDim.x) lut[i] = luts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (kSeeded) {
    for (int p = 0; p < hmax * wmax; ++p)
      out[(size_t)p * n + lane] = seed[(size_t)p * n + lane];
  }

  const int h = geom[lane], w = geom[n + lane], sb = geom[2 * n + lane];
  const bool is_hl = sb == 1, is_hh = sb == 3;
  const int magmask = (1 << mag_bits) - 1;
  int32_t* seg = out + lane;
  const size_t rs = (size_t)wmax * n;   // canvas row stride
  auto at = [&](int r, int c) -> int32_t& {
    return seg[(size_t)r * rs + (size_t)c * n];
  };
  auto sig = [&](int r, int c, int plane) -> int {
    return ((at(r, c) & magmask) >> plane) != 0;
  };
  auto sgn = [&](int r, int c, int plane) -> int {
    return sig(r, c, plane) ? -((at(r, c) >> mag_bits) & 1) : 0;
  };

  bool alive = true;
  PlaneState st;
  for (int rnd = 0; rnd < R; ++rnd) {
    const int off = offs[(size_t)rnd * n + lane];
    if (off < 0) alive = false;
    if (!alive) {
      pos_out[(size_t)rnd * n + lane] = 0;
      continue;
    }
    Stream s{stream + off, lane_end[lane] - off,
             ebits[(size_t)rnd * n + lane]};
    for (int q = 0; q < 17; ++q) {
      st.zero[q] = 2;
      st.total[q] = 4;
      st.bin_n[q] = 0;
      st.bin_low[q] = 0;
      st.bin_index[q] = 0;
    }
    st.dw = 0;
    st.pos = 0;
    st.err = false;
    const int lsb = lsb0 - rnd, prev = lsb + 1;

    for (int r = 0; r < h && !st.err; ++r) {
      for (int c = 0; c < w; ++c) {
        const int v = at(r, c);
        const int mag = v & magmask;
        const int msb = mag > 1 ? 31 - __clz(mag) : 0;
        const int cat = min(max(msb - lsb, 0), 3);
        const bool down = r + 1 < h, right = c + 1 < w;
        int bit;
        if (cat == 3) {
          bit = decode_bit(st, s, lut, 1, 2);
          if (st.err) break;
          at(r, c) = v | (bit << lsb);
          continue;
        }
        int ctx;
        if (cat == 2) {
          ctx = 11;
        } else {
          const int hc = (c > 0 ? sig(r, c - 1, lsb) : 0)
                         + (right ? sig(r, c + 1, prev) : 0);
          const int vc = (r > 0 ? sig(r - 1, c, lsb) : 0)
                         + (down ? sig(r + 1, c, prev) : 0);
          if (cat == 1) {
            ctx = hc + vc == 0 ? 9 : 10;
          } else {
            const int dc = (r > 0 && c > 0 ? sig(r - 1, c - 1, lsb) : 0)
                           + (c > 0 && down ? sig(r + 1, c - 1, prev) : 0)
                           + (r > 0 && right ? sig(r - 1, c + 1, lsb) : 0)
                           + (down && right ? sig(r + 1, c + 1, prev) : 0);
            const int hh = is_hl ? vc : hc, vv = is_hl ? hc : vc;
            ctx = is_hh ? lut[kLutHH + min(hh + vv, 4) * 5 + dc]
                        : lut[kLutLL + min(hh, 2) * 15 + min(vv, 2) * 5 + dc];
          }
        }
        bit = decode_bit(st, s, lut, st.zero[ctx], st.total[ctx]);
        if (st.err) break;
        at(r, c) = v | (bit << lsb);
        update(st, ctx, bit);
        if (cat == 0 && bit) {
          const int sh = 2 + (c > 0 ? sgn(r, c - 1, lsb) : 0)
                         + (right ? sgn(r, c + 1, prev) : 0);
          const int sv = 2 + (r > 0 ? sgn(r - 1, c, lsb) : 0)
                         + (down ? sgn(r + 1, c, prev) : 0);
          const int sh2 = is_hl ? sv : sh, sv2 = is_hl ? sh : sv;
          const int sctx = lut[kLutSctx + sh2 * 5 + sv2];
          const int pred = lut[kLutSpred + sh2 * 5 + sv2];
          const int agree = decode_bit(st, s, lut, st.zero[sctx],
                                       st.total[sctx]);
          if (st.err) break;
          at(r, c) |= ((agree ^ pred) & 1) << mag_bits;
          update(st, sctx, agree);
        }
      }
    }
    pos_out[(size_t)rnd * n + lane] = st.pos;
    if (st.err) alive = false;
  }
  err_out[lane] = alive ? 0 : 1;
}

}  // namespace

extern "C" int plane_decode_launch(const void* stream, const void* offs,
                                   const void* ebits, const void* lane_end,
                                   const void* geom, const void* luts,
                                   void* out, void* err, void* pos, int R,
                                   int n, int hmax, int wmax, int lsb0,
                                   int mag_bits, int lut_size,
                                   void* cuda_stream) {
  if (lut_size != kLutSize || hmax <= 0 || wmax <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  plane_decode_kernel<false><<<blocks, threads, 0,
                               (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const int32_t*)offs, (const int32_t*)ebits,
      (const int32_t*)lane_end, (const int32_t*)geom, (const int32_t*)luts,
      nullptr, (int32_t*)out, (int32_t*)err, (int32_t*)pos, R, n, hmax,
      wmax, lsb0, mag_bits);
  return (int)cudaGetLastError();
}

extern "C" int plane_decode_seeded_launch(
    const void* stream, const void* offs, const void* ebits,
    const void* lane_end, const void* geom, const void* seed,
    const void* luts, void* out, void* err, void* pos, int n, int hmax,
    int wmax, int lsb, int mag_bits, int lut_size, void* cuda_stream) {
  if (lut_size != kLutSize || hmax <= 0 || wmax <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  plane_decode_kernel<true><<<blocks, threads, 0,
                              (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const int32_t*)offs, (const int32_t*)ebits,
      (const int32_t*)lane_end, (const int32_t*)geom, (const int32_t*)luts,
      (const int32_t*)seed, (int32_t*)out, (int32_t*)err, (int32_t*)pos, 1,
      n, hmax, wmax, lsb, mag_bits);
  return (int)cudaGetLastError();
}
