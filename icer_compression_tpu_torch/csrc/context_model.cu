// Context model of the ICER port's encoder: a pass's sign-magnitude
// coefficients straight to each coded bucket's coder words.
//
// Replaces plane_emissions_words of icer_compression_tpu/ops/context_model.py
// (the closed-form context tables over shifted significance maps, which the
// JAX package leaves to XLA), the gather of every segment rectangle into a
// padded lane batch in ops/encode_jax.py (_make_emit_fn) and the interleave
// of the two emission slots.  The plain PyTorch version is Encoder.emit over
// ops/context_model.py's plane_emissions_words, then Encoder.bucket_words;
// word for word, this gives its (rows, Lk) words, the words of invalid
// pixels and the zero tail of each row included.
//
// One thread per (image, lane, pixel of the lane's mh x mw canvas) of a
// stage group, the pixel index fastest, so that a warp reads a run of one
// image row and writes 256 contiguous bytes of one coder row.  The thread
// loads its pixel and its 8 neighbours once (a neighbour outside the lane's
// h x w rectangle, and every pixel of a dummy lane, is 0: the segment border
// is insignificant) and then loops over the group's plane window lo .. hi,
// in registers: W, N, NW and NE are tested at lsb, E, S, SW and SE at
// lsb + 1; HL swaps the horizontal and vertical counts, HH has its own
// table; category 3 goes to context 17.  For each plane it stores one int2
// [w0, w1] at column 2 * pixel of row (image, plane, lane) of the group's
// part of the bucket: w0 = valid | ctx << 1 | bit << 6, w1 = sign_event |
// sign_ctx << 1 | agreement << 6 (an invalid pixel reads 0, so it has no
// sign event).  Threads past the canvas, up to Lk / 2, write the row's zero
// tail.
//
// Bound on this card: the bytes the function has to move.  The words are
// written once (8 bytes a pixel and plane, 9 planes for 16-bit data: 72
// bytes a pixel, 75.5 MB per MP, 0.0225 ms per MP at 3.35 TB/s) and the
// coefficients read once (4 bytes a pixel; neighbours come from cache); the
// arithmetic is some tens of integer operations a pixel and plane.

#include <cstdint>
#include <cuda_runtime.h>

// kernel<<<grid, block, 0, stream>>>(...); a host build of this file for the
// tests defines its own LAUNCH first.
#ifndef LAUNCH
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSubbandHL = 1;         // core/constants.py SUBBAND_HL
constexpr int kSubbandHH = 3;         // SUBBAND_HH
constexpr int kCtxUncoded = 17;
constexpr int kLaneFields = 5;        // row, col, h, w, subband

// CONTEXT_TABLE_LL_LH_HL[h][v][d] in closed form (_ctx_ll).
__device__ __forceinline__ int ctx_ll(int h, int v, int d) {
  const int d2 = d < 2 ? d : 2;
  if (h == 2) return 8;
  if (h == 1) return v == 0 ? 5 + d2 : 7;
  return v == 0 ? d2 : 2 + v;
}

// CONTEXT_TABLE_HH[s][d] with s = h + v (_ctx_hh).
__device__ __forceinline__ int ctx_hh(int s, int d) {
  const int t = s < 2 ? s : 2;
  if (d == 0) return t;
  if (d == 1) return 3 + t;
  if (d == 2) return 6 + (t < 1 ? t : 1);
  return 8;
}

// One thread per (image, lane, pixel); blocks run over the pixels of a
// (image, lane) fastest.  `out` is the group's first row of the bucket, rows
// of `half` int2s; row (b * planes + k) * lanes + lane holds plane lo + k.
__global__ void __launch_bounds__(kThreads) context_words_kernel(
    const int32_t* __restrict__ img, int H, int W,
    const int32_t* __restrict__ lanes, int nlanes, int mh, int mw, int lo,
    int planes, int mag_bits, int half, int pblocks, int2* __restrict__ out,
    unsigned long long* __restrict__ runs) {
  const long long blk = blockIdx.x;
  if (runs != nullptr && blk == 0 && threadIdx.x == 0) atomicAdd(runs, 1ull);
  const long long bn = blk / pblocks;
  const int p = (int)(blk - bn * pblocks) * kThreads + (int)threadIdx.x;
  if (p >= half) return;
  const int lane = (int)(bn % nlanes);
  const long long b = bn / nlanes;
  const long long step = (long long)nlanes * half;   // next plane's row
  int2* dst = out + (b * planes * nlanes + lane) * half + p;
  if (p >= mh * mw) {
    for (int k = 0; k < planes; ++k) dst[k * step] = make_int2(0, 0);
    return;
  }
  const int r = p / mw, c = p - r * mw;
  const int32_t* lt = lanes + lane * kLaneFields;
  const int lh = __ldg(lt + 2), lw = __ldg(lt + 3), sb = __ldg(lt + 4);
  const int32_t* base = img + (b * H + __ldg(lt)) * W + __ldg(lt + 1);
  auto at = [&](int dr, int dc) -> int {
    const int rr = r + dr, cc = c + dc;
    return (unsigned)rr < (unsigned)lh && (unsigned)cc < (unsigned)lw
               ? __ldg(base + (long long)rr * W + cc) : 0;
  };
  const int v = at(0, 0), v_w = at(0, -1), v_e = at(0, 1),
            v_n = at(-1, 0), v_s = at(1, 0);
  const int mask = (1 << mag_bits) - 1;
  const int m = v & mask, m_w = v_w & mask, m_e = v_e & mask,
            m_n = v_n & mask, m_s = v_s & mask;
  const int m_nw = at(-1, -1) & mask, m_ne = at(-1, 1) & mask,
            m_sw = at(1, -1) & mask, m_se = at(1, 1) & mask;
  const int neg = (v >> mag_bits) & 1, n_w = (v_w >> mag_bits) & 1,
            n_e = (v_e >> mag_bits) & 1, n_n = (v_n >> mag_bits) & 1,
            n_s = (v_s >> mag_bits) & 1;
  const int valid = (unsigned)r < (unsigned)lh && (unsigned)c < (unsigned)lw;
  const int msb = 31 - __clz(m | 1);
  const bool hl = sb == kSubbandHL, hh = sb == kSubbandHH;
  for (int k = 0; k < planes; ++k) {
    const int lsb = lo + k;
    // significance: W, N, NW, NE at this plane; E, S, SW, SE at the last
    const int s_w = (m_w >> lsb) != 0, s_n = (m_n >> lsb) != 0;
    const int s_e = (m_e >> (lsb + 1)) != 0, s_s = (m_s >> (lsb + 1)) != 0;
    const int hr = s_w + s_e, vr = s_n + s_s;
    const int d = ((m_nw >> lsb) != 0) + ((m_ne >> lsb) != 0)
                  + ((m_sw >> (lsb + 1)) != 0) + ((m_se >> (lsb + 1)) != 0);
    const int hc = hl ? vr : hr, vc = hl ? hr : vr;
    const int cat = min(max(msb - lsb, 0), 3);
    const int ctx = cat == 0 ? (hh ? ctx_hh(hc + vc, d) : ctx_ll(hc, vc, d))
                    : cat == 1 ? (hc + vc == 0 ? 9 : 10)
                    : cat == 2 ? 11 : kCtxUncoded;
    const int bit = (m >> lsb) & 1;
    // sign counts: 2 less one for each negative significant neighbour
    const int shr = 2 - (n_w & s_w) - (n_e & s_e);
    const int svr = 2 - (n_n & s_n) - (n_s & s_s);
    const int a = (hl ? svr : shr) - 2, bb = (hl ? shr : svr) - 2;
    const int cb = min(max(bb, -1), 1);
    const int sctx = a == 0 ? 12 + (bb != 0) : 15 - (a > 0 ? cb : -cb);
    const int pred = a < 0 ? 1 : a > 0 ? 0 : (bb > 0);
    const int sign_event = cat == 0 && bit == 1;
    dst[k * step] = make_int2(valid | ctx << 1 | bit << 6,
                              sign_event | sctx << 1
                                  | ((pred ^ neg) & 1) << 6);
  }
}

}  // namespace

// One stage group's words: img (B, H, W) int32 sign-magnitude coefficients,
// lanes (nlanes, 5) int32 (row, col, h, w, subband; a dummy lane has h = w =
// 0), the planes lo .. hi - 1; out the group's B * (hi - lo) * nlanes rows
// of Lk int32 words, 8-byte aligned.  Adds one to *runs as it starts.
extern "C" int context_words_launch(const void* img, int B, int H, int W,
                                    const void* lanes, int nlanes, int mh,
                                    int mw, int lo, int hi, int mag_bits,
                                    long long Lk, void* out, void* runs,
                                    void* stream) {
  const long long half = Lk / 2;
  if (img == nullptr || lanes == nullptr || out == nullptr || B < 1
      || nlanes < 1 || mh < 1 || mw < 1 || lo < 0 || hi <= lo
      || mag_bits < 1 || mag_bits > 15 || hi > 30 || Lk % 2
      || half < (long long)mh * mw || half > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pblocks = (half + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * nlanes * pblocks;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  LAUNCH(context_words_kernel, dim3((unsigned)blocks), kThreads,
         static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(img),
         H, W, static_cast<const int32_t*>(lanes), nlanes, mh, mw, lo,
         hi - lo, mag_bits, (int)half, (int)pblocks, static_cast<int2*>(out),
         static_cast<unsigned long long*>(runs));
  return static_cast<int>(cudaGetLastError());
}
