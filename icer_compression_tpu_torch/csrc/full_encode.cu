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
// previous step wrote, so a lane of L steps costs L dependent step
// latencies, and a block has only a few hundred lanes for 132 SMs.  Unlike
// kernel 1 this coder also builds each codeword (golomb remainder bit
// reversal, custom output tables) inside the chain.
//
// Design: one thread per lane, the TPU grid over L-chunks becoming a loop
// over all L steps inside the thread.  The 17 context counters and the 17
// bin states (run count or input prefix, prefix length, opening emission)
// are per-thread arrays indexed directly by context and bin: the TPU
// kernel's 17-way select trees and packed-word table scans exist only
// because Mosaic has no per-lane dynamic indexing.  The constant tables
// (cutoffs, golomb m/l/i, custom input lengths, output codes and the custom
// flush table that kernel 1 also reads) sit in shared memory.  The 17
// flush rows are written by the kernel after the last step.  There is no
// reorder-window eviction here, as on the TPU: the tail detects lanes that
// need one and the caller re-encodes them on the host.
//
// Kernel 5: on the TPU the tiling amortises dynamic-row VMEM access.  Here
// the analogue is the same loop unrolled by 8: the tile's 24 input words
// are loaded into registers before its 8 dependent steps.  The loads do not
// depend on the chain, so issuing them first keeps all 24 in flight
// together and the chain waits for memory once per tile instead of once per
// step; the tile's 24 output words are stored after the steps.  A last
// tile shorter than 8 rows is masked.  This version is made to be right;
// making the chain shorter is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRescaleCap = 500;        // CONTEXT_RESCALING_CAP
constexpr int kBig = 1 << 30;
constexpr int kTile = 8;

// LUT layout, shared with ops/entropy_full.py (its first 2337 entries are
// kernel 1's LUT from ops/entropy_slim.py)
constexpr int kLutCut = 0;
constexpr int kLutGm = 16;
constexpr int kLutCinb = 33;
constexpr int kLutFlv = 289;
constexpr int kLutGl = 2337;
constexpr int kLutGi = 2354;
constexpr int kLutCout = 2371;
constexpr int kLutCobits = 2627;
constexpr int kLutSize = 2883;

struct CoderState {
  int zero[17];
  int total[17];
  int bk[17];    // golomb run length / custom input prefix
  int bnb[17];   // custom prefix length
  int bop[17];   // opening emission, -1 = closed
};

__device__ __forceinline__ int bitrev16(int v, int nbits) {
  return (int)(__brev((unsigned)(v & 0xFFFF)) >> 16) >> (16 - nbits);
}

// One emission step; writes the completed codeword (or none) to the
// (code, nbits, open) triple.
__device__ __forceinline__ void coder_step(CoderState& s, const int* lut,
                                           int v, int c, int b, int emi,
                                           int& out_code, int& out_nbits,
                                           int& out_open) {
  out_code = 0;
  out_nbits = 0;
  out_open = kBig;
  if (!v) return;

  // ---- counters & bin (the uncoded context codes with (1, 2))
  const bool unc = c >= 17;
  const int zc = unc ? 0 : s.zero[c];
  const int tc = unc ? 0 : s.total[c];
  const int zcu = unc ? 1 : zc;
  const int tcu = unc ? 2 : tc;
  const bool inv = zcu < (tcu >> 1);
  const int zeff = inv ? tcu - zcu : zcu;
  const int cb = b ^ (inv ? 1 : 0);
  const int comp = zeff << 16;
  int bn = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) bn += comp >= tcu * lut[kLutCut + q];
  if (!unc) {
    int tc2 = tc + 1;
    int zc2 = zc + (b == 0);
    if (tc2 >= kRescaleCap) {
      tc2 >>= 1;
      if (zc2 > tc2) zc2 >>= 1;
    }
    s.zero[c] = zc2;
    s.total[c] = tc2;
  }

  // ---- the bin's open codeword
  int k = s.bk[bn], nb = s.bnb[bn], op = s.bop[bn];
  if (op < 0) {
    op = emi;
    k = 0;
    nb = 0;
  }
  bool complete;
  int code, nbits, newk;
  if (bn >= 8) {
    // golomb: a one ends the run (the codeword of the k zeros before it),
    // m zeros are a full run (the 1-bit codeword '1')
    const int m = lut[kLutGm + bn], l = lut[kLutGl + bn];
    const int i = lut[kLutGi + bn];
    const int kz = k + (cb == 0);
    const bool run_done = cb == 0 && kz >= m;
    const int adj = k < i ? k : k + i;
    const int glen = l + (k >= i);
    complete = cb == 1 || run_done;
    code = run_done ? 1 : bitrev16(adj, glen);
    nbits = run_done ? 1 : glen;
    newk = kz;
  } else if (bn >= 1) {
    // custom: the input prefix grows by one bit (nb <= 4 in these bins)
    const int val = (k | (cb << nb)) & 31;
    const int key = bn * 32 + val;
    complete = lut[kLutCinb + key] == nb + 1;
    code = lut[kLutCout + key];
    nbits = lut[kLutCobits + key];
    newk = val;
  } else {
    complete = true;
    code = cb;
    nbits = 1;
    newk = 0;
  }
  if (complete) {
    s.bk[bn] = 0;
    s.bnb[bn] = 0;
    s.bop[bn] = -1;
    out_code = code;
    out_nbits = nbits;
    out_open = op;
  } else {
    s.bk[bn] = newk;
    s.bnb[bn] = nb + 1;
    s.bop[bn] = op;
  }
}

__device__ __forceinline__ void init_state(CoderState& s) {
  for (int q = 0; q < 17; ++q) {
    s.zero[q] = 2;
    s.total[q] = 4;
    s.bk[q] = 0;
    s.bnb[q] = 0;
    s.bop[q] = -1;
  }
}

// The 17 end-of-plane flush rows (rows L .. L + 16).
__device__ void flush_rows(const CoderState& s, const int* lut, int L,
                           int lanes, int lane, int32_t* code,
                           int32_t* nbits, int32_t* opn) {
  for (int b = 0; b < 17; ++b) {
    int fc = 0, fn = 0, fo = kBig;
    if (b >= 1 && s.bop[b] >= 0) {
      const int k = s.bk[b], nb = s.bnb[b];
      if (b >= 8) {
        const int m = lut[kLutGm + b], l = lut[kLutGl + b];
        const int i = lut[kLutGi + b];
        const int adj = k < i ? k : k + i;
        const int glen = l + (k >= i);
        fc = k == m - 1 ? 1 : bitrev16(adj, glen);
        fn = k == m - 1 ? 1 : glen;
      } else {
        const int fv = lut[kLutFlv + (b * 8 + (nb & 7)) * 32 + (k & 31)];
        const int fin = (k | (fv << nb)) & 31;
        fc = lut[kLutCout + b * 32 + fin];
        fn = lut[kLutCobits + b * 32 + fin];
      }
      fo = s.bop[b];
    }
    const size_t r = (size_t)(L + b) * lanes + lane;
    code[r] = fc;
    nbits[r] = fn;
    opn[r] = fo;
  }
}

__device__ __forceinline__ void load_lut(int* lut, const int32_t* luts) {
  for (int i = threadIdx.x; i < kLutSize; i += blockDim.x) lut[i] = luts[i];
  __syncthreads();
}

__global__ void full_encode_kernel(const int32_t* __restrict__ valid,
                                   const int32_t* __restrict__ ctx,
                                   const int32_t* __restrict__ bit,
                                   int32_t* __restrict__ code,
                                   int32_t* __restrict__ nbits,
                                   int32_t* __restrict__ opn,
                                   const int32_t* __restrict__ luts, int L,
                                   int lanes) {
  __shared__ int lut[kLutSize];
  load_lut(lut, luts);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  CoderState s;
  init_state(s);
  for (int i = 0; i < L; ++i) {
    const size_t r = (size_t)i * lanes + lane;
    int oc, on, oo;
    coder_step(s, lut, valid[r], ctx[r], bit[r], i, oc, on, oo);
    code[r] = oc;
    nbits[r] = on;
    opn[r] = oo;
  }
  flush_rows(s, lut, L, lanes, lane, code, nbits, opn);
}

__global__ void full_encode_tiled_kernel(const int32_t* __restrict__ valid,
                                         const int32_t* __restrict__ ctx,
                                         const int32_t* __restrict__ bit,
                                         int32_t* __restrict__ code,
                                         int32_t* __restrict__ nbits,
                                         int32_t* __restrict__ opn,
                                         const int32_t* __restrict__ luts,
                                         int L, int lanes) {
  __shared__ int lut[kLutSize];
  load_lut(lut, luts);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  CoderState s;
  init_state(s);
  for (int base = 0; base < L; base += kTile) {
    int tv[kTile], tc[kTile], tb[kTile];
    // the tile's loads, all issued before the dependent steps
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const size_t r = (size_t)(base + j) * lanes + lane;
      const bool in = base + j < L;
      tv[j] = in ? valid[r] : 0;
      tc[j] = in ? ctx[r] : 0;
      tb[j] = in ? bit[r] : 0;
    }
    int oc[kTile], on[kTile], oo[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      coder_step(s, lut, tv[j], tc[j], tb[j], base + j, oc[j], on[j], oo[j]);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (base + j < L) {
        const size_t r = (size_t)(base + j) * lanes + lane;
        code[r] = oc[j];
        nbits[r] = on[j];
        opn[r] = oo[j];
      }
    }
  }
  flush_rows(s, lut, L, lanes, lane, code, nbits, opn);
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          int32_t*, int32_t*, int32_t*, const int32_t*, int,
                          int);

int launch(KernelFn kernel, const void* valid, const void* ctx,
           const void* bit, void* code, void* nbits, void* opn,
           const void* luts, int L, int lanes, int lut_size, void* stream) {
  if (lut_size != kLutSize || L < 0 || L + 17 >= kBig)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return (int)cudaSuccess;
  const int threads = 64;
  const int blocks = (lanes + threads - 1) / threads;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)valid, (const int32_t*)ctx, (const int32_t*)bit,
      (int32_t*)code, (int32_t*)nbits, (int32_t*)opn, (const int32_t*)luts,
      L, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int full_encode_launch(const void* valid, const void* ctx,
                                  const void* bit, void* code, void* nbits,
                                  void* opn, const void* luts, int L,
                                  int lanes, int lut_size, void* stream) {
  return launch(full_encode_kernel, valid, ctx, bit, code, nbits, opn, luts,
                L, lanes, lut_size, stream);
}

extern "C" int full_encode_tiled_launch(const void* valid, const void* ctx,
                                        const void* bit, void* code,
                                        void* nbits, void* opn,
                                        const void* luts, int L, int lanes,
                                        int lut_size, void* stream) {
  return launch(full_encode_tiled_kernel, valid, ctx, bit, code, nbits, opn,
                luts, L, lanes, lut_size, stream);
}
