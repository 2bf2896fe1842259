// Native host runtime for the ICER TPU framework.
//
// Provides the sequential components that stay on the host:
//   * the interleaved entropy coder consuming precomputed emission streams
//     (pass-1 context modelling runs vectorized in numpy/JAX; only the
//     order-dependent codeword machinery runs here), and
//   * the bitplane decoder state machine, batched over independent
//     error-containment segments with a std::thread pool.
//
// Behavioral contract: bit-identical to the reference implementation
// (lib_icer/src/icer_encoding.c, icer_decoding.c, icer_context_modeller.c)
// and to this package's backend/sequential.py, which is differentially
// tested against the reference build.
//
// Exposed via a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

namespace {

constexpr int kBins = 17;
constexpr int kCtx = 17;           // adaptive contexts 0..16
constexpr int kCtxUncoded = 17;    // fixed-probability marker in emissions
constexpr int kCircBuf = 2048;
constexpr uint16_t kDone = 1u << 10;
constexpr uint16_t kDataMask = (1u << 10) - 1;
constexpr int kBitsOff = 11;
constexpr uint32_t kRescaleCap = 500;

// ---- format tables (mirrors core/constants.py; values are the ICER
// format specification) --------------------------------------------------

const uint32_t kCutoff[16] = {
    35298, 37345, 40503, 43591, 47480, 50133, 53645, 55902,
    57755, 58894, 60437, 62267, 63613, 64557, 65134, 65392};

const int32_t kBinScheme[kBins] = {0, -1, -1, -1, -1, -1, -1, -1,
                                   5, 6, 7, 11, 17, 31, 70, 200, 512};

struct CustomEntry { uint8_t in_val, in_bits, out_val, out_bits; };

// (input pattern value/bits -> output code value/bits), LSB-first values.
const CustomEntry kCustom[7][9] = {
    // bin 2
    {{0b01,2,0b10,2},{0b011,3,0b011,3},{0b0111,4,0b1111,4},{0b1111,4,0b10000,5},
     {0b10,2,0b01,2},{0b100,3,0b100,3},{0b1000,4,0b1000,4},{0b10000,5,0b00000,5},
     {0b00000,5,0b0111,4}},
    // bin 3
    {{0b10,2,0b01,2},{0b100,3,0b00,2},{0b0000,4,0b011,3},{0b11000,5,0b10010,5},
     {0b01000,5,0b1111,4},{0b01,2,0b110,3},{0b0011,4,0b0111,4},{0b1011,4,0b00010,5},
     {0b111,3,0b1010,4}},
    // bin 4
    {{0b10,2,0b10,2},{0b100,3,0b011,3},{0b000,3,0b00,2},{0b01,2,0b01,2},
     {0b11,2,0b111,3},{0,0,0,0},{0,0,0,0},{0,0,0,0},{0,0,0,0}},
    // bin 5
    {{0b00,2,0b1,1},{0b010,3,0b000,3},{0b110,3,0b1010,4},{0b101,3,0b0010,4},
     {0b1001,4,0b1110,4},{0b00001,5,0b0100,4},{0b10001,5,0b00110,5},
     {0b011,3,0b1100,4},{0b111,3,0b10110,5}},
    // bin 6
    {{0b1,1,0b10,2},{0b010,3,0b011,3},{0b110,3,0b1111,4},{0b100,3,0b101,3},
     {0b1000,4,0b001,3},{0b10000,5,0b0111,4},{0b00000,5,0b00,2},
     {0,0,0,0},{0,0,0,0}},
    // bin 7
    {{0b000,3,0b0,1},{0b100,3,0b001,3},{0b010,3,0b101,3},{0b110,3,0b01111,5},
     {0b11,2,0b0111,4},{0b001,3,0b011,3},{0b101,3,0b11111,5},{0,0,0,0},{0,0,0,0}},
    // bin 8
    {{0b10,2,0b101,3},{0b100,3,0b001,3},{0b0000,4,0b0,1},{0b01000,5,0b0111,4},
     {0b11000,5,0b01111,5},{0b01,2,0b011,3},{0b11,2,0b11111,5},{0,0,0,0},{0,0,0,0}},
};

struct FlushEntry { uint8_t val, bits, app_val, app_bits; };
const FlushEntry kFlush[7][8] = {
    // bin 2
    {{0b1,1,0,1},{0b11,2,0,1},{0b111,3,0,1},{0b0,1,1,1},{0b00,2,1,1},
     {0b000,3,1,1},{0b0000,4,0,1},{255,0,0,0}},
    // bin 3
    {{0b0,1,1,1},{0b00,2,1,1},{0b000,3,0,1},{0b1000,4,0,1},{0b1,1,0,1},
     {0b11,2,1,1},{0b011,3,0,1},{255,0,0,0}},
    // bin 4
    {{0b0,1,1,1},{0b00,2,0,1},{0b1,1,0,1},{255,0,0,0},{255,0,0,0},{255,0,0,0},
     {255,0,0,0},{255,0,0,0}},
    // bin 5
    {{0b0,1,0,1},{0b10,2,0,1},{0b01,2,1,1},{0b001,3,1,1},{0b0001,4,0,1},
     {0b1,1,0b01,2},{0b11,2,0,1},{255,0,0,0}},
    // bin 6
    {{0b0,1,0b01,2},{0b01,2,0,1},{0b00,2,1,1},{0b000,3,1,1},{0b0000,4,0,1},
     {255,0,0,0},{255,0,0,0},{255,0,0,0}},
    // bin 7
    {{0b0,1,0b00,2},{0b00,2,0,1},{0b10,2,0,1},{0b1,1,1,1},{0b01,2,0,1},
     {255,0,0,0},{255,0,0,0},{255,0,0,0}},
    // bin 8
    {{0b0,1,1,1},{0b00,2,1,1},{0b000,3,0,1},{0b1000,4,0,1},{0b1,1,0,1},
     {255,0,0,0},{255,0,0,0},{255,0,0,0}},
};

const uint8_t kCtxTableLL[3][3][5] = {
    {{0,1,2,2,2},{3,3,3,3,3},{4,4,4,4,4}},
    {{5,6,7,7,7},{7,7,7,7,7},{7,7,7,7,7}},
    {{8,8,8,8,8},{8,8,8,8,8},{8,8,8,8,8}}};
const uint8_t kCtxTableHH[5][5] = {
    {0,3,6,8,8},{1,4,7,8,8},{2,5,7,8,8},{2,5,7,8,8},{2,5,7,8,8}};
const uint8_t kSignCtx[5][5] = {
    {14,14,15,16,16},{14,14,15,16,16},{13,13,12,13,13},
    {16,16,15,14,14},{16,16,15,14,14}};
const uint8_t kSignPred[5][5] = {
    {1,1,1,1,1},{1,1,1,1,1},{0,0,0,1,1},{0,0,0,0,0},{0,0,0,0,0}};

// ---- derived LUTs, built once ------------------------------------------

struct Golomb { uint16_t m, l, i; };
Golomb g_golomb[kBins];
// encode: value -> (in_bits, out_val, out_bits); 0 in_bits = not a code.
uint8_t g_enc_in_bits[kBins][32];
uint8_t g_enc_out_val[kBins][32];
uint8_t g_enc_out_bits[kBins][32];
// flush: (value, bits) -> appended bits
uint8_t g_flush_val[kBins][32][6];
uint8_t g_flush_bits[kBins][32][6];
// decode: (stream code value, bits) -> (pushed value (reversed input), bits)
uint8_t g_dec_out_val[kBins][32][11];
uint8_t g_dec_out_bits[kBins][32][11];
uint8_t g_dec_valid[kBins][32][11];

uint16_t reverse_bits(uint16_t v, int n) {
  uint16_t r = 0;
  for (int b = 0; b < n; b++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

struct InitOnce {
  InitOnce() {
    for (int b = 0; b < kBins; b++) {
      if (kBinScheme[b] > 0) {
        unsigned m = kBinScheme[b];
        unsigned l = 31 - __builtin_clz(m);
        if ((m ^ (1u << l)) != 0) l++;
        g_golomb[b] = {uint16_t(m), uint16_t(l), uint16_t((1u << l) - m)};
      }
    }
    std::memset(g_enc_in_bits, 0, sizeof(g_enc_in_bits));
    std::memset(g_flush_bits, 0, sizeof(g_flush_bits));
    std::memset(g_flush_val, 0, sizeof(g_flush_val));
    std::memset(g_dec_valid, 0, sizeof(g_dec_valid));
    for (int bi = 0; bi < 7; bi++) {
      int b = bi + 1;
      for (const auto &e : kCustom[bi]) {
        if (e.in_bits == 0) continue;
        g_enc_in_bits[b][e.in_val] = e.in_bits;
        g_enc_out_val[b][e.in_val] = e.out_val;
        g_enc_out_bits[b][e.in_val] = e.out_bits;
        // decode table keyed by (output code, output bits); pushed value is
        // the bit-reversed input pattern so stack consumption replays the
        // original bit order.
        g_dec_valid[b][e.out_val][e.out_bits] = 1;
        g_dec_out_val[b][e.out_val][e.out_bits] =
            (uint8_t)reverse_bits(e.in_val, e.in_bits);
        g_dec_out_bits[b][e.out_val][e.out_bits] = e.in_bits;
      }
      for (const auto &f : kFlush[bi]) {
        if (f.val == 255) continue;
        g_flush_val[b][f.val][f.bits] = f.app_val;
        g_flush_bits[b][f.val][f.bits] = f.app_bits;
      }
    }
  }
} g_init;

int compute_bin(uint32_t zero, uint32_t total) {
  uint32_t comp = zero * 65536u;
  for (int b = 16; b > 0; b--)
    if (comp >= total * kCutoff[b - 1]) return b;
  return 0;
}

// Counter values stay below the rescale cap (total <= 500, zero <= total),
// so (bin, invert) is precomputable for every reachable (total, zero):
// one table read per coded bit instead of the 16-compare scan.
constexpr int kLutT = 512;
uint8_t g_bin_lut[kLutT][kLutT];   // bin | (invert << 5)

struct BinLutInit {
  BinLutInit() {
    for (uint32_t total = 1; total < kLutT; total++) {
      for (uint32_t zero = 0; zero <= total; zero++) {
        uint32_t z = zero;
        uint8_t inv = 0;
        if (z < (total >> 1)) { z = total - z; inv = 1; }
        g_bin_lut[total][zero] =
            (uint8_t)(compute_bin(z, total) | (inv << 5));
      }
    }
  }
} g_bin_lut_init;

// ---- encoder ------------------------------------------------------------

struct Encoder {
  std::vector<uint16_t> words;
  size_t head = 0;
  int64_t bin_word[kBins];   // index into words (unbounded), -1 = none
  int16_t bin_bits[kBins];
  uint8_t *out;
  size_t out_cap;
  size_t out_bits = 0;
  int flush_events = 0;
  bool overflowed = false;

  explicit Encoder(uint8_t *o, size_t cap) : out(o), out_cap(cap) {
    words.reserve(4096);
    for (int b = 0; b < kBins; b++) { bin_word[b] = -1; bin_bits[b] = 0; }
  }

  // Output is written strictly sequentially, so every byte is first
  // touched at bit offset 0: assign fresh bytes instead of OR-ing into
  // them.  The destination buffer therefore needs no pre-zeroing (a
  // large saving: worst-case-stride batch buffers are ~100x the actual
  // payload bytes).
  void emit(uint16_t v, int n) {
    size_t pos = out_bits;
    out_bits += n;
    if ((out_bits + 7) / 8 > out_cap) { overflowed = true; return; }
    while (n > 0) {
      size_t byte_i = pos >> 3;
      int bit_i = pos & 7;
      int take = 8 - bit_i < n ? 8 - bit_i : n;
      uint8_t bits = (uint8_t)((v & ((1u << take) - 1)) << bit_i);
      if (bit_i == 0)
        out[byte_i] = bits;
      else
        out[byte_i] |= bits;
      v >>= take;
      n -= take;
      pos += take;
    }
  }

  void pop_available() {
    while (head < words.size() && (words[head] & kDone)) {
      uint16_t w = words[head++];
      emit(w & kDataMask, w >> kBitsOff);
    }
  }

  static uint16_t golomb_done_word(int b, int k) {
    const Golomb &g = g_golomb[b];
    uint16_t code = k + (k < g.i ? 0 : g.i);
    int nb = g.l + (k >= g.i ? 1 : 0);
    code = reverse_bits(code, nb);
    return (uint16_t)((nb << kBitsOff) | kDone | code);
  }

  void flush_head() {
    uint16_t &w = words[head];
    if (!(w & kDone)) {
      int b = w >> kBitsOff;
      if (b > 7) {
        int k = w & kDataMask;
        if (k == g_golomb[b].m - 1)
          w = (uint16_t)((1 << kBitsOff) | kDone | 1);
        else
          w = golomb_done_word(b, k);
        bin_word[b] = -1;
      } else if (b != 0) {
        int prefix = w & kDataMask;
        int nb = bin_bits[b];
        prefix |= g_flush_val[b][prefix][nb] << nb;
        w = (uint16_t)((g_enc_out_bits[b][prefix] << kBitsOff) | kDone |
                       g_enc_out_val[b][prefix]);
        bin_word[b] = -1;
        bin_bits[b] = 0;
      }
    }
    pop_available();
  }

  // Uncoded (category-3) bits: bin 0 completes immediately, so with an
  // empty codeword queue the alloc+complete+pop collapses to a direct
  // bit append (identical output and state).
  inline void encode_uncoded(int bit) {
    if (head == words.size()) {
      emit((uint16_t)(bit & 1), 1);
      return;
    }
    encode_bit(bit, 1, 2);
  }

  void encode_bit(int bit, uint32_t zero, uint32_t total) {
    uint8_t lu = g_bin_lut[total][zero];
    bit ^= (lu >> 5);
    int b = lu & 31;
    int64_t idx = bin_word[b];
    if (idx < 0) {
      if (words.size() - head >= kCircBuf) { flush_events++; flush_head(); }
      idx = (int64_t)words.size();
      words.push_back((uint16_t)(b << kBitsOff));
      bin_word[b] = idx;
    }
    uint16_t w = words[idx];
    if (b > 7) {
      if (!bit) {
        w++;
        if ((w & kDataMask) >= g_golomb[b].m) {
          w = (uint16_t)((1 << kBitsOff) | kDone | 1);
          bin_word[b] = -1;
        }
      } else {
        w = golomb_done_word(b, w & kDataMask);
        bin_word[b] = -1;
      }
    } else if (b != 0) {
      w |= (uint16_t)(bit << bin_bits[b]);
      bin_bits[b]++;
      int prefix = w & kDataMask;
      if (g_enc_in_bits[b][prefix] == bin_bits[b]) {
        w = (uint16_t)((g_enc_out_bits[b][prefix] << kBitsOff) | kDone |
                       g_enc_out_val[b][prefix]);
        bin_word[b] = -1;
        bin_bits[b] = 0;
      }
    } else {
      w = (uint16_t)((1 << kBitsOff) | kDone | (bit & 1));
      bin_word[b] = -1;
    }
    words[idx] = w;
    pop_available();
  }

  void drain() { while (head < words.size()) flush_head(); }
};

// ---- decoder ------------------------------------------------------------

struct Decoder {
  const uint8_t *data;
  size_t nbytes;
  uint32_t encoded_bits;
  size_t pos = 0;                 // consumed bit position
  size_t decoded_words = 0;
  // Per-bin bit stack; golomb bins can hold up to m=512 pending zeros
  // (the reference uses 30 uint32 words = 960 bits: icer.h:328-337).
  uint64_t bin_buf[kBins][16];
  int bin_bits[kBins];
  size_t bin_index[kBins];
  bool out_of_data = false;
  bool invalid = false;

  Decoder(const uint8_t *d, size_t nb, uint32_t ebits)
      : data(d), nbytes(nb), encoded_bits(ebits) {
    for (int b = 0; b < kBins; b++) {
      std::memset(bin_buf[b], 0, sizeof(bin_buf[b]));
      bin_bits[b] = 0; bin_index[b] = 0;
    }
  }

  int bit_at(size_t p) const {
    size_t byte_i = p >> 3;
    if (byte_i >= nbytes) return 0;  // reference reads adjacent memory (UB)
    return (data[byte_i] >> (p & 7)) & 1;
  }

  int peek_bit(int ahead) const { return bit_at(pos + ahead - 1); }

  // Unaligned 64-bit window at byte_i; bytes past the readable extent are
  // zero (same value bit_at would produce).  Codewords are at most 11 bits,
  // so one window always covers a whole read.
  uint64_t load_window(size_t byte_i) const {
    if (byte_i + 8 <= nbytes) {
      uint64_t w;
      std::memcpy(&w, data + byte_i, 8);
      return w;
    }
    uint64_t w = 0;
    if (byte_i < nbytes) std::memcpy(&w, data + byte_i, nbytes - byte_i);
    return w;
  }

  uint32_t peek_bits(int n) {
    if ((uint32_t)n > encoded_bits) { out_of_data = true; return 0; }
    uint64_t w = load_window(pos >> 3) >> (pos & 7);
    return (uint32_t)(w & ((1ull << n) - 1));
  }

  uint32_t pop_bits(int n) {
    uint32_t v = peek_bits(n);
    pos += n;
    return v;
  }

  void push(uint32_t value, int n, int b) {
    int p = bin_bits[b];
    bin_bits[b] += n;
    while (n > 0) {
      int word = p >> 6, off = p & 63;
      int take = 64 - off < n ? 64 - off : n;
      bin_buf[b][word] |= ((uint64_t)value & ((take >= 64 ? ~0ull : ((1ull << take) - 1)))) << off;
      value >>= take;
      n -= take;
      p += take;
    }
  }

  int consume(int b) {
    int n = --bin_bits[b];
    int word = n >> 6, off = n & 63;
    int v = (int)((bin_buf[b][word] >> off) & 1);
    bin_buf[b][word] &= ~(1ull << off);
    return v;
  }

  // Returns 0/1, or -1 on error (out_of_data / invalid set).
  int decode_bit(uint32_t zero, uint32_t total) {
    uint8_t lu = g_bin_lut[total][zero];
    bool inv = (lu >> 5) != 0;
    int b = lu & 31;

    if (bin_bits[b] <= 0 || decoded_words - bin_index[b] >= kCircBuf) {
      bin_bits[b] = 0;
      std::memset(bin_buf[b], 0, sizeof(bin_buf[b]));
      if (b > 7) {
        const Golomb &g = g_golomb[b];
        if (peek_bit(1)) {
          pop_bits(1);
          push(0, g.m, b);
        } else {
          uint16_t k = (uint16_t)peek_bits(g.l);
          if (out_of_data) return -1;
          k = reverse_bits(k, g.l);
          if (k < g.i) {
            pop_bits(g.l);
            push(1, 1, b);
            push(0, k, b);
          } else {
            k = (uint16_t)pop_bits(g.l + 1);
            if (out_of_data) return -1;
            k = reverse_bits(k, g.l + 1);
            push(1, 1, b);
            push(0, k - g.i, b);
          }
        }
      } else if (b != 0) {
        // One windowed fetch covers the whole <=10-bit lookahead (bits
        // beyond the readable extent read as 0, like bit_at).
        const uint64_t look = load_window(pos >> 3) >> (pos & 7);
        uint32_t codeword = 0;
        int nb = 0;
        for (;;) {
          if ((uint32_t)(nb + 1) >= encoded_bits) { out_of_data = true; return -1; }
          codeword |= (uint32_t)((look >> nb) & 1) << nb;
          nb++;
          if (codeword >= 32) { invalid = true; return -1; }
          if (g_dec_valid[b][codeword][nb]) {
            push(g_dec_out_val[b][codeword][nb], g_dec_out_bits[b][codeword][nb], b);
            uint32_t test = pop_bits(nb);
            if (out_of_data) return -1;
            if (test != codeword) { invalid = true; return -1; }
            break;
          }
          if (nb >= 10) { invalid = true; return -1; }
        }
      } else {
        uint32_t v = pop_bits(1);
        if (out_of_data) return -1;
        push(v, 1, b);
      }
      decoded_words++;
      bin_index[b] = decoded_words;
    }
    int v = consume(b);
    return v ^ (inv ? 1 : 0);
  }
};

struct Counters {
  uint32_t zero[kCtx], total[kCtx];
  Counters() { for (int i = 0; i < kCtx; i++) { zero[i] = 2; total[i] = 4; } }
  void update(int c, int bit) {
    total[c]++;
    if (!bit) zero[c]++;
    if (total[c] >= kRescaleCap) {
      total[c] >>= 1;
      if (zero[c] > total[c]) zero[c] >>= 1;
    }
  }
};

// Fill row significance flags: dst[c+1] = ((seg_row[c] & magmask) >>
// plane) != 0 for c in [0, w); dst[0] and dst[w+1] stay 0 (border
// sentinels).  Straight-line loop, auto-vectorizes.
static inline void fill_sig_row(uint8_t *dst, const int32_t *seg_row,
                                int w, int32_t magmask, int plane) {
  for (int c = 0; c < w; c++)
    dst[c + 1] = (uint8_t)(((seg_row[c] & magmask) >> plane) != 0);
}

// Decode one bitplane of one segment in place.  data is int32
// sign-magnitude (sign at bit mag_bits).  Returns 0 ok, <0 error.
//
// Neighbor significance (icer_pixel_context's 3x3 probe) is kept in four
// rolling row buffers instead of 8 scattered int32 loads per pixel:
//   above_lsb -- row r-1 at plane lsb (already updated this plane),
//   cur_lsb   -- row r at lsb, updated in place as pixels decode,
//   cur_prev  -- row r at lsb+1 (static: this plane writes bit lsb only),
//   below_prev-- row r+1 at lsb+1 (static).
// Buffers are (w+2) wide with zero sentinels = "insignificant outside
// the segment", exactly the reference's border handling.
int decode_plane(int32_t *seg, int h, int w, int rowstride, int subband,
                 int lsb, int mag_bits, Counters &cnt, Decoder &dec) {
  const int prev = lsb + 1;
  const int32_t magmask = (1 << mag_bits) - 1;
  const bool is_hl = subband == 1, is_hh = subband == 3;

  auto sgn = [&](int r, int c, int plane) -> int {
    int32_t v = seg[r * rowstride + c];
    if (((v & magmask) >> plane) == 0) return 0;
    return (v >> mag_bits) & 1 ? -1 : 0;
  };

  const int bw = w + 2;
  std::vector<uint8_t> scratch(4 * bw, 0);
  uint8_t *above_lsb = scratch.data();
  uint8_t *cur_lsb = scratch.data() + bw;
  uint8_t *cur_prev = scratch.data() + 2 * bw;
  uint8_t *below_prev = scratch.data() + 3 * bw;
  fill_sig_row(cur_prev, seg, w, magmask, prev);
  // Pre-decode, every lsb bit in the row is still 0, so row-at-lsb
  // significance equals row-at-prev significance.
  std::memcpy(cur_lsb, cur_prev, bw);
  if (h > 1) fill_sig_row(below_prev, seg + rowstride, w, magmask, prev);

  for (int r = 0; r < h; r++) {
    for (int c = 0; c < w; c++) {
      int32_t v = seg[r * rowstride + c];
      int32_t mag = v & magmask;
      int msb = 31 - __builtin_clz((uint32_t)(mag | 1));
      int cat = msb - lsb;
      if (cat < 0) cat = 0;
      if (cat > 3) cat = 3;

      if (cat == 3) {
        // Uncoded bin with counts (1,2): no inversion, bin 0, and the
        // 1-bit FIFO always drains immediately -- inline the read while
        // keeping decoded_words/bin_index bookkeeping identical.  Runs
        // of consecutive cat-3 pixels read in up-to-16-bit batches (the
        // out-of-data guard compares a constant n against the frozen
        // plane total, so batching only when the total covers the batch
        // keeps the error semantics exactly).
        if (dec.encoded_bits >= 16) {
          int cend = c;
          const int32_t hi = ((int32_t)1) << (lsb + 3);
          while (cend < w
                 && (seg[r * rowstride + cend] & magmask) >= hi)
            cend++;
          int run = cend - c;
          while (run > 0) {
            int take = run < 16 ? run : 16;
            uint32_t bits = dec.pop_bits(take);
            for (int k = 0; k < take; k++)
              seg[r * rowstride + c + k] |=
                  (int32_t)((bits >> k) & 1) << lsb;
            dec.decoded_words += take;
            c += take;
            run -= take;
          }
          dec.bin_index[0] = dec.decoded_words;
          c--;  // loop increment
          continue;
        }
        uint32_t bitv = dec.pop_bits(1);
        if (dec.out_of_data) return -1;
        dec.decoded_words++;
        dec.bin_index[0] = dec.decoded_words;
        seg[r * rowstride + c] = v | ((int32_t)bitv << lsb);
        continue;
      }

      const int i = c + 1;
      int ctx;
      int hc = 0, vc = 0;
      if (cat <= 1) {
        hc = cur_lsb[i - 1] + cur_prev[i + 1];
        vc = above_lsb[i] + below_prev[i];
      }
      if (cat == 0) {
        int dc = above_lsb[i - 1] + below_prev[i - 1]
               + above_lsb[i + 1] + below_prev[i + 1];
        int hh = hc, vv = vc;
        if (is_hl) { hh = vc; vv = hc; }
        ctx = is_hh ? kCtxTableHH[hh + vv][dc] : kCtxTableLL[hh][vv][dc];
      } else if (cat == 1) {
        ctx = (hc + vc == 0) ? 9 : 10;
      } else {
        ctx = 11;
      }

      int bit = dec.decode_bit(cnt.zero[ctx], cnt.total[ctx]);
      if (bit < 0) return -1;
      v |= bit << lsb;
      seg[r * rowstride + c] = v;
      cnt.update(ctx, bit);
      if (cat == 0) cur_lsb[i] = (uint8_t)bit;

      if (cat == 0 && bit) {
        int sh = 2 + (c > 0 ? sgn(r, c - 1, lsb) : 0)
                   + (c < w - 1 ? sgn(r, c + 1, prev) : 0);
        int sv = 2 + (r > 0 ? sgn(r - 1, c, lsb) : 0)
                   + (r < h - 1 ? sgn(r + 1, c, prev) : 0);
        if (is_hl) { int t = sh; sh = sv; sv = t; }
        int sctx = kSignCtx[sh][sv];
        int pred = kSignPred[sh][sv];
        int agree = dec.decode_bit(cnt.zero[sctx], cnt.total[sctx]);
        if (agree < 0) return -1;
        int actual = (agree ^ pred) & 1;
        seg[r * rowstride + c] = v | (actual << mag_bits);
        cnt.update(sctx, agree);
      }
    }
    // Rotate: next row's above@lsb is this row's (updated) cur@lsb; next
    // row's cur@prev is this row's below@prev.
    std::swap(above_lsb, cur_lsb);
    std::swap(cur_prev, below_prev);
    std::memcpy(cur_lsb, cur_prev, bw);
    if (r + 2 < h)
      fill_sig_row(below_prev, seg + (r + 2) * rowstride, w, magmask, prev);
    else
      std::memset(below_prev, 0, bw);
  }
  return 0;
}


// Encode one bitplane of one segment: pixel-loop context modelling fused
// with the interleaved coder (mirrors icer_compress_bitplane_*).
void encode_plane(const int32_t *seg, int h, int w, int rowstride,
                  int subband, int lsb, int mag_bits, Counters &cnt,
                  Encoder &enc) {
  const int prev = lsb + 1;
  const int32_t magmask = (1 << mag_bits) - 1;
  const bool is_hl = subband == 1, is_hh = subband == 3;

  auto sgn = [&](int r, int c, int plane) -> int {
    int32_t v = seg[r * rowstride + c];
    if (((v & magmask) >> plane) == 0) return 0;
    return (v >> mag_bits) & 1 ? -1 : 0;
  };

  // Rolling row significance buffers (see decode_plane): the data is
  // static during encode, so all four rows are direct fills.
  const int bw = w + 2;
  std::vector<uint8_t> scratch(4 * bw, 0);
  uint8_t *above_lsb = scratch.data();
  uint8_t *cur_lsb = scratch.data() + bw;
  uint8_t *cur_prev = scratch.data() + 2 * bw;
  uint8_t *below_prev = scratch.data() + 3 * bw;
  fill_sig_row(cur_lsb, seg, w, magmask, lsb);
  fill_sig_row(cur_prev, seg, w, magmask, prev);
  if (h > 1) fill_sig_row(below_prev, seg + rowstride, w, magmask, prev);

  for (int r = 0; r < h; r++) {
    for (int c = 0; c < w; c++) {
      int32_t v = seg[r * rowstride + c];
      int32_t mag = v & magmask;
      int msb = 31 - __builtin_clz((uint32_t)(mag | 1));
      int cat = msb - lsb;
      if (cat < 0) cat = 0;
      if (cat > 3) cat = 3;
      int bit = (mag >> lsb) & 1;

      if (cat == 3) {
        // With an empty codeword queue, a run of cat-3 pixels is a raw
        // bit run: gather up to 16 bits and emit once (state-equivalent
        // to per-pixel encode_uncoded, which emits directly under the
        // same queue-empty condition).
        if (enc.head == enc.words.size()) {
          int cend = c;
          const int32_t hi = ((int32_t)1) << (lsb + 3);
          while (cend < w && (seg[r * rowstride + cend] & magmask) >= hi)
            cend++;
          uint32_t wbuf = 0;
          int nb = 0;
          for (int k = c; k < cend; k++) {
            wbuf |= (uint32_t)(((seg[r * rowstride + k] & magmask)
                                >> lsb) & 1) << nb;
            if (++nb == 16) { enc.emit((uint16_t)wbuf, 16); wbuf = 0; nb = 0; }
          }
          if (nb) enc.emit((uint16_t)wbuf, nb);
          c = cend - 1;
          continue;
        }
        enc.encode_uncoded(bit);
        continue;
      }
      const int i = c + 1;
      int ctx;
      int hc = 0, vc = 0;
      if (cat <= 1) {
        hc = cur_lsb[i - 1] + cur_prev[i + 1];
        vc = above_lsb[i] + below_prev[i];
      }
      if (cat == 0) {
        int dc = above_lsb[i - 1] + below_prev[i - 1]
               + above_lsb[i + 1] + below_prev[i + 1];
        int hh = hc, vv = vc;
        if (is_hl) { hh = vc; vv = hc; }
        ctx = is_hh ? kCtxTableHH[hh + vv][dc] : kCtxTableLL[hh][vv][dc];
      } else if (cat == 1) {
        ctx = (hc + vc == 0) ? 9 : 10;
      } else {
        ctx = 11;
      }
      enc.encode_bit(bit, cnt.zero[ctx], cnt.total[ctx]);
      cnt.update(ctx, bit);

      if (cat == 0 && bit) {
        int sh = 2 + (c > 0 ? sgn(r, c - 1, lsb) : 0)
                   + (c < w - 1 ? sgn(r, c + 1, prev) : 0);
        int sv = 2 + (r > 0 ? sgn(r - 1, c, lsb) : 0)
                   + (r < h - 1 ? sgn(r + 1, c, prev) : 0);
        if (is_hl) { int t = sh; sh = sv; sv = t; }
        int sctx = kSignCtx[sh][sv];
        int agree = (kSignPred[sh][sv] ^ ((v >> mag_bits) & 1)) & 1;
        enc.encode_bit(agree, cnt.zero[sctx], cnt.total[sctx]);
        cnt.update(sctx, agree);
      }
    }
    std::swap(above_lsb, cur_lsb);
    std::swap(cur_prev, below_prev);
    if (r + 1 < h)
      fill_sig_row(cur_lsb, seg + (r + 1) * rowstride, w, magmask, lsb);
    if (r + 2 < h)
      fill_sig_row(below_prev, seg + (r + 2) * rowstride, w, magmask, prev);
    else
      std::memset(below_prev, 0, bw);
  }
  enc.drain();
}


// ---- integer lifting DWT (mirrors ops/wavelet.py semantics) -------------

struct FiltParams { int a_n1, a0, a1, beta; };
const FiltParams kFilt[7] = {
    {0,4,4,0},{0,4,6,4},{-1,4,8,6},{0,4,5,2},{0,3,8,6},{0,3,9,8},{0,4,4,4}};

inline int32_t floor_div(int32_t a, int32_t b) {
  int32_t d = a / b, r = a % b;
  return r && ((a < 0) != (b < 0)) ? d - 1 : d;
}

inline int32_t wrap_sample(int32_t v, int mag_bits) {
  int bits = mag_bits + 1;
  uint32_t m = (1u << bits) - 1;
  uint32_t w = (uint32_t)v & m;
  return (int32_t)w - (int32_t)(((w >> (bits - 1)) & 1) << bits);
}

// Forward lifting of one line (length N, stride st), out-of-place temp.
// Returns overflow flag.
bool dwt_fwd_line(int32_t *x, int N, int st, int filt, int mag_bits,
                  int32_t *tmp) {
  const FiltParams &f = kFilt[filt];
  int lo = -(1 << mag_bits), hi = (1 << mag_bits) - 1;
  bool ov = false;
  int half = N / 2, is_odd = N & 1, nL = half + is_odd;
  int32_t *L = tmp, *D = tmp + nL;
  for (int n = 0; n < half; n++) {
    int32_t d1 = x[(2 * n) * st], d2 = x[(2 * n + 1) * st];
    int32_t l = floor_div(d1 + d2, 2), h = d1 - d2;
    if (l > hi || l < lo || h > hi || h < lo) ov = true;
    L[n] = wrap_sample(l, mag_bits);
    D[n] = wrap_sample(h, mag_bits);
  }
  if (is_odd) L[half] = x[(N - 1) * st];

  auto r_at = [&](int n) -> int32_t {
    return n > 0 ? L[n - 1] - L[n] : 1;
  };
  for (int n = 0; n < half; n++) {
    int32_t sub;
    if (n == 0) {
      sub = floor_div(r_at(1), 4);
    } else if (n == 1 && f.a_n1 != 0) {
      // filter C quirk: the d term reads the *original* high[1]
      // (0 when N == 5); see ops/wavelet.py.
      int32_t d2v = (is_odd && half == 2) ? 0 : D[1];
      sub = floor_div(2 * r_at(1) + 3 * r_at(2) - 2 * d2v + 4, 8);
    } else if (!is_odd && n == half - 1) {
      sub = floor_div(r_at(half - 1), 4);
    } else {
      int32_t dn = (n + 1 < half) ? D[n + 1] : 0;
      sub = floor_div(f.a_n1 * r_at(n - 1) + f.a0 * r_at(n)
                      + f.a1 * r_at(n + 1) - f.beta * dn + 8, 16);
    }
    int32_t h = D[n] - sub;
    if (h > hi || h < lo) ov = true;
    D[n] = wrap_sample(h, mag_bits);
  }
  for (int n = 0; n < nL; n++) x[n * st] = L[n];
  for (int n = 0; n < half; n++) x[(nL + n) * st] = D[n];
  return ov;
}

// Inverse of dwt_fwd_line; includes the uint8 odd-length interleave quirk.
bool dwt_inv_line(int32_t *x, int N, int st, int filt, int mag_bits,
                  int32_t *tmp) {
  const FiltParams &f = kFilt[filt];
  int lo = -(1 << mag_bits), hi = (1 << mag_bits) - 1;
  bool ov = false;
  int half = N / 2, is_odd = N & 1, nL = half + is_odd;
  int32_t *L = tmp, *D = tmp + nL;
  for (int n = 0; n < nL; n++) L[n] = x[n * st];
  for (int n = 0; n < half; n++) D[n] = x[(nL + n) * st];

  auto r_at = [&](int n) -> int32_t {
    return n > 0 ? L[n - 1] - L[n] : 1;
  };
  int32_t *H = tmp + nL + half;          // stored (coded) highs copy
  for (int n = 0; n < half; n++) H[n] = D[n];
  for (int n = half - 1; n >= 0; n--) {
    int32_t add;
    if (n == 0) {
      add = floor_div(r_at(1), 4);
    } else if (n == 1 && f.a_n1 != 0) {
      int32_t d2v = (is_odd && half == 2) ? 0 : H[1];
      add = floor_div(2 * r_at(1) + 3 * r_at(2) - 2 * d2v + 4, 8);
    } else if (!is_odd && n == half - 1) {
      add = floor_div(r_at(half - 1), 4);
    } else {
      int32_t dn = (n + 1 < half) ? D[n + 1] : 0;  // restored
      add = floor_div(f.a_n1 * r_at(n - 1) + f.a0 * r_at(n)
                      + f.a1 * r_at(n + 1) - f.beta * dn + 8, 16);
    }
    int32_t d = H[n] + add;
    if (d > hi || d < lo) ov = true;
    D[n] = wrap_sample(d, mag_bits);
  }

  // un-pair into y = [evens | tail | odds], then interleave
  int32_t *Y = tmp + nL + 2 * half;
  for (int n = 0; n < half; n++) {
    int32_t t = L[n] + floor_div(D[n] + 1, 2);
    int32_t o = t - D[n];
    if (t > hi || t < lo || o > hi || o < lo) ov = true;
    Y[n] = wrap_sample(t, mag_bits);
    Y[nL + n] = wrap_sample(o, mag_bits);
  }
  if (is_odd) Y[half] = wrap_sample(L[half], mag_bits);

  if (!is_odd) {
    for (int n = 0; n < half; n++) {
      x[(2 * n) * st] = Y[n];
      x[(2 * n + 1) * st] = Y[nL + n];
    }
  } else if (mag_bits == 15) {
    for (int n = 0; n < half; n++) {
      x[(2 * n) * st] = Y[n];
      x[(2 * n + 1) * st] = Y[nL + n];
    }
    x[(N - 1) * st] = Y[half];
  } else {
    // uint8 odd-length quirk: pairs (y[j], y[m+2+j]) then y[m-1..m+1]
    int m = half, k = 0;
    for (int j = 0; j + 1 < m; j++) {
      x[(k++) * st] = Y[j];
      x[(k++) * st] = Y[m + 2 + j];
    }
    x[(k++) * st] = Y[m - 1];
    x[(k++) * st] = Y[m];
    x[(k++) * st] = Y[m + 1];
  }
  return ov;
}

int ceil_div_int(int a, int b) { return (a + b - 1) / b; }

bool dwt_2d(int32_t *img, int w, int h, int rowstride, int filt,
            int mag_bits, bool inverse, int nthreads) {
  std::atomic<bool> ov(false);
  auto run_lines = [&](bool cols) {
    int count = cols ? w : h;
    int len = cols ? h : w;
    int stride = cols ? rowstride : 1;
    std::atomic<int> next(0);
    auto worker = [&]() {
      std::vector<int32_t> tmp(4 * (len + 2));
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= count) return;
        int32_t *base = img + (cols ? i : i * rowstride);
        bool o = inverse
            ? dwt_inv_line(base, len, stride, filt, mag_bits, tmp.data())
            : dwt_fwd_line(base, len, stride, filt, mag_bits, tmp.data());
        if (o) ov.store(true);
      }
    };
    int nt = nthreads > 1 && count > 8 ? nthreads : 1;
    if (nt == 1) {
      worker();
    } else {
      std::vector<std::thread> ths;
      for (int t = 0; t < nt; t++) ths.emplace_back(worker);
      for (auto &t : ths) t.join();
    }
  };
  if (!inverse) {
    run_lines(false);   // rows
    run_lines(true);    // cols
  } else {
    run_lines(true);    // cols
    run_lines(false);   // rows
  }
  return ov.load();
}

}  // namespace

// ---- C ABI --------------------------------------------------------------

extern "C" {

// Entropy-encode a precomputed emission stream.
// valid/ctx/bit: int32 arrays of length n (ctx 0..16 adaptive, 17 uncoded).
// out: byte buffer of out_cap bytes.  Returns bit length (>=0) or -1 if
// out_cap was exceeded.  *flush_events reports mid-plane forced flushes.
int64_t icer_tpu_encode_emissions(const int32_t *valid, const int32_t *ctx,
                                  const int32_t *bit, int64_t n,
                                  uint8_t *out, int64_t out_cap,
                                  int32_t *flush_events) {
  Encoder enc(out, (size_t)out_cap);
  Counters cnt;
  for (int64_t i = 0; i < n; i++) {
    if (!valid[i]) continue;
    int c = ctx[i];
    int b = bit[i];
    if (c == kCtxUncoded) {
      enc.encode_uncoded(b);
    } else {
      enc.encode_bit(b, cnt.zero[c], cnt.total[c]);
      cnt.update(c, b);
    }
    if (enc.overflowed) return -1;
  }
  enc.drain();
  if (enc.overflowed) return -1;
  if (flush_events) *flush_events = enc.flush_events;
  return (int64_t)enc.out_bits;
}

// One decode task: a segment of a subband with its per-plane payloads.
struct SegTask {
  int32_t seg_off;      // offset of segment (row0*rowstride + col0) in image
  int32_t h, w, rowstride;
  int32_t subband, mag_bits;
  int32_t nplanes;      // number of bitplanes (7 or 9); lsb index = plane
  // per plane (index = lsb): offset into blob (bytes) and bit length;
  // offset < 0 means plane missing.
  int64_t plane_off[16];
  int64_t plane_bits[16];
};

// Decode a batch of independent segment tasks with nthreads workers.
// statuses[i]: 0 full, >0 = number of planes decoded before stopping.
void icer_tpu_decode_segments(int32_t *image, const SegTask *tasks,
                              int64_t ntasks, const uint8_t *blob,
                              int64_t blob_len, int32_t nthreads,
                              int32_t *planes_done) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t t = next.fetch_add(1);
      if (t >= ntasks) return;
      const SegTask &task = tasks[t];
      int32_t *seg = image + task.seg_off;
      int done = 0;
      for (int lsb = task.nplanes - 1; lsb >= 0; lsb--) {
        if (task.plane_off[lsb] < 0) break;
        Counters cnt;
        // Readable extent runs to the end of the blob: the reference
        // decodes zero-copy from the stream, so out-of-contract over-reads
        // consume the following stream bytes (reproduced for parity).
        size_t nbytes = (size_t)(blob_len - task.plane_off[lsb]);
        Decoder dec(blob + task.plane_off[lsb], nbytes,
                    (uint32_t)task.plane_bits[lsb]);
        int r = decode_plane(seg, task.h, task.w, task.rowstride,
                             task.subband, lsb, task.mag_bits, cnt, dec);
        if (r < 0) break;
        done++;
      }
      planes_done[t] = done;
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt == 1 || ntasks <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int i = 0; i < nt; i++) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }
}

// Batched entropy encode: tasks give (offset, length) into the emission
// arrays; outputs are written at fixed stride out_stride per task.
void icer_tpu_encode_batch(const int32_t *valid, const int32_t *ctx,
                           const int32_t *bit, const int64_t *offsets,
                           const int64_t *lengths, int64_t ntasks,
                           uint8_t *out, int64_t out_stride,
                           int64_t *out_bits, int32_t nthreads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t t = next.fetch_add(1);
      if (t >= ntasks) return;
      int32_t fl = 0;
      out_bits[t] = icer_tpu_encode_emissions(
          valid + offsets[t], ctx + offsets[t], bit + offsets[t], lengths[t],
          out + t * out_stride, out_stride, &fl);
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt == 1 || ntasks <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int i = 0; i < nt; i++) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }
}


// One encode task: a segment of a subband; bitplanes lsb0 .. lsb0 +
// nplanes - 1 are encoded (fresh coder + counters per plane, mirroring
// icer_compress_partition_*).  lsb0 lets the quota-aware scheduler
// submit single-plane packets in priority order.
struct EncTask {
  int32_t seg_off, h, w, rowstride, subband, mag_bits, nplanes, lsb0;
};

// Encode a batch of segment tasks.  For task t and plane lsb, the payload
// is written at out + (t*nplanes + lsb)*stride and its bit length at
// out_bits[t*nplanes + lsb].
void icer_tpu_encode_segments(const int32_t *image, const EncTask *tasks,
                              int64_t ntasks, uint8_t *out, int64_t stride,
                              int64_t *out_bits, int32_t nthreads) {
  // Planes of one segment are independent (fresh coder + counters each,
  // mirroring icer_compress_partition_*), so parallelize over
  // (task, plane) units: ~nplanes x finer-grained than whole segments,
  // which balances the work when segment sizes span orders of magnitude.
  std::atomic<int64_t> next(0);
  const int64_t nplanes = ntasks ? tasks[0].nplanes : 0;
  const int64_t nunits = ntasks * nplanes;
  auto worker = [&]() {
    for (;;) {
      int64_t u = next.fetch_add(1);
      if (u >= nunits) return;
      int64_t t = u / nplanes;
      const EncTask &task = tasks[t];
      int lsb = task.lsb0 + (int)(u % nplanes);
      const int32_t *seg = image + task.seg_off;
      uint8_t *o = out + u * stride;
      Encoder enc(o, (size_t)stride);
      Counters cnt;
      encode_plane(seg, task.h, task.w, task.rowstride, task.subband,
                   lsb, task.mag_bits, cnt, enc);
      out_bits[u] = enc.overflowed ? -1 : (int64_t)enc.out_bits;
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt == 1 || nunits <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int i = 0; i < nt; i++) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }
}


// Multi-stage DWT on an int32 image, in place.  Returns 1 on overflow.
int32_t icer_tpu_dwt_forward(int32_t *img, int32_t w, int32_t h,
                             int32_t stages, int32_t filt, int32_t mag_bits,
                             int32_t nthreads) {
  bool ov = false;
  int lw = w, lh = h;
  for (int s = 0; s < stages; s++) {
    ov |= dwt_2d(img, lw, lh, w, filt, mag_bits, false, nthreads);
    lw = (lw + 1) / 2;
    lh = (lh + 1) / 2;
  }
  return ov ? 1 : 0;
}

int32_t icer_tpu_dwt_inverse(int32_t *img, int32_t w, int32_t h,
                             int32_t stages, int32_t filt, int32_t mag_bits,
                             int32_t nthreads) {
  bool ov = false;
  for (int it = 1; it <= stages; it++) {
    int dec = stages - it;
    int lw = w, lh = h;
    for (int k = 0; k < dec; k++) { lw = (lw + 1) / 2; lh = (lh + 1) / 2; }
    ov |= dwt_2d(img, lw, lh, w, filt, mag_bits, true, nthreads);
  }
  return ov ? 1 : 0;
}

}  // extern "C"
