// Native image codec: PNG row filters, JPEG decoding (baseline, extended
// sequential and progressive, Huffman or arithmetic coding; 1, 3 and 4
// components) and baseline JPEG encoding.
//
// The JAX package reads and writes every image through cv2 (libpng and
// libjpeg(-turbo)); the port has neither, so this file rebuilds the parts it
// needs.  The arithmetic follows libjpeg where cv2's results depend on it:
//   * jidctint.c  jpeg_idct_islow (the decoder's default IDCT), with the
//     16-bit wrapping and saturation of libjpeg-turbo's SIMD version of it
//     (jidctint-sse2.asm / -avx2.asm), which cv2 runs
//   * jdhuff.c, jdphuff.c  Huffman scans, the four progressive kinds into a
//     whole-image coefficient buffer (jdcoefct.c), quantization tables
//     latched per component at its first scan (jdinput.c
//     latch_quant_tables), and the rule for data that run out
//     (insufficient_data: the rest of the scan is left as it was)
//   * jdarith.c   ITU-T T.81 Annex D's binary arithmetic decoder (jaricom.c's
//     probability table), its sequential and four progressive scan kinds,
//     the DAC conditioning and its stop at an impossible code
//   * jdcoefct.c  libjpeg-turbo's (>= 2.1) block smoothing of progressive
//     files whose scans leave low-frequency bits unknown (smoothing_ok,
//     decompress_smooth_data), as cv2's bundled libjpeg-turbo 3.1 does it
//   * jdsample.c  h2v1/h2v2/h1v2 "fancy" triangular chroma upsampling
//   * jdcolor.c   fixed-point YCbCr -> RGB tables, YCCK -> CMYK
//   * jfdctint.c  jpeg_fdct_islow, jcsample.c h2v2_downsample, jccolor.c
//     RGB -> YCbCr and jcparam.c quality scaling (the encoder's defaults)
// and cv2's where it post-processes libjpeg's samples: CMYK -> BGR
// (imgcodecs/src/utils.cpp icvCvt_CMYK2BGR_8u_C4C3R).
// PNG inflation stays in Python (zlib); only the five row filters are here,
// since Paeth and Average run sequentially along a row.  cv2's INTER_AREA
// resize is here too (imgproc/resize.cpp): at fractional shrinking ratios
// computeResizeAreaTab and ResizeArea_Invoker, their float32 sums in cv2's
// order; where either axis grows, the linear resize with area coefficients
// and its uint8 fixed-point passes.
//
// Exposed via a plain C ABI for ctypes.  Errors return a negative code; the
// message is read with image_ops_error().  Return codes: -1 malformed or
// unsupported input, -2 a JPEG that cv2 does not read either: a coding mode
// the decoder does not implement (lossless, hierarchical, 12-bit samples, 2
// components or a DNL-defined height) or a file cut off before its EOI.
//
// Build: c++ -O3 -shared -fPIC -std=c++17 image_ops.cpp -o libimage_ops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;
thread_local std::vector<uint8_t> g_encoded;

struct CodecError {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg, int code = -1) {
  throw CodecError{code, msg};
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// ---------------------------------------------------------------------------
// JPEG tables
// ---------------------------------------------------------------------------

const int kZigzag[64 + 16] = {  // natural index of the k-th coefficient
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries absorb a corrupt run past the end of the block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// jidctint.c: slow-but-accurate integer IDCT
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline int32_t wrap16(int32_t v) { return (int16_t)(uint16_t)(uint32_t)v; }
inline int32_t clamp_to(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// pmaddwd: two 16-bit products summed in 32 bits, wrapping
inline uint32_t madd(int32_t a, int32_t ca, int32_t b, int32_t cb) {
  return (uint32_t)(a * ca) + (uint32_t)(b * cb);
}

// One 1-D pass of jidctint.c over 8 inputs, as libjpeg-turbo's SIMD code
// arranges it (jidctint-sse2.asm / -avx2.asm): the sums of two inputs in
// 16 bits, the products and everything after in 32 bits, wrapping.  out:
// the 8 outputs before descaling.
void islow_1d(const int32_t* in, uint32_t* out) {
  const uint32_t tmp3 = madd(in[2], FIX_0_541196100 + FIX_0_765366865, in[6],
                             FIX_0_541196100);
  const uint32_t tmp2 = madd(in[2], FIX_0_541196100, in[6],
                             FIX_0_541196100 - FIX_1_847759065);
  const uint32_t tmp0 = (uint32_t)(wrap16(in[0] + in[4]) * (1 << CONST_BITS));
  const uint32_t tmp1 = (uint32_t)(wrap16(in[0] - in[4]) * (1 << CONST_BITS));
  const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int32_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  const uint32_t z3m = madd(z3, FIX_1_175875602 - FIX_1_961570560, z4,
                            FIX_1_175875602);
  const uint32_t z4m = madd(z3, FIX_1_175875602, z4,
                            FIX_1_175875602 - FIX_0_390180644);
  const uint32_t o0 = madd(in[7], FIX_0_298631336 - FIX_0_899976223, in[1],
                           -FIX_0_899976223) + z3m;
  const uint32_t o3 = madd(in[7], -FIX_0_899976223, in[1],
                           FIX_1_501321110 - FIX_0_899976223) + z4m;
  const uint32_t o1 = madd(in[5], FIX_2_053119869 - FIX_2_562915447, in[3],
                           -FIX_2_562915447) + z4m;
  const uint32_t o2 = madd(in[5], -FIX_2_562915447, in[3],
                           FIX_3_072711026 - FIX_2_562915447) + z3m;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

// (x + 2^(n-1)) >> n in 32 bits, wrapping, then saturated to 16 bits
inline int32_t descale16(uint32_t x, int n) {
  return clamp_to((int32_t)(x + (1u << (n - 1))) >> n, -32768, 32767);
}

// jidctint.c's slow-but-accurate IDCT as libjpeg-turbo's SIMD code
// computes it, which is what cv2 runs: dequantization in 16 bits
// (pmullw), the column pass's outputs saturated to 16 bits and the samples
// to 8 (packssdw, packsswb, then + 128), and the DC-only shortcut taken
// only when rows 1-7 of every column are zero.  A column or row whose
// inputs 1-7 are zero gives the full path's outputs from its DC alone (no
// sum there can wrap), so it takes that shortcut.  deq: the dequantized
// coefficients (natural order); ac: whether a coefficient of rows 1-7 is
// nonzero before dequantization; out: 8x8 samples, row stride `stride`.
void idct_islow_simd(const int32_t* deq, bool ac, uint8_t* out,
                     int64_t stride) {
  int32_t ws[64];
  uint32_t o[8];
  for (int c = 0; c < 8; c++) {
    int32_t in[8];
    bool col_ac = false;
    for (int k = 0; k < 8; k++) {
      in[k] = wrap16(deq[k * 8 + c]);
      col_ac |= k > 0 && in[k] != 0;
    }
    if (!col_ac) {  // the SIMD block shortcut wraps, the full path saturates
      const int32_t v = ac ? clamp_to(in[0] * (1 << PASS1_BITS), -32768, 32767)
                           : wrap16(in[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = v;
      continue;
    }
    islow_1d(in, o);
    for (int k = 0; k < 8; k++)
      ws[k * 8 + c] = descale16(o[k], CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + r * 8;
    uint8_t* row = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint32_t dc = (uint32_t)(w[0] * (1 << CONST_BITS));
      std::memset(row, clamp_to(descale16(dc, CONST_BITS + PASS1_BITS + 3),
                                -128, 127) + 128, 8);
      continue;
    }
    islow_1d(w, o);
    for (int k = 0; k < 8; k++)
      row[k] = (uint8_t)(clamp_to(descale16(o[k], CONST_BITS + PASS1_BITS + 3),
                                  -128, 127) + 128);
  }
}

// A bound on the column pass's outputs, summed per column as coefficients
// are dequantized: |output| <= 4 |row 0| + 5.55 (|row 1| + ... + |row 7|)
// (the 1-D IDCT's largest weights, 8192 and 11363, over 2^11).
inline void add_to_bound(int32_t* bound, int nat, int32_t deq) {
  bound[nat & 7] += (nat < 8 ? 4 : 6) * (deq < 0 ? -deq : deq);
}

// jidctint.c's IDCT as its C code computes it, the samples clamped.
void idct_islow_c(const int32_t* coef, uint8_t* out, int64_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int32_t* in = coef + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = in[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = (int32_t)descale(tmp10 + tmp3, sh);
    ws[7 * 8 + c] = (int32_t)descale(tmp10 - tmp3, sh);
    ws[1 * 8 + c] = (int32_t)descale(tmp11 + tmp2, sh);
    ws[6 * 8 + c] = (int32_t)descale(tmp11 - tmp2, sh);
    ws[2 * 8 + c] = (int32_t)descale(tmp12 + tmp1, sh);
    ws[5 * 8 + c] = (int32_t)descale(tmp12 - tmp1, sh);
    ws[3 * 8 + c] = (int32_t)descale(tmp13 + tmp0, sh);
    ws[4 * 8 + c] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  auto sample = [](int64_t v) {
    return (uint8_t)(v < -128 ? 0 : (v > 127 ? 255 : v + 128));
  };
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      std::memset(o, sample(descale(w[0], PASS1_BITS + 3)), 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = sample(descale(tmp10 + tmp3, sh));
    o[7] = sample(descale(tmp10 - tmp3, sh));
    o[1] = sample(descale(tmp11 + tmp2, sh));
    o[6] = sample(descale(tmp11 - tmp2, sh));
    o[2] = sample(descale(tmp12 + tmp1, sh));
    o[5] = sample(descale(tmp12 - tmp1, sh));
    o[3] = sample(descale(tmp13 + tmp0, sh));
    o[4] = sample(descale(tmp13 - tmp0, sh));
  }
}

// The IDCT cv2 computes.  Where every column's bound (add_to_bound) stays
// below 2^14, no value the SIMD code holds in 16 bits leaves them (the
// products, the sums of two, either pass's outputs), and jidctint.c's C
// form gives its bits, as for any real image; corrupt or zero-filled data
// takes the SIMD code's 16-bit arithmetic.  deq: the dequantized
// coefficients (natural order); ac: whether a coefficient of rows 1-7 is
// nonzero before dequantization.
void idct_islow(const int32_t* deq, bool ac, const int32_t* bound,
                uint8_t* out, int64_t stride) {
  if (*std::max_element(bound, bound + 8) < (1 << 14))
    idct_islow_c(deq, out, stride);
  else
    idct_islow_simd(deq, ac, out, stride);
}

// ---------------------------------------------------------------------------
// JPEG decoding
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoff[17];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 = slow path

  void derive() {
    int32_t huffcode[257];
    uint8_t huffsize[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) {
        if (p >= 256) fail("bad Huffman table");
        huffsize[p++] = (uint8_t)l;
      }
    huffsize[p] = 0;
    int32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoff[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++)
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); c++)
          look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
    present = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;
  // jdhuff.c's insufficient_data: a bit was taken past the marker (or the
  // end) that closes the entropy-coded data; real = data bits still in acc
  // once that marker is reached.  Zeros are supplied from there on.
  bool insufficient = false;
  int real = 0;

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (p < end && *p != 0xFF) {
          b = *p++;
        } else {
          const uint8_t* q = p;
          while (q < end && *q == 0xFF) q++;  // FF and any fill bytes
          if (q > p && q < end && *q == 0x00) {
            b = 0xFF;  // a stuffed zero
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker for parse()
            real = nbits;
          }
        }
      }
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (at_marker && (real -= n) < 0) insufficient = true;
  }
  inline uint32_t get(int n) {  // n raw bits, n <= 16
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  inline int32_t receive(int s) {
    if (s == 0) return 0;
    uint32_t v = get(s);
    // F.2.2.1 EXTEND
    if (v < (1u << (s - 1))) return (int32_t)v - (1 << s) + 1;
    return (int32_t)v;
  }
  inline int decode(const HuffTable& h) {
    uint32_t look = peek(kLookBits);
    uint16_t e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    uint32_t code = peek(16);
    int l = kLookBits + 1;
    while (l <= 16 && (int32_t)(code >> (16 - l)) > h.maxcode[l]) l++;
    if (l > 16) fail("corrupt Huffman code");
    skip(l);
    return h.vals[(code >> (16 - l)) + h.valoff[l]];
  }
  // Drop the bit buffer and step over the next RSTn marker; data that ran
  // out stays out unless an RSTn was found (jdhuff.c process_restart).
  void restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    if (skip_restart_marker(p, end)) insufficient = false;
  }

  // Move p past the next RSTn marker (true), or onto the next other
  // marker.
  static bool skip_restart_marker(const uint8_t*& p, const uint8_t* end) {
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) {
        if (p[1] < 0xD0 || p[1] > 0xD7) return false;
        p += 2;
        return true;
      }
      p++;
    }
    return false;
  }
};

// jaricom.c jpeg_aritab: T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS,
// Switch_MPS) packed as libjpeg packs it, and entry 113, the fixed
// probability 0.5 of the sign and DC refinement bits.
#define V(qe, nlps, nmps, sw) \
  (((uint32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const uint32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0), V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0), V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0), V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0), V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0), V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0), V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0), V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0), V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0), V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0), V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0), V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0), V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0), V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0), V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0), V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V
constexpr uint8_t kFixedBin = 113;

// jdarith.c's decoder: the code register c (interval base and the bits not
// yet used, split at ct) and the interval size a.  ct = -16 makes the next
// decision load two bytes (each scan and restart interval starts so); ct =
// -1 marks a scan stopped at an impossible code.  Past a marker it reads
// zeros, as T.81 prescribes, and leaves p on the marker for parse().
struct ArithDecoder {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;
  static constexpr bool insufficient = false;  // zeros past a marker are
                                                // data here (T.81 D.2.6)
  int next_byte() {
    if (at_marker) return 0;
    if (p >= end) fail("truncated JPEG (no EOI)", -2);
    int d = *p++;
    if (d != 0xFF) return d;
    const uint8_t* marker = p - 1;
    do {  // swallow fill bytes
      if (p >= end) fail("truncated JPEG (no EOI)", -2);
      d = *p++;
    } while (d == 0xFF);
    if (d == 0) return 0xFF;  // a stuffed zero
    at_marker = true;
    p = marker;
    return 0;
  }
  // One binary decision with statistics bin *st (T.81 D.2.4-D.2.6).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the 2 initial bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);  // Next_Index_LPS + Switch_MPS
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);  // Next_Index_MPS
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Step over the next RSTn marker and start the decoder afresh.
  void restart() {
    at_marker = false;
    BitReader::skip_restart_marker(p, end);
    c = a = 0;
    ct = -16;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int64_t cw = 0, ch = 0;       // downsampled size
  int64_t pw = 0, ph = 0;       // plane size (whole MCUs)
  int32_t dc_pred = 0;
  int dc_context = 0;  // arithmetic coding: the DC statistics' offset
  std::vector<uint8_t> plane;
  // progressive: quantized coefficients of every block of the plane
  // (natural order), the quantization table latched at the component's
  // first scan, and how many low bits of each coefficient (zigzag order)
  // are still unknown (-1 = no scan yet; libjpeg's coef_bits)
  std::vector<int16_t> coef;
  bool latched = false;
  int32_t qlatch[64] = {0};
  int coef_bits[64];
  int prev_bits[64];  // coef_bits before the component's latest scan
  int16_t* block(int64_t bx, int64_t by) {
    return coef.data() + (by * (pw / 8) + bx) * 64;
  }
};

// Frame types of the coding modes that are not implemented (cv2 reads none
// of them): raises for them, returns for any other marker.
void refuse_sof(int m) {
  if (m == 0xC3 || m == 0xCB) fail("lossless JPEG is not supported", -2);
  if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF))
    fail("hierarchical JPEG is not supported", -2);
}

struct JpegDecoder {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int64_t mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int64_t last_good_row = 0;
  int scans = 0;
  bool have_frame = false, progressive = false, arith = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int32_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[4];
  // arithmetic coding (jdarith.c): the DAC conditioning of each table
  // (defaults L = 0, U = 1, Kx = 5, reset at SOI) and the statistics bins
  uint8_t arith_L[16], arith_U[16], arith_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = kFixedBin;

  JpegDecoder(const uint8_t* d, int64_t len) : data(d), n(len) {
    std::fill(arith_L, arith_L + 16, 0);
    std::fill(arith_U, arith_U + 16, 1);
    std::fill(arith_K, arith_K + 16, 5);
  }

  int u8() {
    if (pos >= n) fail("truncated JPEG (no EOI)", -2);
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // skip to 0xFF, past fill bytes, and over stuffed 0xFF00 pairs left
    // at the end of an entropy-coded segment
    for (;;) {
      while (pos < n && data[pos] != 0xFF) pos++;
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) fail("truncated JPEG (no EOI)", -2);
      int m = data[pos++];
      if (m != 0x00) return m;
    }
  }

  void read_sof(bool alloc, bool prog) {
    if (have_frame) fail("more than one frame in the JPEG");
    progressive = prog;
    int len = u16();
    int64_t stop = pos + len - 2;
    int precision = u8();
    if (precision != 8)
      fail("JPEG with " + std::to_string(precision) +
               "-bit samples is not supported (8-bit only)", -2);
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("JPEG with a DNL-defined height is not supported", -2);
    if (width == 0) fail("JPEG width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG with " + std::to_string(ncomp) +
           " components is not supported (1, 3 and 4 are)", -2);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad JPEG component parameters");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    if (pos != stop) fail("bad SOF length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.cw = ((int64_t)width * c.h + hmax - 1) / hmax;
      c.ch = ((int64_t)height * c.v + vmax - 1) / vmax;
      c.pw = mcux * c.h * 8;
      c.ph = mcuy * c.v * 8;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, -1);
      if (!alloc) continue;
      // a sequential block never decoded is an IDCT of zeros: mid-grey
      if (progressive) c.coef.assign((size_t)(c.pw / 8 * c.ph / 8 * 64), 0);
      else c.plane.assign((size_t)(c.pw * c.ph), 128);
    }
    have_frame = true;
  }

  void read_dqt() {
    int len = u16();
    int64_t stop = pos + len - 2;
    while (pos < stop) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT");
      for (int k = 0; k < 64; k++)
        qt[tq][kZigzag[k]] = pq ? u16() : u8();
      qt_present[tq] = true;
    }
    if (pos != stop) fail("bad DQT length");
  }

  void read_dht() {
    int len = u16();
    int64_t stop = pos + len - 2;
    while (pos < stop) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT");
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        t.bits[l] = (uint8_t)u8();
        total += t.bits[l];
      }
      if (total > 256) fail("bad DHT");
      for (int i = 0; i < total; i++) t.vals[i] = (uint8_t)u8();
      t.derive();
    }
    if (pos != stop) fail("bad DHT length");
  }

  // jdmarker.c get_dac: DC tables take L (low nibble) <= U (high nibble),
  // AC tables Kx, taken as it is (libjpeg checks no range there).
  void read_dac() {
    int len = u16();
    int64_t stop = pos + len - 2;
    while (pos < stop) {
      int index = u8(), val = u8();
      if (index >= 32) fail("bad DAC table index");
      if (index >= 16) {
        arith_K[index - 16] = (uint8_t)val;
      } else {
        arith_L[index] = (uint8_t)(val & 15);
        arith_U[index] = (uint8_t)(val >> 4);
        if (arith_L[index] > arith_U[index]) fail("bad DAC value");
      }
    }
    if (pos != stop) fail("bad DAC length");
  }

  void read_app(int marker) {
    int64_t len = u16();
    int64_t start = pos;
    if (marker == 0xE0 && len >= 7 && pos + 5 <= n &&
        std::memcmp(data + pos, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && len >= 14 && pos + 12 <= n &&
        std::memcmp(data + pos, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = start + len - 2;
  }

  // Each value kept in 16 bits (libjpeg's JCOEF), dequantized as decoded.
  void decode_block(BitReader& br, Component& c, int64_t bx, int64_t by) {
    int32_t deq[64], bound[8] = {0};
    std::memset(deq, 0, sizeof(deq));
    const int32_t* q = qt[c.tq];
    int t = br.decode(dc[c.td]);
    if (t > 16) fail("corrupt DC coefficient");
    c.dc_pred += br.receive(t);
    deq[0] = (int16_t)c.dc_pred * q[0];
    add_to_bound(bound, 0, deq[0]);
    bool rows_ac = false;
    const HuffTable& ha = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        const int nat = kZigzag[k];
        const int16_t v = (int16_t)br.receive(s);
        deq[nat] = v * q[nat];
        add_to_bound(bound, nat, deq[nat]);
        rows_ac |= nat >= 8 && v != 0;
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(deq, rows_ac, bound, c.plane.data() + by * 8 * c.pw + bx * 8,
               c.pw);
  }

  // Inverse-transform blk (natural order, quantized with q) into block
  // (bx, by) of c's plane.
  static void idct_block(const int16_t* blk, const int32_t* q, Component& c,
                         int64_t bx, int64_t by) {
    int32_t deq[64], bound[8];
    int rows = 0;  // any coefficient of rows 1-7
    for (int k = 0; k < 64; k++) deq[k] = blk[k] * q[k];
    for (int k = 0; k < 8; k++) bound[k] = 4 * std::abs(deq[k]);
    for (int k = 8; k < 64; k++) {
      bound[k & 7] += 6 * std::abs(deq[k]);
      rows |= blk[k];
    }
    idct_islow(deq, rows != 0, bound, c.plane.data() + by * 8 * c.pw + bx * 8,
               c.pw);
  }

  // Run fn(block column, block row, component) over a scan's blocks, MCU
  // by MCU, with the restart interval: a single-component scan covers the
  // component's own ceil(cw/8) x ceil(ch/8) blocks, an interleaved one
  // whole MCUs.  on_restart runs after each RSTn.  An MCU that starts
  // after the data ran out is skipped, its blocks left as they are, and
  // last_good_row keeps the iMCU row of the last MCU that started with
  // data (jdhuff.c / jdphuff.c insufficient_data, jdcoefct.c
  // last_good_iMCU_row).
  template <class Reader, class Fn, class Restart>
  void for_each_block(Reader& br, Component** sc, int ns, Fn fn,
                      Restart on_restart) {
    auto mcu = [&](int64_t imcu_row) {
      if (br.insufficient) return false;
      last_good_row = imcu_row;
      return true;
    };
    int64_t todo = restart_interval;
    auto maybe_restart = [&](bool last) {
      if (!restart_interval || last) return;
      if (--todo == 0) {
        br.restart();
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        on_restart();
        todo = restart_interval;
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      int64_t bw = (c.cw + 7) / 8, bh = (c.ch + 7) / 8;
      for (int64_t by = 0; by < bh; by++)
        for (int64_t bx = 0; bx < bw; bx++) {
          if (mcu(by / c.v)) fn(bx, by, c);
          maybe_restart(by == bh - 1 && bx == bw - 1);
        }
    } else {
      for (int64_t my = 0; my < mcuy; my++)
        for (int64_t mx = 0; mx < mcux; mx++) {
          if (mcu(my))
            for (int i = 0; i < ns; i++) {
              Component& c = *sc[i];
              for (int yy = 0; yy < c.v; yy++)
                for (int xx = 0; xx < c.h; xx++)
                  fn(mx * c.h + xx, my * c.v + yy, c);
            }
          maybe_restart(my == mcuy - 1 && mx == mcux - 1);
        }
    }
  }

  void read_sos() {
    if (!have_frame) fail("SOS before SOF");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad SOS");
    Component* sc[4];
    const int ntables = arith ? 16 : 4;  // NUM_ARITH_TBLS, NUM_HUFF_TBLS
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tdta = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) fail("SOS names an unknown component");
      sc[i]->td = tdta >> 4;
      sc[i]->ta = tdta & 15;
      if (sc[i]->td >= ntables || sc[i]->ta >= ntables)
        fail("SOS uses a missing entropy-coding table");
      if (!qt_present[sc[i]->tq]) fail("component uses a missing DQT table");
      sc[i]->dc_pred = 0;
    }
    int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    scans++;
    if (progressive) start_progressive_scan(sc, ns, ss, se, ah, al);
    else if (ss != 0 || se != 63 || ahal != 0) fail("bad sequential scan");
    if (arith) {
      ArithDecoder ad{data + pos, data + n};
      arith_scan(ad, sc, ns, ss, se, ah, al);
      pos = ad.p - data;  // on the marker that ended the scan, if it was read
      return;
    }
    BitReader br{data + pos, data + n};
    if (progressive) {
      progressive_scan(br, sc, ns, ss, se, ah, al);
    } else {
      for (int i = 0; i < ns; i++)
        if (!dc[sc[i]->td].present || !ac[sc[i]->ta].present)
          fail("SOS uses a missing Huffman table");
      for_each_block(
          br, sc, ns,
          [&](int64_t bx, int64_t by, Component& c) {
            decode_block(br, c, bx, by);
          },
          [] {});
    }
    pos = br.p - data;  // the next marker search starts here
  }

  // A progressive scan's checks (jdphuff.c and jdarith.c start_pass), the
  // quantization table latched at each component's first scan (jdinput.c
  // latch_quant_tables) and the low bits the scan leaves unknown.  libjpeg
  // only warns about a scan order that skips or repeats bits; so does
  // nothing here.
  void start_progressive_scan(Component** sc, int ns, int ss, int se, int ah,
                              int al) {
    const bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail("bad progressive scan parameters");
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {
        std::memcpy(c.qlatch, qt[c.tq], sizeof(c.qlatch));
        c.latched = true;
      }
      for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
        c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
  }

  // One progressive Huffman scan into the coefficient buffers (jdphuff.c
  // decode_mcu_DC_first, decode_mcu_DC_refine, decode_mcu_AC_first or
  // decode_mcu_AC_refine).
  void progressive_scan(BitReader& br, Component** sc, int ns, int ss, int se,
                        int ah, int al) {
    const bool dc_band = ss == 0;
    for (int i = 0; i < ns; i++) {
      const Component& c = *sc[i];
      if (dc_band ? (ah == 0 && !dc[c.td].present) : !ac[c.ta].present)
        fail("SOS uses a missing Huffman table");
    }
    const int p1 = 1 << al, m1 = -p1;
    int eobrun = 0;
    auto reset = [&] { eobrun = 0; };
    // a coefficient already nonzero gains its next bit (AC refinement)
    auto refine = [&](int16_t* t) {
      if (br.get(1) && (*t & p1) == 0) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
    };
    if (dc_band && ah == 0) {
      for_each_block(br, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        int t = br.decode(dc[c.td]);
        if (t > 16) fail("corrupt DC coefficient");
        c.dc_pred += br.receive(t);
        c.block(bx, by)[0] = (int16_t)((uint32_t)c.dc_pred << al);
      }, reset);
    } else if (dc_band) {
      for_each_block(br, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (br.get(1)) c.block(bx, by)[0] = (int16_t)(c.block(bx, by)[0] | p1);
      }, reset);
    } else if (ah == 0) {
      for_each_block(br, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        int16_t* blk = c.block(bx, by);
        const HuffTable& ha = ac[c.ta];
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(ha);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kZigzag[k]] = (int16_t)((uint32_t)br.receive(s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) + (int)br.get(r) - 1;
            break;
          }
        }
      }, reset);
    } else {
      for_each_block(br, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        int16_t* blk = c.block(bx, by);
        const HuffTable& ha = ac[c.ta];
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; k++) {
            int rs = br.decode(ha);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br.get(1) ? p1 : m1;  // libjpeg warns if the size is not 1
            } else if (r != 15) {
              eobrun = (1 << r) + (int)br.get(r);
              break;
            }
            // skip r zero-history coefficients, refining nonzero ones
            do {
              int16_t* t = blk + kZigzag[k];
              if (*t != 0) refine(t);
              else if (--r < 0) break;
              k++;
            } while (k <= se);
            if (s) blk[kZigzag[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; k++) {
            int16_t* t = blk + kZigzag[k];
            if (*t != 0) refine(t);
          }
          eobrun--;
        }
      }, reset);
    }
  }

  // ---- arithmetic coding (jdarith.c) ----

  // Figures F.19 and F.21-F.24: one DC difference, added to c.dc_pred
  // modulo 2^16; false at an impossible magnitude.
  bool arith_dc(ArithDecoder& ad, Component& c) {
    uint8_t* const stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (ad.decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m) {
      st = stats + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ad.ct = -1;
          return false;
        }
        st++;
      }
    }
    // F.1.4.4.1.2: the next difference's conditioning from this one's size
    if (m < ((1 << arith_L[c.td]) >> 1)) c.dc_context = 0;
    else if (m > ((1 << arith_U[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    c.dc_pred = (c.dc_pred + (sign ? -v : v)) & 0xffff;
    return true;
  }

  // Figure F.20: the AC coefficients ss..se of one block, each nonzero one
  // passed to store(k, value); a run or magnitude past its end stops the
  // scan (ct = -1).
  template <class Store>
  void arith_ac(ArithDecoder& ad, int tbl, int ss, int se, Store store) {
    uint8_t* const stats = ac_stats[tbl];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ad.decode(st)) return;  // end of block
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ad.ct = -1;
          return;
        }
      }
      const int sign = ad.decode(&fixed_bin);
      st += 2;
      int m = ad.decode(st);
      if (m && ad.decode(st)) {
        m <<= 1;
        st = stats + (k <= arith_K[tbl] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ad.ct = -1;
            return;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ad.decode(st)) v |= m;
      v += 1;
      store(k, sign ? -v : v);
    }
  }

  // One arithmetic-coded scan (jdarith.c start_pass, then decode_mcu or
  // the progressive decode_mcu_DC_first, _DC_refine, _AC_first or
  // _AC_refine).  Statistics and DC predictions start afresh at the scan
  // and at each restart.  An impossible code stops decoding until the next
  // restart marker, as libjpeg's ct = -1 does, and cv2 returns the image
  // all the same: the blocks not reached keep what they had (in a
  // sequential scan, zero coefficients).
  void arith_scan(ArithDecoder& ad, Component** sc, int ns, int ss, int se,
                  int ah, int al) {
    const bool dc_stats_used = !progressive || (ss == 0 && ah == 0);
    const bool ac_stats_used = !progressive || ss != 0;
    auto reset = [&] {
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        if (dc_stats_used) {
          std::memset(dc_stats[c.td], 0, sizeof(dc_stats[0]));
          c.dc_pred = 0;
          c.dc_context = 0;
        }
        if (ac_stats_used) std::memset(ac_stats[c.ta], 0, sizeof(ac_stats[0]));
      }
    };
    reset();
    const int p1 = 1 << al, m1 = -p1;
    if (!progressive) {
      for_each_block(ad, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        int16_t blk[64] = {0};
        if (ad.ct != -1 && arith_dc(ad, c)) {
          blk[0] = (int16_t)c.dc_pred;
          arith_ac(ad, c.ta, 1, 63,
                   [&](int k, int v) { blk[kZigzag[k]] = (int16_t)v; });
        }
        idct_block(blk, qt[c.tq], c, bx, by);
      }, reset);
    } else if (ss == 0 && ah == 0) {
      for_each_block(ad, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (ad.ct != -1 && arith_dc(ad, c))
          c.block(bx, by)[0] = (int16_t)((uint32_t)c.dc_pred << al);
      }, reset);
    } else if (ss == 0) {  // the next bit of each DC, at probability 0.5
      for_each_block(ad, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (ad.decode(&fixed_bin))
          c.block(bx, by)[0] = (int16_t)(c.block(bx, by)[0] | p1);
      }, reset);
    } else if (ah == 0) {
      for_each_block(ad, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (ad.ct == -1) return;
        int16_t* blk = c.block(bx, by);
        arith_ac(ad, c.ta, ss, se, [&](int k, int v) {
          blk[kZigzag[k]] = (int16_t)((uint32_t)v << al);
        });
      }, reset);
    } else {
      for_each_block(ad, sc, ns, [&](int64_t bx, int64_t by, Component& c) {
        if (ad.ct == -1) return;
        int16_t* blk = c.block(bx, by);
        uint8_t* const stats = ac_stats[c.ta];
        int kex = se;  // the previous stages' end of block
        while (kex > 0 && !blk[kZigzag[kex]]) kex--;
        for (int k = ss; k <= se; k++) {
          uint8_t* st = stats + 3 * (k - 1);
          if (k > kex && ad.decode(st)) return;  // end of block
          for (;;) {
            int16_t* t = blk + kZigzag[k];
            if (*t) {  // nonzero before: its correction bit
              if (ad.decode(st + 2)) *t = (int16_t)(*t + (*t < 0 ? m1 : p1));
              break;
            }
            if (ad.decode(st + 1)) {  // newly nonzero
              *t = (int16_t)(ad.decode(&fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              ad.ct = -1;
              return;
            }
          }
        }
      }, reset);
    }
  }

  // ---- the output of a progressive file ----

  // As jdcoefct.c's output pass sees the coefficient buffer in cv2's
  // non-buffered decode, where jpeg_start_decompress has absorbed the whole
  // file first: every block dequantized with its latched table and
  // inverse-transformed (decompress_data), after block smoothing where
  // smoothing_ok allows it.
  void finish_progressive() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.plane.assign((size_t)(c.pw * c.ph), 0);
      if (smooth) {
        smooth_component(c);
      } else {
        for (int64_t by = 0; by < c.ph / 8; by++)
          for (int64_t bx = 0; bx < c.pw / 8; bx++)
            idct_block(c.block(bx, by), c.qlatch, c, bx, by);
      }
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // jdcoefct.c smoothing_ok (SAVED_COEFS = 10): every component has its
  // table latched with nonzero Q for the DC and AC 1-9 (zigzag order) and
  // its DC at least partly known, and some component still lacks bits of
  // one of those 9 AC coefficients.
  bool smoothing_ok() const {
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int k = 0; k < 10; k++)
        if (c.qlatch[kZigzag[k]] == 0) return false;
      for (int k = 1; k < 10; k++) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data as libjpeg-turbo has it since 2.1:
  // in each block, on the quantized coefficients, each of AC 1-9 that is
  // zero and not fully known is estimated from the DC values of the 5x5
  // blocks around it (Q-weighted, rounded as libjpeg rounds, clamped below
  // 2^Al); where no AC bit at all is known (only DC scans so far), AC 6-9
  // and the DC itself too, with a Gaussian-like kernel.  The window clamps
  // at the component's first and last block column; its rows clamp as
  // libjpeg's iMCU-row bookkeeping does, which reckons with the last iMCU
  // row's block count for every row and so may reach MCU padding rows or
  // clamp early.  Rows past the last one a scan reached with data (a file
  // cut inside a scan) take the bits known before the component's latest
  // scan.  cv2 decodes without buffered-image mode: the whole file has
  // been read, so no other scan is in progress.
  void smooth_component(Component& c) {
    int latch[10], prev_latch[10];
    for (int k = 0; k < 10; k++) {
      latch[k] = c.coef_bits[k];
      prev_latch[k] = scans > 1 ? c.prev_bits[k] : -1;
    }
    const int32_t* q = c.qlatch;
    const int64_t Q00 = q[0];
    const int64_t wib = (c.cw + 7) / 8, hib = (c.ch + 7) / 8, total = mcuy;
    int16_t ws[64];
    int64_t d[26];  // libjpeg's DC01..DC25, the 5x5 window row by row
    const int* bits = latch;
    // the estimate of coefficient zz (natural position nat) from sum
    auto estimate = [&](int zz, int64_t sum) {
      const int nat = kZigzag[zz], al = bits[zz];
      if (al == 0 || ws[nat] != 0) return;
      const int64_t qk = q[nat], num = Q00 * sum;
      int pred = (int)(((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      ws[nat] = (int16_t)(num >= 0 ? pred : -pred);
    };
    for (int64_t r = 0; r < total; r++) {
      bits = r > last_good_row ? prev_latch : latch;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
      int block_rows = c.v;
      if (r == total - 1 && hib % c.v) block_rows = (int)(hib % c.v);
      const int64_t image_rows = block_rows * total;
      for (int b = 0; b < block_rows; b++) {
        const int64_t ib = r * block_rows + b, y = r * c.v + b;
        int64_t rows[5];
        rows[2] = y;
        rows[1] = ib > 0 ? y - 1 : y;
        rows[0] = ib > 1 ? y - 2 : rows[1];
        rows[3] = ib < image_rows - 1 ? y + 1 : y;
        rows[4] = ib < image_rows - 2 ? y + 2 : rows[3];
        for (int64_t x = 0; x < wib; x++) {
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 5; j++) {
              int64_t xx = std::min(std::max(x + j - 2, (int64_t)0), wib - 1);
              d[1 + i * 5 + j] = c.block(xx, rows[i])[0];
            }
          std::memcpy(ws, c.block(x, y), sizeof(ws));
          if (change_dc) {
            estimate(1, -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] -
                            13 * d[9] + 3 * d[10] - 3 * d[11] + 38 * d[12] -
                            38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                            13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] +
                            d[25]);
            estimate(2, -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] +
                            13 * d[7] + 38 * d[8] + 13 * d[9] - d[10] +
                            d[16] - 13 * d[17] - 38 * d[18] - 13 * d[19] +
                            d[20] + d[21] + 3 * d[22] + 3 * d[23] +
                            3 * d[24] + d[25]);
            estimate(3, d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] -
                            14 * d[13] - 5 * d[14] + 2 * d[17] + 7 * d[18] +
                            2 * d[19] + d[23]);
            estimate(4, -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] +
                            9 * d[19] + d[21] - d[25]);
            estimate(5, 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] -
                            14 * d[13] + 7 * d[14] + d[15] + 2 * d[17] -
                            5 * d[18] + 2 * d[19]);
            estimate(6, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
            estimate(7, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
            estimate(8, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
            estimate(9, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
            const int64_t num =
                Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] -
                       6 * d[6] + 6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] -
                       8 * d[11] + 42 * d[12] + 152 * d[13] + 42 * d[14] -
                       8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] +
                       6 * d[19] - 6 * d[20] - 2 * d[21] - 6 * d[22] -
                       8 * d[23] - 6 * d[24] - 2 * d[25]);
            const int pred =
                (int)(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
            ws[0] = (int16_t)(num >= 0 ? pred : -pred);
          } else {
            estimate(1, -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
            estimate(2, -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
            estimate(3, -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
            estimate(4, d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] -
                            d[20] + d[22] - d[24] + d[4] - d[6] + 10 * d[7] -
                            10 * d[9]);
            estimate(5, -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
          }
          idct_block(ws, q, c, x, y);
        }
      }
    }
  }

  void parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                       // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;       // stray RSTn
      if (m == 0x01) continue;                    // TEM
      switch (m) {
        case 0xC0: case 0xC1: read_sof(true, false); break;
        case 0xC2: read_sof(true, true); break;
        case 0xC9: arith = true; read_sof(true, false); break;
        case 0xCA: arith = true; read_sof(true, true); break;
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (u16() != 4) fail("bad DRI");
          restart_interval = u16();
          break;
        case 0xDA: read_sos(); break;
        default:
          refuse_sof(m);
          if (m >= 0xE0 && m <= 0xEF) read_app(m);
          else if (m == 0xFE || m == 0xDC || m == 0xDE || m == 0xDF)
            pos += u16() - 2;
          else
            fail("unknown JPEG marker");
      }
    }
    if (!have_frame) fail("JPEG without a frame");
    if (progressive) finish_progressive();
  }
  // Full-resolution plane of component c (width x height), libjpeg's
  // upsampling: fancy (triangular) for h2v1, h2v2 and h1v2, box otherwise.
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> out((size_t)width * height);
    const int fx = hmax / c.h, fy = vmax / c.v;
    if (hmax % c.h || vmax % c.v) fail("unsupported JPEG sampling factors");
    const uint8_t* pl = c.plane.data();
    const int64_t pw = c.pw, cw = c.cw, ch = c.ch;
    auto in_row = [&](int64_t r) {
      if (r < 0) r = 0;
      if (r > ch - 1) r = ch - 1;
      return pl + r * pw;
    };
    std::vector<uint8_t> row((size_t)(2 * cw + 2));
    if (fx == 1 && fy == 1) {
      for (int64_t y = 0; y < height; y++)
        std::memcpy(&out[y * width], pl + y * pw, width);
    } else if (fx == 2 && fy == 1 && cw > 2) {
      for (int64_t y = 0; y < height; y++) {
        const uint8_t* in = pl + y * pw;
        uint8_t* o = row.data();
        int iv = in[0];
        *o++ = (uint8_t)iv;
        *o++ = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
        for (int64_t x = 1; x < cw - 1; x++) {
          iv = in[x] * 3;
          *o++ = (uint8_t)((iv + in[x - 1] + 1) >> 2);
          *o++ = (uint8_t)((iv + in[x + 1] + 2) >> 2);
        }
        iv = in[cw - 1];
        *o++ = (uint8_t)((iv * 3 + in[cw - 2] + 1) >> 2);
        *o++ = (uint8_t)iv;
        std::memcpy(&out[y * width], row.data(), width);
      }
    } else if (fx == 2 && fy == 2 && cw > 2) {
      for (int64_t y = 0; y < height; y++) {
        int64_t r = y >> 1;
        const uint8_t* in0 = in_row(r);
        const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
        uint8_t* o = row.data();
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int64_t x = 2; x < cw; x++) {
          nextcol = in0[x] * 3 + in1[x];
          *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
        std::memcpy(&out[y * width], row.data(), width);
      }
    } else if (fx == 1 && fy == 2) {
      for (int64_t y = 0; y < height; y++) {
        int64_t r = y >> 1;
        const uint8_t* in0 = in_row(r);
        const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int64_t x = 0; x < width; x++)
          out[y * width + x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else {
      for (int64_t y = 0; y < height; y++) {
        const uint8_t* in = pl + (y / fy) * pw;
        for (int64_t x = 0; x < width; x++) out[y * width + x] = in[x / fx];
      }
    }
    return out;
  }

  void to_rgb(uint8_t* out) const {
    const int64_t npx = (int64_t)width * height;
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int64_t y = 0; y < height; y++)
        for (int64_t x = 0; x < width; x++) {
          uint8_t g = c.plane[y * c.pw + x];
          uint8_t* o = out + 3 * (y * width + x);
          o[0] = o[1] = o[2] = g;
        }
      return;
    }
    std::vector<uint8_t> p0 = upsample(comp[0]);
    std::vector<uint8_t> p1 = upsample(comp[1]);
    std::vector<uint8_t> p2 = upsample(comp[2]);
    // jdapimin.c default_decompress_parms: the colour space
    bool ycc;
    if (ncomp == 4) ycc = saw_adobe && adobe_transform != 0;  // YCCK
    else if (saw_jfif) ycc = true;
    else if (saw_adobe) ycc = adobe_transform != 0;
    else ycc = !(comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
    // jdcolor.c build_ycc_rgb_table
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    if (ycc) {  // ycc_rgb_convert, or the first step of ycck_cmyk_convert
      for (int64_t i = 0; i < npx; i++) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        p0[i] = clamp255(y + cr_r[cr]);
        p1[i] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        p2[i] = clamp255(y + cb_b[cb]);
        if (ncomp == 4) {
          p0[i] = (uint8_t)(255 - p0[i]);
          p1[i] = (uint8_t)(255 - p1[i]);
          p2[i] = (uint8_t)(255 - p2[i]);
        }
      }
    }
    if (ncomp == 3) {
      for (int64_t i = 0; i < npx; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // CMYK as libjpeg hands it over, to cv2's colour
    // (imgcodecs/src/utils.cpp icvCvt_CMYK2BGR_8u_C4C3R, channels reversed)
    std::vector<uint8_t> p3 = upsample(comp[3]);
    for (int64_t i = 0; i < npx; i++) {
      int k = p3[i];
      out[3 * i] = (uint8_t)(k - (((255 - p0[i]) * k) >> 8));
      out[3 * i + 1] = (uint8_t)(k - (((255 - p1[i]) * k) >> 8));
      out[3 * i + 2] = (uint8_t)(k - (((255 - p2[i]) * k) >> 8));
    }
  }
};

// ---------------------------------------------------------------------------
// JPEG encoding (libjpeg's defaults: 4:2:0, islow DCT, Annex K tables)
// ---------------------------------------------------------------------------

const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int p = 0;
    uint16_t c = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) put(0x7F, 7);  // pad with ones
    nbits = 0;
  }
};

// jfdctint.c jpeg_fdct_islow (output scaled up by 8)
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + r * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int32_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int32_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int32_t)descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

void scale_quant(const int* base, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = (int)t;
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void write_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits,
               const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; l++) total += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + total);
  o.push_back((uint8_t)tc_th);
  for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
  for (int i = 0; i < total; i++) o.push_back(vals[i]);
}

inline int nbits_of(int v) {
  if (v < 0) v = -v;
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

// Forward DCT and quantization of one block (jcdctmgr.c, islow divisors
// q << 3); zz receives the coefficients in zigzag order.
void quantize_block(int32_t* blk, const int* q, int32_t* zz) {
  fdct_islow(blk);
  for (int k = 0; k < 64; k++) {
    int nat = kZigzag[k];
    int32_t qval = q[nat] << 3;
    int32_t t = blk[nat];
    if (t < 0) {
      t = -t + (qval >> 1);
      t = t >= qval ? -(t / qval) : 0;
    } else {
      t += qval >> 1;
      t = t >= qval ? t / qval : 0;
    }
    zz[k] = t;
  }
}

void emit_block(BitWriter& bw, const int32_t* zz, int& pred,
                const EncTable& dct, const EncTable& act) {
  int diff = zz[0] - pred;
  pred = zz[0];
  int s = nbits_of(diff);
  bw.put(dct.code[s], dct.size[s]);
  if (s) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = zz[k];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    s = nbits_of(v);
    int rs = (run << 4) | s;
    bw.put(act.code[rs], act.size[rs]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run > 0) bw.put(act.code[0], act.size[0]);
}

// Edge-replicated copy of src [h, w] into [ph, pw].
std::vector<uint8_t> pad_plane(const std::vector<uint8_t>& src, int64_t w,
                               int64_t h, int64_t pw, int64_t ph) {
  std::vector<uint8_t> out((size_t)(pw * ph));
  for (int64_t y = 0; y < ph; y++) {
    const uint8_t* in = src.data() + (y < h ? y : h - 1) * w;
    uint8_t* o = out.data() + y * pw;
    std::memcpy(o, in, (size_t)(w < pw ? w : pw));
    for (int64_t x = w; x < pw; x++) o[x] = in[w - 1];
  }
  return out;
}

void encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                 std::vector<uint8_t>& o) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535)
    fail("JPEG size out of range");
  int ql[64], qc[64];
  scale_quant(kStdLuma, quality, ql);
  scale_quant(kStdChroma, quality, qc);

  // jccolor.c rgb_ycc_convert
  constexpr int SB = 16;
  constexpr int64_t HALF = (int64_t)1 << (SB - 1);
  constexpr int64_t CBCR_OFF = (int64_t)128 << SB;
  auto fix = [](double x) { return (int64_t)(x * (1L << SB) + 0.5); };
  int64_t ry[256], gy[256], by_[256], rcb[256], gcb[256], bcb[256], gcr[256],
      bcr[256];
  for (int i = 0; i < 256; i++) {
    ry[i] = fix(0.29900) * i;
    gy[i] = fix(0.58700) * i;
    by_[i] = fix(0.11400) * i + HALF;
    rcb[i] = -fix(0.16874) * i;
    gcb[i] = -fix(0.33126) * i;
    bcb[i] = fix(0.50000) * i + CBCR_OFF + HALF - 1;  // also R -> Cr
    gcr[i] = -fix(0.41869) * i;
    bcr[i] = -fix(0.08131) * i;
  }
  const int64_t npx = (int64_t)w * h;
  std::vector<uint8_t> Y(npx), Cb(npx), Cr(npx);
  for (int64_t i = 0; i < npx; i++) {
    int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    Y[i] = (uint8_t)((ry[r] + gy[g] + by_[b]) >> SB);
    Cb[i] = (uint8_t)((rcb[r] + gcb[g] + bcb[b]) >> SB);
    Cr[i] = (uint8_t)((bcb[r] + gcr[g] + bcr[b]) >> SB);
  }
  // libjpeg's edge handling: luma blocks ceil(w/8) x ceil(h/8) over
  // edge-replicated samples, MCU slots past them are dummy blocks (zero
  // AC, the DC of the block before); chroma from the full-resolution planes
  // replicated to whole 2x2 groups, downsampled by jcsample.c's
  // h2v2_downsample (2x2 box, alternating 1, 2 bias), then its last row
  // replicated to whole blocks.
  const int64_t mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int64_t ybw = (w + 7) / 8, ybh = (h + 7) / 8;
  std::vector<uint8_t> Yp = pad_plane(Y, w, h, ybw * 8, mcuy * 16);
  const int64_t cw = (w + 1) / 2, ch = (h + 1) / 2;
  const int64_t cpw = mcux * 8, cph = mcuy * 8;
  std::vector<uint8_t> Cbf = pad_plane(Cb, w, h, cpw * 2, ch * 2);
  std::vector<uint8_t> Crf = pad_plane(Cr, w, h, cpw * 2, ch * 2);
  std::vector<uint8_t> Cbs((size_t)(cpw * ch)), Crs((size_t)(cpw * ch));
  for (int64_t y = 0; y < ch; y++) {
    int bias = 1;
    for (int64_t x = 0; x < cpw; x++) {
      int64_t i0 = (2 * y) * (cpw * 2) + 2 * x, i1 = i0 + cpw * 2;
      Cbs[y * cpw + x] =
          (uint8_t)((Cbf[i0] + Cbf[i0 + 1] + Cbf[i1] + Cbf[i1 + 1] + bias) >> 2);
      Crs[y * cpw + x] =
          (uint8_t)((Crf[i0] + Crf[i0 + 1] + Crf[i1] + Crf[i1 + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
  Cbs = pad_plane(Cbs, cpw, ch, cpw, cph);
  Crs = pad_plane(Crs, cpw, ch, cpw, cph);
  (void)cw;

  // headers: SOI, JFIF APP0, DQT x2, SOF0, DHT x4, SOS
  o.clear();
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                              'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                              0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
  for (int t = 0; t < 2; t++) {
    const int* q = t ? qc : ql;
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_u16(o, 67);
    o.push_back((uint8_t)t);
    for (int k = 0; k < 64; k++) o.push_back((uint8_t)q[kZigzag[k]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put_u16(o, 17);
  o.push_back(8);
  put_u16(o, h);
  put_u16(o, w);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  write_dht(o, 0x00, kDcLumaBits, kDcVals);
  write_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(o, 0x01, kDcChromaBits, kDcVals);
  write_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  static const EncTable dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
  static const EncTable dcc(kDcChromaBits, kDcVals),
      acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int pred_y = 0, pred_cb = 0, pred_cr = 0;
  int32_t blk[64];
  int32_t zz[4][64];
  auto load = [&](const std::vector<uint8_t>& pl, int64_t stride, int64_t x0,
                  int64_t y0) {
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++)
        blk[r * 8 + c] = (int32_t)pl[(y0 + r) * stride + x0 + c] - 128;
  };
  for (int64_t my = 0; my < mcuy; my++)
    for (int64_t mx = 0; mx < mcux; mx++) {
      for (int yy = 0; yy < 2; yy++)
        for (int xx = 0; xx < 2; xx++) {
          int32_t* z = zz[yy * 2 + xx];
          int64_t bx = mx * 2 + xx, by = my * 2 + yy;
          if (by < ybh && bx < ybw) {
            load(Yp, ybw * 8, bx * 8, by * 8);
            quantize_block(blk, ql, z);
          } else {
            std::memset(z, 0, 64 * sizeof(int32_t));
            z[0] = zz[yy * 2 + xx - 1][0];  // left block, or row above's last
          }
          emit_block(bw, z, pred_y, dcl, acl);
        }
      load(Cbs, cpw, mx * 8, my * 8);
      quantize_block(blk, qc, zz[0]);
      emit_block(bw, zz[0], pred_cb, dcc, acc);
      load(Crs, cpw, mx * 8, my * 8);
      quantize_block(blk, qc, zz[0]);
      emit_block(bw, zz[0], pred_cr, dcc, acc);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

// ---------------------------------------------------------------------------
// INTER_AREA at fractional ratios
// ---------------------------------------------------------------------------

struct AreaTab {
  int64_t di, si;
  float alpha;
};

// cv2's computeResizeAreaTab: the source samples of each destination
// sample and their overlap weights, in order.
std::vector<AreaTab> area_tab(int64_t ssize, int64_t dsize, int cn,
                              double scale) {
  std::vector<AreaTab> tab;
  for (int64_t dx = 0; dx < dsize; dx++) {
    double fsx1 = dx * scale;
    double fsx2 = fsx1 + scale;
    double cell = std::min(scale, ssize - fsx1);
    int64_t sx1 = (int64_t)std::ceil(fsx1), sx2 = (int64_t)std::floor(fsx2);
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3)
      tab.push_back({dx * cn, (sx1 - 1) * cn, (float)((sx1 - fsx1) / cell)});
    for (int64_t sx = sx1; sx < sx2; sx++)
      tab.push_back({dx * cn, sx * cn, (float)(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx * cn, sx2 * cn,
                     (float)(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

inline uint8_t saturate_u8(float v) {
  long iv = std::lrintf(v);  // cvRound: half to even
  return (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
}

}  // namespace

extern "C" {

// cv2.resize(src, (dw, dh), interpolation=INTER_AREA) for uint8 [sh, sw,
// cn] shrunk on both axes at a fractional ratio (ResizeArea_Invoker over
// every row).
void image_ops_resize_area(const uint8_t* src, int64_t sh, int64_t sw,
                           int cn, uint8_t* dst, int64_t dh, int64_t dw) {
  const double scale_x = 1.0 / ((double)dw / sw);
  const double scale_y = 1.0 / ((double)dh / sh);
  std::vector<AreaTab> xtab = area_tab(sw, dw, cn, scale_x);
  std::vector<AreaTab> ytab = area_tab(sh, dh, 1, scale_y);
  const int64_t width = dw * cn;
  std::vector<float> buf(width), sum(width, 0.0f);
  int64_t prev_dy = ytab[0].di;
  for (const AreaTab& y : ytab) {
    const uint8_t* S = src + y.si * sw * cn;
    std::fill(buf.begin(), buf.end(), 0.0f);
    for (const AreaTab& x : xtab)
      for (int c = 0; c < cn; c++) buf[x.di + c] += S[x.si + c] * x.alpha;
    if (y.di != prev_dy) {
      uint8_t* D = dst + prev_dy * width;
      for (int64_t i = 0; i < width; i++) {
        D[i] = saturate_u8(sum[i]);
        sum[i] = y.alpha * buf[i];
      }
      prev_dy = y.di;
    } else {
      for (int64_t i = 0; i < width; i++) sum[i] += y.alpha * buf[i];
    }
  }
  uint8_t* D = dst + prev_dy * width;
  for (int64_t i = 0; i < width; i++) D[i] = saturate_u8(sum[i]);
}

// cv2.resize(src, (dw, dh), interpolation=INTER_AREA) for uint8 [sh, sw,
// cn] where either axis grows: imgproc/resize.cpp cv::hal::resize takes the
// linear kernel with area coefficients there (area_mode: sx = floor(dx *
// scale), fx = (dx + 1) - (sx + 1) / scale, fx <= 0 ? 0 : fx - floor(fx)),
// in fixed point with INTER_RESIZE_COEF_BITS = 11: HResizeLinear's integer
// row pass, then VResizeLinear<uchar, int, short, ...>, whose scalar tail
// rounds as its vector body (VResizeLinearVec_32s8u) does.
void image_ops_resize_linear_area(const uint8_t* src, int64_t sh, int64_t sw,
                                  int cn, uint8_t* dst, int64_t dh,
                                  int64_t dw) {
  constexpr int ONE = 1 << 11;
  auto coefs = [](int64_t ssize, int64_t dsize, std::vector<int64_t>& ofs,
                  std::vector<int32_t>& a, bool clamp_last) {
    const double inv = (double)dsize / ssize, scale = 1.0 / inv;
    int64_t lim = dsize;  // from here on, one source sample (xmax)
    for (int64_t d = 0; d < dsize; d++) {
      int64_t s = (int64_t)std::floor(d * scale);
      float f = (float)((d + 1) - (s + 1) * inv);
      f = f <= 0 ? 0.f : f - std::floor(f);
      if (clamp_last && s + 1 >= ssize) {
        lim = std::min(lim, d);
        f = 0.f;
        s = ssize - 1;
      }
      ofs[d] = s;
      a[2 * d] = (int32_t)std::lrintf((1.f - f) * ONE);
      a[2 * d + 1] = (int32_t)std::lrintf(f * ONE);
    }
    return lim;
  };
  std::vector<int64_t> xofs(dw), yofs(dh);
  std::vector<int32_t> alpha(2 * dw), beta(2 * dh);
  const int64_t xmax = coefs(sw, dw, xofs, alpha, true);
  coefs(sh, dh, yofs, beta, false);
  const int64_t width = dw * cn;
  std::vector<int32_t> rows((size_t)(sh * width));  // HResizeLinear
  for (int64_t y = 0; y < sh; y++) {
    const uint8_t* S = src + y * sw * cn;
    int32_t* D = rows.data() + y * width;
    for (int64_t dx = 0; dx < dw; dx++) {
      const uint8_t* s0 = S + xofs[dx] * cn;
      for (int c = 0; c < cn; c++)
        D[dx * cn + c] = dx < xmax ? s0[c] * alpha[2 * dx] +
                                         s0[c + cn] * alpha[2 * dx + 1]
                                   : s0[c] * ONE;
    }
  }
  for (int64_t dy = 0; dy < dh; dy++) {  // VResizeLinear, uchar
    const int64_t y0 = std::min(std::max(yofs[dy], (int64_t)0), sh - 1);
    const int64_t y1 = std::min(std::max(yofs[dy] + 1, (int64_t)0), sh - 1);
    const int32_t *S0 = rows.data() + y0 * width, *S1 = rows.data() + y1 * width;
    const int32_t b0 = beta[2 * dy], b1 = beta[2 * dy + 1];
    uint8_t* D = dst + dy * width;
    for (int64_t x = 0; x < width; x++)
      D[x] = clamp255((((b0 * (S0[x] >> 4)) >> 16) +
                       ((b1 * (S1[x] >> 4)) >> 16) + 2) >> 2);
  }
}


const char* image_ops_error() { return g_error.c_str(); }

// Undo the PNG row filters of `rows` scanlines, each a filter byte followed
// by `rowbytes` bytes, with `bpp` bytes per complete pixel (>= 1).
int image_ops_png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows,
                           int64_t rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t r = 0; r < rows; r++) {
    int f = in[r * (rowbytes + 1)];
    const uint8_t* src = in + r * (rowbytes + 1) + 1;
    uint8_t* dst = out + r * rowbytes;
    switch (f) {
      case 0:
        std::memcpy(dst, src, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        g_error = "bad PNG filter type " + std::to_string(f);
        return -1;
    }
    prev = dst;
  }
  return 0;
}

// Frame size of a JPEG as stored (before any EXIF orientation): info =
// [width, height, components].
int image_ops_jpeg_header(const uint8_t* data, int64_t n, int32_t* info) {
  try {
    JpegDecoder d(data, n);
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    d.pos = 2;
    for (;;) {
      int m = d.next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
        d.read_sof(false, m == 0xC2 || m == 0xCA);
        break;
      }
      refuse_sof(m);
      if (m == 0xD9 || m == 0xDA) fail("JPEG without a frame header");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      d.pos += d.u16() - 2;
    }
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    return 0;
  } catch (const CodecError& e) {
    g_error = e.msg;
    return e.code;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return -1;
  }
}

// Decode into out [height, width, 3] RGB (grey replicated).
int image_ops_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                          int64_t width, int64_t height) {
  try {
    JpegDecoder d(data, n);
    d.parse();
    if (d.width != width || d.height != height)
      fail("JPEG size changed between header and decode");
    d.to_rgb(out);
    return 0;
  } catch (const CodecError& e) {
    g_error = e.msg;
    return e.code;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return -1;
  }
}

// Encode rgb [h, w, 3] as a baseline 4:2:0 JFIF; returns its size, read it
// with image_ops_fetch_encoded.
int64_t image_ops_jpeg_encode(const uint8_t* rgb, int w, int h, int quality) {
  try {
    encode_jpeg(rgb, w, h, quality, g_encoded);
    return (int64_t)g_encoded.size();
  } catch (const CodecError& e) {
    g_error = e.msg;
    return e.code;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return -1;
  }
}

void image_ops_fetch_encoded(uint8_t* out) {
  std::memcpy(out, g_encoded.data(), g_encoded.size());
  std::vector<uint8_t>().swap(g_encoded);
}

}  // extern "C"
