// Baseline and progressive JPEG decoding on the host, for the data loaders.
//
// The JAX package reads JPEG files with imageio (Pillow over libjpeg-turbo)
// and, for COCO panoptic, with OpenCV (its own libjpeg-turbo). Neither is
// installed where the port runs, so this file decodes them itself and is
// built with g++ and loaded with ctypes (data/jpeg.py). It is host code, as
// the decoders it replaces are: no TPU kernel stands behind it.
//
// Output is what libjpeg-turbo gives with its defaults, to the bit:
// - Huffman decoding of sequential (SOF0, SOF1) and progressive (SOF2)
//   frames: DC first and refinement scans, AC first and refinement scans
//   with end-of-band runs, restart intervals (DRI, RST0-7), fill bytes and
//   stuffed zero bytes; a 9-bit lookahead table and the canonical slow path
//   for longer codes;
// - 8- and 16-bit quantisation tables, latched when a component's first
//   scan starts, as libjpeg does;
// - the accurate integer inverse DCT (jidctint.c, jpeg_idct_islow) with its
//   range limit;
// - libjpeg's fancy upsampling (jdsample.c): the h2v1, h1v2 and h2v2
//   triangle filters with their rounding biases, the image's edge rows and
//   columns repeated, box replication for other integral factors and for
//   h2v1 or h2v2 components of 2 columns or fewer;
// - the fixed-point YCbCr -> RGB conversion of jdcolor.c.
// All scans are decoded into coefficient arrays before any sample is
// made, so progressive files get no block smoothing: libjpeg only smooths
// while some coefficient bits are still unknown, and here all are known.
//
// Refused with an error that names the reason: arithmetic coding (SOF9-11,
// SOF13-15, DAC), lossless (SOF3) and hierarchical (SOF5-7) frames, sample
// precision other than 8 bits, component counts other than 1 and 3 (CMYK
// and YCCK files have 4), fractional sampling factors, a DNL-defined
// height, and a file that ends before its EOI marker (libjpeg would pad the
// missing data with zeros and warn). Corrupt entropy data (a code no table
// holds, a restart marker out of sequence) raises too.
//
// Entry points: jpeg_info reads the frame header; jpeg_decode writes the
// (H, W) gray or (H, W, 3) RGB image into a caller's buffer. Both return 0
// or -1 with a message. They keep no state between calls, so threads may
// decode at once.

#include <stdint.h>
#include <string.h>

#include <exception>
#include <string>
#include <vector>

namespace {

struct JpegError : std::exception {
  std::string msg;
  explicit JpegError(std::string m) : msg(std::move(m)) {}
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// Zigzag position -> natural (row-major) position; the 16 extra entries keep
// a run that overshoots in corrupt data inside the block, as libjpeg's do.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint16_t look[1 << kLookBits];  // (code length << 8) | symbol; 0: a longer code
  int32_t maxcode[18];            // the largest code of each length, -1 if none
  int32_t valoffset[18];          // symbol index = code + valoffset[length]
  uint8_t symbols[256];
};

// As libjpeg's jpeg_make_d_derived_tbl, whose checks come first: every code
// must fit its length with room for one more (no code of all ones), which
// also keeps the lookahead fill inside its table, and a DC table's
// symbols, bit counts of the difference, must be at most 15.
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* symbols, int n, bool dc) {
  int code = 0;
  for (int len = 1; len <= 16; ++len) {
    code += counts[len - 1];
    if (counts[len - 1] && code >= (1 << len)) fail("bad Huffman table (a code of all ones)");
    code <<= 1;
  }
  for (int i = 0; dc && i < n; ++i)
    if (symbols[i] > 15) fail("bad Huffman table (a DC symbol above 15)");
  memset(t.look, 0, sizeof t.look);
  memcpy(t.symbols, symbols, n);
  code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    const int count = counts[len - 1];
    for (int i = 0; i < count; ++i, ++code, ++k) {
      if (len <= kLookBits) {
        const int shift = kLookBits - len;
        for (int fill = 0; fill < (1 << shift); ++fill)
          t.look[(code << shift) | fill] = static_cast<uint16_t>((len << 8) | symbols[k]);
      }
    }
    t.maxcode[len] = count ? code - 1 : -1;
    code <<= 1;
  }
  t.defined = true;
}

// The entropy-coded bits of one scan. Bytes are pulled eight at a time ahead
// of use; a marker stops the pull and zeros stand in for whatever follows it,
// as libjpeg pads a segment that ends early.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (pos >= size) fail("truncated file: the data ends inside a scan");
        byte = data[pos];
        if (byte == 0xFF) {
          size_t p = pos + 1;
          while (p < size && data[p] == 0xFF) ++p;  // fill bytes
          if (p >= size) fail("truncated file: the data ends inside a scan");
          if (data[p] == 0) {
            pos = p + 1;  // a stuffed zero: the byte is 0xFF
          } else {
            at_marker = true;  // stop at the marker; pos stays on its 0xFF
            pos = p - 1;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }

  int bits(int n) {  // 1 <= n <= 16
    if (count < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    count -= n;
    return v;
  }

  int decode(const Huffman& t) {
    if (count < 16) fill();
    const uint16_t e = t.look[buf >> (64 - kLookBits)];
    if (e) {
      const int len = e >> 8;
      buf <<= len;
      count -= len;
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      const int code = static_cast<int>(buf >> (64 - len));
      if (code <= t.maxcode[len]) {
        buf <<= len;
        count -= len;
        return t.symbols[code + t.valoffset[len]];
      }
    }
    fail("corrupt data: a Huffman code that no table holds");
  }

  void restart() {
    buf = 0;
    count = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks a row, block rows (the MCU-padded array)
  int dw = 0, dh = 0;          // samples: libjpeg's downsampled_width/height
  int wib = 0, hib = 0;        // blocks of a non-interleaved scan
  bool latched = false;
  int16_t q[64];               // the quantisation table, natural order
  std::vector<int16_t> coef;   // bh x bw blocks of 64, natural order
  int dc_pred = 0;
  int16_t* block(int bx, int by) { return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64; }
};

inline int div_up(int a, int b) { return (a + b - 1) / b; }

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, progressive = false;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  Component comp[3];

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int byte() {
    if (pos >= size) fail("truncated file: the data ends inside a marker segment");
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // The next marker code, past any bytes before it (libjpeg skips them too).
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) fail("truncated file: no EOI marker");
      const int m = data[pos++];
      if (m != 0) return m;
    }
  }

  // Reads markers up to and including the frame header (header_only) or to
  // EOI, decoding every scan.
  void parse(bool header_only) {
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn: libjpeg warns and goes on
      if (m == 0x01) continue;  // TEM, no segment
      const int len = word();
      if (len < 2) fail("bad marker segment length");
      const size_t end = pos + len - 2;
      if (end > size) fail("truncated file: the data ends inside a marker segment");
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_frame(m, end);
          if (header_only) return;
          break;
        case 0xC3: fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("arithmetic coding (SOF" + std::to_string(m - 0xC0) + ") is not supported");
        case 0xCC: fail("arithmetic coding (DAC) is not supported");
        case 0xC4: read_huffman(end); break;
        case 0xDB: read_quant(end); break;
        case 0xDD:
          if (len != 4) fail("bad DRI segment");
          restart_interval = word();
          break;
        case 0xDC: fail("a height defined by a DNL marker is not supported");
        case 0xDA:
          if (!frame) fail("SOS before the frame header");
          read_scan(end);
          continue;  // read_scan leaves pos after the scan's entropy data
        case 0xE0:
          if (len >= 7 && memcmp(data + pos, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && memcmp(data + pos, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default: break;  // other APPn, COM and the rest: skipped
      }
      pos = end;
    }
    if (!frame) fail("no frame header before EOI");
  }

  void read_frame(int m, size_t end) {
    if (frame) fail("more than one frame header");
    const int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples are not supported (8-bit only)");
    height = word();
    width = word();
    ncomp = byte();
    if (height == 0) fail("a height defined by a DNL marker is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp == 4) fail("4 components (CMYK/YCCK) are not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + " components are not supported (1 or 3)");
    if (pos + 3 * ncomp > end) fail("bad frame header length");
    progressive = m == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component parameters");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = div_up(width, 8 * hmax);
    mcuy = div_up(height, 8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = div_up(width * c.h, hmax);
      c.dh = div_up(height * c.v, vmax);
      c.wib = div_up(width * c.h, 8 * hmax);
      c.hib = div_up(height * c.v, 8 * vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_huffman(size_t end) {
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table class or index");
      uint8_t counts[16];
      int n = 0;
      for (int i = 0; i < 16; ++i) n += counts[i] = static_cast<uint8_t>(byte());
      if (n > 256 || pos + n > end) fail("bad Huffman table");
      build_huffman(tc ? ac[th] : dc[th], counts, data + pos, n, tc == 0);
      pos += n;
    }
  }

  void read_quant(size_t end) {
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("bad quantisation table");
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? word() : byte());
      qt_defined[tq] = true;
    }
  }

  void read_scan(size_t end) {
    const int ns = byte();
    if (ns < 1 || ns > ncomp || pos + 2 * ns + 3 != end) fail("bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), tables = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("a scan names a component the frame lacks");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) fail("bad Huffman table index in a scan");
      sc[i] = c;
    }
    const int ss = byte(), se = byte(), ahl = byte();
    const int ah = ahl >> 4, al = ahl & 15;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg keeps the table in force at the component's first scan
        if (!qt_defined[c.tq]) fail("a component's quantisation table is not defined");
        for (int k = 0; k < 64; ++k) c.q[k] = static_cast<int16_t>(qt[c.tq][k]);
        c.latched = true;
      }
      c.dc_pred = 0;
    }
    const bool dc_scan = !progressive || ss == 0;
    const bool ac_scan = !progressive || ss > 0;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) fail("bad progressive scan");
      if (al > 13 || (ah && ah != al + 1)) fail("bad successive approximation");
    }
    for (int i = 0; i < ns; ++i) {
      if (dc_scan && !(progressive && ah) && !dc[sc[i]->td].defined)
        fail("a scan uses an undefined DC Huffman table");
      if (ac_scan && !ac[sc[i]->ta].defined) fail("a scan uses an undefined AC Huffman table");
    }
    pos = end;
    BitReader br{data, size, pos};
    int eobrun = 0;
    auto decode_block = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        int s = br.decode(dc[c.td]);
        if (s) s = extend(br.bits(s), s);
        c.dc_pred += s;
        blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huffman& t = ac[c.ta];
        for (int k = 1; k < 64; ++k) {
          const int rs = br.decode(t);
          const int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc[c.td]);
          if (s) s = extend(br.bits(s), s);
          c.dc_pred += s;
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
        } else if (br.bits(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        const Huffman& t = ac[c.ta];
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(t);
          int r = rs >> 4;
          const int s = rs & 15;
          if (s) {
            k += r;
            const int val = extend(br.bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(val) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            --eobrun;
            break;
          }
        }
      } else {  // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = ac[c.ta];
        int k = ss;
        auto refine = [&](int16_t* coef) {
          if (br.bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        };
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = br.decode(t);
            int r = rs >> 4;
            int s = rs & 15;
            if (s) {
              s = br.bits(1) ? p1 : m1;  // a new coefficient is +-1 at this bit
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += br.bits(r);
              break;  // the rest of the band is the end-of-band run's
            }
            do {  // past r zero coefficients, refining the nonzero ones on the way
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                refine(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) refine(coef);
          }
          --eobrun;
        }
      }
    };

    const bool interleaved = ns > 1;
    const int mcus_x = interleaved ? mcux : sc[0]->wib;
    const int mcus_y = interleaved ? mcuy : sc[0]->hib;
    const int total = mcus_x * mcus_y;
    int to_go = restart_interval, next_rst = 0;
    for (int mcu = 0; mcu < total; ++mcu) {
      if (restart_interval) {
        if (to_go == 0) {  // discard the padding bits and step over RSTn
          br.restart();
          pos = br.pos;
          const int m = next_marker();
          if (m != 0xD0 + next_rst) fail("corrupt data: restart marker out of sequence");
          next_rst = (next_rst + 1) & 7;
          br.pos = pos;
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          eobrun = 0;
          to_go = restart_interval;
        }
        --to_go;
      }
      const int mx = mcu % mcus_x, my = mcu / mcus_x;
      if (interleaved) {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x) decode_block(c, c.block(mx * c.h + x, my * c.v + y));
        }
      } else {
        decode_block(*sc[0], sc[0]->block(mx, my));
      }
    }
    pos = br.pos;  // at or before the next marker
  }
};

// ---- jidctint.c jpeg_idct_islow: the accurate integer inverse DCT ----

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// libjpeg's range limit after the IDCT: the result, centred at 128, clamped
// to 0..255 (libjpeg-turbo's SIMD IDCT saturates; its table agrees on every
// value a valid stream gives).
inline uint8_t idct_limit(int64_t x) {
  x += 128;
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dcval = static_cast<int>(ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int n = kConstBits + kPass1Bits + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, n));
    op[7] = idct_limit(descale(tmp10 - tmp3, n));
    op[1] = idct_limit(descale(tmp11 + tmp2, n));
    op[6] = idct_limit(descale(tmp11 - tmp2, n));
    op[2] = idct_limit(descale(tmp12 + tmp1, n));
    op[5] = idct_limit(descale(tmp12 - tmp1, n));
    op[3] = idct_limit(descale(tmp13 + tmp0, n));
    op[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// ---- upsampling (jdsample.c) ----

// A component's samples at full resolution: rows() of at least `width`
// columns, valid for rows < height.
struct Plane {
  std::vector<uint8_t> pixels;
  int stride = 0;
  const uint8_t* row(int y) const { return pixels.data() + static_cast<size_t>(y) * stride; }
};

// The IDCT of every block holding real samples: dh rows of bw * 8 columns.
Plane samples(Component& c) {
  Plane p;
  p.stride = c.bw * 8;
  const int brows = div_up(c.dh, 8), bcols = div_up(c.dw, 8);
  p.pixels.resize(static_cast<size_t>(brows) * 8 * p.stride);
  for (int by = 0; by < brows; ++by)
    for (int bx = 0; bx < bcols; ++bx)
      idct_islow(c.block(bx, by), c.q, p.pixels.data() + (static_cast<size_t>(by) * 8) * p.stride + bx * 8,
                 p.stride);
  return p;
}

Plane upsample(const Component& c, const Plane& in, int hmax, int vmax, int height) {
  const int hx = hmax / c.h, vx = vmax / c.v;
  if (hx == 1 && vx == 1) return in;
  if (hmax % c.h || vmax % c.v) fail("fractional sampling factors are not supported");
  const int dw = c.dw, dh = c.dh;
  Plane out;
  out.stride = dw * hx;
  const int rows = dh * vx < height ? dh * vx : height;
  out.pixels.resize(static_cast<size_t>(rows) * out.stride);
  auto src = [&](int y) { return in.row(y < 0 ? 0 : y >= dh ? dh - 1 : y); };
  if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < rows; ++y) {
      const uint8_t* ip = in.row(y);
      uint8_t* op = out.pixels.data() + static_cast<size_t>(y) * out.stride;
      int v = ip[0];
      op[0] = static_cast<uint8_t>(v);
      op[1] = static_cast<uint8_t>((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = ip[x] * 3;
        op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      op[2 * dw - 2] = static_cast<uint8_t>((v * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = static_cast<uint8_t>(v);
    }
  } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < rows; ++y) {
      const uint8_t* near = in.row(y >> 1);
      const uint8_t* far = src((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* op = out.pixels.data() + static_cast<size_t>(y) * out.stride;
      for (int x = 0; x < dw; ++x) op[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    }
  } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int y = 0; y < rows; ++y) {
      const uint8_t* near = in.row(y >> 1);
      const uint8_t* far = src((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      for (int x = 0; x < dw; ++x) sum[x] = near[x] * 3 + far[x];
      uint8_t* op = out.pixels.data() + static_cast<size_t>(y) * out.stride;
      op[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
      op[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        op[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        op[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      op[2 * dw - 2] = static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
      op[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
    }
  } else {  // int_upsample (and h2v1_upsample, h2v2_upsample): box replication
    for (int y = 0; y < rows; ++y) {
      const uint8_t* ip = in.row(y / vx);
      uint8_t* op = out.pixels.data() + static_cast<size_t>(y) * out.stride;
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < hx; ++k) op[x * hx + k] = ip[x];
    }
  }
  return out;
}

// ---- jdcolor.c: YCbCr -> RGB in 16-bit fixed point ----

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x); }

void write_image(Decoder& d, uint8_t* out) {
  for (int i = 0; i < d.ncomp; ++i)
    if (!d.comp[i].latched) fail("a component has no scan");
  const int w = d.width, h = d.height;
  if (d.ncomp == 1) {
    const Plane p = samples(d.comp[0]);
    for (int y = 0; y < h; ++y) memcpy(out + static_cast<size_t>(y) * w, p.row(y), w);
    return;
  }
  Plane planes[3];
  for (int i = 0; i < 3; ++i) planes[i] = upsample(d.comp[i], samples(d.comp[i]), d.hmax, d.vmax, h);
  // libjpeg's colour space of a 3-component file: YCbCr under JFIF; else
  // Adobe's transform flag; else RGB only for component ids 'R', 'G', 'B'.
  bool rgb;
  if (d.saw_jfif) rgb = false;
  else if (d.saw_adobe) rgb = d.adobe_transform == 0;
  else rgb = d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B';
  static const ColorTables t;
  for (int y = 0; y < h; ++y) {
    const uint8_t *p0 = planes[0].row(y), *p1 = planes[1].row(y), *p2 = planes[2].row(y);
    uint8_t* op = out + static_cast<size_t>(y) * w * 3;
    if (rgb) {
      for (int x = 0; x < w; ++x) {
        op[3 * x] = p0[x];
        op[3 * x + 1] = p1[x];
        op[3 * x + 2] = p2[x];
      }
      continue;
    }
    for (int x = 0; x < w; ++x) {
      const int yy = p0[x], cb = p1[x], cr = p2[x];
      op[3 * x] = clamp255(yy + t.cr_r[cr]);
      op[3 * x + 1] = clamp255(yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      op[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    strncpy(err, msg, errlen - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

// The frame header of `size` bytes at `data`: height, width and channels (1
// or 3). Returns 0, or -1 with a message in err.
extern "C" int jpeg_info(const uint8_t* data, int64_t size, int* height, int* width,
                         int* channels, char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.parse(true);
    if (!d.frame) fail("no frame header");
    *height = d.height;
    *width = d.width;
    *channels = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg.c_str());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

// Decodes the whole file into out: (H, W) gray or (H, W, 3) RGB uint8, whose
// size in bytes the caller gives as capacity. Returns 0, or -1 with a
// message in err.
extern "C" int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t capacity,
                           char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.parse(false);
    if (static_cast<int64_t>(d.width) * d.height * d.ncomp != capacity)
      fail("output buffer does not match the image");
    write_image(d, out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg.c_str());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}
