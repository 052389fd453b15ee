// A baseline / extended-sequential JPEG decoder that returns the very BGR
// bytes of cv2.imread(path, IMREAD_COLOR) as OpenCV 5.0 computes them with
// its bundled libjpeg-turbo 3.1.2 and that library's defaults:
//
//   * 8-bit Huffman-coded sequential frames (SOF0, SOF1), interleaved or
//     not, restart intervals, any Huffman tables;
//   * one component (grey, replicated to B, G and R) or three (YCbCr);
//   * sampling 4:4:4, 4:2:2, 4:4:0 and 4:2:0, any image size;
//   * the JDCT_ISLOW integer IDCT (jidctint.c), samples clamped to 0..255;
//   * fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
//     their alternating rounding biases when the downsampled width is
//     above 2 (plain replication otherwise), h1v2 with biases 1 and 2, the
//     first and last real rows standing in for the rows past the edges;
//   * jdcolor.c's fixed-point YCbCr -> RGB (16-bit tables), written BGR.
//
// It refuses, with a message, what it cannot decode as cv2 would:
// progressive, arithmetic-coded, lossless, hierarchical and 12-bit frames,
// four-component (CMYK/YCCK) files, other sampling layouts, Adobe RGB
// (transform 0), and an EXIF orientation other than 1 (cv2 rotates those).
//
// C interface (ctypes):
//   int ucj_header(const uint8_t* data, long size, int* hw, char* err,
//                  long err_cap)
//       hw[0] = height, hw[1] = width; 0 on success, -1 with a message.
//   int ucj_decode(const uint8_t* data, long size, uint8_t* out, char* err,
//                  long err_cap)
//       out: height * width * 3 bytes, BGR; 0 on success, -1 with a message.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 (data/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

struct Huffman {
  bool present = false;
  // canonical decoding tables (jdhuff.c's slow path)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;           // Huffman tables of the current scan
  int bw = 0, bh = 0;           // blocks allocated (MCU-padded)
  int wb = 0, hb = 0;           // blocks holding image data
  int dw = 0, dh = 0;           // downsampled width and height in samples
  int pred = 0;                 // DC predictor
  std::vector<int16_t> coef;    // bw * bh * 64, natural order
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 stays in bounds
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

class Decoder {
 public:
  Decoder(const uint8_t* data, long size) : d_(data), n_(size) {}

  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) fail("no frame before the end of the image");
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
        header_end_ = pos_;
        return;
      }
      handle_table_or_app(m);
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }

  void decode(uint8_t* out) {
    pos_ = header_end_;
    for (auto& c : comps_) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    bool any_scan = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        read_sos();
        any_scan = true;
        continue;
      }
      if (m == 0xDC) fail("DNL markers are not supported");
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
        fail("a second frame header");
      handle_table_or_app(m);
    }
    if (!any_scan) fail("no scan");
    produce(out);
  }

 private:
  const uint8_t* d_;
  long n_;
  long pos_ = 0, header_end_ = 0;
  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  int adobe_transform_ = -1;
  // entropy decoder state
  uint32_t bits_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;

  int u8() {
    if (pos_ >= n_) fail("unexpected end of file");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip to 0xFF, then past fill bytes; 0xFF00 is entropy-coded data
    // that a scan left unread (its final padding)
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_) fail("bad segment length");
    pos_ += len - 2;
  }

  void handle_table_or_app(int m) {
    if (m == 0xDB) return read_dqt();
    if (m == 0xC4) return read_dht();
    if (m == 0xDD) return read_dri();
    if (m == 0xE1) return read_app1();
    if (m == 0xEE) return read_app14();
    if (m == 0xCC) fail("arithmetic-coded JPEG (DAC) is not supported");
    if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) return skip_segment();
    if (m >= 0xD0 && m <= 0xD7) return;  // stray RST: no payload
    if (m == 0x01) return;
    skip_segment();
  }

  void read_dqt() {
    int len = u16();
    long end = pos_ + len - 2;
    while (pos_ < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad quantization table");
      for (int i = 0; i < 64; i++)
        qt_[tq][kZigzag[i]] = (uint16_t)(pq ? u16() : u8());
      qt_present_[tq] = true;
    }
    if (pos_ != end) fail("bad DQT length");
  }

  void read_dht() {
    int len = u16();
    long end = pos_ + len - 2;
    while (pos_ < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) total += counts[i] = (uint8_t)u8();
      if (total > 256) fail("bad Huffman table");
      Huffman& h = tc ? ac_[th] : dc_[th];
      for (int i = 0; i < total; i++) h.huffval[i] = (uint8_t)u8();
      build_huffman(h, counts, total);
    }
    if (pos_ != end) fail("bad DHT length");
  }

  static void build_huffman(Huffman& h, const uint8_t* counts, int total) {
    std::vector<uint16_t> codes(total);
    std::vector<uint8_t> sizes(total);
    int k = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l]; i++) sizes[k++] = (uint8_t)l;
    uint32_t code = 0;
    int si = total ? sizes[0] : 0;
    k = 0;
    while (k < total) {
      while (k < total && sizes[k] == si) codes[k++] = (uint16_t)code++;
      if (code >= (1u << si) && k < total) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    k = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        h.valoffset[l] = k - (int)codes[k];
        k += counts[l];
        h.maxcode[l] = codes[k - 1];
      } else {
        h.maxcode[l] = -1;
      }
    }
    h.maxcode[17] = 0x7FFFFFFF;
    std::memset(h.look, 0, sizeof(h.look));
    for (int i = 0; i < total; i++) {
      int l = sizes[i];
      if (l > 9) continue;
      int shift = 9 - l;
      for (int j = 0; j < (1 << shift); j++)
        h.look[(codes[i] << shift) | j] = (uint16_t)((l << 8) | h.huffval[i]);
    }
    h.present = true;
  }

  void read_dri() {
    if (u16() != 4) fail("bad DRI length");
    restart_ = u16();
  }

  void read_app14() {
    long start = pos_;
    int len = u16();
    if (len >= 14 && pos_ + 12 <= n_ &&
        std::memcmp(d_ + pos_, "Adobe", 5) == 0)
      adobe_transform_ = d_[pos_ + 11];
    pos_ = start;
    skip_segment();
  }

  void read_app1() {
    long start = pos_;
    int len = u16();
    long end = start + len;
    if (end > n_) fail("bad APP1 length");
    long p = pos_;
    if (len >= 16 && std::memcmp(d_ + p, "Exif\0\0", 6) == 0) {
      long t = p + 6;  // TIFF header
      bool le = d_[t] == 'I';
      auto r16 = [&](long q) -> int {
        if (q + 2 > end) return -1;
        return le ? d_[q] | (d_[q + 1] << 8) : (d_[q] << 8) | d_[q + 1];
      };
      auto r32 = [&](long q) -> long {
        if (q + 4 > end) return -1;
        return le ? (long)d_[q] | ((long)d_[q + 1] << 8) |
                        ((long)d_[q + 2] << 16) | ((long)d_[q + 3] << 24)
                  : ((long)d_[q] << 24) | ((long)d_[q + 1] << 16) |
                        ((long)d_[q + 2] << 8) | (long)d_[q + 3];
      };
      long ifd = r32(t + 4);
      int count = ifd >= 0 ? r16(t + ifd) : -1;
      for (int i = 0; i < count; i++) {
        long e = t + ifd + 2 + 12L * i;
        if (r16(e) == 0x0112) {
          int orientation = r16(e + 8);
          if (orientation >= 2 && orientation <= 8)
            fail("EXIF orientation " + std::to_string(orientation) +
                 " (cv2.imread would rotate the image) is not supported");
        }
      }
    }
    pos_ = start;
    skip_segment();
  }

  void read_sof(int m) {
    switch (m) {
      case 0xC0: case 0xC1: break;
      case 0xC2: fail("progressive JPEG is not supported");
      case 0xC3: fail("lossless JPEG is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail("hierarchical JPEG is not supported");
      default: fail("arithmetic-coded JPEG is not supported");
    }
    int len = u16();
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported");
    height_ = u16();
    width_ = u16();
    int nc = u8();
    if (len != 8 + 3 * nc) fail("bad SOF length");
    if (height_ == 0 || width_ == 0) fail("empty image");
    if (nc == 4) fail("four-component (CMYK/YCCK) JPEG is not supported");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + "-component JPEG is not supported");
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    for (auto& c : comps_) {
      int rx = hmax_ / c.h, ry = vmax_ / c.v;
      if (hmax_ % c.h || vmax_ % c.v || rx > 2 || ry > 2)
        fail("sampling factors " + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " of " + std::to_string(hmax_) + "x" +
             std::to_string(vmax_) + " are not supported");
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.dw = (int)(((long)width_ * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((long)height_ * c.v + vmax_ - 1) / vmax_);
      c.wb = (c.dw + 7) / 8;
      c.hb = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
  }

  void read_sos() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad SOS");
    std::vector<Component*> scan;
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == id) c = &k;
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc_[c->td].present ||
          !ac_[c->ta].present)
        fail("scan uses an undefined Huffman table");
      if (!qt_present_[c->tq]) fail("undefined quantization table");
      scan.push_back(c);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("bad sequential scan");
    decode_scan(scan);
  }

  // -- entropy decoding ----------------------------------------------------

  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
  }

  void fill() {
    while (nbits_ <= 24) {
      int c = 0;
      if (!hit_marker_ && pos_ < n_) {
        c = d_[pos_];
        if (c == 0xFF) {
          long q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;
          if (q < n_ && d_[q] == 0) {
            pos_ = q + 1;
          } else {
            hit_marker_ = true;  // libjpeg feeds zeros past a marker
            c = 0;
          }
        } else {
          pos_++;
        }
      }
      bits_ |= (uint32_t)c << (24 - nbits_);
      nbits_ += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    int v = (int)(bits_ >> (32 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }

  int decode_symbol(const Huffman& h) {
    if (nbits_ < 16) fill();
    int look = h.look[bits_ >> 23];
    if (look) {
      int l = look >> 8;
      bits_ <<= l;
      nbits_ -= l;
      return look & 0xFF;
    }
    int code = 0, l = 0;
    do {
      code = (code << 1) | (int)(bits_ >> 31);
      bits_ <<= 1;
      nbits_--;
      l++;
    } while (l <= 16 && code > h.maxcode[l]);
    if (l > 16) fail("corrupt Huffman data");
    return h.huffval[(h.valoffset[l] + code) & 0xFF];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void decode_block(Component& c, int16_t* blk) {
    int s = decode_symbol(dc_[c.td]);
    if (s > 16) fail("corrupt DC coefficient");
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        int v = extend(get_bits(sz), sz);
        blk[kZigzag[k]] = (int16_t)v;
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void restart_marker() {
    // drop the buffered bits, then expect RSTn
    reset_bits();
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 &&
                               d_[pos_ + 1] <= 0xD7)) {
      if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF)
        return;  // another marker: libjpeg resynchronizes and goes on
      pos_++;
    }
    if (pos_ + 1 < n_) pos_ += 2;
  }

  void decode_scan(const std::vector<Component*>& scan) {
    reset_bits();
    for (auto* c : scan) c->pred = 0;
    int todo = restart_;
    auto block = [](Component& c, int bx, int by) {
      return c.coef.data() + ((size_t)by * c.bw + bx) * 64;
    };
    if (scan.size() == 1) {
      Component& c = *scan[0];
      for (int by = 0; by < c.hb; by++)
        for (int bx = 0; bx < c.wb; bx++) {
          if (restart_ && todo == 0) {
            restart_marker();
            c.pred = 0;
            todo = restart_;
          }
          decode_block(c, block(c, bx, by));
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy_; my++)
        for (int mx = 0; mx < mcux_; mx++) {
          if (restart_ && todo == 0) {
            restart_marker();
            for (auto* c : scan) c->pred = 0;
            todo = restart_;
          }
          for (auto* c : scan)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++)
                decode_block(*c, block(*c, mx * c->h + x, my * c->v + y));
          todo--;
        }
    }
  }

  // -- reconstruction ------------------------------------------------------

  static inline uint8_t clamp8(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  // jidctint.c jpeg_idct_islow
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const long F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
               F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
               F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dc = (int)ip[0] * qp[0] * (1 << PASS1_BITS);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      long z2 = (long)ip[16] * qp[16], z3 = (long)ip[48] * qp[48];
      long z1 = (z2 + z3) * F0_541;
      long tmp2 = z1 + z3 * (-F1_847);
      long tmp3 = z1 + z2 * F0_765;
      z2 = (long)ip[0] * qp[0];
      z3 = (long)ip[32] * qp[32];
      long tmp0 = (z2 + z3) * (1L << CONST_BITS);
      long tmp1 = (z2 - z3) * (1L << CONST_BITS);
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (long)ip[56] * qp[56];
      tmp1 = (long)ip[40] * qp[40];
      tmp2 = (long)ip[24] * qp[24];
      tmp3 = (long)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long z4 = tmp1 + tmp3;
      long z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      const long rnd = 1L << (sh - 1);
      wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    const int sh2 = CONST_BITS + PASS1_BITS + 3;
    const long rnd2 = 1L << (sh2 - 1);
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
          !wp[7]) {
        uint8_t v = clamp8((int)(((long)wp[0] + (1L << (PASS1_BITS + 2))) >>
                                 (PASS1_BITS + 3)) + 128);
        for (int i = 0; i < 8; i++) op[i] = v;
        continue;
      }
      long z2 = wp[2], z3 = wp[6];
      long z1 = (z2 + z3) * F0_541;
      long tmp2 = z1 + z3 * (-F1_847);
      long tmp3 = z1 + z2 * F0_765;
      long tmp0 = ((long)wp[0] + wp[4]) * (1L << CONST_BITS);
      long tmp1 = ((long)wp[0] - wp[4]) * (1L << CONST_BITS);
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long z4 = tmp1 + tmp3;
      long z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = clamp8((int)((tmp10 + tmp3 + rnd2) >> sh2) + 128);
      op[7] = clamp8((int)((tmp10 - tmp3 + rnd2) >> sh2) + 128);
      op[1] = clamp8((int)((tmp11 + tmp2 + rnd2) >> sh2) + 128);
      op[6] = clamp8((int)((tmp11 - tmp2 + rnd2) >> sh2) + 128);
      op[2] = clamp8((int)((tmp12 + tmp1 + rnd2) >> sh2) + 128);
      op[5] = clamp8((int)((tmp12 - tmp1 + rnd2) >> sh2) + 128);
      op[3] = clamp8((int)((tmp13 + tmp0 + rnd2) >> sh2) + 128);
      op[4] = clamp8((int)((tmp13 - tmp0 + rnd2) >> sh2) + 128);
    }
  }

  // The component's samples at full resolution: width_ x height_ (the
  // plane is at least that large; stride returned in *stride).
  std::vector<uint8_t> full_plane(const Component& c, int* stride) {
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane((size_t)pw * ph);
    const uint16_t* q = qt_[c.tq];
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, q,
                   plane.data() + (size_t)by * 8 * pw + bx * 8, pw);
    int rx = hmax_ / c.h, ry = vmax_ / c.v;
    if (rx == 1 && ry == 1) {
      *stride = pw;
      return plane;
    }
    const int dw = c.dw, dh = c.dh;
    const int ow = dw * rx, oh = dh * ry;
    std::vector<uint8_t> up((size_t)ow * oh);
    auto row = [&](int r) {
      r = r < 0 ? 0 : r >= dh ? dh - 1 : r;
      return plane.data() + (size_t)r * pw;
    };
    if (rx == 2 && ry == 1) {
      for (int r = 0; r < dh; r++) {
        const uint8_t* in = row(r);
        uint8_t* o = up.data() + (size_t)r * ow;
        if (dw > 2) {
          int v = in[0];
          o[0] = (uint8_t)v;
          o[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            v = in[x] * 3;
            o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
            o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
          }
          v = in[dw - 1];
          o[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
          o[2 * dw - 1] = (uint8_t)v;
        } else {
          for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in[x];
        }
      }
    } else if (rx == 1 && ry == 2) {
      for (int r = 0; r < dh; r++)
        for (int v = 0; v < 2; v++) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = row(v ? r + 1 : r - 1);
          int bias = v ? 2 : 1;
          uint8_t* o = up.data() + (size_t)(2 * r + v) * ow;
          for (int x = 0; x < dw; x++)
            o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        }
    } else {  // 2 x 2
      for (int r = 0; r < dh; r++)
        for (int v = 0; v < 2; v++) {
          uint8_t* o = up.data() + (size_t)(2 * r + v) * ow;
          const uint8_t* in0 = row(r);
          if (dw <= 2) {
            for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in0[x];
            continue;
          }
          const uint8_t* in1 = row(v ? r + 1 : r - 1);
          int this_sum = in0[0] * 3 + in1[0];
          int next_sum = in0[1] * 3 + in1[1];
          o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
          o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 1; x < dw - 1; x++) {
            next_sum = in0[x + 1] * 3 + in1[x + 1];
            o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
        }
    }
    *stride = ow;
    return up;
  }

  void produce(uint8_t* out) {
    const size_t w = (size_t)width_;
    if (comps_.size() == 1) {
      int stride;
      std::vector<uint8_t> y = full_plane(comps_[0], &stride);
      for (int r = 0; r < height_; r++) {
        const uint8_t* in = y.data() + (size_t)r * stride;
        uint8_t* o = out + (size_t)r * w * 3;
        for (size_t x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = in[x];
      }
      return;
    }
    if (adobe_transform_ == 0)
      fail("Adobe RGB JPEG (transform 0) is not supported");
    int sy, sb, sr;
    std::vector<uint8_t> Y = full_plane(comps_[0], &sy);
    std::vector<uint8_t> Cb = full_plane(comps_[1], &sb);
    std::vector<uint8_t> Cr = full_plane(comps_[2], &sr);
    // jdcolor.c build_ycc_rgb_table
    const int SCALEBITS = 16;
    const long ONE_HALF = 1L << (SCALEBITS - 1);
    auto fix = [](double x) { return (long)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    long cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    for (int r = 0; r < height_; r++) {
      const uint8_t* py = Y.data() + (size_t)r * sy;
      const uint8_t* pb = Cb.data() + (size_t)r * sb;
      const uint8_t* pr = Cr.data() + (size_t)r * sr;
      uint8_t* o = out + (size_t)r * w * 3;
      for (size_t x = 0; x < w; x++) {
        int yy = py[x], cb = pb[x], cr = pr[x];
        o[3 * x + 2] = clamp8(yy + cr_r[cr]);
        o[3 * x + 1] =
            clamp8(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        o[3 * x + 0] = clamp8(yy + cb_b[cb]);
      }
    }
  }
};

void copy_error(const std::string& msg, char* err, long cap) {
  if (!err || cap <= 0) return;
  long n = std::min<long>((long)msg.size(), cap - 1);
  std::memcpy(err, msg.data(), (size_t)n);
  err[n] = 0;
}

}  // namespace

extern "C" int ucj_header(const uint8_t* data, long size, int* hw, char* err,
                          long err_cap) {
  try {
    Decoder dec(data, size);
    dec.read_header();
    hw[0] = dec.height();
    hw[1] = dec.width();
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, err_cap);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, err_cap);
  }
  return -1;
}

extern "C" int ucj_decode(const uint8_t* data, long size, uint8_t* out,
                          char* err, long err_cap) {
  try {
    Decoder dec(data, size);
    dec.read_header();
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, err_cap);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, err_cap);
  }
  return -1;
}
