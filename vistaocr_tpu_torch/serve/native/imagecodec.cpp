// PNG and JPEG decoding for the port's HTTP server, without PIL.
//
// The output of each entry point equals np.asarray(PIL.Image.open(...)) for
// the same bytes: the PNG part unfilters, deinterlaces and unpacks rows the
// way Pillow's zip decoder and unpackers do (the inflate stays in Python);
// the JPEG part is a baseline/progressive Huffman decoder written from ITU-T
// T.81 that mirrors libjpeg-turbo's integer arithmetic (the "islow" IDCT in
// its AVX2 lanes,
// "fancy" triangle upsampling, the fixed-point YCbCr->RGB tables) and its
// handling of damaged data (zero bits past a marker, a bad Huffman code read
// as 0, restart resync, the read-ahead of its bit buffer, which decides
// whether a truncated file is refused).
//
// The library holds no Python object. Each entry point returns 0, or 1 (the
// data is damaged) or 2 (the decoder refuses the form) with a message in
// `err`; the caller raises ValueError with it.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
  int code;  // 1: damaged or invalid data, 2: a form this decoder refuses
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg, 1}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Fail{msg, 2}; }

void set_err(char* err, int err_len, const std::string& msg) {
  if (err == nullptr || err_len <= 0) return;
  std::snprintf(err, (size_t)err_len, "%s", msg.c_str());
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

// Unfilter one pass of `rows` rows of `rowbytes` bytes each (plus the
// filter byte) from `src` into `dst` (rows * rowbytes). Returns the bytes of
// `src` used.
size_t unfilter_pass(const uint8_t* src, size_t avail, int64_t rows,
                     int64_t rowbytes, int bpp, uint8_t* dst) {
  size_t used = 0;
  for (int64_t y = 0; y < rows; ++y) {
    if (avail - used < (size_t)(rowbytes + 1)) fail("PNG image data is short");
    int ft = src[used];
    const uint8_t* in = src + used + 1;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* prev = y ? out - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(out, in, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          out[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        fail("PNG row filter type " + std::to_string(ft) + " is not 0-4");
    }
    used += (size_t)rowbytes + 1;
  }
  return used;
}

// Write pixel `x` of an unfiltered row into the output element at `dst`
// (Pillow's array for the PNG mode: see the table in imagecodec.py).
inline void put_pixel(const uint8_t* row, int64_t x, int depth, int ctype,
                      uint8_t* dst) {
  if (depth < 8) {
    int per = 8 / depth;
    int shift = 8 - depth * (int)(x % per + 1);
    int v = (row[x / per] >> shift) & ((1 << depth) - 1);
    if (ctype == 3) {
      dst[0] = (uint8_t)v;  // P: the palette index
    } else if (depth == 1) {
      dst[0] = (uint8_t)(v ? 255 : 0);  // "1": a bool array of 0/255 bytes
    } else {
      dst[0] = (uint8_t)(depth == 2 ? v * 0x55 : v * 0x11);  // L;2, L;4
    }
    return;
  }
  if (depth == 8) {
    int ch = ctype == 0 || ctype == 3 ? 1 : ctype == 2 ? 3 : ctype == 4 ? 2 : 4;
    std::memcpy(dst, row + x * ch, (size_t)ch);
    return;
  }
  // 16 bits a sample
  switch (ctype) {
    case 0: {  // I;16: native-endian uint16
      uint16_t v = (uint16_t)((row[2 * x] << 8) | row[2 * x + 1]);
      std::memcpy(dst, &v, 2);
      break;
    }
    case 2:  // RGB;16B: the high bytes
      dst[0] = row[6 * x];
      dst[1] = row[6 * x + 2];
      dst[2] = row[6 * x + 4];
      break;
    case 4:  // LA;16B -> RGBA (grey, grey, grey, alpha)
      dst[0] = dst[1] = dst[2] = row[4 * x];
      dst[3] = row[4 * x + 2];
      break;
    case 6:  // RGBA;16B
      dst[0] = row[8 * x];
      dst[1] = row[8 * x + 2];
      dst[2] = row[8 * x + 4];
      dst[3] = row[8 * x + 6];
      break;
  }
}

int channels(int ctype) {
  return ctype == 0 || ctype == 3 ? 1 : ctype == 2 ? 3 : ctype == 4 ? 2 : 4;
}

void png_decode(const uint8_t* raw, size_t raw_len, int64_t W, int64_t H,
                int depth, int ctype, int interlace, int out_elem,
                uint8_t* out) {
  const int bits = depth * channels(ctype);
  const int bpp = bits >= 8 ? bits / 8 : 1;
  std::vector<uint8_t> rows;
  if (!interlace) {
    const int64_t rowbytes = (W * bits + 7) / 8;
    rows.resize((size_t)(rowbytes * H));
    unfilter_pass(raw, raw_len, H, rowbytes, bpp, rows.data());
    for (int64_t y = 0; y < H; ++y) {
      const uint8_t* row = rows.data() + y * rowbytes;
      uint8_t* o = out + y * W * out_elem;
      if (depth == 8) {
        std::memcpy(o, row, (size_t)(W * out_elem));
      } else {
        for (int64_t x = 0; x < W; ++x)
          put_pixel(row, x, depth, ctype, o + x * out_elem);
      }
    }
    return;
  }
  // Adam7: pass p covers x = x0 + i * dx, y = y0 + j * dy
  static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
  size_t used = 0;
  for (int p = 0; p < 7; ++p) {
    int64_t pw = W > X0[p] ? (W - X0[p] + DX[p] - 1) / DX[p] : 0;
    int64_t ph = H > Y0[p] ? (H - Y0[p] + DY[p] - 1) / DY[p] : 0;
    if (pw == 0 || ph == 0) continue;
    const int64_t rowbytes = (pw * bits + 7) / 8;
    rows.assign((size_t)(rowbytes * ph), 0);
    used += unfilter_pass(raw + used, raw_len - used, ph, rowbytes, bpp,
                          rows.data());
    for (int64_t j = 0; j < ph; ++j) {
      const uint8_t* row = rows.data() + j * rowbytes;
      int64_t y = Y0[p] + j * DY[p];
      for (int64_t i = 0; i < pw; ++i) {
        int64_t x = X0[p] + i * DX[p];
        put_pixel(row, i, depth, ctype, out + (y * W + x) * out_elem);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

// zigzag -> natural order, with the 16 extra entries libjpeg keeps so that
// a damaged run cannot index past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the tables of ITU-T T.81 Annex K.3, which libjpeg-turbo installs for any
// table slot a file leaves undefined
struct StdTable {
  int cls, slot;
  uint8_t bits[17];
  uint8_t vals[162];
};
const StdTable kStdTables[4] = {
    {0, 0, {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {1, 0, {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
     {1,   2,   3,   0,   4,   17,  5,   18,  33,  49,  65,  6,   19,  81,
      97,  7,   34,  113, 20,  50,  129, 145, 161, 8,   35,  66,  177, 193,
      21,  82,  209, 240, 36,  51,  98,  114, 130, 9,   10,  22,  23,  24,
      25,  26,  37,  38,  39,  40,  41,  42,  52,  53,  54,  55,  56,  57,
      58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,  87,
      88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
      118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146,
      147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167,
      168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
      196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216,
      217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242,
      243, 244, 245, 246, 247, 248, 249, 250}},
    {0, 1, {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {1, 1, {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119},
     {0,   1,   2,   3,   17,  4,   5,   33,  49,  6,   18,  65,  81,  7,
      97,  113, 19,  34,  50,  129, 8,   20,  66,  145, 161, 177, 193, 9,
      35,  51,  82,  240, 21,  98,  114, 209, 10,  22,  36,  52,  225, 37,
      241, 23,  24,  25,  26,  38,  39,  40,  41,  42,  53,  54,  55,  56,
      57,  58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,
      87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116,
      117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137,
      138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165,
      166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
      194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214,
      215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242,
      243, 244, 245, 246, 247, 248, 249, 250}},
};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

// libjpeg's d_derived_tbl
struct Derived {
  int64_t maxcode[18];
  int64_t valoffset[18];
  int lookup[256];  // (code length << 8) | value, or 9 << 8: longer
  uint8_t vals[256];
};

void derive(const HuffTable* tables, int slot, bool is_dc, Derived& d) {
  if (slot < 0 || slot >= 4 || !tables[slot].defined)
    fail("JPEG scan uses Huffman table " + std::to_string(slot) +
         ", which is not defined");
  const HuffTable& t = tables[slot];
  char size[257];
  unsigned code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = t.bits[l];
    if (p + n > 256) fail("bad JPEG Huffman table");
    while (n--) size[p++] = (char)l;
  }
  size[p] = 0;
  const int nsym = p;
  unsigned c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code[p++] = c;
      ++c;
    }
    if ((int64_t)c >= ((int64_t)1 << si)) fail("bad JPEG Huffman table");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d.valoffset[l] = (int64_t)p - (int64_t)code[p];
      p += t.bits[l];
      d.maxcode[l] = code[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) d.lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      int look = (int)(code[p] << (8 - l));
      for (int k = 1 << (8 - l); k > 0; --k) d.lookup[look++] = (l << 8) | t.vals[p];
    }
  }
  std::memcpy(d.vals, t.vals, 256);
  if (is_dc) {
    for (int i = 0; i < nsym; ++i)
      if (t.vals[i] > 15) fail("bad JPEG Huffman table");
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int wib = 0, hib = 0;  // width/height in blocks
  int bw = 0, bh = 0;    // allocated blocks (padded to whole MCUs)
  int dw = 0, dh = 0;    // downsampled width/height in samples
  bool latched = false;
  int16_t q[64] = {0};
  int coef_bits[64];
  std::vector<int16_t> coef;
};

const uint64_t kChunk = 65536;  // Pillow's read size (ImageFile.MAXBLOCK)
const int kMinGetBits = 57;     // libjpeg's MIN_GET_BITS with a 64-bit buffer

struct NeedMore {};  // the read-ahead passed the end of the current chunk
struct Eof {};       // the data ended where libjpeg wanted more

struct BitState {
  uint64_t buf = 0;
  int bits = 0;
  uint64_t pos = 0;
};

class Jpeg {
 public:
  Jpeg(const uint8_t* d, uint64_t n) : d_(d), n_(n) {
    bufend_ = n_ < kChunk ? n_ : kChunk;
  }

  void decode(int64_t W, int64_t H, int nc, uint8_t* out);

 private:
  const uint8_t* d_;
  uint64_t n_;
  uint64_t bufend_;  // end of the data Pillow has handed libjpeg so far
  uint64_t pos_ = 0;
  BitState bs_;
  int unread_marker_ = 0;
  bool insufficient_ = false;
  bool saw_soi_ = false, saw_sof_ = false;
  bool progressive_ = false;
  int precision_ = 8;
  int width_ = 0, height_ = 0;
  int hmax_ = 1, vmax_ = 1;
  std::vector<Component> comps_;
  uint16_t qt_[4][64];
  bool qdef_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  // the current scan
  int ncs_ = 0;
  Component* cs_[4];
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int next_restart_ = 0;
  int restarts_to_go_ = 0;
  int last_dc_[4];
  unsigned eobrun_ = 0;
  Derived dcd_[4], acd_[4];

  // Read the byte at pos_, taking Pillow's next chunk when it is needed.
  int input_byte() {
    while (pos_ >= bufend_) more();
    return d_[pos_++];
  }
  void more() {
    if (bufend_ >= n_) throw Eof();
    bufend_ = bufend_ + kChunk < n_ ? bufend_ + kChunk : n_;
  }
  int input_2bytes() {
    int a = input_byte();
    return (a << 8) | input_byte();
  }
  void skip(int64_t len) {
    if (len <= 0) return;
    pos_ += (uint64_t)len;
    while (pos_ > bufend_) more();
  }

  void first_marker();
  void next_marker();
  int read_markers();  // 1: SOS, 2: EOI
  void get_sof(bool prog, bool lossless, bool arith);
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_dac();
  void get_app(int marker);
  void initial_setup();
  void start_scan();
  void decode_scan();
  void finish_output(int64_t W, int64_t H, int nc, uint8_t* out);

  // the entropy decoder's bit reader (jdhuff.c)
  void fill_bits(BitState& s, int nbits);
  int get_bits(BitState& s, int n) {
    if (s.bits < n) fill_bits(s, n);
    s.bits -= n;
    return (int)((s.buf >> s.bits) & ((1u << n) - 1));
  }
  int huff_decode(BitState& s, const Derived& t);
  int huff_slow(BitState& s, const Derived& t, int min_bits);
  void process_restart();
  void read_restart_marker();
  void resync_to_restart(int desired);

  void decode_mcu_seq(int mcu_x, int mcu_y, bool usefast);
  bool decode_mcu_fast(int mcu_x, int mcu_y);
  void decode_mcu_prog(int mcu_x, int mcu_y);
  int16_t* block_at(Component* c, int bx, int by) {
    return c->coef.data() + ((size_t)by * c->bw + bx) * 64;
  }
  template <typename F>
  void for_mcu_blocks(int mcu_x, int mcu_y, F f) {
    if (ncs_ == 1) {
      f(0, block_at(cs_[0], mcu_x, mcu_y));
      return;
    }
    for (int ci = 0; ci < ncs_; ++ci) {
      Component* c = cs_[ci];
      for (int y = 0; y < c->v; ++y)
        for (int x = 0; x < c->h; ++x)
          f(ci, block_at(c, mcu_x * c->h + x, mcu_y * c->v + y));
    }
  }
};

// -- markers (jdmarker.c) ----------------------------------------------------

void Jpeg::first_marker() {
  int c = input_byte();
  int c2 = input_byte();
  if (c != 0xFF || c2 != 0xD8) fail("not a JPEG file (no SOI marker)");
  unread_marker_ = c2;
}

void Jpeg::next_marker() {
  int c;
  for (;;) {
    c = input_byte();
    while (c != 0xFF) c = input_byte();
    do {
      c = input_byte();
    } while (c == 0xFF);
    if (c != 0) break;
  }
  unread_marker_ = c;
}

int Jpeg::read_markers() {
  for (;;) {
    if (unread_marker_ == 0) {
      if (!saw_soi_)
        first_marker();
      else
        next_marker();
    }
    const int m = unread_marker_;
    switch (m) {
      case 0xD8:
        if (saw_soi_) fail("JPEG has a second SOI marker");
        restart_interval_ = 0;
        jfif_ = adobe_ = false;
        saw_soi_ = true;
        break;
      case 0xC0:
      case 0xC1:
        get_sof(false, false, false);
        break;
      case 0xC2:
        get_sof(true, false, false);
        break;
      case 0xC3:
        get_sof(false, true, false);
        break;
      case 0xC9:
        get_sof(false, false, true);
        break;
      case 0xCA:
        get_sof(true, false, true);
        break;
      case 0xCB:
        get_sof(false, true, true);
        break;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        unsupported("hierarchical (differential) JPEG is not supported");
      case 0xC8:
        unsupported("JPEG marker JPG (0xC8) is not supported");
      case 0xDA:
        get_sos();
        unread_marker_ = 0;
        return 1;
      case 0xD9:
        unread_marker_ = 0;
        return 2;
      case 0xCC:
        get_dac();
        break;
      case 0xC4:
        get_dht();
        break;
      case 0xDB:
        get_dqt();
        break;
      case 0xDD:
        get_dri();
        break;
      case 0xE0:
      case 0xEE:
        get_app(m);
        break;
      case 0xD0:
      case 0xD1:
      case 0xD2:
      case 0xD3:
      case 0xD4:
      case 0xD5:
      case 0xD6:
      case 0xD7:
      case 0x01:
        break;
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
          int len = input_2bytes() - 2;
          skip(len);
          break;
        }
        fail("JPEG has an unknown marker 0x" + std::to_string(m));
    }
    unread_marker_ = 0;
  }
}

void Jpeg::get_sof(bool prog, bool lossless, bool arith) {
  int length = input_2bytes();
  precision_ = input_byte();
  height_ = input_2bytes();
  width_ = input_2bytes();
  int nc = input_byte();
  length -= 8;
  if (arith) unsupported("arithmetic-coded JPEG is not supported");
  if (lossless) unsupported("lossless JPEG is not supported");
  if (height_ <= 0 || width_ <= 0 || nc <= 0) fail("JPEG image is empty");
  if (length != nc * 3) fail("bad JPEG SOF length");
  if (saw_sof_) fail("JPEG has a second SOF marker");
  progressive_ = prog;
  comps_.assign((size_t)nc, Component());
  for (int i = 0; i < nc; ++i) {
    Component& c = comps_[(size_t)i];
    c.id = input_byte();
    int s = input_byte();
    c.h = (s >> 4) & 15;
    c.v = s & 15;
    c.tq = input_byte();
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  saw_sof_ = true;
}

void Jpeg::get_sos() {
  if (!saw_sof_) fail("JPEG SOS before SOF");
  int length = input_2bytes();
  int n = input_byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) fail("bad JPEG SOS length");
  ncs_ = n;
  for (int i = 0; i < n; ++i) {
    int cc = input_byte();
    int c = input_byte();
    Component* found = nullptr;
    for (auto& comp : comps_) {
      if (comp.id != cc) continue;
      bool dup = false;
      for (int j = 0; j < i; ++j) dup |= cs_[j] == &comp;
      if (!dup) {
        found = &comp;
        break;
      }
    }
    if (!found) fail("JPEG SOS names an unknown component");
    cs_[i] = found;
    found->dc_tbl = (c >> 4) & 15;
    found->ac_tbl = c & 15;
  }
  ss_ = input_byte();
  se_ = input_byte();
  int a = input_byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_ = 0;
}

void Jpeg::get_dht() {
  int64_t length = input_2bytes() - 2;
  while (length > 16) {
    int index = input_byte();
    uint8_t bits[17];
    bits[0] = 0;
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = (uint8_t)input_byte();
      count += bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) fail("bad JPEG Huffman table");
    uint8_t vals[256];
    std::memset(vals, 0, sizeof vals);
    for (int i = 0; i < count; ++i) vals[i] = (uint8_t)input_byte();
    length -= count;
    HuffTable* t;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) fail("bad JPEG Huffman table index");
      t = &ac_[index];
    } else {
      if (index < 0 || index >= 4) fail("bad JPEG Huffman table index");
      t = &dc_[index];
    }
    t->defined = true;
    std::memcpy(t->bits, bits, sizeof bits);
    std::memcpy(t->vals, vals, sizeof vals);
  }
  if (length != 0) fail("bad JPEG DHT length");
}

void Jpeg::get_dqt() {
  int64_t length = input_2bytes() - 2;
  while (length > 0) {
    int n = input_byte();
    int prec = n >> 4;
    n &= 15;
    if (n >= 4) fail("bad JPEG quantization table index");
    for (int i = 0; i < 64; ++i) {
      int tmp = prec ? input_2bytes() : input_byte();
      qt_[n][kNatural[i]] = (uint16_t)tmp;
    }
    qdef_[n] = true;
    length -= 64 + 1;
    if (prec) length -= 64;
  }
  if (length != 0) fail("bad JPEG DQT length");
}

void Jpeg::get_dac() {  // arithmetic conditioning: checked, then unused
  int64_t length = input_2bytes() - 2;
  while (length > 0) {
    int index = input_byte();
    int val = input_byte();
    length -= 2;
    if (index < 0 || index >= 32) fail("bad JPEG DAC table index");
    if (index < 16 && (val & 15) > (val >> 4)) fail("bad JPEG DAC value");
  }
  if (length != 0) fail("bad JPEG DAC length");
}

void Jpeg::get_dri() {
  if (input_2bytes() != 4) fail("bad JPEG DRI length");
  restart_interval_ = input_2bytes();
}

void Jpeg::get_app(int marker) {
  int64_t length = input_2bytes() - 2;
  uint8_t b[14];
  int numtoread = length >= 14 ? 14 : length > 0 ? (int)length : 0;
  for (int i = 0; i < numtoread; ++i) b[i] = (uint8_t)input_byte();
  length -= numtoread;
  if (marker == 0xE0) {
    if (numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
        b[3] == 'F' && b[4] == 0)
      jfif_ = true;
  } else if (numtoread >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' &&
             b[3] == 'b' && b[4] == 'e') {
    adobe_ = true;
    adobe_transform_ = b[11];
  }
  skip(length);
}

// -- frame and scan set-up (jdinput.c) -----------------------------------------

void Jpeg::initial_setup() {
  if (width_ > 65500 || height_ > 65500) fail("JPEG image is too big");
  if (precision_ != 8)
    unsupported(std::to_string(precision_) +
                "-bit JPEG samples are not supported");
  const int nc = (int)comps_.size();
  if (nc == 2 || nc == 4)
    unsupported(std::to_string(nc) + "-component JPEG (" +
         (nc == 4 ? "CMYK or YCCK" : "two channels") + ") is not supported");
  if (nc != 1 && nc != 3)
    unsupported(std::to_string(nc) + "-component JPEG is not supported");
  for (auto& c : comps_) {
    if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4)
      fail("bad JPEG sampling factors");
    hmax_ = c.h > hmax_ ? c.h : hmax_;
    vmax_ = c.v > vmax_ ? c.v : vmax_;
  }
  if (nc == 3) {
    const Component& y = comps_[0];
    bool ok = comps_[1].h == 1 && comps_[1].v == 1 && comps_[2].h == 1 &&
              comps_[2].v == 1 &&
              ((y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) ||
               (y.h == 2 && y.v == 2));
    if (!ok) {
      std::string f;
      for (auto& c : comps_)
        f += (f.empty() ? "" : ",") + std::to_string(c.h) + "x" +
             std::to_string(c.v);
      unsupported("JPEG sampling factors " + f +
           " are not supported (only 1x1, 2x1 or 2x2 luma over 1x1 chroma)");
    }
  }
  const int mcux = (width_ + hmax_ * 8 - 1) / (hmax_ * 8);
  const int mcuy = (height_ + vmax_ * 8 - 1) / (vmax_ * 8);
  for (auto& c : comps_) {
    c.wib = (int)(((int64_t)width_ * c.h + hmax_ * 8 - 1) / (hmax_ * 8));
    c.hib = (int)(((int64_t)height_ * c.v + vmax_ * 8 - 1) / (vmax_ * 8));
    c.dw = (int)(((int64_t)width_ * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((int64_t)height_ * c.v + vmax_ - 1) / vmax_);
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    if (c.bw < c.wib) c.bw = c.wib;
    if (c.bh < c.hib) c.bh = c.hib;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  }
}

void Jpeg::start_scan() {
  // per_scan_setup
  if (ncs_ > 1) {
    int blocks = 0;
    for (int i = 0; i < ncs_; ++i) blocks += cs_[i]->h * cs_[i]->v;
    if (blocks > 10) fail("bad JPEG MCU size");
  }
  // latch_quant_tables
  for (int i = 0; i < ncs_; ++i) {
    Component* c = cs_[i];
    if (c->latched) continue;
    if (c->tq < 0 || c->tq >= 4 || !qdef_[c->tq])
      fail("JPEG component uses an undefined quantization table");
    for (int k = 0; k < 64; ++k) c->q[k] = (int16_t)qt_[c->tq][k];
    c->latched = true;
  }
  // the standard tables fill any slot a sequential file left undefined
  // (libjpeg-turbo's jinit_huff_decoder; its progressive decoder does not)
  for (const auto& st : kStdTables) {
    if (progressive_) break;
    HuffTable& t = st.cls ? ac_[st.slot] : dc_[st.slot];
    if (t.defined) continue;
    t.defined = true;
    std::memcpy(t.bits, st.bits, 17);
    std::memset(t.vals, 0, 256);
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += st.bits[l];
    std::memcpy(t.vals, st.vals, (size_t)n);
  }
  if (progressive_) {
    const bool dc_band = ss_ == 0;
    bool bad = false;
    if (dc_band) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ >= 64) bad = true;
      if (ncs_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) fail("bad JPEG progression parameters");
    for (int i = 0; i < ncs_; ++i) {
      Component* c = cs_[i];
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
      if (dc_band) {
        if (ah_ == 0) derive(dc_, c->dc_tbl, true, dcd_[i]);
      } else {
        derive(ac_, c->ac_tbl, false, acd_[i]);
      }
      last_dc_[i] = 0;
    }
    eobrun_ = 0;
  } else {
    for (int i = 0; i < ncs_; ++i) {
      Component* c = cs_[i];
      derive(dc_, c->dc_tbl, true, dcd_[i]);
      derive(ac_, c->ac_tbl, false, acd_[i]);
      last_dc_[i] = 0;
      for (int k = 0; k < 64; ++k) c->coef_bits[k] = 0;
    }
  }
  bs_.bits = 0;
  bs_.buf = 0;
  insufficient_ = false;
  restarts_to_go_ = restart_interval_;
}

// -- the bit reader ----------------------------------------------------------

void Jpeg::fill_bits(BitState& s, int nbits) {
  if (unread_marker_ == 0) {
    while (s.bits < kMinGetBits) {
      if (s.pos >= bufend_) throw NeedMore();
      int c = d_[s.pos++];
      if (c == 0xFF) {
        do {
          if (s.pos >= bufend_) throw NeedMore();
          c = d_[s.pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker_ = c;
          goto no_more_bytes;
        }
      }
      s.buf = (s.buf << 8) | (uint64_t)c;
      s.bits += 8;
    }
    return;
  }
no_more_bytes:
  if (nbits > s.bits) {
    insufficient_ = true;
    s.buf <<= kMinGetBits - s.bits;
    s.bits = kMinGetBits;
  }
}

int Jpeg::huff_slow(BitState& s, const Derived& t, int min_bits) {
  int l = min_bits;
  int64_t code = get_bits(s, l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | get_bits(s, 1);
    ++l;
  }
  if (l > 16) return 0;  // a bad code reads as 0
  return t.vals[(int)(code + t.valoffset[l]) & 0xFF];
}

int Jpeg::huff_decode(BitState& s, const Derived& t) {
  if (s.bits < 8) {
    fill_bits(s, 0);
    if (s.bits < 8) return huff_slow(s, t, 1);
  }
  int look = (int)((s.buf >> (s.bits - 8)) & 0xFF);
  int nb = t.lookup[look] >> 8;
  if (nb <= 8) {
    s.bits -= nb;
    return t.lookup[look] & 0xFF;
  }
  return huff_slow(s, t, 9);
}

inline int huff_extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r;
}

void Jpeg::resync_to_restart(int desired) {
  int marker = unread_marker_;
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else {
      if (marker == 0xD0 + ((desired + 1) & 7) ||
          marker == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
    }
    if (action == 1) {
      unread_marker_ = 0;
      return;
    }
    if (action == 3) return;
    pos_ = bs_.pos;
    next_marker();
    bs_.pos = pos_;
    marker = unread_marker_;
  }
}

void Jpeg::read_restart_marker() {
  if (unread_marker_ == 0) {
    pos_ = bs_.pos;
    next_marker();
    bs_.pos = pos_;
  }
  if (unread_marker_ == 0xD0 + next_restart_)
    unread_marker_ = 0;
  else
    resync_to_restart(next_restart_);
  next_restart_ = (next_restart_ + 1) & 7;
}

void Jpeg::process_restart() {
  bs_.bits = 0;
  read_restart_marker();
  for (int i = 0; i < ncs_; ++i) last_dc_[i] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (unread_marker_ == 0) insufficient_ = false;
}

// -- sequential Huffman MCUs (jdhuff.c) -----------------------------------------

bool Jpeg::decode_mcu_fast(int mcu_x, int mcu_y) {
  BitState s = bs_;
  int dc[4];
  std::memcpy(dc, last_dc_, sizeof dc);
  bool hit_marker = false;
  auto fill_fast = [&]() {
    if (s.bits > 16) return;
    for (int i = 0; i < 6; ++i) {
      int c0 = d_[s.pos++];
      int c1 = d_[s.pos];
      s.buf = (s.buf << 8) | (uint64_t)c0;
      s.bits += 8;
      if (c0 == 0xFF) {
        ++s.pos;
        if (c1 != 0) {
          hit_marker = true;
          s.pos -= 2;
          s.buf &= ~(uint64_t)0xFF;
        }
      }
    }
  };
  auto decode_fast = [&](const Derived& t) -> int {
    fill_fast();
    int look = (int)((s.buf >> (s.bits - 8)) & 0xFF);
    int v = t.lookup[look];
    int nb = v >> 8;
    s.bits -= nb;
    int r = v & 0xFF;
    if (nb > 8) {
      int64_t code = (int64_t)((s.buf >> s.bits) & ((1u << nb) - 1));
      while (code > t.maxcode[nb]) {
        s.bits -= 1;
        code = (code << 1) | (int64_t)((s.buf >> s.bits) & 1);
        ++nb;
      }
      r = nb > 16 ? 0 : t.vals[(int)(code + t.valoffset[nb]) & 0xFF];
    }
    return r;
  };
  auto bits_fast = [&](int n) -> int {
    s.bits -= n;
    return (int)((s.buf >> s.bits) & ((1u << n) - 1));
  };
  // values land in scratch first: the MCU is redone from its start when a
  // marker turns up, as libjpeg-turbo redoes it on its slow path
  int16_t scratch[10][64];
  int16_t* dst[10];
  int nblk = 0;
  for_mcu_blocks(mcu_x, mcu_y, [&](int ci, int16_t* blk) {
    dst[nblk] = blk;
    int16_t* b = scratch[nblk++];
    std::memset(b, 0, 128);
    const Derived& dt = dcd_[ci];
    const Derived& at = acd_[ci];
    int sv = decode_fast(dt);
    if (sv) {
      fill_fast();
      int r = bits_fast(sv);
      sv = huff_extend(r, sv);
    }
    dc[ci] = (int)((unsigned)sv + (unsigned)dc[ci]);
    b[0] = (int16_t)dc[ci];
    for (int k = 1; k < 64; ++k) {
      int v = decode_fast(at);
      int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        fill_fast();
        r = bits_fast(v);
        b[kNatural[k]] = (int16_t)huff_extend(r, v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  });
  if (hit_marker) return false;
  for (int i = 0; i < nblk; ++i) std::memcpy(dst[i], scratch[i], 128);
  std::memcpy(last_dc_, dc, sizeof dc);
  bs_ = s;
  return true;
}

void Jpeg::decode_mcu_seq(int mcu_x, int mcu_y, bool usefast) {
  if (insufficient_) return;  // the rest of the segment stays zero
  if (usefast && decode_mcu_fast(mcu_x, mcu_y)) return;
  BitState s = bs_;
  int dc[4];
  std::memcpy(dc, last_dc_, sizeof dc);
  int16_t scratch[10][64];
  int16_t* dst[10];
  int nblk = 0;
  for_mcu_blocks(mcu_x, mcu_y, [&](int ci, int16_t* blk) {
    dst[nblk] = blk;
    int16_t* b = scratch[nblk++];
    std::memset(b, 0, 128);
    int sv = huff_decode(s, dcd_[ci]);
    if (sv) {
      int r = get_bits(s, sv);
      sv = huff_extend(r, sv);
    }
    dc[ci] = (int)((unsigned)sv + (unsigned)dc[ci]);
    b[0] = (int16_t)dc[ci];
    for (int k = 1; k < 64; ++k) {
      int v = huff_decode(s, acd_[ci]);
      int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        r = get_bits(s, v);
        b[kNatural[k]] = (int16_t)huff_extend(r, v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  });
  for (int i = 0; i < nblk; ++i) std::memcpy(dst[i], scratch[i], 128);
  std::memcpy(last_dc_, dc, sizeof dc);
  bs_ = s;
}

// -- progressive Huffman MCUs (jdphuff.c) ---------------------------------------

void Jpeg::decode_mcu_prog(int mcu_x, int mcu_y) {
  const bool dc_band = ss_ == 0;
  if (dc_band && ah_ == 0) {  // DC first
    if (insufficient_) return;
    BitState s = bs_;
    int dc[4];
    std::memcpy(dc, last_dc_, sizeof dc);
    struct W {
      int16_t* b;
      int16_t v;
    } w[10];
    int nw = 0;
    for_mcu_blocks(mcu_x, mcu_y, [&](int ci, int16_t* blk) {
      int sv = huff_decode(s, dcd_[ci]);
      if (sv) {
        int r = get_bits(s, sv);
        sv = huff_extend(r, sv);
      }
      dc[ci] = (int)((unsigned)sv + (unsigned)dc[ci]);
      w[nw++] = {blk, (int16_t)((unsigned)dc[ci] << al_)};
    });
    for (int i = 0; i < nw; ++i) w[i].b[0] = w[i].v;
    std::memcpy(last_dc_, dc, sizeof dc);
    bs_ = s;
    return;
  }
  if (dc_band) {  // DC refine: no insufficient-data check in libjpeg
    BitState s = bs_;
    const int p1 = 1 << al_;
    int16_t* blks[10];
    int bits[10];
    int n = 0;
    for_mcu_blocks(mcu_x, mcu_y, [&](int, int16_t* blk) {
      blks[n] = blk;
      bits[n++] = get_bits(s, 1);
    });
    for (int i = 0; i < n; ++i)
      if (bits[i]) blks[i][0] = (int16_t)(blks[i][0] | p1);
    bs_ = s;
    return;
  }
  if (insufficient_) return;
  int16_t* blk = block_at(cs_[0], mcu_x, mcu_y);
  const Derived& t = acd_[0];
  if (ah_ == 0) {  // AC first
    unsigned eob = eobrun_;
    if (eob > 0) {
      eobrun_ = eob - 1;
      return;
    }
    BitState s = bs_;
    int16_t b[64];
    std::memcpy(b, blk, 128);
    for (int k = ss_; k <= se_; ++k) {
      int v = huff_decode(s, t);
      int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        r = get_bits(s, v);
        v = huff_extend(r, v);
        b[kNatural[k]] = (int16_t)((unsigned)v << al_);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eob = 1u << r;
          if (r) eob += (unsigned)get_bits(s, r);
          --eob;
          break;
        }
      }
    }
    std::memcpy(blk, b, 128);
    eobrun_ = eob;
    bs_ = s;
    return;
  }
  // AC refine
  const int p1 = 1 << al_;
  const int m1 = -1 * (1 << al_);
  BitState s = bs_;
  unsigned eob = eobrun_;
  int16_t b[64];
  std::memcpy(b, blk, 128);
  int k = ss_;
  auto refine = [&](int16_t& coef) {
    if (get_bits(s, 1)) {
      if ((coef & p1) == 0) {
        if (coef >= 0)
          coef = (int16_t)(coef + p1);
        else
          coef = (int16_t)(coef + m1);
      }
    }
  };
  if (eob == 0) {
    for (; k <= se_; ++k) {
      int v = huff_decode(s, t);
      int r = v >> 4;
      v &= 15;
      if (v) {
        v = get_bits(s, 1) ? p1 : m1;
      } else if (r != 15) {
        eob = 1u << r;
        if (r) eob += (unsigned)get_bits(s, r);
        break;
      }
      do {
        int16_t& coef = b[kNatural[k]];
        if (coef != 0) {
          refine(coef);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se_);
      if (v) b[kNatural[k]] = (int16_t)v;
    }
  }
  if (eob > 0) {
    for (; k <= se_; ++k) {
      int16_t& coef = b[kNatural[k]];
      if (coef != 0) refine(coef);
    }
    --eob;
  }
  std::memcpy(blk, b, 128);
  eobrun_ = eob;
  bs_ = s;
}

void Jpeg::decode_scan() {
  int mcux, mcuy, blocks;
  if (ncs_ == 1) {
    mcux = cs_[0]->wib;
    mcuy = cs_[0]->hib;
    blocks = 1;
  } else {
    mcux = (width_ + hmax_ * 8 - 1) / (hmax_ * 8);
    mcuy = (height_ + vmax_ * 8 - 1) / (vmax_ * 8);
    blocks = 0;
    for (int i = 0; i < ncs_; ++i) blocks += cs_[i]->h * cs_[i]->v;
  }
  bs_.pos = pos_;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (;;) {
        // the state at the MCU's start, to redo it when Pillow has to hand
        // libjpeg its next chunk (libjpeg suspends and starts the MCU anew)
        const BitState saved = bs_;
        const int saved_marker = unread_marker_;
        const bool saved_insuff = insufficient_;
        const int saved_restarts = restarts_to_go_;
        const int saved_next_rst = next_restart_;
        const unsigned saved_eob = eobrun_;
        int saved_dc[4];
        std::memcpy(saved_dc, last_dc_, sizeof saved_dc);
        try {
          bool usefast = true;
          if (restart_interval_) {
            if (restarts_to_go_ == 0) process_restart();
            usefast = false;
          }
          if (progressive_) {
            decode_mcu_prog(mx, my);
          } else {
            if (bufend_ - bs_.pos < (uint64_t)512 * blocks ||
                unread_marker_ != 0)
              usefast = false;
            decode_mcu_seq(mx, my, usefast);
          }
          if (restart_interval_) --restarts_to_go_;
          break;
        } catch (NeedMore&) {
          bs_ = saved;
          unread_marker_ = saved_marker;
          insufficient_ = saved_insuff;
          restarts_to_go_ = saved_restarts;
          next_restart_ = saved_next_rst;
          eobrun_ = saved_eob;
          std::memcpy(last_dc_, saved_dc, sizeof saved_dc);
          more();
        }
      }
    }
  }
  pos_ = bs_.pos;
}

// -- output (jidctint.c, jdsample.c, jdcolor.c) ---------------------------------

// The "islow" IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) as Pillow's
// libjpeg-turbo runs it, in its AVX2 form (jidctint-avx2.asm): coefficients
// are dequantized into 16-bit lanes, in0 +- in4, in7 + in3 and in5 + in1 are
// 16-bit sums, the products are 32-bit pair sums (pmaddwd), each pass is
// saturated to 16 bits and the output to 8 bits around 128; a block whose
// rows 1-7 are all zero takes pass 1 as its DC row shifted in 16 bits. On
// data that fits, this equals the C code; on damaged data it is what Pillow
// gives.
inline int16_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) {
  return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
inline int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// one 8-point pass over in[0..7]; out[i] = the pass's 32-bit results
inline void idct_pass(const int16_t* in, int32_t* out) {
  const int32_t F054 = 4433, F130 = 4433 + 6270, MF130 = 4433 - 15137;
  const int32_t F117 = 9633, MF078 = 9633 - 16069, F078 = 9633 - 3196;
  const int32_t MF060 = 2446 - 7373, MF089 = -7373, MF050 = 16819 - 20995,
                MF256 = -20995, F050 = 25172 - 20995, F060 = 12299 - 7373;
  const int32_t i0 = in[0], i1 = in[1], i2 = in[2], i3 = in[3], i4 = in[4],
                i5 = in[5], i6 = in[6], i7 = in[7];
  int32_t tmp3 = add32(i2 * F130, i6 * F054);
  int32_t tmp2 = add32(i2 * F054, i6 * MF130);
  int32_t t0 = (int32_t)((uint32_t)(int32_t)w16(i0 + i4) << 13);
  int32_t t1 = (int32_t)((uint32_t)(int32_t)w16(i0 - i4) << 13);
  int32_t t10 = add32(t0, tmp3), t13 = sub32(t0, tmp3);
  int32_t t11 = add32(t1, tmp2), t12 = sub32(t1, tmp2);
  int32_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
  int32_t z3p = add32(z3 * MF078, z4 * F117);
  int32_t z4p = add32(z3 * F117, z4 * F078);
  int32_t o0 = add32(add32(i7 * MF060, i1 * MF089), z3p);
  int32_t o1 = add32(add32(i5 * MF050, i3 * MF256), z4p);
  int32_t o2 = add32(add32(i5 * MF256, i3 * F050), z3p);
  int32_t o3 = add32(add32(i7 * MF089, i1 * F060), z4p);
  out[0] = add32(t10, o3);
  out[7] = sub32(t10, o3);
  out[1] = add32(t11, o2);
  out[6] = sub32(t11, o2);
  out[2] = add32(t12, o1);
  out[5] = sub32(t12, o1);
  out[3] = add32(t13, o0);
  out[4] = sub32(t13, o0);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int16_t dq[64], ws[64];
  for (int k = 0; k < 64; ++k) dq[k] = w16((int32_t)in[k] * q[k]);
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      int16_t v = w16((int32_t)((uint32_t)(int32_t)dq[c] << 2));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8];
      int32_t res[8];
      for (int r = 0; r < 8; ++r) col[r] = dq[8 * r + c];
      idct_pass(col, res);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = sat16(add32(res[r], 1 << 10) >> 11);
    }
  }
  for (int r = 0; r < 8; ++r) {
    int32_t res[8];
    idct_pass(ws + 8 * r, res);
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t v = sat16(add32(res[c], 1 << 17) >> 18);
      v = v < -128 ? -128 : v > 127 ? 127 : v;
      op[c] = (uint8_t)(v + 128);
    }
  }
}

// One output row of a chroma plane upsampled to full width (jdsample.c):
// `row` is the nearest chroma row, `other` the next nearest (h2v2 only).
void upsample_row(const uint8_t* row, const uint8_t* other, int dw, int h,
                  int v, uint8_t* out, int outw) {
  if (h == 1) {  // full size (v is 1 too)
    std::memcpy(out, row, (size_t)outw);
    return;
  }
  std::vector<uint8_t> tmp((size_t)dw * 2);
  uint8_t* o = tmp.data();
  if (dw <= 2) {  // plain replication
    for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = row[x];
  } else if (v == 1) {  // h2v1 fancy
    o[0] = row[0];
    o[1] = (uint8_t)((row[0] * 3 + row[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      int iv = row[x] * 3;
      o[2 * x] = (uint8_t)((iv + row[x - 1] + 1) >> 2);
      o[2 * x + 1] = (uint8_t)((iv + row[x + 1] + 2) >> 2);
    }
    o[2 * dw - 2] = (uint8_t)((row[dw - 1] * 3 + row[dw - 2] + 1) >> 2);
    o[2 * dw - 1] = row[dw - 1];
  } else {  // h2v2 fancy
    auto cs = [&](int x) { return row[x] * 3 + other[x]; };
    int this_ = cs(0), next = cs(1), last;
    o[0] = (uint8_t)((this_ * 4 + 8) >> 4);
    o[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
    last = this_;
    this_ = next;
    for (int x = 1; x < dw - 1; ++x) {
      next = cs(x + 1);
      o[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
      o[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
    }
    o[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
    o[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
  }
  std::memcpy(out, o, (size_t)outw);
}

void Jpeg::finish_output(int64_t W, int64_t H, int nc, uint8_t* out) {
  if (W != width_ || H != height_ || nc != (int)comps_.size())
    fail("JPEG frame does not match its header");
  // IDCT every block inside each component's width and height in blocks
  std::vector<std::vector<uint8_t>> planes(comps_.size());
  std::vector<int> pstride(comps_.size());
  for (size_t ci = 0; ci < comps_.size(); ++ci) {
    Component& c = comps_[ci];
    const int stride = c.wib * 8;
    pstride[ci] = stride;
    planes[ci].assign((size_t)stride * c.hib * 8, 0);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(block_at(&c, bx, by), c.q,
                   planes[ci].data() + (size_t)by * 8 * stride + bx * 8,
                   stride);
  }
  if (nc == 1) {
    for (int64_t y = 0; y < H; ++y)
      std::memcpy(out + y * W, planes[0].data() + y * pstride[0], (size_t)W);
    return;
  }
  // colour space as libjpeg guesses it (jdapimin.c default_decompress_parms)
  bool ycc;
  if (jfif_)
    ycc = true;
  else if (adobe_)
    ycc = adobe_transform_ != 0;
  else
    ycc = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static bool tables = false;
  if (!tables) {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    tables = true;
  }
  const int hs = comps_[0].h, vs = comps_[0].v;
  std::vector<uint8_t> up1((size_t)W), up2((size_t)W);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* Y = planes[0].data() + y * pstride[0];
    for (int k = 1; k <= 2; ++k) {
      Component& c = comps_[(size_t)k];
      uint8_t* dst = k == 1 ? up1.data() : up2.data();
      const uint8_t* p = planes[(size_t)k].data();
      const int st = pstride[(size_t)k];
      if (vs == 2) {
        int64_t r = y / 2;
        int64_t o = (y & 1) ? (r + 1 < c.dh ? r + 1 : c.dh - 1)
                            : (r > 0 ? r - 1 : 0);
        upsample_row(p + r * st, p + o * st, c.dw, hs, vs, dst, (int)W);
      } else {
        upsample_row(p + y * st, nullptr, c.dw, hs, vs, dst, (int)W);
      }
    }
    uint8_t* o = out + y * W * 3;
    if (!ycc) {
      for (int64_t x = 0; x < W; ++x) {
        o[3 * x] = Y[x];
        o[3 * x + 1] = up1[(size_t)x];
        o[3 * x + 2] = up2[(size_t)x];
      }
      continue;
    }
    for (int64_t x = 0; x < W; ++x) {
      int yy = Y[x], cb = up1[(size_t)x], cr = up2[(size_t)x];
      auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
      o[3 * x] = clamp(yy + cr_r[cr]);
      o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp(yy + cb_b[cb]);
    }
  }
}

void Jpeg::decode(int64_t W, int64_t H, int nc, uint8_t* out) {
  const char* truncated = "JPEG image file is truncated";
  int r;
  try {
    r = read_markers();  // jpeg_read_header: up to the first SOS
  } catch (Eof&) {
    fail(truncated);
  }
  if (r == 2) fail("JPEG has no image (EOI before SOS)");
  initial_setup();
  const bool multiscan = ncs_ < (int)comps_.size() || progressive_;
  for (;;) {
    start_scan();
    try {
      decode_scan();
    } catch (Eof&) {
      fail(truncated);
    }
    if (!multiscan) {
      // the rows are out; jpeg_finish_decompress reads on to EOI and stops
      // quietly where the data ends
      try {
        if (read_markers() == 1)
          fail("JPEG has a second scan after a single-scan frame");
      } catch (Eof&) {
      }
      break;
    }
    try {
      r = read_markers();  // a multi-scan file is read whole, to EOI
    } catch (Eof&) {
      fail(truncated);
    }
    if (r == 2) break;
  }
  if (progressive_) {
    // libjpeg smooths blocks whose low AC coefficients no scan completed
    // (jdcoefct.c smoothing_ok); such files are not supported here
    for (auto& c : comps_) {
      if (c.coef_bits[0] < 0) continue;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          unsupported("progressive JPEG whose scans leave coefficients "
                      "unfinished (libjpeg's block smoothing) is not "
                      "supported");
    }
  }
  finish_output(W, H, nc, out);
}

}  // namespace

extern "C" {

int vo_png_decode(const uint8_t* raw, int64_t raw_len, int64_t width,
                  int64_t height, int32_t depth, int32_t ctype,
                  int32_t interlace, int32_t out_elem, uint8_t* out,
                  char* err, int32_t err_len) {
  try {
    png_decode(raw, (size_t)raw_len, width, height, depth, ctype, interlace,
               out_elem, out);
    return 0;
  } catch (Fail& f) {
    set_err(err, err_len, f.msg);
    return f.code;
  } catch (std::exception& e) {
    set_err(err, err_len, std::string("PNG decoding failed: ") + e.what());
  }
  return 1;
}

int vo_jpeg_decode(const uint8_t* data, int64_t len, int64_t width,
                   int64_t height, int32_t ncomp, uint8_t* out, char* err,
                   int32_t err_len) {
  try {
    Jpeg j(data, (uint64_t)len);
    j.decode(width, height, ncomp, out);
    return 0;
  } catch (Fail& f) {
    set_err(err, err_len, f.msg);
    return f.code;
  } catch (std::exception& e) {
    set_err(err, err_len, std::string("JPEG decoding failed: ") + e.what());
  }
  return 1;
}

}  // extern "C"
