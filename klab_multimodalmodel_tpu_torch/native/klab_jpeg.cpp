// JPEG decoder of the port's C++ host runtime, built into the same library
// as klab_host.cpp (see __init__.py beside this file).
//
// It gives, bit for bit, what Pillow's JpegImageFile gives through
// libjpeg-turbo with Pillow's settings (JDCT_ISLOW, fancy upsampling on, block
// smoothing on) for a draft scale 1/s, s in {1, 2, 4, 8}, followed by
// Image.convert("RGB"):
//   * the 8x8 accurate integer IDCT of jidctint.c, and at s = 2, 4, 8 the
//     reduced 4x4, 2x2 and 1x1 IDCTs of jidctred.c, chosen per component as
//     jdmaster.c does (a subsampled component is scaled up by the IDCT where
//     it can be, so 4:2:0 at s = 2 runs the chroma's full 8x8 IDCT and
//     upsamples nothing), in the arithmetic of libjpeg-turbo's x86 SIMD
//     versions (see the IDCT section);
//   * jdsample.c's upsamplers: fancy h2v1, h2v2 and h1v2 (the edge rows and
//     columns replicated as jdmainct.c supplies them), and replication by
//     any integer ratio where a component is at most 2 samples wide, the
//     scale is 1/8 or the ratio is another one (jinit_upsampler's choice);
//   * jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK tables, then
//     Pillow's "CMYK;I" unpacking and its cmyk2rgb, or gray replicated;
//   * the colour space chosen as jdapimin.c chooses it (JFIF, Adobe
//     transform, component ids); no EXIF orientation, no ICC profile;
//   * jdcoefct.c's block smoothing of progressive images whose scans leave
//     low-frequency coefficients unrefined;
//   * libjpeg's recovery from damaged entropy-coded data, where Pillow
//     returns pixels: a segment that ends early reads as zero bits and
//     leaves the rest of its MCUs out, a bad Huffman code reads as symbol
//     0, restart markers out of order are resynchronized; jdarith.c's zero
//     data past a marker and its latch after a bad code;
//   * Pillow's decision between pixels and an error: its own walk of the
//     markers up to the first SOS (JpegImageFile._open) and its refusals
//     there; its 65536-byte reads of the file, which libjpeg suspends on
//     (a Huffman scan whose data runs into the end of the file is
//     truncated exactly where jdhuff.c asks for bytes past it) and which
//     jdarith.c cannot suspend on (arithmetic-coded data across such a
//     read raises).
// Baseline, extended sequential and progressive frames with 8-bit samples,
// Huffman or arithmetic coding, 1, 3 or 4 components and any sampling
// factors that libjpeg takes, and lossless (SOF3) frames at scale 1 without
// a colour transform, are decoded. Everything else (12-bit, hierarchical,
// lossless at a draft scale) is refused with the reason, as is a malformed
// or truncated stream.
//
// The input is untrusted: every read is bounds-checked, every table index
// and component reference is validated, and the image size is checked from
// the SOF (against libjpeg's 65500 and Pillow's 2 * MAX_IMAGE_PIXELS)
// before anything is allocated.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <initializer_list>
#include <new>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string what;
  bool truncated = false;  // the data ended before libjpeg was done
};

template <class... A>
[[noreturn]] void fail(const char* fmt, A... args) {
  char buf[256];
  if constexpr (sizeof...(A) == 0) {
    std::snprintf(buf, sizeof buf, "%s", fmt);
  } else {
    std::snprintf(buf, sizeof buf, fmt, args...);
  }
  throw JpegError{buf};
}

constexpr int kMaxDimension = 65500;            // libjpeg's JPEG_MAX_DIMENSION
constexpr int64_t kMaxPixels = 2LL * 89478485;  // 2 * PIL.Image.MAX_IMAGE_PIXELS
constexpr int kMaxBlocksInMcu = 10;             // libjpeg's D_MAX_BLOCKS_IN_MCU
constexpr size_t kPillowRead = 65536;           // PIL.ImageFile.MAXBLOCK
constexpr int kMinGetBits = 57;                 // jdhuff.h MIN_GET_BITS (64-bit)
constexpr size_t kFastBytesPerBlock = 512;      // jdhuff.c BUFSIZE

// Zigzag index -> natural index, with libjpeg's 16 extra entries so that a
// corrupt run past the block's end lands on the last coefficient.
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU T.81 K.3), which libjpeg-turbo puts in
// table slots 0 and 1 of a sequential file that defines none there (Motion
// JPEG frames).
constexpr uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                       1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcLumVals[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcChrVals[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                       5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdAcLumVals[] = {
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
constexpr uint8_t kStdAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdAcChrVals[] = {
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

// --------------------------------------------------------------------------
// Huffman tables (jdhuff.c jpeg_make_d_derived_tbl, jpeg_huff_decode)
// --------------------------------------------------------------------------

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  // Derived: canonical decoding by length, and an 8-bit lookahead.
  bool derived = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];  // (length << 8) | symbol; 0 where no code <= 8 bits

  void set(const uint8_t* b, const uint8_t* v, int count) {
    std::memcpy(bits, b, 17);
    std::memset(vals, 0, sizeof vals);
    std::memcpy(vals, v, count);
    defined = true;
    derived = false;
  }

  // max_dc: the largest DC symbol (15; a lossless difference's size, 16).
  void derive(bool is_dc, int max_dc = 15) {
    if (derived) return;
    char huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
      if (p + i > 256) fail("corrupt data: a Huffman table holds over 256 codes");
      while (i--) huffsize[p++] = static_cast<char>(l);
    }
    huffsize[p] = 0;
    int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si))
        fail("corrupt data: a Huffman table's code lengths overflow");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;  // ends the slow decode's loop
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (is_dc) {
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > max_dc)
          fail("corrupt data: a DC Huffman table holds a size over %d",
               max_dc);
    }
    derived = true;
  }
};

// --------------------------------------------------------------------------
// Entropy-coded segment reader (jdhuff.c jpeg_fill_bit_buffer,
// jpeg_huff_decode)
// --------------------------------------------------------------------------

// What one MCU asked of the bit reader, for FillModel: a Huffman code of
// `bits` bits (huffman) or `bits` raw bits, `at` bits into the segment.
struct BitEvent {
  int64_t at;
  int bits;
  bool huffman;
};

struct BitReader {
  const uint8_t* data = nullptr;
  size_t end = 0;
  size_t pos = 0;     // next byte of the segment
  uint64_t buf = 0;   // right-aligned bits
  int count = 0;      // bits in buf
  int padding = 0;    // of those, zero bits stuffed past a marker or the end
  int64_t used = 0;   // bits taken since the segment's start
  bool stopped = false;
  bool at_end = false;  // stopped at the end of the data, not at a marker
  // libjpeg's insufficient_data: a decode needed bits past a marker. The
  // bits read as zeros; the scan skips its MCUs up to the next restart.
  bool insufficient = false;
  std::vector<BitEvent>* events = nullptr;  // recorded where not null

  void start(const uint8_t* d, size_t n, size_t p) {
    data = d;
    end = n;
    pos = p;
    buf = 0;
    count = padding = 0;
    used = 0;
    stopped = at_end = false;
  }

  void fill() {
    while (count <= 56) {
      if (!stopped) {
        if (pos >= end) {
          stopped = at_end = true;
          continue;
        }
        uint32_t c = data[pos];
        if (c == 0xFF) {
          // FF FF ... FF 00 is one data byte FF; FF FF ... FF xx a marker,
          // left unread for the marker parser.
          size_t q = pos + 1;
          while (q < end && data[q] == 0xFF) q++;
          if (q >= end) {
            stopped = at_end = true;
            continue;
          }
          if (data[q] != 0) {
            stopped = true;
            continue;
          }
          pos = q + 1;
        } else {
          pos++;
        }
        buf = (buf << 8) | c;
        count += 8;
      } else {
        buf <<= 8;
        count += 8;
        padding += 8;
      }
    }
  }

  inline uint32_t peek(int n) {
    if (count < n) fill();
    return static_cast<uint32_t>(buf >> (count - n)) & ((1u << n) - 1);
  }

  inline void skip(int n) {
    count -= n;
    used += n;
    if (count < padding) {
      // Where the data ends with no marker, libjpeg waits for more and
      // Pillow calls the file truncated.
      if (at_end)
        fail("truncated: the data ends inside an entropy-coded segment");
      insufficient = true;
      padding = count;
    }
  }

  inline uint32_t get(int n) {
    if (n == 0) return 0;
    if (events) events->push_back({used, n, false});
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  // A code that no length up to 16 matches reads as symbol 0, its 17 bits
  // consumed, as libjpeg reads it.
  inline int decode(const Huffman& h) {
    if (count < 17) fill();
    const int64_t at = used;
    uint32_t look = static_cast<uint32_t>(buf >> (count - 8)) & 0xFF;
    uint16_t e = h.look[look];
    int length = 17, symbol = 0;
    if (e) {
      length = e >> 8;
      symbol = e & 0xFF;
    } else {
      uint32_t code16 = static_cast<uint32_t>(buf >> (count - 16)) & 0xFFFF;
      for (int l = 9; l <= 16; l++) {
        int32_t code = static_cast<int32_t>(code16 >> (16 - l));
        if (code <= h.maxcode[l]) {
          length = l;
          symbol = h.vals[(code + h.valoffset[l]) & 0xFF];
          break;
        }
      }
    }
    if (events) events->push_back({at, length, true});
    skip(length);
    return symbol;
  }
};

// --------------------------------------------------------------------------
// When libjpeg asks for bytes (jdhuff.c jpeg_fill_bit_buffer, decode_mcu's
// fast and slow paths), replayed from what an MCU asked of the bit reader
// (BitEvent). Pillow feeds libjpeg the file in reads of kPillowRead bytes;
// where libjpeg asks for a byte past the ones read so far, it suspends and
// the MCU starts again once the next read has come. Where the file has no
// more, Pillow raises "image file is truncated". So a scan whose data runs
// into the end of the file with no marker is truncated exactly where a
// refill finds fewer than kMinGetBits bits before the end, whether or not
// the decode needed them. The bits that libjpeg holds are `loaded` (data
// bits read since the segment's start, and zero bits past a marker) less
// the bits the decode has taken.
// --------------------------------------------------------------------------

struct FillModel {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t next = 0;      // libjpeg's next_input_byte
  int64_t loaded = 0;
  bool marker = false;  // libjpeg's unread_marker: no byte is read past it

  void start(const uint8_t* data, size_t size, size_t p, bool at_marker) {
    d = data;
    n = size;
    next = p;
    loaded = 0;
    marker = at_marker;
  }

  // jpeg_fill_bit_buffer at `at` bits taken, for `nbits`: false where it
  // asks for a byte at `limit` or past it (`*need` is that byte).
  bool fill(int64_t at, int nbits, size_t limit, size_t* need) {
    if (!marker) {
      while (loaded - at < kMinGetBits) {
        if (next >= limit) {
          *need = next;
          return false;
        }
        int c = d[next++];
        if (c == 0xFF) {
          do {
            if (next >= limit) {
              *need = next;
              return false;
            }
            c = d[next++];
          } while (c == 0xFF);
          if (c != 0) {
            marker = true;
            break;
          }
        }
        loaded += 8;
      }
    }
    if (marker && nbits > loaded - at) loaded = at + kMinGetBits;
    return true;
  }

  // The slow path (decode_mcu_slow, jpeg_huff_decode) over one MCU's
  // events: HUFF_DECODE refills below 8 bits, a code longer than 8 bits
  // checks for 9 and then one bit at a time, raw bits check for their
  // count.
  bool slow(const std::vector<BitEvent>& ev, size_t limit, size_t* need) {
    for (const BitEvent& e : ev) {
      if (!e.huffman) {
        if (loaded - e.at < e.bits && !fill(e.at, e.bits, limit, need))
          return false;
        continue;
      }
      if (loaded - e.at < 8) {
        if (!fill(e.at, 0, limit, need)) return false;
        if (loaded - e.at < 8) {  // at a marker: one bit at a time
          for (int i = 0; i < e.bits; i++)
            if (loaded - (e.at + i) < 1 && !fill(e.at + i, 1, limit, need))
              return false;
          continue;
        }
      }
      if (e.bits <= 8) continue;
      if (loaded - e.at < 9 && !fill(e.at, 9, limit, need)) return false;
      for (int i = 9; i < e.bits; i++)
        if (loaded - (e.at + i) < 1 && !fill(e.at + i, 1, limit, need))
          return false;
    }
    return true;
  }

  // The fast path (decode_mcu_fast): FILL_BIT_BUFFER_FAST, six bytes at
  // most 16 bits, before each code and each nonzero value's bits. False
  // where it meets a marker: libjpeg then decodes the MCU again on the
  // slow path.
  bool fast(const std::vector<BitEvent>& ev) {
    for (const BitEvent& e : ev) {
      if (loaded - e.at > 16) continue;
      for (int i = 0; i < 6; i++) {
        if (next + 1 >= n) return false;
        int c0 = d[next], c1 = d[next + 1];
        next += c0 == 0xFF ? 2 : 1;
        loaded += 8;
        if (c0 == 0xFF && c1 != 0) return false;
      }
    }
    return true;
  }
};

inline int extend(uint32_t r, int s) {
  // HUFF_EXTEND
  int v = static_cast<int>(r);
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// --------------------------------------------------------------------------
// IDCTs: jidctint.c jpeg_idct_islow (8x8) and jidctred.c jpeg_idct_4x4,
// 2x2, 1x1, in the arithmetic of libjpeg-turbo's x86 SIMD versions, which
// Pillow's libjpeg-turbo runs for the first three: the dequantized
// coefficients and the first pass's outputs held in 16-bit lanes (a product
// or a sum of two coefficients wraps there, a pass's output saturates),
// 32-bit products and sums, and the output saturated to [0, 255]. Wherever
// the values stay in range (every file an encoder writes) this equals the
// C code; on corrupt data, where the C code's range limit would wrap, it
// keeps Pillow's pixels. The 1x1 IDCT has no SIMD version: it is the C
// code, with libjpeg's post-IDCT range-limit table.
// --------------------------------------------------------------------------

inline int32_t wrap32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}
inline int16_t wrap16(int32_t x) {
  return static_cast<int16_t>(static_cast<uint16_t>(x));
}
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(std::clamp(x, -32768, 32767));
}
// DESCALE: round, then an arithmetic shift right (paddd, psrad).
inline int32_t descale(int32_t x, int n) {
  return wrap32(int64_t(x) + (1 << (n - 1))) >> n;
}
// a * ca + b * cb of two 16-bit lanes (pmaddwd).
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
  return wrap32(int64_t(a) * ca + int64_t(b) * cb);
}
inline int32_t add(int32_t a, int32_t b) { return wrap32(int64_t(a) + b); }
inline int32_t sub(int32_t a, int32_t b) { return wrap32(int64_t(a) - b); }
// A coefficient times its quantization step (pmullw).
inline int16_t dequant(int16_t coef, int16_t q) {
  return wrap16(int32_t(coef) * q);
}
// The output stage: 16-bit, then 8-bit signed saturation, recentred.
inline uint8_t sample(int32_t v) {
  return static_cast<uint8_t>(std::clamp<int32_t>(sat16(v), -128, 127) + 128);
}

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

// One 1-D 8-point islow IDCT over 16-bit inputs, descaled by n. The even
// part's z2 + z3 and the odd part's in7 + in3, in5 + in1 are 16-bit sums;
// the rotations are jidctint.c's with their constants folded into pairs.
void islow_1d(const int16_t in[8], int32_t out[8], int n) {
  constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                    F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                    F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                    F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int32_t tmp2 = madd(in[2], F0_541, in[6], F0_541 - F1_847);
  int32_t tmp3 = madd(in[2], F0_541 + F0_765, in[6], F0_541);
  int32_t tmp0 = int32_t(wrap16(int32_t(in[0]) + in[4])) * (1 << CONST_BITS);
  int32_t tmp1 = int32_t(wrap16(int32_t(in[0]) - in[4])) * (1 << CONST_BITS);
  int32_t t10 = add(tmp0, tmp3), t13 = sub(tmp0, tmp3);
  int32_t t11 = add(tmp1, tmp2), t12 = sub(tmp1, tmp2);
  int16_t z3 = wrap16(int32_t(in[7]) + in[3]);
  int16_t z4 = wrap16(int32_t(in[5]) + in[1]);
  int32_t z3r = madd(z3, F1_175 - F1_961, z4, F1_175);
  int32_t z4r = madd(z3, F1_175, z4, F1_175 - F0_390);
  int32_t o0 = add(madd(in[7], F0_298 - F0_899, in[1], -F0_899), z3r);
  int32_t o3 = add(madd(in[7], -F0_899, in[1], F1_501 - F0_899), z4r);
  int32_t o1 = add(madd(in[5], F2_053 - F2_562, in[3], -F2_562), z4r);
  int32_t o2 = add(madd(in[5], -F2_562, in[3], F3_072 - F2_562), z3r);
  out[0] = descale(add(t10, o3), n);
  out[7] = descale(sub(t10, o3), n);
  out[1] = descale(add(t11, o2), n);
  out[6] = descale(sub(t11, o2), n);
  out[2] = descale(add(t12, o1), n);
  out[5] = descale(sub(t12, o1), n);
  out[3] = descale(add(t13, o0), n);
  out[4] = descale(sub(t13, o0), n);
}

// Where every AC coefficient is zero, the first pass is the shifted
// dequantized DC (a 16-bit shift) in every row.
bool dc_only(const int16_t* in, std::initializer_list<int> rows) {
  for (int r : rows)
    for (int c = 0; c < 8; c++)
      if (in[8 * r + c]) return false;
  return true;
}

void idct_8x8(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];
  if (dc_only(in, {1, 2, 3, 4, 5, 6, 7})) {
    for (int c = 0; c < 8; c++) {
      int16_t dc = wrap16(dequant(in[c], q[c]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      int32_t o[8];
      for (int r = 0; r < 8; r++) col[r] = dequant(in[8 * r + c], q[8 * r + c]);
      islow_1d(col, o, CONST_BITS - PASS1_BITS);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(o[r]);
    }
  }
  for (int r = 0; r < 8; r++) {
    int32_t o[8];
    islow_1d(ws + 8 * r, o, CONST_BITS + PASS1_BITS + 3);
    for (int c = 0; c < 8; c++) out[r * stride + c] = sample(o[c]);
  }
}

// One 1-D 4-point output of jidctred.c over 16-bit inputs (in[4] unused):
// out[0..3] descaled by n.
void red4_1d(const int16_t in[8], int32_t out[4], int n) {
  constexpr int32_t F0_211 = 1730, F0_509 = 4176, F0_601 = 4926,
                    F0_765 = 6270, F0_899 = 7373, F1_061 = 8697,
                    F1_451 = 11893, F1_847 = 15137, F2_172 = 17799,
                    F2_562 = 20995;
  int32_t odd2 = add(madd(in[1], F2_562, in[3], F0_899),
                     madd(in[5], -F0_601, in[7], -F0_509));
  int32_t odd0 = add(madd(in[1], F1_061, in[3], -F2_172),
                     madd(in[5], F1_451, in[7], -F0_211));
  int32_t tmp0 = int32_t(in[0]) * (1 << (CONST_BITS + 1));
  int32_t tmp2 = madd(in[2], F1_847, in[6], -F0_765);
  int32_t t10 = add(tmp0, tmp2), t12 = sub(tmp0, tmp2);
  out[0] = descale(add(t10, odd2), n);
  out[3] = descale(sub(t10, odd2), n);
  out[1] = descale(add(t12, odd0), n);
  out[2] = descale(sub(t12, odd0), n);
}

void idct_4x4(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[4][8];
  if (dc_only(in, {1, 2, 3, 5, 6, 7})) {  // row 4 is not used
    for (int c = 0; c < 8; c++) {
      int16_t dc = wrap16(dequant(in[c], q[c]) * (1 << PASS1_BITS));
      for (int r = 0; r < 4; r++) ws[r][c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      int32_t o[4];
      for (int r = 0; r < 8; r++) col[r] = dequant(in[8 * r + c], q[8 * r + c]);
      red4_1d(col, o, CONST_BITS - PASS1_BITS + 1);
      for (int r = 0; r < 4; r++) ws[r][c] = sat16(o[r]);
    }
  }
  for (int r = 0; r < 4; r++) {
    int32_t o[4];
    red4_1d(ws[r], o, CONST_BITS + PASS1_BITS + 3 + 1);
    for (int c = 0; c < 4; c++) out[r * stride + c] = sample(o[c]);
  }
}

// The 2x2 IDCT's first pass keeps 32-bit outputs: the second pass
// saturates the odd columns to 16 bits for its products and shifts column
// 0 in 32 bits.
void idct_2x2(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  constexpr int32_t F0_720 = 5906, F0_850 = 6967, F1_272 = 10426,
                    F3_624 = 29692;
  int32_t ws[2][8] = {};
  for (int c : {0, 1, 3, 5, 7}) {  // columns 2, 4, 6 are not used
    int16_t z[8];
    for (int r = 0; r < 8; r++) z[r] = dequant(in[8 * r + c], q[8 * r + c]);
    int32_t tmp0 = add(madd(z[1], F3_624, z[3], -F1_272),
                       madd(z[5], F0_850, z[7], -F0_720));
    int32_t tmp10 = int32_t(z[0]) * (1 << (CONST_BITS + 2));
    ws[0][c] = descale(add(tmp10, tmp0), CONST_BITS - PASS1_BITS + 2);
    ws[1][c] = descale(sub(tmp10, tmp0), CONST_BITS - PASS1_BITS + 2);
  }
  for (int r = 0; r < 2; r++) {
    const int32_t* w = ws[r];
    int32_t tmp0 = add(madd(sat16(w[1]), F3_624, sat16(w[3]), -F1_272),
                       madd(sat16(w[5]), F0_850, sat16(w[7]), -F0_720));
    int32_t tmp10 = wrap32(int64_t(static_cast<uint32_t>(w[0]))
                           << (CONST_BITS + 2));
    constexpr int n = CONST_BITS + PASS1_BITS + 3 + 2;
    out[r * stride] = sample(descale(add(tmp10, tmp0), n));
    out[r * stride + 1] = sample(descale(sub(tmp10, tmp0), n));
  }
}

// libjpeg's post-IDCT range limit of the C 1x1 IDCT: (x & 1023) ->
// sample, clamping within +-512 of the centre and wrapping beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_1x1(const int16_t* in, const int16_t* q, uint8_t* out, int) {
  int32_t dc = int32_t(in[0]) * q[0];
  out[0] = kRange.t[static_cast<int32_t>(
      (int64_t(dc) + 4) >> 3) & 1023];
}

// --------------------------------------------------------------------------
// Colour conversion (jdcolor.c) and Pillow's cmyk2rgb
// --------------------------------------------------------------------------

struct ColorTables {
  int32_t cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SCALEBITS) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int32_t>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int32_t>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline void ycc_to_rgb(int y, int cb, int cr, uint8_t* o) {
  o[0] = clamp255(y + kColor.cr_r[cr]);
  o[1] = clamp255(y + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
  o[2] = clamp255(y + kColor.cb_b[cb]);
}

// MULDIV255 of Pillow's Convert.c.
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// libjpeg's CMYK samples -> Pillow's "CMYK;I" (inverted) -> cmyk2rgb.
inline void cmyk_to_rgb(int c, int m, int y, int k, uint8_t* o) {
  int C = 255 - c, M = 255 - m, Y = 255 - y, K = 255 - k;
  int nk = 255 - K;
  o[0] = clamp255(nk - muldiv255(C, nk));
  o[1] = clamp255(nk - muldiv255(M, nk));
  o[2] = clamp255(nk - muldiv255(Y, nk));
}

// --------------------------------------------------------------------------
// Arithmetic decoding (jdarith.c): T.81 Table D.2 packed as jaricom.c packs
// it, Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS;
// the last entry is the fixed probability 0.5 of sign and refinement bits.
// --------------------------------------------------------------------------

constexpr int32_t V(int32_t qe, int nmps, int nlps, int sw) {
  return (qe << 16) | (nmps << 8) | (sw << 7) | nlps;
}
constexpr int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 2, 14, 0), V(0x1114, 3, 16, 0),
    V(0x080b, 4, 18, 0), V(0x03d8, 5, 20, 0), V(0x01da, 6, 23, 0),
    V(0x00e5, 7, 25, 0), V(0x006f, 8, 28, 0), V(0x0036, 9, 30, 0),
    V(0x001a, 10, 33, 0), V(0x000d, 11, 35, 0), V(0x0006, 12, 9, 0),
    V(0x0003, 13, 10, 0), V(0x0001, 13, 12, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 16, 36, 0), V(0x2cf2, 17, 38, 0), V(0x207c, 18, 39, 0),
    V(0x17b9, 19, 40, 0), V(0x1182, 20, 42, 0), V(0x0cef, 21, 43, 0),
    V(0x09a1, 22, 45, 0), V(0x072f, 23, 46, 0), V(0x055c, 24, 48, 0),
    V(0x0406, 25, 49, 0), V(0x0303, 26, 51, 0), V(0x0240, 27, 52, 0),
    V(0x01b1, 28, 54, 0), V(0x0144, 29, 56, 0), V(0x00f5, 30, 57, 0),
    V(0x00b7, 31, 59, 0), V(0x008a, 32, 60, 0), V(0x0068, 33, 62, 0),
    V(0x004e, 34, 63, 0), V(0x003b, 35, 32, 0), V(0x002c, 9, 33, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 38, 64, 0), V(0x3a0d, 39, 65, 0),
    V(0x2ef1, 40, 67, 0), V(0x261f, 41, 68, 0), V(0x1f33, 42, 69, 0),
    V(0x19a8, 43, 70, 0), V(0x1518, 44, 72, 0), V(0x1177, 45, 73, 0),
    V(0x0e74, 46, 74, 0), V(0x0bfb, 47, 75, 0), V(0x09f8, 48, 77, 0),
    V(0x0861, 49, 78, 0), V(0x0706, 50, 79, 0), V(0x05cd, 51, 48, 0),
    V(0x04de, 52, 50, 0), V(0x040f, 53, 50, 0), V(0x0363, 54, 51, 0),
    V(0x02d4, 55, 52, 0), V(0x025c, 56, 53, 0), V(0x01f8, 57, 54, 0),
    V(0x01a4, 58, 55, 0), V(0x0160, 59, 56, 0), V(0x0125, 60, 57, 0),
    V(0x00f6, 61, 58, 0), V(0x00cb, 62, 59, 0), V(0x00ab, 63, 61, 0),
    V(0x008f, 32, 61, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 66, 80, 0),
    V(0x412c, 67, 81, 0), V(0x37d8, 68, 82, 0), V(0x2fe8, 69, 83, 0),
    V(0x293c, 70, 84, 0), V(0x2379, 71, 86, 0), V(0x1edf, 72, 87, 0),
    V(0x1aa9, 73, 87, 0), V(0x174e, 74, 72, 0), V(0x1424, 75, 72, 0),
    V(0x119c, 76, 74, 0), V(0x0f6b, 77, 74, 0), V(0x0d51, 78, 75, 0),
    V(0x0bb6, 79, 77, 0), V(0x0a40, 48, 77, 0), V(0x5832, 81, 80, 1),
    V(0x4d1c, 82, 88, 0), V(0x438e, 83, 89, 0), V(0x3bdd, 84, 90, 0),
    V(0x34ee, 85, 91, 0), V(0x2eae, 86, 92, 0), V(0x299a, 87, 93, 0),
    V(0x2516, 71, 86, 0), V(0x5570, 89, 88, 1), V(0x4ca9, 90, 95, 0),
    V(0x44d9, 91, 96, 0), V(0x3e22, 92, 97, 0), V(0x3824, 93, 99, 0),
    V(0x32b4, 94, 99, 0), V(0x2e17, 86, 93, 0), V(0x56a8, 96, 95, 1),
    V(0x4f46, 97, 101, 0), V(0x47e5, 98, 102, 0), V(0x41cf, 99, 103, 0),
    V(0x3c3d, 100, 104, 0), V(0x375e, 93, 99, 0), V(0x5231, 102, 105, 0),
    V(0x4c0f, 103, 106, 0), V(0x4639, 104, 107, 0), V(0x415e, 99, 103, 0),
    V(0x5627, 106, 105, 1), V(0x50e7, 107, 108, 0), V(0x4b85, 103, 109, 0),
    V(0x5597, 109, 110, 0), V(0x504f, 107, 111, 0), V(0x5a10, 111, 110, 1),
    V(0x5522, 109, 112, 0), V(0x59eb, 111, 112, 1), V(0x5a1d, 113, 113, 0),
};
constexpr int kArithTables = 16;  // NUM_ARITH_TBLS

// --------------------------------------------------------------------------
// The decoder
// --------------------------------------------------------------------------

// jdsample.c's methods: kInt replicates by (he, ve), which covers its
// h2v1 / h2v2 replication too.
enum class Upsample { kFull, kH2V1Fancy, kH2V2Fancy, kH1V2Fancy, kInt };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int grid_w = 0, grid_h = 0;      // blocks allocated (whole MCUs)
  int ds = 8;                      // DCT scaled size (1: a lossless sample)
  int dw = 0, dh = 0;              // downsampled width, height (samples)
  Upsample up = Upsample::kFull;
  int he = 1, ve = 1;              // kInt's ratios
  bool latched = false;            // quantization table latched (jdinput.c)
  uint16_t qval[64];               // the latched quantization table
  int16_t q[64];                   // the IDCT's multipliers (ISLOW_MULT_TYPE)
  bool scanned = false;
  int coef_bits[64];               // progressive: -1 until a scan codes it
  int prev_bits[10];               // coef_bits[0..9] before the last scan
  std::vector<int16_t> coefs;      // multi-scan files: every block
  std::vector<uint8_t> plane;      // IDCT output, grid of ds x ds samples
  int plane_w = 0, plane_h = 0;
  // Lossless: each sample's difference, and per sample row whether it
  // restarts the prediction (1) or reads as zeros past a marker (2).
  std::vector<int32_t> diffs;
  std::vector<uint8_t> first_row;
  int predictor = 0, point_transform = 0;
};

struct ScanComp {
  Component* c;
  int dc_tbl, ac_tbl;
  int last_dc;
  int context;  // jdarith.c dc_context
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  size_t marker_pos = 0;

  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  // jdarith.c: the DAC conditioning (jdmarker.c get_soi's defaults), the
  // statistics of each table, and the coder's registers.
  uint8_t dac_L[kArithTables], dac_U[kArithTables], dac_K[kArithTables];
  uint8_t dc_stats[kArithTables][64];
  uint8_t ac_stats[kArithTables][256];
  uint8_t fixed_bin = 113;
  int64_t ac_c = 0, ac_a = 0;
  int ac_ct = -16;          // -1: a bad code latched the scan's decoding off
  bool ac_marker = false;   // unread_marker: zero data from here

  bool have_frame = false, progressive = false, arith = false;
  bool lossless = false;
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  Component comp[4];

  int scale = 1, min_ds = 8, out_w = 0, out_h = 0;
  bool fancy = true;
  int scans = 0;
  bool multi_scan = false;
  bool whole = false;  // a single-scan image whose scan is decoded
  int last_good = 0;   // libjpeg's last_good_iMCU_row

  // The bytes that Pillow has handed libjpeg so far (whole kPillowRead
  // reads from the start of the file): a read past them suspends libjpeg
  // until the next read, except inside an arithmetic-coded scan.
  size_t limit = 0;
  bool cannot_suspend = false;

  Decoder(const uint8_t* data, size_t size)
      : d(data), n(size), limit(std::min(size, kPillowRead)) {
    std::memset(dac_L, 0, sizeof dac_L);
    std::memset(dac_U, 1, sizeof dac_U);
    std::memset(dac_K, 5, sizeof dac_K);
  }

  [[noreturn]] void truncated() const {
    throw JpegError{"truncated: the data ends before the EOI marker", true};
  }
  // libjpeg asks for byte p: past the end, the file is truncated; past
  // the bytes read so far, Pillow reads on (or, where libjpeg cannot
  // suspend, raises).
  void need(size_t p) {
    if (p < limit) return;
    if (p >= n) truncated();
    if (cannot_suspend)
      fail("arithmetic-coded data across Pillow's %zu-byte reads of the "
           "file: libjpeg cannot suspend there, and Pillow raises",
           kPillowRead);
    while (limit <= p) limit = std::min(n, limit + kPillowRead);
  }
  int u8() {
    need(pos);
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // -- jdarith.c's coder -----------------------------------------------------

  void arith_start() {
    ac_c = ac_a = 0;
    ac_ct = -16;  // the first decode reads two bytes
    ac_marker = false;
  }

  // get_byte with its marker handling: a marker ends the data, which
  // then reads as zeros (legal in arithmetic coding).
  int arith_byte() {
    if (ac_marker) return 0;
    int data = u8();
    if (data == 0xFF) {
      const size_t at = pos - 1;
      do data = u8();
      while (data == 0xFF);
      if (data == 0) return 0xFF;
      ac_marker = true;
      marker_pos = at;
      return 0;
    }
    return data;
  }

  // arith_decode: one binary decision with statistics bin st.
  int arith_decode(uint8_t& st) {
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        ac_c = (ac_c << 8) | arith_byte();
        if ((ac_ct += 8) < 0 && ++ac_ct == 0) ac_a = 0x8000;
      }
      ac_a <<= 1;
    }
    int sv = st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdmarker.c next_marker: skips garbage bytes, fill FFs and stuffed FF 00.
  // marker_pos: where the marker's run of FF bytes starts.
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      marker_pos = pos - 1;
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // The end of a segment that libjpeg skips (APPn, COM, DNL); a length
  // under 2 holds no data.
  size_t skipped_segment() {
    int len = u16();
    if (len < 2) return pos;
    size_t end = pos + static_cast<size_t>(len - 2);
    if (end > n) truncated();
    return end;
  }

  // The table segments are read as jdmarker.c reads them: the length, then
  // byte by byte (the file may end inside, which libjpeg waits on), each
  // entry checked as it comes, the length last.

  // get_dac: arithmetic-coding conditioning.
  void read_dac() {
    int length = u16() - 2;
    while (length > 0) {
      int index = u8(), value = u8();
      length -= 2;
      if (index >= 2 * kArithTables)
        fail("corrupt data: a DAC entry for table %d", index);
      if (index >= kArithTables) {
        dac_K[index - kArithTables] = static_cast<uint8_t>(value);
      } else {
        dac_L[index] = static_cast<uint8_t>(value & 15);
        dac_U[index] = static_cast<uint8_t>(value >> 4);
        if (dac_L[index] > dac_U[index])
          fail("corrupt data: a bad DAC entry");
      }
    }
    if (length != 0) fail("corrupt data: a DAC segment's bad length");
  }

  // get_dqt: a table is read whole, its precision's 64 or 128 bytes, even
  // past the segment's length.
  void read_dqt() {
    int length = u16() - 2;
    while (length > 0) {
      length--;
      int pq = u8();
      int prec = pq >> 4, t = pq & 15;
      if (t >= 4) fail("corrupt data: a quantization table index %d", t);
      for (int i = 0; i < 64; i++)
        qt[t][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      qt_defined[t] = true;
      length -= prec ? 128 : 64;
    }
    if (length != 0) fail("corrupt data: a DQT segment's bad length");
  }

  // get_dht
  void read_dht() {
    int length = u16() - 2;
    while (length > 16) {
      int index = u8();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = static_cast<uint8_t>(u8());
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length)
        fail("corrupt data: a bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; i++) vals[i] = static_cast<uint8_t>(u8());
      length -= count;
      bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4)
        fail("corrupt data: a Huffman table index %d", index);
      (is_ac ? ac : dc)[index].set(bits, vals, count);
    }
    if (length != 0) fail("corrupt data: a DHT segment's bad length");
  }

  // get_dri
  void read_dri() {
    if (u16() != 4) fail("corrupt data: the DRI segment's bad length");
    restart_interval = u16();
  }

  void read_app(int marker, size_t end) {
    size_t len = end - pos;
    const uint8_t* b = d + pos;
    size_t look = std::min<size_t>(len, 14);  // libjpeg's APPN_DATA_LEN
    if (marker == 0xE0 && look >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && look >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    pos = end;
  }

  // get_sof
  void read_sof(int marker) {
    if (have_frame) fail("corrupt data: a second SOF marker");
    const int length = u16() - 8;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
    lossless = marker == 0xC3;
    if (precision != 8)
      fail("unsupported JPEG: %d-bit samples (only 8-bit)", precision);
    if (height <= 0 || width <= 0 || ncomp <= 0)
      fail("unsupported JPEG: an empty image (height %d, width %d; DNL is "
           "not supported)", height, width);
    if (length != ncomp * 3)
      fail("corrupt data: the SOF segment's bad length");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("unsupported JPEG: %d components (only 1, 3 or 4)", ncomp);
    if (width > kMaxDimension || height > kMaxDimension)
      fail("unsupported JPEG: %d x %d is over libjpeg's 65500 per side",
           width, height);
    if (int64_t(width) * height > kMaxPixels)
      fail("image too large: %d x %d = %lld pixels is over Pillow's "
           "decompression-bomb limit of %lld",
           width, height, static_cast<long long>(int64_t(width) * height),
           static_cast<long long>(kMaxPixels));
    max_h = max_v = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt data: sampling factors %dx%d", c.h, c.v);
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    have_frame = true;
  }

  std::string sampling_name() const {
    std::string s;
    for (int i = 0; i < ncomp; i++) {
      char buf[16];
      std::snprintf(buf, sizeof buf, "%s%dx%d", i ? "," : "", comp[i].h,
                    comp[i].v);
      s += buf;
    }
    return s;
  }

  // Pillow 12's JpegImageFile._open, which walks the markers up to the
  // first SOS in Python before libjpeg sees the file, and raises (the
  // caller sees PIL.UnidentifiedImageError or OSError) on: an FF xx
  // outside its table of FF C0 to FF FE other than FF 00 and FF FF; the
  // end of the data; a segment shorter than its length (_safe_read); an
  // SOF of other than 8 bits or 1, 3 or 4 layers, too short, or with a
  // partial component; a DQT table shorter than its precision; a JFIF or
  // Adobe segment too short for its version; a Photoshop resource cut
  // after its code; an ICC profile chunk too short for its count where an
  // SOF follows. Non-FF bytes, fill FFs and FF 00 are skipped.
  void pillow_walk() const {
    auto i16 = [&](size_t p) { return (d[p] << 8) | d[p + 1]; };
    auto short_data = []() {
      fail("truncated: the data ends before the first SOS marker");
    };
    std::vector<std::pair<size_t, size_t>> icc;  // chunks since the last SOF
    size_t p = 2;  // d[2] is FF (the signature)
    for (;;) {
      if (p >= n) short_data();
      if (d[p] != 0xFF) {
        p++;
        continue;
      }
      if (p + 1 >= n) short_data();
      const int m = d[p + 1];
      p += 2;
      if (m == 0xFF) {
        p--;
        continue;
      }
      if (m == 0) continue;
      if (m < 0xC0)
        fail("no marker found: 0xFF%02X before the first SOS marker "
             "(Pillow's header parser refuses it)", m);
      const bool bare = m == 0xC8 || (m >= 0xD0 && m <= 0xD9) ||
                        (m >= 0xF0 && m <= 0xFD);
      if (bare) continue;
      // The handler's segment: n = i16(read(2)) - 2; _safe_read(n).
      if (p + 2 > n) short_data();
      const int len = i16(p) - 2;
      p += 2;
      const size_t s = p, sn = len > 0 ? static_cast<size_t>(len) : 0;
      if (s + sn > n) short_data();
      p += sn;
      auto starts = [&](const char* tag, size_t k) {
        return sn >= k && std::memcmp(d + s, tag, k) == 0;
      };
      const bool sof = (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                        m != 0xCC) || m == 0xDE;
      if (sof) {
        if (sn < 5) fail("corrupt data: an SOF segment too short for its size");
        if (d[s] != 8)
          fail("unsupported JPEG: %d-bit samples (Pillow takes 8-bit only)",
               d[s]);
        if (sn < 6) fail("corrupt data: an SOF segment without its layers");
        if (d[s + 5] != 1 && d[s + 5] != 3 && d[s + 5] != 4)
          fail("unsupported JPEG: %d components (only 1, 3 or 4)", d[s + 5]);
        if (!icc.empty()) {
          auto less = [&](const std::pair<size_t, size_t>& a,
                          const std::pair<size_t, size_t>& b) {
            return std::lexicographical_compare(
                d + a.first, d + a.first + a.second, d + b.first,
                d + b.first + b.second);
          };
          if (std::min_element(icc.begin(), icc.end(), less)->second < 14)
            fail("corrupt data: an ICC profile chunk without its count");
          icc.clear();
        }
        if ((sn - 6) % 3 != 0)
          fail("corrupt data: an SOF segment with a partial component");
      } else if (m == 0xDB) {
        for (size_t q = s; q < s + sn;) {
          const size_t table = 1 + 64 * (d[q] >> 4 ? 2 : 1);
          if (s + sn - q < table)
            fail("corrupt data: a bad quantization table marker");
          q += table;
        }
      } else if (m == 0xE0 && starts("JFIF", 4)) {
        if (sn < 7) fail("corrupt data: a JFIF segment without its version");
      } else if (m == 0xEE && starts("Adobe", 5)) {
        if (sn < 7) fail("corrupt data: an Adobe segment without its version");
      } else if (m == 0xE2 && starts("ICC_PROFILE\0", 12)) {
        icc.emplace_back(s, sn);
      } else if (m == 0xED && starts("Photoshop 3.0\0", 14)) {
        // Its 8BIM resources: a cut struct field ends the walk; a resource
        // cut right after its code raises IndexError.
        size_t off = 14;
        auto u32 = [&](size_t q) {
          return (uint64_t(d[s + q]) << 24) | (uint64_t(d[s + q + 1]) << 16) |
                 (uint64_t(d[s + q + 2]) << 8) | d[s + q + 3];
        };
        while (off + 4 <= sn && std::memcmp(d + s + off, "8BIM", 4) == 0) {
          off += 4;
          if (off + 2 > sn) break;
          const int code = i16(s + off);
          off += 2;
          if (off >= sn)
            fail("corrupt data: a Photoshop resource without its name");
          off += 1 + d[s + off];
          off += off & 1;
          if (off + 4 > sn) break;
          const uint64_t size = u32(off);
          off += 4;
          if (code == 0x03ED && (off >= sn || sn - off < 14 || size < 14))
            break;
          if (size > sn) break;  // off + size is past the data: the loop ends
          off += size;
          off += off & 1;
        }
      }
      if (m == 0xDA) return;
    }
  }

  // Reads the markers up to and with the SOF. For the size alone.
  void read_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG: no SOI marker");
    if (n > 2 && d[2] != 0xFF)
      fail("not a JPEG: no FF D8 FF signature (Pillow's)");
    pos = 2;
    while (!have_frame) {
      int m = next_marker();
      if (m == 0xDA || m == 0xD9) fail("corrupt data: no SOF marker before the scan");
      handle_marker(m);
    }
    const size_t after_sof = pos;
    pillow_walk();
    pos = after_sof;
  }

  // Handles one non-scan marker; false at EOI.
  bool handle_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        read_sof(m);
        return true;
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        fail("unsupported JPEG: hierarchical (SOF%d)", m - 0xC0);
      case 0xCB:
        fail("unsupported JPEG: arithmetic-coded lossless (SOF11)");
      case 0xC8:
        fail("unsupported JPEG: the JPG extension marker");
      case 0xDE: case 0xDF:
        fail("unsupported JPEG: hierarchical (marker 0xFF%02X)", m);
      case 0xD8:
        fail("corrupt data: a second SOI marker");
      case 0xC4:
        read_dht();
        return true;
      case 0xDB:
        read_dqt();
        return true;
      case 0xDD:
        read_dri();
        return true;
      case 0xCC:
        read_dac();
        return true;
      case 0xDC:  // DNL: skipped, as libjpeg does
      case 0xFE:  // COM
        pos = skipped_segment();
        return true;
      case 0x01:  // TEM
      case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        return true;  // parameterless: ignored outside a scan, as libjpeg does
      case 0xD9:
        return false;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m, skipped_segment());
          return true;
        }
        fail("corrupt data: an unknown marker 0xFF%02X", m);
    }
  }

  // Geometry at scale 1/s (jdmaster.c jpeg_core_output_dimensions, jdsample.c
  // jinit_upsampler). A lossless frame's blocks are single samples.
  void setup_geometry() {
    const int bs = lossless ? 1 : 8;
    min_ds = lossless ? 1 : 8 / scale;
    out_w = lossless ? width : static_cast<int>((int64_t(width) * min_ds + 7) / 8);
    out_h = lossless ? height : static_cast<int>((int64_t(height) * min_ds + 7) / 8);
    fancy = min_ds > 1;  // jdmainct.c has no context rows at 1/8
    int mcus_x = (width + bs * max_h - 1) / (bs * max_h);
    int mcus_y = (height + bs * max_v - 1) / (bs * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      int ss = min_ds;
      while (ss < 8 && (max_h * min_ds) % (c.h * ss * 2) == 0 &&
             (max_v * min_ds) % (c.v * ss * 2) == 0)
        ss *= 2;
      if (lossless) ss = 1;
      c.ds = ss;
      c.width_in_blocks = static_cast<int>(
          (int64_t(width) * c.h + bs * max_h - 1) / (bs * max_h));
      c.height_in_blocks = static_cast<int>(
          (int64_t(height) * c.v + bs * max_v - 1) / (bs * max_v));
      c.grid_w = mcus_x * c.h;
      c.grid_h = mcus_y * c.v;
      c.dw = static_cast<int>((int64_t(width) * c.h * ss + bs * max_h - 1) /
                              (bs * max_h));
      c.dh = static_cast<int>((int64_t(height) * c.v * ss + bs * max_v - 1) /
                              (bs * max_v));
      const int h_in = c.h * ss / min_ds, v_in = c.v * ss / min_ds;
      c.he = c.ve = 1;
      if (h_in == max_h && v_in == max_v) {
        c.up = Upsample::kFull;
      } else if (h_in * 2 == max_h && v_in == max_v && fancy && c.dw > 2) {
        c.up = Upsample::kH2V1Fancy;
      } else if (h_in == max_h && v_in * 2 == max_v && fancy) {
        c.up = Upsample::kH1V2Fancy;
      } else if (h_in * 2 == max_h && v_in * 2 == max_v && fancy &&
                 c.dw > 2) {
        c.up = Upsample::kH2V2Fancy;
      } else if (max_h % h_in == 0 && max_v % v_in == 0) {
        c.up = Upsample::kInt;
        c.he = max_h / h_in;
        c.ve = max_v / v_in;
      } else {
        fail("unsupported JPEG: sampling factors %s, not an integer ratio "
             "(libjpeg refuses them)", sampling_name().c_str());
      }
      c.plane_w = c.width_in_blocks * ss;
      c.plane_h = c.height_in_blocks * ss;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      for (int k = 0; k < 10; k++) c.prev_bits[k] = -1;
    }
  }

  void latch(Component& c) {
    if (c.latched) return;
    if (c.tq < 0 || c.tq >= 4 || !qt_defined[c.tq])
      fail("corrupt data: quantization table %d is not defined", c.tq);
    for (int k = 0; k < 64; k++) {
      c.qval[k] = qt[c.tq][k];
      c.q[k] = static_cast<int16_t>(qt[c.tq][k]);
    }
    c.latched = true;
  }

  void idct_block(Component& c, const int16_t* blk, int bx, int by) {
    if (bx >= c.width_in_blocks || by >= c.height_in_blocks) return;
    uint8_t* out = c.plane.data() + size_t(by) * c.ds * c.plane_w +
                   size_t(bx) * c.ds;
    switch (c.ds) {
      case 8: idct_8x8(blk, c.q, out, c.plane_w); break;
      case 4: idct_4x4(blk, c.q, out, c.plane_w); break;
      case 2: idct_2x2(blk, c.q, out, c.plane_w); break;
      default: idct_1x1(blk, c.q, out, c.plane_w); break;
    }
  }

  int16_t* stored(Component& c, int bx, int by) {
    return c.coefs.data() + (size_t(by) * c.grid_w + bx) * 64;
  }

  // -- scans ---------------------------------------------------------------

  void read_scan() {
    if (!have_frame) fail("corrupt data: a scan before the SOF marker");
    int len = u16();
    int ns = u8();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4)
      fail("corrupt data: the SOS segment's bad length");
    ScanComp sc[4];
    // jdmarker.c get_sos: each id names the first component of that id
    // that the scan has not named yet.
    bool named[4] = {false, false, false, false};
    for (int i = 0; i < ns; i++) {
      int id = u8(), tables = u8();
      Component* found = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id && !named[k]) {
          found = &comp[k];
          named[k] = true;
          break;
        }
      if (!found)
        fail("corrupt data: a scan names component id %d, which the frame "
             "lacks or the scan named already", id);
      sc[i] = ScanComp{found, tables >> 4, tables & 15, 0, 0};
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;

    if (scans == 0) {
      multi_scan = progressive || ns < ncomp;
      for (int i = 0; i < ncomp; i++) {
        Component& c = comp[i];
        if (lossless) {
          c.diffs.assign(size_t(c.grid_w) * c.grid_h, 0);
          c.first_row.assign(size_t(c.grid_h), 0);
        } else {
          c.plane.assign(size_t(c.plane_w) * c.plane_h, 0);
          if (multi_scan) c.coefs.assign(size_t(c.grid_w) * c.grid_h * 64, 0);
        }
      }
      if (!progressive && !arith && !lossless) {
        // libjpeg-turbo's jinit_huff_decoder: the standard tables in slots 0
        // and 1 where the file defines none (Motion JPEG; not jdlhuff.c).
        if (!dc[0].defined) dc[0].set(kStdDcLumBits, kStdDcLumVals, 12);
        if (!ac[0].defined) ac[0].set(kStdAcLumBits, kStdAcLumVals, 162);
        if (!dc[1].defined) dc[1].set(kStdDcChrBits, kStdDcChrVals, 12);
        if (!ac[1].defined) ac[1].set(kStdAcChrBits, kStdAcChrVals, 162);
      }
    } else if (!multi_scan) {
      fail("corrupt data: a second scan in a single-scan image");
    }
    scans++;

    int blocks = 0;
    for (int i = 0; i < ns; i++) {
      if (!lossless) latch(*sc[i].c);
      sc[i].c->scanned = true;
      blocks += ns == 1 ? 1 : sc[i].c->h * sc[i].c->v;
    }
    if (blocks > kMaxBlocksInMcu)
      fail("corrupt data: %d blocks in an MCU (at most 10)", blocks);
    if (lossless) return lossless_scan(sc, ns, ss, se, ah, al);

    auto table = [](Huffman* set, int t, bool is_dc) -> Huffman& {
      if (t < 0 || t >= 4 || !set[t].defined)
        fail("corrupt data: Huffman table %d is not defined", t);
      set[t].derive(is_dc);
      return set[t];
    };

    enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind = kSeq;
    if (progressive) {
      bool is_dc = ss == 0;
      bool bad = false;
      if (is_dc) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad)
        fail("corrupt data: bad progression parameters Ss=%d Se=%d Ah=%d "
             "Al=%d", ss, se, ah, al);
      // jdphuff.c start_pass_phuff_decoder (jdarith.c start_pass): the
      // precision the scan starts from, which smoothing uses for iMCU rows
      // that the file's last scan left without data.
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i].c;
        for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); k++)
          c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      }
      kind = is_dc ? (ah == 0 ? kDcFirst : kDcRefine)
                   : (ah == 0 ? kAcFirst : kAcRefine);
    }
    Huffman* dct[4] = {};
    Huffman* act[4] = {};
    const bool uses_dc = kind == kSeq || kind == kDcFirst;
    const bool uses_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
    // jdarith.c start_pass and process_restart: the statistics the scan
    // codes with, zeroed (a table index is a nibble: one of the 16).
    auto clear_stats = [&]() {
      for (int i = 0; i < ns; i++) {
        if (uses_dc) std::memset(dc_stats[sc[i].dc_tbl], 0, sizeof dc_stats[0]);
        if (uses_ac) std::memset(ac_stats[sc[i].ac_tbl], 0, sizeof ac_stats[0]);
      }
    };
    if (arith) clear_stats();
    for (int i = 0; i < ns && !arith; i++) {
      if (uses_dc) dct[i] = &table(dc, sc[i].dc_tbl, true);
      if (uses_ac) act[i] = &table(ac, sc[i].ac_tbl, false);
    }

    BitReader br;
    br.start(d, n, pos);
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    int eobrun = 0;
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    arith_start();

    // Where a single-scan image's Huffman-coded data runs into the end of
    // the file, FillModel decides where libjpeg asks for bytes past it.
    const bool model = !arith && !multi_scan && reaches_end(pos);
    std::vector<BitEvent> events;
    FillModel fm;
    if (model) {
      br.events = &events;
      fm.start(d, n, pos, false);
    }
    auto replay = [&]() {
      if (!model) return;
      for (;;) {
        const FillModel saved = fm;
        if (restart_interval == 0 && !fm.marker && limit > fm.next &&
            limit - fm.next >= kFastBytesPerBlock * size_t(blocks)) {
          if (fm.fast(events)) return;
          fm = saved;
        }
        size_t needed = 0;
        if (fm.slow(events, limit, &needed)) return;
        fm = saved;
        if (needed >= n)
          fail("truncated: the data ends inside an entropy-coded segment");
        need(needed);  // Pillow's next read, and the MCU again
      }
    };

    auto restart = [&]() {
      events.clear();
      if (restart_interval == 0) return;
      if (restarts_to_go == 0) {
        // jdhuff.c process_restart: drop the buffered bits and read the
        // next marker (jdarith.c: the one its reader stopped at).
        const bool taken = read_restart(
            arith ? (ac_marker ? marker_pos : pos) : br.pos, &next_rst);
        br.start(d, n, pos);
        if (taken) br.insufficient = false;
        if (model) fm.start(d, n, pos, !taken);
        for (int i = 0; i < ns; i++) sc[i].last_dc = sc[i].context = 0;
        eobrun = 0;
        if (arith) {
          clear_stats();
          arith_start();
          ac_marker = !taken;
        }
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    };

    auto dc_value = [&](ScanComp& s, int diff) {
      int last = s.last_dc;
      if ((last >= 0 && diff > INT32_MAX - last) ||
          (last < 0 && diff < INT32_MIN - last))
        fail("corrupt data: a DC coefficient overflows");
      s.last_dc = last + diff;
      return s.last_dc;
    };

    // jdarith.c Figures F.19 to F.24: a DC difference (the dc_context
    // conditioning, arith_dc_L / arith_dc_U), false where its magnitude
    // overflows.
    auto arith_dc = [&](ScanComp& s, int* value) {
      uint8_t* st = dc_stats[s.dc_tbl] + s.context;
      if (arith_decode(st[0]) == 0) {
        s.context = 0;
        *value = 0;
        return true;
      }
      int sign = arith_decode(st[1]);
      st += 2 + sign;
      int m = arith_decode(st[0]);
      if (m) {
        st = dc_stats[s.dc_tbl] + 20;
        while (arith_decode(st[0])) {
          if ((m <<= 1) == 0x8000) return false;
          st++;
        }
      }
      if (m < ((1 << dac_L[s.dc_tbl]) >> 1))
        s.context = 0;
      else if (m > ((1 << dac_U[s.dc_tbl]) >> 1))
        s.context = 12 + sign * 4;
      else
        s.context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st[0])) v |= m;
      v += 1;
      *value = sign ? -v : v;
      return true;
    };
    // An AC value's sign and magnitude at coefficient k, from its S0 + 3(k
    // - 1) bins; false where its magnitude overflows.
    auto arith_ac = [&](int tbl, uint8_t* st, int k, int* value) {
      int sign = arith_decode(fixed_bin);
      st += 2;
      int m = arith_decode(st[0]);
      if (m && arith_decode(st[0])) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= dac_K[tbl] ? 189 : 217);
        while (arith_decode(st[0])) {
          if ((m <<= 1) == 0x8000) return false;
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st[0])) v |= m;
      v += 1;
      *value = sign ? -v : v;
      return true;
    };
    // A band of AC coefficients (sequential: 1 to 63), each written through
    // put(k, v); false at a spectral or magnitude overflow.
    auto arith_band = [&](int tbl, int from, int to, auto put) {
      for (int k = from; k <= to; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(st[0])) break;  // EOB
        while (arith_decode(st[1]) == 0) {
          st += 3;
          if (++k > to) return false;
        }
        int v;
        if (!arith_ac(tbl, st, k, &v)) return false;
        put(k, v);
      }
      return true;
    };

    auto block = [&](int i, int bx, int by) {
      ScanComp& s = sc[i];
      Component& c = *s.c;
      switch (kind) {
        case kSeq: {
          // A multi-scan file's blocks are decoded in place, as libjpeg's
          // coefficient buffer is.
          int16_t local[64] = {0};
          int16_t* blk = multi_scan ? stored(c, bx, by) : local;
          if (arith) {
            int diff;
            if (ac_ct != -1 && !arith_dc(s, &diff)) ac_ct = -1;
            if (ac_ct != -1) {
              s.last_dc = (s.last_dc + diff) & 0xFFFF;
              blk[0] = static_cast<int16_t>(s.last_dc);
              if (!arith_band(s.ac_tbl, 1, 63, [&](int k, int v) {
                    blk[kNatural[k]] = static_cast<int16_t>(v);
                  }))
                ac_ct = -1;
            }
          } else {
            int t = br.decode(*dct[i]);
            int diff = t ? extend(br.get(t), t) : 0;
            blk[0] = static_cast<int16_t>(dc_value(s, diff));
            const Huffman& h = *act[i];
            for (int k = 1; k < 64; k++) {
              int rs = br.decode(h);
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
          if (!multi_scan) idct_block(c, blk, bx, by);
          break;
        }
        case kDcFirst: {
          int v;
          if (arith) {
            int diff;
            if (ac_ct == -1) break;
            if (!arith_dc(s, &diff)) {
              ac_ct = -1;
              break;
            }
            s.last_dc = (s.last_dc + diff) & 0xFFFF;
            v = s.last_dc;
          } else {
            int t = br.decode(*dct[i]);
            int diff = t ? extend(br.get(t), t) : 0;
            v = dc_value(s, diff);
          }
          stored(c, bx, by)[0] =
              static_cast<int16_t>(static_cast<uint32_t>(v) << al);
          break;
        }
        case kDcRefine: {
          if (arith ? arith_decode(fixed_bin) : br.get(1))
            stored(c, bx, by)[0] |= static_cast<int16_t>(p1);
          break;
        }
        case kAcFirst: {
          int16_t* blk = stored(c, bx, by);
          if (arith) {
            if (ac_ct != -1 &&
                !arith_band(s.ac_tbl, ss, se, [&](int k, int v) {
                  blk[kNatural[k]] = static_cast<int16_t>(
                      static_cast<uint32_t>(v) << al);
                }))
              ac_ct = -1;
            break;
          }
          if (eobrun > 0) {
            eobrun--;
            break;
          }
          const Huffman& h = *act[i];
          for (int k = ss; k <= se; k++) {
            int rs = br.decode(h);
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              blk[kNatural[k]] = static_cast<int16_t>(
                  static_cast<uint32_t>(extend(br.get(sz), sz)) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += static_cast<int>(br.get(r));
              eobrun--;
              break;
            }
          }
          break;
        }
        case kAcRefine: {
          int16_t* blk = stored(c, bx, by);
          if (arith) {
            // jdarith.c decode_mcu_AC_refine
            if (ac_ct == -1) break;
            int kex = se;
            for (; kex > 0; kex--)
              if (blk[kNatural[kex]]) break;
            for (int k = ss; k <= se; k++) {
              uint8_t* st = ac_stats[s.ac_tbl] + 3 * (k - 1);
              if (k > kex && arith_decode(st[0])) break;
              for (;;) {
                int16_t& coef = blk[kNatural[k]];
                if (coef) {
                  if (arith_decode(st[2]))
                    coef = static_cast<int16_t>(coef < 0 ? coef + m1
                                                         : coef + p1);
                  break;
                }
                if (arith_decode(st[1])) {
                  coef = static_cast<int16_t>(arith_decode(fixed_bin) ? m1
                                                                        : p1);
                  break;
                }
                st += 3;
                if (++k > se) {
                  ac_ct = -1;
                  return;
                }
              }
            }
            break;
          }
          const Huffman& h = *act[i];
          auto correct = [&](int16_t& coef) {
            if (br.get(1) && (coef & p1) == 0)
              coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
          };
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; k++) {
              int rs = br.decode(h);
              int r = rs >> 4, sz = rs & 15;
              int value = 0;
              if (sz) {
                // A size other than 1 is a warning in libjpeg, which goes on.
                value = br.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += static_cast<int>(br.get(r));
                break;
              }
              do {
                int16_t& coef = blk[kNatural[k]];
                if (coef != 0) {
                  correct(coef);
                } else {
                  if (--r < 0) break;
                }
                k++;
              } while (k <= se);
              if (value) blk[kNatural[k]] = static_cast<int16_t>(value);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; k++) {
              int16_t& coef = blk[kNatural[k]];
              if (coef != 0) correct(coef);
            }
            eobrun--;
          }
          break;
        }
      }
    };

    // Once a segment's data has run out, its later MCUs are not decoded:
    // a single-scan image's blocks then read as zeros (uniform gray), a
    // multi-scan image's keep what earlier scans gave them.
    const int16_t zeros[64] = {0};
    auto mcu_block = [&](bool skipped, int i, int bx, int by) {
      if (!skipped) block(i, bx, by);
      else if (!multi_scan) idct_block(*sc[i].c, zeros, bx, by);
    };
    // libjpeg's last_good_iMCU_row: the iMCU row of the last MCU that the
    // file's scans came to (before its restart marker) with data left.
    cannot_suspend = arith;
    if (ns == 1) {
      Component& c = *sc[0].c;
      for (int by = 0; by < c.height_in_blocks; by++)
        for (int bx = 0; bx < c.width_in_blocks; bx++) {
          if (!br.insufficient) last_good = by / c.v;
          restart();
          mcu_block(br.insufficient, 0, bx, by);
          replay();
        }
    } else {
      int mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
      int mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
      for (int my = 0; my < mcus_y; my++) {
        for (int mx = 0; mx < mcus_x; mx++) {
          if (!br.insufficient) last_good = my;
          restart();
          bool skipped = br.insufficient;
          for (int i = 0; i < ns; i++) {
            const Component& c = *sc[i].c;
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                mcu_block(skipped, i, mx * c.h + x, my * c.v + y);
          }
          replay();
        }
      }
    }
    cannot_suspend = false;
    end_scan(arith ? (ac_marker ? marker_pos : pos) : br.pos);
  }

  // jdmarker.c read_restart_marker from p: the next marker, where it is
  // the expected RSTn, is taken; else jpeg_resync_to_restart's rules: a
  // marker below SOF0 or an RST one or two behind: read on to the next
  // marker; one of the next two RSTs or another marker: leave it unread
  // (the segment then reads as empty: false); any other RST: take it.
  // pos is then where the segment's data starts.
  bool read_restart(size_t p, int* next_rst) {
    pos = p;
    int m = next_marker();
    bool taken = true;
    while (m != 0xD0 + *next_rst) {
      int ahead = (m - 0xD0 - *next_rst) & 7;
      if (m >= 0xD0 && m <= 0xD7 && ahead > 2 && ahead < 6) break;
      if (m >= 0xC0 && !(m >= 0xD0 && m <= 0xD7 && ahead >= 6)) {
        taken = false;
        pos = marker_pos;
        break;
      }
      m = next_marker();
    }
    *next_rst = (*next_rst + 1) & 7;
    return taken;
  }

  // A lossless scan (jdlhuff.c decode_mcus, jddiffct.c): each sample's
  // difference into its component's diffs, an MCU row at a time (a sample
  // row of a single-component scan); restarts and rows past a marker (zero
  // differences) reset the prediction, which decode() runs (jdlossls.c).
  void lossless_scan(ScanComp* sc, int ns, int ss, int se, int ah, int al) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      fail("corrupt data: bad lossless parameters Ss=%d Se=%d Ah=%d Al=%d",
           ss, se, ah, al);
    Huffman* tbl[4];
    for (int i = 0; i < ns; i++) {
      const int t = sc[i].dc_tbl;
      if (t >= 4 || !dc[t].defined)
        fail("corrupt data: Huffman table %d is not defined", t);
      dc[t].derive(true, 16);
      tbl[i] = &dc[t];
      sc[i].c->predictor = ss;
      sc[i].c->point_transform = al;
    }
    const int per_row = ns == 1 ? sc[0].c->width_in_blocks
                                : (width + max_h - 1) / max_h;
    const int rows = ns == 1 ? sc[0].c->height_in_blocks
                             : (height + max_v - 1) / max_v;
    if (restart_interval % per_row != 0)
      fail("unsupported JPEG: a lossless restart interval of %d MCUs, not "
           "whole rows of %d", restart_interval, per_row);
    const int rows_per_restart = restart_interval / per_row;
    BitReader br;
    br.start(d, n, pos);
    const bool model = !multi_scan && reaches_end(pos);
    std::vector<BitEvent> events;
    FillModel fm;
    if (model) {
      br.events = &events;
      fm.start(d, n, pos, false);
    }
    // jdlossls.c start_pass, run while an iMCU row (v sample rows of a
    // component) is decoded: the prediction starts again at the first row
    // of that iMCU row, which jddiffct.c undifferences after the decode.
    auto mark = [&](int my) {
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i].c;
        c.first_row[size_t(ns == 1 ? my / c.v * c.v : my * c.v)] = 1;
      }
    };
    int rows_to_go = rows_per_restart, next_rst = 0;
    for (int my = 0; my < rows; my++) {
      if (restart_interval) {
        if (rows_to_go == 0) {
          const bool taken = read_restart(br.pos, &next_rst);
          br.start(d, n, pos);
          if (taken) br.insufficient = false;
          if (model) fm.start(d, n, pos, !taken);
          mark(my);
          rows_to_go = rows_per_restart;
        }
        rows_to_go--;
      }
      if (br.insufficient) {  // the row reads as zero differences
        mark(my);
        continue;
      }
      for (int mx = 0; mx < per_row; mx++) {
        events.clear();
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i].c;
          const int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
          for (int y = 0; y < v; y++)
            for (int x = 0; x < h; x++) {
              int s = br.decode(*tbl[i]);
              if (s == 16) s = 32768;
              else if (s) s = extend(br.get(s), s);
              c.diffs[size_t(my * v + y) * c.grid_w + mx * h + x] = s;
            }
        }
        if (!model) continue;
        for (;;) {
          const FillModel saved = fm;
          size_t needed = 0;
          if (fm.slow(events, limit, &needed)) break;
          fm = saved;
          if (needed >= n)
            fail("truncated: the data ends inside an entropy-coded segment");
          need(needed);
        }
      }
    }
    end_scan(br.pos);
  }

  // jdlossls.c: each row's samples from its differences, predicted from
  // the row above (Ra left, Rb above, Rc above left) or, in a row that
  // starts the prediction, from the left and 1 << (7 - Pt); then shifted
  // by the point transform into 8 bits.
  void undifference(Component& c) {
    const int w = c.width_in_blocks, pt = c.point_transform;
    std::vector<int> prev(static_cast<size_t>(w)), cur(static_cast<size_t>(w));
    for (int r = 0; r < c.height_in_blocks; r++) {
      const int32_t* diff = c.diffs.data() + size_t(r) * c.grid_w;
      if (r == 0 || c.first_row[size_t(r)]) {
        int ra = 1 << (7 - pt);
        for (int x = 0; x < w; x++) cur[x] = ra = (diff[x] + ra) & 0xFFFF;
      } else {
        cur[0] = (diff[0] + prev[0]) & 0xFFFF;
        for (int x = 1; x < w; x++) {
          const int ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
          int p = 0;
          switch (c.predictor) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = (diff[x] + p) & 0xFFFF;
        }
      }
      uint8_t* out = c.plane.data() + size_t(r) * c.plane_w;
      for (int x = 0; x < w; x++)
        out[x] = static_cast<uint8_t>(static_cast<uint32_t>(cur[x]) << pt);
      std::swap(prev, cur);
    }
  }

  // What follows a scan's last MCU up to the next marker is skipped, as
  // libjpeg's next_marker skips it. A single-scan image is whole once its
  // scan is: libjpeg reads the markers after it only to finish, and Pillow
  // takes the image where the data ends first (decode()). A multi-scan
  // image whose data ends there is truncated: libjpeg reads to EOI before
  // it outputs a line.
  void end_scan(size_t p) {
    pos = p;
    whole = !multi_scan;
    next_marker();
    pos = marker_pos;
  }

  // Whether the entropy-coded data from p runs into the end of the file:
  // no marker ends it before (with restarts, no marker that
  // jpeg_resync_to_restart would not read past: one of SOF0 and above
  // other than an RST).
  bool reaches_end(size_t p) const {
    for (;;) {
      const void* f = std::memchr(d + p, 0xFF, n - p);
      if (!f) return true;
      size_t q = static_cast<const uint8_t*>(f) - d;
      while (q < n && d[q] == 0xFF) q++;
      if (q >= n) return true;
      const int m = d[q];
      if (m != 0) {
        if (restart_interval == 0) return false;
        if (m >= 0xC0 && !(m >= 0xD0 && m <= 0xD7)) return false;
      }
      p = q + 1;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg block-smooths a progressive image whose
  // scans leave any of the first 9 AC coefficients unrefined.
  bool would_smooth() const {
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.qval[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data: each block's first 9 AC
  // coefficients that are still zero and not known to full precision are
  // estimated from the DC values of its 5x5 neighbourhood (and where no AC
  // scan reached the component, its DC too), then the block's IDCT. The
  // neighbourhood's rows and columns past the edges repeat as libjpeg's
  // buffer pointers and sliding registers repeat them.
  void smooth(Component& c) {
    // The precision of iMCU rows past the last good one: the last scan's
    // starting point (none known after one scan).
    int prev[10];
    for (int k = 1; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    const int64_t Q00 = c.qval[0];
    auto estimate = [](int64_t num, int64_t q, int al) {
      int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
      if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
      return static_cast<int16_t>(num >= 0 ? pred : -pred);
    };
    const int T = (height + 8 * max_v - 1) / (8 * max_v);  // iMCU rows
    const int last_col = c.width_in_blocks - 1;
    for (int t = 0; t < T; t++) {
      const int* bits = t > last_good ? prev : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; k++)
        if (bits[k] != -1) change_dc = false;
      int block_rows = c.v;
      if (t == T - 1) {
        block_rows = c.height_in_blocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int R = block_rows * T;
      for (int r = 0; r < block_rows; r++) {
        const int row = t * c.v + r, image_row = t * block_rows + r;
        const int prev = image_row > 0 ? row - 1 : row;
        const int prev2 = image_row > 1 ? row - 2 : prev;
        const int next = image_row < R - 1 ? row + 1 : row;
        const int next2 = image_row < R - 2 ? row + 2 : next;
        const int rows[5] = {prev2, prev, row, next, next2};
        auto dc = [&](int k, int col) { return int(stored(c, col, rows[k])[0]); };
        // dc5[k][j]: DC(k * 5 + j + 1) of libjpeg's registers.
        int w[5][5];
        for (int k = 0; k < 5; k++)
          for (int j = 0; j < 5; j++) w[k][j] = dc(k, 0);
        for (int bx = 0; bx <= last_col; bx++) {
          if (bx == 0 && bx < last_col)
            for (int k = 0; k < 5; k++) w[k][3] = w[k][4] = dc(k, 1);
          if (bx + 1 < last_col)
            for (int k = 0; k < 5; k++) w[k][4] = dc(k, bx + 2);
          int16_t ws[64];
          std::memcpy(ws, stored(c, bx, row), sizeof ws);
          const int DC01 = w[0][0], DC02 = w[0][1], DC03 = w[0][2],
                    DC04 = w[0][3], DC05 = w[0][4], DC06 = w[1][0],
                    DC07 = w[1][1], DC08 = w[1][2], DC09 = w[1][3],
                    DC10 = w[1][4], DC11 = w[2][0], DC12 = w[2][1],
                    DC13 = w[2][2], DC14 = w[2][3], DC15 = w[2][4],
                    DC16 = w[3][0], DC17 = w[3][1], DC18 = w[3][2],
                    DC19 = w[3][3], DC20 = w[3][4], DC21 = w[4][0],
                    DC22 = w[4][1], DC23 = w[4][2], DC24 = w[4][3],
                    DC25 = w[4][4];
          auto apply = [&](int k, int64_t kernel) {
            int pos = kNatural[k];
            if (bits[k] != 0 && ws[pos] == 0)
              ws[pos] = estimate(Q00 * kernel, c.qval[pos], bits[k]);
          };
          apply(1, change_dc
              ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25)
              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          apply(2, change_dc
              ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          apply(3, change_dc
              ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23)
              : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          apply(4, change_dc
              ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                 DC21 - DC25)
              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          apply(5, change_dc
              ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19)
              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          if (change_dc) {
            apply(6, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            apply(7, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            apply(8, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            apply(9, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[0] = estimate(
                Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                       6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 -
                       6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                       42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 +
                       42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                       6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                Q00, 0);
          }
          idct_block(c, ws, bx, row);
          for (int k = 0; k < 5; k++)
            for (int j = 0; j < 4; j++) w[k][j] = w[k][j + 1];
        }
      }
    }
  }

  void decode(int s, uint8_t* out, int64_t cap) {
    scale = s;
    read_header();
    if (lossless) {
      // Pillow 12 asks libjpeg for a draft, which lossless frames do not
      // scale: it raises, or writes full-size rows into its smaller
      // buffer. libjpeg-turbo converts no colours of a lossless frame.
      if (s > 1)
        fail("unsupported JPEG: lossless (SOF3) at a draft scale of 1/%d "
             "(Pillow raises or overruns its buffer)", s);
      Space space = color_space();
      if (space == Space::kYCbCr || space == Space::kYCCK)
        fail("unsupported JPEG: lossless (SOF3) with a colour transform");
    }
    setup_geometry();
    if (int64_t(out_w) * out_h * 3 > cap) fail("the output buffer is too small");
    try {
      for (;;) {
        int m = next_marker();
        if (m == 0xDA) {
          read_scan();
          continue;
        }
        if (!handle_marker(m)) break;
      }
    } catch (const JpegError& e) {
      // A single-scan image is whole once its scan is: libjpeg reads the
      // markers after it to EOI only to finish, and Pillow takes the image
      // where the data ends first (an error there still raises).
      if (!(e.truncated && whole)) throw;
    }
    if (scans == 0) fail("corrupt data: no scan before the EOI marker");
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].scanned)
        fail("corrupt data: component %d is in no scan", comp[i].id);
    if (lossless) {
      for (int i = 0; i < ncomp; i++) {
        comp[i].plane.assign(size_t(comp[i].plane_w) * comp[i].plane_h, 0);
        undifference(comp[i]);
      }
    } else if (multi_scan) {
      bool smoothing = progressive && would_smooth();
      for (int i = 0; i < ncomp; i++) {
        Component& c = comp[i];
        if (smoothing) {
          smooth(c);
        } else {
          for (int by = 0; by < c.height_in_blocks; by++)
            for (int bx = 0; bx < c.width_in_blocks; bx++)
              idct_block(c, stored(c, bx, by), bx, by);
        }
        std::vector<int16_t>().swap(c.coefs);
      }
    }
    emit(out);
  }

  // One output row of component c, upsampled to (at least) out_w samples.
  const uint8_t* row(const Component& c, int y, uint8_t* tmp) const {
    auto line = [&](int r) { return c.plane.data() + size_t(r) * c.plane_w; };
    switch (c.up) {
      case Upsample::kFull:
        return line(y);
      case Upsample::kInt: {
        // jdsample.c int_upsample (h2v1_upsample and h2v2_upsample too)
        const uint8_t* in = line(y / c.ve);
        for (int x = 0, i = 0; x < out_w; i++)
          for (int k = 0; k < c.he; k++) tmp[x++] = in[i];
        return tmp;
      }
      case Upsample::kH1V2Fancy: {
        // jdsample.c h1v2_fancy_upsample, with jdmainct.c's context rows
        int j = y >> 1;
        int far = (y & 1) ? std::min(j + 1, c.dh - 1) : std::max(j - 1, 0);
        const int bias = (y & 1) ? 2 : 1;
        const uint8_t* i0 = line(j);
        const uint8_t* i1 = line(far);
        for (int x = 0; x < c.dw; x++)
          tmp[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
        return tmp;
      }
      case Upsample::kH2V1Fancy: {
        // jdsample.c h2v1_fancy_upsample
        const uint8_t* in = line(y);
        uint8_t* o = tmp;
        int w = c.dw;
        int v = in[0];
        *o++ = static_cast<uint8_t>(v);
        *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < w - 1; x++) {
          v = in[x] * 3;
          *o++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          *o++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        v = in[w - 1];
        *o++ = static_cast<uint8_t>((v * 3 + in[w - 2] + 1) >> 2);
        *o++ = static_cast<uint8_t>(v);
        return tmp;
      }
      case Upsample::kH2V2Fancy: {
        // jdsample.c h2v2_fancy_upsample, with jdmainct.c's context rows:
        // the first row above the top, the last real row below the bottom.
        int j = y >> 1;
        int far = (y & 1) ? std::min(j + 1, c.dh - 1) : std::max(j - 1, 0);
        const uint8_t* i0 = line(j);
        const uint8_t* i1 = line(far);
        uint8_t* o = tmp;
        int w = c.dw;
        int this_sum = i0[0] * 3 + i1[0];
        int next_sum = i0[1] * 3 + i1[1];
        *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < w; x++) {
          next_sum = i0[x] * 3 + i1[x];
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        return tmp;
      }
    }
    return nullptr;
  }

  // jdapimin.c default_decompress_parms: the file's colour space.
  enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };
  Space color_space() const {
    if (ncomp == 1) return Space::kGray;
    if (ncomp == 3) {
      if (jfif) return Space::kYCbCr;
      if (adobe) return adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
      if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
        return Space::kRGB;
      // libjpeg-turbo 3: a lossless frame without either marker is RGB.
      return lossless ? Space::kRGB : Space::kYCbCr;
    }
    if (adobe) return adobe_transform == 0 ? Space::kCMYK : Space::kYCCK;
    return Space::kCMYK;
  }

  void emit(uint8_t* out) {
    Space space = color_space();
    std::vector<uint8_t> tmp[4];
    for (int i = 0; i < ncomp; i++) tmp[i].resize(size_t(out_w) + 16);
    const uint8_t* r[4];
    for (int y = 0; y < out_h; y++) {
      for (int i = 0; i < ncomp; i++) r[i] = row(comp[i], y, tmp[i].data());
      uint8_t* o = out + size_t(y) * out_w * 3;
      switch (space) {
        case Space::kGray:
          for (int x = 0; x < out_w; x++, o += 3) o[0] = o[1] = o[2] = r[0][x];
          break;
        case Space::kRGB:
          for (int x = 0; x < out_w; x++, o += 3) {
            o[0] = r[0][x];
            o[1] = r[1][x];
            o[2] = r[2][x];
          }
          break;
        case Space::kYCbCr:
          for (int x = 0; x < out_w; x++, o += 3)
            ycc_to_rgb(r[0][x], r[1][x], r[2][x], o);
          break;
        case Space::kCMYK:
          for (int x = 0; x < out_w; x++, o += 3)
            cmyk_to_rgb(r[0][x], r[1][x], r[2][x], r[3][x], o);
          break;
        case Space::kYCCK:
          for (int x = 0; x < out_w; x++, o += 3) {
            // jdcolor.c ycck_cmyk_convert
            int yy = r[0][x], cb = r[1][x], cr = r[2][x];
            int c = clamp255(255 - (yy + kColor.cr_r[cr]));
            int m = clamp255(255 - (yy + static_cast<int>(
                (kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16)));
            int yel = clamp255(255 - (yy + kColor.cb_b[cb]));
            cmyk_to_rgb(c, m, yel, r[3][x], o);
          }
          break;
      }
    }
  }
};

void set_error(char* err, int errcap, const char* msg) {
  if (err && errcap > 0) {
    std::snprintf(err, static_cast<size_t>(errcap), "%s", msg);
  }
}

}  // namespace

extern "C" {

// The frame's size and component count from its SOF: info[0] = width,
// info[1] = height, info[2] = components. 0, or -1 with the reason in err.
int klab_jpeg_info(const uint8_t* data, int64_t size, int32_t* info,
                   char* err, int errcap) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.read_header();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errcap, e.what.c_str());
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
  }
  return -1;
}

// Decodes at scale 1/s (s in 1, 2, 4, 8) into out, (ceil(H/s), ceil(W/s), 3)
// uint8 RGB, whose capacity in bytes is cap. 0, or -1 with the reason in err.
int klab_jpeg_decode(const uint8_t* data, int64_t size, int scale,
                     uint8_t* out, int64_t cap, char* err, int errcap) {
  try {
    if (scale != 1 && scale != 2 && scale != 4 && scale != 8)
      fail("scale 1/%d: only 1, 2, 4 and 8", scale);
    Decoder(data, static_cast<size_t>(size)).decode(scale, out, cap);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errcap, e.what.c_str());
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
  }
  return -1;
}

}  // extern "C"
