// TUM RGB-D frame loader: a PNG decoder with its own inflate, and a
// prefetch thread pool.
//
// The port's copy of the repository's native/tum_loader.cpp, with the same
// C ABI (tum_decode_pair, tum_prefetcher_create/get/destroy), consumed via
// ctypes by supersurfel_fusion_tpu_torch/io/native_loader.py. It decodes the
// two PNG flavours TUM ships (8-bit RGB, colour type 2, and 16-bit grey,
// colour type 0; non-interlaced) into caller-provided buffers, and its
// prefetcher decodes frames ahead of the SLAM loop so that host decoding
// overlaps the card's work.
//
// It links nothing but pthread: the zlib stream of the IDAT chunks is
// inflated here (RFC 1950 header and Adler-32 check; RFC 1951 stored,
// fixed-Huffman and dynamic-Huffman blocks). Huffman codes are decoded
// through a 10-bit lookup table, longer codes through the canonical code's
// per-length limits; each worker thread keeps its own decoder state.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -o libtum_loader.so tum_loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Inflate (RFC 1950 / RFC 1951)
// ---------------------------------------------------------------------------

constexpr int kFastBits = 10;
constexpr int kMaxSymbols = 288;

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
// order in which the code-length code's lengths are sent
const uint8_t kClenOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                11, 4,  12, 3, 13, 2, 14, 1, 15};

// A canonical Huffman code: codes of up to kFastBits bits resolve in one
// lookup of the next kFastBits input bits (bit-reversed, as deflate sends
// them); longer codes are found by comparing the next 16 bits, read MSB
// first, against each length's limit.
struct Huffman {
  uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0: slow path
  uint16_t first_code[17];
  uint16_t first_index[17];
  uint32_t limit[17];             // (last code of the length + 1) << (16 - len)
  uint8_t length[kMaxSymbols];    // by sorted index
  uint16_t symbol[kMaxSymbols];   // by sorted index
  int total = 0;                  // symbols with a code

  bool build(const uint8_t* lens, int n) {
    int count[17] = {0};
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    std::memset(fast, 0, sizeof(fast));
    int next[17];
    int code = 0, index = 0;
    for (int len = 1; len <= 16; len++) {
      next[len] = code;
      first_code[len] = uint16_t(code);
      first_index[len] = uint16_t(index);
      code += count[len];
      if (count[len] && code - 1 >= (1 << len)) return false;  // oversubscribed
      limit[len] = uint32_t(code) << (16 - len);
      code <<= 1;
      index += count[len];
    }
    limit[16] = 0x10000;  // sentinel: every 16-bit value is below
    total = index;
    for (int s = 0; s < n; s++) {
      int len = lens[s];
      if (!len) continue;
      int idx = next[len] - first_code[len] + first_index[len];
      length[idx] = uint8_t(len);
      symbol[idx] = uint16_t(s);
      if (len <= kFastBits) {
        int rev = 0, c = next[len];
        for (int b = 0; b < len; b++) rev |= ((c >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << kFastBits); j += 1 << len)
          fast[j] = uint16_t((len << 9) | s);
      }
      next[len]++;
    }
    return true;
  }
};

inline uint32_t reverse16(uint32_t v) {
  v = ((v & 0xAAAA) >> 1) | ((v & 0x5555) << 1);
  v = ((v & 0xCCCC) >> 2) | ((v & 0x3333) << 2);
  v = ((v & 0xF0F0) >> 4) | ((v & 0x0F0F) << 4);
  v = ((v & 0xFF00) >> 8) | ((v & 0x00FF) << 8);
  return v;
}

// Reads the deflate stream LSB first through a 64-bit buffer. Past the end
// of the input it supplies zero bytes and counts them; a stream that needs
// any of them is truncated.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;          // valid bits in buf
  size_t padded = 0;    // zero bytes supplied past the end

  BitReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  // at least 56 valid bits afterwards
  inline void refill() {
    if (end - p >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);  // little-endian host
      buf |= w << cnt;
      p += (63 - cnt) >> 3;
      cnt |= 56;
      return;
    }
    while (cnt <= 56) {
      if (p < end) {
        buf |= uint64_t(*p++) << cnt;
      } else {
        padded++;
      }
      cnt += 8;
    }
  }
  inline uint32_t peek(int n) const { return uint32_t(buf & ((1ull << n) - 1)); }
  inline void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  inline uint32_t bits(int n) {  // n <= 32; refills as needed
    if (cnt < n) refill();
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
  bool truncated() const { return padded * 8 > size_t(cnt); }
};

// the fixed-Huffman block's codes (RFC 1951, 3.2.6)
struct FixedCodes {
  Huffman litlen, dist;
  FixedCodes() {
    uint8_t lens[288];
    std::memset(lens, 8, 144);
    std::memset(lens + 144, 9, 112);
    std::memset(lens + 256, 7, 24);
    std::memset(lens + 280, 8, 8);
    litlen.build(lens, 288);
    std::memset(lens, 5, 30);
    dist.build(lens, 30);
  }
};

// out[0, len) = out[-d, len - d), overlapping when d < len, in 8-byte
// steps (the output buffer has 8 bytes of slack past its end). A distance
// under 8 is widened to its first multiple of at least 8 once that many
// bytes are written: the copy repeats with period d either way.
inline void copy_match(uint8_t* dst, size_t d, size_t len) {
  if (d == 1) {
    std::memset(dst, dst[-1], len);
    return;
  }
  size_t i = 0;
  if (d < 8) {
    size_t wide = d * ((8 + d - 1) / d);
    for (; i < len && i < wide; i++) dst[i] = dst[i - d];
    d = wide;
  }
  for (; i < len; i += 8) std::memcpy(dst + i, dst + i - d, 8);
}

// Adler-32 (RFC 1950) of data[0, n): 32-byte blocks, each adding its byte
// sum to a and its position-weighted sum to b, both reduced every 173
// blocks (5536 bytes, under zlib's 5552-byte bound for 32-bit sums)
uint32_t adler32(const uint8_t* data, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t m = std::min<size_t>(n, 5536);
    n -= m;
    for (; m >= 32; m -= 32, data += 32) {
      uint32_t s = 0, w = 0;
      for (int j = 0; j < 32; j++) {
        s += data[j];
        w += uint32_t(32 - j) * data[j];
      }
      b += 32 * a + w;
      a += s;
    }
    for (; m; m--) {
      a += *data++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// one decoder state per thread: the dynamic block's two codes and the
// code-length code
struct Inflater {
  Huffman litlen, dist, clen;

  // the next symbol of `h`, or -1 on a code the table does not hold
  static inline int decode(BitReader& br, const Huffman& h) {
    if (br.cnt < 16) br.refill();
    uint16_t e = h.fast[br.peek(kFastBits)];
    if (e) {
      br.drop(e >> 9);
      return e & 511;
    }
    uint32_t k = reverse16(br.peek(16));
    int len = kFastBits + 1;
    while (k >= h.limit[len]) len++;  // stops at 16: limit[16] is 2**16
    if (len == 16) return -1;
    int idx = int(k >> (16 - len)) - h.first_code[len] + h.first_index[len];
    if (idx < 0 || idx >= h.total || h.length[idx] != len) return -1;
    br.drop(len);
    return h.symbol[idx];
  }

  bool read_dynamic(BitReader& br) {
    int hlit = int(br.bits(5)) + 257;
    int hdist = int(br.bits(5)) + 1;
    int hclen = int(br.bits(4)) + 4;
    if (hlit > 286 || hdist > 30) return false;
    uint8_t clens[19] = {0};
    for (int i = 0; i < hclen; i++) clens[kClenOrder[i]] = uint8_t(br.bits(3));
    if (!clen.build(clens, 19)) return false;
    uint8_t lens[286 + 30];
    int n = 0;
    while (n < hlit + hdist) {
      int sym = decode(br, clen);
      if (sym < 0 || br.padded > 16) return false;
      if (sym < 16) {
        lens[n++] = uint8_t(sym);
        continue;
      }
      int rep;
      uint8_t val = 0;
      if (sym == 16) {
        if (n == 0) return false;
        val = lens[n - 1];
        rep = 3 + int(br.bits(2));
      } else if (sym == 17) {
        rep = 3 + int(br.bits(3));
      } else {
        rep = 11 + int(br.bits(7));
      }
      if (n + rep > hlit + hdist) return false;
      std::memset(lens + n, val, rep);
      n += rep;
    }
    if (lens[256] == 0) return false;  // no end-of-block code
    return litlen.build(lens, hlit) && dist.build(lens + hlit, hdist);
  }

  // the compressed symbols of one block into out[pos, cap)
  static bool inflate_block(BitReader& br, const Huffman& lt,
                            const Huffman& dt, uint8_t* out, size_t& pos,
                            size_t cap) {
    for (;;) {
      if (br.cnt < 48) {
        br.refill();
        if (br.padded > 16) return false;
      }
      int sym = decode(br, lt);
      if (sym < 256) {
        if (sym < 0 || pos >= cap) return false;
        out[pos++] = uint8_t(sym);
        continue;
      }
      if (sym == 256) return true;
      sym -= 257;
      if (sym >= 29) return false;
      size_t len = kLenBase[sym] + br.bits(kLenExtra[sym]);
      int ds = decode(br, dt);
      if (ds < 0 || ds >= 30) return false;
      size_t d = kDistBase[ds] + br.bits(kDistExtra[ds]);
      if (d > pos || len > cap - pos) return false;
      copy_match(out + pos, d, len);
      pos += len;
    }
  }

  // inflate the zlib stream `in` into out[0, n); `out` holds n + 8 bytes
  bool zlib_inflate(const uint8_t* in, size_t in_len, uint8_t* out,
                    size_t n) {
    if (in_len < 6) return false;
    uint8_t cmf = in[0], flg = in[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 ||
        (flg & 0x20))  // deflate, window <= 32K, header check, no dictionary
      return false;
    BitReader br(in + 2, in_len - 2);
    size_t pos = 0;
    bool last = false;
    while (!last) {
      last = br.bits(1);
      uint32_t type = br.bits(2);
      if (type == 0) {
        br.drop(br.cnt & 7);  // to a byte boundary
        uint32_t len = br.bits(16), nlen = br.bits(16);
        if ((len ^ 0xFFFF) != nlen || len > n - pos) return false;
        while (len && br.cnt >= 8) {  // whole bytes still in the buffer
          out[pos++] = uint8_t(br.peek(8));
          br.drop(8);
          len--;
        }
        if (len) {
          if (size_t(br.end - br.p) < len) return false;
          std::memcpy(out + pos, br.p, len);
          br.p += len;
          pos += len;
          br.buf = 0;  // it may hold look-ahead bits of the copied bytes
        }
      } else if (type == 1) {
        static const FixedCodes fixed;
        if (!inflate_block(br, fixed.litlen, fixed.dist, out, pos, n))
          return false;
      } else if (type == 2) {
        if (!read_dynamic(br) || !inflate_block(br, litlen, dist, out, pos, n))
          return false;
      } else {
        return false;
      }
      if (br.truncated()) return false;
    }
    if (pos != n) return false;
    br.drop(br.cnt & 7);
    uint32_t want = 0;
    for (int i = 0; i < 4; i++) want = (want << 8) | br.bits(8);
    if (br.truncated()) return false;
    return adler32(out, n) == want;
  }
};

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct Image {
  uint32_t width = 0, height = 0;
  uint8_t bit_depth = 0, color_type = 0;
  std::vector<uint8_t> pixels;  // unfiltered raw (RGB8 interleaved or
                                // big-endian 16-bit gray)
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  // branchless form: p-a = b-c, p-b = a-c, p-c = (b-c)+(a-c)
  int pa = std::abs(b - c), pb = std::abs(a - c),
      pc = std::abs(b - c + a - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Sub (1), Average (3) or Paeth (4) over one row of BPP-byte pixels, each
// byte depending on the one BPP bytes before it: the previous pixel's
// bytes (a) and the previous row's (c) stay in registers, so the BPP
// channels are independent chains and no byte waits on a store. `up` is
// the previous output row, or a zero pixel repeated (up_step 0) in row 0.
template <int BPP, int F>
void unfilter_chain(uint8_t* dst, const uint8_t* src, const uint8_t* up,
                    size_t up_step, size_t stride) {
  int a[BPP] = {0}, c[BPP] = {0};
  for (size_t x = 0; x < stride; x += BPP, up += up_step) {
    for (int i = 0; i < BPP; i++) {
      int b = up[i], v;
      if (F == 1) {
        v = src[x + i] + a[i];
      } else if (F == 3) {
        v = src[x + i] + ((a[i] + b) >> 1);
      } else {
        v = src[x + i] + paeth(a[i], b, c[i]);
      }
      a[i] = dst[x + i] = uint8_t(v);
      c[i] = b;
    }
  }
}

// Unfilter one PNG row. `prev` is the previous OUTPUT row (null for row 0,
// whose previous row is zeros).
template <int BPP>
bool unfilter_row(uint8_t filter, uint8_t* dst, const uint8_t* src,
                  const uint8_t* prev, size_t stride) {
  static const uint8_t zeros[BPP] = {0};
  const uint8_t* up = prev ? prev : zeros;
  size_t up_step = prev ? BPP : 0;
  switch (filter) {
    case 0:
      std::memcpy(dst, src, stride);
      return true;
    case 1:
      unfilter_chain<BPP, 1>(dst, src, up, up_step, stride);
      return true;
    case 2:
      for (size_t x = 0; x < stride; x++)
        dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
      return true;
    case 3:
      unfilter_chain<BPP, 3>(dst, src, up, up_step, stride);
      return true;
    case 4:
      unfilter_chain<BPP, 4>(dst, src, up, up_step, stride);
      return true;
    default:
      return false;
  }
}

bool decode_png(const std::string& path, Image& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  if (size < 45 || std::memcmp(buf.data(), "\x89PNG\r\n\x1a\n", 8) != 0)
    return false;

  // collect IDAT spans; a single chunk is inflated straight out of the
  // file buffer
  std::vector<std::pair<const uint8_t*, size_t>> idat_spans;
  size_t idat_total = 0;
  size_t off = 8;
  bool have_header = false;
  while (off + 12 <= buf.size()) {
    uint32_t len = be32(&buf[off]);
    // bound the chunk body (data + 4-byte CRC) to the file buffer: a
    // truncated or corrupt PNG fails cleanly instead of overreading
    if (len > buf.size() - off - 12) return false;
    const char* type = reinterpret_cast<const char*>(&buf[off + 4]);
    const uint8_t* data = &buf[off + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;
      out.width = be32(data);
      out.height = be32(data + 4);
      out.bit_depth = data[8];
      out.color_type = data[9];
      if (data[12] != 0) return false;  // interlaced unsupported
      have_header = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat_spans.emplace_back(data, len);
      idat_total += len;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (!have_header || idat_spans.empty()) return false;
  // 8-bit RGB or 16-bit grey, at most 2**28 pixels
  bool rgb8 = out.color_type == 2 && out.bit_depth == 8;
  bool grey16 = out.color_type == 0 && out.bit_depth == 16;
  if (!(rgb8 || grey16) || out.width == 0 || out.height == 0 ||
      uint64_t(out.width) * out.height > (1ull << 28))
    return false;

  const uint8_t* idat_ptr;
  std::vector<uint8_t> idat_joined;
  if (idat_spans.size() == 1) {
    idat_ptr = idat_spans[0].first;
  } else {
    idat_joined.reserve(idat_total);
    for (auto& s : idat_spans)
      idat_joined.insert(idat_joined.end(), s.first, s.first + s.second);
    idat_ptr = idat_joined.data();
  }

  int bpp = rgb8 ? 3 : 2;  // bytes per pixel
  size_t stride = size_t(out.width) * bpp;
  size_t n_raw = (stride + 1) * out.height;
  std::vector<uint8_t> raw(n_raw + 8);  // 8 bytes of slack for match copies

  thread_local Inflater inflater;
  if (!inflater.zlib_inflate(idat_ptr, idat_total, raw.data(), n_raw))
    return false;

  out.pixels.resize(stride * out.height);
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < out.height; y++) {
    const uint8_t* src = &raw[(stride + 1) * y];
    uint8_t* dst = &out.pixels[stride * y];
    bool ok = rgb8 ? unfilter_row<3>(src[0], dst, src + 1, prev, stride)
                   : unfilter_row<2>(src[0], dst, src + 1, prev, stride);
    if (!ok) return false;
    prev = dst;
  }
  return true;
}

bool decode_frame(const std::string& rgb_path, const std::string& depth_path,
                  Image& rgb, Image& depth) {
  try {
    return decode_png(rgb_path, rgb) && decode_png(depth_path, depth) &&
           rgb.color_type == 2 && depth.color_type == 0 &&
           rgb.width == depth.width && rgb.height == depth.height;
  } catch (...) {  // allocation failure: the frame fails, the caller lives
    return false;
  }
}

void depth_to_host(const Image& depth, uint16_t* out) {
  size_t n = size_t(depth.width) * depth.height;
  for (size_t i = 0; i < n; i++)  // big-endian -> host
    out[i] = uint16_t((uint16_t(depth.pixels[2 * i]) << 8) |
                      depth.pixels[2 * i + 1]);
}

// ---------------------------------------------------------------------------
// Prefetcher: a worker pool decoding (rgb, depth) pairs ahead of the consumer.
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<uint8_t> rgb;      // H*W*3
  std::vector<uint16_t> depth;   // H*W host-endian
  uint32_t width = 0, height = 0;
  bool ok = false;
};

struct Prefetcher {
  std::vector<std::pair<std::string, std::string>> files;
  std::vector<bool> served;      // frames already handed to the consumer
  std::unordered_map<int, Frame> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::atomic<int> next_to_schedule{0};
  int next_to_consume = 0;
  int lookahead = 8;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = -1;
      {
        std::lock_guard<std::mutex> lk(mu);
        int candidate = next_to_schedule.load();
        if (candidate < int(files.size()) &&
            candidate < next_to_consume + lookahead) {
          idx = candidate;
          next_to_schedule++;
        }
      }
      if (idx < 0) {
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
        continue;
      }
      Frame fr;
      Image rgb_img, depth_img;
      if (decode_frame(files[idx].first, files[idx].second, rgb_img,
                       depth_img)) {
        fr.width = rgb_img.width;
        fr.height = rgb_img.height;
        fr.rgb = std::move(rgb_img.pixels);
        fr.depth.resize(size_t(fr.width) * fr.height);
        depth_to_host(depth_img, fr.depth.data());
        fr.ok = true;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(fr));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// one-shot synchronous decode into caller buffers (rgb: H*W*3 uint8,
// depth: H*W uint16). Returns 1 on success, 0 on failure.
int tum_decode_pair(const char* rgb_path, const char* depth_path,
                    uint8_t* rgb_out, uint16_t* depth_out, int width,
                    int height) {
  Image rgb_img, depth_img;
  if (!decode_frame(rgb_path, depth_path, rgb_img, depth_img)) return 0;
  if (int(rgb_img.width) != width || int(rgb_img.height) != height) return 0;
  std::memcpy(rgb_out, rgb_img.pixels.data(), size_t(width) * height * 3);
  depth_to_host(depth_img, depth_out);
  return 1;
}

void* tum_prefetcher_create(const char** rgb_paths, const char** depth_paths,
                            int n, int n_threads, int lookahead) {
  auto* p = new Prefetcher();
  p->files.reserve(n);
  for (int i = 0; i < n; i++) p->files.emplace_back(rgb_paths[i], depth_paths[i]);
  p->served.assign(n, false);
  p->lookahead = lookahead;
  for (int i = 0; i < n_threads; i++)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocking: fetch frame `idx` (consumed in order for the best overlap).
// Returns 1 on success, 0 when the frame failed to decode or has another
// size, -1 when `idx` is out of range or was already served (each frame is
// decoded once and handed out once).
int tum_prefetcher_get(void* handle, int idx, uint8_t* rgb_out,
                       uint16_t* depth_out, int width, int height) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  if (idx < 0 || idx >= int(p->files.size()) || p->served[idx]) return -1;
  p->next_to_consume = idx;
  p->cv_ready.wait(lk, [&] { return p->ready.count(idx) > 0; });
  Frame fr = std::move(p->ready[idx]);
  p->ready.erase(idx);
  p->served[idx] = true;
  lk.unlock();
  if (!fr.ok || int(fr.width) != width || int(fr.height) != height) return 0;
  std::memcpy(rgb_out, fr.rgb.data(), size_t(width) * height * 3);
  std::memcpy(depth_out, fr.depth.data(), size_t(width) * height * 2);
  return 1;
}

void tum_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
