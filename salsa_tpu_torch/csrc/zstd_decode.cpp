// zstd frame decoder (RFC 8878), host code only, with a plain C interface for
// ctypes. It reads what orbax / tensorstore write into `.orbax` checkpoints (zarr
// chunks and OCDBT nodes) and any other frame without a dictionary: raw, RLE and
// compressed blocks; raw, RLE, Huffman (1 or 4 streams) and treeless literals;
// predefined, RLE, FSE and repeat sequence tables; the three repeat offsets;
// several frames back to back, skippable frames and XXH64 content checksums.
//
//   long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap)
//
// returns the bytes written to dst, or a negative ZSTD_E* code below.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum : long {
  E_MAGIC = -1,      // not a zstd frame
  E_TRUNCATED = -2,  // the input ends inside a frame
  E_CORRUPT = -3,    // an invalid header, table, bitstream or offset
  E_DST = -4,        // the output does not fit into cap bytes
  E_CHECKSUM = -5,   // the content checksum does not match
  E_DICT = -6,       // the frame needs a dictionary
  E_SIZE = -7,       // the frame's content size does not match its blocks
};

struct Fail {
  long code;
};

[[noreturn]] void fail(long code) { throw Fail{code}; }

inline void need(bool ok, long code = E_CORRUPT) {
  if (!ok) fail(code);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---------------------------------------------------------------------------
// XXH64 (seed 0), for the content checksum
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------

// Little-endian bits read forward (FSE table descriptions); zeros past the end.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << nb) - 1));
  }
  void skip(int nb) { pos += nb; }
};

// A backward bitstream (Huffman streams, FSE-coded weights and sequences): it
// starts below the highest set bit of its last byte and is read towards its
// first byte; bits below the first byte read as zeros, and `pos` goes negative.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits left to read
  BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
    need(len > 0 && src[len - 1] != 0);
    pos = int64_t(len - 1) * 8 + highbit(src[len - 1]);
  }
  uint64_t window(int64_t byte) const {  // 8 bytes from `byte`, zeros past the end
    if (byte + 8 <= int64_t(n)) return le64(p + byte);
    uint64_t v = 0;
    for (int64_t i = 0; byte + i < int64_t(n); ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }
  // the next nb (<= 56) bits, the first read being the most significant
  uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    uint64_t mask = (1ULL << nb) - 1;
    if (lo >= 0) return (window(lo >> 3) >> (lo & 7)) & mask;
    if (pos <= 0) return 0;
    return (window(0) << (-lo)) & mask;
  }
  void skip(int nb) { pos -= nb; }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t nb_bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  FseEntry e[1 << 9];
};

// Normalized counts -> decoding table (FSE_buildDTable of the reference).
void fse_build(FseTable& t, const int16_t* norm, int n_symbols, int log) {
  int size = 1 << log, high = size - 1, total = 0;
  uint16_t next[256];
  for (int s = 0; s < n_symbols; ++s) total += norm[s] == -1 ? 1 : norm[s];
  need(total == size);  // every state is some symbol's
  t.log = log;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, position = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[position].symbol = uint8_t(s);
      do position = (position + step) & mask;
      while (position > high);
    }
  }
  need(position == 0);
  for (int u = 0; u < size; ++u) {
    uint16_t x = next[t.e[u].symbol]++;
    int nb = log - highbit(x);
    t.e[u].nb_bits = uint8_t(nb);
    t.e[u].base = uint16_t((x << nb) - size);
  }
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.e[0] = {symbol, 0, 0};
}

// An FSE table description at src (FSE_readNCount): returns its bytes.
size_t fse_read(FseTable& t, const uint8_t* src, size_t n, int max_log, int max_symbol) {
  need(n > 0, E_TRUNCATED);
  ForwardBits bits{src, n};
  int log = int(bits.peek(4)) + 5;
  bits.skip(4);
  need(log <= max_log);
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (previous0) {
      int n0 = s;
      while (bits.peek(2) == 3) {
        n0 += 3;
        bits.skip(2);
      }
      n0 += int(bits.peek(2));
      bits.skip(2);
      need(n0 <= max_symbol);
      while (s < n0) norm[s++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = bits.peek(nb);
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      bits.skip(nb - 1);
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.skip(nb);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  need(remaining == 1 && s <= max_symbol + 1);
  size_t used = (bits.pos + 7) >> 3;
  need(used <= n, E_TRUNCATED);
  fse_build(t, norm, s, log);
  return used;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackBits& bits) {
    t = &table;
    state = uint32_t(bits.read(table.log));
  }
  uint8_t symbol() const { return t->e[state].symbol; }
  void update(BackBits& bits) {
    const FseEntry& e = t->e[state];
    state = e.base + uint32_t(bits.read(e.nb_bits));
  }
};

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  uint16_t entry[1 << 11];  // by the next max_bits bits: symbol | bits << 8
};

// The Huffman tree description at src; returns its bytes.
size_t huf_read(HufTable& h, const uint8_t* src, size_t n) {
  need(n > 0, E_TRUNCATED);
  uint8_t w[256] = {0};
  int n_w = 0;
  size_t used;
  int header = src[0];
  if (header < 128) {  // FSE-coded weights, two interleaved states
    used = 1 + size_t(header);
    need(used <= n, E_TRUNCATED);
    FseTable t;
    size_t desc = fse_read(t, src + 1, header, 6, 255);
    need(desc < size_t(header));
    BackBits bits(src + 1 + desc, header - desc);
    FseState s1, s2;
    s1.init(t, bits);
    s2.init(t, bits);
    for (;;) {
      need(n_w < 255);
      w[n_w++] = s1.symbol();
      s1.update(bits);
      if (bits.pos < 0) {
        need(n_w < 255);
        w[n_w++] = s2.symbol();
        break;
      }
      need(n_w < 255);
      w[n_w++] = s2.symbol();
      s2.update(bits);
      if (bits.pos < 0) {
        need(n_w < 255);
        w[n_w++] = s1.symbol();
        break;
      }
    }
  } else {  // direct 4-bit weights, the first in the high nibble
    n_w = header - 127;
    used = 1 + size_t((n_w + 1) / 2);
    need(used <= n, E_TRUNCATED);
    for (int i = 0; i < n_w; ++i) w[i] = (src[1 + i / 2] >> (i % 2 ? 0 : 4)) & 15;
  }
  uint32_t total = 0;
  for (int i = 0; i < n_w; ++i) {
    need(w[i] <= 11);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  need(total > 0);
  int max_bits = highbit(total) + 1;
  need(max_bits <= 11);
  uint32_t rest = (1u << max_bits) - total;
  need((rest & (rest - 1)) == 0);  // a power of two: the implicit last weight
  w[n_w++] = uint8_t(highbit(rest) + 1);
  h.max_bits = max_bits;
  uint32_t position = 0;
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (int s = 0; s < n_w; ++s) {
      if (w[s] != weight) continue;
      uint32_t len = 1u << (weight - 1);
      uint16_t e = uint16_t(s | (max_bits + 1 - weight) << 8);
      for (uint32_t k = 0; k < len; ++k) h.entry[position + k] = e;
      position += len;
    }
  }
  need(position == (1u << max_bits));
  return used;
}

// One Huffman stream being decoded into out[0, count).
struct HufStream {
  BackBits bits;
  uint8_t* out;
  size_t count, i = 0;
  HufStream(const uint8_t* src, size_t n, uint8_t* dst, size_t cnt)
      : bits(src, n), out(dst), count(cnt) {}
  bool fast() const { return i + 4 <= count && bits.pos >= 56; }
  // four symbols (at most 44 bits) from one 8-byte load of the 56 bits below pos
  void step4(const HufTable& h) {
    int64_t lo = bits.pos - 56;
    uint64_t w = le64(bits.p + (lo >> 3)) >> (lo & 7);
    const int mb = h.max_bits;
    int top = 56;
    for (int k = 0; k < 4; ++k) {
      uint16_t e = h.entry[uint32_t(w >> (top - mb)) & ((1u << mb) - 1)];
      out[i + k] = uint8_t(e);
      top -= e >> 8;
    }
    bits.pos -= 56 - top;
    i += 4;
  }
  void finish(const HufTable& h) {
    for (; i < count; ++i) {
      uint16_t e = h.entry[bits.peek(h.max_bits)];
      out[i] = uint8_t(e);
      bits.skip(e >> 8);
    }
    need(bits.pos == 0);  // every stream is consumed exactly
  }
};

void huf_streams(const HufTable& h, HufStream* s, int n_streams) {
  if (n_streams == 4) {  // the four streams in lockstep: four independent chains
    while (s[0].fast() && s[1].fast() && s[2].fast() && s[3].fast()) {
      s[0].step4(h);
      s[1].step4(h);
      s[2].step4(h);
      s[3].step4(h);
    }
  }
  for (int k = 0; k < n_streams; ++k) {
    while (s[k].fast()) s[k].step4(h);
    s[k].finish(h);
  }
}

// ---------------------------------------------------------------------------
// sequences
// ---------------------------------------------------------------------------

constexpr uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t LL_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t ML_NORM[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t OF_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1,  1,  1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  uint8_t* dst;  // start of this frame's output
  size_t cap;    // bytes available from dst
  size_t out = 0;
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint8_t literals[1 << 17];
};

// One table of the sequences section in `mode`; returns the bytes it took.
size_t seq_table(FseTable& t, bool& have, int mode, const uint8_t* src, size_t n,
                 const int16_t* norm, int n_norm, int norm_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, norm, n_norm, norm_log);
      have = true;
      return 0;
    case 1:
      need(n >= 1, E_TRUNCATED);
      need(src[0] <= max_symbol);
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = fse_read(t, src, n, max_log, max_symbol);
      have = true;
      return used;
    }
    default:
      need(have);  // repeat: the previous block's table
      return 0;
  }
}

void copy_out(Frame& f, const uint8_t* src, size_t n) {
  need(n <= f.cap - f.out, E_DST);
  std::memcpy(f.dst + f.out, src, n);
  f.out += n;
}

void compressed_block(Frame& f, const uint8_t* src, size_t n) {
  // literals section
  need(n >= 1, E_TRUNCATED);
  int type = src[0] & 3, format = (src[0] >> 2) & 3;
  size_t regen, comp = 0, head;
  if (type < 2) {
    if (format == 0 || format == 2) {
      head = 1;
      regen = src[0] >> 3;
    } else if (format == 1) {
      head = 2;
      need(n >= 2, E_TRUNCATED);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      head = 3;
      need(n >= 3, E_TRUNCATED);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    head = format < 2 ? 3 : format == 2 ? 4 : 5;
    need(n >= head, E_TRUNCATED);
    uint64_t c = 0;
    for (size_t i = 0; i < head; ++i) c |= uint64_t(src[i]) << (8 * i);
    int width = head == 3 ? 10 : head == 4 ? 14 : 18;
    regen = (c >> 4) & ((1u << width) - 1);
    comp = (c >> (4 + width)) & ((1u << width) - 1);
  }
  need(regen <= (1u << 17));
  const uint8_t* p = src + head;
  size_t left = n - head;
  if (type == 0) {
    need(left >= regen, E_TRUNCATED);
    std::memcpy(f.literals, p, regen);
    p += regen;
    left -= regen;
  } else if (type == 1) {
    need(left >= 1, E_TRUNCATED);
    std::memset(f.literals, p[0], regen);
    p += 1;
    left -= 1;
  } else {
    need(left >= comp, E_TRUNCATED);
    const uint8_t* q = p;
    size_t qn = comp;
    if (type == 2) {
      size_t t = huf_read(f.huf, q, qn);
      q += t;
      qn -= t;
    } else {
      need(f.huf.max_bits > 0);  // treeless: the previous block's table
    }
    if (format == 0) {
      HufStream one(q, qn, f.literals, regen);
      huf_streams(f.huf, &one, 1);
    } else {
      need(qn >= 6, E_TRUNCATED);
      size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
      need(6 + s1 + s2 + s3 <= qn);
      size_t s4 = qn - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
      need(3 * seg <= regen);
      const uint8_t* s = q + 6;
      HufStream four[4] = {
          {s, s1, f.literals, seg},
          {s + s1, s2, f.literals + seg, seg},
          {s + s1 + s2, s3, f.literals + 2 * seg, seg},
          {s + s1 + s2 + s3, s4, f.literals + 3 * seg, regen - 3 * seg}};
      huf_streams(f.huf, four, 4);
    }
    p += comp;
    left -= comp;
  }

  // sequences section
  need(left >= 1, E_TRUNCATED);
  size_t n_seq = p[0];
  if (n_seq < 128) {
    p += 1;
    left -= 1;
  } else if (n_seq < 255) {
    need(left >= 2, E_TRUNCATED);
    n_seq = ((n_seq - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    need(left >= 3, E_TRUNCATED);
    n_seq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  if (n_seq == 0) {
    need(left == 0);
    copy_out(f, f.literals, regen);
    return;
  }
  need(left >= 1, E_TRUNCATED);
  int modes = p[0];
  need((modes & 3) == 0);
  p += 1;
  left -= 1;
  size_t t = seq_table(f.ll, f.have_ll, modes >> 6, p, left, LL_NORM, 36, 6, 9, 35);
  p += t;
  left -= t;
  t = seq_table(f.of, f.have_of, (modes >> 4) & 3, p, left, OF_NORM, 29, 5, 8, 31);
  p += t;
  left -= t;
  t = seq_table(f.ml, f.have_ml, (modes >> 2) & 3, p, left, ML_NORM, 53, 6, 9, 52);
  p += t;
  left -= t;

  BackBits bits(p, left);
  FseState ll, of, ml;
  ll.init(f.ll, bits);
  of.init(f.of, bits);
  ml.init(f.ml, bits);
  size_t lit = 0;
  for (size_t i = 0; i < n_seq; ++i) {
    int of_code = of.symbol(), ml_code = ml.symbol(), ll_code = ll.symbol();
    need(of_code <= 31 && ml_code <= 52 && ll_code <= 35);
    uint32_t offset_value = (1u << of_code) + uint32_t(bits.read(of_code));
    size_t match = ML_BASE[ml_code] + bits.read(ML_BITS[ml_code]);
    size_t lits = LL_BASE[ll_code] + bits.read(LL_BITS[ll_code]);
    uint32_t offset;
    if (offset_value > 3) {
      offset = offset_value - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      uint32_t idx = offset_value - (lits == 0 ? 0 : 1);  // 0..3 into rep (3: rep0 - 1)
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (idx != 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      ll.update(bits);
      ml.update(bits);
      of.update(bits);
    }
    need(lits <= regen - lit);
    copy_out(f, f.literals + lit, lits);
    lit += lits;
    need(offset > 0 && offset <= f.out);
    need(match <= f.cap - f.out, E_DST);
    uint8_t* d = f.dst + f.out;
    const uint8_t* from = d - offset;
    if (offset >= match) {
      std::memcpy(d, from, match);
    } else {
      for (size_t k = 0; k < match; ++k) d[k] = from[k];
    }
    f.out += match;
  }
  need(bits.pos == 0);
  copy_out(f, f.literals + lit, regen - lit);
}

// One frame at src; returns the input bytes it took and adds its output to *out.
size_t frame(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out, Frame& f) {
  need(n >= 5, E_TRUNCATED);
  int fhd = src[4];
  need((fhd & 0x08) == 0);  // reserved bit
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did = fhd & 3;
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    need(n >= pos + 1, E_TRUNCATED);
    int wd = src[pos++];
    uint64_t base = 1ULL << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  size_t did_size = did == 3 ? 4 : did;
  need(n >= pos + did_size, E_TRUNCATED);
  uint32_t dict_id = 0;
  for (size_t i = 0; i < did_size; ++i) dict_id |= uint32_t(src[pos + i]) << (8 * i);
  if (dict_id != 0) fail(E_DICT);
  pos += did_size;
  size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
  need(n >= pos + fcs_size, E_TRUNCATED);
  uint64_t content = 0;
  bool has_content = fcs_size > 0;
  for (size_t i = 0; i < fcs_size; ++i) content |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) content += 256;
  pos += fcs_size;
  if (single) window = content;
  size_t block_max = window < (1u << 17) ? size_t(window) : size_t(1) << 17;

  f.dst = dst + *out;
  f.cap = cap - *out;
  f.out = 0;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  f.huf.max_bits = 0;
  f.have_ll = f.have_of = f.have_ml = false;
  for (bool last = false; !last;) {
    need(n >= pos + 3, E_TRUNCATED);
    uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    need(type != 3);
    if (type == 1) {  // RLE: one byte, `size` times
      need(size <= block_max);
      need(n >= pos + 1, E_TRUNCATED);
      need(size <= f.cap - f.out, E_DST);
      std::memset(f.dst + f.out, src[pos], size);
      f.out += size;
      pos += 1;
    } else {
      need(size <= block_max);
      need(n >= pos + size, E_TRUNCATED);
      if (type == 0)
        copy_out(f, src + pos, size);
      else
        compressed_block(f, src + pos, size);
      pos += size;
    }
  }
  if (has_content) need(f.out == content, E_SIZE);
  if (checksum) {
    need(n >= pos + 4, E_TRUNCATED);
    if (uint32_t(xxh64(f.dst, f.out)) != le32(src + pos)) fail(E_CHECKSUM);
    pos += 4;
  }
  *out += f.out;
  return pos;
}

}  // namespace

extern "C" long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  static thread_local Frame* state = nullptr;
  if (!state) state = new Frame();
  size_t pos = 0, out = 0;
  try {
    need(n >= 4, E_TRUNCATED);
    while (pos < n) {
      need(n - pos >= 4, E_TRUNCATED);
      uint32_t magic = le32(src + pos);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame
        need(n - pos >= 8, E_TRUNCATED);
        size_t size = le32(src + pos + 4);
        need(n - pos - 8 >= size, E_TRUNCATED);
        pos += 8 + size;
        continue;
      }
      if (magic != 0xFD2FB528u) fail(pos == 0 ? E_MAGIC : E_CORRUPT);
      pos += frame(src + pos, n - pos, dst, cap, &out, *state);
    }
  } catch (const Fail& e) {
    return e.code;
  }
  return long(out);
}

extern "C" uint64_t zstd_xxh64(const uint8_t* src, size_t n) { return xxh64(src, n); }
