// Parquet column-chunk writer and reader for the port's file I/O (host C++).
//
// Writer: the shuffled-write encoder of nvtabular_tpu (cpp/nvt_parquet.cc),
// without its fused transform and its page-reuse mode. The shuffle window's
// gather is fused into the encode; pages are DataPage V1 of REQUIRED columns,
// PLAIN, DELTA_BINARY_PACKED or BYTE_STREAM_SPLIT, uncompressed or zstd. One
// page per column chunk per row group; Python writes the thrift footer.
//
// Reader: decodes one column chunk of a flat column: DataPage V1 pages in
// PLAIN, DELTA_BINARY_PACKED or BYTE_STREAM_SPLIT, uncompressed or zstd,
// REQUIRED or OPTIONAL (definition levels in the RLE/bit-packed hybrid,
// which must all be 1: a real null is refused). Page headers are parsed with
// a thrift compact reader that skips fields it does not know. Python parses
// the footer and maps the error codes below to messages.
//
// zstd is optional: without <zstd.h> the library builds, and asking it to
// compress or decompress zstd returns kErrNoZstd.
//
// C ABI (ctypes; nvtabular_tpu_torch/io/native_parquet.py):
//   nvtpq_open(path)                                    -> writer handle
//   nvtpq_write_column(h, srcs, npieces, gidx, n, dtype, enc, codec, level,
//                      out_meta[4])                     -> 0 ok
//   nvtpq_close(h)                                      -> 0 ok
//   nvtpq_build_window_index(...)                       -> selected rows
//   nvtpq_read_chunk(path, offset, size, num_values, dtype, max_def, codec,
//                    out)                               -> 0 ok, else kErr*
//   nvtpq_has_zstd()                                    -> 1 when built with zstd

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <type_traits>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#if __has_include(<zstd.h>)
#include <zstd.h>
#define NVTPQ_HAVE_ZSTD 1
#else
#define NVTPQ_HAVE_ZSTD 0
#endif

namespace {

// Encodings / codecs / page types (parquet.thrift enum values).
constexpr int kEncPlain = 0;
constexpr int kEncRle = 3;
constexpr int kEncDelta = 5;
constexpr int kEncByteStreamSplit = 9;
constexpr int kCodecUncompressed = 0;
constexpr int kCodecZstd = 6;
constexpr int kPageData = 0;
constexpr int kPageDictionary = 2;
constexpr int kPageDataV2 = 3;

// Return codes shared with io/native_parquet.py.
constexpr int kErrEncoding = 2;     // encoding not in the native subset
constexpr int kErrCodec = 3;        // codec not in the native subset
constexpr int kErrIo = 4;           // read/write failed
constexpr int kErrNoZstd = 6;       // zstd asked for, library built without it
constexpr int kErrDictionary = 10;  // dictionary page
constexpr int kErrPageV2 = 11;      // DataPage V2
constexpr int kErrNull = 12;        // a definition level of 0 (a real null)
constexpr int kErrCorrupt = 13;     // truncated or inconsistent chunk
constexpr int kErrPageType = 14;    // index page or unknown page type

// ---------------------------------------------------------------- thrift
// Minimal thrift compact-protocol writer (just what PageHeader needs).
struct ThriftBuf {
  std::vector<uint8_t> buf;
  int16_t last_fid = 0;

  void u8(uint8_t b) { buf.push_back(b); }
  void uleb(uint64_t v) {
    while (v >= 0x80) {
      u8(static_cast<uint8_t>(v) | 0x80);
      v >>= 7;
    }
    u8(static_cast<uint8_t>(v));
  }
  static uint64_t zigzag(int64_t v) {
    return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
  }
  // compact types: I32=5, STRUCT=12
  void field_i32(int16_t fid, int32_t v) {
    field_header(fid, 5);
    uleb(zigzag(v));
  }
  void field_struct(int16_t fid) { field_header(fid, 12); }
  void field_header(int16_t fid, uint8_t type) {
    int delta = fid - last_fid;
    if (delta >= 1 && delta <= 15) {
      u8(static_cast<uint8_t>((delta << 4) | type));
    } else {
      u8(type);
      uleb(zigzag(fid));
    }
    last_fid = fid;
  }
  void stop() { u8(0); }
};

// PageHeader{type=DATA_PAGE(0), uncompressed_page_size, compressed_page_size,
//            data_page_header{num_values, encoding, def=RLE(3), rep=RLE(3)}}
void write_page_header(ThriftBuf* t, int64_t uncomp, int64_t comp,
                       int64_t num_values, int encoding) {
  t->field_i32(1, kPageData);
  t->field_i32(2, static_cast<int32_t>(uncomp));
  t->field_i32(3, static_cast<int32_t>(comp));
  t->field_struct(5);  // data_page_header
  int16_t outer = t->last_fid;
  t->last_fid = 0;
  t->field_i32(1, static_cast<int32_t>(num_values));
  t->field_i32(2, encoding);
  t->field_i32(3, kEncRle);  // definition_level_encoding (unused: REQUIRED)
  t->field_i32(4, kEncRle);  // repetition_level_encoding
  t->stop();
  t->last_fid = outer;
  t->stop();
}

// Thrift compact-protocol reader over a byte range: reads the fields of a
// PageHeader it needs and skips every other field, nested ones included.
struct ThriftIn {
  const uint8_t* p;
  const uint8_t* end;
  bool bad = false;

  uint8_t u8() {
    if (p >= end) {
      bad = true;
      return 0;
    }
    return *p++;
  }
  uint64_t uleb() {
    uint64_t v = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      uint8_t b = u8();
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80) || bad) return v;
    }
    bad = true;
    return v;
  }
  int64_t zz() {
    uint64_t v = uleb();
    return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
  }
  // Reads a field header; returns false at STOP. Types: 1/2 bool, 3 byte,
  // 4 i16, 5 i32, 6 i64, 7 double, 8 binary, 9 list, 10 set, 11 map, 12 struct
  bool field(int16_t* fid, int* type, int16_t* last) {
    uint8_t b = u8();
    if (bad || b == 0) return false;
    *type = b & 0x0F;
    int delta = b >> 4;
    *fid = delta ? static_cast<int16_t>(*last + delta) : static_cast<int16_t>(zz());
    *last = *fid;
    return true;
  }
  void skip(int type, int depth = 0) {
    if (depth > 32) {
      bad = true;
      return;
    }
    switch (type) {
      case 1:
      case 2:
        return;  // bool lives in the field header
      case 3:
        u8();
        return;
      case 4:
      case 5:
      case 6:
        uleb();
        return;
      case 7:
        if (end - p < 8) bad = true;
        else p += 8;
        return;
      case 8: {
        uint64_t n = uleb();
        if (static_cast<uint64_t>(end - p) < n) bad = true;
        else p += n;
        return;
      }
      case 9:
      case 10: {
        uint8_t h = u8();
        uint64_t n = h >> 4;
        if (n == 15) n = uleb();
        int et = h & 0x0F;
        for (uint64_t i = 0; i < n && !bad; i++) skip_elem(et, depth + 1);
        return;
      }
      case 11: {
        uint64_t n = uleb();
        if (n == 0) return;
        uint8_t kv = u8();
        for (uint64_t i = 0; i < n && !bad; i++) {
          skip_elem(kv >> 4, depth + 1);
          skip_elem(kv & 0x0F, depth + 1);
        }
        return;
      }
      case 12: {
        int16_t last = 0, fid;
        int t;
        while (!bad && field(&fid, &t, &last)) skip(t, depth + 1);
        return;
      }
      default:
        bad = true;
    }
  }
  // list/set/map elements carry no field header; a bool element is a byte
  void skip_elem(int type, int depth) {
    if (type == 1 || type == 2) u8();
    else skip(type, depth);
  }
};

struct PageHeader {
  int type = -1;
  int64_t uncomp = -1;
  int64_t comp = -1;
  int64_t num_values = -1;
  int encoding = -1;
};

// Parses a PageHeader at t->p; leaves t->p at the page body.
bool read_page_header(ThriftIn* t, PageHeader* h) {
  int16_t last = 0, fid;
  int type;
  while (t->field(&fid, &type, &last)) {
    if (fid == 1 && type == 5) h->type = static_cast<int>(t->zz());
    else if (fid == 2 && type == 5) h->uncomp = t->zz();
    else if (fid == 3 && type == 5) h->comp = t->zz();
    else if (fid == 5 && type == 12) {  // DataPageHeader
      int16_t ilast = 0, ifid;
      int itype;
      while (t->field(&ifid, &itype, &ilast)) {
        if (ifid == 1 && itype == 5) h->num_values = t->zz();
        else if (ifid == 2 && itype == 5) h->encoding = static_cast<int>(t->zz());
        else t->skip(itype);
        if (t->bad) return false;
      }
    } else {
      t->skip(type);
    }
    if (t->bad) return false;
  }
  return !t->bad && h->type >= 0 && h->comp >= 0 && h->uncomp >= 0;
}

// ---------------------------------------------------------------- handle
struct Writer {
  FILE* f = nullptr;
  int64_t offset = 0;
  std::vector<uint8_t> scratch;  // gathered column values
  std::vector<uint8_t> enc;      // encoded page body
  std::vector<uint8_t> comp;     // compressed page body
};

// ------------------------------------------------------------- gathering
// gidx entries pack (piece << 48) | row, in DESTINATION order: the shuffle
// window's permutation is applied here, fused with the encode, instead of
// a separate landing pass over every column.
constexpr int64_t kRowMask = (int64_t(1) << 48) - 1;

template <typename T>
void gather_into(T* dst, const void* const* srcs, int npieces,
                 const int64_t* gidx, int64_t n) {
  if (npieces == 1) {
    const T* s = static_cast<const T*>(srcs[0]);
    for (int64_t i = 0; i < n; i++) dst[i] = s[gidx[i] & kRowMask];
  } else {
    for (int64_t i = 0; i < n; i++) {
      int64_t g = gidx[i];
      dst[i] = static_cast<const T*>(srcs[g >> 48])[g & kRowMask];
    }
  }
}

template <typename T>
const T* gather(Writer* w, const void* const* srcs, int npieces,
                const int64_t* gidx, int64_t n) {
  if (gidx == nullptr && npieces == 1) return static_cast<const T*>(srcs[0]);
  w->scratch.resize(static_cast<size_t>(n) * sizeof(T));
  T* dst = reinterpret_cast<T*>(w->scratch.data());
  gather_into(dst, srcs, npieces, gidx, n);
  return dst;
}

// PLAIN: gather straight into the page body, one pass.
template <typename T>
void plain_gathered(std::vector<uint8_t>* out, const void* const* srcs,
                    int npieces, const int64_t* gidx, int64_t n) {
  out->resize(static_cast<size_t>(n) * sizeof(T));
  T* dst = reinterpret_cast<T*>(out->data());
  if (gidx == nullptr && npieces == 1)
    std::memcpy(dst, srcs[0], static_cast<size_t>(n) * sizeof(T));
  else
    gather_into(dst, srcs, npieces, gidx, n);
}

// ------------------------------------------------------- DELTA_BINARY_PACKED
// Spec: parquet-format Encodings.md. Block = 128 values, 4 miniblocks of 32.
// Deltas use two's-complement wraparound arithmetic; decode reverses it.
constexpr int kBlock = 128;
constexpr int kMiniblocks = 4;
constexpr int kMini = kBlock / kMiniblocks;  // 32

inline void put_uleb(std::vector<uint8_t>* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out->push_back(static_cast<uint8_t>(v));
}
inline void put_zz(std::vector<uint8_t>* out, int64_t v) {
  put_uleb(out, (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63));
}

inline int bit_width(uint64_t v) {
  return v == 0 ? 0 : 64 - __builtin_clzll(v);
}

// Pack `count` values of `width` bits each, LSB-first little-endian.
inline void bitpack(std::vector<uint8_t>* out, const uint64_t* vals, int count,
                    int width) {
  if (width == 0) return;
  size_t bytes = (static_cast<size_t>(count) * width + 7) / 8;
  size_t base = out->size();
  out->resize(base + bytes, 0);
  uint8_t* dst = out->data() + base;
  if (width <= 32) {
    // 64-bit accumulate + whole-word stores, exact tail
    uint64_t acc = 0;
    int nbits = 0;
    for (int i = 0; i < count; i++) {
      acc |= vals[i] << nbits;
      nbits += width;
      if (nbits >= 64) {
        std::memcpy(dst, &acc, 8);
        dst += 8;
        nbits -= 64;
        acc = nbits ? vals[i] >> (width - nbits) : 0;
      }
    }
    if (nbits > 0) std::memcpy(dst, &acc, (nbits + 7) / 8);
  } else if (width <= 56) {
    uint64_t acc = 0;
    int nbits = 0;
    for (int i = 0; i < count; i++) {
      acc |= vals[i] << nbits;
      nbits += width;
      while (nbits >= 8) {
        *dst++ = static_cast<uint8_t>(acc);
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits > 0) *dst = static_cast<uint8_t>(acc);
  } else {
    unsigned __int128 acc = 0;
    int nbits = 0;
    for (int i = 0; i < count; i++) {
      acc |= static_cast<unsigned __int128>(vals[i]) << nbits;
      nbits += width;
      while (nbits >= 8) {
        *dst++ = static_cast<uint8_t>(acc);
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits > 0) *dst = static_cast<uint8_t>(acc);
  }
}

// Src is a raw `const T*` (sequential reads) or a GatherSrc (the shuffle
// window's fused random gather, block-buffered so no value is loaded twice).
template <typename T, typename Src>
void delta_pack_src(std::vector<uint8_t>* out, Src v, int64_t n) {
  using UT = typename std::make_unsigned<T>::type;
  using ST = typename std::make_signed<T>::type;
  put_uleb(out, kBlock);
  put_uleb(out, kMiniblocks);
  put_uleb(out, static_cast<uint64_t>(n));
  if (n == 0) {
    put_zz(out, 0);
    return;
  }
  T prev = v[0];
  put_zz(out, static_cast<int64_t>(prev));
  int64_t ndeltas = n - 1;
  int64_t pos = 0;
  uint64_t deltas[kBlock];
  T cur[kBlock];
  while (pos < ndeltas) {
    int count = static_cast<int>(ndeltas - pos < kBlock ? ndeltas - pos : kBlock);
    v.load_block(cur, pos + 1, count);
    // deltas wrap within the COLUMN's width so adjusted deltas fit
    // bit_width(T): readers reject an int32 page with 33-bit deltas
    ST mind = std::numeric_limits<ST>::max();
    UT udeltas[kBlock];
    for (int i = 0; i < count; i++) {
      UT du = static_cast<UT>(cur[i]) - static_cast<UT>(i ? cur[i - 1] : prev);
      udeltas[i] = du;
      ST d = static_cast<ST>(du);
      if (d < mind) mind = d;
    }
    prev = cur[count - 1];
    put_zz(out, static_cast<int64_t>(mind));
    for (int i = 0; i < count; i++)
      deltas[i] = static_cast<uint64_t>(
          static_cast<UT>(udeltas[i] - static_cast<UT>(mind)));
    // pad the trailing partial miniblock with adjusted-zero deltas
    for (int i = count; i < ((count + kMini - 1) / kMini) * kMini; i++)
      deltas[i] = 0;
    int used_minis = (count + kMini - 1) / kMini;
    uint8_t widths[kMiniblocks] = {0, 0, 0, 0};
    for (int m = 0; m < used_minis; m++) {
      uint64_t mx = 0;
      for (int i = m * kMini; i < (m + 1) * kMini; i++)
        if (deltas[i] > mx) mx = deltas[i];
      widths[m] = static_cast<uint8_t>(bit_width(mx));
    }
    // all miniblock widths are always listed, even for a partial block
    for (int m = 0; m < kMiniblocks; m++) out->push_back(widths[m]);
    for (int m = 0; m < used_minis; m++)
      bitpack(out, deltas + m * kMini, kMini, widths[m]);
    pos += count;
  }
}

template <typename T>
struct RawSrc {
  const T* p;
  inline T operator[](int64_t i) const { return p[i]; }
  inline void load_block(T* dst, int64_t start, int count) const {
    std::memcpy(dst, p + start, static_cast<size_t>(count) * sizeof(T));
  }
};

template <typename T>
struct GatherSrc {
  const void* const* srcs;
  int npieces;
  const int64_t* gidx;
  inline T operator[](int64_t i) const {
    int64_t g = gidx[i];
    const void* s = npieces == 1 ? srcs[0] : srcs[g >> 48];
    return static_cast<const T*>(s)[g & kRowMask];
  }
  inline void load_block(T* dst, int64_t start, int count) const {
    gather_into(dst, srcs, npieces, gidx + start, count);
  }
};

template <typename T>
void delta_pack_gathered(std::vector<uint8_t>* out, const void* const* srcs,
                         int npieces, const int64_t* gidx, int64_t n) {
  if (gidx == nullptr && npieces == 1)
    delta_pack_src<T, RawSrc<T>>(out, RawSrc<T>{static_cast<const T*>(srcs[0])},
                                 n);
  else
    delta_pack_src<T, GatherSrc<T>>(out, GatherSrc<T>{srcs, npieces, gidx}, n);
}

// ------------------------------------------------------ BYTE_STREAM_SPLIT
template <int W>
void byte_stream_split(std::vector<uint8_t>* out, const uint8_t* v, int64_t n) {
  size_t base = out->size();
  out->resize(base + static_cast<size_t>(n) * W);
  uint8_t* dst = out->data() + base;
  for (int b = 0; b < W; b++) {
    uint8_t* d = dst + static_cast<size_t>(b) * n;
    const uint8_t* s = v + b;
    for (int64_t i = 0; i < n; i++) d[i] = s[static_cast<size_t>(i) * W];
  }
}

// ------------------------------------------------------------- shuffle split
// splitmix64 finalizer — shared with io/native_parquet.py's numpy twin
// (hash_split); the two MUST stay bit-identical.
inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

int write_column_impl(Writer* w, const void* const* srcs, int npieces,
                      const int64_t* gi, long long n, int dtype, int encoding,
                      int codec, int level, long long* out_meta) {
  w->enc.clear();
  switch (encoding) {
    case kEncDelta:
      if (dtype == 0)
        delta_pack_gathered<int32_t>(&w->enc, srcs, npieces, gi, n);
      else if (dtype == 1)
        delta_pack_gathered<int64_t>(&w->enc, srcs, npieces, gi, n);
      else
        return kErrEncoding;
      break;
    case kEncByteStreamSplit:
      if (dtype == 0 || dtype == 2)
        byte_stream_split<4>(&w->enc,
                             reinterpret_cast<const uint8_t*>(
                                 gather<int32_t>(w, srcs, npieces, gi, n)),
                             n);
      else
        byte_stream_split<8>(&w->enc,
                             reinterpret_cast<const uint8_t*>(
                                 gather<int64_t>(w, srcs, npieces, gi, n)),
                             n);
      break;
    case kEncPlain:
      if (dtype == 0 || dtype == 2)
        plain_gathered<int32_t>(&w->enc, srcs, npieces, gi, n);
      else
        plain_gathered<int64_t>(&w->enc, srcs, npieces, gi, n);
      break;
    default:
      return kErrEncoding;
  }

  int64_t uncomp = static_cast<int64_t>(w->enc.size());
  const uint8_t* body = w->enc.data();
  int64_t body_len = uncomp;
  if (codec == kCodecZstd) {
#if NVTPQ_HAVE_ZSTD
    size_t bound = ZSTD_compressBound(w->enc.size());
    w->comp.resize(bound);
    size_t got = ZSTD_compress(w->comp.data(), bound, w->enc.data(),
                               w->enc.size(), level);
    if (ZSTD_isError(got)) return kErrCodec;
    body = w->comp.data();
    body_len = static_cast<int64_t>(got);
#else
    (void)level;
    return kErrNoZstd;
#endif
  } else if (codec != kCodecUncompressed) {
    return kErrCodec;
  }

  ThriftBuf t;
  write_page_header(&t, uncomp, body_len, n, encoding);

  int64_t page_offset = w->offset;
  if (std::fwrite(t.buf.data(), 1, t.buf.size(), w->f) != t.buf.size())
    return kErrIo;
  if (body_len > 0 &&
      std::fwrite(body, 1, static_cast<size_t>(body_len), w->f) !=
          static_cast<size_t>(body_len))
    return kErrIo;
  w->offset += static_cast<int64_t>(t.buf.size()) + body_len;

  out_meta[0] = page_offset;
  out_meta[1] = static_cast<int64_t>(t.buf.size()) + body_len;
  out_meta[2] = static_cast<int64_t>(t.buf.size()) + uncomp;
  out_meta[3] = static_cast<int64_t>(t.buf.size());
  return 0;
}

// ------------------------------------------------------------------ reader
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool bad = false;
  // next `width` (<= 64) bits, LSB first
  uint64_t take(int width) {
    if (width == 0) return 0;
    unsigned __int128 v = acc;
    int have = nbits;
    while (have < width) {
      if (p >= end) {
        bad = true;
        return 0;
      }
      v |= static_cast<unsigned __int128>(*p++) << have;
      have += 8;
    }
    uint64_t out = width == 64 ? static_cast<uint64_t>(v)
                               : static_cast<uint64_t>(v) & ((uint64_t(1) << width) - 1);
    v >>= width;
    acc = static_cast<uint64_t>(v);
    nbits = have - width;
    return out;
  }
};

bool read_uleb(const uint8_t** p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  for (int shift = 0; shift < 64; shift += 7) {
    if (*p >= end) return false;
    uint8_t b = *(*p)++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
  }
  return false;
}

// DELTA_BINARY_PACKED → n values of T; advances *pp past the consumed bytes.
template <typename T>
int delta_decode(const uint8_t** pp, const uint8_t* end, int64_t n, T* out) {
  using UT = typename std::make_unsigned<T>::type;
  const uint8_t* p = *pp;
  uint64_t block, minis, total, first;
  if (!read_uleb(&p, end, &block) || !read_uleb(&p, end, &minis) ||
      !read_uleb(&p, end, &total) || !read_uleb(&p, end, &first))
    return kErrCorrupt;
  if (block == 0 || minis == 0 || block % minis || (block / minis) % 8 ||
      static_cast<int64_t>(total) < n)
    return kErrCorrupt;
  const uint64_t per_mini = block / minis;
  if (n == 0) {
    *pp = p;
    return 0;
  }
  UT prev = static_cast<UT>(static_cast<int64_t>(first >> 1) ^ -static_cast<int64_t>(first & 1));
  out[0] = static_cast<T>(prev);
  int64_t got = 1;
  std::vector<uint8_t> widths(minis);
  while (got < static_cast<int64_t>(total)) {
    uint64_t zmin;
    if (!read_uleb(&p, end, &zmin)) return kErrCorrupt;
    UT mind = static_cast<UT>(static_cast<int64_t>(zmin >> 1) ^ -static_cast<int64_t>(zmin & 1));
    if (static_cast<uint64_t>(end - p) < minis) return kErrCorrupt;
    std::memcpy(widths.data(), p, minis);
    p += minis;
    for (uint64_t m = 0; m < minis && got < static_cast<int64_t>(total); m++) {
      int w = widths[m];
      if (w > 64) return kErrCorrupt;
      uint64_t bytes = per_mini * w / 8;
      if (static_cast<uint64_t>(end - p) < bytes) return kErrCorrupt;
      Bits bits{p, p + bytes};
      for (uint64_t i = 0; i < per_mini && got < static_cast<int64_t>(total); i++) {
        prev = static_cast<UT>(prev + mind + static_cast<UT>(bits.take(w)));
        if (got < n) out[got] = static_cast<T>(prev);
        got++;
      }
      p += bytes;
    }
  }
  *pp = p;
  return 0;
}

// RLE/bit-packed hybrid definition levels of bit width 1: every one of the
// n levels must be 1 (no nulls).
int check_def_levels(const uint8_t* p, const uint8_t* end, int64_t n) {
  int64_t seen = 0;
  while (seen < n) {
    uint64_t h;
    if (!read_uleb(&p, end, &h)) return kErrCorrupt;
    if (h & 1) {  // bit-packed groups of 8
      uint64_t groups = h >> 1;
      uint64_t count = groups * 8;
      if (static_cast<uint64_t>(end - p) < groups) return kErrCorrupt;
      for (uint64_t i = 0; i < count && seen < n; i++, seen++)
        if (!((p[i >> 3] >> (i & 7)) & 1)) return kErrNull;
      p += groups;
    } else {  // a run of one value, in one byte at bit width 1
      uint64_t run = h >> 1;
      if (p >= end) return kErrCorrupt;
      uint8_t v = *p++;
      if (run && (v & 1) == 0) return kErrNull;
      seen += static_cast<int64_t>(run);
    }
  }
  return 0;
}

int decode_values(const uint8_t* p, const uint8_t* end, int64_t n, int dtype,
                  int encoding, uint8_t* out) {
  const int w = (dtype == 0 || dtype == 2) ? 4 : 8;
  const size_t bytes = static_cast<size_t>(n) * w;
  switch (encoding) {
    case kEncPlain:
      if (static_cast<size_t>(end - p) < bytes) return kErrCorrupt;
      std::memcpy(out, p, bytes);
      return 0;
    case kEncByteStreamSplit:
      if (static_cast<size_t>(end - p) < bytes) return kErrCorrupt;
      for (int b = 0; b < w; b++) {
        const uint8_t* s = p + static_cast<size_t>(b) * n;
        for (int64_t i = 0; i < n; i++) out[static_cast<size_t>(i) * w + b] = s[i];
      }
      return 0;
    case kEncDelta:
      if (dtype == 0) return delta_decode<int32_t>(&p, end, n, reinterpret_cast<int32_t*>(out));
      if (dtype == 1) return delta_decode<int64_t>(&p, end, n, reinterpret_cast<int64_t*>(out));
      return kErrEncoding;
    default:
      return kErrEncoding;
  }
}

bool read_exact(int fd, int64_t offset, uint8_t* dst, int64_t size) {
  while (size > 0) {
    ssize_t got = pread(fd, dst, static_cast<size_t>(size), static_cast<off_t>(offset));
    if (got <= 0) return false;
    dst += got;
    offset += got;
    size -= got;
  }
  return true;
}

}  // namespace

extern "C" {

long long nvtpq_has_zstd() { return NVTPQ_HAVE_ZSTD; }

// This file's destination-order gather index for a shuffle window of WHOLE
// pieces: row r of piece p belongs to file ((((r * PHI64) ^ seed) >> 32) *
// nfiles) >> 32 (a Fibonacci multiply-shift with a 32x32 range map), and the
// selected rows are Fisher-Yates shuffled with shuffle_seed (mix64-chained).
// Returns the selected row count; gidx must hold sum(piece_rows) entries.
// MUST stay bit-identical to native_parquet.hash_split.
long long nvtpq_build_window_index(const long long* piece_rows,
                                   const unsigned long long* piece_seeds,
                                   int npieces, int nfiles, int file_k,
                                   unsigned long long shuffle_seed,
                                   long long* gidx) {
  constexpr uint64_t kPhi = 0x9E3779B97F4A7C15ULL;
  long long cnt = 0;
  for (int p = 0; p < npieces; p++) {
    const uint64_t seed = piece_seeds[p];
    const int64_t n = piece_rows[p];
    const int64_t base = static_cast<int64_t>(p) << 48;
    if (nfiles <= 1) {
      for (int64_t r = 0; r < n; r++) gidx[cnt++] = base | r;
    } else {
      const uint64_t nf = static_cast<uint64_t>(nfiles);
      for (int64_t r = 0; r < n; r++) {
        const uint64_t h = (static_cast<uint64_t>(r) * kPhi) ^ seed;
        if ((((h >> 32) * nf) >> 32) == static_cast<uint64_t>(file_k))
          gidx[cnt++] = base | r;
      }
    }
  }
  uint64_t s = shuffle_seed;
  for (long long i = cnt - 1; i > 0; i--) {
    s = mix64(s);
    const long long j = static_cast<long long>(s % static_cast<uint64_t>(i + 1));
    const int64_t tmp = gidx[i];
    gidx[i] = gidx[j];
    gidx[j] = tmp;
  }
  return cnt;
}

void* nvtpq_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  if (std::fwrite("PAR1", 1, 4, f) != 4) {
    std::fclose(f);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  w->offset = 4;
  return w;
}

// dtype: 0=int32 1=int64 2=float32 3=float64
// out_meta: [page_offset, total_compressed_size, total_uncompressed_size,
//            header_bytes]
int nvtpq_write_column(void* h, const void* const* srcs, int npieces,
                       const long long* gidx, long long n, int dtype,
                       int encoding, int codec, int level,
                       long long* out_meta) {
  return write_column_impl(static_cast<Writer*>(h), srcs, npieces,
                           reinterpret_cast<const int64_t*>(gidx), n, dtype,
                           encoding, codec, level, out_meta);
}

int nvtpq_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  int rc = std::fclose(w->f) == 0 ? 0 : 1;
  delete w;
  return rc;
}

// Decode the column chunk at [offset, offset + size) of `path` into `out`
// (num_values values of dtype 0=int32 1=int64 2=float32 3=float64).
// max_def is 0 for a REQUIRED column and 1 for an OPTIONAL one; codec is the
// chunk's codec from the footer.
int nvtpq_read_chunk(const char* path, long long offset, long long size,
                     long long num_values, int dtype, int max_def, int codec,
                     void* out) {
  if (codec != kCodecUncompressed && codec != kCodecZstd) return kErrCodec;
#if !NVTPQ_HAVE_ZSTD
  if (codec == kCodecZstd) return kErrNoZstd;
#endif
  if (max_def < 0 || max_def > 1 || size < 0) return kErrCorrupt;
  std::vector<uint8_t> chunk(static_cast<size_t>(size));
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return kErrIo;
  bool ok = read_exact(fd, offset, chunk.data(), size);
  ::close(fd);
  if (!ok) return kErrIo;

  const int w = (dtype == 0 || dtype == 2) ? 4 : 8;
  uint8_t* dst = static_cast<uint8_t*>(out);
  std::vector<uint8_t> plain;
  const uint8_t* p = chunk.data();
  const uint8_t* end = p + size;
  int64_t done = 0;
  while (done < num_values) {
    ThriftIn t{p, end};
    PageHeader h;
    if (!read_page_header(&t, &h)) return kErrCorrupt;
    p = t.p;
    if (h.comp > end - p) return kErrCorrupt;
    if (h.type == kPageDictionary) return kErrDictionary;
    if (h.type == kPageDataV2) return kErrPageV2;
    if (h.type != kPageData) return kErrPageType;
    if (h.num_values < 0 || h.num_values > num_values - done) return kErrCorrupt;
    const uint8_t* body = p;
    const uint8_t* body_end = p + h.comp;
    if (codec == kCodecZstd) {
#if NVTPQ_HAVE_ZSTD
      plain.resize(static_cast<size_t>(h.uncomp));
      size_t got = ZSTD_decompress(plain.data(), plain.size(), p, static_cast<size_t>(h.comp));
      if (ZSTD_isError(got) || got != plain.size()) return kErrCorrupt;
      body = plain.data();
      body_end = body + got;
#endif
    }
    if (max_def == 1) {  // 4-byte length, then the levels
      if (body_end - body < 4) return kErrCorrupt;
      uint32_t len;
      std::memcpy(&len, body, 4);
      body += 4;
      if (len > static_cast<uint64_t>(body_end - body)) return kErrCorrupt;
      int rc = check_def_levels(body, body + len, h.num_values);
      if (rc) return rc;
      body += len;
    }
    int rc = decode_values(body, body_end, h.num_values, dtype, h.encoding,
                           dst + static_cast<size_t>(done) * w);
    if (rc) return rc;
    done += h.num_values;
    p += h.comp;
  }
  return 0;
}

}  // extern "C"
