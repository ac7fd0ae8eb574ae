// Native shuffle-wire serializer: the kudo-analog pack/unpack core (the
// JAX package's native/kudo.cpp, the same C interface and frame layout).
//
// Reference parity: spark-rapids-jni's KudoSerializer (imported by
// GpuColumnarBatchSerializer.scala:30,136) — a low-overhead header+buffer
// wire layout for columnar batches. The Python layer
// (shuffle/serde.py) describes a batch as N host buffers
// (planes) plus a metadata blob; this native core assembles/parses the
// framed payload in one pass and provides an xxhash64 integrity checksum.
//
// Layout of a packed frame:
//   [u64 magic][u32 version][u32 n_bufs]
//   [u64 meta_len][meta bytes]
//   n_bufs * [u64 buf_len]
//   concatenated buffer bytes (8-byte aligned each)
//   [u64 xxhash64 of everything before the hash]
//
// Host code: built at first use with g++ into build/torch_kernels/
// (ops/_build.load_host) and loaded with ctypes. shuffle/serde.py keeps a
// pure-Python packer with the identical layout as its plain version, held
// byte for byte against this one by the tests; the format, not the
// implementation, is the contract.

#include <cstdint>
#include <cstring>

extern "C" {

static const uint64_t KUDO_MAGIC = 0x54505544554B4F31ULL;  // "TPUDUKO1"
static const uint32_t KUDO_VERSION = 1;

// ---- xxhash64 (public algorithm, from the spec) -------------------------
static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = round1(0, val);
  acc ^= val;
  return acc * P1 + P4;
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t kudo_xxhash64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p)); p += 8;
      v2 = round1(v2, read64(p)); p += 8;
      v3 = round1(v3, read64(p)); p += 8;
      v4 = round1(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

static inline uint64_t align8(uint64_t x) { return (x + 7) & ~7ULL; }

// Total frame size for the given buffer lengths.
uint64_t kudo_frame_size(uint64_t meta_len, uint32_t n_bufs,
                         const uint64_t* buf_lens) {
  uint64_t sz = 8 + 4 + 4;          // magic, version, n_bufs
  sz += 8 + align8(meta_len);       // meta
  sz += 8ULL * n_bufs;              // buffer length table
  for (uint32_t i = 0; i < n_bufs; i++) sz += align8(buf_lens[i]);
  sz += 8;                          // trailing hash
  return sz;
}

// Pack meta + buffers into out (caller sized it with kudo_frame_size).
// Returns bytes written.
uint64_t kudo_pack(const uint8_t* meta, uint64_t meta_len, uint32_t n_bufs,
                   const uint8_t** bufs, const uint64_t* buf_lens,
                   uint8_t* out) {
  uint8_t* p = out;
  std::memcpy(p, &KUDO_MAGIC, 8); p += 8;
  std::memcpy(p, &KUDO_VERSION, 4); p += 4;
  std::memcpy(p, &n_bufs, 4); p += 4;
  std::memcpy(p, &meta_len, 8); p += 8;
  std::memcpy(p, meta, meta_len);
  if (align8(meta_len) > meta_len)
    std::memset(p + meta_len, 0, align8(meta_len) - meta_len);
  p += align8(meta_len);
  for (uint32_t i = 0; i < n_bufs; i++) {
    std::memcpy(p, &buf_lens[i], 8); p += 8;
  }
  for (uint32_t i = 0; i < n_bufs; i++) {
    std::memcpy(p, bufs[i], buf_lens[i]);
    if (align8(buf_lens[i]) > buf_lens[i])
      std::memset(p + buf_lens[i], 0, align8(buf_lens[i]) - buf_lens[i]);
    p += align8(buf_lens[i]);
  }
  uint64_t h = kudo_xxhash64(out, (uint64_t)(p - out), 0);
  std::memcpy(p, &h, 8); p += 8;
  return (uint64_t)(p - out);
}

// Parse a frame header. Fills meta_off/meta_len, n_bufs, and for each
// buffer its offset+length into offs/lens (caller allocates max_bufs).
// Returns 0 on success, negative error code otherwise (-1 bad magic,
// -2 bad version, -3 truncated, -4 too many bufs, -5 checksum mismatch).
int64_t kudo_unpack(const uint8_t* data, uint64_t len, uint64_t* meta_off,
                    uint64_t* meta_len, uint32_t* n_bufs, uint64_t* offs,
                    uint64_t* lens, uint32_t max_bufs, int32_t verify) {
  if (len < 24 + 8) return -3;
  uint64_t magic = read64(data);
  if (magic != KUDO_MAGIC) return -1;
  if (read32(data + 8) != KUDO_VERSION) return -2;
  uint32_t nb = read32(data + 12);
  if (nb > max_bufs) return -4;
  uint64_t ml = read64(data + 16);
  uint64_t pos = 24;
  // overflow-safe: every field is checked against the REMAINING length
  // before pos advances, so a corrupt u64 can't wrap the arithmetic
  if (ml > len - pos || align8(ml) > len - pos) return -3;
  *meta_off = pos;
  *meta_len = ml;
  pos += align8(ml);
  if (8ULL * nb + 8 > len - pos) return -3;
  for (uint32_t i = 0; i < nb; i++) {
    lens[i] = read64(data + pos);
    pos += 8;
  }
  for (uint32_t i = 0; i < nb; i++) {
    offs[i] = pos;
    uint64_t a = align8(lens[i]);
    if (a < lens[i] || a > len - pos || len - pos - a < 8) return -3;
    pos += a;
  }
  if (verify) {
    uint64_t want = read64(data + pos);
    uint64_t got = kudo_xxhash64(data, pos, 0);
    if (want != got) return -5;
  }
  *n_bufs = nb;
  return (int64_t)(pos + 8);
}

}  // extern "C"
