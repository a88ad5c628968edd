// Host hot loops of the serving path: XXH3-64 block hashing and the KV
// router's prefix index, behind a plain C interface loaded with ctypes
// (dynamo_tpu_torch/native/__init__.py). Built by the host compiler, not
// nvcc: nothing here runs on the card.
//
// - dyn_xxh3_64(data, len, seed) is XXH3_64bits_withSeed, every length
//   class (0, 1-3, 4-8, 9-16, 17-128, 129-240 bytes and the striped long
//   path), transcribed from the package's pure-Python utils/xxh3.py, which
//   is itself a translation of xxHash's xxhash.h (version 0.8.3, BSD
//   2-Clause, Copyright (C) 2012-2023 Yann Collet; the notice is in
//   utils/xxh3.py). Only the C++ standard library is included.
// - dyn_block_hashes(tokens, n, block_size, seed, block_out, seq_out) hashes
//   every complete block of u32 tokens (little-endian bytes):
//     block_hash[i] = XXH3_64(token bytes of block i, seed)
//     seq_hash[0]   = block_hash[0]
//     seq_hash[i]   = XXH3_64(le_u64(seq_hash[i-1]) || token bytes, seed)
//   and returns the number of blocks (tokens.py's chain).
// - dyn_index_*: a map from chained sequence hash to the workers holding
//   that block, with a per-worker reference count so that a duplicate
//   "stored" event needs two "removed" events. Because the hashes chain
//   over the whole prefix, longest-prefix matching is a flat walk: a worker
//   can match block i + 1 only if it matched block i.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kPrime32_1 = 0x9E3779B1ULL;
constexpr uint64_t kPrime32_2 = 0x85EBCA77ULL;
constexpr uint64_t kPrime32_3 = 0xC2B2AE3DULL;
constexpr uint64_t kPrime64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kPrime64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kPrime64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kPrime64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kPrime64_5 = 0x27D4EB2F165667C5ULL;
constexpr uint64_t kPrimeMx1 = 0x165667919E3779F9ULL;
constexpr uint64_t kPrimeMx2 = 0x9FB21C651E98DF25ULL;

constexpr size_t kSecretSize = 192;
constexpr size_t kSecretSizeMin = 136;
constexpr size_t kMidsizeMax = 240;
constexpr size_t kStripeLen = 64;
constexpr size_t kSecretConsumeRate = 8;
constexpr size_t kSecretLastAccStart = 7;
constexpr size_t kSecretMergeAccsStart = 11;
constexpr size_t kMidsizeStartOffset = 3;
constexpr size_t kMidsizeLastOffset = 17;

// XXH3_kSecret: 192 pseudorandom bytes taken from FARSH
alignas(64) const uint8_t kSecret[kSecretSize] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,
    0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,
    0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,
    0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,
    0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,
    0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,
    0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,
    0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,
    0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,
    0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,
    0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,
    0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,
    0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

// Little-endian loads: the byte order of the hash is fixed whatever the
// host's (every host this runs on is little-endian; the shifts keep it
// right elsewhere and compile to one load here).
inline uint32_t read32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

inline uint64_t read64(const uint8_t* p) {
  return static_cast<uint64_t>(read32(p)) |
         static_cast<uint64_t>(read32(p + 4)) << 32;
}

inline void write64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = static_cast<uint8_t>(v >> (8 * i));
}

inline uint64_t swap32(uint64_t x) {
  const uint32_t v = static_cast<uint32_t>(x);
  return ((v << 24) & 0xff000000U) | ((v << 8) & 0x00ff0000U) |
         ((v >> 8) & 0x0000ff00U) | ((v >> 24) & 0x000000ffU);
}

inline uint64_t swap64(uint64_t x) {
  return (swap32(x) << 32) | swap32(x >> 32);
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  const __uint128_t p = static_cast<__uint128_t>(a) * b;
  return static_cast<uint64_t>(p) ^ static_cast<uint64_t>(p >> 64);
}

inline uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= kPrime64_2;
  h ^= h >> 29;
  h *= kPrime64_3;
  return h ^ (h >> 32);
}

inline uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= kPrimeMx1;
  return h ^ (h >> 32);
}

inline uint64_t rrmxmx(uint64_t h, uint64_t len) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kPrimeMx2;
  h ^= (h >> 35) + len;
  h *= kPrimeMx2;
  return h ^ (h >> 28);
}

inline uint64_t mix16(const uint8_t* in, const uint8_t* sec, uint64_t seed) {
  return mul128_fold64(read64(in) ^ (read64(sec) + seed),
                       read64(in + 8) ^ (read64(sec + 8) - seed));
}

uint64_t len_0to16(const uint8_t* in, size_t n, uint64_t seed) {
  if (n > 8) {
    const uint64_t lo =
        read64(in) ^ ((read64(kSecret + 24) ^ read64(kSecret + 32)) + seed);
    const uint64_t hi = read64(in + n - 8) ^
                        ((read64(kSecret + 40) ^ read64(kSecret + 48)) - seed);
    return avalanche(n + swap64(lo) + hi + mul128_fold64(lo, hi));
  }
  if (n >= 4) {
    seed ^= swap32(seed) << 32;
    const uint64_t in1 = read32(in);
    const uint64_t in2 = read32(in + n - 4);
    const uint64_t bitflip =
        (read64(kSecret + 8) ^ read64(kSecret + 16)) - seed;
    return rrmxmx((in2 + (in1 << 32)) ^ bitflip, n);
  }
  if (n > 0) {
    const uint32_t combined = (static_cast<uint32_t>(in[0]) << 16) |
                              (static_cast<uint32_t>(in[n >> 1]) << 24) |
                              static_cast<uint32_t>(in[n - 1]) |
                              static_cast<uint32_t>(n << 8);
    const uint64_t bitflip =
        static_cast<uint64_t>(read32(kSecret) ^ read32(kSecret + 4)) + seed;
    return xxh64_avalanche(static_cast<uint64_t>(combined) ^ bitflip);
  }
  return xxh64_avalanche(seed ^ read64(kSecret + 56) ^ read64(kSecret + 64));
}

uint64_t len_17to128(const uint8_t* in, size_t n, uint64_t seed) {
  uint64_t acc = n * kPrime64_1;
  if (n > 32) {
    if (n > 64) {
      if (n > 96) {
        acc += mix16(in + 48, kSecret + 96, seed);
        acc += mix16(in + n - 64, kSecret + 112, seed);
      }
      acc += mix16(in + 32, kSecret + 64, seed);
      acc += mix16(in + n - 48, kSecret + 80, seed);
    }
    acc += mix16(in + 16, kSecret + 32, seed);
    acc += mix16(in + n - 32, kSecret + 48, seed);
  }
  acc += mix16(in, kSecret, seed);
  acc += mix16(in + n - 16, kSecret + 16, seed);
  return avalanche(acc);
}

uint64_t len_129to240(const uint8_t* in, size_t n, uint64_t seed) {
  uint64_t acc = n * kPrime64_1;
  for (size_t i = 0; i < 8; ++i) {
    acc += mix16(in + 16 * i, kSecret + 16 * i, seed);
  }
  uint64_t acc_end =
      mix16(in + n - 16, kSecret + kSecretSizeMin - kMidsizeLastOffset, seed);
  acc = avalanche(acc);
  const size_t rounds = n / 16;
  for (size_t i = 8; i < rounds; ++i) {
    acc_end += mix16(in + 16 * i, kSecret + 16 * (i - 8) + kMidsizeStartOffset,
                     seed);
  }
  return avalanche(acc + acc_end);
}

inline void accumulate_512(uint64_t* acc, const uint8_t* in,
                           const uint8_t* sec) {
  for (size_t lane = 0; lane < 8; ++lane) {
    const uint64_t v = read64(in + 8 * lane);
    const uint64_t key = v ^ read64(sec + 8 * lane);
    acc[lane ^ 1] += v;
    acc[lane] += (key & 0xffffffffULL) * (key >> 32);
  }
}

inline void scramble(uint64_t* acc, const uint8_t* sec) {
  for (size_t lane = 0; lane < 8; ++lane) {
    uint64_t a = acc[lane];
    a ^= a >> 47;
    a ^= read64(sec + 8 * lane);
    acc[lane] = a * kPrime32_1;
  }
}

uint64_t hash_long(const uint8_t* in, size_t n, uint64_t seed) {
  // XXH3_initCustomSecret: the seed added to the even u64 words of the
  // default secret and taken from the odd ones (seed 0 keeps it as it is)
  alignas(64) uint8_t custom[kSecretSize];
  const uint8_t* sec = kSecret;
  if (seed != 0) {
    for (size_t i = 0; i < kSecretSize / 16; ++i) {
      write64(custom + 16 * i, read64(kSecret + 16 * i) + seed);
      write64(custom + 16 * i + 8, read64(kSecret + 16 * i + 8) - seed);
    }
    sec = custom;
  }
  uint64_t acc[8] = {kPrime32_3, kPrime64_1, kPrime64_2, kPrime64_3,
                     kPrime64_4, kPrime32_2, kPrime64_5, kPrime32_1};
  const size_t stripes_per_block =
      (kSecretSize - kStripeLen) / kSecretConsumeRate;
  const size_t block_len = kStripeLen * stripes_per_block;
  const size_t n_blocks = (n - 1) / block_len;
  for (size_t b = 0; b < n_blocks; ++b) {
    for (size_t s = 0; s < stripes_per_block; ++s) {
      accumulate_512(acc, in + b * block_len + s * kStripeLen,
                     sec + s * kSecretConsumeRate);
    }
    scramble(acc, sec + kSecretSize - kStripeLen);
  }
  // the last partial block, then the last stripe
  const size_t n_stripes = ((n - 1) - block_len * n_blocks) / kStripeLen;
  for (size_t s = 0; s < n_stripes; ++s) {
    accumulate_512(acc, in + n_blocks * block_len + s * kStripeLen,
                   sec + s * kSecretConsumeRate);
  }
  accumulate_512(acc, in + n - kStripeLen,
                 sec + kSecretSize - kStripeLen - kSecretLastAccStart);
  uint64_t result = n * kPrime64_1;
  for (size_t i = 0; i < 4; ++i) {
    const uint8_t* s = sec + kSecretMergeAccsStart + 16 * i;
    result += mul128_fold64(acc[2 * i] ^ read64(s),
                            acc[2 * i + 1] ^ read64(s + 8));
  }
  return avalanche(result);
}

uint64_t xxh3_64(const uint8_t* in, size_t n, uint64_t seed) {
  if (n <= 16) return len_0to16(in, n, seed);
  if (n <= 128) return len_17to128(in, n, seed);
  if (n <= kMidsizeMax) return len_129to240(in, n, seed);
  return hash_long(in, n, seed);
}

struct PrefixIndex {
  // seq_hash -> workers (small vectors: a block is usually on few workers)
  std::unordered_map<uint64_t, std::vector<uint64_t>> blocks;
  // worker -> reference count per hash (duplicate stored events)
  std::unordered_map<uint64_t, std::unordered_map<uint64_t, int64_t>> owned;
};

void index_remove_one(PrefixIndex* ix, uint64_t worker, uint64_t h) {
  auto it = ix->blocks.find(h);
  if (it == ix->blocks.end()) return;
  auto& v = it->second;
  for (size_t i = 0; i < v.size(); ++i) {
    if (v[i] == worker) {
      v[i] = v.back();
      v.pop_back();
      break;
    }
  }
  if (v.empty()) ix->blocks.erase(it);
}

}  // namespace

extern "C" {

uint64_t dyn_xxh3_64(const uint8_t* data, int64_t len, uint64_t seed) {
  return xxh3_64(data, static_cast<size_t>(len), seed);
}

int64_t dyn_block_hashes(const uint32_t* tokens, int64_t n_tokens,
                         int64_t block_size, uint64_t seed,
                         uint64_t* block_hashes, uint64_t* seq_hashes) {
  if (block_size <= 0) return 0;
  const int64_t n_blocks = n_tokens / block_size;
  const size_t body_len = static_cast<size_t>(block_size) * 4;
  // [parent seq hash, u64 LE][block's token bytes, u32 LE each]
  std::vector<uint8_t> buf(8 + body_len);
  uint8_t* body = buf.data() + 8;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const uint32_t* blk = tokens + b * block_size;
    for (int64_t t = 0; t < block_size; ++t) {
      const uint32_t v = blk[t];
      body[4 * t] = static_cast<uint8_t>(v);
      body[4 * t + 1] = static_cast<uint8_t>(v >> 8);
      body[4 * t + 2] = static_cast<uint8_t>(v >> 16);
      body[4 * t + 3] = static_cast<uint8_t>(v >> 24);
    }
    block_hashes[b] = xxh3_64(body, body_len, seed);
    if (b == 0) {
      seq_hashes[b] = block_hashes[b];
    } else {
      write64(buf.data(), seq_hashes[b - 1]);
      seq_hashes[b] = xxh3_64(buf.data(), 8 + body_len, seed);
    }
  }
  return n_blocks;
}

void* dyn_index_new() { return new PrefixIndex(); }

void dyn_index_free(void* handle) { delete static_cast<PrefixIndex*>(handle); }

void dyn_index_stored(void* handle, uint64_t worker, const uint64_t* hashes,
                      int64_t n) {
  auto* ix = static_cast<PrefixIndex*>(handle);
  auto& mine = ix->owned[worker];
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t h = hashes[i];
    if (++mine[h] == 1) ix->blocks[h].push_back(worker);
  }
}

void dyn_index_removed(void* handle, uint64_t worker, const uint64_t* hashes,
                       int64_t n) {
  auto* ix = static_cast<PrefixIndex*>(handle);
  auto wit = ix->owned.find(worker);
  if (wit == ix->owned.end()) return;
  auto& mine = wit->second;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t h = hashes[i];
    auto hit = mine.find(h);
    if (hit == mine.end()) continue;
    if (--hit->second <= 0) {
      mine.erase(hit);
      index_remove_one(ix, worker, h);
    }
  }
}

void dyn_index_clear_worker(void* handle, uint64_t worker) {
  auto* ix = static_cast<PrefixIndex*>(handle);
  auto wit = ix->owned.find(worker);
  if (wit == ix->owned.end()) return;
  for (const auto& kv : wit->second) index_remove_one(ix, worker, kv.first);
  ix->owned.erase(wit);
}

int64_t dyn_index_num_blocks(void* handle) {
  return static_cast<int64_t>(static_cast<PrefixIndex*>(handle)->blocks.size());
}

// Longest-prefix match over the chained hashes, in order; workers_out and
// depths_out hold max_out entries. Returns the number of matching workers.
int64_t dyn_index_find_matches(void* handle, const uint64_t* hashes, int64_t n,
                               uint64_t* workers_out, int64_t* depths_out,
                               int64_t max_out) {
  auto* ix = static_cast<PrefixIndex*>(handle);
  std::unordered_map<uint64_t, int64_t> depth;  // worker -> matched blocks
  for (int64_t i = 0; i < n; ++i) {
    auto it = ix->blocks.find(hashes[i]);
    bool advanced = false;
    if (it != ix->blocks.end()) {
      for (uint64_t w : it->second) {
        auto dit = depth.find(w);
        if (i == 0 && dit == depth.end()) {
          depth[w] = 1;
          advanced = true;
        } else if (dit != depth.end() && dit->second == i) {
          dit->second = i + 1;
          advanced = true;
        }
      }
    }
    if (!advanced) break;  // prefix property: nobody can match deeper
  }
  int64_t out = 0;
  for (const auto& kv : depth) {
    if (out >= max_out) break;
    workers_out[out] = kv.first;
    depths_out[out] = kv.second;
    ++out;
  }
  return out;
}

}  // extern "C"
