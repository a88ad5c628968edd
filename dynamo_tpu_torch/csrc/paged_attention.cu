// Paged attention for Hopper (sm_90a), bound to Python with ctypes
// (ops/_build.py builds this file, ops/paged_attention.py calls it).
//
// Replaces the one Pallas TPU kernel of dynamo_tpu: paged_attention_ragged
// (dynamo_tpu/ops/paged_attention.py:175, body _ragged_kernel at :55, the
// pallas_call at :299) and its decode face paged_attention_decode (:311),
// with the quantized-KV branch of both (:73-76, :109-115, :265-281).
// It computes what that kernel computes, not its block-by-block schedule:
//
//   Queries are packed along one flat axis. Row r owns the slots
//   [q_start[r], q_start[r+1]) and fills the first q_len[r] of them; query i
//   of row r sits at absolute position ctx_len[r] - q_len[r] + i and sees
//   exactly the keys at positions <= that, read from the paged cache
//   [NB, KV, bs, hd] through the row's block table. GQA: query head h reads
//   KV head h / G. Softmax is online, in f32.
//
// Trash-block contract (physical block 0 and stale table tails hold
// arbitrary bits, NaN included): a key at a position >= ctx_len is never
// read — its staging slot is zero-filled (cp.async with a source size of 0)
// — so it can neither contribute nor poison the sums; a scale past the
// frontier is staged as 0 the same way; a zero softmax denominator divides
// as 1; every slot of a row's allotment with no valid query (q_len == 0
// rows, slots past q_len) is written as exact zeros.
//
// Quantized KV: pages of int8 or fp8 (e4m3) with one f32 scale per (slot,
// KV head), [NB, KV, bs].
//
// Three kernels:
//
// 1. ragged_paged_attention_mma_kernel — the ragged (prefill) face for bf16
//    queries over bf16, int8 or fp8 pages, hd 64 or 128.
//    What bounds it: a 512-query chunk over 512 keys does ~1.1 GFLOP of
//    QK^T and PV (~1.1 us at the card's 989 TFLOP/s bf16) and reads ~5 MB
//    (~1.6 us at 3.35 TB/s); scalar f32 FMAs on CUDA cores (kernel 3's
//    design) sit 200x over that bound. What bounds this
//    design instead is the longest causal tile: its chunks run one after
//    another in one block (~1.3 us per 64 keys on an H100), plus ~4 us of
//    launch and dependent metadata loads.
//    Design: one block of four warps per (KV head, row, query tile); a tile
//    is 64 flat rows = 64 / G query slots x the G query heads of one KV
//    head, so every staged K/V byte serves all G heads. Each warp owns 16
//    flat rows and runs both products on tensor cores (mma.sync m16n8k16,
//    bf16 in, f32 accumulate): Q is loaded once by ldmatrix and held in
//    registers; S and the O accumulator live in registers; the online
//    softmax runs on the S fragment (row max and sum across the quad by
//    shuffles); P is rounded to bf16 in registers and fed straight back as
//    the A operand of PV, V through ldmatrix.trans. Keys come in chunks
//    (64 keys for bf16 pages, in a three-stage ring; 128 for 1-byte pages,
//    two stages), staged by 16-byte cp.async copies (rows padded by 16
//    bytes, so ldmatrix is conflict-free) while earlier chunks are
//    multiplied; each chunk's table entries are read one chunk ahead, the
//    first ones together with the row's metadata. The block walks its
//    chunks only up to its tile's causal frontier; the per-row causal mask
//    touches S only in chunks that straddle a row's frontier. Tiles are
//    scheduled heaviest (longest causal prefix) first.
//    Launch parameters (engine/autotune.py sweeps them per shape class):
//    q_tile, the query slots of a block (default min(max_q_len, 64 / G));
//    a smaller tile gives more blocks over the same keys. kv_chunk, the
//    keys per chunk, 64 or 128, both instantiated for every page type
//    (each instantiation raises its own shared-memory limit once); 0
//    launches the default for the page type.
//    Quantized pages are staged raw by cp.async and converted to bf16 in
//    shared memory once per chunk: int8 (|q| <= 127, 7 significant bits)
//    and e4m3 (4) are exact in bf16, int8 through byte permutes and one
//    bf16 subtraction, no float conversion. The K scale multiplies S per
//    key column after the product (S_ij * ks_j / sqrt(hd)); the V scale is
//    folded into P (p_ij * vs_j) before P is rounded to bf16.
//
// 2. paged_attention_decode_split_kernel — the decode face (one query per
//    row), every q and page type, split over the context.
//    What bounds it: bytes, ideally. Each visible key and value is read
//    once per KV head and meets G query heads (~2 flops per byte); B=16
//    rows over ~560 keys read ~18 MB per layer (~5.4 us at 3.35 TB/s). One
//    block per (row, KV head) would give 128 blocks at B=16 on 132 SMs,
//    each walking ~18 chunks in turn. Design: the keys are cut
//    into spans of 64 keys (or of a multiple of bs when bs > 64); split s
//    of n_split takes the spans s, s + n_split, s + 2 n_split, ... One
//    block per (split, KV head, row) holds the G query heads of its KV
//    head, stages each span's pages with 16-byte cp.async copies into a
//    two-stage ring (table entries read one chunk ahead) and keeps a
//    partial softmax state. n_split is a function of host-known shapes
//    only (B, KV, W, bs, SM count, the kernel's blocks per SM; or the
//    autotune's winner, 1 .. the span count), so the
//    launch needs no host sync and the grid fills the card once; blocks
//    whose first span starts at or past seq_len exit at once. Each split
//    writes (m, l, acc[G, hd]) to an f32 scratch; the last live split of a
//    (row, KV head) to finish — counted in a buffer it resets — rescales
//    and sums them into the output, so a call is one launch. Rows with
//    seq_len == 0 come out as exact zeros.
//    bf16 queries run both products on tensor cores: the G heads are rows
//    of one 16-row mma tile (rows >= G zero) and warp w takes keys [16 w,
//    16 w + 16) of every chunk, with its own m, l and O, merged at the end
//    of the split. On CUDA cores, f32 dots cost ~500 instructions per
//    thread per 64-key chunk, and the instruction count, not the bytes,
//    bounded the kernel; mma.sync takes a warp's 16 keys in 16 tensor-core
//    instructions. Quantized fragments are converted
//    to bf16 in registers (each page element exactly once), the K scale
//    multiplies S per key and the V scale is folded into p before its bf16
//    rounding, as in the ragged face. f32 queries keep f32 dots on CUDA
//    cores (TF32 would break the f32 build's 1e-4 tolerance).
//
// 3. ragged_paged_attention_f32_kernel — the first, CUDA-core design of the
//    ragged face, kept for f32 queries only (a phase-2 case off the main
//    path), for the same reason. One block per (row, query tile, KV head),
//    32-key chunks staged as f32, m/l/acc in shared memory.
//
// Numerics of the bf16 builds: P is rounded to bf16 before PV, as the
// port's einsum path and the JAX package's bf16 path do; each term then
// carries a relative error <= 2^-9 while the sums stay in f32, so a kernel
// stays within one bf16 ulp of the f32 plain version
// (chip_smoke.TOL["bfloat16"]). The softmax denominator sums the unrounded
// p.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;        // f32 kernel: keys per staged chunk
constexpr int kMaxRows = 64;     // flat query rows (q slots x G) per block
constexpr int kChunk = 64;       // mma / decode kernels: keys per chunk
constexpr int kMaxG = 16;        // decode: query heads per KV head
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec16;  // elements in one 16-byte load
template <>
struct Vec16<float> {
  static constexpr int N = 4;
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
};
template <>
struct Vec16<__nv_fp8_e4m3> {
  static constexpr int N = 16;
};

// 16 bytes of any element type to f32 (quantized: the raw value, exact)
__device__ __forceinline__ void cvt16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void cvt16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// int8 -> f32, exact, without I2F (a quarter-rate instruction): the byte
// u = v + 128 placed in the mantissa of 2^23 reads 2^23 + u; subtracting
// 2^23 + 128 leaves v
constexpr float kI8Magic = 8388736.f;  // 2^23 + 128
__device__ __forceinline__ float i8_to_f32(uint32_t biased, int byte) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + byte)) -
         kI8Magic;
}

__device__ __forceinline__ void cvt16(const int8_t* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[4 * i + j] = i8_to_f32(w[i], j);
}

__device__ __forceinline__ float2 fp8x2_to_float2(__nv_fp8x2_storage_t p) {
  // e4m3 -> f16 -> f32 is exact; the low byte is the lower element
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(p, __NV_E4M3));
  return __half22float2(h);
}

__device__ __forceinline__ void cvt16(const __nv_fp8_e4m3* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = fp8x2_to_float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// two consecutive elements to f32
__device__ __forceinline__ float2 cvt2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 cvt2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 cvt2(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  return make_float2(i8_to_f32(w, 0), i8_to_f32(w, 1));
}
__device__ __forceinline__ float2 cvt2(const __nv_fp8_e4m3* p) {
  return fp8x2_to_float2(*reinterpret_cast<const __nv_fp8x2_storage_t*>(p));
}

// 16 one-byte page elements to 16 bf16, exact. int8 takes no float
// conversion: bf16 bits 0x4300 | (v & 0x7f) read 128 + (v & 0x7f), bits
// 0x4300 | (v & 0x80) read 128 or 256, and their difference is v.
__device__ __forceinline__ void to_bf16x16(const int8_t* src,
                                           uint32_t (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = in[i] & 0x7f7f7f7fu;
    const uint32_t sgn = in[i] & 0x80808080u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sel = h ? 0x4342u : 0x4140u;
      const uint32_t x = __byte_perm(m, 0x43434343u, sel);
      const uint32_t c = __byte_perm(sgn, 0x43434343u, sel);
      const __nv_bfloat162 d =
          __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                  *reinterpret_cast<const __nv_bfloat162*>(&c));
      out[2 * i + h] = *reinterpret_cast<const uint32_t*>(&d);
    }
  }
}

__device__ __forceinline__ void to_bf16x16(const __nv_fp8_e4m3* src,
                                           uint32_t (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = fp8x2_to_float2(p[i]);
    const __nv_bfloat162 d = __floats2bfloat162_rn(f.x, f.y);
    out[i] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// two one-byte page elements (low byte first) to a bf16x2, exact
template <typename KT>
__device__ __forceinline__ uint32_t bytes2_to_bf16x2(uint32_t w);
template <>
__device__ __forceinline__ uint32_t bytes2_to_bf16x2<int8_t>(uint32_t w) {
  const uint32_t x = __byte_perm(w & 0x7f7fu, 0x43434343u, 0x4140u);
  const uint32_t c = __byte_perm(w & 0x8080u, 0x43434343u, 0x4140u);
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}
template <>
__device__ __forceinline__ uint32_t bytes2_to_bf16x2<__nv_fp8_e4m3>(
    uint32_t w) {
  const float2 f = fp8x2_to_float2(static_cast<__nv_fp8x2_storage_t>(w));
  const __nv_bfloat162 d = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the f32 kernel's staging: dequantized page elements (element times scale)
template <typename KT>
__device__ __forceinline__ void load16(const KT* src, float s, float* dst) {
  cvt16(src, dst);
#pragma unroll
  for (int i = 0; i < Vec16<KT>::N; ++i) dst[i] *= s;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A position's table entry and offset in its page; a power-of-two bs (the
// engine's) takes a shift and a mask instead of a division.
struct PageMap {
  int bs, shift;  // shift < 0: bs is not a power of two
  __device__ __forceinline__ int page(int pos) const {
    return shift >= 0 ? pos >> shift : pos / bs;
  }
  __device__ __forceinline__ int off(int pos) const {
    return shift >= 0 ? pos & (bs - 1) : pos % bs;
  }
};
__device__ __forceinline__ PageMap page_map(int bs) {
  return {bs, (bs & (bs - 1)) ? -1 : __ffs(bs) - 1};
}

// ---------------------- asynchronous copies, tensor cores -----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes == 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------- f32 queries: the CUDA-core kernel -------------------

// KT is the page type: float itself, or int8_t / __nv_fp8_e4m3 with scales
template <typename KT, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_f32_kernel(
    const float* __restrict__ q,             // [Tq, H, HD]
    const KT* __restrict__ k_cache,          // [NB, KV, bs, HD]
    const KT* __restrict__ v_cache,          // [NB, KV, bs, HD]
    const float* __restrict__ k_scale,       // [NB, KV, bs] (quantized KT)
    const float* __restrict__ v_scale,       // [NB, KV, bs] (quantized KT)
    const int32_t* __restrict__ block_tables,  // [R, W]
    const int32_t* __restrict__ q_start,     // [R + 1]
    const int32_t* __restrict__ q_len,       // [R]
    const int32_t* __restrict__ ctx_len,     // [R]
    float* __restrict__ out,                 // [Tq, H, HD]
    int H, int KV, int bs, int W, int q_tile, float scale) {
  using T = float;
  constexpr bool kQuant = !std::is_same<T, KT>::value;
  constexpr int VN = Vec16<T>::N;
  constexpr int VPR = HD / VN;   // 16-byte vectors per head row
  constexpr int KN = Vec16<KT>::N;
  constexpr int KVPR = HD / KN;  // 16-byte page vectors per head row
  constexpr int DPL = HD / 32;   // output dims per lane
  constexpr int KS = HD + 1;     // padded shared-memory key stride
  const int G = H / KV;
  const int nq = q_tile * G;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [nq, HD]
  float* acc_s = q_s + nq * HD;       // [nq, HD]
  float* m_s = acc_s + nq * HD;       // [nq]
  float* l_s = m_s + nq;              // [nq]
  float* k_s = l_s + nq;              // [kKeys, KS]
  float* v_s = k_s + kKeys * KS;      // [kKeys, KS]

  const int r = blockIdx.x;
  const int kvh = blockIdx.z;
  const int qi0 = blockIdx.y * q_tile;
  const int slot0 = q_start[r];
  const int alloc = q_start[r + 1] - slot0;
  if (qi0 >= alloc) return;  // past this row's allotment
  const int qi_end = min(qi0 + q_tile, alloc);
  const int ql = q_len[r];
  const int cl = ctx_len[r];
  // keys the tile's queries may see: positions < ctx_len - q_len + (last
  // live query + 1) — the causal frontier; a tile with no live query reads
  // no key at all. Never past the table.
  int n_keys = 0;
  if (qi0 < ql) {
    n_keys = cl - ql + min(qi_end, ql);
    n_keys = max(0, min(n_keys, W * bs));
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < nq * VPR; e += kThreads) {
    const int j = e / VPR;
    const int c = (e % VPR) * VN;
    const int qi = qi0 + j / G;
    float* dst = q_s + j * HD + c;
    if (qi < qi_end && qi < ql) {
      cvt16(q + ((size_t)(slot0 + qi) * H + kvh * G + j % G) * HD + c, dst);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) dst[i] = 0.f;
    }
  }
  for (int e = tid; e < nq * HD; e += kThreads) acc_s[e] = 0.f;
  for (int e = tid; e < nq; e += kThreads) {
    m_s[e] = -INFINITY;
    l_s[e] = 0.f;
  }
  __syncthreads();

  const int32_t* table = block_tables + (size_t)r * W;
  for (int c0 = 0; c0 < n_keys; c0 += kKeys) {
    // stage this chunk's keys and values of KV head kvh; positions at or
    // past n_keys are zeros and their pages are never touched
    for (int e = tid; e < kKeys * KVPR; e += kThreads) {
      const int kk = e / KVPR;
      const int c = (e % KVPR) * KN;
      const int pos = c0 + kk;
      float* kd = k_s + kk * KS + c;
      float* vd = v_s + kk * KS + c;
      if (pos < n_keys) {
        const size_t slot = ((size_t)table[pos / bs] * KV + kvh) * bs +
                            pos % bs;
        const size_t base = slot * HD + c;
        if constexpr (kQuant) {
          load16(k_cache + base, k_scale[slot], kd);
          load16(v_cache + base, v_scale[slot], vd);
        } else {
          cvt16(k_cache + base, kd);
          cvt16(v_cache + base, vd);
        }
      } else {
#pragma unroll
        for (int i = 0; i < KN; ++i) {
          kd[i] = 0.f;
          vd[i] = 0.f;
        }
      }
    }
    __syncthreads();

    for (int j = warp; j < nq; j += kWarps) {
      const int qi = qi0 + j / G;
      if (qi >= qi_end || qi >= ql) continue;  // no query: stays zero
      const int last = cl - ql + qi;           // last key it may see
      if (c0 > last) continue;                 // chunk wholly in its future
      // lane 0's key (position c0 <= last, < n_keys) is always valid, so
      // the chunk max below is finite
      const int pos = c0 + lane;
      float s = -INFINITY;
      if (pos <= last && pos < n_keys) {
        const float* qr = q_s + j * HD;
        const float* kr = k_s + lane * KS;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_new);  // 0 while m_prev = -inf
      const float p = (pos <= last && pos < n_keys) ? expf(s - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      float* ar = acc_s + j * HD;
      float a[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = ar[lane + 32 * i] * alpha;
#pragma unroll 8
      for (int kk = 0; kk < kKeys; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
        const float* vr = v_s + kk * KS;
#pragma unroll
        for (int i = 0; i < DPL; ++i) a[i] = fmaf(pk, vr[lane + 32 * i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) ar[lane + 32 * i] = a[i];
      __syncwarp();
      if (lane == 0) {
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + p_sum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // every slot of the tile inside the allotment is written: rows that saw
  // no key keep l == 0 and acc == 0 and come out as exact zeros
  for (int j = warp; j < nq; j += kWarps) {
    const int qi = qi0 + j / G;
    if (qi >= qi_end) continue;
    const float l = l_s[j];
    const float denom = (l == 0.f) ? 1.f : l;
    const float* ar = acc_s + j * HD;
    T* o = out + ((size_t)(slot0 + qi) * H + kvh * G + j % G) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store(o + lane + 32 * i, ar[lane + 32 * i] / denom);
  }
}

// --------------- bf16 queries, ragged face: tensor-core kernel -----------

// ring depth for a chunk of CH keys: three chunks of 64 or two of 128
template <int CH>
__host__ __device__ constexpr int mma_stages() {
  return CH == 64 ? 3 : 2;
}

// bytes of dynamic shared memory of one block
template <typename KT, int HD, int CH>
constexpr size_t mma_smem_bytes() {
  constexpr bool kQuant = !std::is_same<__nv_bfloat16, KT>::value;
  constexpr int NST = mma_stages<CH>();
  constexpr size_t q_tile = (size_t)kMaxRows * (HD + 8) * 2;
  constexpr size_t tile = (size_t)CH * (HD + 8) * 2;
  constexpr size_t raw_stage =
      2 * (size_t)CH * (HD + 16) + 2 * (size_t)CH * 4;
  return q_tile + (kQuant ? 2 * tile + NST * raw_stage : 2 * NST * tile);
}

// KT: __nv_bfloat16 pages, or int8_t / __nv_fp8_e4m3 pages with scales;
// CH: keys per chunk
template <typename KT, int HD, int CH>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q,     // [Tq, H, HD]
    const KT* __restrict__ k_cache,          // [NB, KV, bs, HD]
    const KT* __restrict__ v_cache,          // [NB, KV, bs, HD]
    const float* __restrict__ k_scale,       // [NB, KV, bs] (quantized KT)
    const float* __restrict__ v_scale,       // [NB, KV, bs] (quantized KT)
    const int32_t* __restrict__ block_tables,  // [R, W]
    const int32_t* __restrict__ q_start,     // [R + 1]
    const int32_t* __restrict__ q_len,       // [R]
    const int32_t* __restrict__ ctx_len,     // [R]
    __nv_bfloat16* __restrict__ out,         // [Tq, H, HD]
    int H, int KV, int bs, int W, int q_tile, float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr bool kQuant = !std::is_same<bf16, KT>::value;
  constexpr int LD = HD + 8;            // bf16 tile row stride (elements)
  constexpr int NST = mma_stages<CH>();  // chunks in the ring
  constexpr int QTILE = kMaxRows * LD;  // the q tile (elements)
  constexpr int TILE = CH * LD;         // one K or V tile (elements)
  constexpr int RAW_LD = HD + 16;       // raw 1-byte page row stride
  constexpr int RAW = CH * RAW_LD;  // one raw page tile (bytes)
  constexpr int RAW_STAGE = 2 * RAW + 2 * CH * 4;
  constexpr int KSTEPS = HD / 16;       // k-steps of QK^T
  constexpr int DT = HD / 8;            // n-tiles of O
  constexpr int NT = CH / 8;        // n-tiles of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q tile [64, LD]; bf16 pages: a ring of NST {K, V} tile pairs;
  // quantized pages: one {K, V} bf16 tile pair and a ring of NST raw
  // stages of {K bytes, V bytes, K scales [64], V scales [64]}
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + QTILE;
  unsigned char* raw_s = reinterpret_cast<unsigned char*>(
      kv_s + (kQuant ? 2 : 2 * NST) * TILE);

  const int kvh = blockIdx.x;
  const int r = blockIdx.y;
  const int qi0 = (gridDim.z - 1 - blockIdx.z) * q_tile;  // heaviest first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair

  const int32_t* table = block_tables + (size_t)r * W;
  const PageMap pm = page_map(bs);
  // Each thread copies NV 16-byte vectors of a chunk (and, quantized, the
  // scales of key tid). Their pages are read from the table one chunk
  // before they are staged (the first NST - 1 chunks' together with the
  // row's metadata), so the table's latency never sits in front of a copy.
  // Any entry inside the table may be read; -1 marks one past it.
  constexpr int SV = kQuant ? HD / 16 : HD / 8;  // 16-byte vectors per row
  constexpr int NV = CH * SV / kThreads;
  using Pages = int[NV + 1];
  auto fetch = [&](int c0, Pages& pages) {
#pragma unroll
    for (int i = 0; i <= NV; ++i) {
      const int kk = i < NV ? (tid + kThreads * i) / SV : tid;
      const int blk = pm.page(c0 + kk);
      pages[i] = (kk < CH && blk < W) ? table[blk] : -1;
    }
  };
  Pages pre[NST - 1];
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) fetch(i * CH, pre[i]);

  const int slot0 = q_start[r];
  const int alloc = q_start[r + 1] - slot0;
  if (qi0 >= alloc) return;  // past this row's allotment
  const int qi_end = min(qi0 + q_tile, alloc);
  const int ql = q_len[r];
  const int cl = ctx_len[r];
  // the tile's causal frontier (see the f32 kernel); never past the table
  int n_keys = 0;
  if (qi0 < ql) {
    n_keys = cl - ql + min(qi_end, ql);
    n_keys = max(0, min(n_keys, W * bs));
  }
  const int G = H / KV;
  const int nq = q_tile * G;

  // the q tile: flat row j = query slot qi0 + j / G, head kvh * G + j % G;
  // rows with no live query are zero-filled
  {
    constexpr int VPR = HD / 8;
    for (int e = tid; e < kMaxRows * VPR; e += kThreads) {
      const int j = e / VPR;
      const int c = (e % VPR) * 8;
      const int qi = qi0 + j / G;
      const bool ok = j < nq && qi < qi_end && qi < ql;
      const bf16* src =
          ok ? q + ((size_t)(slot0 + qi) * H + kvh * G + j % G) * HD + c : q;
      cp_async16(q_s + j * LD + c, src, ok ? 16 : 0);
    }
  }

  // stage the chunk of keys [c0, c0 + CH) of KV head kvh into ring slot
  // st; positions at or past n_keys are zero-filled, their pages and
  // scales never read
  auto stage = [&](int c0, int st, const Pages& pages) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + kThreads * i;
      const int kk = e / SV;
      const int pos = c0 + kk;
      const bool ok = pos < n_keys;
      const size_t base =
          ok ? (((size_t)pages[i] * KV + kvh) * bs + pm.off(pos)) * HD : 0;
      if constexpr (!kQuant) {
        const int c = (e % SV) * 8;
        bf16* kd = kv_s + 2 * st * TILE;
        cp_async16(kd + kk * LD + c, k_cache + base + c, ok ? 16 : 0);
        cp_async16(kd + TILE + kk * LD + c, v_cache + base + c, ok ? 16 : 0);
      } else {
        const int c = (e % SV) * 16;
        unsigned char* kd = raw_s + st * RAW_STAGE;
        cp_async16(kd + kk * RAW_LD + c, k_cache + base + c, ok ? 16 : 0);
        cp_async16(kd + RAW + kk * RAW_LD + c, v_cache + base + c,
                   ok ? 16 : 0);
      }
    }
    if constexpr (kQuant) {
      if (tid < CH) {
        float* ksd =
            reinterpret_cast<float*>(raw_s + st * RAW_STAGE + 2 * RAW);
        const bool ok = c0 + tid < n_keys;
        const size_t slot =
            ok ? ((size_t)pages[NV] * KV + kvh) * bs + pm.off(c0 + tid) : 0;
        cp_async4(ksd + tid, k_scale + slot, ok ? 4 : 0);
        cp_async4(ksd + CH + tid, v_scale + slot, ok ? 4 : 0);
      }
    }
  };

  // the last key each of this thread's two rows may see; rows with no
  // live query never need a mask (their output is written as zeros)
  int row_last[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = warp * 16 + g + 8 * h;
    const int qi = qi0 + j / G;
    row_last[h] = (j < nq && qi < qi_end && qi < ql)
                      ? min(cl - ql + qi, n_keys - 1)
                      : 0x7fffffff;
  }
  const int warp_last =
      __reduce_min_sync(0xffffffffu, min(row_last[0], row_last[1]));

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t qf[KSTEPS][4];

  // the ring: chunks ch + 1 .. ch + NST - 1 are in flight while chunk ch
  // is multiplied; one commit group per chunk (the first one holds the q
  // tile too; empty past the last chunk)
  const int nch = (n_keys + CH - 1) / CH;
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nch) stage(i * CH, i, pre[i]);
    cp_async_commit();
  }
  Pages pg;
  fetch((NST - 1) * CH, pg);
  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * CH;
    const int st = ch % NST;
    if (ch + NST - 1 < nch)
      stage(c0 + (NST - 1) * CH, (ch + NST - 1) % NST, pg);
    cp_async_commit();
    fetch(c0 + NST * CH, pg);  // staged in the next iteration
    cp_async_wait<NST - 1>();  // chunk ch (and the q tile) has landed
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* ks;
    const bf16* vs;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (kQuant) {
      // raw bytes -> bf16, exact
      const unsigned char* kr = raw_s + st * RAW_STAGE;
      constexpr int VPR = HD / 16;
#pragma unroll
      for (int e = tid; e < 2 * CH * VPR; e += kThreads) {
        const int kv = e / (CH * VPR);  // 0 = K, 1 = V
        const int kk = (e / VPR) % CH;
        const int c = (e % VPR) * 16;
        uint32_t w[8];
        to_bf16x16(
            reinterpret_cast<const KT*>(kr + kv * RAW + kk * RAW_LD + c), w);
        uint4* dst =
            reinterpret_cast<uint4*>(kv_s + kv * TILE + kk * LD + c);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      ksc = reinterpret_cast<const float*>(kr + 2 * RAW);
      vsc = ksc + CH;
      __syncthreads();
      ks = kv_s;
      vs = kv_s + TILE;
    } else {
      ks = kv_s + 2 * st * TILE;
      vs = ks + TILE;
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (nt * 8 + (lane & 7)) * LD + kp * 32 +
                           (lane >> 3) * 8);
        mma_bf16(s[nt], qf[2 * kp], b[0], b[1]);
        mma_bf16(s[nt], qf[2 * kp + 1], b[2], b[3]);
      }
    }

    // scale (and the K scale per key column); the causal mask only where
    // the chunk reaches past a row's last key
    const bool masked = c0 + CH - 1 > warp_last;
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale_log2;
        if constexpr (kQuant) x *= ksc[col];
        if (masked && c0 + col > row_last[e >> 1]) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mu[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = exp2f(m2[h] - mu[h]);  // 0 while m2 = -inf
      m2[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P = exp(S - m); the row sums take p unrounded, PV takes p (times the
    // V scale per key) rounded to bf16, packed as A fragments of 16 keys
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p[e];
        if constexpr (kQuant) p[e] *= vsc[nt * 8 + 2 * t + (e & 1)];
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // ring slot st is free for chunk ch + NST
  }
  cp_async_wait<0>();

  // every slot of the tile inside the allotment is written: slots past
  // q_len (and tiles with no live query) as exact zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = warp * 16 + g + 8 * h;
    const int qi = qi0 + j / G;
    if (j >= nq || qi >= qi_end) continue;
    const bool live = qi < ql;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    bf16* dst = out + ((size_t)(slot0 + qi) * H + kvh * G + j % G) * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float a = live ? o[d][2 * h] * inv : 0.f;
      const float b = live ? o[d][2 * h + 1] * inv : 0.f;
      *reinterpret_cast<uint32_t*>(dst + d * 8 + 2 * t) = pack_bf16(a, b);
    }
  }
}

// ------------------ decode face: split-KV, then combine ------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename KT, int HD>
struct DecodeLayout {
  static constexpr int ROW = HD * (int)sizeof(KT) + 16;  // padded row bytes
  static constexpr int TILE = kChunk * ROW;
  static constexpr int STAGE = 2 * TILE + 2 * kChunk * 4;  // K, V, scales
  // two stages, then q [G, HD], p [64, G4] and alpha [G4] in f32 (G4: G
  // rounded up to 4), or the tensor-core path's bf16 q tile [16, HD + 8];
  // the cross-warp sum at the end reuses the stages
  static constexpr size_t smem(int G) {
    const int G4 = (G + 3) & ~3;
    const size_t f32 = (size_t)(G * HD + kChunk * G4 + G4) * 4;
    const size_t bf16 = (size_t)16 * (HD + 8) * 2;
    return 2 * (size_t)STAGE + (f32 > bf16 ? f32 : bf16);
  }
  static_assert(kWarps * kMaxG * (HD + 2) * 4 <= 2 * STAGE,
                "the cross-warp sum fits in the stages");
};

// One block per (split, KV head, row). Split s owns the spans s, s +
// n_split, s + 2 n_split, ... of `span` keys each (span a multiple of 64
// and of bs) and walks them in 64-key chunks up to seq_len. It writes the
// unnormalised partial acc[G, HD] and (m, l) of each of its G query heads;
// the last live split of a (row, KV head) to finish, found by a counter
// that it resets, rescales and sums the partials into the output. A row
// with seq_len == 0 has no live split: split 0 writes its exact zeros.
template <typename T, typename KT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_split_kernel(
    const T* __restrict__ q,                 // [B, H, HD]
    const KT* __restrict__ k_cache,          // [NB, KV, bs, HD]
    const KT* __restrict__ v_cache,          // [NB, KV, bs, HD]
    const float* __restrict__ k_scale,       // [NB, KV, bs] (quantized KT)
    const float* __restrict__ v_scale,       // [NB, KV, bs] (quantized KT)
    const int32_t* __restrict__ block_tables,  // [B, W]
    const int32_t* __restrict__ seq_lens,    // [B]
    float* __restrict__ part_acc,            // [B, KV, n_split, G, HD]
    float* __restrict__ part_ml,             // [B, KV, n_split, G, 2]
    int* __restrict__ arrived,               // [B * KV], zero between calls
    T* __restrict__ out,                     // [B, H, HD]
    int H, int KV, int bs, int W, int span, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value ||
                          std::is_same<KT, __nv_fp8_e4m3>::value;
  // bf16 queries run both products on tensor cores (see the header)
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using L = DecodeLayout<KT, HD>;
  constexpr int KN = Vec16<KT>::N;
  constexpr int VPR = HD / KN;  // 16-byte vectors per page row
  constexpr int NV = kChunk * VPR / kThreads;  // staged vectors per thread
  constexpr int DPT = HD / 32;  // PV: output dims per lane
  constexpr int KPW = kChunk / kWarps;  // PV: keys per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int G4 = (G + 3) & ~3;
  float* q_s = reinterpret_cast<float*>(smem_raw + 2 * L::STAGE);  // [G,HD]
  float* p_s = q_s + G * HD;            // [64, G4] scores, then p
  float* alpha_s = p_s + kChunk * G4;   // [G4]

  const int s = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int cps = span / kChunk;   // chunks per span
  // the c0 of this block's n-th chunk; increasing in n
  auto chunk_c0 = [&](int n) {
    return (s + (n / cps) * n_split) * span + (n % cps) * kChunk;
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int32_t* table = block_tables + (size_t)b * W;
  const PageMap pm = page_map(bs);

  // pages of this thread's vectors (and of key tid's scales), read one
  // chunk before they are staged (chunk 0's together with seq_len); any
  // entry inside the table may be read, -1 marks one past it
  using Pages = int[NV + 1];
  auto fetch = [&](int c0, Pages& pages) {
#pragma unroll
    for (int i = 0; i <= NV; ++i) {
      const int kk = i < NV ? (tid + kThreads * i) / VPR : tid;
      const int blk = pm.page(c0 + kk);
      pages[i] = (kk < kChunk && blk < W) ? table[blk] : -1;
    }
  };
  Pages pg0, pg;
  fetch(chunk_c0(0), pg0);
  fetch(chunk_c0(1), pg);

  const int n_keys = min(seq_lens[b], W * bs);
  if (n_keys <= 0) {  // a dead row: exact zeros, written once
    if (s == 0)
      for (int e = tid; e < G * HD; e += kThreads)
        store(out + ((size_t)b * H + kvh * G) * HD + e, 0.f);
    return;
  }
  if (s * span >= n_keys) return;  // an empty split
  const int live = min(n_split, (n_keys + span - 1) / span);

  // positions at or past n_keys are zero-filled, their pages and scales
  // never read
  auto stage = [&](int c0, int st, const Pages& pages) {
    unsigned char* kd = smem_raw + st * L::STAGE;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + kThreads * i;
      const int kk = e / VPR;
      const int c = (e % VPR) * KN;
      const bool ok = c0 + kk < n_keys;
      const size_t base =
          ok ? (((size_t)pages[i] * KV + kvh) * bs + pm.off(c0 + kk)) * HD + c
             : 0;
      cp_async16(kd + kk * L::ROW + c * sizeof(KT), k_cache + base,
                 ok ? 16 : 0);
      cp_async16(kd + L::TILE + kk * L::ROW + c * sizeof(KT), v_cache + base,
                 ok ? 16 : 0);
    }
    if constexpr (kQuant) {
      if (tid < kChunk) {
        float* ksd = reinterpret_cast<float*>(kd + 2 * L::TILE);
        const bool ok = c0 + tid < n_keys;
        const size_t slot =
            ok ? ((size_t)pages[NV] * KV + kvh) * bs + pm.off(c0 + tid) : 0;
        cp_async4(ksd + tid, k_scale + slot, ok ? 4 : 0);
        cp_async4(ksd + kChunk + tid, v_scale + slot, ok ? 4 : 0);
      }
    }
  };

  stage(chunk_c0(0), 0, pg0);
  cp_async_commit();

  // tensor-core path (bf16 q): the G query heads are rows of one 16-row
  // A tile (rows >= G are zero), warp w takes keys [16 w, 16 w + 16) of
  // every chunk and keeps its own m, l and O fragments
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
  float m2[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float lp[2] = {0.f, 0.f};  // this thread's share of the row sums
  // CUDA-core path (f32 q)
  float m_r[kMaxG / kWarps], l_r[kMaxG / kWarps];
  float acc[kMaxG][DPT];
  if constexpr (kMma) {
    __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(q_s);
    for (int e = tid; e < 16 * (HD / 8); e += kThreads) {
      const int r = e / (HD / 8);
      const int c = (e % (HD / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < G)
        v = *reinterpret_cast<const uint4*>(
            q + ((size_t)b * H + kvh * G + r) * HD + c);
      *reinterpret_cast<uint4*>(qb + r * (HD + 8) + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qf[kk], qb + (lane & 15) * (HD + 8) + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  } else {
    for (int e = tid; e < G * HD; e += kThreads)
      q_s[e] = to_f32(q[((size_t)b * H + kvh * G) * HD + e]);
#pragma unroll
    for (int i = 0; i < kMaxG / kWarps; ++i) {
      m_r[i] = -INFINITY;
      l_r[i] = 0.f;
    }
    // PV: warp w sums the keys [16 w, 16 w + 16) of every chunk into the
    // dims [DPT lane, DPT lane + DPT) of all G heads
#pragma unroll
    for (int h = 0; h < kMaxG; ++h)
#pragma unroll
      for (int x = 0; x < DPT; ++x) acc[h][x] = 0.f;
  }

  const int kk = tid & (kChunk - 1);  // scoring: this thread's key
  const int hg = tid / kChunk;        // and its heads hg, hg + 2, ...
  const int g = lane >> 2;            // mma fragment row (and row + 8)
  const int t = lane & 3;             // mma fragment column pair
  for (int n = 0;; ++n) {
    const int c0 = chunk_c0(n);
    if (c0 >= n_keys) break;
    const int c1 = chunk_c0(n + 1);
    if (c1 < n_keys) {
      stage(c1, (n + 1) & 1, pg);
      cp_async_commit();
      fetch(chunk_c0(n + 2), pg);  // staged in the next iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = smem_raw + (n & 1) * L::STAGE;
    const unsigned char* vt = kt + L::TILE;
    const float* ksc = reinterpret_cast<const float*>(vt + L::TILE);
    const float* vsc = ksc + kChunk;

    if constexpr (kMma) {
      const int k0 = warp * 16;  // this warp's keys in the chunk
      if (c0 + k0 < n_keys) {    // warp-uniform: at least one live key
        // S = Q K^T, 16 rows x 16 keys
        float sc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
          if constexpr (kQuant) {
            const unsigned char* kr = kt + (k0 + nt * 8 + g) * L::ROW;
#pragma unroll
            for (int k16 = 0; k16 < HD / 16; ++k16) {
              const uint32_t b0 = bytes2_to_bf16x2<KT>(
                  *reinterpret_cast<const uint16_t*>(kr + k16 * 16 + 2 * t));
              const uint32_t b1 = bytes2_to_bf16x2<KT>(
                  *reinterpret_cast<const uint16_t*>(kr + k16 * 16 + 8 +
                                                     2 * t));
              mma_bf16(sc[nt], qf[k16], b0, b1);
            }
          } else {
#pragma unroll
            for (int kp = 0; kp < HD / 32; ++kp) {
              uint32_t bb[4];
              ldmatrix_x4(bb, kt + (k0 + nt * 8 + (lane & 7)) * L::ROW +
                                  (kp * 32 + (lane >> 3) * 8) * 2);
              mma_bf16(sc[nt], qf[2 * kp], bb[0], bb[1]);
              mma_bf16(sc[nt], qf[2 * kp + 1], bb[2], bb[3]);
            }
          }
        }
        // scale (K scale per key), mask keys past seq_len, online softmax
        float mx[2] = {m2[0], m2[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nt * 8 + 2 * t + (e & 1);
            float x = sc[nt][e] * scale;  // scale is in log2 units here
            if constexpr (kQuant) x *= ksc[col];
            if (c0 + col >= n_keys) x = -INFINITY;
            sc[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float mu[2], alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mu[h] = mx[h] == -INFINITY ? 0.f : mx[h];
          alpha[h] = exp2f(m2[h] - mu[h]);
          m2[h] = mx[h];
          lp[h] *= alpha[h];
        }
        uint32_t pa[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float pr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[e] = exp2f(sc[nt][e] - mu[e >> 1]);
            lp[e >> 1] += pr[e];
            if constexpr (kQuant) pr[e] *= vsc[k0 + nt * 8 + 2 * t + (e & 1)];
          }
          pa[nt * 2] = pack_bf16(pr[0], pr[1]);
          pa[nt * 2 + 1] = pack_bf16(pr[2], pr[3]);
        }
        // O = O * alpha + P V
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          o[d][0] *= alpha[0];
          o[d][1] *= alpha[0];
          o[d][2] *= alpha[1];
          o[d][3] *= alpha[1];
        }
        if constexpr (kQuant) {
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            const unsigned char* vc = vt + d * 8 + g;
            const int r0 = k0 + 2 * t;
            const uint32_t b0 = bytes2_to_bf16x2<KT>(
                vc[r0 * L::ROW] | (uint32_t)vc[(r0 + 1) * L::ROW] << 8);
            const uint32_t b1 = bytes2_to_bf16x2<KT>(
                vc[(r0 + 8) * L::ROW] |
                (uint32_t)vc[(r0 + 9) * L::ROW] << 8);
            mma_bf16(o[d], pa, b0, b1);
          }
        } else {
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            uint32_t bb[4];
            ldmatrix_x4_trans(
                bb, vt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::ROW +
                        (np * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(o[2 * np], pa, bb[0], bb[1]);
            mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
          }
        }
      }
    } else {
      // scores of key kk for heads hg, hg + 2, ...: f32 dots on CUDA cores
      {
        float dot[kMaxG / 2];
#pragma unroll
        for (int i = 0; i < kMaxG / 2; ++i) dot[i] = 0.f;
        const unsigned char* krow = kt + kk * L::ROW;
#pragma unroll
        for (int v = 0; v < VPR; ++v) {
          float f[KN];
          cvt16(reinterpret_cast<const KT*>(krow + v * 16), f);
#pragma unroll
          for (int i = 0; i < kMaxG / 2; ++i) {
            if (hg + 2 * i < G) {
              const float4* qr = reinterpret_cast<const float4*>(
                  q_s + (hg + 2 * i) * HD + v * KN);
#pragma unroll
              for (int x = 0; x < KN / 4; ++x) {
                const float4 q4 = qr[x];
                dot[i] = fmaf(q4.x, f[4 * x], dot[i]);
                dot[i] = fmaf(q4.y, f[4 * x + 1], dot[i]);
                dot[i] = fmaf(q4.z, f[4 * x + 2], dot[i]);
                dot[i] = fmaf(q4.w, f[4 * x + 3], dot[i]);
              }
            }
          }
        }
        const bool ok = c0 + kk < n_keys;
        const float ks = kQuant ? ksc[kk] * scale : scale;
#pragma unroll
        for (int i = 0; i < kMaxG / 2; ++i)
          if (hg + 2 * i < G)
            p_s[kk * G4 + hg + 2 * i] = ok ? dot[i] * ks : -INFINITY;
      }
      __syncthreads();

      // online softmax: warp w takes heads w, w + 4, ...; the chunk's
      // first key (c0 < n_keys) is valid, so its max is finite
#pragma unroll
      for (int i = 0; i < kMaxG / kWarps; ++i) {
        const int h = warp + kWarps * i;
        if (h >= G) break;
        const float x0 = p_s[lane * G4 + h];
        const float x1 = p_s[(lane + 32) * G4 + h];
        const float mn = fmaxf(m_r[i], warp_max(fmaxf(x0, x1)));
        const float al = expf(m_r[i] - mn);  // 0 while m = -inf
        float p0 = expf(x0 - mn);
        float p1 = expf(x1 - mn);
        l_r[i] = l_r[i] * al + warp_sum(p0 + p1);
        m_r[i] = mn;
        if constexpr (kQuant) {  // the V scale folded into p
          p0 *= vsc[lane];
          p1 *= vsc[lane + 32];
        }
        p_s[lane * G4 + h] = p0;
        p_s[(lane + 32) * G4 + h] = p1;
        if (lane == 0) alpha_s[h] = al;
      }
      __syncthreads();

      // acc = acc * alpha + p V over this warp's 16 keys
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h < G) {
          const float al = alpha_s[h];
#pragma unroll
          for (int x = 0; x < DPT; ++x) acc[h][x] *= al;
        }
      }
#pragma unroll 4
      for (int k2 = warp * KPW; k2 < warp * KPW + KPW; ++k2) {
        float v[DPT];
        const unsigned char* vrow =
            vt + k2 * L::ROW + lane * DPT * sizeof(KT);
#pragma unroll
        for (int x = 0; x < DPT; x += 2) {
          const float2 v2 = cvt2(reinterpret_cast<const KT*>(vrow) + x);
          v[x] = v2.x;
          v[x + 1] = v2.y;
        }
        const float4* pr = reinterpret_cast<const float4*>(p_s + k2 * G4);
#pragma unroll
        for (int h4 = 0; h4 < kMaxG / 4; ++h4) {
          if (4 * h4 < G) {
            const float4 p4 = pr[h4];
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int x = 0; x < DPT; ++x)
                acc[4 * h4 + j][x] = fmaf(pv[j], v[x], acc[4 * h4 + j][x]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }

  // sum the four warps' shares (in the stages, now idle), then write this
  // split's partial: m in natural-log units, l, and the unnormalised acc
  float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps, G, HD]
  const size_t pbase = ((size_t)(b * KV + kvh) * n_split + s) * G;
  if constexpr (kMma) {
    float* red_m = red + kWarps * G * HD;  // [kWarps, G]
    float* red_l = red_m + kWarps * G;     // [kWarps, G]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lp[h] += __shfl_xor_sync(0xffffffffu, lp[h], 1);
      lp[h] += __shfl_xor_sync(0xffffffffu, lp[h], 2);
      const int r = g + 8 * h;
      if (r < G) {
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          red[(warp * G + r) * HD + d * 8 + 2 * t] = o[d][2 * h];
          red[(warp * G + r) * HD + d * 8 + 2 * t + 1] = o[d][2 * h + 1];
        }
        if (t == 0) {
          red_m[warp * G + r] = m2[h];
          red_l[warp * G + r] = lp[h];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += kThreads) {
      const int h = e / HD;
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * G + h]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = exp2f(red_m[w * G + h] - m);  // 0 for idle warps
        a = fmaf(red[w * G * HD + e], wt, a);
        l = fmaf(red_l[w * G + h], wt, l);
      }
      part_acc[pbase * HD + e] = a;
      if (e % HD == 0) {
        part_ml[(pbase + h) * 2] = m * 0.69314718055994531f;  // ln 2
        part_ml[(pbase + h) * 2 + 1] = l;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kMaxG; ++h)
      if (h < G)
#pragma unroll
        for (int x = 0; x < DPT; ++x)
          red[(warp * G + h) * HD + lane * DPT + x] = acc[h][x];
    __syncthreads();
    for (int e = tid; e < G * HD; e += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[w * G * HD + e];
      part_acc[pbase * HD + e] = a;
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kMaxG / kWarps; ++i) {
        const int h = warp + kWarps * i;
        if (h >= G) break;
        part_ml[(pbase + h) * 2] = m_r[i];
        part_ml[(pbase + h) * 2 + 1] = l_r[i];
      }
    }
  }

  // the last live split to arrive combines (partials are published before
  // the count; the count is reset for the next call)
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = arrived + b * KV + kvh;
    last = atomicAdd(cnt, 1) == live - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t base0 = (size_t)(b * KV + kvh) * n_split * G;
  for (int e = tid; e < G * HD; e += kThreads) {
    const int h = e / HD;
    float m = -INFINITY;
    for (int sp = 0; sp < live; ++sp)
      m = fmaxf(m, __ldcg(part_ml + (base0 + sp * G + h) * 2));
    float l = 0.f, o = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const size_t p = base0 + sp * G + h;
      const float w = expf(__ldcg(part_ml + p * 2) - m);
      l = fmaf(__ldcg(part_ml + p * 2 + 1), w, l);
      o = fmaf(__ldcg(part_acc + p * HD + e % HD), w, o);
    }
    store(out + ((size_t)b * H + kvh * G) * HD + e, o / l);
  }
}

// ------------------------------ dispatch ---------------------------------

template <typename F, typename T, typename KT>
cudaError_t by_hd(int hd, const F& f) {
  switch (hd) {
    case 64:
      return f.template run<T, KT, 64>();
    case 128:
      return f.template run<T, KT, 128>();
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q and out; the pages too when
// kv_dtype is 0); kv_dtype: 0 = pages in q's type, 1 = int8, 2 = fp8 e4m3
template <typename F>
cudaError_t by_types(int dtype, int kv_dtype, int hd, const F& f) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (kv_dtype * 2 + dtype) {
    case 0:
      return by_hd<F, float, float>(hd, f);
    case 1:
      return by_hd<F, __nv_bfloat16, __nv_bfloat16>(hd, f);
    case 2:
      return by_hd<F, float, int8_t>(hd, f);
    case 3:
      return by_hd<F, __nv_bfloat16, int8_t>(hd, f);
    case 4:
      return by_hd<F, float, __nv_fp8_e4m3>(hd, f);
    case 5:
      return by_hd<F, __nv_bfloat16, __nv_fp8_e4m3>(hd, f);
    default:
      return cudaErrorInvalidValue;
  }
}

// raise the block's dynamic shared-memory limit once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

struct Ragged {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int32_t *tables, *q_start, *q_len, *ctx_len;
  void* out;
  int R, H, KV, bs, W, max_q_len;
  // launch parameters (0 = the default): query slots per block, and keys
  // per staged chunk of the tensor-core kernel (64 or 128)
  int q_tile, kv_chunk;
  cudaStream_t stream;

  template <typename T, typename KT, int HD>
  cudaError_t run() const {
    const int G = H / KV;
    const float scale = 1.f / sqrtf((float)HD);
    const int qt = q_tile > 0 ? q_tile : max(1, min(max_q_len, kMaxRows / G));
    if (G > kMaxRows || qt * G > kMaxRows) return cudaErrorInvalidValue;
    if constexpr (std::is_same<T, float>::value) {
      if (kv_chunk != 0) return cudaErrorInvalidValue;  // 32-key chunks
      const int n_tiles = (max_q_len + qt - 1) / qt;
      const int nq = qt * G;
      const size_t smem =
          (size_t)(2 * nq * HD + 2 * nq + 2 * kKeys * (HD + 1)) *
          sizeof(float);
      auto kernel = ragged_paged_attention_f32_kernel<KT, HD>;
      static size_t allowed = 48 * 1024;
      const cudaError_t err = allow_smem(kernel, smem, &allowed);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(R, n_tiles, KV), kThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const KT*>(k),
          static_cast<const KT*>(v), ks, vs, tables, q_start, q_len, ctx_len,
          static_cast<float*>(out), H, KV, bs, W, qt, scale);
    } else {
      // quantized pages amortise their convert pass over 128 keys
      const int ch = kv_chunk > 0
                         ? kv_chunk
                         : (std::is_same<KT, __nv_bfloat16>::value ? 64 : 128);
      cudaError_t err = cudaErrorInvalidValue;
      if (ch == 64) err = run_mma<KT, HD, 64>(scale, qt);
      if (ch == 128) err = run_mma<KT, HD, 128>(scale, qt);
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }

  template <typename KT, int HD, int CH>
  cudaError_t run_mma(float scale, int qt) const {
    const int n_tiles = (max_q_len + qt - 1) / qt;
    constexpr size_t smem = mma_smem_bytes<KT, HD, CH>();
    auto kernel = ragged_paged_attention_mma_kernel<KT, HD, CH>;
    static size_t allowed = 48 * 1024;  // one limit per instantiation
    const cudaError_t err = allow_smem(kernel, smem, &allowed);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(KV, R, n_tiles), kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), ks, vs, tables, q_start, q_len, ctx_len,
        static_cast<__nv_bfloat16*>(out), H, KV, bs, W, qt,
        scale * kLog2e);
    return cudaSuccess;
  }
};

// raise the decode kernel's shared-memory limit, once, to what the
// largest G takes
template <typename T, typename KT, int HD>
cudaError_t prepare_decode() {
  static size_t allowed = 48 * 1024;
  return allow_smem(paged_attention_decode_split_kernel<T, KT, HD>,
                    DecodeLayout<KT, HD>::smem(kMaxG), &allowed);
}

struct Decode {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int32_t *tables, *seq_lens;
  void* out;
  float *part_acc, *part_ml;
  int* arrived;
  int B, H, KV, bs, W, n_split, span;
  cudaStream_t stream;

  template <typename T, typename KT, int HD>
  cudaError_t run() const {
    const int G = H / KV;
    if (G > kMaxG || n_split < 1 || span < kChunk || span % kChunk)
      return cudaErrorInvalidValue;
    const cudaError_t err = prepare_decode<T, KT, HD>();
    if (err != cudaSuccess) return err;
    paged_attention_decode_split_kernel<T, KT, HD>
        <<<dim3(n_split, KV, B), kThreads, DecodeLayout<KT, HD>::smem(G),
           stream>>>(
        static_cast<const T*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), ks, vs, tables, seq_lens, part_acc,
        part_ml, arrived, static_cast<T*>(out), H, KV, bs, W, span,
        // the tensor-core path (bf16 q) takes the scale in log2 units
        (std::is_same<T, float>::value ? 1.f : kLog2e) / sqrtf((float)HD));
    return cudaGetLastError();
  }
};

// blocks of the decode kernel that fit on one SM at once
struct DecodeOccupancy {
  int G;
  int* blocks;

  template <typename T, typename KT, int HD>
  cudaError_t run() const {
    if (G > kMaxG) return cudaErrorInvalidValue;
    const cudaError_t err = prepare_decode<T, KT, HD>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, paged_attention_decode_split_kernel<T, KT, HD>, kThreads,
        DecodeLayout<KT, HD>::smem(G));
  }
};

bool bad_dims(int R, int H, int KV, int bs, int W) {
  return R <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || W <= 0;
}

}  // namespace

// Ragged face. dtype: 0 = float32, 1 = bfloat16 (q, out and the pages).
// q_tile: query slots per block, 1 .. 64 / (H / KV) (0 = min(max_q_len,
// 64 / (H / KV))); kv_chunk: keys per staged chunk of bf16 queries, 64 or
// 128 (0 = 64 for bf16 pages, 128 for 1-byte pages; f32 queries take 0).
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* q_start, const void* q_len,
    const void* ctx_len, void* out, int R, int H, int KV, int hd, int bs,
    int W, int max_q_len, int q_tile, int kv_chunk, int dtype,
    void* stream) {
  if (bad_dims(R, H, KV, bs, W) || max_q_len <= 0 || q_tile < 0 ||
      kv_chunk < 0)
    return (int)cudaErrorInvalidValue;
  const Ragged f{q, k_cache, v_cache, nullptr, nullptr,
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(q_start),
                 static_cast<const int32_t*>(q_len),
                 static_cast<const int32_t*>(ctx_len), out, R, H, KV, bs, W,
                 max_q_len, q_tile, kv_chunk,
                 static_cast<cudaStream_t>(stream)};
  return (int)by_types(dtype, 0, hd, f);
}

// Quantized pages: kv_dtype 1 = int8, 2 = fp8 e4m3; k_scale / v_scale are
// [NB, KV, bs] f32. dtype as above, for q and out.
extern "C" int dtt_ragged_paged_attention_quant(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* q_start, const void* q_len,
    const void* ctx_len, void* out, const void* k_scale, const void* v_scale,
    int R, int H, int KV, int hd, int bs, int W, int max_q_len, int q_tile,
    int kv_chunk, int dtype, int kv_dtype, void* stream) {
  if (bad_dims(R, H, KV, bs, W) || max_q_len <= 0 || q_tile < 0 ||
      kv_chunk < 0 || (kv_dtype != 1 && kv_dtype != 2) || !k_scale ||
      !v_scale)
    return (int)cudaErrorInvalidValue;
  const Ragged f{q, k_cache, v_cache,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(q_start),
                 static_cast<const int32_t*>(q_len),
                 static_cast<const int32_t*>(ctx_len), out, R, H, KV, bs, W,
                 max_q_len, q_tile, kv_chunk,
                 static_cast<cudaStream_t>(stream)};
  return (int)by_types(dtype, kv_dtype, hd, f);
}

// Decode face: one query per row, seq_lens [B] int32 (0 = dead row).
// part_acc [B, KV, n_split, G, hd] and part_ml [B, KV, n_split, G, 2] f32
// are scratch; arrived [B * KV] int32 is zero before the call and after
// it; span is a multiple of 64 keys. One launch.
extern "C" int dtt_paged_attention_decode(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* seq_lens, void* out,
    void* part_acc, void* part_ml, void* arrived, int B, int H, int KV,
    int hd, int bs, int W, int n_split, int span, int dtype, void* stream) {
  if (bad_dims(B, H, KV, bs, W)) return (int)cudaErrorInvalidValue;
  const Decode f{q, k_cache, v_cache, nullptr, nullptr,
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(seq_lens), out,
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 static_cast<int*>(arrived), B, H, KV, bs, W, n_split, span,
                 static_cast<cudaStream_t>(stream)};
  return (int)by_types(dtype, 0, hd, f);
}

extern "C" int dtt_paged_attention_decode_quant(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* seq_lens, void* out,
    void* part_acc, void* part_ml, void* arrived, const void* k_scale,
    const void* v_scale, int B, int H, int KV, int hd, int bs, int W,
    int n_split, int span, int dtype, int kv_dtype, void* stream) {
  if (bad_dims(B, H, KV, bs, W) || (kv_dtype != 1 && kv_dtype != 2) ||
      !k_scale || !v_scale)
    return (int)cudaErrorInvalidValue;
  const Decode f{q, k_cache, v_cache,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(seq_lens), out,
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 static_cast<int*>(arrived), B, H, KV, bs, W, n_split, span,
                 static_cast<cudaStream_t>(stream)};
  return (int)by_types(dtype, kv_dtype, hd, f);
}

// Blocks of the decode kernel for (dtype, kv_dtype, hd, H / KV query heads
// per KV head) that one SM holds at once, into *blocks.
extern "C" int dtt_paged_attention_decode_occupancy(int H, int KV, int hd,
                                                    int dtype, int kv_dtype,
                                                    void* blocks) {
  if (KV <= 0 || H % KV != 0 || !blocks) return (int)cudaErrorInvalidValue;
  const DecodeOccupancy f{H / KV, static_cast<int*>(blocks)};
  return (int)by_types(dtype, kv_dtype, hd, f);
}
