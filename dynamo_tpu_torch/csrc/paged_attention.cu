// Ragged paged attention for Hopper (sm_90a), bound to Python with ctypes
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
// read — its staging slot is written as zeros — so it can neither contribute
// nor poison the sums; a zero softmax denominator divides as 1; every slot
// of a row's allotment with no valid query (q_len == 0 rows, slots past
// q_len) is written as exact zeros.
//
// Quantized KV: pages of int8 or fp8 (e4m3) with one f32 scale per (slot,
// KV head), [NB, KV, bs]. Staging converts each page element to f32 and
// multiplies it by its key's scale — the same single multiply as the plain
// version and the Pallas kernel, so the staged values are bitwise the
// dequantized cache. A key at or past the tile's causal frontier reads
// neither its page bytes nor its scale (trash scales may be NaN). Bound: one
// byte per element plus 4 bytes per (slot, head) for each of K and V, about
// half of bf16's bytes at hd 64; staging is the only change, so the f32
// arithmetic and the schedule are those of the bf16 kernel.
//
// What bounds it on an H100: decode reads every visible key and value once
// per KV head and does 4 flops per (query head, key, dim) — with G = 4 query
// heads per KV head that is ~2 flops per byte read, far below the ~295 the
// card needs to be compute-bound. Decode at B=64 over a 576-token context
// moves ~75 MB per layer launch, ~22 us at 3.35 TB/s: memory-bound. Prefill
// chunks (T <= 512 per row) reuse each staged key across up to 64 query rows
// and are bound by the f32 CUDA-core arithmetic of this first design.
//
// Design: one thread block per (row, query tile, KV head). The block loads
// its own row metadata and block-table entries (scalar prefetch has no
// Hopper counterpart), packs the G query heads of its KV head for up to
// q_tile query slots (at most 64 flat query rows), and walks the row's keys
// in chunks of 32 only up to the tile's causal frontier. Each chunk's K and
// V pages are staged in shared memory as f32 with a padded stride (no bank
// conflicts when a lane reads its key's row); each warp owns query rows,
// scores one key per lane, and keeps m, l and the f32 accumulator of its
// rows in shared memory. Output is written in the input type. Tensor-core
// MMA (wgmma), TMA staging and split-KV decode are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;        // keys per staged chunk: one per lane
constexpr int kMaxRows = 64;     // flat query rows (q slots x G) per block

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

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16 quantized page elements, dequantized: element times its key's scale
__device__ __forceinline__ void load16(const int8_t* src, float s,
                                       float* dst) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]) * s;
}

__device__ __forceinline__ void load16(const __nv_fp8_e4m3* src, float s,
                                       float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // e4m3 -> f16 -> f32 is exact; the low byte is the lower element
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3));
    const float2 f = __half22float2(h);
    dst[2 * i] = f.x * s;
    dst[2 * i + 1] = f.y * s;
  }
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

// KT is the page type: T itself, or int8_t / __nv_fp8_e4m3 with scales
template <typename T, typename KT, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q,                 // [Tq, H, HD]
    const KT* __restrict__ k_cache,          // [NB, KV, bs, HD]
    const KT* __restrict__ v_cache,          // [NB, KV, bs, HD]
    const float* __restrict__ k_scale,       // [NB, KV, bs] (quantized KT)
    const float* __restrict__ v_scale,       // [NB, KV, bs] (quantized KT)
    const int32_t* __restrict__ block_tables,  // [R, W]
    const int32_t* __restrict__ q_start,     // [R + 1]
    const int32_t* __restrict__ q_len,       // [R]
    const int32_t* __restrict__ ctx_len,     // [R]
    T* __restrict__ out,                     // [Tq, H, HD]
    int H, int KV, int bs, int W, int q_tile, float scale) {
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
      load16(q + ((size_t)(slot0 + qi) * H + kvh * G + j % G) * HD + c, dst);
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
          load16(k_cache + base, kd);
          load16(v_cache + base, vd);
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

template <typename T, typename KT, int HD>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const float* k_scale, const float* v_scale,
                   const int32_t* tables, const int32_t* q_start,
                   const int32_t* q_len, const int32_t* ctx_len, void* out,
                   int R, int H, int KV, int bs, int W, int max_q_len,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int q_tile = max(1, min(max_q_len, kMaxRows / G));
  const int n_tiles = (max_q_len + q_tile - 1) / q_tile;
  const int nq = q_tile * G;
  const size_t smem =
      (size_t)(2 * nq * HD + 2 * nq + 2 * kKeys * (HD + 1)) * sizeof(float);
  auto kernel = ragged_paged_attention_kernel<T, KT, HD>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const dim3 grid(R, n_tiles, KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_cache),
      static_cast<const KT*>(v_cache), k_scale, v_scale, tables, q_start,
      q_len, ctx_len, static_cast<T*>(out), H, KV, bs, W, q_tile,
      1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const float* ks, const float* vs,
                      const int32_t* tables, const int32_t* q_start,
                      const int32_t* q_len, const int32_t* ctx_len, void* out,
                      int R, int H, int KV, int bs, int W, int max_q_len,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, KT, 64>(q, k, v, ks, vs, tables, q_start, q_len,
                               ctx_len, out, R, H, KV, bs, W, max_q_len,
                               stream);
    case 128:
      return launch<T, KT, 128>(q, k, v, ks, vs, tables, q_start, q_len,
                                ctx_len, out, R, H, KV, bs, W, max_q_len,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// kv_dtype: 0 = pages in q's type, 1 = int8, 2 = fp8 e4m3 (with scales)
template <typename T>
cudaError_t launch_kv(int kv_dtype, int hd, const void* q, const void* k,
                      const void* v, const float* ks, const float* vs,
                      const int32_t* tables, const int32_t* q_start,
                      const int32_t* q_len, const int32_t* ctx_len, void* out,
                      int R, int H, int KV, int bs, int W, int max_q_len,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_hd<T, T>(hd, q, k, v, nullptr, nullptr, tables, q_start,
                             q_len, ctx_len, out, R, H, KV, bs, W, max_q_len,
                             stream);
    case 1:
      return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, tables, q_start,
                                  q_len, ctx_len, out, R, H, KV, bs, W,
                                  max_q_len, stream);
    case 2:
      return launch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, ks, vs, tables,
                                         q_start, q_len, ctx_len, out, R, H,
                                         KV, bs, W, max_q_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* k_scale, const void* v_scale,
             const void* block_tables, const void* q_start,
             const void* q_len, const void* ctx_len, void* out, int R, int H,
             int KV, int hd, int bs, int W, int max_q_len, int dtype,
             int kv_dtype, void* stream) {
  if (R <= 0 || KV <= 0 || H % KV != 0 || max_q_len <= 0 || bs <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* tables = static_cast<const int32_t*>(block_tables);
  const auto* qs = static_cast<const int32_t*>(q_start);
  const auto* ql = static_cast<const int32_t*>(q_len);
  const auto* cl = static_cast<const int32_t*>(ctx_len);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_kv<float>(kv_dtype, hd, q, k_cache, v_cache, ks, vs, tables,
                           qs, ql, cl, out, R, H, KV, bs, W, max_q_len, st);
  else if (dtype == 1)
    err = launch_kv<__nv_bfloat16>(kv_dtype, hd, q, k_cache, v_cache, ks, vs,
                                   tables, qs, ql, cl, out, R, H, KV, bs, W,
                                   max_q_len, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the pages). Returns a
// cudaError_t (0 = launched).
extern "C" int dtt_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* q_start, const void* q_len,
    const void* ctx_len, void* out, int R, int H, int KV, int hd, int bs,
    int W, int max_q_len, int dtype, void* stream) {
  return dispatch(q, k_cache, v_cache, nullptr, nullptr, block_tables,
                  q_start, q_len, ctx_len, out, R, H, KV, hd, bs, W,
                  max_q_len, dtype, 0, stream);
}

// Quantized pages: kv_dtype 1 = int8, 2 = fp8 e4m3; k_scale / v_scale are
// [NB, KV, bs] f32. dtype as above, for q and out.
extern "C" int dtt_ragged_paged_attention_quant(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* q_start, const void* q_len,
    const void* ctx_len, void* out, const void* k_scale, const void* v_scale,
    int R, int H, int KV, int hd, int bs, int W, int max_q_len, int dtype,
    int kv_dtype, void* stream) {
  if (kv_dtype != 1 && kv_dtype != 2) return (int)cudaErrorInvalidValue;
  return dispatch(q, k_cache, v_cache, k_scale, v_scale, block_tables,
                  q_start, q_len, ctx_len, out, R, H, KV, hd, bs, W,
                  max_q_len, dtype, kv_dtype, stream);
}
