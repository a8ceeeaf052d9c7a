// Decode attention of the LM for Hopper (sm_90a): few query rows a
// sequence against its KV cache, grouped-query, with per-row cache lengths,
// reading int8 codes with their scales or bf16 or float32 rows.
//
// No TPU kernel stands behind it. The reference attends over the cache
// with jnp ops (src/repro/nn/attention.py:82-123, gqa_attention, called
// from src/repro/models/lm/transformer.py:154-172): it dequantizes the
// whole int8 cache to the model's dtype (dequantize_symmetric), forms the
// logits q·kᵀ·hd^-0.5 over every cache position, masks at -1e30 beyond the
// causal bound q_offset + i and the valid length, takes a float32 softmax,
// rounds the probabilities to v's dtype and sums p·v in float32. In eager
// PyTorch the dequantize writes a copy of the whole cache on every step.
// Here the codes are dequantized in registers, exactly as the reference
// rounds them (bf16(code) · bf16(scale) rounded to bf16 in a bf16 model, a
// float32 product in a float32 one), and only the keys below each row's
// bound are read: masked keys have exp(-1e30 - max) = 0 in the reference.
//
// A decode step at long_500k has B · Hkv = 8 (sequence, kv head) pairs for
// 132 SMs, so the keys are cut into chunks of kChunk, one block a (chunk,
// sequence and kv head, tile of query rows), and the softmax is taken in
// passes that keep the reference's arithmetic (flash-decoding's split,
// without its rescaled partial sums, which would round otherwise):
//
//   1. scores: logits of the chunk's keys into a float32 scratch
//      (rows, T), and each row's chunk maximum;
//   2. sums: the row's maximum M over its chunks, then each chunk's sum of
//      exp(l - M);
//   3. values: the row's sum S over its chunks (in chunk order, the same in
//      every block), p = exp(l - M) / S rounded to v's dtype, and the
//      chunk's partial sum of p·v in float32;
//   4. combine: each output the sum of its chunks' partials in chunk order,
//      cast to q's dtype (pass 3 writes the output itself when T fits one
//      chunk).
//
// A key is read by LPK = hd / 4 neighbouring lanes, four elements each
// (one 4-, 8- or 16-byte load), so a warp reads 32 / LPK keys at a time
// and reduces each dot product with LPK-wide shuffles. A block holds up to
// kRows query rows (s × group of one kv head) and reads each key once for
// all of them.
//
// What bounds it on an H100 (3.35 TB/s): the bytes of the valid keys and
// values (read once each), the query rows and the output. The logits
// scratch adds 12 bytes a (row, key) over the three passes, against 2·hd
// bytes of int8 K and V a key: 9% of the traffic at hd = 128 and one row
// a kv head, more at larger groups.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // query rows a block (one kv head's)
constexpr int kChunk = 512;       // keys a block
constexpr int kMaxHd = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return round_bf16(x);
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements of a cache row as float32, dequantized in the
// model's dtype QT where the cache holds int8 codes.
template <typename QT, typename KT>
__device__ __forceinline__ void load4(const KT* p, float scale, float out[4]) {
  if constexpr (sizeof(KT) == 1) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    const float codes[4] = {static_cast<float>(c.x), static_cast<float>(c.y),
                            static_cast<float>(c.z), static_cast<float>(c.w)};
    const float sc = round_to<QT>(scale);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = round_to<QT>(__fmul_rn(codes[e], sc));
  } else if constexpr (sizeof(KT) == 2) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = __bfloat162float(h[e]);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
}

struct Geometry {
  int B, S, Hq, Hkv, T, hd, group;
  int off_stride, valid_stride;     // 0: one shared length; 1: (B,)
  int causal, n_chunks;
};

// The row's exclusive bound on key positions: min(valid, q_offset + i + 1)
// (causal), clamped to [0, T].
__device__ __forceinline__ int row_limit(const Geometry& g, const int* off,
                                         const int* valid, int b, int i) {
  int lim = valid[b * g.valid_stride];
  if (g.causal) lim = min(lim, off[b * g.off_stride] + i + 1);
  return min(max(lim, 0), g.T);
}

// The block's tile, in shared memory (indexed by row in loops, it would
// otherwise live in local memory): its rows' global ids ((b * S + i) * Hq
// + qh for row r = i * group + g of kv head kvh), their bounds, their
// count and the largest bound. Every thread calls it.
struct Tile {
  long long row[kRows];
  int lim[kRows];
  int n;
  int max_lim;
};

__device__ __forceinline__ void load_tile(Tile& t, const Geometry& g,
                                          const int* off, const int* valid,
                                          int b, int kvh, int tile) {
  const int n = min(kRows, g.S * g.group - tile * kRows);
  if (threadIdx.x < kRows) {
    const int j = threadIdx.x;
    const int r = tile * kRows + min(j, n - 1);
    const int i = r / g.group;
    t.row[j] = (static_cast<long long>(b) * g.S + i) * g.Hq
               + kvh * g.group + r % g.group;
    t.lim[j] = j < n ? row_limit(g, off, valid, b, i) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int j = 0; j < n; ++j) m = max(m, t.lim[j]);
    t.n = n;
    t.max_lim = m;
  }
  __syncthreads();
}

__device__ __forceinline__ int chunks_of(int lim) {
  return (lim + kChunk - 1) / kChunk;
}

// Each row's maximum over its chunks, and (with ``sums``) its sum over
// them in chunk order, into shared memory: one thread a row.
__device__ __forceinline__ void row_stats(const Tile& t, const Geometry& g,
                                          const float* cmax,
                                          const float* csum, float* s_m,
                                          float* s_s) {
  if (threadIdx.x < t.n) {
    const int j = threadIdx.x;
    const int n = chunks_of(t.lim[j]);
    float m = -INFINITY, s = 0.0f;
    for (int c = 0; c < n; ++c) m = fmaxf(m, cmax[t.row[j] * g.n_chunks + c]);
    if (csum != nullptr) {
      for (int c = 0; c < n; ++c) s += csum[t.row[j] * g.n_chunks + c];
    }
    s_m[j] = m;
    s_s[j] = s;
  }
  __syncthreads();
}

// Pass 1. Grid (n_chunks, B * Hkv, row tiles).
template <typename QT, typename KT, int LPK>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const float* __restrict__ k_scale, const int* __restrict__ off,
              const int* __restrict__ valid, Geometry g, float sm_scale,
              float* __restrict__ logits, float* __restrict__ cmax) {
  constexpr int kHd = 4 * LPK, kKeysPerWarp = 32 / LPK;
  __shared__ float s_q[kRows][kHd];
  __shared__ float s_max[kWarps][kRows];
  __shared__ Tile tile;
  const int c = blockIdx.x;
  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;      // no row reads this chunk
  const int t1 = min(t0 + kChunk, tile.max_lim);
  const int n = tile.n;
  for (int x = threadIdx.x; x < kRows * kHd; x += kThreads) {
    const int j = x / kHd, d = x % kHd;
    s_q[j][d] = to_float(q[tile.row[j] * kHd + d]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  const float scale = k_scale == nullptr ? 0.0f
                                         : k_scale[b * g.Hkv + kvh];
  float m[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) m[j] = -INFINITY;
  for (int base = t0 + warp * kKeysPerWarp; base < t1;
       base += kWarps * kKeysPerWarp) {
    const int t = base + grp;
    float kf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (t < t1) {
      load4<QT>(k + ((static_cast<long long>(b) * g.T + t) * g.Hkv + kvh) *
                        kHd + 4 * sub, scale, kf);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < n) {                      // block-uniform: shuffles stay whole
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(s_q[j][4 * sub + e], kf[e], acc);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        }
        const float l = acc * sm_scale;
        if (sub == 0 && t < tile.lim[j]) {
          logits[tile.row[j] * g.T + t] = l;
          m[j] = fmaxf(m[j], l);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    float x = m[j];
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) s_max[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int j = threadIdx.x;
    float x = s_max[0][j];
    for (int w = 1; w < kWarps; ++w) x = fmaxf(x, s_max[w][j]);
    cmax[tile.row[j] * g.n_chunks + c] = x;
  }
}

// Pass 2. Grid as pass 1.
__global__ void __launch_bounds__(kThreads)
sums_kernel(const int* __restrict__ off, const int* __restrict__ valid,
            Geometry g, const float* __restrict__ logits,
            const float* __restrict__ cmax, float* __restrict__ csum) {
  __shared__ float s_part[kWarps];
  __shared__ float s_m[kRows], s_s[kRows];
  __shared__ Tile tile;
  const int c = blockIdx.x;
  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;
  row_stats(tile, g, cmax, nullptr, s_m, s_s);
  for (int j = 0; j < tile.n; ++j) {
    const int t1 = min(t0 + kChunk, tile.lim[j]);
    float s = 0.0f;
    for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
      s += expf(logits[tile.row[j] * g.T + t] - s_m[j]);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x % 32 == 0) s_part[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.0f;
      for (int w = 0; w < kWarps; ++w) tot += s_part[w];
      csum[tile.row[j] * g.n_chunks + c] = tot;
    }
    __syncthreads();
  }
}

// Pass 3. Grid as pass 1. PT: the type the probabilities round to (v's).
// The chunk's probabilities are formed once, a thread each, into shared
// memory; the warps then read them against their keys' values.
template <typename QT, typename KT, typename PT, int LPK>
__global__ void __launch_bounds__(kThreads)
values_kernel(const KT* __restrict__ v, const float* __restrict__ v_scale,
              const int* __restrict__ off, const int* __restrict__ valid,
              Geometry g, const float* __restrict__ logits,
              const float* __restrict__ cmax, const float* __restrict__ csum,
              float* __restrict__ part, QT* __restrict__ out) {
  constexpr int kHd = 4 * LPK, kKeysPerWarp = 32 / LPK;
  // the probabilities (kRows × kChunk), then the warps' partial sums
  // (kWarps × kRows × kHd) in the same bytes
  constexpr int kProbs = kRows * kChunk, kAcc = kWarps * kRows * kHd;
  __shared__ float s_buf[kProbs > kAcc ? kProbs : kAcc];
  __shared__ float s_m[kRows], s_s[kRows];
  __shared__ Tile tile;
  const int c = blockIdx.x;
  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;
  const int t1 = min(t0 + kChunk, tile.max_lim);
  const int n = tile.n;
  row_stats(tile, g, cmax, csum, s_m, s_s);
  for (int x = threadIdx.x; x < n * kChunk; x += kThreads) {
    const int j = x / kChunk, t = t0 + x % kChunk;
    float p = 0.0f;                     // past the row's bound: no weight
    if (t < tile.lim[j]) {
      const float e = expf(logits[tile.row[j] * g.T + t] - s_m[j]);
      p = round_to<PT>(__fdiv_rn(e, s_s[j]));
    }
    s_buf[x] = p;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  const float scale = v_scale == nullptr ? 0.0f
                                         : v_scale[b * g.Hkv + kvh];
  float acc[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  for (int base = t0 + warp * kKeysPerWarp; base < t1;
       base += kWarps * kKeysPerWarp) {
    const int t = base + grp;
    if (t >= t1) continue;              // no shuffle below: may diverge
    float vf[4];
    load4<QT>(v + ((static_cast<long long>(b) * g.T + t) * g.Hkv + kvh) *
                      kHd + 4 * sub, scale, vf);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < n) {
        const float p = s_buf[j * kChunk + (t - t0)];
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] = fmaf(p, vf[x], acc[j][x]);
      }
    }
  }
  __syncthreads();                      // every warp has read the probabilities
  // the warp's key groups, then the warps
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1) {
        acc[j][x] += __shfl_xor_sync(0xffffffffu, acc[j][x], o);
      }
      if (grp == 0) s_buf[(warp * kRows + j) * kHd + 4 * sub + x] = acc[j][x];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n * kHd; x += kThreads) {
    const int j = x / kHd, d = x % kHd;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_buf[(w * kRows + j) * kHd + d];
    if (g.n_chunks == 1) {
      out[tile.row[j] * kHd + d] = from_float<QT>(s);
    } else {
      part[(static_cast<long long>(c) * g.B * g.S * g.Hq + tile.row[j]) * kHd
           + d] = s;
    }
  }
}

// Pass 4. One thread an output element.
template <typename QT, int LPK>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ off, const int* __restrict__ valid,
               Geometry g, const float* __restrict__ part,
               QT* __restrict__ out) {
  constexpr int kHd = 4 * LPK;
  const long long n_rows = static_cast<long long>(g.B) * g.S * g.Hq;
  const long long x = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (x >= n_rows * kHd) return;
  const long long row = x / kHd;
  const int d = static_cast<int>(x % kHd);
  const int i = static_cast<int>((row / g.Hq) % g.S);
  const int b = static_cast<int>(row / (static_cast<long long>(g.Hq) * g.S));
  const int n = chunks_of(row_limit(g, off, valid, b, i));
  float s = 0.0f;
  for (int c = 0; c < n; ++c) s += part[(c * n_rows + row) * kHd + d];
  out[row * kHd + d] = from_float<QT>(s);
}

template <typename QT, typename KT, int LPK>
int run(const void* q, const void* k, const void* v, const float* k_scale,
        const float* v_scale, const int* off, const int* valid, Geometry g,
        float sm_scale, float* logits, float* cmax, float* csum, float* part,
        void* out, cudaStream_t st) {
  using PT = typename std::conditional<sizeof(KT) == 1, QT, KT>::type;
  const int tiles = (g.S * g.group + kRows - 1) / kRows;
  const dim3 grid(g.n_chunks, g.B * g.Hkv, tiles);
  const QT* qq = static_cast<const QT*>(q);
  scores_kernel<QT, KT, LPK><<<grid, kThreads, 0, st>>>(qq, static_cast<const KT*>(k), k_scale, off, valid, g, sm_scale, logits, cmax);
  sums_kernel<<<grid, kThreads, 0, st>>>(off, valid, g, logits, cmax, csum);
  values_kernel<QT, KT, PT, LPK><<<grid, kThreads, 0, st>>>(static_cast<const KT*>(v), v_scale, off, valid, g, logits, cmax, csum, part, static_cast<QT*>(out));
  if (g.n_chunks > 1) {
    const long long n = static_cast<long long>(g.B) * g.S * g.Hq * g.hd;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    combine_kernel<QT, LPK><<<blocks, kThreads, 0, st>>>(off, valid, g, part, static_cast<QT*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int by_width(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* off, const int* valid, Geometry g,
             float sm_scale, float* logits, float* cmax, float* csum,
             float* part, void* out, cudaStream_t st) {
  switch (g.hd) {
    case 16:
      return run<QT, KT, 4>(q, k, v, ks, vs, off, valid, g, sm_scale, logits,
                            cmax, csum, part, out, st);
    case 32:
      return run<QT, KT, 8>(q, k, v, ks, vs, off, valid, g, sm_scale, logits,
                            cmax, csum, part, out, st);
    case 64:
      return run<QT, KT, 16>(q, k, v, ks, vs, off, valid, g, sm_scale, logits,
                             cmax, csum, part, out, st);
    case 128:
      return run<QT, KT, 32>(q, k, v, ks, vs, off, valid, g, sm_scale, logits,
                             cmax, csum, part, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int by_cache(int cache_type, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int* off,
             const int* valid, Geometry g, float sm_scale, float* logits,
             float* cmax, float* csum, float* part, void* out,
             cudaStream_t st) {
  switch (cache_type) {
    case 0:
      return by_width<QT, int8_t>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                  logits, cmax, csum, part, out, st);
    case 1:
      return by_width<QT, __nv_bfloat16>(q, k, v, ks, vs, off, valid, g,
                                         sm_scale, logits, cmax, csum, part,
                                         out, st);
    case 2:
      return by_width<QT, float>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                 logits, cmax, csum, part, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys a block reads: the wrapper sizes the scratch by it.
extern "C" int decode_attention_chunk() { return kChunk; }

// q (B, S, Hq, hd) of q_type (1 = bf16, 2 = float32), also the output's
// type; k, v (B, T, Hkv, hd) of cache_type (0 = int8 with k_scale, v_scale
// (B, 1, Hkv, 1) float32; 1 = bf16; 2 = float32); q_offset and valid int32,
// each with stride 0 (shared) or 1 ((B,)). Scratch: logits (B·S·Hq, T),
// cmax and csum (B·S·Hq, n_chunks), part (n_chunks, B·S·Hq, hd), float32.
// Returns the launches' cudaError_t.
extern "C" int decode_attention(const void* q, int q_type, const void* k,
                                const void* v, int cache_type,
                                const float* k_scale, const float* v_scale,
                                const int* q_offset, int off_stride,
                                const int* valid, int valid_stride, int B,
                                int S, int Hq, int Hkv, int T, int hd,
                                float sm_scale, int causal, float* logits,
                                float* cmax, float* csum, float* part,
                                void* out, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      hd > kMaxHd) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((cache_type == 0) != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{B, S, Hq, Hkv, T, hd, Hq / Hkv, off_stride, valid_stride,
             causal, (T + kChunk - 1) / kChunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_type) {
    case 1:
      return by_cache<__nv_bfloat16>(cache_type, q, k, v, k_scale, v_scale,
                                     q_offset, valid, g, sm_scale, logits,
                                     cmax, csum, part, out, st);
    case 2:
      return by_cache<float>(cache_type, q, k, v, k_scale, v_scale, q_offset,
                             valid, g, sm_scale, logits, cmax, csum, part,
                             out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
