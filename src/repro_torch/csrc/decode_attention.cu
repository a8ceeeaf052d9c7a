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
// What bounds it on an H100 (3.35 TB/s): the bytes of the valid keys and
// values (read once each), the query rows and the output; at group 2 there
// are about two multiply-adds a byte. So the design is about bytes in
// flight. Each lane moves 16 bytes a load: LPK = hd · size / 16 lanes carry
// a key (8 at hd 128 in int8), a warp reads 32 / LPK keys a load, and a
// warp's step issues KL loads (8 at up to two rows a tile) before it uses
// any, 4 KB a warp in flight at hd 128. The int8 codes become bf16 pairs in
// four integer and two bf16 operations a word (0x43 | low seven bits, less
// 128 or 256 by the sign bit: exact), and one bf16 multiply a pair by the
// scale rounds each product as the reference does. The query rows live in
// registers. In the scores pass a step's dot products (KL keys' partials
// in each of a key's LPK lanes) are reduced by a reduce-scatter over those
// lanes (LPK - 1 shuffles a row for KL keys where KL = LPK, against 3 a key
// by xor trees), which leaves each lane one key's logit: the warp writes a
// step's 32 logits of a row as one 128-byte line. In the values pass a
// warp forms a step's probabilities once, a lane each, into shared memory,
// and each lane keeps its E elements' float32 sums for every row until the
// chunk ends. Blocks whose chunk starts past every row's bound exit at
// once: at the slotted lane's short contexts a 32,768-key cache is 16
// chunks, one of which reads.
//
// The logits scratch adds 12 bytes a (row, key) over the three passes,
// against 2·hd bytes of int8 K and V a key: 9% of the traffic at hd = 128
// and one row a kv head, more at larger groups.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;      // keys a block
constexpr int kMaxHd = 128;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, sizeof(r));
  return r;
}
__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 x) {
  unsigned r;
  memcpy(&r, &x, sizeof(r));
  return r;
}
// the two float32 values of a bf16 pair's bits
__device__ __forceinline__ void unpack_bf16(unsigned u, float* out) {
  out[0] = __uint_as_float(u << 16);
  out[1] = __uint_as_float(u & 0xffff0000u);
}

// The geometry of a key row: E elements a 16-byte load, LPK lanes a key,
// KPW keys a warp's load, KL loads a step of STEP keys (at most 32).
template <typename KT, int HD, int R>
struct Shape {
  static constexpr int E = 16 / static_cast<int>(sizeof(KT));
  static constexpr int LPK = HD / E;
  static constexpr int KPW = 32 / LPK;
  static constexpr int KLMAX = R <= 2 ? 8 : 4;
  static constexpr int KL = LPK < KLMAX ? LPK : KLMAX;
  static constexpr int STEP = KL * KPW;
  static_assert(LPK >= 1 && LPK <= 32 && STEP <= 32, "unsupported width");
};

// 16 bytes of a cache row as E float32 values, dequantized in the model's
// dtype QT where the cache holds int8 codes.
template <typename QT, typename KT>
struct Dequant {
  float scale;        // the scale rounded to QT
  unsigned scale2;    // and as a bf16 pair (QT = bf16)

  __device__ explicit Dequant(float s) : scale(round_to<QT>(s)), scale2(0) {
    if constexpr (sizeof(KT) == 1 && sizeof(QT) == 2) {
      scale2 = as_u32(__float2bfloat162_rn(s));
    }
  }

  __device__ __forceinline__ void operator()(const uint4& raw,
                                             float* out) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (sizeof(KT) == 1 && sizeof(QT) == 2) {
      // x = (128 + low7) - (bit 7 ? 256 : 128), exact in bf16; then
      // bf16(x · scale) by one bf16 multiply
      const __nv_bfloat162 sc = as_bf162(scale2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned lo = w[i] & 0x7f7f7f7fu, hi = w[i] & 0x80808080u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned sel = h == 0 ? 0x4140u : 0x4342u;
          const __nv_bfloat162 a = as_bf162(__byte_perm(lo, 0x43434343u, sel));
          const __nv_bfloat162 b = as_bf162(__byte_perm(hi, 0x43434343u, sel));
          unpack_bf16(as_u32(__hmul2(__hsub2(a, b), sc)), out + 4 * i + 2 * h);
        }
      }
    } else if constexpr (sizeof(KT) == 1) {
      // 2^23 + (code + 128) by a byte permute, less 2^23 + 128: exact;
      // then the float32 product, rounded once
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = __uint_as_float(__byte_perm(u, 0x4b000000u,
                                                      0x7440u + e));
          out[4 * i + e] = __fmul_rn(f - 8388736.0f, scale);
        }
      }
    } else if constexpr (sizeof(KT) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack_bf16(w[i], out + 2 * i);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
    }
  }
};

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

// The block's tile of R query rows, in shared memory: their global ids
// ((b * S + i) * Hq + qh for row r = i * group + g of kv head kvh), their
// bounds (0 past the tile's n rows), n and the largest bound. Every thread
// calls it.
template <int R>
struct Tile {
  long long row[R];
  int lim[R];
  int n;
  int max_lim;
};

template <int R>
__device__ __forceinline__ void load_tile(Tile<R>& t, const Geometry& g,
                                          const int* off, const int* valid,
                                          int b, int kvh, int tile) {
  const int n = min(R, g.S * g.group - tile * R);
  if (threadIdx.x < R) {
    const int j = threadIdx.x;
    const int r = tile * R + min(j, n - 1);
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
template <int R>
__device__ __forceinline__ void row_stats(const Tile<R>& t, const Geometry& g,
                                          const float* cmax,
                                          const float* csum, float* s_m,
                                          float* s_s) {
  if (threadIdx.x < t.n) {
    const int j = threadIdx.x;
    const int n = chunks_of(t.lim[j]);
    const float* mx = cmax + t.row[j] * g.n_chunks;
    float m = -INFINITY, s = 0.0f;
    for (int c = 0; c < n; ++c) m = fmaxf(m, mx[c]);
    if (csum != nullptr) {
      const float* sm = csum + t.row[j] * g.n_chunks;
      for (int c = 0; c < n; ++c) s += sm[c];
    }
    s_m[j] = m;
    s_s[j] = s;
  }
  __syncthreads();
}

// A reduce-scatter of KL values a row over the LPK lanes of a key: halving
// rounds (partner lane ^ D) while more than one value is left, then plain
// xor rounds. Lane sub ends with v[0] the full sum of value sub·KL / LPK.
template <int D, int N, int KL, int R>
__device__ __forceinline__ void reduce_scatter(float (&v)[KL][R], int sub) {
  if constexpr (D >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = (sub & D) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float send = upper ? v[i][j] : v[i + H][j];
          const float keep = upper ? v[i + H][j] : v[i][j];
          v[i][j] = keep + __shfl_xor_sync(kFull, send, D);
        }
      }
      reduce_scatter<D / 2, H, KL, R>(v, sub);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[0][j] += __shfl_xor_sync(kFull, v[0][j], D);
      reduce_scatter<D / 2, 1, KL, R>(v, sub);
    }
  }
}

template <typename KT>
__device__ __forceinline__ uint4 load16(const KT* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Pass 1. Grid (B * Hkv, n_chunks, row tiles): the blocks in flight at
// once are every kv head of a few chunks, whose keys share DRAM pages.
template <typename QT, typename KT, int HD, int R>
__global__ void __launch_bounds__(kThreads, 2)
scores_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const float* __restrict__ k_scale, const int* __restrict__ off,
              const int* __restrict__ valid, Geometry g, float sm_scale,
              float* __restrict__ logits, float* __restrict__ cmax) {
  using Sh = Shape<KT, HD, R>;
  constexpr int E = Sh::E, LPK = Sh::LPK, KPW = Sh::KPW, KL = Sh::KL;
  __shared__ float s_max[kWarps][R];
  __shared__ Tile<R> tile;
  const int c = blockIdx.y;
  const int b = blockIdx.x / g.Hkv, kvh = blockIdx.x % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;      // no row reads this chunk
  const int t1 = min(t0 + kChunk, tile.max_lim);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  float qf[R][E];
  int lim[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    lim[j] = tile.lim[j];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[j][e] = j < tile.n ? to_float(q[tile.row[j] * HD + sub * E + e])
                            : 0.0f;
    }
  }
  const Dequant<QT, KT> dq(k_scale == nullptr ? 0.0f
                                              : k_scale[b * g.Hkv + kvh]);
  const long long stride = static_cast<long long>(g.Hkv) * HD;
  const KT* kp = k + (static_cast<long long>(b) * g.T * g.Hkv + kvh) * HD
                 + sub * E;
  float m[R];
#pragma unroll
  for (int j = 0; j < R; ++j) m[j] = -INFINITY;
  const bool writer = (sub * KL) % LPK == 0;   // the first of equal lanes
  const int mine = sub * KL / LPK;             // its key load after the scatter
  for (int base = t0 + warp * Sh::STEP; base < t1;
       base += kWarps * Sh::STEP) {
    uint4 raw[KL];
#pragma unroll
    for (int u = 0; u < KL; ++u) {
      const int t = base + u * KPW + grp;
      raw[u] = t < t1 ? load16(kp + t * stride) : make_uint4(0, 0, 0, 0);
    }
    float v[KL][R];
#pragma unroll
    for (int u = 0; u < KL; ++u) {
      float kf[E];
      dq(raw[u], kf);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc = fmaf(qf[j][e], kf[e], acc);
        v[u][j] = acc;
      }
    }
    reduce_scatter<LPK / 2, KL, KL, R>(v, sub);
    const int t = base + mine * KPW + grp;
    if (writer && t < t1) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (t < lim[j]) {
          const float l = v[0][j] * sm_scale;
          logits[tile.row[j] * g.T + t] = l;
          m[j] = fmaxf(m[j], l);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float x = m[j];
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
    if (lane == 0) s_max[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < tile.n) {
    const int j = threadIdx.x;
    float x = s_max[0][j];
    for (int w = 1; w < kWarps; ++w) x = fmaxf(x, s_max[w][j]);
    cmax[tile.row[j] * g.n_chunks + c] = x;
  }
}

// Pass 2. Grid as pass 1.
template <int R>
__global__ void __launch_bounds__(kThreads)
sums_kernel(const int* __restrict__ off, const int* __restrict__ valid,
            Geometry g, const float* __restrict__ logits,
            const float* __restrict__ cmax, float* __restrict__ csum) {
  __shared__ float s_part[kWarps];
  __shared__ float s_m[R], s_s[R];
  __shared__ Tile<R> tile;
  const int c = blockIdx.y;
  const int b = blockIdx.x / g.Hkv, kvh = blockIdx.x % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;
  row_stats(tile, g, cmax, nullptr, s_m, s_s);
  for (int j = 0; j < tile.n; ++j) {
    const int t1 = min(t0 + kChunk, tile.lim[j]);
    const float* l = logits + tile.row[j] * g.T;
    float s = 0.0f;
    for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
      s += expf(l[t] - s_m[j]);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
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
// A warp forms each step's probabilities once, a lane a key, into shared
// memory; its lanes then weigh their keys' values by them.
template <typename QT, typename KT, typename PT, int HD, int R>
__global__ void __launch_bounds__(kThreads, 2)
values_kernel(const KT* __restrict__ v, const float* __restrict__ v_scale,
              const int* __restrict__ off, const int* __restrict__ valid,
              Geometry g, const float* __restrict__ logits,
              const float* __restrict__ cmax, const float* __restrict__ csum,
              float* __restrict__ part, QT* __restrict__ out) {
  using Sh = Shape<KT, HD, R>;
  constexpr int E = Sh::E, LPK = Sh::LPK, KPW = Sh::KPW, KL = Sh::KL;
  __shared__ float s_p[kWarps][R][32];
  __shared__ float s_acc[kWarps][R][HD];
  __shared__ float s_m[R], s_s[R];
  __shared__ Tile<R> tile;
  const int c = blockIdx.y;
  const int b = blockIdx.x / g.Hkv, kvh = blockIdx.x % g.Hkv;
  load_tile(tile, g, off, valid, b, kvh, blockIdx.z);
  const int t0 = c * kChunk;
  if (t0 >= tile.max_lim) return;
  const int t1 = min(t0 + kChunk, tile.max_lim);
  const int n = tile.n;
  row_stats(tile, g, cmax, csum, s_m, s_s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  float rm[R], rs[R];
  int lim[R];
  const float* lrow[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    rm[j] = j < n ? s_m[j] : 0.0f;
    rs[j] = j < n ? s_s[j] : 1.0f;
    lim[j] = tile.lim[j];
    lrow[j] = logits + tile.row[j] * g.T;
  }
  const Dequant<QT, KT> dq(v_scale == nullptr ? 0.0f
                                              : v_scale[b * g.Hkv + kvh]);
  const long long stride = static_cast<long long>(g.Hkv) * HD;
  const KT* vp = v + (static_cast<long long>(b) * g.T * g.Hkv + kvh) * HD
                 + sub * E;
  float acc[R][E];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.0f;
  }
  for (int base = t0 + warp * Sh::STEP; base < t1;
       base += kWarps * Sh::STEP) {
    uint4 raw[KL];
#pragma unroll
    for (int u = 0; u < KL; ++u) {
      const int t = base + u * KPW + grp;
      raw[u] = t < t1 ? load16(vp + t * stride) : make_uint4(0, 0, 0, 0);
    }
    // the step's probabilities: lane x the key base + x; none past a
    // row's bound
    if (lane < Sh::STEP) {
      const int t = base + lane;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float p = 0.0f;
        if (t < lim[j]) {
          p = round_to<PT>(__fdiv_rn(expf(lrow[j][t] - rm[j]), rs[j]));
        }
        s_p[warp][j][lane] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < KL; ++u) {
      float vf[E];
      dq(raw[u], vf);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = s_p[warp][j][u * KPW + grp];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
    __syncwarp();                       // before the next step's probabilities
  }
  // the warp's key groups, then the warps in order
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], o);
      }
      if (grp == 0) s_acc[warp][j][sub * E + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n * HD; x += kThreads) {
    const int j = x / HD, d = x % HD;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_acc[w][j][d];
    if (g.n_chunks == 1) {
      out[tile.row[j] * HD + d] = from_float<QT>(s);
    } else {
      part[(static_cast<long long>(c) * g.B * g.S * g.Hq + tile.row[j]) * HD
           + d] = s;
    }
  }
}

// Pass 4. One thread an output element: its chunks' partials in chunk
// order, kAhead loads in flight.
template <typename QT, int HD>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ off, const int* __restrict__ valid,
               Geometry g, const float* __restrict__ part,
               QT* __restrict__ out) {
  constexpr int kAhead = 32;
  const long long n_rows = static_cast<long long>(g.B) * g.S * g.Hq;
  const long long x = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (x >= n_rows * HD) return;
  const long long row = x / HD;
  const int i = static_cast<int>((row / g.Hq) % g.S);
  const int b = static_cast<int>(row / (static_cast<long long>(g.Hq) * g.S));
  const int n = chunks_of(row_limit(g, off, valid, b, i));
  const long long stride = n_rows * HD;
  const float* p = part + x;
  float s = 0.0f;
  for (int c = 0; c < n; c += kAhead) {
    float y[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      y[u] = c + u < n ? p[(c + u) * stride] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c + u < n) s += y[u];
    }
  }
  out[x] = from_float<QT>(s);
}

struct Buffers {
  float *logits, *cmax, *csum, *part;
};

template <typename QT, typename KT, int HD, int R>
int run(const void* q, const void* k, const void* v, const float* k_scale,
        const float* v_scale, const int* off, const int* valid, Geometry g,
        float sm_scale, Buffers buf, void* out, cudaStream_t st) {
  using PT = typename std::conditional<sizeof(KT) == 1, QT, KT>::type;
  const int tiles = (g.S * g.group + R - 1) / R;
  if (g.n_chunks > 65535 || tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(g.B * g.Hkv, g.n_chunks, tiles);
  const QT* qq = static_cast<const QT*>(q);
  const KT* kk = static_cast<const KT*>(k);
  const KT* vv = static_cast<const KT*>(v);
  QT* o = static_cast<QT*>(out);
  scores_kernel<QT, KT, HD, R><<<grid, kThreads, 0, st>>>(qq, kk, k_scale, off, valid, g, sm_scale, buf.logits, buf.cmax);
  sums_kernel<R><<<grid, kThreads, 0, st>>>(off, valid, g, buf.logits, buf.cmax, buf.csum);
  values_kernel<QT, KT, PT, HD, R><<<grid, kThreads, 0, st>>>(vv, v_scale, off, valid, g, buf.logits, buf.cmax, buf.csum, buf.part, o);
  if (g.n_chunks > 1) {
    const long long n = static_cast<long long>(g.B) * g.S * g.Hq * HD;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    combine_kernel<QT, HD><<<blocks, kThreads, 0, st>>>(off, valid, g, buf.part, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tiles of up to two rows (one query row a kv head at group 1 or 2), else
// of four.
template <typename QT, typename KT, int HD>
int by_rows(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* off, const int* valid, Geometry g,
            float sm_scale, Buffers buf, void* out, cudaStream_t st) {
  if (g.S * g.group <= 2) {
    return run<QT, KT, HD, 2>(q, k, v, ks, vs, off, valid, g, sm_scale, buf,
                              out, st);
  }
  return run<QT, KT, HD, 4>(q, k, v, ks, vs, off, valid, g, sm_scale, buf,
                            out, st);
}

template <typename QT, typename KT>
int by_width(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* off, const int* valid, Geometry g,
             float sm_scale, Buffers buf, void* out, cudaStream_t st) {
  switch (g.hd) {
    case 16:
      return by_rows<QT, KT, 16>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                 buf, out, st);
    case 32:
      return by_rows<QT, KT, 32>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                 buf, out, st);
    case 64:
      return by_rows<QT, KT, 64>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                 buf, out, st);
    case 128:
      return by_rows<QT, KT, 128>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                  buf, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int by_cache(int cache_type, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int* off,
             const int* valid, Geometry g, float sm_scale, Buffers buf,
             void* out, cudaStream_t st) {
  switch (cache_type) {
    case 0:
      return by_width<QT, int8_t>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                  buf, out, st);
    case 1:
      return by_width<QT, __nv_bfloat16>(q, k, v, ks, vs, off, valid, g,
                                         sm_scale, buf, out, st);
    case 2:
      return by_width<QT, float>(q, k, v, ks, vs, off, valid, g, sm_scale,
                                 buf, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys a block reads: the wrapper sizes the scratch by it.
extern "C" int decode_attention_chunk() { return kChunk; }

// q (B, S, Hq, hd) of q_type (1 = bf16, 2 = float32), also the output's
// type; k, v (B, T, Hkv, hd) of cache_type (0 = int8 with k_scale, v_scale
// (B, 1, Hkv, 1) float32; 1 = bf16; 2 = float32), 16-byte aligned; q_offset
// and valid int32, each with stride 0 (shared) or 1 ((B,)). Scratch: logits
// (B·S·Hq, T), cmax and csum (B·S·Hq, n_chunks), part (n_chunks, B·S·Hq,
// hd), float32. Returns the launches' cudaError_t.
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
  const Buffers buf{logits, cmax, csum, part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_type) {
    case 1:
      return by_cache<__nv_bfloat16>(cache_type, q, k, v, k_scale, v_scale,
                                     q_offset, valid, g, sm_scale, buf, out,
                                     st);
    case 2:
      return by_cache<float>(cache_type, q, k, v, k_scale, v_scale, q_offset,
                             valid, g, sm_scale, buf, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
