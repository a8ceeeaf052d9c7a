// KV-cache write of the LM's decode path for Hopper (sm_90a): one layer's
// new keys and values written into its caches at each row's length, with
// the int8 caches' running-absmax scales kept.
//
// No TPU kernel stands behind it. The reference writes the cache with
// jnp ops (src/repro/models/lm/transformer.py:196-245, LM._cache_write and
// LM._requant_cache): a dynamic_update_slice, and for an int8 cache the
// absmax scale calibration, a lax.cond that rewrites the *whole* cache onto
// the new grid when any scale grew, and the projection of the new values.
// In eager PyTorch that cond is either a host sync (which a CUDA graph
// cannot hold) or a rewrite on every step. Here the lengths and scales are
// read on the device and nothing waits on the host.
//
// The arithmetic, per (cache, b, h), is the plain version's bit for bit:
// obs = max(max|vals[b, :, h, :]| * (1/127), 1e-8) (jitted XLA turns the
// division by the constant 127 into a multiply by its float32 reciprocal,
// so the kernels do too); the new scale is obs where len_b == 0 (a fresh
// or recycled slot re-seeds) and max(scale, obs) otherwise; where it grew
// on a row already holding codes, the stored codes of [0, start) are
// re-projected, rint(code * (old / new)) clipped to ±127; the new values
// go to [start, start + s), start = len_b clamped to [0, T - s] as
// dynamic_update_slice clamps it, as codes rint(v / scale) clipped to ±127
// (a true division, as jitted XLA keeps it) or cast to the cache's type
// (round to nearest even). The reference rewrites every row when any scale
// grew, but a row whose scale did not grow has ratio 1 and rint(code * 1)
// == code, a re-seeded row's prefix is empty, and the reference's
// re-projected codes in [start, len_b) (a length past T - s) are
// overwritten by the new ones: so re-projecting [0, start) where the scale
// grew gives the reference's valid prefix, and the two ranges are
// disjoint, so one launch may write both.
//
// Two routes, chosen by the wrapper from s * hd (a route, not a fallback):
//
//   - decode (s * hd <= kSmallWork): one launch for a layer's keys and
//     values (``kv_decode_kernel``), grid (cache x b x h, prefix slots). A
//     block of slot y is live if y < min(gridDim.y, pieces of kPiece
//     positions in [0, start)), block 0 always; the others exit after
//     reading the length. A live block forms its (b, h)'s absmax from the
//     few new values with one warp, block 0 writes the new codes, and every
//     live block re-projects its pieces if the scale grew. The new scale
//     may be stored only once every live block has read the old one (a
//     block that read the new one would see no growth and skip its
//     pieces): each live block takes a ticket (an int32 per (cache, b, h)
//     in the wrapper's scratch) after reading it, and the last stores the
//     scale and puts the ticket back to 0, so that a CUDA-graph replay
//     starts clean.
//   - prefill (larger s): the work spreads over positions, not over B * H.
//     For an int8 cache ``kv_absmax_kernel`` reduces each (cache, b, h)'s
//     new values over pieces of kPos positions into an int32 (float bits
//     of a non-negative maximum, so atomicMax is exact and order-free); the
//     last block of a (cache, b, h), by ticket, forms the scale, keeps the
//     old one in the scratch, stores the new one and puts its slots back
//     to 0. Then ``kv_write_kernel``, grid (cache x b x h, pieces of the new
//     positions + pieces of the prefix), writes the codes (or values) and
//     re-projects [0, start) where the scale grew. A float cache takes the
//     second kernel alone.
//
// Loads and stores are 8 values a thread (16-byte bf16 loads, 8-byte int8
// stores; 16-byte code vectors in the re-projection) where hd % 8 == 0 (16)
// and the tensors are aligned, with 32-bit index math where every offset
// fits, otherwise one value a thread with 64-bit offsets; the
// re-projection loads four code vectors a thread before it stores any.
//
// What bounds it on an H100 (3.35 TB/s): the bytes it must move, the new
// values read once and written once into the cache (s * hd each a row and
// head), plus the prefix re-projection where a scale grew (read and
// written once). A decode step's write is a few hundred bytes a block: the
// launch, not the bytes, is its cost, and it runs inside the decode cell's
// CUDA graph, once a layer.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallWork = 4096;   // s * hd at most on the decode route
constexpr int kPiece = 1024;       // prefix positions a decode block takes at once
constexpr int kPos = 128;          // positions a prefill block takes
constexpr int kDecodeBlocks = 4 * 132;   // blocks the decode route aims at
constexpr int kMaxPrefixBlocks = 64;     // prefix slots of a prefill (c, b, h)
constexpr int kBatch = 4;    // code vectors a thread re-projects at once
constexpr float kInv127 = 1.0f / 127.0f;   // XLA's reciprocal of the constant
constexpr float kMinScale = 1e-8f;

struct KvArgs {
  const void* vals[2];   // (B, S, H, hd) each
  void* cache[2];        // (B, T, H, hd) each
  float* scale[2];       // (B, 1, H, 1) each, int8 caches only
  const int* lens;       // one shared length (len_stride 0) or (B,)
  int* scratch;          // int8 only: tickets, maxima (0 between launches)
                         // and kept old scales, n_slots int32 each
  int len_stride;
  int n_slots;           // caches x B x H
  int B, S, T, H, hd;
  int wide_codes;        // 16-byte code vectors in the re-projection
};

__device__ __forceinline__ int8_t clip_code(float x) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a))
         | static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8
         | static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16
         | static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// V consecutive values as floats (V = 8: one 16-byte bf16 load or two
// float4 loads).
template <typename VT, int V>
__device__ __forceinline__ void load_vals(const VT* p, float (&x)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<VT, float>) {
      x[0] = p[0];
    } else {
      x[0] = __bfloat162float(p[0]);
    }
  } else if constexpr (std::is_same_v<VT, float>) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// V values into a float cache, cast to its type (round to nearest even).
template <typename CT, int V>
__device__ __forceinline__ void store_vals(CT* p, const float (&x)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<CT, float>) {
      p[0] = x[0];
    } else {
      p[0] = __float2bfloat16_rn(x[0]);
    }
  } else if constexpr (std::is_same_v<CT, float>) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// V codes rint(x / scale) clipped to ±127 into an int8 cache.
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&x)[V],
                                            float scale) {
  int8_t c[V];
#pragma unroll
  for (int k = 0; k < V; ++k) c[k] = clip_code(__fdiv_rn(x[k], scale));
  if constexpr (V == 1) {
    p[0] = c[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(c[0], c[1], c[2], c[3]),
                                              pack4(c[4], c[5], c[6], c[7]));
  }
}

__device__ __forceinline__ uint32_t requant4(uint32_t w, float ratio) {
  int8_t c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float code = static_cast<float>(
        static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * k))));
    c[k] = clip_code(__fmul_rn(code, ratio));
  }
  return pack4(c[0], c[1], c[2], c[3]);
}

// The (b, i, h, col) offset of a (B, N, H, hd) tensor.
template <typename I>
__device__ __forceinline__ I offset(const KvArgs& a, int n, int b, int i,
                                    int h, int col) {
  return ((static_cast<I>(b) * n + i) * a.H + h) * a.hd + col;
}

// The row's new positions [i0, i1) of one (b, h): the values at
// [start + i0, start + i1) of the cache, as codes on ``scale`` for an int8
// cache. Threads ``tid`` of ``nt`` share them, V values each.
template <typename VT, typename CT, int V, typename I>
__device__ __forceinline__ void write_new(const KvArgs& a, const VT* vals,
                                          CT* cache, int b, int h, int start,
                                          int i0, int i1, float scale,
                                          int tid, int nt) {
  const int per_row = a.hd / V;
  const int n = (i1 - i0) * per_row;
#pragma unroll 4
  for (int j = tid; j < n; j += nt) {
    const int i = i0 + j / per_row;
    const int col = (j % per_row) * V;
    float x[V];
    load_vals<VT, V>(vals + offset<I>(a, a.S, b, i, h, col), x);
    CT* dst = cache + offset<I>(a, a.T, b, start + i, h, col);
    if constexpr (sizeof(CT) == 1) {
      store_codes<V>(dst, x, scale);
    } else {
      store_vals<CT, V>(dst, x);
    }
  }
}

// Re-projection of the stored codes at positions [t0, t1) of one (b, h)
// onto the grid ``ratio`` = old / new coarser; the block's threads share
// them, 16 codes a thread where ``a.wide_codes`` (kBatch vectors loaded
// before any is stored), else one.
template <typename I>
__device__ __forceinline__ void requant(const KvArgs& a, int8_t* cache, int b,
                                        int h, int t0, int t1, float ratio) {
  if (a.wide_codes) {
    const int per_row = a.hd / 16;
    const int n = (t1 - t0) * per_row;
    for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
      uint4 u[kBatch];
      uint4* p[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int j = j0 + r * kThreads;
        p[r] = reinterpret_cast<uint4*>(
            cache + offset<I>(a, a.T, b, t0 + j / per_row, h,
                              (j % per_row) * 16));
        if (j < n) u[r] = *p[r];
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        if (j0 + r * kThreads < n) {
          *p[r] = make_uint4(requant4(u[r].x, ratio), requant4(u[r].y, ratio),
                             requant4(u[r].z, ratio), requant4(u[r].w, ratio));
        }
      }
    }
  } else {
    const int n = (t1 - t0) * a.hd;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      int8_t& code = cache[offset<I>(a, a.T, b, t0 + j / a.hd, h, j % a.hd)];
      code = clip_code(__fmul_rn(static_cast<float>(code), ratio));
    }
  }
}

// The decode route: one launch for the layer. blockIdx.x = (c * B + b) * H
// + h, blockIdx.y a prefix slot.
template <typename VT, typename CT, int V, typename I>
__global__ void __launch_bounds__(kThreads)
kv_decode_kernel(const __grid_constant__ KvArgs a) {
  const int slot = blockIdx.x;
  const int bh_n = a.B * a.H;
  const int c = slot / bh_n;
  const int b = (slot - c * bh_n) / a.H;
  const int h = slot % a.H;
  const int len = a.lens[b * a.len_stride];
  const int start = min(max(len, 0), a.T - a.S);
  const VT* vals = static_cast<const VT*>(a.vals[c]);
  CT* cache = static_cast<CT*>(a.cache[c]);
  if constexpr (sizeof(CT) != 1) {
    write_new<VT, CT, V, I>(a, vals, cache, b, h, start, 0, a.S, 0.0f,
                            threadIdx.x, kThreads);
  } else {
    const int prefix = len > 0 ? start : 0;   // codes a growth re-projects
    const int pieces = (prefix + kPiece - 1) / kPiece;
    const int live = max(1, min(static_cast<int>(gridDim.y), pieces));
    if (static_cast<int>(blockIdx.y) >= live) return;
    const int bh = slot - c * bh_n;
    __shared__ float s_old, s_fresh;
    if (threadIdx.x < 32) {
      const int per_row = a.hd / V;
      float m = 0.0f;
      for (int j = threadIdx.x; j < a.S * per_row; j += 32) {
        float x[V];
        load_vals<VT, V>(vals + offset<I>(a, a.S, b, j / per_row, h,
                                          (j % per_row) * V), x);
#pragma unroll
        for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(x[k]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (threadIdx.x == 0) {
        const float old = a.scale[c][bh];
        const float obs = fmaxf(__fmul_rn(m, kInv127), kMinScale);
        s_old = old;
        s_fresh = len == 0 ? obs : fmaxf(old, obs);
      }
    }
    __syncthreads();
    const float old = s_old, fresh = s_fresh;
    if (threadIdx.x == 0) {
      if (live == 1) {
        a.scale[c][bh] = fresh;            // the slot's only block
      } else {
        // this block has read the old scale; the last live one stores the
        // new one
        int* ticket = a.scratch + slot;
        __threadfence();
        if (atomicAdd(ticket, 1) == live - 1) {
          atomicExch(ticket, 0);
          a.scale[c][bh] = fresh;
        }
      }
    }
    if (blockIdx.y == 0) {
      write_new<VT, CT, V, I>(a, vals, cache, b, h, start, 0, a.S, fresh,
                              threadIdx.x, kThreads);
    }
    if (fresh > old && prefix > 0) {   // block-uniform: the scale grew
      const float ratio = __fdiv_rn(old, fresh);
      for (int p = blockIdx.y; p < pieces; p += live) {
        requant<I>(a, cache, b, h, p * kPiece, min((p + 1) * kPiece, prefix),
                   ratio);
      }
    }
  }
}

// The prefill route's scales: blockIdx.x a (cache, b, h) slot, blockIdx.y a
// piece of kPos new positions. The last block of a slot stores its scale.
template <typename VT, int V, typename I>
__global__ void __launch_bounds__(kThreads)
kv_absmax_kernel(const __grid_constant__ KvArgs a) {
  __shared__ float s_max[kThreads / 32];
  const int slot = blockIdx.x;
  const int bh_n = a.B * a.H;
  const int c = slot / bh_n;
  const int bh = slot - c * bh_n;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const VT* vals = static_cast<const VT*>(a.vals[c]);
  const int i0 = blockIdx.y * kPos;
  const int i1 = min(i0 + kPos, a.S);
  const int per_row = a.hd / V;
  const int n = (i1 - i0) * per_row;
  float m = 0.0f;
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float x[V];
    load_vals<VT, V>(vals + offset<I>(a, a.S, b, i0 + j / per_row, h,
                                      (j % per_row) * V), x);
#pragma unroll
    for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(x[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_max[w]);
  int* ticket = a.scratch + slot;
  int* amax = a.scratch + a.n_slots + slot;
  int* kept = a.scratch + 2 * a.n_slots + slot;
  atomicMax(amax, __float_as_int(m));   // m >= 0: its bits order as ints
  __threadfence();
  if (atomicAdd(ticket, 1) != static_cast<int>(gridDim.y) - 1) return;
  __threadfence();
  const float mx = __int_as_float(atomicExch(amax, 0));
  atomicExch(ticket, 0);
  const int len = a.lens[b * a.len_stride];
  const float old = a.scale[c][bh];
  const float obs = fmaxf(__fmul_rn(mx, kInv127), kMinScale);
  *kept = __float_as_int(old);
  a.scale[c][bh] = len == 0 ? obs : fmaxf(old, obs);
}

// The prefill route's write: blockIdx.y < n_new a piece of kPos new
// positions, past it a slot of the prefix re-projection (int8 caches).
template <typename VT, typename CT, int V, typename I>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(const __grid_constant__ KvArgs a, int n_new) {
  const int slot = blockIdx.x;
  const int bh_n = a.B * a.H;
  const int c = slot / bh_n;
  const int bh = slot - c * bh_n;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int len = a.lens[b * a.len_stride];
  const int start = min(max(len, 0), a.T - a.S);
  CT* cache = static_cast<CT*>(a.cache[c]);
  const int y = blockIdx.y;
  if (y < n_new) {
    float fresh = 0.0f;
    if constexpr (sizeof(CT) == 1) fresh = a.scale[c][bh];
    write_new<VT, CT, V, I>(a, static_cast<const VT*>(a.vals[c]), cache, b, h,
                            start, y * kPos, min((y + 1) * kPos, a.S), fresh,
                            threadIdx.x, kThreads);
    return;
  }
  if constexpr (sizeof(CT) == 1) {
    const int prefix = len > 0 ? start : 0;
    if (prefix == 0) return;
    const float fresh = a.scale[c][bh];
    const float old = __int_as_float(a.scratch[2 * a.n_slots + slot]);
    if (!(fresh > old)) return;
    const float ratio = __fdiv_rn(old, fresh);
    const int stride = static_cast<int>(gridDim.y) - n_new;
    for (int p = y - n_new; p * kPos < prefix; p += stride) {
      requant<I>(a, cache, b, h, p * kPos, min((p + 1) * kPos, prefix),
                 ratio);
    }
  }
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

template <typename VT, typename CT, int V, typename I>
int launch(const KvArgs& a, cudaStream_t stream) {
  const long long s_work = static_cast<long long>(a.S) * a.hd;
  if (s_work <= kSmallWork) {
    int ny = 1;
    if constexpr (sizeof(CT) == 1) {
      const int pieces = ceil_div(a.T - a.S, kPiece);
      ny = max(1, min(pieces, ceil_div(kDecodeBlocks, a.n_slots)));
    }
    kv_decode_kernel<VT, CT, V, I><<<dim3(a.n_slots, ny), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_new = ceil_div(a.S, kPos);
  int n_prefix = 0;
  if constexpr (sizeof(CT) == 1) {
    kv_absmax_kernel<VT, V, I><<<dim3(a.n_slots, n_new), kThreads, 0, stream>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    n_prefix = min(ceil_div(a.T - a.S, kPos), kMaxPrefixBlocks);
  }
  kv_write_kernel<VT, CT, V, I><<<dim3(a.n_slots, n_new + n_prefix), kThreads, 0, stream>>>(a, n_new);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT, typename CT>
int dispatch_width(const KvArgs& a, bool vec, bool small, cudaStream_t st) {
  if (!vec) return launch<VT, CT, 1, long long>(a, st);
  return small ? launch<VT, CT, 8, int>(a, st)
               : launch<VT, CT, 8, long long>(a, st);
}

template <typename VT>
int dispatch_cache(int cache_type, const KvArgs& a, bool vec, bool small,
                   cudaStream_t st) {
  switch (cache_type) {
    case 0: return dispatch_width<VT, int8_t>(a, vec, small, st);
    case 1: return dispatch_width<VT, __nv_bfloat16>(a, vec, small, st);
    case 2: return dispatch_width<VT, float>(a, vec, small, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// s * hd at most on the decode route (one launch; the prefill route takes
// two for an int8 cache): the wrapper counts launches by it.
extern "C" int kv_cache_write_small_work() { return kSmallWork; }

// One layer's write: n_caches (1 or 2) caches, each with its values and,
// for int8 caches, its scale. vals (B, S, H, hd) of type val_type (1 =
// bf16, 2 = float32); caches (B, T, H, hd) of type cache_type (0 = int8, 1
// = bf16, 2 = float32); scales (B, 1, H, 1) float32 (int8 caches only,
// else null); lens int32, len_stride 0 for one shared length, 1 for a (B,)
// vector; scratch (int8 caches only): 3 x n_caches x B x H int32, zero,
// left zero. Returns the last launch's cudaError_t.
extern "C" int kv_cache_write(int n_caches, const void* vals0,
                              const void* vals1, int val_type, void* cache0,
                              void* cache1, int cache_type, float* scale0,
                              float* scale1, const int* lens, int len_stride,
                              int* scratch, int B, int S, int T, int H,
                              int hd, void* stream) {
  if (n_caches < 1 || n_caches > 2 || B <= 0 || H <= 0 || S <= 0 || S > T
      || hd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool int8 = cache_type == 0;
  if (int8 != (scale0 != nullptr) || (int8 && scratch == nullptr)
      || (n_caches == 2 && (int8 != (scale1 != nullptr) || vals1 == nullptr
                            || cache1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slots = static_cast<long long>(n_caches) * B * H;
  if (slots >= (1ll << 31) / 3 || static_cast<long long>(S) * hd >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KvArgs a{};
  a.vals[0] = vals0;
  a.vals[1] = vals1;
  a.cache[0] = cache0;
  a.cache[1] = cache1;
  a.scale[0] = scale0;
  a.scale[1] = scale1;
  a.lens = lens;
  a.scratch = scratch;
  a.len_stride = len_stride;
  a.n_slots = static_cast<int>(slots);
  a.B = B;
  a.S = S;
  a.T = T;
  a.H = H;
  a.hd = hd;
  bool vec = hd % 8 == 0;
  bool wide = hd % 16 == 0;
  for (int i = 0; i < n_caches; ++i) {
    vec = vec && aligned(a.vals[i], 16) && aligned(a.cache[i], 16);
    wide = wide && aligned(a.cache[i], 16);
  }
  a.wide_codes = int8 && wide ? 1 : 0;
  const long long most = static_cast<long long>(B) * T * H * hd;
  const bool small = most < (1ll << 31);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (val_type) {
    case 1: return dispatch_cache<__nv_bfloat16>(cache_type, a, vec, small, st);
    case 2: return dispatch_cache<float>(cache_type, a, vec, small, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
