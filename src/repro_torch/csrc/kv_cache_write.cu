// KV-cache write of the LM's decode path for Hopper (sm_90a): one layer's
// new keys (or values) written into its cache at each row's length, with
// the int8 cache's running-absmax scales kept.
//
// No TPU kernel stands behind it. The reference writes the cache with
// jnp ops (src/repro/models/lm/transformer.py:196-245, LM._cache_write and
// LM._requant_cache): a dynamic_update_slice, and for an int8 cache the
// absmax scale calibration, a lax.cond that rewrites the *whole* cache onto
// the new grid when any scale grew, and the projection of the new values.
// In eager PyTorch that cond is either a host sync (which a CUDA graph
// cannot hold) or a rewrite on every step. Here the lengths and scales are
// read on the device and nothing waits on the host:
//
//   - every block reads its row's length len_b (a scalar or a (B,) vector)
//     and, for an int8 cache, forms obs = max(max|vals[b, :, h, :]| *
//     (1/127), 1e-8) for its (b, h) (jitted XLA turns the division by the
//     constant 127 into a multiply by its float32 reciprocal, so the
//     kernels do too) and the new scale: obs where len_b == 0 (a fresh or
//     recycled slot re-seeds) and otherwise max(scale, obs);
//   - int8 only, a grid of (b, h, piece of kPiece positions) blocks
//     (``kv_requant_kernel``, launched first) re-projects the valid prefix
//     [0, len_b) of each (b, h) whose scale grew on a row already holding
//     codes, rint(code * (old / new)) clipped to ±127, every piece at once.
//     The reference rewrites every row when any scale grew, but a row
//     whose scale did not grow has ratio 1 and rint(code * 1) == code, and
//     a re-seeded row's prefix is empty: so the valid prefixes are
//     bit-identical to the reference's. Its blocks where no scale grew
//     exit after reading the new values;
//   - then one block per (b, h) (``kv_cache_write_kernel``) writes the new
//     values at the start, clamped to [0, T - s] as dynamic_update_slice
//     clamps it (an idle slot that finished at max_len still writes,
//     inside its row): int8 codes rint(v / scale) clipped to ±127 (a true
//     division, as jitted XLA keeps it) or the values cast to the cache's
//     type (round to nearest even), and stores the new scale.
//
// What bounds it on an H100 (3.35 TB/s): the bytes it must move, the new
// values read once and written once into the cache (s * hd each a row and
// head), plus the prefix re-projection where a scale grew (read and
// written once, spread over the pieces' blocks). A decode step's write is
// a few hundred bytes a block: the launches, not the bytes, are its cost,
// and they run inside the decode cell's CUDA graph.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 4096;               // prefix positions a block re-projects
constexpr float kInv127 = 1.0f / 127.0f;   // XLA's reciprocal of the constant
constexpr float kMinScale = 1e-8f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t clip_code(float x) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -127.0f), 127.0f));
}

// The (b, h) block's scale after this write: obs of its new values, and
// the stored scale where the row already holds codes. Every thread of the
// block calls it and gets the block's value.
template <typename VT>
__device__ __forceinline__ float fresh_scale(const VT* vals, float old,
                                             int len, int b, int h, int S,
                                             int H, int hd) {
  __shared__ float s_max[kThreads / 32];
  const long long n_new = static_cast<long long>(S) * hd;
  float m = 0.0f;
  for (long long j = threadIdx.x; j < n_new; j += kThreads) {
    const long long i = j / hd, c = j % hd;
    m = fmaxf(m, fabsf(to_float(
        vals[((static_cast<long long>(b) * S + i) * H + h) * hd + c])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = s_max[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_max[w]);
  const float obs = fmaxf(__fmul_rn(m, kInv127), kMinScale);
  return len == 0 ? obs : fmaxf(old, obs);
}

// Re-projection of the valid prefix where the scale grows. Grid (B * H,
// pieces of kPiece positions); launched before kv_cache_write_kernel,
// which then stores the scale it reads here.
template <typename VT>
__global__ void __launch_bounds__(kThreads)
kv_requant_kernel(const VT* __restrict__ vals, int8_t* __restrict__ cache,
                  const float* __restrict__ scale,
                  const int* __restrict__ lens, int len_stride, int S, int T,
                  int H, int hd) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int len = min(lens[b * len_stride], T);
  const long long t0 = static_cast<long long>(blockIdx.y) * kPiece;
  if (len <= 0 || t0 >= len) return;   // nothing stored here to move
  const float old = scale[blockIdx.x];
  const float fresh = fresh_scale(vals, old, len, b, h, S, H, hd);
  if (!(fresh > old)) return;          // block-uniform: the scale stays
  const float ratio = __fdiv_rn(old, fresh);
  const long long t1 = min(t0 + kPiece, static_cast<long long>(len));
  const long long n = (t1 - t0) * hd;
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    int8_t& code = cache[((static_cast<long long>(b) * T + t0 + j / hd) * H
                          + h) * hd + j % hd];
    code = clip_code(__fmul_rn(static_cast<float>(code), ratio));
  }
}

// The new values' write and the scale's store. One block per (b, h):
// blockIdx.x = b * H + h.
template <typename VT, typename CT>
__global__ void __launch_bounds__(kThreads)
kv_cache_write_kernel(const VT* __restrict__ vals, CT* __restrict__ cache,
                      float* __restrict__ scale, const int* __restrict__ lens,
                      int len_stride, int S, int T, int H, int hd) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int len = lens[b * len_stride];
  const int start = min(max(len, 0), T - S);
  const long long n_new = static_cast<long long>(S) * hd;
  auto val_at = [&](long long j) {
    const long long i = j / hd, c = j % hd;
    return to_float(vals[((static_cast<long long>(b) * S + i) * H + h) * hd + c]);
  };
  auto cache_at = [&](long long t, long long c) -> CT& {
    return cache[((static_cast<long long>(b) * T + t) * H + h) * hd + c];
  };
  if constexpr (sizeof(CT) != 1) {
    for (long long j = threadIdx.x; j < n_new; j += kThreads) {
      cache_at(start + j / hd, j % hd) = from_float<CT>(val_at(j));
    }
  } else {
    const float old = scale[blockIdx.x];
    const float fresh = fresh_scale(vals, old, len, b, h, S, H, hd);
    for (long long j = threadIdx.x; j < n_new; j += kThreads) {
      cache_at(start + j / hd, j % hd) = clip_code(__fdiv_rn(val_at(j), fresh));
    }
    __syncthreads();                      // every thread has read ``old``
    if (threadIdx.x == 0) scale[blockIdx.x] = fresh;
  }
}

template <typename VT, typename CT>
int launch(const void* vals, void* cache, float* scale, const int* lens,
           int len_stride, int B, int S, int T, int H, int hd,
           cudaStream_t stream) {
  if constexpr (sizeof(CT) == 1) {
    const dim3 pieces(B * H, (T + kPiece - 1) / kPiece);
    kv_requant_kernel<VT><<<pieces, kThreads, 0, stream>>>(static_cast<const VT*>(vals), static_cast<int8_t*>(cache), scale, lens, len_stride, S, T, H, hd);
  }
  kv_cache_write_kernel<VT, CT><<<B * H, kThreads, 0, stream>>>(static_cast<const VT*>(vals), static_cast<CT*>(cache), scale, lens, len_stride, S, T, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int dispatch_cache(int cache_type, const void* vals, void* cache, float* scale,
                   const int* lens, int len_stride, int B, int S, int T, int H,
                   int hd, cudaStream_t stream) {
  switch (cache_type) {
    case 0:
      return launch<VT, int8_t>(vals, cache, scale, lens, len_stride, B, S, T,
                                H, hd, stream);
    case 1:
      return launch<VT, __nv_bfloat16>(vals, cache, scale, lens, len_stride,
                                       B, S, T, H, hd, stream);
    case 2:
      return launch<VT, float>(vals, cache, scale, lens, len_stride, B, S, T,
                               H, hd, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// vals (B, S, H, hd) of type val_type (1 = bf16, 2 = float32); cache
// (B, T, H, hd) of type cache_type (0 = int8, 1 = bf16, 2 = float32);
// scale (B, 1, H, 1) float32 (int8 caches only, else null); lens int32,
// len_stride 0 for one shared length, 1 for a (B,) vector. Returns the
// launch's cudaError_t.
extern "C" int kv_cache_write(const void* vals, int val_type, void* cache,
                              int cache_type, float* scale, const int* lens,
                              int len_stride, int B, int S, int T, int H,
                              int hd, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > T || hd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((cache_type == 0) != (scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (val_type) {
    case 1:
      return dispatch_cache<__nv_bfloat16>(cache_type, vals, cache, scale,
                                           lens, len_stride, B, S, T, H, hd,
                                           st);
    case 2:
      return dispatch_cache<float>(cache_type, vals, cache, scale, lens,
                                   len_stride, B, S, T, H, hd, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
