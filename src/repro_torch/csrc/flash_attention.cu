// Flash attention for Hopper (sm_90a), float32: the online-softmax forward
// (with or without the logsumexp rows) and the backward that recomputes the
// probabilities from the stored logsumexp.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (_flash_kernel), flash_attention_fwd_stats
// (_flash_fwd_stats_kernel) and flash_attention_bwd (_flash_bwd_kernel).
// Layout (BH, S, hd), row-major, hd <= 128, any S >= 1.
//
// Numerics, as the TPU kernels compute them:
//   s = (q . k) * scale, scale = hd^-0.5 applied after the dot product;
//   causal: s = -1e30 where key > query;
//   running max m and denominator den in float32, o = acc / max(den, 1e-30);
//   lse = m + log(max(den, 1e-30));
//   backward: p = exp(s - lse), dp = do . v, ds = p * (dp - delta) * scale,
//   with delta = rowsum(do * o) formed by the caller.
// expf and logf are the accurate ones: build without --use_fast_math.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores): at SASRec's shape (S = 50, hd = 50, causal) bytes. One
// (BH, S, hd) float32 tensor is 655.36 MB at the train_batch cell
// (BH = 65,536): the forward reads q, k, v and writes o (0.782 ms), the
// backward reads q, k, v, do, lse, delta and writes dq, dk, dv (1.377 ms);
// the causal products need about a third of those times at 67 TFLOP/s.
//
// Design (simple and right first; SIMT FMAs, no wgmma: hd = 50 is not a
// multiple of 16). Tiles of kTile = 64 query rows and 64 key rows live in
// shared memory with an odd row stride (no bank conflicts when 16 threads
// read 16 different rows at one column); rows past S are zero. 256 threads
// per block: thread t owns rows rg*4 .. rg*4+3 (rg = t / 16) of a tile and
// columns cg + 16*j (cg = t % 16) of a score tile (j < 4) or of an output
// tile (j < NC, NC*16 >= hd). A row's scores lie in the 16 lanes of one half
// warp, so its max and sum are taken with shuffles.
//
// Forward: one block per (bh, query tile). It walks the key tiles in order,
// skipping those wholly above the diagonal, and keeps m, den and acc in
// registers; probabilities pass through shared memory to the P.V product.
//
// Backward: one block per bh walks the key tiles in order; for each it keeps
// dk and dv of its 64 key rows in registers over the query tiles (from the
// diagonal on, when causal) and adds each query tile's dq contribution to dq
// in device memory, which only this block and only the same thread touch (a
// read-modify-write in a fixed order, where the TPU revisited dq's output
// block). No float atomics: repeat runs give the same bits.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // query rows and key rows of a tile
constexpr int kThreads = 256;       // 16 row groups x 16 column groups
constexpr int kMaxHeadDim = 128;
constexpr int kPLd = kTile + 1;     // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;   // the TPU kernels' mask value
constexpr float kMinDen = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// Odd row stride of a (kTile, hd) tile in shared memory.
__host__ __device__ __forceinline__ int tile_ld(int hd) { return hd | 1; }

// Rows [row0, row0 + kTile) of a (S, hd) matrix into dst (stride ld); rows
// at or past S become 0. Consecutive threads read consecutive floats.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int s, int hd, int ld) {
  const int n = kTile * hd;
  const float* from = src + static_cast<size_t>(row0) * hd;
  const int valid = (s - row0) * hd;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / hd;
    dst[r * ld + (e - r * hd)] = e < valid ? from[e] : 0.f;
  }
}

// acc[i][j] = sum_d a[(rg*4 + i) * ld + d] * b[(cg + 16*j) * ld + d], in
// order of d, each term one fused multiply-add.
__device__ __forceinline__ void dot_tile(float (&acc)[4][4],
                                         const float* a, const float* b,
                                         int hd, int ld, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const float* ar = a + rg * 4 * ld;
  const float* br = b + cg * ld;
#pragma unroll 2
  for (int d = 0; d < hd; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ar[i * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = br[16 * j * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

// Max and sum over the 16 lanes of a half warp (one row group).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

size_t fwd_smem_bytes(int hd) {
  return (3 * static_cast<size_t>(kTile) * tile_ld(hd) + kTile * kPLd) *
         sizeof(float);
}

size_t bwd_smem_bytes(int hd) {
  return (4 * static_cast<size_t>(kTile) * tile_ld(hd) + 2 * kTile * kPLd +
          2 * kTile) * sizeof(float);
}

// grid (BH, ceil(S / kTile)); lse may be null when kStats is false.
template <int NC, bool kStats>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int s, int hd, float scale,
                 int causal, float* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int ld = tile_ld(hd);
  float* sq = smem;
  float* sk = sq + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sp = sv + kTile * ld;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * hd;
  const int q0 = blockIdx.y * kTile;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile(sq, q + base, q0, s, hd, ld);
  float m[4], den[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // keys past the last query row of the tile are all masked when causal
  const int k_end = causal ? min(q0 + kTile, s) : s;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of sk, sv, sp are done
    load_tile(sk, k + base, k0, s, hd, ld);
    load_tile(sv, v + base, k0, s, hd, ld);
    __syncthreads();
    float sc[4][4];
    dot_tile(sc, sq, sk, hd, ld, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = sc[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        sc[i][j] = x;
        if (col < s) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        const float p = col < s ? expf(sc[i][j] - m_new) : 0.f;
        sp[(rg * 4 + i) * kPLd + cg + 16 * j] = p;
        sum += p;
      }
      den[i] = den[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const int n_keys = min(kTile, s - k0);
    for (int j = 0; j < n_keys; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(rg * 4 + i) * kPLd + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cg + 16 * c;
        vv[c] = col < hd ? sv[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= s) continue;
    const float dd = fmaxf(den[i], kMinDen);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg + 16 * c;
      if (col < hd) o[base + static_cast<size_t>(row) * hd + col] = acc[i][c] / dd;
    }
    if (kStats && cg == 0) {
      lse[static_cast<size_t>(blockIdx.x) * s + row] = m[i] + logf(dd);
    }
  }
}

// grid (BH): one block walks every key tile of its bh.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int s, int hd, float scale,
                 int causal, float* __restrict__ dq, float* __restrict__ dk,
                 float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int ld = tile_ld(hd);
  float* sk = smem;
  float* sv = sk + kTile * ld;
  float* sq = sv + kTile * ld;
  float* sdo = sq + kTile * ld;
  float* sp = sdo + kTile * ld;
  float* sds = sp + kTile * kPLd;
  float* slse = sds + kTile * kPLd;
  float* sdelta = slse + kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * hd;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * s;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();  // the previous key tile's readers of sk, sv are done
    load_tile(sk, k + base, k0, s, hd, ld);
    load_tile(sv, v + base, k0, s, hd, ld);
    float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
    }
    const int n_k = min(kTile, s - k0);
    // query rows before k0 see none of these keys when causal
    for (int q0 = causal ? k0 : 0; q0 < s; q0 += kTile) {
      __syncthreads();  // the previous query tile's readers are done
      load_tile(sq, q + base, q0, s, hd, ld);
      load_tile(sdo, dout + base, q0, s, hd, ld);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        slse[threadIdx.x] = row < s ? lse[rbase + row] : 0.f;
        sdelta[threadIdx.x] = row < s ? delta[rbase + row] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      dot_tile(sc, sq, sk, hd, ld, rg, cg);
      dot_tile(dp, sdo, sv, hd, ld, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + cg + 16 * j;
          float x = sc[i][j] * scale;
          if (causal && col > row) x = kNegInf;
          const float p = (row < s && col < s) ? expf(x - slse[r]) : 0.f;
          sp[r * kPLd + cg + 16 * j] = p;
          sds[r * kPLd + cg + 16 * j] = p * (dp[i][j] - sdelta[r]) * scale;
        }
      }
      __syncthreads();
      // dv += P^T dO and dk += dS^T Q over this tile's query rows; this
      // thread's key rows are rg*4 .. rg*4+3 of the key tile
      const int n_q = min(kTile, s - q0);
      for (int r = 0; r < n_q; ++r) {
        float p[4], ds[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sp[r * kPLd + rg * 4 + i];
          ds[i] = sds[r * kPLd + rg * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          dov[c] = col < hd ? sdo[r * ld + col] : 0.f;
          qv[c] = col < hd ? sq[r * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(p[i], dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv[c], dk_acc[i][c]);
          }
        }
      }
      // dq += dS K for this thread's query rows rg*4 .. rg*4+3
      float dq_t[4][NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_t[i][c] = 0.f;
      }
      for (int j = 0; j < n_k; ++j) {
        float ds[4], kv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = sds[(rg * 4 + i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          kv[c] = col < hd ? sk[j * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NC; ++c) dq_t[i][c] = fmaf(ds[i], kv[c], dq_t[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg * 4 + i;
        if (row >= s) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          if (col >= hd) continue;
          const size_t at = base + static_cast<size_t>(row) * hd + col;
          // key tile 0 reaches every query row first (causal or not)
          dq[at] = k0 == 0 ? dq_t[i][c] : dq[at] + dq_t[i][c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + rg * 4 + i;
      if (row >= s) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cg + 16 * c;
        if (col >= hd) continue;
        const size_t at = base + static_cast<size_t>(row) * hd + col;
        dk[at] = dk_acc[i][c];
        dv[at] = dv_acc[i][c];
      }
    }
  }
}

// Column groups per thread for a head dimension (1, 2, 4 or 8); 0 if
// hd is out of range.
int column_groups(int hd) {
  if (hd < 1 || hd > kMaxHeadDim) return 0;
  if (hd <= 16) return 1;
  if (hd <= 32) return 2;
  if (hd <= 64) return 4;
  return 8;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int NC, bool kStats>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       long long bh, int s, int hd, float scale, int causal,
                       float* o, float* lse, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hd);
  const cudaError_t err = allow_smem(flash_fwd_kernel<NC, kStats>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kTile - 1) / kTile));
  flash_fwd_kernel<NC, kStats><<<grid, kThreads, smem, stream>>>(
      q, k, v, s, hd, scale, causal, o, lse);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       long long bh, int s, int hd, float scale, int causal,
                       float* dq, float* dk, float* dv, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(hd);
  const cudaError_t err = allow_smem(flash_bwd_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<NC><<<static_cast<unsigned>(bh), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, s, hd, scale, causal, dq, dk, dv);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t dispatch_fwd(const float* q, const float* k, const float* v,
                         long long bh, int s, int hd, float scale, int causal,
                         float* o, float* lse, cudaStream_t st) {
  switch (column_groups(hd)) {
    case 1: return launch_fwd<1, kStats>(q, k, v, bh, s, hd, scale, causal, o, lse, st);
    case 2: return launch_fwd<2, kStats>(q, k, v, bh, s, hd, scale, causal, o, lse, st);
    case 4: return launch_fwd<4, kStats>(q, k, v, bh, s, hd, scale, causal, o, lse, st);
    case 8: return launch_fwd<8, kStats>(q, k, v, bh, s, hd, scale, causal, o, lse, st);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(long long bh, int s, int hd) {
  return bh < 1 || bh > INT_MAX || s < 1 || column_groups(hd) == 0 ||
         (s + kTile - 1) / kTile > 65535;
}

}  // namespace

// Forward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// q, k, v, o (bh, s, hd) float32, contiguous; lse (bh, s) float32, or null
// for the plain forward, which writes no logsumexp rows.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, long long bh, int s, int hd,
                                   float scale, int causal, void* o, void* lse,
                                   void* stream) {
  if (bad_shape(bh, s, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  auto* fl = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lse == nullptr
          ? dispatch_fwd<false>(fq, fk, fv, bh, s, hd, scale, causal, fo, fl, st)
          : dispatch_fwd<true>(fq, fk, fv, bh, s, hd, scale, causal, fo, fl, st);
  return static_cast<int>(err);
}

// Backward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// q, k, v, dout, dq, dk, dv (bh, s, hd) and lse, delta (bh, s), float32 and
// contiguous. dq, dk and dv are written whole.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   long long bh, int s, int hd, float scale,
                                   int causal, void* dq, void* dk, void* dv,
                                   void* stream) {
  if (bad_shape(bh, s, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(q);
  const auto* b = static_cast<const float*>(k);
  const auto* c = static_cast<const float*>(v);
  const auto* g = static_cast<const float*>(dout);
  const auto* l = static_cast<const float*>(lse);
  const auto* e = static_cast<const float*>(delta);
  auto* x = static_cast<float*>(dq);
  auto* y = static_cast<float*>(dk);
  auto* z = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (column_groups(hd)) {
    case 1: err = launch_bwd<1>(a, b, c, g, l, e, bh, s, hd, scale, causal, x, y, z, st); break;
    case 2: err = launch_bwd<2>(a, b, c, g, l, e, bh, s, hd, scale, causal, x, y, z, st); break;
    case 4: err = launch_bwd<4>(a, b, c, g, l, e, bh, s, hd, scale, causal, x, y, z, st); break;
    case 8: err = launch_bwd<8>(a, b, c, g, l, e, bh, s, hd, scale, causal, x, y, z, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
