// The MPE search-phase mixture (paper Eq. 9) and its backward for Hopper
// (sm_90a):
//
//   out = sum_{b_i > 0} p_i * (alpha_i * clip(round((e - beta) / alpha_i),
//                                             N_b, P_b) + beta)
//
// Replaces the TPU kernels src/repro/kernels/mpe_qat/kernel.py:
// mixed_expectation_fwd (_fwd_kernel) and mixed_expectation_bwd
// (_bwd_kernel). The retrain lookup is the same mixture with one-hot p.
//
// What bounds them on an H100 (3.35 TB/s): their bytes are 0.4186 ms
// (forward) and 0.6417 ms (backward) a call at SASRec's step (3 lookups of
// 3,276,800 rows, d = 50, m = 7) and 0.1190 / 0.1892 at DLRM's
// train_batch (2,555,904 rows, d = 16); the forward runs near them. The
// backward is bound by its arithmetic and its latency: per element and
// width it divides, clamps, rounds, forms three float32 products and
// converts each to float64 for its sum, and conversions and float64 adds
// run at a fraction of the float32 rate (scripts/qat_variants.py takes it
// apart: the same kernel summing in float32 runs in 78% of the time).
//
// Layout (both kernels, rows of d <= 256): a row of d elements belongs to L = ceil(d / E)
// lanes of one warp, E consecutive elements each, and a warp holds
// R = 32 / L rows at a time (d = 50: 5 lanes x 10 elements, 6 rows; d = 16:
// 4 x 4, 8 rows; d = 32: 8 x 4, 4 rows). A lane's dimensions are the same
// in every row, so its E offsets beta stay in registers, as do alpha, its
// correctly rounded reciprocal and, for the live widths only (b > 0, kept
// in ascending order), the dalpha sums; the widths' code bounds come by
// value in the parameter space. Rows are read with vector loads where d
// and the pointers allow (16 bytes at d % 4 == 0, 8 at d % 2 == 0), each
// row's probabilities once by each of its lanes, broadcast. The grid is
// persistent: one block per resident slot of the card (an occupancy query,
// kept per kernel), its warps walking groups of R rows at a fixed stride.
// Each group's rows are loaded when its turn comes (loading the next ones
// ahead took registers and ran slower). The loops over a lane's elements
// and widths are straight-line code (a
// lane, row or element that is not live holds zeros, a width slot past
// the live ones p = 0, and each adds an exact 0), so the compiler can
// interleave them; a launch bound of kMinBlocks blocks an SM holds the
// backward to 96 registers, for 20 warps an SM (the variants: 4 blocks
// ran 22% slower, 6 or 8 slower again from spills).
//
// Rows wider than 256 (the LM's token table: d = 2,048 on internlm2-1.8b,
// up to 6,144 on grok-1-314b; any d up to kMaxWideD = 16,384, whose
// float64 dbeta sums take 128 KB of shared memory) take a second layout, a
// block of 256 threads a row (mpe_qat_fwd_wide_kernel,
// mpe_qat_bwd_wide_kernel, below), which carries the three sums across a
// row's column tiles: dprobs over the whole row, dbeta per column over
// the block's rows, dalpha over both. The TPU kernel takes any d in its
// (256, d) block.
//
// Arithmetic. v = (e - beta) / alpha_i is the IEEE quotient, formed as
// q = (e - beta) * r_i with r_i = RN(1 / alpha_i), then one Markstein
// correction fma(fma(-q, alpha_i, e - beta), r_i, q), which gives the
// division's bits (tests/test_torch_mpe_qat.py checks it over the alpha
// range in use; __fdiv_rn took the backward from 1.66 to 3.96 ms). The
// code is clamped, then rounded half to even by rintf: clamping and
// rounding commute at integer bounds. The dequant alpha*code + beta and
// the accumulations acc + p*q (forward) and drow + p*g_inside (backward)
// are each one fused multiply-add (__fmaf_rn), exactly where the plain
// PyTorch version (kernels/mpe_qat/ref.py) calls torch.addcmul: out and
// drows are bit-identical to it. Eq. 5's term is N_b | round(v) - v | P_b,
// formed as a select: outside the code range the clamped code is the
// bound. Build without --use_fast_math.
//
// Backward sums, each of the plain version's float32 products in float64,
// rounded to float32 once, in a fixed order. dprobs_i of a row: each lane
// over its E dimensions in order, then the row's L lanes by a fixed-order
// shuffle tree. dalpha: per lane over its rows, per block through shared
// memory in thread order. dbeta: per element over the widths, then per
// lane over its rows in shared memory (registers are the scarce resource),
// per block in thread order. Each block writes one (m + d, blocks)
// column-major partial, which a second small kernel sums per column in a
// fixed order (a strided sum per thread, then a tree). No float atomics
// anywhere: two runs on the same inputs and the same card give the same
// bits.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWidths = 16;
constexpr int kMaxBits = 24;          // codes stay exact in float32
constexpr int kMaxD = 256;            // the widest row of the warp layout
constexpr int kMaxWideD = 16384;      // the widest row of the block layout
constexpr int kThreads = 128;         // 4 warps a block, both kernels
constexpr int kWideThreads = 256;     // a block a row: rows wider than kMaxD
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr int kReduceThreads = 256;
constexpr int kMinBlocks = 5;         // blocks of kThreads an SM must hold

// Candidate widths, passed by value in the kernel's parameter space. The
// kernels loop over the live widths (b > 0) only, in ascending order of
// width index: a dropped width adds nothing to out or drows and has zero
// gradients.
struct Widths {
  int m;                     // candidate widths
  int live;                  // widths with b > 0
  int idx[kMaxWidths];       // the width index of each live slot
  int slot[kMaxWidths];      // the live slot of each width, -1 at b = 0
  float lo[kMaxWidths];      // N_b of each live slot
  float hi[kMaxWidths];      // P_b of each live slot
};

// t / a with the division's bits, from r = RN(1 / a).
__device__ __forceinline__ float divide(float t, float a, float r) {
  const float q = __fmul_rn(t, r);
  return __fmaf_rn(__fmaf_rn(-q, a, t), r, q);
}

// Quantize t = e - beta at live slot k: v, its clipped code (clamped, then
// rounded half to even: the two commute at integer bounds), alpha*code +
// beta.
struct Quant {
  float v, code, q;
};

__device__ __forceinline__ Quant quantize(float t, float a, float r, float bj,
                                          const Widths& w, int k) {
  Quant z;
  z.v = divide(t, a, r);
  z.code = rintf(fminf(fmaxf(z.v, w.lo[k]), w.hi[k]));
  z.q = __fmaf_rn(a, z.code, bj);
  return z;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float* dst) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ dst,
                                          const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

// This lane's place: its row in the warp's group (grp < R) and its first
// dimension j0 = k * E.
struct Place {
  int L, R, grp, k, j0;
  bool active;
};

template <int E>
__device__ __forceinline__ Place place(int d) {
  Place pl;
  pl.L = (d + E - 1) / E;
  pl.R = 32 / pl.L;
  const int lane = threadIdx.x & 31;
  pl.grp = lane / pl.L;
  pl.k = lane - pl.grp * pl.L;
  pl.active = pl.grp < pl.R;
  pl.j0 = pl.k * E;
  return pl;
}

// One lane's share of a row: its E elements of rows (and of g), the row's
// probabilities at the live widths; zeros where the lane or row is not live.
template <int E, int MW, bool kGrad>
struct Share {
  float e[E];
  float g[kGrad ? E : 1];
  float p[MW];
};

template <int V, int E, int MW, bool kGrad>
__device__ __forceinline__ void load_share(
    Share<E, MW, kGrad>& s, const float* __restrict__ rows,
    const float* __restrict__ g, const float* __restrict__ probs,
    const Widths& w, long long row, bool live, int j0, int d) {
#pragma unroll
  for (int x = 0; x < E; x += V) {
    const bool in = live && j0 + x < d;
    const long long at = row * d + j0 + x;
    if (in) {
      load_vec<V>(rows + at, s.e + x);
      if constexpr (kGrad) load_vec<V>(g + at, s.g + x);
    } else {
#pragma unroll
      for (int y = 0; y < V; ++y) {
        s.e[x + y] = 0.0f;
        if constexpr (kGrad) s.g[x + y] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MW; ++k) {
    s.p[k] = (live && k < w.live) ? __ldg(probs + row * w.m + w.idx[k]) : 0.0f;
  }
}

// Per-lane constants: alpha and r = RN(1 / alpha) of each live width, the
// lane's E offsets beta.
template <int E, int MW>
__device__ __forceinline__ void constants(const float* __restrict__ alpha,
                                          const float* __restrict__ beta,
                                          const Widths& w, const Place& pl,
                                          int d, float* a, float* r,
                                          float* bj) {
#pragma unroll
  for (int k = 0; k < MW; ++k) {
    a[k] = k < w.live ? __ldg(alpha + w.idx[k]) : 1.0f;
    r[k] = __frcp_rn(a[k]);
  }
#pragma unroll
  for (int x = 0; x < E; ++x) {
    bj[x] = (pl.active && pl.j0 + x < d) ? __ldg(beta + pl.j0 + x) : 0.0f;
  }
}

template <int V, int E, int MW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mpe_qat_fwd_kernel(const float* __restrict__ rows,
                   const float* __restrict__ probs,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta,
                   const __grid_constant__ Widths w, long long n_rows, int d,
                   float* __restrict__ out) {
  const Place pl = place<E>(d);
  float a[MW], r[MW], bj[E];
  constants<E, MW>(alpha, beta, w, pl, d, a, r, bj);
  const long long n_groups = (n_rows + pl.R - 1) / pl.R;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long grp_at = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
  for (; grp_at < n_groups; grp_at += stride) {
    const long long row = grp_at * pl.R + pl.grp;
    const bool live = pl.active && row < n_rows;
    Share<E, MW, false> cur;
    load_share<V>(cur, rows, nullptr, probs, w, row, live, pl.j0, d);
    float o[E];
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const float t = __fsub_rn(cur.e[x], bj[x]);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MW; ++k) {  // slots past w.live have p = 0
        const Quant z = quantize(t, a[k], r[k], bj[x], w, k);
        acc = __fmaf_rn(cur.p[k], z.q, acc);
      }
      o[x] = acc;
    }
    if (live) {
#pragma unroll
      for (int x = 0; x < E; x += V) {
        if (pl.j0 + x < d) store_vec<V>(out + row * d + pl.j0 + x, o + x);
      }
    }
  }
}

// Shared memory: (MW + E) x kThreads doubles, each thread's dalpha sums at
// its live widths, then its dbeta sums at its E dimensions (kept there
// while it walks its rows, to spare registers); column c of this block's
// partial goes to partials[c * n_parts + blockIdx.x].
template <int V, int E, int MW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mpe_qat_bwd_kernel(const float* __restrict__ rows,
                   const float* __restrict__ probs,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta,
                   const float* __restrict__ g,
                   const __grid_constant__ Widths w, long long n_rows, int d,
                   float* __restrict__ drows, float* __restrict__ dprobs,
                   double* __restrict__ partials, int n_parts) {
  extern __shared__ double sums[];
  const int tid = threadIdx.x;
  const Place pl = place<E>(d);
  float a[MW], r[MW], bj[E];
  constants<E, MW>(alpha, beta, w, pl, d, a, r, bj);
  double acc_alpha[MW];
#pragma unroll
  for (int k = 0; k < MW; ++k) acc_alpha[k] = 0.0;
  double* acc_beta = sums + MW * kThreads + tid;  // [x * kThreads]
#pragma unroll
  for (int x = 0; x < E; ++x) acc_beta[x * kThreads] = 0.0;

  const long long n_groups = (n_rows + pl.R - 1) / pl.R;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long grp_at = static_cast<long long>(blockIdx.x) * kWarps + (tid >> 5);
  for (; grp_at < n_groups; grp_at += stride) {
    const long long row = grp_at * pl.R + pl.grp;
    const bool live = pl.active && row < n_rows;
    Share<E, MW, true> cur;
    load_share<V>(cur, rows, g, probs, w, row, live, pl.j0, d);
    double dp[MW];
#pragma unroll
    for (int k = 0; k < MW; ++k) dp[k] = 0.0;
    float drow[E];
#pragma unroll
    for (int x = 0; x < E; ++x) {
      // branch-free: a lane, row or dimension that is not live holds e, g
      // and p of 0, a slot past w.live p = 0, and each adds an exact 0
      const float gv = cur.g[x];
      const float t = __fsub_rn(cur.e[x], bj[x]);
      float dr = 0.0f;
      double db = 0.0;
#pragma unroll
      for (int k = 0; k < MW; ++k) {
        const float pi = cur.p[k];
        const Quant z = quantize(t, a[k], r[k], bj[x], w, k);
        const bool inside = z.v > w.lo[k] && z.v < w.hi[k];
        dp[k] += static_cast<double>(__fmul_rn(gv, z.q));             // <g, Q>
        dr = __fmaf_rn(pi, inside ? gv : 0.0f, dr);                   // Eq. 4
        // Eq. 5's N_b | round(v) - v | P_b: outside, the clamped code is
        // the bound (a NaN v keeps code - v)
        const float dq = inside || z.v != z.v ? __fsub_rn(z.code, z.v)
                                              : z.code;
        const float pg = __fmul_rn(pi, gv);
        acc_alpha[k] += static_cast<double>(__fmul_rn(pg, dq));      // Eq. 5
        db += static_cast<double>(inside ? 0.0f : pg);                // Eq. 6
      }
      drow[x] = dr;
      acc_beta[x * kThreads] += db;
    }
    // dprobs: the row's L lane sums, by a fixed-order tree, the widths'
    // shuffles of one level side by side
#pragma unroll
    for (int lev = 0; lev < 5; ++lev) {
      const int off = 1 << lev;
      if (off >= pl.L) break;  // the same for the whole warp
      const bool take = (pl.k & (2 * off - 1)) == 0 && pl.k + off < pl.L;
#pragma unroll
      for (int k = 0; k < MW; ++k) {
        const double o = __shfl_down_sync(0xffffffffu, dp[k], off);
        if (take) dp[k] += o;
      }
    }
    if (live) {
      if (pl.k == 0) {
        float* dst = dprobs + row * w.m;
#pragma unroll
        for (int k = 0; k < MW; ++k) {
          if (k < w.live) dst[w.idx[k]] = static_cast<float>(dp[k]);
        }
        for (int i = 0; i < w.m; ++i) {
          if (w.slot[i] < 0) dst[i] = 0.0f;  // a dropped width
        }
      }
#pragma unroll
      for (int x = 0; x < E; x += V) {
        if (pl.j0 + x < d) store_vec<V>(drows + row * d + pl.j0 + x, drow + x);
      }
    }
  }

  // this block's partials, each column summed over its threads in order
#pragma unroll
  for (int k = 0; k < MW; ++k) sums[k * kThreads + tid] = acc_alpha[k];
  __syncthreads();
  for (int c = tid; c < w.m + d; c += kThreads) {
    double s = 0.0;
    if (c < w.m) {
      const int k = w.slot[c];
      if (k >= 0) {
        for (int t = 0; t < kThreads; ++t) s += sums[k * kThreads + t];
      }
    } else {
      const int j = c - w.m, k = j / E, x = j - k * E;
      for (int wp = 0; wp < kWarps; ++wp) {
        for (int gr = 0; gr < pl.R; ++gr) {
          s += sums[(MW + x) * kThreads + wp * 32 + gr * pl.L + k];
        }
      }
    }
    partials[static_cast<long long>(c) * n_parts + blockIdx.x] = s;
  }
}

// out[c] = sum of partials[c * n_parts + 0 .. n_parts - 1], one block per
// column, in a fixed order: thread t sums entries t, t + kReduceThreads,
// ..., then a tree over the threads; in float64, rounded to float32 once.
__global__ void __launch_bounds__(kReduceThreads)
mpe_qat_reduce_kernel(const double* __restrict__ partials, int n_parts,
                      float* __restrict__ out) {
  __shared__ double scratch[kReduceThreads];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const double* col = partials + static_cast<long long>(c) * n_parts;
  double s = 0.0;
  for (int x = tid; x < n_parts; x += kReduceThreads) s += col[x];
  scratch[tid] = s;
  __syncthreads();
  for (int step = kReduceThreads / 2; step > 0; step >>= 1) {
    if (tid < step) scratch[tid] += scratch[tid + step];
    __syncthreads();
  }
  if (tid == 0) out[c] = static_cast<float>(scratch[0]);
}

// Rows wider than kMaxD: a block of kWideThreads owns one row at a time
// (persistent blocks walking the rows at a fixed stride), thread t its
// columns t * V + c * kWideThreads * V (+ 0 .. V - 1) for c = 0, 1, ...,
// so a column always belongs to the same thread of every block. The row's
// probabilities are read once a row by each thread (one broadcast load),
// alpha and its reciprocal stay in registers. Each element's arithmetic
// is the warp layout's, step for step: out and drows are bit-identical to
// the plain version at any width.
template <int V, int MW>
__global__ void __launch_bounds__(kWideThreads)
mpe_qat_fwd_wide_kernel(const float* __restrict__ rows,
                        const float* __restrict__ probs,
                        const float* __restrict__ alpha,
                        const float* __restrict__ beta,
                        const __grid_constant__ Widths w, long long n_rows,
                        int d, float* __restrict__ out) {
  float a[MW], r[MW];
#pragma unroll
  for (int k = 0; k < MW; ++k) {
    a[k] = k < w.live ? __ldg(alpha + w.idx[k]) : 1.0f;
    r[k] = __frcp_rn(a[k]);
  }
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    float p[MW];
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      p[k] = k < w.live ? __ldg(probs + row * w.m + w.idx[k]) : 0.0f;
    }
    const float* src = rows + row * d;
    float* dst = out + row * d;
    for (int c = threadIdx.x * V; c < d; c += kWideThreads * V) {
      float e[V], b[V], o[V];
      load_vec<V>(src + c, e);
      load_vec<V>(beta + c, b);
#pragma unroll
      for (int x = 0; x < V; ++x) {
        const float t = __fsub_rn(e[x], b[x]);
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < MW; ++k) {  // slots past w.live have p = 0
          const Quant z = quantize(t, a[k], r[k], b[x], w, k);
          acc = __fmaf_rn(p[k], z.q, acc);
        }
        o[x] = acc;
      }
      store_vec<V>(dst + c, o);
    }
  }
}

// Per-thread column slots of the block layout at width d.
template <int V>
__host__ __device__ __forceinline__ int wide_slots(int d) {
  return (d + kWideThreads * V - 1) / (kWideThreads * V) * V;
}

// Shared memory (doubles): each thread's dbeta sums at its column slots,
// [slot * kWideThreads + tid]; each warp's dprobs sums of the row at hand,
// [warp * MW + k]; each thread's dalpha sums at the end, [k * kWideThreads
// + tid]. The sums run as in the warp layout: dprobs of a row over each
// thread's columns in order, then a shuffle tree within each warp and the
// warps in order; dalpha per thread over its rows and columns, then per
// block in thread order; dbeta per column over the block's rows. Column c
// of this block's partial goes to partials[c * n_parts + blockIdx.x].
template <int V, int MW>
__global__ void __launch_bounds__(kWideThreads)
mpe_qat_bwd_wide_kernel(const float* __restrict__ rows,
                        const float* __restrict__ probs,
                        const float* __restrict__ alpha,
                        const float* __restrict__ beta,
                        const float* __restrict__ g,
                        const __grid_constant__ Widths w, long long n_rows,
                        int d, float* __restrict__ drows,
                        float* __restrict__ dprobs,
                        double* __restrict__ partials, int n_parts) {
  extern __shared__ double sums[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = wide_slots<V>(d);
  double* acc_beta = sums;                                   // [slot][tid]
  double* red = sums + slots * kWideThreads;                 // [warp][k]
  double* acc_alpha_sm = red + kWideWarps * MW;              // [k][tid]
  for (int sl = 0; sl < slots; ++sl) acc_beta[sl * kWideThreads + tid] = 0.0;
  float a[MW], r[MW];
  double acc_alpha[MW];
#pragma unroll
  for (int k = 0; k < MW; ++k) {
    a[k] = k < w.live ? __ldg(alpha + w.idx[k]) : 1.0f;
    r[k] = __frcp_rn(a[k]);
    acc_alpha[k] = 0.0;
  }
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    float p[MW];
    double dp[MW];
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      p[k] = k < w.live ? __ldg(probs + row * w.m + w.idx[k]) : 0.0f;
      dp[k] = 0.0;
    }
    const long long base = row * d;
    int sl = 0;
    for (int c = tid * V; c < d; c += kWideThreads * V, sl += V) {
      float e[V], gg[V], b[V], drow[V];
      load_vec<V>(rows + base + c, e);
      load_vec<V>(g + base + c, gg);
      load_vec<V>(beta + c, b);
#pragma unroll
      for (int x = 0; x < V; ++x) {
        const float gv = gg[x];
        const float t = __fsub_rn(e[x], b[x]);
        float dr = 0.0f;
        double db = 0.0;
#pragma unroll
        for (int k = 0; k < MW; ++k) {
          const float pi = p[k];
          const Quant z = quantize(t, a[k], r[k], b[x], w, k);
          const bool inside = z.v > w.lo[k] && z.v < w.hi[k];
          dp[k] += static_cast<double>(__fmul_rn(gv, z.q));            // <g, Q>
          dr = __fmaf_rn(pi, inside ? gv : 0.0f, dr);                  // Eq. 4
          const float dq = inside || z.v != z.v ? __fsub_rn(z.code, z.v)
                                                : z.code;
          const float pg = __fmul_rn(pi, gv);
          acc_alpha[k] += static_cast<double>(__fmul_rn(pg, dq));     // Eq. 5
          db += static_cast<double>(inside ? 0.0f : pg);               // Eq. 6
        }
        drow[x] = dr;
        acc_beta[(sl + x) * kWideThreads + tid] += db;
      }
      store_vec<V>(drows + base + c, drow);
    }
    // dprobs of this row: each warp by a fixed-order shuffle tree, then
    // the warps in order
#pragma unroll
    for (int k = 0; k < MW; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dp[k] += __shfl_down_sync(0xffffffffu, dp[k], off);
      }
      if (lane == 0) red[warp * MW + k] = dp[k];
    }
    __syncthreads();
    if (tid < w.m) {
      const int k = w.slot[tid];
      double s = 0.0;
      if (k >= 0) {
        for (int wp = 0; wp < kWideWarps; ++wp) s += red[wp * MW + k];
      }
      dprobs[row * w.m + tid] = static_cast<float>(s);  // 0: a dropped width
    }
    __syncthreads();
  }

  // this block's partials
#pragma unroll
  for (int k = 0; k < MW; ++k) acc_alpha_sm[k * kWideThreads + tid] = acc_alpha[k];
  __syncthreads();
  for (int c = tid; c < w.m + d; c += kWideThreads) {
    double s = 0.0;
    if (c < w.m) {
      const int k = w.slot[c];
      if (k >= 0) {
        for (int t = 0; t < kWideThreads; ++t) {
          s += acc_alpha_sm[k * kWideThreads + t];
        }
      }
    } else {
      const int j = c - w.m;
      const int round = j / (kWideThreads * V), rem = j - round * kWideThreads * V;
      const int owner = rem / V, x = rem - owner * V;
      s = acc_beta[(round * V + x) * kWideThreads + owner];
    }
    partials[static_cast<long long>(c) * n_parts + blockIdx.x] = s;
  }
}

// Host-side checks shared by both entry points; fills `w`.
int make_widths(const int* bits, int m, int d, Widths* w) {
  if (m < 1 || m > kMaxWidths || d < 1 || d > kMaxWideD) return -1;
  w->m = m;
  w->live = 0;
  for (int i = 0; i < kMaxWidths; ++i) {
    w->slot[i] = -1;
    w->idx[i] = 0;
    w->lo[i] = w->hi[i] = 0.0f;
  }
  for (int i = 0; i < m; ++i) {
    const int b = bits[i];
    if (b < 0 || b > kMaxBits) return -1;
    if (b == 0) continue;
    const int k = w->live++;
    w->slot[i] = k;
    w->idx[k] = i;
    w->lo[k] = -static_cast<float>(1 << (b - 1));
    w->hi[k] = static_cast<float>((1 << (b - 1)) - 1);
  }
  return 0;
}

// The kernels' instantiations: V floats a load, E elements a lane (the
// warp layout, d <= kMaxD), or the block layout's V (d > kMaxD).
enum Kind { kV4E4, kV4E8, kV2E10, kV1E8, kWideV4, kWideV1 };

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest loads that d and every row pointer allow (and beta's, which
// the block layout reads by the same vectors).
Kind choose(int d, std::initializer_list<const void*> ptrs, const void* beta) {
  bool a16 = d % 4 == 0, a8 = d % 2 == 0;
  for (const void* p : ptrs) {
    a16 = a16 && aligned(p, 16);
    a8 = a8 && aligned(p, 8);
  }
  if (d > kMaxD) return a16 && aligned(beta, 16) ? kWideV4 : kWideV1;
  if (a16) return d <= 128 ? kV4E4 : kV4E8;
  if (a8 && d <= 320) return kV2E10;
  return kV1E8;
}

int sm_count(int dev, cudaError_t* err) {
  int sms = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Lets `fn` use `smem` bytes of dynamic shared memory and returns the blocks
// of it the card holds at once (SMs x blocks an SM holds). Both are found
// once per (fn, device, smem) and kept: the attribute call and the
// occupancy query cost more host time than a small launch.
cudaError_t resident_blocks(const void* fn, size_t smem, long long* blocks,
                            int threads = kThreads) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : seen) {
    if (e.fn == fn && e.dev == dev && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int sms = sm_count(dev, &err);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<long long>(sms) * per_sm;
  seen.push_back({fn, dev, smem, *blocks});
  return cudaSuccess;
}

// Persistent blocks: as many as the card holds, at most one warp a group.
template <int E>
long long grid_for(long long n_rows, int d, long long resident) {
  const int rows_per_warp = 32 / ((d + E - 1) / E);
  const long long groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const long long wanted = (groups + kWarps - 1) / kWarps;
  return wanted < resident ? wanted : resident;
}

struct Args {
  const float *rows, *probs, *alpha, *beta, *g;
  float *out_or_drows, *dprobs, *sums;
  double* partials;
  long long capacity;
};

template <int V, int E, int MW>
cudaError_t launch_fwd(const Args& x, const Widths& w, long long n_rows, int d,
                       cudaStream_t st) {
  auto kernel = mpe_qat_fwd_kernel<V, E, MW>;
  long long resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), 0,
                                    &resident);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(grid_for<E>(n_rows, d, resident));
  kernel<<<blocks, kThreads, 0, st>>>(x.rows, x.probs, x.alpha, x.beta, w, n_rows, d, x.out_or_drows);
  return cudaGetLastError();
}

template <int V, int E, int MW>
cudaError_t launch_bwd(const Args& x, const Widths& w, long long n_rows, int d,
                       cudaStream_t st) {
  auto kernel = mpe_qat_bwd_kernel<V, E, MW>;
  const size_t smem = static_cast<size_t>(MW + E) * kThreads * sizeof(double);
  long long resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel),
                                    smem, &resident);
  if (err != cudaSuccess) return err;
  const long long blocks = grid_for<E>(n_rows, d, resident);
  if (blocks * (w.m + d) > x.capacity) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  kernel<<<grid, kThreads, smem, st>>>(x.rows, x.probs, x.alpha, x.beta, x.g, w, n_rows, d, x.out_or_drows, x.dprobs, x.partials, static_cast<int>(blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mpe_qat_reduce_kernel<<<w.m + d, kReduceThreads, 0, st>>>(x.partials, static_cast<int>(blocks), x.sums);
  return cudaGetLastError();
}

template <int V, int MW>
cudaError_t launch_fwd_wide(const Args& x, const Widths& w, long long n_rows,
                            int d, cudaStream_t st) {
  auto kernel = mpe_qat_fwd_wide_kernel<V, MW>;
  long long resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), 0,
                                    &resident, kWideThreads);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(n_rows < resident ? n_rows : resident);
  kernel<<<blocks, kWideThreads, 0, st>>>(x.rows, x.probs, x.alpha, x.beta, w, n_rows, d, x.out_or_drows);
  return cudaGetLastError();
}

template <int V, int MW>
size_t wide_bwd_smem(int d) {
  return (static_cast<size_t>(wide_slots<V>(d)) * kWideThreads +
          static_cast<size_t>(kWideWarps) * MW +
          static_cast<size_t>(MW) * kWideThreads) * sizeof(double);
}

template <int V, int MW>
cudaError_t launch_bwd_wide(const Args& x, const Widths& w, long long n_rows,
                            int d, cudaStream_t st) {
  auto kernel = mpe_qat_bwd_wide_kernel<V, MW>;
  const size_t smem = wide_bwd_smem<V, MW>(d);
  long long resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel),
                                    smem, &resident, kWideThreads);
  if (err != cudaSuccess) return err;
  const long long blocks = n_rows < resident ? n_rows : resident;
  if (blocks * (w.m + d) > x.capacity) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  kernel<<<grid, kWideThreads, smem, st>>>(x.rows, x.probs, x.alpha, x.beta, x.g, w, n_rows, d, x.out_or_drows, x.dprobs, x.partials, static_cast<int>(blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mpe_qat_reduce_kernel<<<w.m + d, kReduceThreads, 0, st>>>(x.partials, static_cast<int>(blocks), x.sums);
  return cudaGetLastError();
}

// Launches `Launch<V, E, MW>` at the kind and at 6 register slots of live
// widths (the paper's 0..6 bits) or 16; the block layout's kinds through
// `Launch<V, 0, MW>::wide`.
template <template <int, int, int> class Launch>
cudaError_t dispatch(Kind kind, const Args& x, const Widths& w,
                     long long n_rows, int d, cudaStream_t st) {
  const bool small = w.live <= 6;
  switch (kind) {
    case kV4E4:
      return small ? Launch<4, 4, 6>::run(x, w, n_rows, d, st)
                   : Launch<4, 4, 16>::run(x, w, n_rows, d, st);
    case kV4E8:
      return small ? Launch<4, 8, 6>::run(x, w, n_rows, d, st)
                   : Launch<4, 8, 16>::run(x, w, n_rows, d, st);
    case kV2E10:
      return small ? Launch<2, 10, 6>::run(x, w, n_rows, d, st)
                   : Launch<2, 10, 16>::run(x, w, n_rows, d, st);
    case kWideV4:
      return small ? Launch<4, 0, 6>::wide(x, w, n_rows, d, st)
                   : Launch<4, 0, 16>::wide(x, w, n_rows, d, st);
    case kWideV1:
      return small ? Launch<1, 0, 6>::wide(x, w, n_rows, d, st)
                   : Launch<1, 0, 16>::wide(x, w, n_rows, d, st);
    default:
      return small ? Launch<1, 8, 6>::run(x, w, n_rows, d, st)
                   : Launch<1, 8, 16>::run(x, w, n_rows, d, st);
  }
}

template <int V, int E, int MW>
struct Fwd {
  static cudaError_t run(const Args& x, const Widths& w, long long n, int d,
                         cudaStream_t st) {
    return launch_fwd<V, E, MW>(x, w, n, d, st);
  }
  static cudaError_t wide(const Args& x, const Widths& w, long long n, int d,
                          cudaStream_t st) {
    return launch_fwd_wide<V, MW>(x, w, n, d, st);
  }
};

template <int V, int E, int MW>
struct Bwd {
  static cudaError_t run(const Args& x, const Widths& w, long long n, int d,
                         cudaStream_t st) {
    return launch_bwd<V, E, MW>(x, w, n, d, st);
  }
  static cudaError_t wide(const Args& x, const Widths& w, long long n, int d,
                          cudaStream_t st) {
    return launch_bwd_wide<V, MW>(x, w, n, d, st);
  }
};

}  // namespace

// Rows of an (rows, m + d) float64 scratch buffer that mpe_qat_bwd needs for
// n_rows rows of width d: at least the blocks the card holds at once (0
// when d is out of range or the device cannot be read).
extern "C" long long mpe_qat_bwd_partial_rows(long long n_rows, int d) {
  if (d < 1 || d > kMaxWideD || n_rows < 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  const int sms = sm_count(dev, &err);
  if (err != cudaSuccess) return 0;
  return static_cast<long long>(sms) *
         (d > kMaxD ? 2048 / kWideThreads : kMaxBlocksPerSm);
}

// Forward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers:
// rows (n_rows, d), probs (n_rows, m), alpha (m,), beta (d,), out (n_rows, d),
// all float32 and contiguous. `bits` is a host array of m ints in 0..24.
extern "C" int mpe_qat_fwd(const void* rows, const void* probs,
                           const void* alpha, const void* beta,
                           const void* bits, int m, long long n_rows, int d,
                           void* out, void* stream) {
  Widths w{};
  if (make_widths(static_cast<const int*>(bits), m, d, &w) != 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const Args x{static_cast<const float*>(rows), static_cast<const float*>(probs),
               static_cast<const float*>(alpha), static_cast<const float*>(beta),
               nullptr, static_cast<float*>(out), nullptr, nullptr, nullptr, 0};
  return static_cast<int>(dispatch<Fwd>(choose(d, {rows, out}, beta), x, w, n_rows,
                                        d, static_cast<cudaStream_t>(stream)));
}

// Backward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// as for the forward, plus g (n_rows, d); outputs drows (n_rows, d), dprobs
// (n_rows, m), float64 scratch `partials` (mpe_qat_bwd_partial_rows(n_rows,
// d) x (m + d) doubles) and `sums` (m + d): dalpha = sums[:m],
// dbeta = sums[m:].
extern "C" int mpe_qat_bwd(const void* rows, const void* probs,
                           const void* alpha, const void* beta, const void* g,
                           const void* bits, int m, long long n_rows, int d,
                           void* drows, void* dprobs, void* partials,
                           void* sums, void* stream) {
  Widths w{};
  if (make_widths(static_cast<const int*>(bits), m, d, &w) != 0 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x{static_cast<const float*>(rows), static_cast<const float*>(probs),
               static_cast<const float*>(alpha), static_cast<const float*>(beta),
               static_cast<const float*>(g), static_cast<float*>(drows),
               static_cast<float*>(dprobs), static_cast<float*>(sums),
               static_cast<double*>(partials),
               mpe_qat_bwd_partial_rows(n_rows, d) * (m + d)};
  return static_cast<int>(dispatch<Bwd>(choose(d, {rows, g, drows}, beta), x, w,
                                        n_rows, d,
                                        static_cast<cudaStream_t>(stream)));
}
