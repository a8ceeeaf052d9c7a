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
// What bounds them on an H100 (3.35 TB/s): bytes. Each element does a few
// flops per width (a division, a rounding, two fused multiply-adds), far
// under the float32 rate. At the train_batch cell (65,536 rows x 39 fields
// = 2,555,904 rows, d = 16, m = 7):
//   forward  reads rows and probs, writes out: 398,721,024 B, 0.1190 ms;
//   backward reads rows, probs and g, writes drows and dprobs:
//            633,864,192 B, 0.1892 ms
// (alpha, beta and their gradients add m + d floats each way).
//
// Forward: one thread per (row, dimension) element. Consecutive threads
// touch consecutive dimensions, so rows and out move coalesced; the row's
// probabilities are the same addresses across its d threads and broadcast.
// The candidate widths (at most 16) come by value in the parameter space
// and the width loop is unrolled; alpha and beta are trained parameters and
// are read from device memory on every launch. The division is IEEE
// (__fdiv_rn), the rounding rintf (half to even, as torch.round and
// jnp.round), and the dequant alpha*code + beta and the accumulation
// acc + p*q are each one fused multiply-add (__fmaf_rn), exactly where the
// plain PyTorch version (kernels/mpe_qat/ref.py) calls torch.addcmul: out
// and drows are bit-identical to it. Build without --use_fast_math.
//
// Backward: drows comes element by element. dprobs_i is a sum over the d
// dimensions of a row, dalpha a sum over all rows, dbeta a sum over all rows
// of each dimension. The TPU kernel accumulated dalpha and dbeta in output
// blocks that its sequential grid revisited; blocks on Hopper run in no
// order, so here a block walks kTilesPerBlock tiles of rows in order, keeps
// its dalpha and dbeta contributions in registers, and writes one partial
// row per block; a second small kernel sums the partials of each column in
// a fixed order (a strided sum per thread, then a tree). dprobs is summed
// per row through shared memory in dimension order. No float atomics
// anywhere: two runs on the same inputs give the same bits. The products
// are float32, formed as the plain version forms them; the three sums run
// in float64 and are rounded once. Float32 sums of a dalpha over thousands
// of rows, taken in two orders, part by more than the contract (rtol 1e-4,
// atol 1e-6) when the total cancels to near 0; in float64 the kernel and
// the plain version summing in float64 (sum_dtype) agree to the last bit
// or nearly in any order.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWidths = 16;
constexpr int kMaxBits = 24;       // codes stay exact in float32
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = 16;  // backward: tiles of rows per block

// Candidate widths, passed by value in the kernel's parameter space.
struct Widths {
  int bits[kMaxWidths];  // code width b_i; 0 = dropped feature
  int m;                 // number of candidate widths
};

// Quantize e at width b: v, its clipped code and alpha * code + beta.
struct Quant {
  float v, code, q, lo, hi;
};

__device__ __forceinline__ Quant quantize(float e, float a, float bj, int b) {
  Quant r;
  r.lo = -static_cast<float>(1 << (b - 1));
  r.hi = static_cast<float>((1 << (b - 1)) - 1);
  r.v = __fdiv_rn(__fsub_rn(e, bj), a);
  r.code = fminf(fmaxf(rintf(r.v), r.lo), r.hi);
  r.q = __fmaf_rn(a, r.code, bj);
  return r;
}

__global__ void __launch_bounds__(kThreads)
mpe_qat_fwd_kernel(const float* __restrict__ rows,
                   const float* __restrict__ probs,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta,
                   const __grid_constant__ Widths w, long long n_rows, int d,
                   float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n_rows * d) return;
  const long long r = t / d;
  const int j = static_cast<int>(t - r * d);
  const float e = rows[t];
  const float bj = __ldg(beta + j);
  const float* p = probs + r * w.m;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxWidths; ++i) {
    if (i >= w.m) break;
    const int b = w.bits[i];
    if (b == 0) continue;  // a dropped width contributes the zero vector
    const Quant qz = quantize(e, __ldg(alpha + i), bj, b);
    acc = __fmaf_rn(__ldg(p + i), qz.q, acc);
  }
  out[t] = acc;
}

// One block walks kTilesPerBlock tiles of rows_per_tile = kThreads / d rows;
// thread tid owns element tid of each tile (tid < rows_per_tile * d), so its
// dimension j is the same in every tile. Shared memory: gq, m floats per
// thread (g * Q_i of its element), and kThreads doubles of scratch.
__global__ void __launch_bounds__(kThreads)
mpe_qat_bwd_kernel(const float* __restrict__ rows,
                   const float* __restrict__ probs,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta,
                   const float* __restrict__ g,
                   const __grid_constant__ Widths w, long long n_rows, int d,
                   float* __restrict__ drows, float* __restrict__ dprobs,
                   double* __restrict__ partials) {
  extern __shared__ float gq[];        // [kThreads][m]
  __shared__ double scratch[kThreads];
  const int m = w.m;
  const int tid = threadIdx.x;
  const int rows_per_tile = kThreads / d;
  const bool active = tid < rows_per_tile * d;
  const int rr = active ? tid / d : 0;
  const int j = active ? tid - rr * d : 0;
  const float bj = active ? __ldg(beta + j) : 0.0f;
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;

  double acc_alpha[kMaxWidths];
#pragma unroll
  for (int i = 0; i < kMaxWidths; ++i) acc_alpha[i] = 0.0;
  double acc_beta = 0.0;

  for (int k = 0; k < kTilesPerBlock; ++k) {
    const long long tile = static_cast<long long>(blockIdx.x) * kTilesPerBlock + k;
    if (tile >= n_tiles) break;  // the same for every thread of the block
    const long long r = tile * rows_per_tile + rr;
    const bool live = active && r < n_rows;
    const long long at = r * d + j;
    const float e = live ? rows[at] : 0.0f;
    const float gv = live ? g[at] : 0.0f;
    const float* p = probs + r * m;
    float drow = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxWidths; ++i) {
      if (i >= m) break;
      const int b = w.bits[i];
      float gqi = 0.0f;
      if (b != 0 && live) {
        const float pi = __ldg(p + i);
        const Quant qz = quantize(e, __ldg(alpha + i), bj, b);
        const bool inside = qz.v > qz.lo && qz.v < qz.hi;
        gqi = __fmul_rn(gv, qz.q);                               // <g, Q_i>
        drow = __fmaf_rn(pi, inside ? gv : 0.0f, drow);          // Eq. 4
        const float dq = qz.v <= qz.lo ? qz.lo
                       : (qz.v >= qz.hi ? qz.hi : __fsub_rn(qz.code, qz.v));
        acc_alpha[i] += __fmul_rn(__fmul_rn(pi, gv), dq);        // Eq. 5
        acc_beta += __fmul_rn(pi, inside ? 0.0f : gv);           // Eq. 6
      }
      gq[tid * m + i] = gqi;
    }
    if (live) drows[at] = drow;
    __syncthreads();
    // dprobs[row, i]: the row's d products, summed in dimension order
    for (int x = tid; x < rows_per_tile * m; x += kThreads) {
      const int row = x / m;
      const int i = x - row * m;
      const long long rg = tile * rows_per_tile + row;
      if (rg < n_rows) {
        double s = 0.0;
        for (int jj = 0; jj < d; ++jj) s += gq[(row * d + jj) * m + i];
        dprobs[rg * m + i] = static_cast<float>(s);  // 0 for 0 bits
      }
    }
    __syncthreads();
  }

  // this block's dalpha partials: a tree over its threads, width by width
  double* part = partials + static_cast<long long>(blockIdx.x) * (m + d);
#pragma unroll
  for (int i = 0; i < kMaxWidths; ++i) {
    if (i >= m) break;
    scratch[tid] = acc_alpha[i];
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) scratch[tid] += scratch[tid + s];
      __syncthreads();
    }
    if (tid == 0) part[i] = scratch[0];
    __syncthreads();
  }
  // this block's dbeta partials: column j over the tile's rows, in row order
  scratch[tid] = acc_beta;
  __syncthreads();
  if (tid < d) {
    double s = 0.0;
    for (int row = 0; row < rows_per_tile; ++row) s += scratch[row * d + tid];
    part[m + tid] = s;
  }
}

// out[c] = sum over the n_parts rows of partials[:, c], one block per
// column, in a fixed order: thread t sums rows t, t + kThreads, ..., then a
// tree over the threads; in float64, rounded to float32 once.
__global__ void __launch_bounds__(kThreads)
mpe_qat_reduce_kernel(const double* __restrict__ partials, long long n_parts,
                      int width, float* __restrict__ out) {
  __shared__ double scratch[kThreads];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0;
  for (long long x = tid; x < n_parts; x += kThreads) {
    s += partials[x * width + c];
  }
  scratch[tid] = s;
  __syncthreads();
  for (int step = kThreads / 2; step > 0; step >>= 1) {
    if (tid < step) scratch[tid] += scratch[tid + step];
    __syncthreads();
  }
  if (tid == 0) out[c] = static_cast<float>(scratch[0]);
}

// Host-side checks shared by both entry points; fills `w`.
int make_widths(const int* bits, int m, int d, Widths* w) {
  if (m < 1 || m > kMaxWidths || d < 1 || d > kThreads) return -1;
  for (int i = 0; i < m; ++i) {
    if (bits[i] < 0 || bits[i] > kMaxBits) return -1;
    w->bits[i] = bits[i];
  }
  for (int i = m; i < kMaxWidths; ++i) w->bits[i] = 0;
  w->m = m;
  return 0;
}

long long bwd_blocks(long long n_rows, int d) {
  const int rows_per_tile = kThreads / d;
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  return (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
}

}  // namespace

// Rows of the (blocks, m + d) partials buffer that mpe_qat_bwd needs for
// n_rows rows of width d (0 when d is out of range).
extern "C" long long mpe_qat_bwd_partial_rows(long long n_rows, int d) {
  if (d < 1 || d > kThreads || n_rows < 0) return 0;
  return bwd_blocks(n_rows, d);
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
  const long long total = n_rows * d;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  mpe_qat_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(probs),
      static_cast<const float*>(alpha), static_cast<const float*>(beta), w,
      n_rows, d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// as for the forward, plus g (n_rows, d); outputs drows (n_rows, d), dprobs
// (n_rows, m), float64 scratch `partials` (mpe_qat_bwd_partial_rows(n_rows,
// d), m + d) and `sums` (m + d): dalpha = sums[:m], dbeta = sums[m:].
extern "C" int mpe_qat_bwd(const void* rows, const void* probs,
                           const void* alpha, const void* beta, const void* g,
                           const void* bits, int m, long long n_rows, int d,
                           void* drows, void* dprobs, void* partials,
                           void* sums, void* stream) {
  Widths w{};
  if (make_widths(static_cast<const int*>(bits), m, d, &w) != 0 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = bwd_blocks(n_rows, d);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(kThreads) * m * sizeof(float);
  mpe_qat_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const float*>(rows), static_cast<const float*>(probs),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(g), w, n_rows, d, static_cast<float*>(drows),
      static_cast<float*>(dprobs), static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mpe_qat_reduce_kernel<<<m + d, kThreads, 0, st>>>(
      static_cast<const double*>(partials), blocks, m + d,
      static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
