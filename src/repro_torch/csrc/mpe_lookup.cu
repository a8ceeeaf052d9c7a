// Packed mixed-precision embedding lookup for Hopper (sm_90a): gather the
// bit-packed row of every id, unpack its signed b-bit codes and dequantize
// alpha_b * code + beta (paper §4).
//
// Replaces the TPU kernel src/repro/kernels/mpe_lookup/kernel.py:63
// (packed_lookup_pallas / _lookup_kernel / _unpack_block), which ran one
// pallas_call per width bucket and composed the buckets with a select
// (src/repro/kernels/mpe_lookup/ops.py). Here one launch serves every bucket:
// each id reads its width from width_idx and its row from local_idx, so no
// bucket is computed and thrown away; a width of 0 gives the zero row.
//
// What bounds it on an H100 (3.35 TB/s). The bytes it must move: per id the
// id (4) and its float32 row (4 * d); per distinct row its width_idx and
// local_idx entries and its ceil(d*b/32) packed words. At d = 16 the 64-byte
// output row is most of it (chip_smoke.py::lookup_bytes counts the bound from
// the run's ids). But every index and word read is a random 4-byte read that
// depends on the one before (id -> width and row -> words), so what holds a
// simple kernel is the latency of those chains, not the bytes: one thread
// per output element (the first design) kept about two chains a warp in
// flight, read each id's indices d times, and ran at a fifth of the bound,
// 3.7 times slower again with a cold L2.
//
// Design. A warp takes a tile of 32 ids, one a lane, in two phases.
// 1. Gather: each lane loads its id, then its width_idx and local_idx entries
//    together (both depend only on the id), then alpha and all of its row's
//    words at once (at most MW, 4 at d = 16 and b <= 6, 16 at d = 50), so a
//    warp keeps 32 chains in flight and an SM up to 2,048. The words go to
//    the warp's slice of shared memory with the row's width and alpha. A
//    cold call so waits on three dependent reads a lane (id, indices,
//    words); beta, shared by every row, is read in phase 2 from the L1.
//    (Staging beta in shared memory first measured no faster cold and up to
//    5% slower warm.)
// 2. Decode and write: the lanes walk the tile's 32 * d outputs four
//    consecutive floats a lane, so each warp store is one coalesced
//    512-byte float4 store (the tile's first output is a multiple of 32 * d
//    floats, so every float4 is 16-byte aligned). A lane decodes V codes of
//    one row from a 64-bit window of two words (V = 4 where d % 4 == 0 and
//    every width <= 8; V = 2 where d is even and widths <= 16; else 1). Rows
//    are staged as packed words, not decoded floats: a tenth of the bytes
//    in shared memory at d = 16, and decoding is a few integer operations.
// Unpacking follows src/repro/core/packing.py: the code's bits start at
// j * b in the row, take them from the window, mask, add N_b. The dequant is
// one fused multiply-add (__fmaf_rn), which is what the reference's jitted
// lookup and the plain PyTorch version (torch.addcmul) compute, so the three
// agree bit for bit. Offsets of outputs and rows are 64-bit.
//
// The launch descriptor (Plan: the buckets' subtables, rows, bits and words
// per row, and the table's index, alpha and beta pointers) is built and
// checked once per table by the wrapper (kernels/mpe_lookup/ops.py) and
// passed by value in the kernel's parameter space, so a call checks the ids
// and makes one ctypes call.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuckets = 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;           // ids a warp gathers, one a lane
constexpr long long kMaxSharedBytes = 227 * 1024;  // a block's most on sm_90
constexpr unsigned kFull = 0xffffffffu;

// The launch descriptor; mirrored field by field by _Plan in
// repro_torch/kernels/mpe_lookup/ops.py.
struct Plan {
  const uint32_t* words[kMaxBuckets];  // subtable base; null where bits = 0
  const int* width_idx;                // (n_table,)
  const int* local_idx;                // (n_table,)
  const float* alpha;                  // (n_buckets,)
  const float* beta;                   // (d,)
  int rows[kMaxBuckets];               // padded rows of the subtable
  int bits[kMaxBuckets];               // code width b; 0 = dropped feature
  int wpr[kMaxBuckets];                // words per row, ceil(d * b / 32)
  int n_buckets;
  int n_table;
  int d;
  int max_words;                       // the largest wpr
  int max_bits;                        // the largest b
};

// Shared memory of one warp: kTile rows of `stride` words (the row's words
// plus one, so a window's second word stays inside the slot), then kTile
// widths and kTile alphas.
__host__ __device__ inline long long warp_words(int stride) {
  return static_cast<long long>(kTile) * stride + 2 * kTile;
}

// V outputs of row r from column j: codes at bits j*b, (j+1)*b, ... taken
// from one 64-bit window (V * b <= 32, so the window holds them all).
template <int V>
__device__ __forceinline__ void decode(const uint32_t* __restrict__ sw,
                                       const int* __restrict__ sb,
                                       const float* __restrict__ sa,
                                       const float* __restrict__ beta,
                                       int stride, int r, int j, float* v) {
  const int b = sb[r];
  if (b == 0) {  // a dropped feature (or a lane past the last id)
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.0f;
    return;
  }
  const int bitpos = j * b;
  const uint32_t* row = sw + r * stride + (bitpos >> 5);
  const unsigned long long win =
      static_cast<unsigned long long>(row[0]) |
      (static_cast<unsigned long long>(row[1]) << 32);
  const int off = bitpos & 31;
  const unsigned mask = (1u << b) - 1u;
  const int n_b = 1 << (b - 1);
  const float a = sa[r];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const unsigned u = static_cast<unsigned>(win >> (off + k * b)) & mask;
    const int code = static_cast<int>(u) - n_b;
    v[k] = __fmaf_rn(a, static_cast<float>(code), __ldg(beta + j + k));
  }
}

// MW: the words a lane loads ahead, >= plan.max_words (0: any number, one
// after another). V: outputs decoded from one window.
template <int MW, int V>
__global__ void __launch_bounds__(kThreads)
mpe_lookup_kernel(const int* __restrict__ ids, long long n_ids,
                  const __grid_constant__ Plan plan, int stride,
                  float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * kTile;
  if (tile0 >= n_ids) return;  // the whole warp leaves together
  uint32_t* sw = smem + warp * warp_words(stride);
  int* sb = reinterpret_cast<int*>(sw + kTile * stride);
  float* sa = reinterpret_cast<float*>(sb + kTile);

  // 1. gather: lane -> id tile0 + lane
  {
    int b = 0;
    float a = 0.0f;
    const long long i = tile0 + lane;
    if (i < n_ids) {
      // ids are in range by contract; the clamps only keep a bad one inside
      const int id = min(max(__ldg(ids + i), 0), plan.n_table - 1);
      const int w = __ldg(plan.width_idx + id);
      const int li = __ldg(plan.local_idx + id);
      if (w >= 0 && w < plan.n_buckets && plan.bits[w] > 0) {
        b = plan.bits[w];
        const int wpr = plan.wpr[w];
        const long long r = min(max(li, 0), plan.rows[w] - 1);
        const uint32_t* row = plan.words[w] + r * wpr;
        a = __ldg(plan.alpha + w);
        uint32_t* slot = sw + lane * stride;
        if constexpr (MW > 0) {
          uint32_t x[MW];
#pragma unroll
          for (int k = 0; k < MW; ++k) x[k] = k < wpr ? __ldg(row + k) : 0u;
#pragma unroll
          for (int k = 0; k < MW; ++k) {
            if (k < wpr) slot[k] = x[k];
          }
        } else {
          for (int k = 0; k < wpr; ++k) slot[k] = __ldg(row + k);
        }
      }
    }
    sb[lane] = b;
    sa[lane] = a;
  }
  __syncwarp(kFull);

  // 2. decode and write: four consecutive outputs a lane, float4 stores
  const int d = plan.d;
  const long long n_here = min(static_cast<long long>(kTile), n_ids - tile0);
  const int n_el = static_cast<int>(n_here) * d;
  float* dst = out + tile0 * d;
  const int step_r = 128 / d, step_j = 128 - step_r * d;
  int r = (lane * 4) / d;
  int j = lane * 4 - r * d;
  for (int e0 = lane * 4; e0 < n_el; e0 += 128) {
    float v[4];
    int rr = r, jj = j;
#pragma unroll
    for (int g = 0; g < 4; g += V) {
      if (e0 + g < n_el) {
        decode<V>(sw, sb, sa, plan.beta, stride, rr, jj, v + g);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[g + k] = 0.0f;
      }
      jj += V;
      if (jj >= d) { jj -= d; ++rr; }
    }
    if (e0 + 4 <= n_el) {
      *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e0 + k < n_el) dst[e0 + k] = v[k];
      }
    }
    r += step_r;
    j += step_j;
    if (j >= d) { j -= d; ++r; }
  }
}

template <int MW, int V>
cudaError_t launch(const int* ids, long long n_ids, const Plan& plan,
                   float* out, cudaStream_t stream) {
  const int stride = (MW > 0 ? MW : plan.max_words) + 1;
  const long long warp_bytes = warp_words(stride) * 4;
  // kWarps warps a block, fewer where long rows would not fit (MW = 0)
  const long long warps = min(static_cast<long long>(kWarps),
                              kMaxSharedBytes / warp_bytes);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(warps * warp_bytes);
  auto kernel = mpe_lookup_kernel<MW, V>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const long long per_block = warps * kTile;
  const long long blocks = (n_ids + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const unsigned threads = static_cast<unsigned>(32 * warps);
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(ids, n_ids, plan, stride, out);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_words(const int* ids, long long n_ids, const Plan& plan,
                         float* out, cudaStream_t stream) {
  if (plan.max_words <= 4) return launch<4, V>(ids, n_ids, plan, out, stream);
  if (plan.max_words <= 8) return launch<8, V>(ids, n_ids, plan, out, stream);
  if (plan.max_words <= 16) return launch<16, V>(ids, n_ids, plan, out, stream);
  return launch<0, V>(ids, n_ids, plan, out, stream);
}

}  // namespace

// The size of the descriptor, which the wrapper checks against its mirror.
extern "C" int mpe_lookup_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// Launches the lookup on `stream` and returns cudaGetLastError() (0 = ok).
// plan: a host Plan (see above) whose pointers are device addresses; ids
// (n_ids,) int32 and out (n_ids, d) float32 (16-byte aligned), on the device.
extern "C" int mpe_lookup(const void* plan_ptr, const void* ids,
                          long long n_ids, void* out, void* stream) {
  const Plan& plan = *static_cast<const Plan*>(plan_ptr);
  if (plan.n_buckets < 1 || plan.n_buckets > kMaxBuckets || plan.d < 1 ||
      plan.n_table < 1 || n_ids < 0 || plan.max_bits > 31 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ids == 0) return 0;
  const auto* i = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (plan.d % 4 == 0 && plan.max_bits <= 8) {
    err = launch_words<4>(i, n_ids, plan, o, st);
  } else if (plan.d % 2 == 0 && plan.max_bits <= 16) {
    err = launch_words<2>(i, n_ids, plan, o, st);
  } else {
    err = launch_words<1>(i, n_ids, plan, o, st);
  }
  return static_cast<int>(err);
}
