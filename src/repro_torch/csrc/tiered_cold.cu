// Cold fill of the tiered embedding cache for Hopper (sm_90a): unpack and
// dequantize the packed rows of a request's cold ids, staged from host
// memory, into the rows of the embedding buffer the hot-tier lookup wrote.
//
// No TPU kernel stands behind it. The reference's cold path
// (src/repro/cache/tiers.py:452-529, src/repro/serve/cells.py:268-272) is a
// host gather of packed words, a device_put, a jitted unpack and scatter of
// the codes into a dense grid, an eager dequantize of the whole grid and a
// jnp.where merge with the hot rows. Here the last three are one launch that
// writes only the cold rows: the hot lookup (csrc/mpe_lookup.cu) leaves the
// zero row at every cold id (their width index is -1 in the store's lookup
// view), and this kernel writes alpha_b * code + beta over those zeros, so
// no merge is needed.
//
// The staged buffer (int32 words, built on the host by
// repro_torch/cache/tiers.py::TieredTableStore.prefetch_cold):
//   [0, nb)              count of cold entries of each width bucket
//   [nb, nb + K)         each entry's row in the output, bucket by bucket
//   [nb + K, ...)        each entry's packed words, bucket by bucket, wpr_b
//                        words a row (only the table's packed bytes cross
//                        PCIe)
// with K the sum of the counts. The counts are read on the device, because
// a CUDA graph fixes a launch's arguments at capture and a request's cold
// count varies: the grid is sized for the buffer's capacity and a
// grid-stride loop over the K * d outputs ends where this request's entries
// end.
//
// One thread an output element: entry k = e / d, column j = e % d. A block
// first turns the counts into each bucket's first entry and first word in
// shared memory; a thread then finds its entry's bucket (at most 16), reads
// the entry's row index, takes code j from a 64-bit window of the row's
// words as src/repro/core/packing.py lays them out (bits j * b .. j * b +
// b - 1, the unsigned value u, code = u + N_b with N_b = -2^(b-1)) and
// writes __fmaf_rn(alpha_b, code, beta_j): one rounding, as the port's
// lookup and its plain version (torch.addcmul) dequantize, so a cold row is
// bit-identical to the same row served from the monolithic table. Threads
// of one entry write its d floats side by side.
//
// What bounds it on an H100 (3.35 TB/s): the bytes it must move are the
// staged buffer's used words, read once, and the K * d float32 outputs,
// written once (chip_smoke.py::cold_bytes counts them from the run's
// buffer); at d = 16 the outputs are most of it.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuckets = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // enough to fill every SM

// The launch descriptor; mirrored field by field by _ColdPlan in
// repro_torch/kernels/tiered_cold/ops.py.
struct ColdPlan {
  const float* alpha;        // (n_buckets,)
  const float* beta;         // (d,)
  int bits[kMaxBuckets];     // code width b; 0 = dropped width (no entries)
  int wpr[kMaxBuckets];      // words per row, ceil(d * b / 32)
  int n_buckets;
  int d;
};

__global__ void __launch_bounds__(kThreads)
tiered_cold_kernel(const int* __restrict__ buf, long long capacity,
                   float* __restrict__ out, long long n_out,
                   const __grid_constant__ ColdPlan plan) {
  __shared__ long long s_first[kMaxBuckets + 1];  // first entry of a bucket
  __shared__ long long s_word[kMaxBuckets + 1];   // its first word
  const int nb = plan.n_buckets;
  if (threadIdx.x == 0) {
    long long k = 0, w = 0;
    for (int i = 0; i < nb; ++i) {
      s_first[i] = k;
      s_word[i] = w;
      // a count outside [0, capacity] is a bad buffer: take none of it
      long long c = __ldg(buf + i);
      c = (c < 0 || k + c > capacity) ? 0 : c;
      if (plan.bits[i] == 0) c = 0;
      k += c;
      w += c * plan.wpr[i];
    }
    s_first[nb] = k;
    s_word[nb] = w;
  }
  __syncthreads();
  const long long n_entries = s_first[nb];
  const int d = plan.d;
  const long long n_el = n_entries * d;
  const int* pos = buf + nb;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(buf + nb + n_entries);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n_el; e += stride) {
    const long long k = e / d;
    const int j = static_cast<int>(e - k * d);
    int i = 0;
    while (i + 1 < nb && k >= s_first[i + 1]) ++i;
    const int b = plan.bits[i];
    const int wpr = plan.wpr[i];
    const long long r = __ldg(pos + k);
    if (r < 0 || r >= n_out) continue;  // a bad row index writes nothing
    const uint32_t* row = words + s_word[i] + (k - s_first[i]) * wpr;
    const int bitpos = j * b;
    const int w0 = bitpos >> 5;
    const unsigned long long win =
        static_cast<unsigned long long>(__ldg(row + w0)) |
        (w0 + 1 < wpr
             ? static_cast<unsigned long long>(__ldg(row + w0 + 1)) << 32
             : 0ull);
    const unsigned u =
        static_cast<unsigned>(win >> (bitpos & 31)) & ((1u << b) - 1u);
    const int code = static_cast<int>(u) - (1 << (b - 1));
    out[r * d + j] =
        __fmaf_rn(__ldg(plan.alpha + i), static_cast<float>(code),
                  __ldg(plan.beta + j));
  }
}

}  // namespace

// The size of the descriptor, which the wrapper checks against its mirror.
extern "C" int tiered_cold_plan_bytes() {
  return static_cast<int>(sizeof(ColdPlan));
}

// Launches the cold fill on `stream` and returns cudaGetLastError()
// (0 = ok). plan: a host ColdPlan whose pointers are device addresses; buf:
// the staged buffer on the device, holding at most `capacity` entries; out:
// (n_out, d) float32 on the device, written only at the entries' rows.
extern "C" int tiered_cold(const void* plan_ptr, const void* buf,
                           long long capacity, void* out, long long n_out,
                           void* stream) {
  const ColdPlan& plan = *static_cast<const ColdPlan*>(plan_ptr);
  if (plan.n_buckets < 1 || plan.n_buckets > kMaxBuckets || plan.d < 1 ||
      capacity < 0 || n_out < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < plan.n_buckets; ++i) {
    if (plan.bits[i] < 0 || plan.bits[i] > 31 ||
        (plan.bits[i] > 0 && plan.wpr[i] != (plan.d * plan.bits[i] + 31) / 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (capacity == 0 || n_out == 0) return 0;
  const long long want = (capacity * plan.d + kThreads - 1) / kThreads;
  const long long blocks = want < kMaxBlocks ? want : kMaxBlocks;
  tiered_cold_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(buf), capacity, static_cast<float*>(out), n_out, plan);
  return static_cast<int>(cudaGetLastError());
}
