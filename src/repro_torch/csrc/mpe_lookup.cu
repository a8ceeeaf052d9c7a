// Packed mixed-precision embedding lookup for Hopper (sm_90a): gather the
// bit-packed row of every id, unpack its signed b-bit codes and dequantize
// alpha_b * code + beta (paper §4).
//
// Replaces the TPU kernel src/repro/kernels/mpe_lookup/kernel.py
// (packed_lookup_pallas / _lookup_kernel / _unpack_block), which ran one
// pallas_call per width bucket and composed the buckets with a select
// (src/repro/kernels/mpe_lookup/ops.py). Here one launch serves every bucket:
// each id reads its width from width_idx and its row from local_idx, so no
// bucket is computed and thrown away.
//
// Layout: one thread per (id, dimension) output element. Consecutive threads
// write consecutive dimensions, so the float32 stores coalesce; the id and
// its two index entries are the same address across the d threads of a row
// and broadcast. Unpacking follows src/repro/core/packing.py: take `lo` from
// word w0, OR in `hi` from word w0 + 1 when the code straddles, mask, add
// N_b. The dequant is one fused multiply-add (__fmaf_rn), which is what the
// reference's jitted lookup and the plain PyTorch version (torch.addcmul)
// compute, so the three agree bit for bit.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Per id it must read 4 (id)
// and write 4 * d; per distinct row it must read 4 (width_idx) and, where
// b > 0, 4 (local_idx) + 4 * ceil(d*b/32) (packed words). At d = 16 the
// 64-byte output row is most of it. Were every id a distinct row, the
// serve_bulk cell (262,144 rows x 39 fields = 10,223,616 ids) would move
// about 0.87 GB, a bound near 0.26 ms; under Zipf traffic repeated ids share
// their row's reads, so the bound is lower (chip_smoke.py computes it from
// the run's ids). The serve_p99 cell (19,968 ids, under 1.7 MB) is bound by
// launch overhead. Shared memory has no role; the kernel is kept simple and
// correct first.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuckets = 16;
constexpr int kThreads = 256;

// Per-width-bucket subtables, passed by value in the kernel's parameter
// space (no device copy of a descriptor per call).
struct Buckets {
  const uint32_t* words[kMaxBuckets];  // subtable base; unused where bits = 0
  int rows[kMaxBuckets];               // padded rows of the subtable
  int bits[kMaxBuckets];               // code width b; 0 = dropped feature
  int n;                               // number of buckets (candidate widths)
};

__global__ void __launch_bounds__(kThreads)
mpe_lookup_kernel(const int* __restrict__ ids, long long n_ids, int n_table,
                  const int* __restrict__ width_idx,
                  const int* __restrict__ local_idx,
                  const __grid_constant__ Buckets buckets,
                  const float* __restrict__ alpha,
                  const float* __restrict__ beta, int d,
                  float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n_ids * d) return;
  const long long r = t / d;
  const int j = static_cast<int>(t - r * d);

  // Ids are in range by contract; the clamp only keeps a bad id in bounds.
  const int id = min(max(__ldg(ids + r), 0), n_table - 1);
  const int w = __ldg(width_idx + id);
  const int b = (w >= 0 && w < buckets.n) ? buckets.bits[w] : 0;
  float v = 0.0f;  // a b = 0 row is the zero vector
  if (b > 0) {
    const int rows = buckets.rows[w];
    const int lidx = min(max(__ldg(local_idx + id), 0), rows - 1);
    const int wpr = (d * b + 31) >> 5;
    const uint32_t* row = buckets.words[w] + static_cast<long long>(lidx) * wpr;
    const int bitpos = j * b;
    const int w0 = bitpos >> 5;
    const int off = bitpos & 31;
    uint32_t u = __ldg(row + w0) >> off;
    if (off + b > 32) u |= __ldg(row + w0 + 1) << (32 - off);
    u &= (1u << b) - 1u;
    const int code = static_cast<int>(u) - (1 << (b - 1));
    v = __fmaf_rn(__ldg(alpha + w), static_cast<float>(code), __ldg(beta + j));
  }
  out[t] = v;
}

}  // namespace

// Launches the lookup on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: ids (n_ids,) int32, width_idx and local_idx (n_table,)
// int32, alpha (n_buckets,) f32, beta (d,) f32, out (n_ids, d) f32.
// Host arrays of n_buckets entries: words_ptrs (int64 device addresses of the
// int32/uint32 subtables), rows (int32), bits (int32, 0 or 1..31).
extern "C" int mpe_lookup(const void* ids, long long n_ids, int n_table,
                          const void* width_idx, const void* local_idx,
                          const void* words_ptrs, const void* rows,
                          const void* bits, int n_buckets, const void* alpha,
                          const void* beta, int d, void* out, void* stream) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets || d < 1 || n_table < 1 ||
      n_ids < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Buckets bk{};
  const long long* ptrs = static_cast<const long long*>(words_ptrs);
  const int* nrows = static_cast<const int*>(rows);
  const int* nbits = static_cast<const int*>(bits);
  for (int i = 0; i < n_buckets; ++i) {
    if (nbits[i] < 0 || nbits[i] > 31 || (nbits[i] > 0 && nrows[i] < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bk.words[i] = reinterpret_cast<const uint32_t*>(
        static_cast<uintptr_t>(ptrs[i]));
    bk.rows[i] = nrows[i];
    bk.bits[i] = nbits[i];
  }
  bk.n = n_buckets;

  const long long total = n_ids * d;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  mpe_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), n_ids, n_table,
      static_cast<const int*>(width_idx), static_cast<const int*>(local_idx),
      bk, static_cast<const float*>(alpha), static_cast<const float*>(beta), d,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
