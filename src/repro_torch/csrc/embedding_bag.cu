// Embedding bag for Hopper (sm_90a): the masked sum of the gathered rows of
// every bag, out[b, :] = sum_{j < L} table[ids[b, j], :] * mask[b, j], for a
// float32 table (N, d), ids (B, L) int32 or int64 and a mask (B, L) of bools
// or float32 weights, giving out (B, d) float32. The (B, L, d) gather is
// never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:33
// (embedding_bag_pallas / _bag_kernel). That kernel walks a (B, L) grid in
// order and keeps the bag's output block resident while it revisits it for
// the L slots. Blocks on Hopper run in no order, so nothing is carried
// between them: here one warp owns one bag and loops over its slots itself.
//
// Layout: one warp per bag, the lanes over the d columns (strided by 32 for
// d > 32), so each row read is a contiguous, coalesced 4 * d bytes (128 B at
// d = 32). Lane t reads slot j0 + t's id and weight once, coalesced, and the
// warp passes them round with shuffles. Every lane walks the slots in order
// 0..L-1, so the sum has one fixed order and repeat runs are bit-identical.
// Each product row * weight is rounded to float32, as the reference
// multiplies in the table's type (__fmul_rn, never contracted into an FMA),
// and the products are summed in float64 and rounded once: two float32
// orders of 50 N(0, 1) terms already differ by more than the reference's
// atol of 1e-6 where the sum cancels, and the float64 sum agrees with the
// plain version (ref.py, which sums the same products in float64) to the
// last bit nearly always, whatever order either takes. The weight is
// multiplied, never branched on, so an inf or NaN in a masked-out row
// propagates as it does in the reference (inf * 0 = NaN). Row offsets are
// 64-bit (row * d passes 2^31 on the largest tables). Ids must lie in
// [0, N), as for the reference's kernel; the clamp only keeps a bad id
// inside the table.
//
// What bounds it on an H100 (3.35 TB/s): bytes. It must read each distinct
// row it gathers once (4 * d bytes), each id and weight once, and write
// B * d floats. Rows repeated across bags are read again, mostly from the
// 50 MB L2; chip_smoke.py computes the bound from the run's ids. Making it
// fast (several bags per warp at small d, vector loads, more loads in
// flight) is later work; this kernel is the simple one that is right.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // bags per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float weight(unsigned char m) {
  return m ? 1.0f : 0.0f;
}

__device__ __forceinline__ float weight(float m) { return m; }

template <typename IdT, typename MaskT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, long long n_rows, int d,
                     const IdT* __restrict__ ids,
                     const MaskT* __restrict__ mask, long long n_bags, int l,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together
  const IdT* bag_ids = ids + bag * l;
  const MaskT* bag_mask = mask + bag * l;
  float* bag_out = out + bag * d;

  for (int c0 = 0; c0 < d; c0 += 32) {
    const int col = c0 + lane;
    const bool live = col < d;
    double acc = 0.0;
    for (int j0 = 0; j0 < l; j0 += 32) {
      long long my_id = 0;
      float my_w = 0.0f;
      if (j0 + lane < l) {
        my_id = static_cast<long long>(__ldg(bag_ids + j0 + lane));
        my_id = my_id < 0 ? 0 : (my_id >= n_rows ? n_rows - 1 : my_id);
        my_w = weight(__ldg(bag_mask + j0 + lane));
      }
      const int n = min(32, l - j0);
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const long long id = __shfl_sync(kFull, my_id, t);
        const float w = __shfl_sync(kFull, my_w, t);
        if (live) {
          const float v = __ldg(table + id * d + col);
          acc += static_cast<double>(__fmul_rn(v, w));
        }
      }
    }
    if (live) bag_out[col] = __double2float_rn(acc);
  }
}

template <typename IdT>
void launch(unsigned blocks, cudaStream_t stream, const float* table,
            long long n_rows, int d, const void* ids, const void* mask,
            int mask_float, long long n_bags, int l, float* out) {
  if (mask_float) {
    embedding_bag_kernel<IdT, float><<<blocks, kThreads, 0, stream>>>(
        table, n_rows, d, static_cast<const IdT*>(ids),
        static_cast<const float*>(mask), n_bags, l, out);
  } else {
    embedding_bag_kernel<IdT, unsigned char><<<blocks, kThreads, 0, stream>>>(
        table, n_rows, d, static_cast<const IdT*>(ids),
        static_cast<const unsigned char*>(mask), n_bags, l, out);
  }
}

}  // namespace

// Launches the bag on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: table (n_rows, d) f32; ids (n_bags, l) int64 where ids_64
// is 1, else int32; mask (n_bags, l) float32 where mask_float is 1, else one
// byte per slot (torch.bool); out (n_bags, d) f32. All contiguous.
extern "C" int embedding_bag_fwd(const void* table, long long n_rows, int d,
                                 const void* ids, int ids_64, const void* mask,
                                 int mask_float, long long n_bags, int l,
                                 void* out, void* stream) {
  if (n_rows < 1 || d < 1 || l < 0 || n_bags < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_bags == 0) return 0;
  const long long blocks = (n_bags + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  const auto b = static_cast<unsigned>(blocks);
  if (ids_64) {
    launch<long long>(b, s, t, n_rows, d, ids, mask, mask_float, n_bags, l, o);
  } else {
    launch<int>(b, s, t, n_rows, d, ids, mask, mask_float, n_bags, l, o);
  }
  return static_cast<int>(cudaGetLastError());
}
