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
// between them: here a group of lanes owns one bag and loops over its slots
// itself.
//
// What bounds it on an H100 (3.35 TB/s). The bytes it must move: each
// distinct row it gathers once (4 * d bytes), each id and weight once, and
// B * d floats written (chip_smoke.py computes the bound from the run's
// ids). Rows repeated across bags are read again, from the L1 or the 50 MB
// L2: at BST's serve_bulk shape (262,144 bags of 20, d = 32) the gather
// reads 671 MB for 96 MB of distinct rows. Each row read is a random
// 4 * d bytes whose address waits on the id's load, so the kernel needs many
// rows in flight. The first design gave a bag a whole warp, lanes over the
// columns: at d <= 16 half or more of the lanes sat idle, and with one float
// a lane and the slots walked four at a time, a warp had four 128-byte rows
// in flight at d = 32 (a third of the bound).
//
// Design. A bag belongs to LW lanes of a warp, each lane owning V
// consecutive columns (V = 4, float4 loads, where d % 4 == 0 and the table
// is 16-byte aligned; else 2 or 1), LW = d / V rounded up to a power of two
// (8 at d = 32, so a warp serves 4 bags; 32 at most, columns beyond 32 * V
// taken in further passes). The slots go in windows of kWindow = 8: the
// group's lanes load the window's ids and weights (coalesced, in their own
// types, templated), pass them round by shuffles, then every lane issues
// its 8 row loads before it adds any, so a warp keeps 8 rows of each of its
// bags in flight. The launch bound holds a thread to 64 registers, 4 blocks
// (32 warps) an SM.
//
// What holds it now (scripts/bag_variants.py takes it apart): the float64
// sums and the latency of the gather at the occupancy 64 registers allow.
// Without the row loads it takes 41% of its time; with every row from one
// address, 68%; summing in float32 saves 5-7%; 79 registers (3 blocks an SM)
// or 48 with spills are slower; loading the next window's ids ahead of the
// adds gained nothing.
//
// The contract of the first design is kept: each product row * weight is
// rounded to float32, as the reference multiplies in the table's type
// (__fmul_rn, never contracted into an FMA), and the products are summed in
// float64 in slot order 0..L-1 and rounded once, so repeat runs give the
// same bits (two float32 orders of 50 N(0, 1) terms already differ by more
// than the reference's atol of 1e-6 where the sum cancels; the float64 sum
// agrees with the plain version, ref.py, to the last bit nearly always). The
// weight is multiplied, never branched on, so an inf or NaN in a masked-out
// row propagates as it does in the reference (inf * 0 = NaN). Row offsets
// are 64-bit. Ids must lie in [0, N), as for the reference's kernel; the
// clamp only keeps a bad id inside the table.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers a thread
constexpr int kWindow = 8;  // slots whose rows a lane loads before adding
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float* dst) {
  const typename Vec<V>::T x =
      __ldg(reinterpret_cast<const typename Vec<V>::T*>(src));
  if constexpr (V == 4) {
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (V == 2) {
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = x;
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* dst, const double* acc) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(
        __double2float_rn(acc[0]), __double2float_rn(acc[1]),
        __double2float_rn(acc[2]), __double2float_rn(acc[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(
        __double2float_rn(acc[0]), __double2float_rn(acc[1]));
  } else {
    *dst = __double2float_rn(acc[0]);
  }
}

__device__ __forceinline__ float weight(unsigned char m) {
  return m ? 1.0f : 0.0f;
}

__device__ __forceinline__ float weight(float m) { return m; }

// LW lanes a bag, V columns a lane a pass; ids of IdT (int or long long),
// the mask of MaskT (one byte a slot, or float32 weights).
template <int LW, int V, typename IdT, typename MaskT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_kernel(const float* __restrict__ table, long long n_rows, int d,
                     const IdT* __restrict__ ids,
                     const MaskT* __restrict__ mask,
                     long long n_bags, int l, float* __restrict__ out) {
  constexpr int kBags = 32 / LW;                 // bags a warp
  constexpr int kPer = (kWindow + LW - 1) / LW;  // window slots a lane loads
  const int lane = threadIdx.x & 31;
  const int k = lane % LW;                       // the lane within its group
  const long long warp0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kBags;
  if (warp0 >= n_bags) return;  // the whole warp leaves together
  const long long bag = warp0 + lane / LW;
  const bool live_bag = bag < n_bags;  // lanes past the last bag shuffle only
  const long long slot0 = (live_bag ? bag : 0) * l;
  const IdT* bag_ids = ids + slot0;
  const MaskT* bag_mask = mask + slot0;

  for (int c0 = k * V; c0 < LW * V * ((d + LW * V - 1) / (LW * V));
       c0 += LW * V) {
    const bool live_col = live_bag && c0 < d;
    double acc[V];
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = 0.0;
    for (int s0 = 0; s0 < l; s0 += kWindow) {
      // the window's ids and weights: lane k of the group loads slots
      // s0 + k + LW * u
      IdT my_id[kPer];
      float my_w[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int s = s0 + k + LW * u;
        my_id[u] = 0;
        my_w[u] = 0.0f;
        if (live_bag && s < l && s < s0 + kWindow) {
          const IdT id = __ldg(bag_ids + s);
          my_id[u] = id < 0 ? 0 : (id >= n_rows ? static_cast<IdT>(n_rows - 1) : id);
          my_w[u] = weight(__ldg(bag_mask + s));
        }
      }
      // every lane's row loads first, then the adds in slot order
      float row[kWindow][V];
      float w[kWindow];
#pragma unroll
      for (int t = 0; t < kWindow; ++t) {
        const long long id = __shfl_sync(kFull, my_id[t / LW], t % LW, LW);
        w[t] = __shfl_sync(kFull, my_w[t / LW], t % LW, LW);
        if (live_col && s0 + t < l) {
          load_row<V>(table + id * d + c0, row[t]);
        } else {
#pragma unroll
          for (int x = 0; x < V; ++x) row[t][x] = 0.0f;
        }
      }
#pragma unroll
      for (int t = 0; t < kWindow; ++t) {
        if (s0 + t < l) {
#pragma unroll
          for (int x = 0; x < V; ++x) {
            acc[x] += static_cast<double>(__fmul_rn(row[t][x], w[t]));
          }
        }
      }
    }
    if (live_col) store_row<V>(out + bag * d + c0, acc);
  }
}

template <int LW, int V, typename IdT, typename MaskT>
cudaError_t launch_typed(cudaStream_t stream, const float* table,
                         long long n_rows, int d, const void* ids,
                         const void* mask, long long n_bags, int l,
                         float* out) {
  constexpr long long per_block = static_cast<long long>(kWarps) * (32 / LW);
  const long long blocks = (n_bags + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<LW, V, IdT, MaskT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(table, n_rows, d, static_cast<const IdT*>(ids), static_cast<const MaskT*>(mask), n_bags, l, out);
  return cudaGetLastError();
}

template <int LW, int V>
cudaError_t launch(cudaStream_t stream, const float* table, long long n_rows,
                   int d, const void* ids, int ids_64, const void* mask,
                   int mask_float, long long n_bags, int l, float* out) {
  if (ids_64 && mask_float) {
    return launch_typed<LW, V, long long, float>(stream, table, n_rows, d, ids,
                                                 mask, n_bags, l, out);
  }
  if (ids_64) {
    return launch_typed<LW, V, long long, unsigned char>(
        stream, table, n_rows, d, ids, mask, n_bags, l, out);
  }
  if (mask_float) {
    return launch_typed<LW, V, int, float>(stream, table, n_rows, d, ids, mask,
                                           n_bags, l, out);
  }
  return launch_typed<LW, V, int, unsigned char>(stream, table, n_rows, d, ids,
                                                 mask, n_bags, l, out);
}

template <int V>
cudaError_t launch_lanes(cudaStream_t stream, const float* table,
                         long long n_rows, int d, const void* ids, int ids_64,
                         const void* mask, int mask_float, long long n_bags,
                         int l, float* out) {
  const int lanes = (d + V - 1) / V;  // lanes a pass would fill
  if (lanes <= 1) {
    return launch<1, V>(stream, table, n_rows, d, ids, ids_64, mask,
                        mask_float, n_bags, l, out);
  }
  if (lanes <= 2) {
    return launch<2, V>(stream, table, n_rows, d, ids, ids_64, mask,
                        mask_float, n_bags, l, out);
  }
  if (lanes <= 4) {
    return launch<4, V>(stream, table, n_rows, d, ids, ids_64, mask,
                        mask_float, n_bags, l, out);
  }
  if (lanes <= 8) {
    return launch<8, V>(stream, table, n_rows, d, ids, ids_64, mask,
                        mask_float, n_bags, l, out);
  }
  if (lanes <= 16) {
    return launch<16, V>(stream, table, n_rows, d, ids, ids_64, mask,
                         mask_float, n_bags, l, out);
  }
  return launch<32, V>(stream, table, n_rows, d, ids, ids_64, mask,
                       mask_float, n_bags, l, out);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (d % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {
    err = launch_lanes<4>(s, t, n_rows, d, ids, ids_64, mask, mask_float,
                          n_bags, l, o);
  } else if (d % 2 == 0 && aligned(table, 8) && aligned(out, 8)) {
    err = launch_lanes<2>(s, t, n_rows, d, ids, ids_64, mask, mask_float,
                          n_bags, l, o);
  } else {
    err = launch_lanes<1>(s, t, n_rows, d, ids, ids_64, mask, mask_float,
                          n_bags, l, o);
  }
  return static_cast<int>(err);
}
