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
// count varies: the grid is sized for the buffer's capacity, at most a few
// blocks an SM, and walks tiles of entries; blocks past this request's
// entries exit right after reading the counts.
//
// A block first turns the counts into each bucket's first entry and first
// word with one warp's scan in shared memory. A buffer whose counts are
// negative, whose entries exceed the capacity or whose words exceed the
// buffer is bad and writes nothing, nor does an entry whose row index lies
// outside the output. A tile holds E entries, L = min(ceil(d / 4), 256)
// threads an entry, each thread four consecutive columns of it (more
// groups of four where d > 1,024): it finds the entry's bucket by a binary
// search of the ≤ 16 bucket starts, loads the row index once and the
// packed words that hold its four codes once (≤ 5 words at b ≤ 31; 1–2 at
// DLRM's b ≤ 6), takes each code as src/repro/core/packing.py lays it out
// (bits j * b .. j * b + b - 1, the unsigned value u, code = u + N_b with
// N_b = -2^(b-1)) and writes __fmaf_rn(alpha_b, code, beta_j): one
// rounding, as the port's lookup and its plain version (torch.addcmul)
// dequantize, so a cold row is bit-identical to the same row served from
// the monolithic table. Stores are 16 bytes where d % 4 == 0, 8 where d is
// even, 4 otherwise; index math is 32-bit where every offset fits.
//
// What bounds it on an H100 (3.35 TB/s): the bytes it must move are the
// staged buffer's used words, read once, and the K * d float32 outputs,
// written once (chip_smoke.py::cold_bytes counts them from the run's
// buffer); at d = 16 the outputs are most of it.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuckets = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // a full card's worth of blocks

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

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[5], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : i == 3 ? w[3] : w[4];
}

// SW: floats a store (4, 2 or 1); I: index type of every offset.
template <int SW, typename I>
__global__ void __launch_bounds__(kThreads)
tiered_cold_kernel(const int* __restrict__ buf, long long n_words,
                   long long capacity, float* __restrict__ out, I n_out,
                   const __grid_constant__ ColdPlan plan, int lanes,
                   int tile) {
  __shared__ I s_first[kMaxBuckets + 1];   // first entry of a bucket
  __shared__ I s_word[kMaxBuckets + 1];    // its first word
  const int nb = plan.n_buckets;
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    long long c = 0, w = 0;
    if (i < nb) {
      c = __ldg(buf + i);
      if (plan.bits[i] == 0 && c > 0) c = -1;   // no rows of the zero width
      w = c * plan.wpr[i];
    }
    const bool bad = __any_sync(0xffffffffu, c < 0);
    // inclusive scans of the counts and of their words
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long c_up = __shfl_up_sync(0xffffffffu, c, off);
      const long long w_up = __shfl_up_sync(0xffffffffu, w, off);
      if (i >= off) {
        c += c_up;
        w += w_up;
      }
    }
    const long long k = __shfl_sync(0xffffffffu, c, 31);
    const long long words = __shfl_sync(0xffffffffu, w, 31);
    const bool ok = !bad && k <= capacity && nb + k + words <= n_words;
    const long long c_ex = __shfl_up_sync(0xffffffffu, c, 1);
    const long long w_ex = __shfl_up_sync(0xffffffffu, w, 1);
    if (i <= nb) {
      s_first[i] = ok && i > 0 ? static_cast<I>(c_ex) : 0;
      s_word[i] = ok && i > 0 ? static_cast<I>(w_ex) : 0;
    }
  }
  __syncthreads();
  const I n_entries = s_first[nb];
  const int e_local = threadIdx.x / lanes;
  if (e_local >= tile) return;
  const int lane = threadIdx.x - e_local * lanes;
  const int d = plan.d;
  const int quads = (d + 3) / 4;
  const int* pos = buf + nb;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf + nb + n_entries);
  for (I k = static_cast<I>(blockIdx.x) * tile + e_local; k < n_entries;
       k += static_cast<I>(gridDim.x) * tile) {
    int i = 0;
#pragma unroll
    for (int step = 8; step > 0; step >>= 1) {
      if (i + step < nb && s_first[i + step] <= k) i += step;
    }
    const I r = __ldg(pos + k);
    if (r < 0 || r >= n_out) continue;   // a bad row index writes nothing
    const int b = plan.bits[i];
    const int wpr = plan.wpr[i];
    const uint32_t* row = words + s_word[i] + (k - s_first[i]) * wpr;
    const float alpha = __ldg(plan.alpha + i);
    const uint32_t mask = (1u << b) - 1u;
    const int neg = 1 << (b - 1);
    float* dst = out + r * d;
    for (int q = lane; q < quads; q += lanes) {
      const int j0 = 4 * q;
      const int nj = min(4, d - j0);
      const int w0 = (j0 * b) >> 5;
      const int wl = ((j0 + nj) * b - 1) >> 5;
      uint32_t w[5];
#pragma unroll
      for (int u = 0; u < 5; ++u) w[u] = w0 + u <= wl ? __ldg(row + w0 + u) : 0u;
      float be[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (SW == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(plan.beta + j0));
        be[0] = v.x; be[1] = v.y; be[2] = v.z; be[3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < nj) be[u] = __ldg(plan.beta + j0 + u);
        }
      }
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rel = (j0 + u) * b - 32 * w0;
        const uint32_t bits = __funnelshift_r(pick(w, rel >> 5),
                                              pick(w, (rel >> 5) + 1),
                                              rel & 31) & mask;
        o[u] = __fmaf_rn(alpha, static_cast<float>(static_cast<int>(bits) - neg),
                         be[u]);
      }
      if constexpr (SW == 4) {
        *reinterpret_cast<float4*>(dst + j0) = make_float4(o[0], o[1], o[2],
                                                           o[3]);
      } else if constexpr (SW == 2) {
        *reinterpret_cast<float2*>(dst + j0) = make_float2(o[0], o[1]);
        if (nj > 2) *reinterpret_cast<float2*>(dst + j0 + 2) = make_float2(o[2], o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < nj) dst[j0 + u] = o[u];
        }
      }
    }
  }
}

template <int SW, typename I>
int launch(const ColdPlan& plan, const int* buf, long long n_words,
           long long capacity, float* out, long long n_out, int lanes,
           int tile, cudaStream_t stream) {
  const long long tiles = (capacity + tile - 1) / tile;
  const long long blocks = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  tiered_cold_kernel<SW, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(buf, n_words, capacity, out, static_cast<I>(n_out), plan, lanes, tile);
  return static_cast<int>(cudaGetLastError());
}

template <int SW>
int dispatch_index(const ColdPlan& plan, const int* buf, long long n_words,
                   long long capacity, float* out, long long n_out, int lanes,
                   int tile, cudaStream_t stream) {
  const bool small = n_words < (1ll << 31) && n_out * plan.d < (1ll << 31);
  return small ? launch<SW, int>(plan, buf, n_words, capacity, out, n_out,
                                 lanes, tile, stream)
               : launch<SW, long long>(plan, buf, n_words, capacity, out,
                                       n_out, lanes, tile, stream);
}

}  // namespace

// The size of the descriptor, which the wrapper checks against its mirror.
extern "C" int tiered_cold_plan_bytes() {
  return static_cast<int>(sizeof(ColdPlan));
}

// Launches the cold fill on `stream` and returns cudaGetLastError()
// (0 = ok). plan: a host ColdPlan whose pointers are device addresses; buf:
// the staged buffer on the device, n_words long, holding at most
// `capacity` entries; out: (n_out, d) float32 on the device, written only
// at the entries' rows.
extern "C" int tiered_cold(const void* plan_ptr, const void* buf,
                           long long n_words, long long capacity, void* out,
                           long long n_out, void* stream) {
  const ColdPlan& plan = *static_cast<const ColdPlan*>(plan_ptr);
  if (plan.n_buckets < 1 || plan.n_buckets > kMaxBuckets || plan.d < 1 ||
      capacity < 0 || n_out < 0 || n_words < plan.n_buckets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < plan.n_buckets; ++i) {
    if (plan.bits[i] < 0 || plan.bits[i] > 31 ||
        (plan.bits[i] > 0 && plan.wpr[i] != (plan.d * plan.bits[i] + 31) / 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (capacity == 0 || n_out == 0) return 0;
  const int quads = (plan.d + 3) / 4;
  const int lanes = quads < kThreads ? quads : kThreads;
  const int tile = kThreads / lanes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  const uintptr_t beta = reinterpret_cast<uintptr_t>(plan.beta);
  const int* b = static_cast<const int*>(buf);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.d % 4 == 0 && base % 16 == 0 && beta % 16 == 0) {
    return dispatch_index<4>(plan, b, n_words, capacity, o, n_out, lanes, tile, st);
  }
  if (plan.d % 2 == 0 && base % 8 == 0) {
    return dispatch_index<2>(plan, b, n_words, capacity, o, n_out, lanes, tile, st);
  }
  return dispatch_index<1>(plan, b, n_words, capacity, o, n_out, lanes, tile, st);
}
