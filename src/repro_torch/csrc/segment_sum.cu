// The backward of a row gather for Hopper (sm_90a): the (T, w) rows of the
// upstream gradient summed by the gather's index into a dense (N, w)
// gradient,
//
//   out[n] = sum over t with ids[t] == n of grad[t],
//
// from the index sorted stably (the wrapper sorts it with torch.sort; the
// t-th sorted id came from position order[t]). Each sum runs in float64 in
// a fixed order and is rounded to float32 once; no float atomics: two runs
// give the same bits.
//
// The bag form (segment_sum_bag) is the embedding bag's backward: grad is
// the bag cotangent g (B, w), and the row summed for position t of the
// (B, L) ids is g[t / L] * weights[t], formed in float32 (__fmul_rn) as the
// plain version forms it, so the (B * L, w) products are never written to
// device memory. The gather's form is the same code with that step left out.
//
// No TPU kernel has this function: the reference differentiates its
// gathers with XLA's scatter-add. It replaces, on the port's path, the
// library's dense embedding backward (aten::embedding_dense_backward), whose
// last pass sums each segment's partial sums in one thread per (segment,
// column), one after another: a Zipf batch gives the lookup's hot groups
// and items segments of a million rows and more, and that one thread's
// walk holds the step.
//
// What bounds it on an H100 (3.35 TB/s): bytes. It reads every gradient
// row, sorted id and position once and writes the dense gradient (whose
// rows with no index the wrapper zeroes first).
//
// Design. The T sorted positions are cut into chunks of kChunk. A worker,
// LW = ceil(w / CPL) lanes of one warp with CPL columns each, walks one
// chunk in order, kAhead positions' ids and rows loaded ahead, summing
// each segment's rows in float64. A segment that starts and ends inside
// the chunk is written at once. A chunk's first segment, if it started in
// an earlier chunk, goes to the chunk's continuation partial; its last, if
// it goes on into the next chunk and started in this one, to its start
// partial. The second kernel gives each chunk holding a start partial one
// block: it finds the last chunk the segment reaches (a binary search over
// the chunks' first ids), adds the continuation partials of the chunks in
// between (a few in order by one thread per column; many by strided sums
// over the block's threads and a tree), then the start partial, and writes
// the segment once. A segment of a million rows is so cut over 16 K chunks
// summed by as many workers, whose partials 256 threads add.
//
// Width. A worker's lanes hold at most kMaxW = 256 columns. A wider row
// (GIN's first layer sums raw node features, 1,433 wide on cora) is cut
// into column tiles of at most kMaxW, each launched over the same sorted
// positions with the row stride `ld` of the full width, one after another
// on the stream, so nothing is copied. A tile's sums are the whole row's
// sums of its columns, so the result does not depend on the cut.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;        // sorted positions a worker sums in order
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 256;
constexpr int kCombineThreads = 256;
constexpr int kSerial = 32;       // continuation partials one thread sums
constexpr int kIlp = 8;           // independent sums a thread keeps

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

// The chunk partials (both (w, n_chunks), column-major) and the flags that
// say which chunks hold a start partial.
struct Partials {
  double* cont;
  double* start;
  unsigned char* has_start;
};

// The bag form's rows: grad row t / l, scaled by weights[t].
struct BagRows {
  const float* weights;  // (n_pos,) float32; null in the gather's form
  unsigned l;            // slots a bag
};

// V floats a load, CPL columns a lane (a multiple of V), kAhead positions
// loaded ahead; kBag: the bag form. w columns of rows ld floats apart, in
// grad and out alike.
template <int V, int CPL, int kAhead, bool kBag>
__global__ void __launch_bounds__(kThreads)
segment_chunk_kernel(const float* __restrict__ grad,
                     const int* __restrict__ ids,
                     const long long* __restrict__ order, long long n_pos,
                     int w, long long ld, long long n_chunks,
                     float* __restrict__ out, Partials part, BagRows bag) {
  const int lw = (w + CPL - 1) / CPL;
  const int per_warp = 32 / lw;
  const int lane = threadIdx.x & 31;
  const int slot = lane / lw, k = lane - slot * lw;
  const long long chunk =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
          per_warp + slot;
  if (slot >= per_warp || chunk >= n_chunks) return;  // no barriers below
  const int c0 = k * CPL;
  const long long t0 = chunk * kChunk;
  const long long t1 = t0 + kChunk < n_pos ? t0 + kChunk : n_pos;
  const long long prev = t0 > 0 ? ids[t0 - 1] : -1;
  const long long next = t1 < n_pos ? ids[t1] : -1;

  double acc[CPL];
#pragma unroll
  for (int x = 0; x < CPL; ++x) acc[x] = 0.0;
  if (k == 0) part.has_start[chunk] = 0;
  long long cur = ids[t0];
  bool first = true;  // cur is the chunk's first segment

  // a finished segment: complete, the continuation or the start partial
  auto flush = [&](bool last) {
    const bool before = first && cur == prev;
    const bool after = last && cur == next;
    if (!before && !after) {
#pragma unroll
      for (int x = 0; x < CPL; ++x) {
        if (c0 + x < w) out[cur * ld + c0 + x] = static_cast<float>(acc[x]);
      }
      return;
    }
    double* dst = before ? part.cont : part.start;
#pragma unroll
    for (int x = 0; x < CPL; ++x) {
      if (c0 + x < w) dst[static_cast<long long>(c0 + x) * n_chunks + chunk] = acc[x];
    }
    if (!before && k == 0) part.has_start[chunk] = 1;
  };

  for (long long t = t0; t < t1; t += kAhead) {
    int sid[kAhead];
    float row[kAhead][CPL];
    float scale[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool in = t + u < t1;
      sid[u] = in ? ids[t + u] : 0;
      long long src = in ? order[t + u] : 0;
      if constexpr (kBag) {
        scale[u] = in ? bag.weights[src] : 0.0f;
        src = static_cast<unsigned>(src) / bag.l;  // the position's bag
      }
#pragma unroll
      for (int x = 0; x < CPL; x += V) {
        if (in && c0 + x < w) {
          load_vec<V>(grad + src * ld + c0 + x, row[u] + x);
        } else {
#pragma unroll
          for (int y = 0; y < V; ++y) row[u][x + y] = 0.0f;
        }
      }
    }
    if constexpr (kBag) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int x = 0; x < CPL; ++x) row[u][x] = __fmul_rn(row[u][x], scale[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t + u >= t1) break;
      if (sid[u] != cur) {
        flush(false);
        first = false;
        cur = sid[u];
#pragma unroll
        for (int x = 0; x < CPL; ++x) acc[x] = 0.0;
      }
#pragma unroll
      for (int x = 0; x < CPL; ++x) acc[x] += static_cast<double>(row[u][x]);
    }
  }
  flush(true);
}

// One block per chunk; a chunk holding a start partial writes its segment:
// the start partial plus the continuation partials of the chunks it
// reaches, in float64. Up to kSerial of them are summed in chunk order by
// one thread per column; more (a hot segment) by every thread of the block,
// kIlp independent strided sums each, then a tree, column by column.
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const int* __restrict__ ids, long long n_pos, int w,
                       long long ld, long long n_chunks, Partials part,
                       float* __restrict__ out) {
  const long long c = blockIdx.x;
  if (!part.has_start[c]) return;  // the same for the whole block
  __shared__ long long reach;
  __shared__ double scratch[kCombineThreads];
  const int tid = threadIdx.x;
  const long long t1 = (c + 1) * kChunk < n_pos ? (c + 1) * kChunk : n_pos;
  const long long seg = ids[t1 - 1];
  if (tid == 0) {  // the last chunk whose first id is seg
    long long lo = c + 1, hi = n_chunks - 1;
    while (lo < hi) {
      const long long mid = (lo + hi + 1) / 2;
      if (ids[mid * kChunk] == seg) lo = mid; else hi = mid - 1;
    }
    reach = lo;
  }
  __syncthreads();
  const long long n = reach - c;  // continuation chunks c + 1 .. reach
  if (n <= kSerial) {
    for (int col = tid; col < w; col += kCombineThreads) {
      const long long at = static_cast<long long>(col) * n_chunks + c;
      double s = part.start[at];
      for (long long x = 1; x <= n; ++x) s += part.cont[at + x];
      out[seg * ld + col] = static_cast<float>(s);
    }
    return;
  }
  for (int col = 0; col < w; ++col) {
    const long long at = static_cast<long long>(col) * n_chunks + c;
    const double* cont = part.cont + at + 1;
    double s[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) s[u] = 0.0;
    for (long long x = tid; x < n; x += kIlp * kCombineThreads) {
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const long long y = x + u * kCombineThreads;
        if (y < n) s[u] += cont[y];
      }
    }
#pragma unroll
    for (int u = 1; u < kIlp; ++u) s[0] += s[u];
    scratch[tid] = s[0];
    __syncthreads();
    for (int step = kCombineThreads / 2; step > 0; step >>= 1) {
      if (tid < step) scratch[tid] += scratch[tid + step];
      __syncthreads();
    }
    if (tid == 0) {
      out[seg * ld + col] = static_cast<float>(part.start[at] + scratch[0]);
    }
    __syncthreads();
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int V, int CPL, int kAhead, bool kBag>
cudaError_t launch(const float* grad, const int* ids, const long long* order,
                   long long n_pos, int w, long long ld, long long n_chunks,
                   float* out, Partials part, BagRows bag, cudaStream_t st) {
  const int per_warp = 32 / ((w + CPL - 1) / CPL);
  const long long per_block = static_cast<long long>(per_warp) * kWarps;
  const long long blocks = (n_chunks + per_block - 1) / per_block;
  if (blocks > INT_MAX || n_chunks > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  auto chunks = segment_chunk_kernel<V, CPL, kAhead, kBag>;
  chunks<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      grad, ids, order, n_pos, w, ld, n_chunks, out, part, bag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned owners = static_cast<unsigned>(n_chunks);  // one per chunk
  segment_combine_kernel<<<owners, kCombineThreads, 0, st>>>(
      ids, n_pos, w, ld, n_chunks, part, out);
  return cudaGetLastError();
}

long long chunks_of(long long n_pos) {
  return n_pos < 1 ? 0 : (n_pos + kChunk - 1) / kChunk;
}

template <bool kBag>
int run(const void* grad, const void* ids, const void* order, long long n_pos,
        int w, void* out, void* scratch, void* flags, BagRows bag,
        void* stream) {
  if (n_pos < 0 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  const long long n_chunks = chunks_of(n_pos);
  const int tile = w < kMaxW ? w : kMaxW;
  double* s = static_cast<double*>(scratch);
  const Partials part{s, s + static_cast<long long>(tile) * n_chunks,
                      static_cast<unsigned char*>(flags)};
  const auto* i = static_cast<const int*>(ids);
  const auto* o = static_cast<const long long*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the column tiles, one after another on the stream: each reuses the
  // partials the one before it has finished with
  for (int c = 0; c < w; c += kMaxW) {
    const int tw = w - c < kMaxW ? w - c : kMaxW;
    const float* g = static_cast<const float*>(grad) + c;
    float* y = static_cast<float*>(out) + c;
    cudaError_t err;
    // rows of up to 8 columns (the group probabilities) take the scalar one
    const bool vec = tw > 8 && tw <= 128;
    if (vec && tw % 4 == 0 && w % 4 == 0 && aligned(g, 16)) {
      err = launch<4, 4, 8, kBag>(g, i, o, n_pos, tw, w, n_chunks, y, part,
                                  bag, st);
    } else if (vec && tw % 2 == 0 && w % 2 == 0 && aligned(g, 8)) {
      err = launch<2, 4, 8, kBag>(g, i, o, n_pos, tw, w, n_chunks, y, part,
                                  bag, st);
    } else {
      err = launch<1, 8, 4, kBag>(g, i, o, n_pos, tw, w, n_chunks, y, part,
                                  bag, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Chunks of n_pos sorted positions: the scratch needs 2 * min(w, 256) *
// chunks doubles and chunks flag bytes.
extern "C" long long segment_sum_chunks(long long n_pos) {
  return chunks_of(n_pos);
}

// On `stream`; returns cudaGetLastError() (0 = ok). Device pointers: grad
// (n_pos, w) float32; ids (n_pos,) int32, sorted, each in [0, n_out);
// order (n_pos,) int64, the gradient row of each sorted position; out
// (n_out, w) float32, zeroed by the caller; scratch 2 * min(w, 256) *
// chunks doubles and flags `chunks` bytes (segment_sum_chunks). All
// contiguous. Any w >= 1: rows wider than 256 are summed in column tiles.
extern "C" int segment_sum(const void* grad, const void* ids, const void* order,
                           long long n_pos, int w, void* out, void* scratch,
                           void* flags, void* stream) {
  return run<false>(grad, ids, order, n_pos, w, out, scratch, flags,
                    BagRows{nullptr, 1}, stream);
}

// The bag form: grad (n_pos / l, w) float32, the bag cotangent; weights
// (n_pos,) float32, the (B, L) mask as weights; l >= 1 slots a bag and
// n_pos < 2^32; ids, order, out, scratch and flags as for segment_sum, over
// the B * L positions.
extern "C" int segment_sum_bag(const void* grad, const void* weights, int l,
                               const void* ids, const void* order,
                               long long n_pos, int w, void* out,
                               void* scratch, void* flags, void* stream) {
  if (l < 1 || n_pos > static_cast<long long>(UINT_MAX) || n_pos % l != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run<true>(grad, ids, order, n_pos, w, out, scratch, flags,
                   BagRows{static_cast<const float*>(weights),
                           static_cast<unsigned>(l)},
                   stream);
}
