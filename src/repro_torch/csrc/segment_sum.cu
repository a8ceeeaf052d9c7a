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
// library's dense embedding backward (aten::embedding_dense_backward) and,
// for GIN's and the MoE's scatters, index_add_ and index_put_ with
// accumulate.
//
// What bounds it on an H100 (3.35 TB/s): bytes. It reads every gradient
// row, sorted id and position once and writes the dense gradient (whose
// rows with no index the wrapper zeroes first).
//
// Design. The T sorted positions are cut into chunks of kChunk. A segment
// belongs to the chunk it starts in, whose worker (LW = ceil(tw / CPL)
// lanes of one warp, CPL columns each) sums it in float64, kAhead
// positions' ids and rows loaded ahead. A segment that ends inside its
// chunk or the next is short: the worker walks on into the next chunk and
// writes it whole, and that chunk's worker skips its rows. So a batch of
// short segments (GIN's edges, uniform ids) needs no second pass at all.
// A segment that reaches a third chunk is long. Its rows are summed in
// parts, one a chunk slot: its owner's rows (its chunk and the next) into
// the slot of the next chunk, and each later chunk's rows into that
// chunk's own slot; so a chunk's slot holds at most one part, and the parts
// take n_chunks × w doubles. The owner finds the segment's last chunk (a
// binary search over the chunks' first ids) and appends its slices of at
// most kSlice parts to a work list, with an integer atomic (the list's
// order changes no sum).
//
// The combine walks that list only: a fixed grid of a few blocks an SM,
// each unit a (slice, column slice of C columns). A thread owns a column
// and one of 256 / C groups; the groups sum the slice's parts in a fixed
// stride, then a fixed tree adds the groups. A segment of one slice is
// written at once; a longer one (SASRec's 1.7 M-row segment, ~26,000
// parts) writes each slice's total over the slice's first part, and the
// last unit to finish (an integer ticket) adds the slices in order and
// writes the segment. A wide hot segment (the MoE's ~50,000 rows of 2,048)
// so spreads over 64 column slices × its slices of blocks.
//
// Width and loads. A worker's lanes hold at most kMaxW = 256 columns; a
// wider row is cut into column tiles of kMaxW, the tiles a grid dimension
// of the one launch (the row stride `ld` is the full width, nothing is
// copied; a tile's sums are the whole row's sums of its columns). Lane k
// loads V floats at tile column (j · LW + k) · V for its j-th vector, so
// neighbouring lanes read neighbouring addresses: 16-byte loads wherever w
// is a multiple of 4 and the rows 16-byte aligned (256-column tiles too),
// 8-byte where w is even. Rows of at most 8 columns (the group
// probabilities, gates) take a lane a column and 16 positions ahead: a
// warp then walks four chunks or more at once, and one load instruction
// reads a row's columns together.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;        // sorted positions a chunk holds
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 256;        // columns of a tile
constexpr int kCombineThreads = 256;
constexpr int kSlice = 256;       // parts a combine unit sums
constexpr int kCombineBlocksPerSm = 4;

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
__device__ __forceinline__ void store_vec(float* dst, const double* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(
        static_cast<float>(src[0]), static_cast<float>(src[1]),
        static_cast<float>(src[2]), static_cast<float>(src[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(static_cast<float>(src[0]),
                                                  static_cast<float>(src[1]));
  } else {
    dst[0] = static_cast<float>(src[0]);
  }
}

// The combine's work: a long segment's slice of parts.
struct Unit {
  int start;    // the chunk the segment starts in: its parts fill the
  int last;     // slots start + 1 .. last
  int slice;    // parts start + 1 + slice · kSlice .. on
  int seg;      // the segment's id
};

// The wrapper's scratch, carved by Layout: the parts (n_chunks, w) float64,
// the work list, its length and the tickets (zeroed before each launch).
struct Scratch {
  double* part;
  Unit* list;
  int* count;     // units in the list
  int* tickets;   // one a (long segment of several slices, column slice)
};

// The bag form's rows: grad row t / l, scaled by weights[t].
struct BagRows {
  const float* weights;  // (n_pos,) float32; null in the gather's form
  unsigned l;            // slots a bag
};

long long chunks_of(long long n_pos) {
  return n_pos < 1 ? 0 : (n_pos + kChunk - 1) / kChunk;
}

// Columns a combine unit takes: a warp's 32, or the row's width rounded up
// to a power of two.
int combine_cols(int w) {
  int c = 1;
  while (c < w && c < 32) c *= 2;
  return c;
}

struct Layout {
  long long n_chunks, units, tickets;   // list capacity, ticket count
  long long list_at, count_at, bytes;   // byte offsets and the total
  int cols, col_slices;

  Layout(long long n_pos, int w) {
    n_chunks = chunks_of(n_pos);
    cols = combine_cols(w);
    col_slices = (w + cols - 1) / cols;
    // a long segment fills two slots or more, so at most n_chunks / 2 of
    // them; each adds a slice a kSlice of its slots, and one
    units = n_chunks / 2 + n_chunks / kSlice + 2;
    // a segment of several slices spans more than kSlice slots, so its
    // first slot / kSlice is its own
    tickets = (n_chunks / kSlice + 1) * col_slices;
    list_at = n_chunks * w * static_cast<long long>(sizeof(double));
    count_at = list_at + units * static_cast<long long>(sizeof(Unit));
    bytes = count_at + (1 + tickets) * static_cast<long long>(sizeof(int));
  }

  Scratch carve(void* base) const {
    char* p = static_cast<char*>(base);
    int* count = reinterpret_cast<int*>(p + count_at);
    return Scratch{reinterpret_cast<double*>(p),
                   reinterpret_cast<Unit*>(p + list_at), count, count + 1};
  }
};

// V floats a load, CPL columns a lane (a multiple of V), kAhead positions
// loaded ahead; kBag: the bag form. Grid (chunk groups, column tiles); w
// columns in all, the rows w floats apart in grad and out alike.
template <int V, int CPL, int kAhead, bool kBag>
__global__ void __launch_bounds__(kThreads)
segment_chunk_kernel(const float* __restrict__ grad,
                     const int* __restrict__ ids,
                     const long long* __restrict__ order, long long n_pos,
                     int w, long long n_chunks, float* __restrict__ out,
                     Scratch sc, BagRows bag) {
  constexpr int NV = CPL / V;
  const int c0 = blockIdx.y * kMaxW;
  const int tw = min(kMaxW, w - c0);
  const int lw = (tw + CPL - 1) / CPL;
  const int per_warp = 32 / lw;
  const int lane = threadIdx.x & 31;
  const int slot = lane / lw, k = lane - slot * lw;
  const long long chunk =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
          per_warp + slot;
  if (slot >= per_warp || chunk >= n_chunks) return;  // no barriers below
  const long long t0 = chunk * kChunk;
  const long long t1 = t0 + kChunk < n_pos ? t0 + kChunk : n_pos;
  const int first_id = ids[t0], last_id = ids[t1 - 1];
  // The chunk's first segment, where it began in an earlier chunk: its
  // owner sums it if that is the chunk before (skip); else it is long, and
  // this chunk's rows of it are a part (part_first).
  bool skip = false, part_first = false;
  if (t0 > 0 && ids[t0 - 1] == first_id) {
    if (chunk == 1 || ids[t0 - kChunk - 1] != first_id) {
      skip = true;
    } else {
      part_first = true;
    }
  }
  // the owner of the last segment walks it on through the next chunk
  const bool owns_last = last_id != first_id || !(skip || part_first);
  long long t_lim = t1;
  if (owns_last && t1 < n_pos && ids[t1] == last_id) {
    t_lim = t1 + kChunk < n_pos ? t1 + kChunk : n_pos;
  }

  double acc[CPL];
#pragma unroll
  for (int x = 0; x < CPL; ++x) acc[x] = 0.0;
  int cur = first_id;
  bool first = true;    // cur is the chunk's first segment

  auto column = [&](int j) { return (j * lw + k) * V; };  // in the tile
  auto write_part = [&](long long at) {
    double* dst = sc.part + at * w + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int y = 0; y < V; ++y) {
        if (column(j) + y < tw) dst[column(j) + y] = acc[j * V + y];
      }
    }
  };
  auto write_out = [&]() {
    float* dst = out + static_cast<long long>(cur) * w + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      // V > 1 takes whole vectors: tw is then a multiple of V
      if (column(j) < tw) store_vec<V>(dst + column(j), acc + j * V);
    }
  };
  // a segment finished inside the walk: a part or whole
  auto flush = [&]() {
    if (first && part_first) {
      write_part(chunk);
    } else if (!(first && skip)) {
      write_out();
    }
  };

  bool done = false;
  for (long long t = t0; t < t_lim && !done; t += kAhead) {
    int sid[kAhead];
    bool in[kAhead];
    float row[kAhead][CPL];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long p = t + u;
      sid[u] = p < t_lim ? ids[p] : -1;
      // not the skipped first segment; past the chunk, the walked one only
      in[u] = p < t_lim && !(skip && sid[u] == first_id) &&
              (p < t1 || sid[u] == last_id);
      long long src = in[u] ? order[p] : 0;
      float scale = 1.0f;
      if constexpr (kBag) {
        scale = in[u] ? bag.weights[src] : 0.0f;
        src = static_cast<unsigned>(src) / bag.l;  // the position's bag
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (in[u] && column(j) < tw) {
          load_vec<V>(grad + src * w + c0 + column(j), row[u] + j * V);
        } else {
#pragma unroll
          for (int y = 0; y < V; ++y) row[u][j * V + y] = 0.0f;
        }
      }
      if constexpr (kBag) {
#pragma unroll
        for (int x = 0; x < CPL; ++x) row[u][x] = __fmul_rn(row[u][x], scale);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (!in[u]) {
        if (t + u >= t1) {   // past the chunk and the walked segment's end
          done = true;
          break;
        }
        continue;            // a row of the skipped first segment
      }
      if (sid[u] != cur) {
        flush();
        first = false;
        cur = sid[u];
#pragma unroll
        for (int x = 0; x < CPL; ++x) acc[x] = 0.0;
      }
#pragma unroll
      for (int x = 0; x < CPL; ++x) acc[x] += static_cast<double>(row[u][x]);
    }
  }
  if (first && skip) return;          // the whole chunk was another's
  const bool long_seg = t_lim > t1 && t_lim < n_pos && ids[t_lim] == cur;
  if (!long_seg) {
    flush();
    return;
  }
  // a long segment's first part: its rows in this chunk and the next
  write_part(chunk + 1);
  if (blockIdx.y != 0 || k != 0) return;  // one worker lists its slices
  long long lo = chunk + 2, hi = n_chunks - 1;  // its last chunk
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    if (ids[mid * kChunk] == cur) lo = mid; else hi = mid - 1;
  }
  const int slices = static_cast<int>((lo - chunk + kSlice - 1) / kSlice);
  const int at = atomicAdd(sc.count, slices);
  for (int s = 0; s < slices; ++s) {
    sc.list[at + s] = Unit{static_cast<int>(chunk), static_cast<int>(lo), s,
                           cur};
  }
}

// A fixed grid walks the units × column slices: a thread a column (cols of
// them a unit) and one of kCombineThreads / cols groups.
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(int w, int cols, int col_slices, Scratch sc,
                       float* __restrict__ out) {
  __shared__ double s_sum[kCombineThreads];
  __shared__ bool s_last;
  const int groups = kCombineThreads / cols;
  const int lane = threadIdx.x % cols, g = threadIdx.x / cols;
  const long long units = static_cast<long long>(*sc.count) * col_slices;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit e = sc.list[u / col_slices];
    const int cs = static_cast<int>(u % col_slices);
    const int col = cs * cols + lane;
    const long long first = e.start + 1 + static_cast<long long>(e.slice) * kSlice;
    const long long end = first + kSlice < e.last + 1LL ? first + kSlice
                                                         : e.last + 1LL;
    double s = 0.0;
    if (col < w) {
      for (long long x = first + g; x < end; x += groups) {
        s += sc.part[x * w + col];
      }
    }
    s_sum[threadIdx.x] = s;
    __syncthreads();
    for (int step = groups / 2; step > 0; step >>= 1) {
      if (g < step) s_sum[threadIdx.x] += s_sum[threadIdx.x + step * cols];
      __syncthreads();
    }
    const int slices = (e.last - e.start + kSlice - 1) / kSlice;
    float* dst = out + static_cast<long long>(e.seg) * w + col;
    if (slices == 1) {
      if (g == 0 && col < w) *dst = static_cast<float>(s_sum[lane]);
    } else {
      // the slice's total over its first part, which only this unit read
      if (g == 0 && col < w) sc.part[first * w + col] = s_sum[lane];
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        const int at = (e.start + 1) / kSlice * col_slices + cs;
        s_last = atomicAdd(sc.tickets + at, 1) == slices - 1;
      }
      __syncthreads();
      if (s_last && g == 0 && col < w) {   // the slices' totals, in order
        __threadfence();
        double tot = 0.0;
        for (int j = 0; j < slices; ++j) {
          tot += __ldcg(sc.part + (e.start + 1 + static_cast<long long>(j) * kSlice) * w + col);
        }
        *dst = static_cast<float>(tot);
      }
    }
    __syncthreads();   // s_sum and s_last serve the next unit
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int combine_blocks() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return kCombineBlocksPerSm * sms;
}

template <int V, int CPL, int kAhead, bool kBag>
cudaError_t launch(const float* grad, const int* ids, const long long* order,
                   long long n_pos, int w, float* out, const Layout& lay,
                   Scratch sc, BagRows bag, cudaStream_t st) {
  // the first tile is the widest: its workers a warp set the grid
  const int tw = w < kMaxW ? w : kMaxW;
  const int per_warp = 32 / ((tw + CPL - 1) / CPL);
  const long long per_block = static_cast<long long>(per_warp) * kWarps;
  const long long blocks = (lay.n_chunks + per_block - 1) / per_block;
  const int tiles = (w + kMaxW - 1) / kMaxW;
  if (blocks > INT_MAX || lay.n_chunks > INT_MAX || tiles > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaMemsetAsync(sc.count, 0,
                                    (1 + lay.tickets) * sizeof(int), st);
  if (err != cudaSuccess) return err;
  auto chunks = segment_chunk_kernel<V, CPL, kAhead, kBag>;
  chunks<<<dim3(static_cast<unsigned>(blocks), tiles), kThreads, 0, st>>>(grad, ids, order, n_pos, w, lay.n_chunks, out, sc, bag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long most = lay.units * lay.col_slices;
  const int grid = most < combine_blocks() ? static_cast<int>(most)
                                           : combine_blocks();
  segment_combine_kernel<<<grid, kCombineThreads, 0, st>>>(w, lay.cols, lay.col_slices, sc, out);
  return cudaGetLastError();
}

template <bool kBag>
int run(const void* grad, const void* ids, const void* order, long long n_pos,
        int w, void* out, void* scratch, BagRows bag, void* stream) {
  if (n_pos < 0 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  const Layout lay(n_pos, w);
  const Scratch sc = lay.carve(scratch);
  const auto* g = static_cast<const float*>(grad);
  const auto* i = static_cast<const int*>(ids);
  const auto* o = static_cast<const long long*>(order);
  auto* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w <= 8) {   // the group probabilities, gates: a lane a column
    err = launch<1, 1, 16, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st);
  } else if (w % 4 == 0 && aligned(g, 16)) {
    err = w <= 128
        ? launch<4, 4, 8, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st)
        : launch<4, 8, 8, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st);
  } else if (w % 2 == 0 && aligned(g, 8)) {
    err = w <= 128
        ? launch<2, 4, 8, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st)
        : launch<2, 8, 8, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st);
  } else {
    err = launch<1, 8, 4, kBag>(g, i, o, n_pos, w, y, lay, sc, bag, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Bytes of scratch a call over n_pos sorted positions of w columns needs:
// the long segments' parts (n_pos / 64 rounded up, × w doubles), the
// combine's work list, its length and tickets.
extern "C" long long segment_sum_scratch(long long n_pos, int w) {
  return n_pos < 1 || w < 1 ? 0 : Layout(n_pos, w).bytes;
}

// On `stream`; returns cudaGetLastError() (0 = ok). Device pointers: grad
// (n_pos, w) float32; ids (n_pos,) int32, sorted, each in [0, n_out);
// order (n_pos,) int64, the gradient row of each sorted position; out
// (n_out, w) float32, zeroed by the caller; scratch segment_sum_scratch
// bytes, 16-byte aligned. All contiguous. Any w >= 1: rows wider than 256
// are summed in column tiles of the one launch.
extern "C" int segment_sum(const void* grad, const void* ids, const void* order,
                           long long n_pos, int w, void* out, void* scratch,
                           void* stream) {
  return run<false>(grad, ids, order, n_pos, w, out, scratch,
                    BagRows{nullptr, 1}, stream);
}

// The bag form: grad (n_pos / l, w) float32, the bag cotangent; weights
// (n_pos,) float32, the (B, L) mask as weights; l >= 1 slots a bag and
// n_pos < 2^32; ids, order, out and scratch as for segment_sum, over the
// B * L positions.
extern "C" int segment_sum_bag(const void* grad, const void* weights, int l,
                               const void* ids, const void* order,
                               long long n_pos, int w, void* out,
                               void* scratch, void* stream) {
  if (l < 1 || n_pos > static_cast<long long>(UINT_MAX) || n_pos % l != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run<true>(grad, ids, order, n_pos, w, out, scratch,
                   BagRows{static_cast<const float*>(weights),
                           static_cast<unsigned>(l)},
                   stream);
}
