// The global-norm clip's norm and scale over a tree of gradient leaves, for
// Hopper (sm_90a), in one read of the leaves:
//
//   gnorm = sqrt(sum over every leaf and element of g * g)
//   scale = min(1, max_norm / (gnorm + 1e-12))
//
// No TPU kernel has this function: the reference's clip is plain jnp
// (src/repro/train/optimizer.py, clip_by_global_norm), which XLA fuses into
// its jitted step. The port's plain version, kernels/global_norm/ref.py,
// squares each leaf into a new float32 tensor, sums it, then stacks, sums
// and takes the root of the leaves' sums: three passes over the gradients
// and one more gradient-sized tensor alive at a time. This pass takes over
// all of it and allocates nothing.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Every leaf is read once,
// 4 bytes an element (2 for a bfloat16 leaf), and nothing gradient-sized
// is written; one multiply and one float64 add an element.
//
// Design. One launch takes the whole tree: up to kMaxLeaves leaves, their
// pointers, their ends in the concatenated element space and their types
// in one __grid_constant__ parameter (CUDA 12.1 and later take 32 KB of
// kernel parameters on Hopper); a larger tree is refused. The grid is
// fixed for a tree (a few blocks an SM, fewer for a small tree), and the
// concatenated elements are cut into kChunksPerBlock contiguous chunks a
// block. A block takes chunk after chunk from a counter, so a block on a
// slower SM takes fewer and the grid ends together (with one fixed range a
// block, the pass waits on its slowest SM: 84-90% of its bound on an H100,
// against 93% with chunks taken in turn). Within a chunk, for each leaf it
// meets: scalar loads up to the leaf's first 16-byte boundary, then
// 16-byte loads, kUnroll in flight a thread, then a scalar tail. Each
// square is taken in float32, as the plain version takes it; squares are
// summed in float64 a thread, then a block by warp shuffles and its warps
// in turn, into the chunk's own partial in the scratch, so which block
// sums a chunk changes none of its bits. The last block to take a ticket
// sums the partials in index order in float64, rounds the total to
// float32, and forms gnorm and scale with the plain version's float32
// operations: torch computes max_norm / x as reciprocal(x) * max_norm, and
// its clamp keeps a NaN. So a NaN or an inf anywhere, or a sum past
// float32's range, reads as a non-finite gnorm, and the trainer's guard
// skips the step. That block also resets the chunk counter and the ticket
// to 0 for the next call. The grid, the chunks and every order are fixed,
// so a call gives the same bits every time.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes. Build without --use_fast_math.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;                  // 16-byte loads in flight a thread
constexpr long long kMinPerBlock = 1 << 16;  // elements: a small tree takes
                                             // fewer blocks
constexpr int kChunksPerBlock = 16;         // chunks of the tree a block
constexpr int kMaxLeaves = 1024;            // leaves a launch takes

struct Leaves {
  const void* ptr[kMaxLeaves];
  long long end[kMaxLeaves];   // a leaf's end in the concatenated elements
  unsigned char bf16[kMaxLeaves];
  int n;
};
// The launch's parameters: the leaves, three pointers and a float, within
// the 32,764 bytes a launch may pass.
static_assert(sizeof(Leaves) + 32 <= 32764, "too many leaves a launch");

// A leaf's element as float: float32 as it is, bfloat16 (its 16 bits)
// widened exactly.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// The square in float32, then exactly in float64.
__device__ __forceinline__ double square(float x) {
  return static_cast<double>(__fmul_rn(x, x));
}

// The squares of one 16-byte load, added to four sums in turn.
__device__ __forceinline__ void add_squares(float, const uint4 v,
                                            double (&acc)[4]) {
  acc[0] += square(__uint_as_float(v.x));
  acc[1] += square(__uint_as_float(v.y));
  acc[2] += square(__uint_as_float(v.z));
  acc[3] += square(__uint_as_float(v.w));
}
__device__ __forceinline__ void add_squares(unsigned short, const uint4 v,
                                            double (&acc)[4]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] += square(__uint_as_float(w[e] << 16));
    acc[e] += square(__uint_as_float(w[e] & 0xffff0000u));
  }
}

// Adds the squares of x[a, c) (one leaf) to the thread's sums; the block's
// threads share the range.
template <typename T>
__device__ void leaf_squares(const T* __restrict__ x, long long a,
                             long long c, double (&acc)[4]) {
  constexpr long long kPer = 16 / sizeof(T);
  const long long off =
      static_cast<long long>(reinterpret_cast<uintptr_t>(x + a) & 15) /
      static_cast<long long>(sizeof(T));
  const long long body = off == 0 ? a : min(c, a + kPer - off);
  for (long long i = a + threadIdx.x; i < body; i += kThreads) {
    acc[0] += square(widen(x[i]));
  }
  const long long nvec = (c - body) / kPer;
  const uint4* v = reinterpret_cast<const uint4*>(x + body);
  for (long long k = threadIdx.x; k < nvec; k += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u * kThreads < nvec) r[u] = __ldg(v + k + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u * kThreads < nvec) add_squares(T(), r[u], acc);
    }
  }
  for (long long i = body + nvec * kPer + threadIdx.x; i < c;
       i += kThreads) {
    acc[1] += square(widen(x[i]));
  }
}

// The block's sum of v in thread 0, in a fixed order: a warp's lanes by
// shuffles, then the warps in turn. Ends with the block synchronised.
__device__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
  }
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
global_norm_kernel(const __grid_constant__ Leaves leaves,
                   double* __restrict__ partials,
                   unsigned* __restrict__ counters, float max_norm,
                   float* __restrict__ out) {
  __shared__ double warp_sums[kWarps];
  __shared__ unsigned next;
  __shared__ bool is_last;
  const long long total = leaves.n > 0 ? leaves.end[leaves.n - 1] : 0;
  const unsigned chunks = gridDim.x * kChunksPerBlock;
  if (threadIdx.x == 0) next = atomicAdd(counters, 1u);
  __syncthreads();
  unsigned c = next;
  while (c < chunks) {
    __syncthreads();  // every thread has read `next`
    if (threadIdx.x == 0) next = atomicAdd(counters, 1u);  // the block's next
    // the chunk's range, its bounds multiples of 8 elements
    const long long lo = (total * c / chunks) & ~7LL;
    const long long hi =
        c + 1 == chunks ? total : (total * (c + 1) / chunks) & ~7LL;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    int i = 0;  // the chunk's first leaf: the first to end past lo
    for (int j = leaves.n; i < j;) {
      const int m = (i + j) / 2;
      if (leaves.end[m] <= lo) {
        i = m + 1;
      } else {
        j = m;
      }
    }
    long long start = i > 0 ? leaves.end[i - 1] : 0;
    for (; i < leaves.n && start < hi; ++i) {
      const long long end = leaves.end[i];
      const long long a = max(lo, start), b = min(hi, end);
      if (a < b) {
        if (leaves.bf16[i]) {
          leaf_squares(static_cast<const unsigned short*>(leaves.ptr[i]),
                       a - start, b - start, acc);
        } else {
          leaf_squares(static_cast<const float*>(leaves.ptr[i]), a - start,
                       b - start, acc);
        }
      }
      start = end;
    }
    const double s = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]),
                               warp_sums);
    if (threadIdx.x == 0) partials[c] = s;
    c = next;  // written before block_sum's barriers
  }
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials, before its ticket
    is_last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // every block's partials, after the last ticket
  double p = 0.0;
  for (unsigned i = threadIdx.x; i < chunks; i += kThreads) {
    p += __ldcg(partials + i);
  }
  const double sum = block_sum(p, warp_sums);
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(__double2float_rn(sum));
    const float scale =
        __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-12f)), max_norm);
    out[0] = isnan(scale) ? scale : fminf(scale, 1.0f);
    out[1] = gnorm;
    // every block has taken its last chunk and its ticket
    counters[0] = 0u;
    counters[1] = 0u;
  }
}

int grid_blocks(int device, long long tree_numel, int* blocks) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  long long want = (tree_numel + kMinPerBlock - 1) / kMinPerBlock;
  if (want < 1) want = 1;
  *blocks = static_cast<int>(want < most ? want : most);
  return 0;
}

}  // namespace

// The most leaves one call of global_norm takes.
extern "C" int global_norm_max_leaves() { return kMaxLeaves; }

// Bytes of the scratch a call on `device` needs (one float64 partial a
// chunk of the largest grid, then the chunk counter and the ticket),
// zeroed once by its owner and reused; -1 if the device cannot be queried.
extern "C" long long global_norm_scratch_bytes(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return -1;
  }
  return static_cast<long long>(sms) * kBlocksPerSm * kChunksPerBlock * 8 +
         8;
}

// One launch over the n leaves (ptrs[i] of numels[i] elements, bf16[i] 0
// for float32, 1 for bfloat16; each contiguous; n at most kMaxLeaves) on
// `stream`, writing out[0] = scale and out[1] = gnorm (float32 on the
// device); returns cudaGetLastError() (0 = ok). scratch:
// global_norm_scratch_bytes(device) bytes, zeroed before its first use, and
// used by one stream at a time.
extern "C" int global_norm(const void* const* ptrs, const long long* numels,
                           const int* bf16, int n, void* scratch,
                           float max_norm, void* out, void* stream) {
  if (n < 0 || n > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Leaves leaves{};
  long long end = 0;
  for (int i = 0; i < n; ++i) {
    if (numels[i] < 0 || (bf16[i] != 0 && bf16[i] != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    end += numels[i];
    leaves.ptr[i] = ptrs[i];
    leaves.end[i] = end;
    leaves.bf16[i] = static_cast<unsigned char>(bf16[i]);
  }
  leaves.n = n;
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int got = grid_blocks(dev, end, &blocks);
  if (got != 0) return got;
  double* partials = static_cast<double*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + global_norm_scratch_bytes(dev) - 8);
  global_norm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(leaves, partials, counters, max_norm, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
