// One training step's parameter update for one leaf, in place, for Hopper
// (sm_90a): the global-norm clip's scale, Adam with its bias corrections,
// the decoupled weight decay and the apply, in one pass:
//
//   g' = g * scale
//   m  = b1 * m + (1 - b1) * g'           (stored in the moments' type)
//   v  = b2 * v + (1 - b2) * g' * g'
//   u  = (-lr * (m / bc1)) / (sqrt(v / bc2) + eps) [- lr * wd * p]
//   p  = p + u                            (rounded once to the leaf's type)
//
// Leaves and gradients are both float32 (moments float32 or bfloat16), or
// both bfloat16 with float32 moments: the LM's layers. A bfloat16 leaf
// follows the reference's promotions (src/repro/train/optimizer.py): the
// clipped gradient float32(g) * scale and both moments are float32, and
// the update float32(p) + u is rounded to bfloat16 once. Its decay term
// is, as jnp forms lr * wd * p on a bfloat16 p, the bfloat16 product
// bf16(bf16(lr * wd) * p) with a constant lr (a Python scalar takes the
// array's type), and the float32 product f32(lr_t * wd) * p with a
// schedule's lr_t (a float32 array promotes it).
//
// lr is a constant of the step, or a schedule's value lr_t (a float32 in
// device memory, computed on the device from Adam's step, as the reference
// computes lr_fn(step + 1) inside its jitted step): then -lr_t and the
// decay's factor are read there, and the factor is formed as the reference
// forms it, f32(lr_t * wd) in float32; with a constant lr it is f32(lr·wd),
// the product of the two Python floats, rounded once.
//
// No TPU kernel has this function: the reference's optimizer is plain jnp
// (src/repro/train/optimizer.py), which XLA fuses, and its jitted step
// updates the donated carry in place. The port's plain version is
// kernels/adam/ref.py, one torch call per operation on a leaf; this pass
// takes over its elementwise passes (the clip's scaling, the two moments,
// the update, the apply and the guard's selects).
//
// What bounds it on an H100 (3.35 TB/s): bytes. It reads p, g, m and v and
// writes p, m and v once each, 7 x 4 bytes an element with float32 moments
// (5 x 4 + 4 with bfloat16 ones; 4 x 2 + 4 x 4 = 22 bytes for a bfloat16
// leaf), and does a dozen float operations an element. The guard flag, the clip scale, the two bias corrections and a
// schedule's lr_t are read from device memory, so no step waits for the
// host; a step whose flag is false returns before reading anything, and
// every leaf and moment keeps its bits.
//
// Every float operation is the one torch runs in the plain version, in its
// order, each rounded once: __fmul_rn, __fadd_rn, __fdiv_rn and
// __fsqrt_rn, so that no multiply-add is contracted where torch's separate
// kernels round twice. On the card the pass gives the plain version's bits.
// Build without --use_fast_math.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // a grid-stride loop over the leaf

// The step's constants, each already the float32 value torch computes with.
struct Hyper {
  float neg_lr;    // -lr (a constant lr)
  float b1, c1;    // b1 and 1 - b1
  float b2, c2;    // b2 and 1 - b2
  float eps;
  float lr_wd;     // f32(lr * weight_decay), for a bfloat16 leaf
                   // bf16(lr * weight_decay) (a constant lr)
  float wd;        // f32(weight_decay) (a schedule: lr_wd = f32(lr_t * wd))
  bool decay;      // the leaf takes the decoupled weight decay
};

// v as stored in T, read back as float: the value the next operation sees.
template <typename T>
__device__ __forceinline__ float stored(float v);
template <>
__device__ __forceinline__ float stored<float>(float v) { return v; }
template <>
__device__ __forceinline__ float stored<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
// v is already a value of x's type (stored<T>), so the store is exact.
__device__ __forceinline__ void store(float* x, long long i, float v) { x[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* x, long long i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

// Four elements k * 4 .. k * 4 + 3: a 16-byte access of float32, an
// 8-byte one of bfloat16.
__device__ __forceinline__ void load4(const float* x, long long k, float* o) {
  const float4 v = reinterpret_cast<const float4*>(x)[k];
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* x, long long k,
                                      float* o) {
  const uint2 v = reinterpret_cast<const uint2*>(x)[k];
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __bfloat162float(b[e]);
}
__device__ __forceinline__ void store4(float* x, long long k, const float* o) {
  reinterpret_cast<float4*>(x)[k] = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, long long k,
                                       const float* o) {
  uint2 v;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = __float2bfloat16_rn(o[e]);
  reinterpret_cast<uint2*>(x)[k] = v;
}

// One element's step on float values: p, m and v come back as the values
// stored in the leaf's type P and the moments' type M.
template <typename P, typename M>
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     float s, float d1, float d2,
                                     float neg_lr, float lr_wd,
                                     bool round_decay, const Hyper& h) {
  const float gi = __fmul_rn(g, s);                                   // clip
  m = stored<M>(__fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, gi)));
  v = stored<M>(__fadd_rn(__fmul_rn(h.b2, v),
                          __fmul_rn(h.c2, __fmul_rn(gi, gi))));
  float u = __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(m, d1)),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, d2)), h.eps));
  if (h.decay) {
    const float dec = __fmul_rn(lr_wd, p);
    u = __fsub_rn(u, round_decay ? stored<P>(dec) : dec);
  }
  p = stored<P>(__fadd_rn(p, u));
}

// kVec elements a thread at a time: 4 (vector loads and stores) where the
// tensors are aligned to it and hold a multiple of 4 elements, else 1.
template <typename P, typename M, int kVec>
__global__ void __launch_bounds__(kThreads)
adam_kernel(P* __restrict__ p, const P* __restrict__ g,
            M* __restrict__ m, M* __restrict__ v, long long n,
            const float* __restrict__ scale, const bool* __restrict__ ok,
            const float* __restrict__ bc1, const float* __restrict__ bc2,
            const float* __restrict__ lr_t, const Hyper h) {
  if (!*ok) return;  // the guard: a skipped step writes nothing
  const float s = *scale, d1 = *bc1, d2 = *bc2;
  float neg_lr = h.neg_lr, lr_wd = h.lr_wd;
  if (lr_t != nullptr) {  // a schedule's value, as the reference forms it
    const float l = *lr_t;
    neg_lr = -l;
    lr_wd = __fmul_rn(l, h.wd);
  }
  // a bfloat16 leaf's decay with a constant lr: the bfloat16 product
  const bool round_decay = lr_t == nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n / kVec; k += stride) {
    if constexpr (kVec == 4) {
      float ps[4], gs[4], ms[4], vs[4];
      load4(p, k, ps);
      load4(g, k, gs);
      load4(m, k, ms);
      load4(v, k, vs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        step<P, M>(ps[e], gs[e], ms[e], vs[e], s, d1, d2, neg_lr, lr_wd,
                   round_decay, h);
      }
      store4(p, k, ps);
      store4(m, k, ms);
      store4(v, k, vs);
    } else {
      float pi = load(p, k), mi = load(m, k), vi = load(v, k);
      step<P, M>(pi, load(g, k), mi, vi, s, d1, d2, neg_lr, lr_wd,
                 round_decay, h);
      store(p, k, pi);
      store(m, k, mi);
      store(v, k, vi);
    }
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  }
  return true;
}

template <typename P, typename M>
void launch(unsigned grid, cudaStream_t st, bool vec4, void* p, const void* g,
            void* m, void* v, long long n, const float* s, const bool* k,
            const float* d1, const float* d2, const float* l, const Hyper& h) {
  auto kernel = vec4 ? adam_kernel<P, M, 4> : adam_kernel<P, M, 1>;
  kernel<<<grid, kThreads, 0, st>>>(static_cast<P*>(p), static_cast<const P*>(g), static_cast<M*>(m), static_cast<M*>(v), n, s, k, d1, d2, l, h);
}

}  // namespace

// The update of one leaf of n elements on `stream`; returns
// cudaGetLastError() (0 = ok). Device pointers: p and g (n,) float32
// (bf16_leaf = 0) or bfloat16 (1); m and v (n,) float32 (bf16_moments =
// 0) or bfloat16 (1, float32 leaves only); scale, bc1, bc2 one float32
// each; ok one bool. All contiguous. lr_t: null for a constant lr (then
// neg_lr and lr_wd are used), else one float32, a schedule's value (then
// wd is used); decay: 1 where the leaf takes the weight decay.
extern "C" int adam_step(void* p, const void* g, void* m, void* v, long long n,
                         int bf16_leaf, int bf16_moments, const void* scale,
                         const void* ok, const void* bc1, const void* bc2,
                         const void* lr_t, float neg_lr, float b1, float c1,
                         float b2, float c2, float eps, float lr_wd, float wd,
                         int decay, void* stream) {
  if (n < 0 || (bf16_moments != 0 && bf16_moments != 1) ||
      (bf16_leaf != 0 && bf16_leaf != 1) || (bf16_leaf && bf16_moments)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n / 4 + kThreads) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  const Hyper h{neg_lr, b1, c1, b2, c2, eps, lr_wd, wd, decay != 0};
  const float* l = static_cast<const float*>(lr_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const bool* k = static_cast<const bool*>(ok);
  const float* d1 = static_cast<const float*>(bc1);
  const float* d2 = static_cast<const float*>(bc2);
  const unsigned grid = static_cast<unsigned>(blocks);
  const bool vec4 = n % 4 == 0 && aligned16({p, g, m, v});
  if (bf16_leaf) {
    launch<__nv_bfloat16, float>(grid, st, vec4, p, g, m, v, n, s, k, d1, d2,
                                 l, h);
  } else if (bf16_moments) {
    launch<float, __nv_bfloat16>(grid, st, false, p, g, m, v, n, s, k, d1, d2,
                                 l, h);
  } else {
    launch<float, float>(grid, st, vec4, p, g, m, v, n, s, k, d1, d2, l, h);
  }
  return static_cast<int>(cudaGetLastError());
}
