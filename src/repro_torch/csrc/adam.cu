// One training step's parameter update for one leaf, in place, for Hopper
// (sm_90a): the global-norm clip's scale, Adam with its bias corrections,
// the decoupled weight decay and the apply, in one pass:
//
//   g' = g * scale
//   m  = b1 * m + (1 - b1) * g'           (stored in the moments' type)
//   v  = b2 * v + (1 - b2) * g' * g'
//   u  = (-lr * (m / bc1)) / (sqrt(v / bc2) + eps) [- lr * wd * p]
//   p  = p + u
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
// (5 x 4 + 4 with bfloat16 ones), and does a dozen float operations an
// element. The guard flag, the clip scale, the two bias corrections and a
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
  float lr_wd;     // f32(lr * weight_decay) (a constant lr)
  float wd;        // f32(weight_decay) (a schedule: lr_wd = f32(lr_t * wd))
  bool decay;      // the leaf takes the decoupled weight decay
};

__device__ __forceinline__ float load(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
// Stores v in the moments' type and returns the value stored, as float.
__device__ __forceinline__ float store(float* x, long long i, float v) {
  x[i] = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* x, long long i, float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  x[i] = b;
  return __bfloat162float(b);
}

// One element's step; returns nothing, writes p, m and v.
template <typename M>
__device__ __forceinline__ void step(float& p, float g, M* m, M* v,
                                     long long i, float s, float d1, float d2,
                                     float neg_lr, float lr_wd, const Hyper& h) {
  const float gi = __fmul_rn(g, s);                                   // clip
  const float mi = store(m, i, __fadd_rn(__fmul_rn(h.b1, load(m, i)),
                                         __fmul_rn(h.c1, gi)));
  const float vi = store(v, i, __fadd_rn(__fmul_rn(h.b2, load(v, i)),
                                         __fmul_rn(h.c2, __fmul_rn(gi, gi))));
  float u = __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(mi, d1)),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, d2)), h.eps));
  if (h.decay) u = __fsub_rn(u, __fmul_rn(lr_wd, p));
  p = __fadd_rn(p, u);
}

// kVec elements a thread at a time: 4 with float32 moments and 16-byte
// aligned tensors of a multiple of 4 elements (float4 loads and stores),
// else 1.
template <typename M, int kVec>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
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
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n / kVec; k += stride) {
    if constexpr (kVec == 4) {
      float4 pv = reinterpret_cast<const float4*>(p)[k];
      const float4 gv = reinterpret_cast<const float4*>(g)[k];
      float4 mv = reinterpret_cast<const float4*>(m)[k];
      float4 vv = reinterpret_cast<const float4*>(v)[k];
      float* ps = &pv.x;
      const float* gs = &gv.x;
      float* ms = &mv.x;
      float* vs = &vv.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        step(ps[e], gs[e], ms, vs, e, s, d1, d2, neg_lr, lr_wd, h);
      }
      reinterpret_cast<float4*>(p)[k] = pv;
      reinterpret_cast<float4*>(m)[k] = mv;
      reinterpret_cast<float4*>(v)[k] = vv;
    } else {
      float pi = p[k];
      step(pi, g[k], m, v, k, s, d1, d2, neg_lr, lr_wd, h);
      p[k] = pi;
    }
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// The update of one leaf of n elements on `stream`; returns
// cudaGetLastError() (0 = ok). Device pointers: p and g float32 (n,); m and
// v (n,) float32 (bf16_moments = 0) or bfloat16 (1); scale, bc1, bc2 one
// float32 each; ok one bool. All contiguous. lr_t: null for a constant lr
// (then neg_lr and lr_wd are used), else one float32, a schedule's value
// (then wd is used); decay: 1 where the leaf takes the weight decay.
extern "C" int adam_step(void* p, const void* g, void* m, void* v, long long n,
                         int bf16_moments, const void* scale, const void* ok,
                         const void* bc1, const void* bc2, const void* lr_t,
                         float neg_lr, float b1, float c1, float b2, float c2,
                         float eps, float lr_wd, float wd, int decay,
                         void* stream) {
  if (n < 0 || (bf16_moments != 0 && bf16_moments != 1)) {
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
  auto* pp = static_cast<float*>(p);
  const auto* gg = static_cast<const float*>(g);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bf16_moments) {
    auto kernel = adam_kernel<__nv_bfloat16, 1>;
    kernel<<<grid, kThreads, 0, st>>>(pp, gg, static_cast<__nv_bfloat16*>(m),
                                      static_cast<__nv_bfloat16*>(v), n, s, k,
                                      d1, d2, l, h);
  } else {
    auto kernel = n % 4 == 0 && aligned16({p, g, m, v}) ? adam_kernel<float, 4>
                                                        : adam_kernel<float, 1>;
    kernel<<<grid, kThreads, 0, st>>>(pp, gg, static_cast<float*>(m),
                                      static_cast<float*>(v), n, s, k, d1, d2,
                                      l, h);
  }
  return static_cast<int>(cudaGetLastError());
}
