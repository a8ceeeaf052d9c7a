// Flash attention for Hopper (sm_90a), float32: the forward (with or
// without the logsumexp rows) and the backward that recomputes the
// probabilities from the stored logsumexp.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (_flash_kernel), flash_attention_fwd_stats
// (_flash_fwd_stats_kernel) and flash_attention_bwd (_flash_bwd_kernel).
// Layout (B, S, H, hd), row-major and contiguous, as the models hold q, k
// and v; lse (B, H, S). The kernels compute the offset of (b, s, h, d)
// themselves, so no caller transposes. hd <= 128, any S >= 1.
//
// Numerics, as the TPU kernels compute them:
//   s = (q . k) * scale, scale = hd^-0.5 applied after the dot product;
//   causal: s = -1e30 where key > query;
//   o = acc / max(den, 1e-30), rounded as the division rounds (divide());
//   lse = m + log(max(den, 1e-30));
//   backward: p = exp(s - lse), dp = do . v, ds = p * (dp - delta) * scale,
//   with delta = rowsum(do * o), formed here from the staged do and o rows
//   (the reference forms it outside its kernel; the sum is the same).
// At hd <= 4 and on the tiled route the products are float32 FMAs in order
// of d; at hd > 4 they run on the tensor cores in split TF32 (three TF32
// products per product, about 2^-20 of it dropped; see mma3()). expf and
// logf are the accurate ones: build without --use_fast_math. Every sum runs
// in a fixed order and no float atomics are used, so the backward gives the
// same bits when repeated.
//
// Two routes, chosen by S inside the C entry points (both launch or fail;
// neither falls back on the other):
//
// * S <= 64, staged (flash_fwd_kernel, flash_bwd_kernel): every model of the
//   port (SASRec S = 50, hd = 50; BST S = 21, hd = 4). What bounds them on
//   an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores) is
//   bytes: at SASRec's serve_bulk the forward moves 10.5 GB (3.13 ms) for
//   66.8 GFLOP of causal products (1.0 ms at the SIMT rate). But SIMT float32
//   spends three FMA slots per useful product there (the causal half, rows
//   and columns padded to 8) and ran compute-bound at 2-4x the byte bound,
//   so hd > 4 goes to the tensor cores. The design:
//   - Work items are whole sequences, all keys resident, so the softmax is
//     one max / exp / sum pass (the one-tile case of the online softmax).
//     Rows are S rounded up to 8 (24 for BST, 56 for SASRec) or 16.
//   - Persistent blocks (SMs x resident blocks) walk the items. Where an
//     item's (S, H, hd) slab is contiguous (all heads of a batch row: BST,
//     and SASRec's single head), one TMA bulk copy per tensor stages it as
//     it lies (cp.async.bulk, completion on an mbarrier); else cp.async. Two
//     stages (the next item's copies in flight during this one's compute)
//     where four blocks still fit on an SM, else one stage and the blocks
//     overlap each other.
//   - hd <= 4 (BST): one thread per (query row, head), an item a batch row
//     with all H heads; scores, o and lse in registers, loops over all keys
//     without branches. The backward's P and dS pass through shared memory
//     in the threads' own order (no bank conflicts). o is stored 16 bytes a
//     thread. Bound by issue: the accurate expf is a fifth of the work.
//   - hd > 4 (SASRec): one (b, h) an item; mma.sync m16n8k8 on fragments
//     read from the staged rows (stride hd, no padding: the fragment loads
//     are 32-bit). Forward: a warp per 16 query rows, S over 64 key columns
//     (when causal only the key tiles up to the band's last row), softmax on
//     the fragments, P through shared memory, O = P.V. Backward: two warps a
//     band, splitting the key columns of S and dP, then the columns of hd
//     of dQ = dS.K, dV = P^T.dO and dK = dS^T.Q; each output written once.
//     Bound by the tensor pipe and the TF32 splits.
// * S > 64, tiled (flash_fwd_tiled_kernel, flash_bwd_tiled_kernel): SIMT
//   float32, 64 x 64 tiles in shared memory, loaded from rows H*hd apart.
//   The forward runs one block per (bh, query tile) over the key tiles with
//   the online softmax; the backward one block per bh over the key tiles,
//   keeping dk and dv in registers and adding dq in a fixed order (only this
//   block and thread touch it); delta is formed per query tile from do and
//   o.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernels' mask value
constexpr float kMinDen = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 128;

// ---------------------------------------------------------------------------
// Staged route (S <= 64)
// ---------------------------------------------------------------------------

constexpr int kMaxStaged = 64;      // longest S of the staged route
constexpr int kMaxRows = 256;       // query rows of an item at hd <= 4
constexpr int kStagedThreads = 256;
constexpr size_t kSmemPerSm = 233472;     // 228 KB on an H100 SM
constexpr size_t kSmemPerBlock = 232448;  // 227 KB a block may ask for
constexpr size_t kSmemReserved = 1024;    // kept by the system per block
constexpr int kBarBytes = 16;             // two mbarriers before the data
constexpr int kMinBlocks = 4;   // two stages only if this many blocks still fit

struct Shape {          // (B, S, H, hd)
  long long b;
  int s, h, hd;
};

struct Staging {
  long long items;      // work items: b * (h / hg)
  int hg;               // heads in an item (1 at hd > 4)
  int kt;               // S rounded up to 8: staged key rows of a head
  int kq;               // hd > 4: S rounded up to 16, one warp per 16 rows
  int off[5];           // per staged tensor: its slot's offset, floats from
  int ld[5];            //   the stage's start, and its row stride
  int lse_off;          // backward: the lse slot's offset
  int rw;               // row stride of P (and dS in the backward), floats
  int vec;              // floats a cp.async moves (1, 2, 4); 0: bulk copies
  int out4;             // outputs stored 16 bytes a thread (hd <= 4)
  int stages;           // 1 or 2
  int stage_floats;     // one stage
  int extra_floats;     // after the stages: P (hd > 4), dS (backward)
};

struct Tensors {
  const float* in[5];   // q, k, v, then do, o for the backward
  const float* lse;     // backward: (B, H, S)
  float* out[3];        // o; or dq, dk, dv
  float* lse_out;       // forward with stats: (B, H, S)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete; a copy that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same memory.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sum_d a[d] * b[d] in order of d, each term a fused multiply-add.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 acc) {
  return make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y),
                     fmaf(p, v.z, acc.z), fmaf(p, v.w, acc.w));
}

// a / b rounded as the IEEE division rounds it, for b >= 1 (every divisor
// here is max(den, 1e-30) with den >= 1: the row's largest term is exp(0)):
// one correctly rounded reciprocal per divisor and a fused correction step
// (Markstein), three instructions a quotient instead of a division each.
struct Divisor {
  float b, r;
};

__device__ __forceinline__ Divisor divisor(float b) { return {b, 1.f / b}; }

__device__ __forceinline__ float divide(float a, Divisor d) {
  const float q = a * d.r;
  return fmaf(fmaf(-q, d.b, a), d.r, q);
}

// The first hd (<= 4) values of v into a row of device memory.
__device__ __forceinline__ void store_row4(float* row, float4 v, int hd,
                                           int out4) {
  if (out4) {
    *reinterpret_cast<float4*>(row) = v;
    return;
  }
  row[0] = v.x;
  if (hd > 1) row[1] = v.y;
  if (hd > 2) row[2] = v.z;
  if (hd > 3) row[3] = v.w;
}

// Max and sum over the 4 lanes (a quad) that share the rows of an mma
// fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ void item_at(const Shape& sh, const Staging& g,
                                        long long item, long long& bi,
                                        int& h0) {
  const int groups = sh.h / g.hg;
  bi = item / groups;
  h0 = static_cast<int>(item - bi * groups) * g.hg;
}

// Stages item `item` into the stage at `dst`: tensor i's rows (s, h') at
// dst + off[i] + (s * hg + h') * ld[i], then, when `with_lse`, its hg x S
// lse rows. One bulk copy per tensor when g.vec == 0 (the item's slab is
// contiguous: all heads, ld == hd); else cp.async, a warp per row. All the
// block's threads call it; the copies of one call are one cp.async group.
template <int kNt>
__device__ void stage_item(float* dst, const Tensors& t, const Shape& sh,
                           const Staging& g, long long item, uint64_t* bar,
                           bool with_lse) {
  long long bi;
  int h0;
  item_at(sh, g, item, bi, h0);
  const size_t base =
      (static_cast<size_t>(bi) * sh.s * sh.h + h0) * static_cast<size_t>(sh.hd);
  if (g.vec == 0) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(sh.s * sh.h * sh.hd) * 4u;
      fence_async_shared();
      mbar_expect_tx(bar, kNt * bytes);
#pragma unroll
      for (int i = 0; i < kNt; ++i) {
        bulk_copy(dst + g.off[i], t.in[i] + base, bytes, bar);
      }
    }
  } else {
    const int rows = sh.s * g.hg, per_row = sh.hd / g.vec;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int i = 0; i < kNt; ++i) {
      for (int row = warp; row < rows; row += nwarps) {
        const int si = g.hg == 1 ? row : row / g.hg, hh = row - si * g.hg;
        const float* src =
            t.in[i] + base + (static_cast<size_t>(si) * sh.h + hh) * sh.hd;
        float* to = dst + g.off[i] + row * g.ld[i];
        for (int c = lane; c < per_row; c += 32) {
          const int e = c * g.vec;
          if (g.vec == 4) {
            cp_async<16>(to + e, src + e);
          } else if (g.vec == 2) {
            cp_async<8>(to + e, src + e);
          } else {
            cp_async<4>(to + e, src + e);
          }
        }
      }
    }
  }
  if (with_lse) {
    float* to = dst + g.lse_off;
    const float* src = t.lse + (static_cast<size_t>(bi) * sh.h + h0) * sh.s;
    for (int e = threadIdx.x; e < g.hg * sh.s; e += blockDim.x) {
      cp_async<4>(to + e, src + e);
    }
  }
  cp_async_commit();
}

// The persistent loop: zero shared memory (pad rows and columns start at 0),
// then walk items blockIdx.x, + gridDim.x, ...; with two stages the next
// item's copies are in flight while `compute(stage, item)` runs.
template <int kNt, typename Compute>
__device__ __forceinline__ void run_items(unsigned char* smem_raw,
                                          const Tensors& t, const Shape& sh,
                                          const Staging& g, bool with_lse,
                                          Compute&& compute) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + kBarBytes);
  const int total = g.stages * g.stage_floats + g.extra_floats;
  for (int e = threadIdx.x; e < total; e += blockDim.x) smem[e] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async_shared();
  __syncthreads();

  const long long step = gridDim.x;
  long long item = blockIdx.x;
  if (item < g.items) stage_item<kNt>(smem, t, sh, g, item, &bars[0], with_lse);
  for (int it = 0; item < g.items; ++it, item += step) {
    const int st = g.stages == 2 ? (it & 1) : 0;
    const long long next = item + step;
    const bool ahead = g.stages == 2 && next < g.items;
    if (ahead) {
      stage_item<kNt>(smem + (st ^ 1) * g.stage_floats, t, sh, g, next,
                      &bars[st ^ 1], with_lse);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (g.vec == 0) {
      const int use = g.stages == 2 ? (it >> 1) : it;
      mbar_wait(&bars[st], static_cast<uint32_t>(use & 1));
    }
    __syncthreads();
    compute(smem + st * g.stage_floats, item);
    __syncthreads();  // the stage is read; it may be filled again
    if (g.stages == 1 && next < g.items) {
      stage_item<kNt>(smem, t, sh, g, next, &bars[0], with_lse);
    }
  }
}

// hd <= 4, forward: thread r < S * hg owns query row (r / hg) of head
// h0 + r % hg; its q row, scores, o and lse live in registers. The loops run
// over all KT staged keys without branches: keys past S (zero rows) and
// causally masked ones score -1e30, so their exp is exactly 0.
template <int KT, bool kStats>
__device__ __forceinline__ void fwd_rows(const float* stage, const Tensors& t,
                                         const Shape& sh, const Staging& g,
                                         long long item, float scale,
                                         int causal) {
  const int s = sh.s, hg = g.hg, r = threadIdx.x;
  if (r >= s * hg) return;
  long long bi;
  int h0;
  item_at(sh, g, item, bi, h0);
  const float* sk = stage + g.off[1];
  const float* sv = stage + g.off[2];
  const int si = r / hg, hh = r - si * hg;
  const float4 q = ld4(stage + g.off[0] + 4 * r);
  const int last = causal ? si : s - 1;  // the last key this row sees
  float sc[KT];
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float x = dot4(q, ld4(sk + 4 * (j * hg + hh)), 0.f) * scale;
    sc[j] = j <= last ? x : kNegInf;
    mx = fmaxf(mx, sc[j]);
  }
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    sc[j] = expf(sc[j] - mx);
    den += sc[j];
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < KT; ++j) acc = fma4(sc[j], ld4(sv + 4 * (j * hg + hh)), acc);
  const float dd = fmaxf(den, kMinDen);
  const Divisor dv = divisor(dd);
  float* orow = t.out[0] +
                ((static_cast<size_t>(bi) * s + si) * sh.h + h0 + hh) * sh.hd;
  store_row4(orow,
             make_float4(divide(acc.x, dv), divide(acc.y, dv),
                         divide(acc.z, dv), divide(acc.w, dv)),
             sh.hd, g.out4);
  if (kStats) {
    t.lse_out[(static_cast<size_t>(bi) * sh.h + h0 + hh) * s + si] =
        mx + logf(dd);
  }
}

// hd <= 4, backward. Query phase: thread r owns query row si = r / hg of
// head h0 + hh; it forms delta, P, dP, dS and dQ for its row and writes P
// and dS at [si * rw + j * hg + hh]. Key phase: the same thread owns key row
// si of the same head and sums dV and dK over the query rows. As in the
// forward, masked and padded entries give p = 0 and ds = 0 exactly, and
// rows of P past S stay 0, so the loops run over all KT without branches.
template <int KT>
__device__ __forceinline__ void bwd_rows(const float* stage, float* sp,
                                         const Tensors& t, const Shape& sh,
                                         const Staging& g, long long item,
                                         float scale, int causal) {
  const int s = sh.s, hg = g.hg, rw = g.rw, r = threadIdx.x;
  const bool live = r < s * hg;
  long long bi;
  int h0;
  item_at(sh, g, item, bi, h0);
  const float* sq = stage + g.off[0];
  const float* sk = stage + g.off[1];
  const float* sv = stage + g.off[2];
  const float* sdo = stage + g.off[3];
  const float* so = stage + g.off[4];
  const float* slse = stage + g.lse_off;
  float* sds = sp + g.kt * rw;
  const int si = live ? r / hg : 0, hh = r - si * hg;
  const size_t row_at =
      ((static_cast<size_t>(bi) * s + si) * sh.h + h0 + hh) * sh.hd;
  if (live) {
    const float4 q = ld4(sq + 4 * r), dov = ld4(sdo + 4 * r);
    const float delta = dot4(dov, ld4(so + 4 * r), 0.f);
    const float lr = slse[hh * s + si];
    const int last = causal ? si : s - 1;
    float4 dq = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4 kj = ld4(sk + 4 * (j * hg + hh));
      const float x = dot4(q, kj, 0.f) * scale;
      const float p = expf((j <= last ? x : kNegInf) - lr);
      const float dp = dot4(dov, ld4(sv + 4 * (j * hg + hh)), 0.f);
      const float ds = p * (dp - delta) * scale;
      sp[si * rw + j * hg + hh] = p;
      sds[si * rw + j * hg + hh] = ds;
      dq = fma4(ds, kj, dq);
    }
    store_row4(t.out[0] + row_at, dq, sh.hd, g.out4);
  }
  __syncthreads();
  if (live) {
    float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const float p = sp[i * rw + r], ds = sds[i * rw + r];
      dv = fma4(p, ld4(sdo + 4 * (i * hg + hh)), dv);
      dk = fma4(ds, ld4(sq + 4 * (i * hg + hh)), dk);
    }
    store_row4(t.out[1] + row_at, dk, sh.hd, g.out4);
    store_row4(t.out[2] + row_at, dv, sh.hd, g.out4);
  }
}

// Split TF32 on the tensor cores (hd > 4). x = hi + lo, each a TF32 value
// (hi its leading 11 bits, lo the next 11); a product a.b is taken as
// lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), accumulated in float32 by
// mma.sync m16n8k8: what is dropped is about 2^-20 of the product, as close
// to float32 as the contracts need (o 3e-5, gradients 2e-4).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {          // 16 x 8: (gid, tig), (gid + 8, tig), (gid, tig + 4),
  uint32_t hi[4], lo[4];  // (gid + 8, tig + 4), gid = lane / 4, tig = lane % 4
};

struct FragB {          // 8 x 8: (k tig, n gid), (k tig + 4, n gid)
  uint32_t hi[2], lo[2];
};

// hi rounds x to the nearest TF32 value; lo = x - hi is exact in float32
// and goes to the tensor cores as it is: they read a TF32 operand's upper 19
// bits, so lo is cut toward zero to its leading 11 (round toward zero, the
// usual TF32 operand conversion), 2^-21 of x at most.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A[m][k] = p[m * ld + k] (rows of p), or with kTrans p[k * ld + m]; 0
// where k >= kmax (the columns of hd past its end).
template <bool kTrans>
__device__ __forceinline__ FragA frag_a(const float* p, int ld, int gid,
                                        int tig, int kmax = 8) {
  FragA f;
  const int m[4] = {gid, gid + 8, gid, gid + 8};
  const int k[4] = {tig, tig, tig + 4, tig + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = kTrans ? p[k[i] * ld + m[i]] : p[m[i] * ld + k[i]];
    split(k[i] < kmax ? x : 0.f, f.hi[i], f.lo[i]);
  }
  return f;
}

// B[k][n] = p[n * ld + k] (B^T in rows of p, kNk), or p[k * ld + n].
template <bool kNk>
__device__ __forceinline__ FragB frag_b(const float* p, int ld, int gid,
                                        int tig) {
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = tig + 4 * i;
    split(kNk ? p[gid * ld + k] : p[k * ld + gid], f.hi[i], f.lo[i]);
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b, three TF32 products, the small ones first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// acc[n] += (16 x 8 A) . (8 x 8 B) over the 8-row steps [k0, k1) of B =
// b[k * ldb + n], n < 8 N: A's step ks at a + 8 ks (columns), or with kTransA
// at a + 8 ks * lda (rows of the transposed operand).
template <int N, bool kTransA>
__device__ __forceinline__ void mma_rows(float (&acc)[N][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int k0, int k1, int gid, int tig) {
  for (int ks = k0; ks < k1; ++ks) {
    const FragA fa = frag_a<kTransA>(a + (kTransA ? 8 * ks * lda : 8 * ks),
                                     lda, gid, tig);
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      mma3(acc[nt], fa, frag_b<false>(b + 8 * ks * ldb + 8 * nt, ldb, gid, tig));
    }
  }
}

// sc[nt] += a.b^T over hd for nt < NK: the 16 rows at a and the key rows
// 8 nt .. 8 nt + 7 at b, both row strides ld; k-steps of 8 columns, A's
// columns past hd read as 0.
template <int NK, int N>
__device__ __forceinline__ void score_tiles(float (&sc)[N][4], const float* a,
                                            const float* b, int ld, int hd,
                                            int gid, int tig) {
  for (int ks = 0; 8 * ks < hd; ++ks) {
    const FragA fa = frag_a<false>(a + 8 * ks, ld, gid, tig, hd - 8 * ks);
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      mma3(sc[nt], fa, frag_b<true>(b + 8 * nt * ld + 8 * ks, ld, gid, tig));
    }
  }
}

// The 16 x 64 score tile of warp w (its 16 rows at a, 64 key rows at b):
// only the key tiles up to S and, when causal, up to the band's last row
// are multiplied (2, 4, 6 or 8 of them, each count compiled on its own);
// the rest stay 0 and are masked.
__device__ __forceinline__ void warp_scores(float (&sc)[8][4], const float* a,
                                            const float* b, int ld, int hd,
                                            int s, int w, int causal, int gid,
                                            int tig) {
  zero(sc);
  const int need = causal ? min((s + 7) >> 3, 2 * w + 2) : (s + 7) >> 3;
  switch ((need + 1) & ~1) {
    case 2: score_tiles<2>(sc, a, b, ld, hd, gid, tig); break;
    case 4: score_tiles<4>(sc, a, b, ld, hd, gid, tig); break;
    case 6: score_tiles<6>(sc, a, b, ld, hd, gid, tig); break;
    default: score_tiles<8>(sc, a, b, ld, hd, gid, tig);
  }
}

// Columns [0, hd) of rows row0 + gid and row0 + gid + 8 (those below S) of
// an output tile set, with kDiv divided by div[0], div[1]; `at` is the start
// of row 0 of the (b, h) sequence in device memory, rows `stride` apart.
template <bool kDiv, int N>
__device__ __forceinline__ void store_tiles(float* at, size_t stride,
                                            const float (&acc)[N][4], int row0,
                                            int s, int hd, int gid, int tig,
                                            const Divisor* div = nullptr) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gid + 8 * i;
    if (row >= s) continue;
    float* r = at + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      const int col = 8 * nt + 2 * tig;
      float x = acc[nt][2 * i], y = acc[nt][2 * i + 1];
      if (kDiv) {
        x = divide(x, div[i]);
        y = divide(y, div[i]);
      }
      if (col < hd) r[col] = x;
      if (col + 1 < hd) r[col + 1] = y;
    }
  }
}

// hd > 4, forward: warp w owns query rows 16w .. 16w+15 of one (b, h), rows
// staged as they lie in device memory (stride hd). S = Q.K^T over 64 keys
// in 16 x 8 tiles (zero rows past S), the softmax on the fragments (a row's
// 8 columns of a tile lie in one quad), P into the warp's rows of the P
// region, and O = P.V over the key tiles that hold a key the warp sees.
template <int NO, bool kStats>
__device__ __forceinline__ void fwd_mma(const float* stage, float* p_region,
                                        const Tensors& t, const Shape& sh,
                                        const Staging& g, long long item,
                                        float scale, int causal) {
  long long bi;
  int hh;
  item_at(sh, g, item, bi, hh);
  const int s = sh.s, hd = sh.hd, rw = g.rw;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, row0 = 16 * w;
  float* sp = p_region + row0 * rw;
  float sc[8][4];
  warp_scores(sc, stage + g.off[0] + row0 * hd, stage + g.off[1], hd, hd, s, w,
              causal, gid, tig);
  float mx[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + gid + 8 * (e >> 1), col = 8 * nt + 2 * tig + (e & 1);
      const bool live = col < s && !(causal && col > row);
      sc[nt][e] = live ? sc[nt][e] * scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nt][e] = expf(sc[nt][e] - mx[e >> 1]);
      den[e >> 1] += sc[nt][e];
    }
    float* at = sp + gid * rw + 8 * nt + 2 * tig;
    *reinterpret_cast<float2*>(at) = make_float2(sc[nt][0], sc[nt][1]);
    *reinterpret_cast<float2*>(at + 8 * rw) = make_float2(sc[nt][2], sc[nt][3]);
  }
  den[0] = quad_sum(den[0]);
  den[1] = quad_sum(den[1]);
  __syncwarp();
  // keys past the band's last row are all masked when causal
  const int nk = causal ? min((s + 7) >> 3, 2 * w + 2) : (s + 7) >> 3;
  float o[NO][4];
  zero(o);
  mma_rows<NO, false>(o, sp, rw, stage + g.off[2], hd, 0, nk, gid, tig);
  const float dd[2] = {fmaxf(den[0], kMinDen), fmaxf(den[1], kMinDen)};
  const Divisor dv[2] = {divisor(dd[0]), divisor(dd[1])};
  const size_t stride = static_cast<size_t>(sh.h) * hd;
  store_tiles<true>(t.out[0] + (static_cast<size_t>(bi) * s * sh.h + hh) * hd,
                    stride, o, row0, s, hd, gid, tig, dv);
  if (kStats && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gid + 8 * i;
      if (row < s) {
        t.lse_out[(static_cast<size_t>(bi) * sh.h + hh) * s + row] =
            mx[i] + logf(dd[i]);
      }
    }
  }
}

// hd > 4, backward: two warps a band of 16 rows (warp 2b + h, band b, half
// h). P and dS are elementwise once lse and delta are known, so the halves
// split the 64 key columns of S = Q.K^T and dP = dO.V^T (32 each; when
// causal, a half wholly above its band's last row has nothing to do) and
// write P and dS into shared memory ([query * rw + key]). After one barrier
// each half takes NO/2 of the 8-column tiles of hd: dQ = dS.K for band b's
// query rows, dV = P^T.dO and dK = dS^T.Q for band b's key rows, summed over
// the query rows in order. Each output is written once.
template <int NO>
__device__ __forceinline__ void bwd_mma(const float* stage, float* sp,
                                        const Tensors& t, const Shape& sh,
                                        const Staging& g, long long item,
                                        float scale, int causal) {
  constexpr int NH = NO / 2;
  long long bi;
  int hh;
  item_at(sh, g, item, bi, hh);
  const int s = sh.s, hd = sh.hd, rw = g.rw;
  const float* sq = stage + g.off[0];
  const float* sk = stage + g.off[1];
  const float* sv = stage + g.off[2];
  const float* sdo = stage + g.off[3];
  const float* so = stage + g.off[4];
  const float* slse = stage + g.lse_off;
  float* sds = sp + g.kq * rw;
  const int lane = threadIdx.x & 31, band = threadIdx.x >> 6;
  const int half = (threadIdx.x >> 5) & 1;
  const int gid = lane >> 2, tig = lane & 3, row0 = 16 * band;
  const size_t stride = static_cast<size_t>(sh.h) * hd;
  const int c0 = 8 * NH * half;  // this half's first column of hd
  float* const outs[3] = {t.out[0], t.out[1], t.out[2]};
  const size_t seq_at = (static_cast<size_t>(bi) * s * sh.h + hh) * hd + c0;

  if (!(causal && 4 * half > 2 * band + 1)) {
    float delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gid + 8 * i;
      float part = 0.f;
      if (row < s) {
        for (int d = tig; d < hd; d += 4) {
          part = fmaf(sdo[row * hd + d], so[row * hd + d], part);
        }
      }
      delta[i] = quad_sum(part);
    }
    const int k0 = 32 * half;  // this half's first key
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    score_tiles<4>(sc, sq + row0 * hd, sk + k0 * hd, hd, hd, gid, tig);
    score_tiles<4>(dp, sdo + row0 * hd, sv + k0 * hd, hd, hd, gid, tig);
    const float lr[2] = {slse[row0 + gid], slse[row0 + gid + 8]};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gid + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * tig + (e & 1);
        const bool live = row < s && col < s && !(causal && col > row);
        const float p = expf((live ? sc[nt][e] * scale : kNegInf) - lr[e >> 1]);
        dp[nt][e] = p * (dp[nt][e] - delta[e >> 1]) * scale;
        sc[nt][e] = p;
      }
      const int at = (row0 + gid) * rw + k0 + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(sp + at) = make_float2(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<float2*>(sp + at + 8 * rw) = make_float2(sc[nt][2], sc[nt][3]);
      *reinterpret_cast<float2*>(sds + at) = make_float2(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<float2*>(sds + at + 8 * rw) = make_float2(dp[nt][2], dp[nt][3]);
    }
  }
  __syncthreads();  // P and dS are complete

  float acc[NH][4];
  // dQ = dS K over the keys the band sees: B[k = key][n = d] = K[key][d]
  const int nk = causal ? min((s + 7) >> 3, 2 * band + 2) : (s + 7) >> 3;
  zero(acc);
  mma_rows<NH, false>(acc, sds + row0 * rw, rw, sk + c0, hd, 0, nk, gid, tig);
  store_tiles<false>(outs[0] + seq_at, stride, acc, row0, s, hd - c0, gid, tig);
  // query rows before the band see none of its keys when causal
  const int q0 = causal ? 2 * band : 0, q1 = (s + 7) >> 3;
  // dV = P^T dO: A[m = key][k = query] = P[query][key]
  zero(acc);
  mma_rows<NH, true>(acc, sp + row0, rw, sdo + c0, hd, q0, q1, gid, tig);
  store_tiles<false>(outs[2] + seq_at, stride, acc, row0, s, hd - c0, gid, tig);
  // dK = dS^T Q
  zero(acc);
  mma_rows<NH, true>(acc, sds + row0, rw, sq + c0, hd, q0, q1, gid, tig);
  store_tiles<false>(outs[1] + seq_at, stride, acc, row0, s, hd - c0, gid, tig);
}

// G = 1: hd <= 4, one thread per (query row, head), N = S rounded up to 8.
// G = 16: hd > 4, one warp per 16 query rows, N = the 8-column tiles of hd
// a warp holds (hd <= 8 N).
// Launch bounds, which set the registers ptxas may give a thread (chosen by
// timing the paths' shapes on an H100): at hd > 4 the forward runs 4 blocks
// of at most 128 threads on an SM (shared memory allows that many), the
// backward 2 of 256, 128 registers each; at hd <= 4 the forward is left
// its registers, the backward is held to 5 blocks (48 registers) up to 40
// keys and to 4 beyond, where 48 would spill.
template <int G, int N, bool kStats>
__global__ void __launch_bounds__(G == 1 ? kStagedThreads : 128, G == 1 ? 1 : 4)
flash_fwd_kernel(Tensors t, Shape sh, Staging g, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sp = reinterpret_cast<float*>(smem_raw + kBarBytes) +
              g.stages * g.stage_floats;
  run_items<3>(smem_raw, t, sh, g, false, [&](float* stage, long long item) {
    if constexpr (G == 1) {
      fwd_rows<N, kStats>(stage, t, sh, g, item, scale, causal);
    } else {
      fwd_mma<N, kStats>(stage, sp, t, sh, g, item, scale, causal);
    }
  });
}

template <int G, int N>
__global__ void __launch_bounds__(kStagedThreads, G == 1 ? (N <= 40 ? 5 : 4) : 2)
flash_bwd_kernel(Tensors t, Shape sh, Staging g, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sp = reinterpret_cast<float*>(smem_raw + kBarBytes) +
              g.stages * g.stage_floats;
  run_items<5>(smem_raw, t, sh, g, true, [&](float* stage, long long item) {
    if constexpr (G == 1) {
      bwd_rows<N>(stage, sp, t, sh, g, item, scale, causal);
    } else {
      bwd_mma<N>(stage, sp, t, sh, g, item, scale, causal);
    }
  });
}

// ---------------------------------------------------------------------------
// Tiled route (S > 64)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;           // query rows and key rows of a tile
constexpr int kThreads = 256;       // 16 row groups x 16 column groups
constexpr int kPLd = kTile + 1;     // row stride of the P and dS tiles

// Odd row stride of a (kTile, hd) tile in shared memory.
__host__ __device__ __forceinline__ int tile_ld(int hd) { return hd | 1; }

// Rows [row0, row0 + kTile) of a sequence whose rows lie `stride` floats
// apart from `src` on, into dst (row stride ld); rows at or past S become 0.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int s, int hd, int ld,
                                          int stride) {
  const int n = kTile * hd;
  const int valid = (s - row0) * hd;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    dst[r * ld + d] =
        e < valid ? src[static_cast<size_t>(row0 + r) * stride + d] : 0.f;
  }
}

// acc[i][j] = sum_d a[(rg*4 + i) * ld + d] * b[(cg + 16*j) * ld + d], in
// order of d, each term one fused multiply-add.
__device__ __forceinline__ void dot_tile(float (&acc)[4][4],
                                         const float* a, const float* b,
                                         int hd, int ld, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const float* ar = a + rg * 4 * ld;
  const float* br = b + cg * ld;
#pragma unroll 2
  for (int d = 0; d < hd; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ar[i * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = br[16 * j * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

// Max and sum over the 16 lanes of a half warp (one row group).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

size_t fwd_tiled_smem_bytes(int hd) {
  return (3 * static_cast<size_t>(kTile) * tile_ld(hd) + kTile * kPLd) *
         sizeof(float);
}

size_t bwd_tiled_smem_bytes(int hd) {
  return (4 * static_cast<size_t>(kTile) * tile_ld(hd) + 2 * kTile * kPLd +
          kTile) * sizeof(float);
}

// grid (B * H, ceil(S / kTile)); lse may be null when kStats is false.
template <int NC, bool kStats>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, int s, int h, int hd,
                       float scale, int causal, float* __restrict__ o,
                       float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int ld = tile_ld(hd), stride = h * hd;
  float* sq = smem;
  float* sk = sq + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sp = sv + kTile * ld;
  const int bh = blockIdx.x;
  const size_t base =
      (static_cast<size_t>(bh / h) * s * h + bh % h) * static_cast<size_t>(hd);
  const int q0 = blockIdx.y * kTile;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile(sq, q + base, q0, s, hd, ld, stride);
  float m[4], den[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // keys past the last query row of the tile are all masked when causal
  const int k_end = causal ? min(q0 + kTile, s) : s;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of sk, sv, sp are done
    load_tile(sk, k + base, k0, s, hd, ld, stride);
    load_tile(sv, v + base, k0, s, hd, ld, stride);
    __syncthreads();
    float sc[4][4];
    dot_tile(sc, sq, sk, hd, ld, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = sc[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        sc[i][j] = x;
        if (col < s) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        const float p = col < s ? expf(sc[i][j] - m_new) : 0.f;
        sp[(rg * 4 + i) * kPLd + cg + 16 * j] = p;
        sum += p;
      }
      den[i] = den[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const int n_keys = min(kTile, s - k0);
    for (int j = 0; j < n_keys; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(rg * 4 + i) * kPLd + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cg + 16 * c;
        vv[c] = col < hd ? sv[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= s) continue;
    const float dd = fmaxf(den[i], kMinDen);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg + 16 * c;
      if (col < hd) {
        o[base + static_cast<size_t>(row) * stride + col] = acc[i][c] / dd;
      }
    }
    if (kStats && cg == 0) {
      lse[static_cast<size_t>(bh) * s + row] = m[i] + logf(dd);
    }
  }
}

// grid (B * H): one block walks every key tile of its (b, h).
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ o,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse, int s, int h, int hd,
                       float scale, int causal, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int ld = tile_ld(hd), stride = h * hd;
  float* sk = smem;
  float* sv = sk + kTile * ld;
  float* sq = sv + kTile * ld;
  float* sdo = sq + kTile * ld;
  float* sp = sdo + kTile * ld;
  float* sds = sp + kTile * kPLd;
  float* slse = sds + kTile * kPLd;
  const int bh = blockIdx.x;
  const size_t base =
      (static_cast<size_t>(bh / h) * s * h + bh % h) * static_cast<size_t>(hd);
  const size_t rbase = static_cast<size_t>(bh) * s;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();  // the previous key tile's readers of sk, sv are done
    load_tile(sk, k + base, k0, s, hd, ld, stride);
    load_tile(sv, v + base, k0, s, hd, ld, stride);
    float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
    }
    const int n_k = min(kTile, s - k0);
    // query rows before k0 see none of these keys when causal
    for (int q0 = causal ? k0 : 0; q0 < s; q0 += kTile) {
      __syncthreads();  // the previous query tile's readers are done
      load_tile(sq, q + base, q0, s, hd, ld, stride);
      load_tile(sdo, dout + base, q0, s, hd, ld, stride);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        slse[threadIdx.x] = row < s ? lse[rbase + row] : 0.f;
      }
      __syncthreads();
      // delta = rowsum(do * o) of this thread's rows, the same in the 16
      // lanes of its half warp
      float delta[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i, row = q0 + r;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          if (row < s && col < hd) {
            part = fmaf(sdo[r * ld + col],
                        o[base + static_cast<size_t>(row) * stride + col], part);
          }
        }
        delta[i] = half_warp_sum(part);
      }
      float sc[4][4], dp[4][4];
      dot_tile(sc, sq, sk, hd, ld, rg, cg);
      dot_tile(dp, sdo, sv, hd, ld, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + cg + 16 * j;
          float x = sc[i][j] * scale;
          if (causal && col > row) x = kNegInf;
          const float p = (row < s && col < s) ? expf(x - slse[r]) : 0.f;
          sp[r * kPLd + cg + 16 * j] = p;
          sds[r * kPLd + cg + 16 * j] = p * (dp[i][j] - delta[i]) * scale;
        }
      }
      __syncthreads();
      // dv += P^T dO and dk += dS^T Q over this tile's query rows; this
      // thread's key rows are rg*4 .. rg*4+3 of the key tile
      const int n_q = min(kTile, s - q0);
      for (int r = 0; r < n_q; ++r) {
        float p[4], ds[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sp[r * kPLd + rg * 4 + i];
          ds[i] = sds[r * kPLd + rg * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          dov[c] = col < hd ? sdo[r * ld + col] : 0.f;
          qv[c] = col < hd ? sq[r * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(p[i], dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv[c], dk_acc[i][c]);
          }
        }
      }
      // dq += dS K for this thread's query rows rg*4 .. rg*4+3
      float dq_t[4][NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_t[i][c] = 0.f;
      }
      for (int j = 0; j < n_k; ++j) {
        float ds[4], kv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = sds[(rg * 4 + i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          kv[c] = col < hd ? sk[j * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NC; ++c) dq_t[i][c] = fmaf(ds[i], kv[c], dq_t[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg * 4 + i;
        if (row >= s) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cg + 16 * c;
          if (col >= hd) continue;
          const size_t at = base + static_cast<size_t>(row) * stride + col;
          // key tile 0 reaches every query row first (causal or not)
          dq[at] = k0 == 0 ? dq_t[i][c] : dq[at] + dq_t[i][c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + rg * 4 + i;
      if (row >= s) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cg + 16 * c;
        if (col >= hd) continue;
        const size_t at = base + static_cast<size_t>(row) * stride + col;
        dk[at] = dk_acc[i][c];
        dv[at] = dv_acc[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool aligned(const void* const* ptrs, int n, uintptr_t bytes) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % bytes != 0) return false;
  }
  return true;
}

struct Plan {
  Staging g;
  int threads;
  size_t smem;
};

// The smallest stride >= n (a multiple of 8) that puts rows k * ld, k < 4,
// 8 banks apart: fragment loads that walk rows by tig are conflict-free.
int stride_8_24(int n) {
  int ld = round_up(n, 8);
  if (ld < 8) ld = 8;
  while (ld % 32 != 8 && ld % 32 != 24) ld += 8;
  return ld;
}

// The staged route's items, shared-memory layout and block for these
// shapes and pointers (those the kernel copies from or stores to).
Plan plan_staged(const Shape& sh, bool bwd, const void* const* ptrs, int n) {
  Plan pl{};
  Staging& g = pl.g;
  const bool small = sh.hd <= 4;
  const int nt = bwd ? 5 : 3;
  g.kt = round_up(sh.s, 8);
  int floats = 0;  // one stage
  if (small) {
    g.hg = 1;  // the most heads (a divisor of H) that keep S * hg <= 256
    for (int d = 1; d <= sh.h; ++d) {
      if (sh.h % d == 0 && sh.s * d <= kMaxRows) g.hg = d;
    }
    const int slot = g.kt * g.hg * 4;
    for (int i = 0; i < nt; ++i) {
      g.off[i] = i * slot;
      g.ld[i] = 4;
    }
    floats = nt * slot;
    if (bwd) {
      g.lse_off = floats;
      floats += round_up(g.hg * sh.s, 4);
    }
    g.rw = round_up(g.kt * g.hg, 32) + g.hg;
    g.extra_floats = bwd ? 2 * g.kt * g.rw : 0;
    pl.threads = round_up(sh.s * g.hg, 32);
  } else {
    // rows as they lie in device memory (stride hd); slots as long as the
    // fragment loads reach (64 key rows for the score tiles) plus 64 floats
    // of slack for the last row's columns past hd
    g.hg = 1;
    g.kq = round_up(sh.s, 16);
    const int rows[5] = {g.kq, 64, bwd ? 64 : g.kt, g.kq, g.kt};
    for (int i = 0; i < nt; ++i) {
      g.off[i] = floats;
      g.ld[i] = sh.hd;
      floats += round_up(rows[i] * sh.hd + 64, 4);
    }
    if (bwd) {
      g.lse_off = floats;
      floats += round_up(g.kq, 4);
    }
    // P (and dS): keys in 64 columns; the backward reads them down columns
    g.rw = bwd ? stride_8_24(64) : 68;
    g.extra_floats = (bwd ? 2 : 1) * g.kq * g.rw;
    // a warp per 16 query rows, two in the backward
    pl.threads = (bwd ? 4 : 2) * g.kq;
  }
  const bool a16 = aligned(ptrs, n, 16), a8 = aligned(ptrs, n, 8);
  // one bulk copy per tensor where an item's slab is contiguous and lands
  // as it lies: all H heads of a batch row, 16-byte multiples
  const bool bulk = g.hg == sh.h && (sh.s * sh.h * sh.hd) % 4 == 0 && a16 &&
                    (!small || sh.hd == 4);
  g.vec = bulk ? 0 : (sh.hd % 4 == 0 && a16) ? 4 : (sh.hd % 2 == 0 && a8) ? 2 : 1;
  g.out4 = small && sh.hd == 4 && a16;
  g.stage_floats = round_up(floats, 4);
  g.items = sh.b * (sh.h / g.hg);
  auto bytes = [&](int stages) {
    return kBarBytes +
           sizeof(float) * (static_cast<size_t>(stages) * g.stage_floats +
                            g.extra_floats);
  };
  // two stages where they still leave kMinBlocks blocks on an SM
  g.stages = kSmemPerSm / (bytes(2) + kSmemReserved) >= kMinBlocks ? 2 : 1;
  pl.smem = bytes(g.stages);
  return pl;
}

// Lets `fn` use `smem` bytes of dynamic shared memory and returns the blocks
// of it the card holds at once (SMs x blocks an SM holds). Both are found
// once per (fn, device, threads, smem) and kept: the attribute call and the
// occupancy query cost more host time than a small launch.
cudaError_t prepare(const void* fn, int dev, int threads, size_t smem,
                    long long* blocks) {
  struct Entry {
    const void* fn;
    int dev, threads;
    size_t smem;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  std::lock_guard<std::mutex> lock(mu);
  size_t allowed = 0;  // the attribute this fn has on dev so far
  for (const Entry& e : seen) {
    if (e.fn != fn || e.dev != dev) continue;
    if (e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
    if (e.smem > allowed) allowed = e.smem;
  }
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<long long>(sms) * per_sm;
  seen.push_back({fn, dev, threads, smem, *blocks});
  return cudaSuccess;
}

// One persistent block per resident slot of the card, at most one per item.
template <typename Kernel>
cudaError_t launch_staged(Kernel kernel, const Plan& pl, const Tensors& t,
                          const Shape& sh, float scale, int causal,
                          cudaStream_t st) {
  if (pl.smem > kSmemPerBlock) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long blocks = 0;
  err = prepare(reinterpret_cast<const void*>(kernel), dev, pl.threads,
                pl.smem, &blocks);
  if (err != cudaSuccess) return err;
  if (pl.g.items < blocks) blocks = pl.g.items;
  kernel<<<static_cast<unsigned>(blocks), pl.threads, pl.smem, st>>>(
      t, sh, pl.g, scale, causal);
  return cudaGetLastError();
}

// Output tiles of 8 columns a warp holds at hd > 4: 2, 4, 8 or 16.
int out_tiles(int hd) {
  const int n = (hd + 7) / 8;
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}

template <bool kStats>
cudaError_t fwd_staged(const Plan& pl, const Tensors& t, const Shape& sh,
                       float scale, int causal, cudaStream_t st) {
#define FLASH_FWD(G, N) \
  launch_staged(flash_fwd_kernel<G, N, kStats>, pl, t, sh, scale, causal, st)
  if (sh.hd <= 4) {
    switch (pl.g.kt) {
      case 8: return FLASH_FWD(1, 8);
      case 16: return FLASH_FWD(1, 16);
      case 24: return FLASH_FWD(1, 24);
      case 32: return FLASH_FWD(1, 32);
      case 40: return FLASH_FWD(1, 40);
      case 48: return FLASH_FWD(1, 48);
      case 56: return FLASH_FWD(1, 56);
      case 64: return FLASH_FWD(1, 64);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (out_tiles(sh.hd)) {
    case 2: return FLASH_FWD(16, 2);
    case 4: return FLASH_FWD(16, 4);
    case 8: return FLASH_FWD(16, 8);
    default: return FLASH_FWD(16, 16);
  }
#undef FLASH_FWD
}

cudaError_t bwd_staged(const Plan& pl, const Tensors& t, const Shape& sh,
                       float scale, int causal, cudaStream_t st) {
#define FLASH_BWD(G, N) \
  launch_staged(flash_bwd_kernel<G, N>, pl, t, sh, scale, causal, st)
  if (sh.hd <= 4) {
    switch (pl.g.kt) {
      case 8: return FLASH_BWD(1, 8);
      case 16: return FLASH_BWD(1, 16);
      case 24: return FLASH_BWD(1, 24);
      case 32: return FLASH_BWD(1, 32);
      case 40: return FLASH_BWD(1, 40);
      case 48: return FLASH_BWD(1, 48);
      case 56: return FLASH_BWD(1, 56);
      case 64: return FLASH_BWD(1, 64);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (out_tiles(sh.hd)) {
    case 2: return FLASH_BWD(16, 2);
    case 4: return FLASH_BWD(16, 4);
    case 8: return FLASH_BWD(16, 8);
    default: return FLASH_BWD(16, 16);
  }
#undef FLASH_BWD
}

// Column groups per thread of the tiled route (1, 2, 4 or 8).
int column_groups(int hd) {
  if (hd <= 16) return 1;
  if (hd <= 32) return 2;
  if (hd <= 64) return 4;
  return 8;
}

// prepare() for a kernel of the tiled route, whose grid is one block per
// tile.
cudaError_t prepare_tiled(const void* fn, size_t smem) {
  int dev = 0;
  long long blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : prepare(fn, dev, kThreads, smem, &blocks);
}

template <int NC, bool kStats>
cudaError_t launch_fwd_tiled(const float* q, const float* k, const float* v,
                             const Shape& sh, float scale, int causal,
                             float* o, float* lse, cudaStream_t stream) {
  const size_t smem = fwd_tiled_smem_bytes(sh.hd);
  const cudaError_t err = prepare_tiled(
      reinterpret_cast<const void*>(flash_fwd_tiled_kernel<NC, kStats>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(sh.b * sh.h),
                  static_cast<unsigned>((sh.s + kTile - 1) / kTile));
  flash_fwd_tiled_kernel<NC, kStats><<<grid, kThreads, smem, stream>>>(
      q, k, v, sh.s, sh.h, sh.hd, scale, causal, o, lse);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd_tiled(const float* q, const float* k, const float* v,
                             const float* o, const float* dout,
                             const float* lse, const Shape& sh, float scale,
                             int causal, float* dq, float* dk, float* dv,
                             cudaStream_t stream) {
  const size_t smem = bwd_tiled_smem_bytes(sh.hd);
  const cudaError_t err = prepare_tiled(
      reinterpret_cast<const void*>(flash_bwd_tiled_kernel<NC>), smem);
  if (err != cudaSuccess) return err;
  flash_bwd_tiled_kernel<NC>
      <<<static_cast<unsigned>(sh.b * sh.h), kThreads, smem, stream>>>(
          q, k, v, o, dout, lse, sh.s, sh.h, sh.hd, scale, causal, dq, dk, dv);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t fwd_tiled(const float* q, const float* k, const float* v,
                      const Shape& sh, float scale, int causal, float* o,
                      float* lse, cudaStream_t st) {
  switch (column_groups(sh.hd)) {
    case 1: return launch_fwd_tiled<1, kStats>(q, k, v, sh, scale, causal, o, lse, st);
    case 2: return launch_fwd_tiled<2, kStats>(q, k, v, sh, scale, causal, o, lse, st);
    case 4: return launch_fwd_tiled<4, kStats>(q, k, v, sh, scale, causal, o, lse, st);
    default: return launch_fwd_tiled<8, kStats>(q, k, v, sh, scale, causal, o, lse, st);
  }
}

bool bad_shape(long long b, int s, int h, int hd) {
  return b < 1 || h < 1 || s < 1 || hd < 1 || hd > kMaxHeadDim ||
         b > INT_MAX / h || (s + kTile - 1) / kTile > 65535;
}

}  // namespace

// Forward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// q, k, v, o (b, s, h, hd) float32, contiguous; lse (b, h, s) float32, or
// null for the plain forward, which writes no logsumexp rows. S <= 64 takes
// the staged route, longer S the tiled one.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, long long b, int s, int h,
                                   int hd, float scale, int causal, void* o,
                                   void* lse, void* stream) {
  if (bad_shape(b, s, h, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, s, h, hd};
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  auto* fl = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (s <= kMaxStaged) {
    const void* ptrs[] = {q, k, v, o};
    const Plan pl = plan_staged(sh, false, ptrs, 4);
    const Tensors t{{fq, fk, fv, nullptr, nullptr}, nullptr,
                    {fo, nullptr, nullptr}, fl};
    err = lse == nullptr ? fwd_staged<false>(pl, t, sh, scale, causal, st)
                         : fwd_staged<true>(pl, t, sh, scale, causal, st);
  } else {
    err = lse == nullptr
              ? fwd_tiled<false>(fq, fk, fv, sh, scale, causal, fo, fl, st)
              : fwd_tiled<true>(fq, fk, fv, sh, scale, causal, fo, fl, st);
  }
  return static_cast<int>(err);
}

// Backward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// q, k, v, o, dout, dq, dk, dv (b, s, h, hd) and lse (b, h, s), float32 and
// contiguous. delta = rowsum(dout * o) is formed inside; dq, dk and dv are
// written whole.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   long long b, int s, int h, int hd,
                                   float scale, int causal, void* dq, void* dk,
                                   void* dv, void* stream) {
  if (bad_shape(b, s, h, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, s, h, hd};
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(o);
  const auto* fg = static_cast<const float*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* x = static_cast<float*>(dq);
  auto* y = static_cast<float*>(dk);
  auto* z = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (s <= kMaxStaged) {
    const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
    const Plan pl = plan_staged(sh, true, ptrs, 8);
    const Tensors t{{fq, fk, fv, fg, fo}, fl, {x, y, z}, nullptr};
    err = bwd_staged(pl, t, sh, scale, causal, st);
  } else {
    switch (column_groups(hd)) {
      case 1: err = launch_bwd_tiled<1>(fq, fk, fv, fo, fg, fl, sh, scale, causal, x, y, z, st); break;
      case 2: err = launch_bwd_tiled<2>(fq, fk, fv, fo, fg, fl, sh, scale, causal, x, y, z, st); break;
      case 4: err = launch_bwd_tiled<4>(fq, fk, fv, fo, fg, fl, sh, scale, causal, x, y, z, st); break;
      default: err = launch_bwd_tiled<8>(fq, fk, fv, fo, fg, fl, sh, scale, causal, x, y, z, st); break;
    }
  }
  return static_cast<int>(err);
}
