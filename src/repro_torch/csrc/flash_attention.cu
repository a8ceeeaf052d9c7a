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
//   with delta = rowsum(do * o), formed inside, once a row (the reference
//   forms it outside its kernel; the sum is the same).
// On the staged route at hd <= 4 the products are float32 FMAs in order of
// d; everywhere else (the staged route at hd > 4, the tiled route at every
// hd) they run on the tensor cores in split TF32 (three TF32 products per
// product, about 2^-20 of it dropped; see mma3()). expf and logf are the
// accurate ones: build without --use_fast_math. Every sum runs in a fixed
// order and no float atomics are used, so the backward gives the same bits
// when repeated.
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
// * S > 64, tiled (flash_fwd_tiled_kernel; the backward flash_bwd_dq_kernel
//   then flash_bwd_dkdv_kernel): the LM's prefill and training at hd 128.
//   What bounds it is the tensor pipe: at train_4k (8 x 4,096, 16 heads of
//   128, causal) the forward's two products are 5.5e11 float32 operations
//   against 1.07 GB, so in split TF32 at 495 TFLOP/s they take 3.3 ms where
//   the bytes take 0.32 ms; the backward's five products 8.3 ms. Where the
//   time goes on mma.sync (scripts/flash_variants.py --set tiled, H100 at
//   700 W): splitting each operand into its TF32 pair, which every warp
//   does for each tile it reads, is about a third of each kernel (34% of
//   the forward at 4,096 keys, 32% of the backward at train_4k); the two
//   extra TF32 products a fifth to a quarter (20-24%); the rest is the
//   one product left, the softmax and the copies. The design:
//   - Forward: one block per (b·h, 64-row query tile), four warps of 16
//     query rows, a sequence's tiles together and its heaviest (last) first,
//     so the blocks in flight share its keys in L2. Q staged once; K and V
//     tiles of 64 keys in two buffers, each refilled by 16-byte cp.async as
//     soon as every warp has read it (K_{j+1} lands during the softmax and
//     P.V of tile j, V_{j+1} during the scores of tile j + 1); deeper
//     rings gained nothing (32-key tiles, alone or two deep, within 1.5%;
//     two 64-key stages or three 32-key ones, one block an SM, 20-37%
//     slower). S = Q.K^T with fragments loaded by ldmatrix (four 8 x 4 float blocks a load);
//     the online softmax on the accumulator fragments, quad shuffles for a
//     row's max and sum; P stays in registers for O += P.V (the k order is
//     permuted instead of the registers). When causal only the key tiles up
//     to the query tile's last row.
//   - Backward: the dQ kernel, a block per (b·h, 64-row query tile) over
//     key steps of 32 up to the diagonal, forms delta once a row (into a
//     (B, H, S) scratch), recomputes S and dP, and sums dQ = dS.K; then the
//     dK/dV kernel, a block per (b·h, 64-row key tile) over query steps of
//     32 from the diagonal on, sums dV = P^T.dO and dK = dS^T.Q. K and V (Q
//     and dO) of a step take two buffers whose roles swap every step, so
//     both land during compute. Each output is written once, no atomics;
//     the price is S and dP formed twice (seven products for five). The
//     grid is (b·h) x tiles: 8,192 blocks of each kind at train_4k.
//   - Columns padded to hd rounded up to 16, 32, 64 or 128, rows to that
//     plus 4 floats (132 at hd 128: an odd multiple of 4, so fragment loads
//     meet 32 distinct banks and rows stay 16-byte aligned); at hd 128 each
//     kernel takes 99-99.5 KB of shared memory and 160-255 registers a
//     thread: two blocks (eight warps) an SM. Any S > 64: rows past S are
//     copied in as zeros and masked.
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

constexpr int kTiledThreads = 128;  // four warps, 16 rows of a tile each
constexpr int kTileRows = 64;       // query rows of a forward or dQ block,
                                    // key rows of a dK/dV block
constexpr int kStepRows = 32;       // key rows of a dQ step, query rows of
                                    // a dK/dV step
// The forward's key tiles: kFwdKeyRows keys, K and V each in a ring of
// kFwdStages buffers (scripts/flash_variants.py --set tiled times other
// settings: none was faster at hd 128).
constexpr int kFwdKeyRows = 64;
constexpr int kFwdStages = 1;

// Row stride (floats) of a tile whose columns are padded to 8 ND: 8 ND + 4,
// an odd multiple of 4. An ldmatrix's eight 16-byte rows and the 32-bit
// loads that walk rows by 2 tig (B operands with the keys or queries along
// k) then meet distinct banks, and every row stays 16-byte aligned for
// cp.async and ldmatrix.
template <int ND>
__host__ __device__ constexpr int tiled_ld() {
  return 8 * ND + 4;
}

// cp.async of kBytes (16 or 4) that writes zeros where !live (src-size 0;
// src is not read then).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool live) {
  const int n = live ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

// Rows [row0, row0 + kRows) of a (b, h) sequence whose rows lie `stride`
// floats apart from `src` on, columns [0, hd), into dst (row stride LD):
// 16 bytes a copy where vec4 (hd % 4 == 0, pointers 16-byte aligned), else
// 4; rows at or past S become zeros. Columns [hd, LD) are not written.
template <int kRows, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int s, int hd, int stride,
                                          int vec4) {
  if (vec4) {
    const int per_row = hd >> 2;
    for (int c = threadIdx.x; c < kRows * per_row; c += kTiledThreads) {
      const int r = c / per_row, e = (c - r * per_row) << 2;
      const bool live = row0 + r < s;
      cp_async_zfill<16>(
          dst + r * LD + e,
          live ? src + static_cast<size_t>(row0 + r) * stride + e : src, live);
    }
  } else {
    for (int c = threadIdx.x; c < kRows * hd; c += kTiledThreads) {
      const int r = c / hd, e = c - r * hd;
      const bool live = row0 + r < s;
      cp_async_zfill<4>(
          dst + r * LD + e,
          live ? src + static_cast<size_t>(row0 + r) * stride + e : src, live);
    }
  }
}

// Entries [row0, row0 + n) of a (B, H, S) row vector from `src` (the
// sequence's start) into dst; entries at or past S become zeros.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n, int s) {
  for (int r = threadIdx.x; r < n; r += kTiledThreads) {
    const bool live = row0 + r < s;
    cp_async_zfill<4>(dst + r, live ? src + row0 + r : src, live);
  }
}

// Columns [hd, 8 ND) of `rows` rows (stride tiled_ld<ND>()) to zero: the
// fragments read them, cp.async never writes them.
template <int ND>
__device__ __forceinline__ void zero_pad(float* p, int rows, int hd) {
  const int pad = 8 * ND - hd;
  for (int e = threadIdx.x; e < rows * pad; e += kTiledThreads) {
    const int r = e / pad;
    p[r * tiled_ld<ND>() + hd + (e - r * pad)] = 0.f;
  }
}

// Four 8 x 4 float blocks of shared memory in one instruction: lane l
// names row l % 8 of block l / 8 (16 bytes, 16-byte aligned); read as 8 x
// 8 b16 matrices, thread (gid, tig) receives float (gid, tig) of each block
// in r[block], which is the TF32 fragment layout.
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row))
      : "memory");
}

// c[nt] += A . B^T over the 8 ND columns: A the 16 rows at a, B^T the rows
// 8 nt .. 8 nt + 7 at b, both stride LD. A k-step's A fragment is one
// ldmatrix, split once for the NT B fragments it meets; each pair of n-tiles
// takes one more. The k-steps are unrolled by four, not wholly: at hd 128
// a whole unroll hoists more fragments than the registers hold, and spills
// (by two, 0.7-3% slower on the card: scripts/flash_variants.py).
template <int ND, int NT>
__device__ __forceinline__ void abt(float (&c)[NT][4], const float* a,
                                    const float* b, int lane) {
  constexpr int LD = tiled_ld<ND>();
  const int r = lane & 7, m = lane >> 3;
  // A's blocks: rows 0-7 and 8-15 of columns 0-3, then of columns 4-7;
  // B's: columns 0-3 and 4-7 of n-tile nt, then of n-tile nt + 1
  const float* arow = a + (r + 8 * (m & 1)) * LD + 4 * (m >> 1);
  const float* brow = b + (r + 8 * (m >> 1)) * LD + 4 * (m & 1);
#pragma unroll 4
  for (int ks = 0; ks < ND; ++ks) {
    uint32_t x[4];
    ldmatrix4(x, arow + 8 * ks);
    FragA fa;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), fa.hi[i], fa.lo[i]);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t y[4];
      ldmatrix4(y, brow + 8 * nt * LD + 8 * ks);
      FragB f0, f1;
      split(__uint_as_float(y[0]), f0.hi[0], f0.lo[0]);
      split(__uint_as_float(y[1]), f0.hi[1], f0.lo[1]);
      split(__uint_as_float(y[2]), f1.hi[0], f1.lo[0]);
      split(__uint_as_float(y[3]), f1.hi[1], f1.lo[1]);
      mma3(c[nt], fa, f0);
      mma3(c[nt + 1], fa, f1);
    }
  }
}

// c[nd] += A . B over NT k-steps of 8, A the accumulator fragments x (16 x
// 8 NT: row gid holds columns 2 tig and 2 tig + 1 of each 8) and B the rows
// at b (stride LD), 8 ND columns. The accumulator layout is not the A
// layout, so the k order is permuted instead of the registers: A's k-slots
// tig and tig + 4 carry columns 2 tig and 2 tig + 1, and B's rows are read
// in the same order. No shuffle, no round trip through shared memory.
// The tensor cores round each mma's sum toward zero, so a sum carried
// through every tile of a sequence drifts (~1e-4 of o after 4,096 keys when
// v has a common part, as at init): each call sums into fresh accumulators,
// four n-tiles at a time, and adds them to c in float32, rounded to
// nearest. A chain is then one tile long (3 NT mma).
template <int ND, int NT>
__device__ __forceinline__ void ab_regs(float (&c)[ND][4],
                                        const float (&x)[NT][4],
                                        const float* b, int gid, int tig) {
  constexpr int LD = tiled_ld<ND>();
  constexpr int G = ND < 4 ? ND : 4;  // n-tiles summed at a time
#pragma unroll
  for (int g = 0; g < ND; g += G) {
    float t[G][4];
    zero(t);
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      FragA fa;
      split(x[kt][0], fa.hi[0], fa.lo[0]);  // (gid, 2 tig)
      split(x[kt][2], fa.hi[1], fa.lo[1]);  // (gid + 8, 2 tig)
      split(x[kt][1], fa.hi[2], fa.lo[2]);  // (gid, 2 tig + 1)
      split(x[kt][3], fa.hi[3], fa.lo[3]);  // (gid + 8, 2 tig + 1)
      const float* row = b + (8 * kt + 2 * tig) * LD + gid + 8 * g;
#pragma unroll
      for (int nd = 0; nd < G; ++nd) {
        FragB fb;
        split(row[8 * nd], fb.hi[0], fb.lo[0]);
        split(row[LD + 8 * nd], fb.hi[1], fb.lo[1]);
        mma3(t[nd], fa, fb);
      }
    }
#pragma unroll
    for (int nd = 0; nd < G; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[g + nd][e] += t[nd][e];
    }
  }
}

// The (b, h) of this block, `tiles` blocks a sequence, and its tile:
// counted from the sequence's last tile where from_last.
__device__ __forceinline__ void block_tile(int tiles, bool from_last, int& bh,
                                           int& tile) {
  bh = static_cast<int>(blockIdx.x / tiles);
  tile = static_cast<int>(blockIdx.x - static_cast<unsigned>(bh) * tiles);
  if (from_last) tile = tiles - 1 - tile;
}

// Forward: one block per (b·h, 64-row query tile), the heaviest (last)
// query tiles of a sequence first and a sequence's tiles together, so the
// blocks in flight share its keys in L2. Warp w owns query rows q0 + 16 w
// .. + 15, staged once in shared memory with the first key tile (in
// registers they would leave too few for the rest at hd 128). Key tiles of
// KR rows in a ring of NS stages of K and V, each buffer refilled by
// cp.async as soon as every warp has read it: tile j's K with K_{j+NS}
// after its scores, its V with V_{j+NS} after P.V (at NS = 1, K_{j+1}
// lands during the softmax and P.V of tile j, V_{j+1} during the scores of
// tile j + 1). S = Q.K^T and O += P.V in split TF32; the online softmax
// on the score fragments (quad shuffles for a row's max and sum), P handed
// to P.V in registers (ab_regs). When causal only the key tiles up to the
// query tile's last row.
template <int ND, bool kStats>
__global__ void __launch_bounds__(kTiledThreads, 2)
flash_fwd_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, int s, int h, int hd,
                       float scale, int causal, int vec4,
                       float* __restrict__ o, float* __restrict__ lse) {
  constexpr int LD = tiled_ld<ND>();
  constexpr int KR = kFwdKeyRows, NS = kFwdStages, NT = KR / 8;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;  // then stage t: K at KR (2 t) rows past Q, V after it
  const auto sk = [&](int t) { return smem + (kTileRows + 2 * t * KR) * LD; };
  const auto sv = [&](int t) { return sk(t) + KR * LD; };
  int bh, qt;
  block_tile((s + kTileRows - 1) / kTileRows, true, bh, qt);
  const int stride = h * hd, q0 = qt * kTileRows;
  const size_t base =
      (static_cast<size_t>(bh / h) * s * h + bh % h) * static_cast<size_t>(hd);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, row0 = q0 + 16 * w;
  // keys past the query tile's last row are all masked when causal
  const int n_kt = ((causal ? min(q0 + kTileRows, s) : s) + KR - 1) / KR;

  // two cp.async groups a tile, K_j's then V_j's (Q goes with K_0's), so
  // 2 NS - 1 groups may still be in flight when either is needed
  zero_pad<ND>(smem, kTileRows + 2 * NS * KR, hd);
  load_rows<kTileRows, LD>(sq, q + base, q0, s, hd, stride, vec4);
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    if (t < n_kt) load_rows<KR, LD>(sk(t), k + base, t * KR, s, hd, stride, vec4);
    cp_async_commit();
    if (t < n_kt) load_rows<KR, LD>(sv(t), v + base, t * KR, s, hd, stride, vec4);
    cp_async_commit();
  }
  const float* qw = sq + 16 * w * LD;
  float acc[ND][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * KR, t = j % NS;
    cp_async_wait<2 * NS - 1>();  // Q and K_j have landed
    __syncthreads();
    float sc[NT][4];
    zero(sc);
    abt<ND, NT>(sc, qw, sk(t), lane);
    __syncthreads();  // every warp has read K_j
    if (j + NS < n_kt) {
      load_rows<KR, LD>(sk(t), k + base, k0 + NS * KR, s, hd, stride, vec4);
    }
    cp_async_commit();
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gid + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * tig + (e & 1);
        const bool live = col < s && !(causal && col > row);
        sc[nt][e] = live ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
        sum[e >> 1] += sc[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) den[i] = den[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    }
    cp_async_wait<2 * NS - 1>();  // V_j has landed
    __syncthreads();
    ab_regs<ND, NT>(acc, sc, sv(t), gid, tig);
    __syncthreads();  // every warp has read V_j
    if (j + NS < n_kt) {
      load_rows<KR, LD>(sv(t), v + base, k0 + NS * KR, s, hd, stride, vec4);
    }
    cp_async_commit();
  }
  const float dd[2] = {fmaxf(den[0], kMinDen), fmaxf(den[1], kMinDen)};
  const Divisor div[2] = {divisor(dd[0]), divisor(dd[1])};
  store_tiles<true>(o + base, stride, acc, row0, s, hd, gid, tig, div);
  if (kStats && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gid + 8 * i;
      if (row < s) lse[static_cast<size_t>(bh) * s + row] = m[i] + logf(dd[i]);
    }
  }
}

// Backward, first kernel: dQ and delta. One block per (b·h, 64-row query
// tile), ordered as the forward's. Warp w owns query rows q0 + 16 w .. +
// 15: it forms delta = rowsum(do·o) of its rows once (into the (B, H, S)
// scratch the dK/dV kernel reads), reads its Q and dO rows from shared
// memory (staged once), and walks key steps of 32 rows up to the diagonal:
// S = Q.K^T, dP = dO.V^T, P = exp(S·scale - lse), dS = P (dP - delta)
// scale, dQ += dS.K (dS from registers). K and V of a step take two
// buffers whose roles swap every step: K_{j+1} goes into V_j's buffer once
// dP has read it, V_{j+1} into K_j's once dQ has, so both land during
// compute. dQ is written once.
template <int ND>
__global__ void __launch_bounds__(kTiledThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, int s, int h, int hd,
                    float scale, int causal, int vec4,
                    float* __restrict__ dq, float* __restrict__ delta_out) {
  constexpr int LD = tiled_ld<ND>();
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = smem + kTileRows * LD;
  float* buf[2] = {smem + 2 * kTileRows * LD,
                   smem + (2 * kTileRows + kStepRows) * LD};
  int bh, qt;
  block_tile((s + kTileRows - 1) / kTileRows, true, bh, qt);
  const int stride = h * hd, q0 = qt * kTileRows;
  const size_t base =
      (static_cast<size_t>(bh / h) * s * h + bh % h) * static_cast<size_t>(hd);
  const size_t rbase = static_cast<size_t>(bh) * s;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, row0 = q0 + 16 * w;
  const int n_kt =
      ((causal ? min(q0 + kTileRows, s) : s) + kStepRows - 1) / kStepRows;

  zero_pad<ND>(smem, 2 * kTileRows + 2 * kStepRows, hd);
  load_rows<kTileRows, LD>(sq, q + base, q0, s, hd, stride, vec4);
  load_rows<kTileRows, LD>(sdo, dout + base, q0, s, hd, stride, vec4);
  load_rows<kStepRows, LD>(buf[0], k + base, 0, s, hd, stride, vec4);
  cp_async_commit();
  load_rows<kStepRows, LD>(buf[1], v + base, 0, s, hd, stride, vec4);
  cp_async_commit();
  const float* qw = sq + 16 * w * LD;
  const float* dw = sdo + 16 * w * LD;
  float lr[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gid + 8 * i;
    float part = 0.f;
    if (row < s) {
      const size_t at = base + static_cast<size_t>(row) * stride;
      for (int d = tig; d < hd; d += 4) part = fmaf(dout[at + d], o[at + d], part);
    }
    delta[i] = quad_sum(part);
    lr[i] = row < s ? lse[rbase + row] : 0.f;
    if (tig == 0 && row < s) delta_out[rbase + row] = delta[i];
  }
  float acc[ND][4];
  zero(acc);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kStepRows;
    float* kb = buf[j & 1];
    float* vb = buf[(j & 1) ^ 1];
    cp_async_wait<1>();  // Q, dO and K_j have landed (V_j may be in flight)
    __syncthreads();
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    abt<ND, 4>(sc, qw, kb, lane);
    cp_async_wait<0>();  // V_j has landed
    __syncthreads();
    abt<ND, 4>(dp, dw, vb, lane);
    __syncthreads();  // every warp has read V_j: K_{j+1} takes its buffer
    if (j + 1 < n_kt) {
      load_rows<kStepRows, LD>(vb, k + base, k0 + kStepRows, s, hd, stride,
                               vec4);
    }
    cp_async_commit();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gid + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * tig + (e & 1);
        const bool live = row < s && col < s && !(causal && col > row);
        const float p = expf((live ? sc[nt][e] * scale : kNegInf) - lr[e >> 1]);
        dp[nt][e] = p * (dp[nt][e] - delta[e >> 1]) * scale;
      }
    }
    ab_regs<ND, 4>(acc, dp, kb, gid, tig);
    __syncthreads();  // every warp has read K_j: V_{j+1} takes its buffer
    if (j + 1 < n_kt) {
      load_rows<kStepRows, LD>(kb, v + base, k0 + kStepRows, s, hd, stride,
                               vec4);
    }
    cp_async_commit();
  }
  store_tiles<false>(dq + base, stride, acc, row0, s, hd, gid, tig);
}

// Backward, second kernel: dK and dV. One block per (b·h, 64-row key
// tile), key tile 0 (when causal the longest walk) first. Warp w owns key
// rows k0 + 16 w .. + 15; K and V of the tile stay in shared memory. It
// walks query steps of 32 rows from the diagonal on: S^T = K.Q^T, dP^T =
// V.dO^T, P^T = exp(S^T·scale - lse), dS^T = P^T (dP^T - delta) scale (lse
// and delta of the step's rows staged beside its Q), dV += P^T.dO and dK +=
// dS^T.Q from registers. Q (with lse and delta) and dO of a step take two
// buffers whose roles swap every step: Q_{i+1} goes into dO_i's buffer once
// dV has read it, dO_{i+1} into Q_i's once dK has. dK and dV are written
// once.
template <int ND>
__global__ void __launch_bounds__(kTiledThreads, 2)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int s, int h, int hd,
                      float scale, int causal, int vec4,
                      float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int LD = tiled_ld<ND>();
  constexpr int kBuf = kStepRows * LD + 2 * kStepRows;  // rows, lse, delta
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = smem + kTileRows * LD;
  float* buf[2] = {smem + 2 * kTileRows * LD,
                   smem + 2 * kTileRows * LD + kBuf};
  int bh, kt;
  block_tile((s + kTileRows - 1) / kTileRows, false, bh, kt);
  const int stride = h * hd, k0 = kt * kTileRows;
  const size_t base =
      (static_cast<size_t>(bh / h) * s * h + bh % h) * static_cast<size_t>(hd);
  const size_t rbase = static_cast<size_t>(bh) * s;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, key0 = k0 + 16 * w;
  // query rows before k0 see none of these keys when causal
  const int i0 = causal ? k0 / kStepRows : 0;
  const int n_qi = (s + kStepRows - 1) / kStepRows;

  zero_pad<ND>(smem, 2 * kTileRows, hd);
  zero_pad<ND>(buf[0], kStepRows, hd);
  zero_pad<ND>(buf[1], kStepRows, hd);
  load_rows<kTileRows, LD>(sk, k + base, k0, s, hd, stride, vec4);
  load_rows<kTileRows, LD>(sv, v + base, k0, s, hd, stride, vec4);
  load_rows<kStepRows, LD>(buf[0], q + base, i0 * kStepRows, s, hd, stride,
                           vec4);
  load_vec(buf[0] + kStepRows * LD, lse + rbase, i0 * kStepRows, kStepRows, s);
  load_vec(buf[0] + kStepRows * LD + kStepRows, delta + rbase,
           i0 * kStepRows, kStepRows, s);
  cp_async_commit();
  load_rows<kStepRows, LD>(buf[1], dout + base, i0 * kStepRows, s, hd, stride,
                           vec4);
  cp_async_commit();
  float acc_k[ND][4], acc_v[ND][4];
  zero(acc_k);
  zero(acc_v);
  const float* ka = sk + 16 * w * LD;
  const float* va = sv + 16 * w * LD;
  for (int i = i0; i < n_qi; ++i) {
    const int c0 = i * kStepRows;
    float* qb = buf[(i - i0) & 1];
    float* ob = buf[((i - i0) & 1) ^ 1];
    cp_async_wait<1>();  // K, V, Q_i, lse and delta have landed
    __syncthreads();
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    abt<ND, 4>(st, ka, qb, lane);
    cp_async_wait<0>();  // dO_i has landed
    __syncthreads();
    abt<ND, 4>(dpt, va, ob, lane);
    const float* slse = qb + kStepRows * LD;
    const float* sdelta = slse + kStepRows;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + gid + 8 * (e >> 1);
        const int c = 8 * nt + 2 * tig + (e & 1), query = c0 + c;
        const bool live = key < s && query < s && !(causal && key > query);
        const float p = expf((live ? st[nt][e] * scale : kNegInf) - slse[c]);
        dpt[nt][e] = p * (dpt[nt][e] - sdelta[c]) * scale;
        st[nt][e] = p;
      }
    }
    ab_regs<ND, 4>(acc_v, st, ob, gid, tig);
    __syncthreads();  // every warp has read dO_i: Q_{i+1} takes its buffer
    if (i + 1 < n_qi) {
      load_rows<kStepRows, LD>(ob, q + base, c0 + kStepRows, s, hd, stride,
                               vec4);
      load_vec(ob + kStepRows * LD, lse + rbase, c0 + kStepRows, kStepRows, s);
      load_vec(ob + kStepRows * LD + kStepRows, delta + rbase,
               c0 + kStepRows, kStepRows, s);
    }
    cp_async_commit();
    ab_regs<ND, 4>(acc_k, dpt, qb, gid, tig);
    __syncthreads();  // every warp has read Q_i: dO_{i+1} takes its buffer
    if (i + 1 < n_qi) {
      load_rows<kStepRows, LD>(qb, dout + base, c0 + kStepRows, s, hd, stride,
                               vec4);
    }
    cp_async_commit();
  }
  store_tiles<false>(dk + base, stride, acc_k, key0, s, hd, gid, tig);
  store_tiles<false>(dv + base, stride, acc_v, key0, s, hd, gid, tig);
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

// The tiled route's launches: one block per tile, its shared memory set
// once per kernel (prepare()).
template <typename Kernel, typename... Args>
cudaError_t launch_tiled(Kernel kernel, size_t smem, long long blocks,
                         cudaStream_t stream, Args... args) {
  int dev = 0;
  long long resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = prepare(reinterpret_cast<const void*>(kernel), dev, kTiledThreads,
                smem, &resident);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kTiledThreads, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

long long tiled_blocks(const Shape& sh) {
  return sh.b * sh.h * ((sh.s + kTileRows - 1) / kTileRows);
}

template <int ND, bool kStats>
cudaError_t launch_fwd_tiled(const float* q, const float* k, const float* v,
                             const Shape& sh, float scale, int causal,
                             int vec4, float* o, float* lse,
                             cudaStream_t stream) {
  const size_t smem = (kTileRows + 2 * kFwdStages * kFwdKeyRows) *
                      tiled_ld<ND>() * sizeof(float);
  return launch_tiled(flash_fwd_tiled_kernel<ND, kStats>, smem,
                      tiled_blocks(sh), stream, q, k, v, sh.s, sh.h, sh.hd,
                      scale, causal, vec4, o, lse);
}

// dQ and delta first, then dK and dV, which read delta: one stream, so in
// that order.
template <int ND>
cudaError_t launch_bwd_tiled(const float* q, const float* k, const float* v,
                             const float* o, const float* dout,
                             const float* lse, const Shape& sh, float scale,
                             int causal, int vec4, float* dq, float* dk,
                             float* dv, float* delta, cudaStream_t stream) {
  constexpr int LD = tiled_ld<ND>();
  const size_t dq_smem = 2 * (kTileRows + kStepRows) * LD * sizeof(float);
  const size_t dkdv_smem =
      (2 * kTileRows * LD + 2 * (kStepRows * LD + 2 * kStepRows)) *
      sizeof(float);
  const cudaError_t err = launch_tiled(
      flash_bwd_dq_kernel<ND>, dq_smem, tiled_blocks(sh), stream, q, k, v, o,
      dout, lse, sh.s, sh.h, sh.hd, scale, causal, vec4, dq, delta);
  if (err != cudaSuccess) return err;
  return launch_tiled(flash_bwd_dkdv_kernel<ND>, dkdv_smem, tiled_blocks(sh),
                      stream, q, k, v, dout, lse,
                      static_cast<const float*>(delta), sh.s, sh.h, sh.hd,
                      scale, causal, vec4, dk, dv);
}

template <bool kStats>
cudaError_t fwd_tiled(const float* q, const float* k, const float* v,
                      const Shape& sh, float scale, int causal, int vec4,
                      float* o, float* lse, cudaStream_t st) {
#define FLASH_FWD(ND) \
  launch_fwd_tiled<ND, kStats>(q, k, v, sh, scale, causal, vec4, o, lse, st)
  switch (out_tiles(sh.hd)) {
    case 2: return FLASH_FWD(2);
    case 4: return FLASH_FWD(4);
    case 8: return FLASH_FWD(8);
    default: return FLASH_FWD(16);
  }
#undef FLASH_FWD
}

cudaError_t bwd_tiled(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, const float* lse,
                      const Shape& sh, float scale, int causal, int vec4,
                      float* dq, float* dk, float* dv, float* delta,
                      cudaStream_t st) {
#define FLASH_BWD(ND)                                                       \
  launch_bwd_tiled<ND>(q, k, v, o, dout, lse, sh, scale, causal, vec4, dq, \
                       dk, dv, delta, st)
  switch (out_tiles(sh.hd)) {
    case 2: return FLASH_BWD(2);
    case 4: return FLASH_BWD(4);
    case 8: return FLASH_BWD(8);
    default: return FLASH_BWD(16);
  }
#undef FLASH_BWD
}

// 16-byte copies where every row of the (B, S, H, hd) tensors starts on a
// 16-byte boundary.
int vec4_rows(int hd, const void* const* ptrs, int n) {
  return hd % 4 == 0 && aligned(ptrs, n, 16) ? 1 : 0;
}

bool bad_shape(long long b, int s, int h, int hd) {
  return b < 1 || h < 1 || s < 1 || hd < 1 || hd > kMaxHeadDim ||
         b > INT_MAX / h ||
         b * h * ((s + kTileRows - 1) / kTileRows) > INT_MAX;
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
    const void* ptrs[] = {q, k, v};
    const int vec4 = vec4_rows(hd, ptrs, 3);
    err = lse == nullptr
              ? fwd_tiled<false>(fq, fk, fv, sh, scale, causal, vec4, fo, fl, st)
              : fwd_tiled<true>(fq, fk, fv, sh, scale, causal, vec4, fo, fl, st);
  }
  return static_cast<int>(err);
}

// Backward on `stream`; returns cudaGetLastError() (0 = ok). Device pointers
// q, k, v, o, dout, dq, dk, dv (b, s, h, hd) and lse (b, h, s), float32 and
// contiguous. delta = rowsum(dout * o) is formed inside, once a row: the
// staged route keeps it in shared memory; the tiled route writes it into
// `delta` (b, h, s) float32 scratch, which it needs (S > 64) and the staged
// route ignores (may be null). dq, dk and dv are written whole.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   long long b, int s, int h, int hd,
                                   float scale, int causal, void* dq, void* dk,
                                   void* dv, void* delta, void* stream) {
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
    if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const void* ptrs[] = {q, k, v, dout};
    err = bwd_tiled(fq, fk, fv, fo, fg, fl, sh, scale, causal,
                    vec4_rows(hd, ptrs, 4), x, y, z, static_cast<float*>(delta),
                    st);
  }
  return static_cast<int>(err);
}
