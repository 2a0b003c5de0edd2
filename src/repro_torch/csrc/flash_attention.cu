// Flash-attention forward for Hopper (sm_90a), bound to Python through
// ctypes by repro_torch/kernels/flash_attention.py, which checks every
// tensor (device, dtype, shape, strides, alignment) before it passes a
// pointer here.
//
// flash_fwd_wgmma replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_kernel: online-softmax attention
// with f32 running (max, sum, acc), causal and sliding-window masks, kv
// tiles outside the causal band and the window skipped, output in bf16.
//
// What bounds it: at gemma3-12b's prefill (4 x 2048 tokens, 16 query heads
// over 8 kv heads, head_dim 240) a global layer needs ~1.3e11 tensor-core
// FLOP (two products of 2*d per unmasked (q, k) pair) against 189 MB of
// q/k/v/o: ~0.13 ms at the H100's 989 TFLOP/s bf16 dense peak against
// ~0.06 ms for the bytes, so it is compute-bound, and only wgmma reaches
// the tensor cores' full rate. P V is issued twice (P as a bf16 high part
// plus a bf16 remainder, see Precision), so the kernel can reach at most
// ~2/3 of that bound.
//
// Design. One block per (batch * q-head, 128-row q tile), largest q tiles
// first across all heads; three warpgroups:
//   * a producer warpgroup (24 registers after setmaxnreg) whose first
//     thread issues TMA loads: the block's Q once, then K and V tiles of 64
//     keys into 2-stage rings, each stage guarded by a "full" and an
//     "empty" mbarrier, K and V apart: a K stage is released as soon as
//     its scores have landed, so the next K load starts a tile early;
//   * two consumer warpgroups (240 registers), each owning 64 q rows:
//     S = Q K^T by wgmma m64n64k16 with Q and K read from shared memory,
//     masks by position, online softmax in f32 (exp2 of log2-scaled
//     scores), then O += P V by wgmma with P from registers as the A
//     operand and V read MN-major through the instruction's transpose bit,
//     so V is never transposed by hand. A warpgroup only waits for and
//     releases the tiles its own rows do not reach. Each warpgroup waits
//     for each product before the next step, and the two overlap each
//     other; issuing the next tile's S before this tile's P V inside one
//     warpgroup (FlashAttention-3's order) measured slower here.
// q, k and v stay in the model layout [B, T, H, d]; TMA reads them through
// 4-D tensor maps (d, head, position, batch) with the strides given, in
// boxes of 64 columns x 64 rows with the 128-byte swizzle that wgmma's
// descriptors name. head_dim is cut into 64-column chunks (240 -> 4, the
// last one zero-filled by TMA past d), rows past T or S are zero-filled as
// well, and query head h reads kv head h / (Hq / Hkv). The tensor maps are
// encoded on the host through cudaGetDriverEntryPoint, so the build links
// nothing beyond the CUDA runtime.
//
// Precision. The Pallas kernel multiplies P and V in f32. Rounding P to one
// bf16 for the tensor cores would add ~2^-9 relative error per term, as
// much as the bf16 rounding of the output itself; so P is split into a bf16
// high part and a bf16 remainder and both are multiplied, which keeps ~16
// bits of P. Masked scores are -inf and their p is exactly 0; a row with no
// valid key yet keeps m = -inf and uses 0 as its reference, so exp never
// sees (-inf) - (-inf). A row with no valid key at all writes 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64;                     // q rows per consumer
constexpr int kBlockQ = kRows * kConsumers;   // q rows per block
constexpr int kBlockK = 64;                   // keys per kv tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kAtom = 64;                     // bf16 per 128-byte row
constexpr int kTileBytes = 64 * kAtom * 2;    // one [64][64] bf16 box
constexpr int kMaxD = 256;                    // largest head_dim taken
constexpr unsigned kFull = 0xffffffffu;

struct Strides {            // in elements: batch, sequence, head
  long long b, t, h;
};

// NC 64-column chunks of head_dim; every tile 1024-byte aligned, as the
// 128-byte swizzle needs.
template <int NC>
struct Smem {
  bf16 q[kConsumers][NC][kRows * kAtom];
  bf16 k[kStages][NC][kBlockK * kAtom];
  bf16 v[kStages][NC][kBlockK * kAtom];
  uint64_t q_full, k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One 64 x 64 box of a [d, head, position, batch] tensor map into shared
// memory; completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(head), "r"(row), "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of an accumulator
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 remainder of (lo, hi) after their bf16 pair `packed`.
__device__ __forceinline__ uint32_t pack_rem(float lo, float hi,
                                             uint32_t packed) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

// D (+)= A B for m64n64k16, A and B from shared memory (K-major, 128-byte
// swizzle); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B for m64n64k16, A (4 registers of bf16 pairs) from registers, B
// from shared memory MN-major (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}



// S = Q K^T for one warpgroup's 64 rows and one 64-key tile, over the
// 16-column steps of head_dim (issued, not waited for).
template <int NC>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const bf16* q,
                                         const bf16* k, int n_kk) {
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    if (kk < n_kk) {
      const int off = (kk / 4) * 64 * kAtom + (kk % 4) * 16;
      wgmma_ss(sc, sw128_desc(q + off, 16, 1024),
               sw128_desc(k + off, 16, 1024), kk > 0);
    }
  }
}

// O += P V with P as bf16 high parts and remainders (16 keys each) and V
// MN-major: 16 keys of a 64-column chunk start 16 rows further.
template <int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC][32],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         const bf16* v) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sw128_desc(v + c * kBlockK * kAtom + kk * 16 * kAtom,
                                     kTileBytes, 1024);
      wgmma_rs(acc[c], hi[kk], db);
      wgmma_rs(acc[c], lo[kk], db);
    }
  }
}

// The running softmax state of a thread's two rows.
struct RowState {
  float m0, m1;     // running maxima, in log2 units
  float l0, l1;     // this thread's share of the running sums
};

// Scores of one tile to probabilities, in place: scale to log2 units, mask
// by position where the tile crosses an edge, new row maxima, exp2, sums.
// Returns the factors by which the accumulator must be rescaled.
__device__ __forceinline__ float2 online_softmax(
    float (&sc)[32], RowState& st, int k0, int row_first, int row0,
    int row1, int col2, int seq_kv, int causal, int window,
    float scale_log2) {
  const bool edge = k0 + kBlockK > seq_kv
      || (causal && k0 + kBlockK - 1 > row_first)
      || (window > 0 && row_first + kRows - 1 - k0 >= window);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * j + e] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * j + col2 + (e & 1);
        const int qpos = e < 2 ? row0 : row1;
        bool ok = kpos < seq_kv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        v = ok ? v : -INFINITY;
      }
      sc[4 * j + e] = v;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  // a row with no valid key so far keeps -inf; 0 stands in as its
  // reference so that every p and the correction are exactly 0
  const float ref0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ref1 = mn1 == -INFINITY ? 0.f : mn1;
  const float2 corr = make_float2(exp2f(st.m0 - ref0), exp2f(st.m1 - ref1));
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = exp2f(sc[4 * j] - ref0);
    sc[4 * j + 1] = exp2f(sc[4 * j + 1] - ref0);
    sc[4 * j + 2] = exp2f(sc[4 * j + 2] - ref1);
    sc[4 * j + 3] = exp2f(sc[4 * j + 3] - ref1);
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * corr.x + sum0;
  st.l1 = st.l1 * corr.y + sum1;
  return corr;
}

// P (the S accumulator's layout is the A operand's) as bf16 high parts and
// bf16 remainders, 16 keys per step.
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(a, b);
      lo[kk][r] = pack_rem(a, b, hi[kk][r]);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                bf16* __restrict__ o, Strides so, int seq_q, int seq_kv,
                int n_heads, int group, int d, float scale_log2, int causal,
                int window) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads, h_kv = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // longest first

  // kv tiles the block's rows reach: the causal band ends at its last real
  // row, the window starts window-1 before its first row
  const int q_last = min(q0 + kBlockQ, seq_q) - 1;
  const int k_end = causal ? min(seq_kv, q_last + 1) : seq_kv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBlockK;
  const int n_tiles = max(0, (k_end + kBlockK - 1) / kBlockK - kt_begin);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers * 128);
      mbar_init(&sm.v_empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.q_full, kConsumers * NC * kTileBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(sm.q[w][c], &tq, &sm.q_full, c * kAtom, h, q0 + w * kRows,
                   b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_begin + i) * kBlockK;
        mbar_wait(&sm.k_empty[s], free_parity);
        mbar_expect_tx(&sm.k_full[s], NC * kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(sm.k[s][c], &tk, &sm.k_full[s], c * kAtom, h_kv, k0, b);
        mbar_wait(&sm.v_empty[s], free_parity);
        mbar_expect_tx(&sm.v_full[s], NC * kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(sm.v[s][c], &tv, &sm.v_full[s], c * kAtom, h_kv, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row_first = q0 + wg * kRows;
    const int row0 = row_first + warp * 16 + lane / 4, row1 = row0 + 8;
    const int col2 = 2 * (lane % 4);
    const int n_kk = d / 16;

    // this warpgroup's own tiles [i_lo, i_hi) of the block's n_tiles; the
    // rest (past the causal band or before the window of its rows) it only
    // waits for and releases
    int i_lo = 0, i_hi = 0;
    if (row_first < seq_q) {
      const int k_end_wg = causal ? min(seq_kv, row_first + kRows) : seq_kv;
      i_hi = min(n_tiles, (k_end_wg + kBlockK - 1) / kBlockK - kt_begin);
      if (window > 0)
        i_lo = min(n_tiles,
                   max(0, row_first - window + 1) / kBlockK - kt_begin);
      i_hi = max(i_hi, i_lo);
    }

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    RowState st{-INFINITY, -INFINITY, 0.f, 0.f};
    const bf16* q_s = sm.q[wg][0];

    mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      mbar_wait(&sm.k_full[s], phase);
      if (i < i_lo || i >= i_hi) {          // no row of ours reaches it
        mbar_arrive(&sm.k_empty[s]);
        mbar_wait(&sm.v_full[s], phase);    // the stage is free only after
        mbar_arrive(&sm.v_empty[s]);        // its loads have landed
        continue;
      }
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      issue_qk<NC>(sc, q_s, sm.k[s][0], n_kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(&sm.k_empty[s]);          // the next K load may start
      const float2 corr = online_softmax(
          sc, st, (kt_begin + i) * kBlockK, row_first, row0, row1, col2,
          seq_kv, causal, window, scale_log2);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[c][4 * j] *= corr.x;
          acc[c][4 * j + 1] *= corr.x;
          acc[c][4 * j + 2] *= corr.y;
          acc[c][4 * j + 3] *= corr.y;
        }
      }
      uint32_t hi[4][4], lo[4][4];
      split_p(sc, hi, lo);
      mbar_wait(&sm.v_full[s], phase);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
      issue_pv<NC>(acc, hi, lo, sm.v[s][0]);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      mbar_arrive(&sm.v_empty[s]);
    }
    float l0 = st.l0, l1 = st.l1;

    // finish: full row sums across the four lanes of a row, then O / l
    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* o0 = o + b * so.b + (long long)row0 * so.t + h * so.h + col2;
    bf16* o1 = o + b * so.b + (long long)row1 * so.t + h * so.h + col2;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kAtom + 8 * j;
        if (col < d) {
          if (row0 < seq_q)
            *reinterpret_cast<uint32_t*>(o0 + col) =
                pack_bf16(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
          if (row1 < seq_q)
            *reinterpret_cast<uint32_t*>(o1 + col) =
                pack_bf16(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once by cudaGetDriverEntryPoint.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [d, heads, seq, batch] map of bf16 with element strides (head, seq,
// batch), read in 64 x 64 boxes with the 128-byte swizzle; reads past d or
// seq fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, long long sh, long long st, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kAtom, 1, kBlockK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, Strides so, int batch, int seq_q,
           int seq_kv, int n_heads, int group, int d, float scale_log2,
           int causal, int window, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<NC>) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * n_heads, (seq_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma<NC><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), so, seq_q, seq_kv, n_heads, group,
      d, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes for head_dim d.
int flash_attention_smem_bytes(int d) {
  switch ((d + kAtom - 1) / kAtom) {
    case 1: return (int)sizeof(Smem<1>) + 1024;
    case 2: return (int)sizeof(Smem<2>) + 1024;
    case 3: return (int)sizeof(Smem<3>) + 1024;
    default: return (int)sizeof(Smem<4>) + 1024;
  }
}

int flash_attention_max_head_dim() { return kMaxD; }

// q [B, T, Hq, d], k/v [B, S, Hkv, d], o [B, T, Hq, d], all bf16; strides
// in elements as (batch, sequence, head), the last dimension contiguous,
// every other stride a multiple of 8 and the pointers 16-byte aligned (as
// TMA needs). window <= 0 means no window. Returns a cudaError_t, or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int batch, int seq_q, int seq_kv, int n_heads,
                        int n_kv_heads, int d, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, long long o_sb, long long o_st,
                        long long o_sh, float scale, int causal, int window,
                        void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, n_heads, seq_q, batch, q_sh, q_st, q_sb)
      || !make_map(&tk, k, d, n_kv_heads, seq_kv, batch, k_sh, k_st, k_sb)
      || !make_map(&tv, v, d, n_kv_heads, seq_kv, batch, v_sh, v_st, v_sb))
    return (int)cudaErrorInvalidValue;
  const Strides so{o_sb, o_st, o_sh};
  const float scale_log2 = scale * 1.4426950408889634f;
  const int group = n_heads / n_kv_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + kAtom - 1) / kAtom) {
    case 1: return launch<1>(tq, tk, tv, o, so, batch, seq_q, seq_kv, n_heads,
                             group, d, scale_log2, causal, window, st);
    case 2: return launch<2>(tq, tk, tv, o, so, batch, seq_q, seq_kv, n_heads,
                             group, d, scale_log2, causal, window, st);
    case 3: return launch<3>(tq, tk, tv, o, so, batch, seq_q, seq_kv, n_heads,
                             group, d, scale_log2, causal, window, st);
    default: return launch<4>(tq, tk, tv, o, so, batch, seq_q, seq_kv,
                              n_heads, group, d, scale_log2, causal, window,
                              st);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
