// Mamba-2 SSD chunk scan for Hopper (sm_90a), bound to Python through
// ctypes by repro_torch/kernels/ssd_scan.py, which checks every tensor
// (device, dtype, shape, strides, alignment) before it passes a pointer
// here.
//
// The four ssd_scan_* kernels below replace the Pallas kernel
// src/repro/kernels/ssd_scan.py::_kernel. Per chunk c of Q steps
//   cs  = cumsum(dt * A)                              (inclusive: L[i,i] = 1)
//   y   = ((C B^T) . L . dt_j) X + e^{cs_i} (C h_{c-1}^T)
//   h_c = e^{cs_Q} h_{c-1} + X^T (e^{cs_Q - cs} . dt . B)   (h_{-1} = 0)
// with L[i,j] = e^{cs_i - cs_j} for j <= i and 0 above the diagonal; y is
// written in bf16 (x's dtype) and the final h in f32.
//
// What bounds it: at mamba2-370m's training shapes (8 x 2048 tokens, 32
// heads of 64, d_state 128, chunk 256) a call needs ~4.3e10 FLOP with the
// upper triangle of C B^T skipped, for ~150 MB of x, B, C, dt, y and the
// final h: ~0.045 ms for the bytes at 3.35 TB/s against ~0.043 ms at the
// bf16 tensor-core peak, so only a kernel on the tensor cores that keeps
// all 132 SMs busy comes near. The Pallas kernel's order (one grid step
// per chunk, h carried in VMEM) would give one block per (batch, head),
// 256 blocks in two uneven waves; instead the work is split the way
// Mamba-2's own chunked algorithm splits it, parallel over chunks:
//   1. ssd_scan_cb, per (batch, chunk, 64 x 64 tile at or below the
//      diagonal): C B^T once for all heads (B and C have one group), f32.
//   2. ssd_scan_chunk_state, per (head, chunk, batch): cs, stored for
//      pass 4, and the chunk's own state X^T (e^{cs_Q - cs} dt B).
//   3. ssd_scan_state_pass, per (batch, head, 4 state cells): the
//      recurrence over the chunks, elementwise, in place: each chunk's
//      slot ends holding the state before the chunk; emits h_final.
//   4. ssd_scan_chunk_out, per (head, chunk, batch): y from M = C B^T . L
//      . dt_j against X, plus e^{cs_i} C h_{c-1}^T.
// The chunk states (B x chunks x heads x 64 x 128 f32, 67 MB at the shapes
// above) are written once by pass 2, read and rewritten by pass 3 and read
// by pass 4; C B^T (17 MB) stays in L2 for the heads that read it.
//
// Products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). x, B and C are bf16 already and go in as they are. Where an
// operand is a computed f32 value (M, the decay-weighted X of the state
// update, the state h) it is split into a bf16 high part plus a bf16
// remainder and both are multiplied, which keeps ~16 bits; per-row factors
// (e^{cs_i}) are applied in f32 after the product. cs and every exp are
// f32, and L is masked before use. The model layout [B, S, nh, hd] of x
// and y and [B, S, 1, N] of B and C is read with strides and staged by
// cp.async into shared-memory rows padded by 16 bytes, so that fragment
// reads (ldmatrix, or 32-bit loads) fall into distinct banks.
//
// The backward (ssd_bwd_*, a prefix that holds no "ssd_scan_", so that
// whatever sums the forward's device time by name never counts it)
// replaces no Pallas kernel: the reference's _ssd_bwd recomputes through
// the sequential oracle under autograd. It computes dx, ddt, dA, dB and dC
// in closed form (Mamba-2's chunked algebra, arXiv:2405.21060 sections
// 6-7) from the forward's own scratch, which the caller keeps: C B^T per
// chunk, cs per head and H, the state entering each chunk. Per chunk, with
// M = C B^T . L . dt_j, w_j = e^{cs_Q - cs_j} dt_j and D the gradient of
// the state leaving the chunk:
//   G_c     = dY^T diag(e^{cs}) C           (the state entering, via y)
//   D_{c-1} = G_c + e^{cs_Q} D_c            (D_last = dh_final)
//   dX      = M^T dY + diag(w) B D^T
//   dCB     = sum_h (dY_h X_h^T) . L_h . dt_h          (heads share B, C)
//   dC      = dCB B + sum_h diag(e^{cs_h}) dY_h H_h
//   dB      = dCB^T C + sum_h diag(w_h) X_h D_h
//   dcs     = the row and column sums of (dY X^T) . M, e^{cs} dY . (H C),
//             the state side -w u with u_j = x_j . D B_j, and on the last
//             step e^{cs_Q} <D, H> + sum_j w_j u_j
//   d(dt A) = the within-chunk suffix sum of dcs; ddt += A d(dt A),
//   dA = sum dt d(dt A).
// What bounds it: at mamba2-370m's training shapes a call needs ~5.3e10
// FLOP counted once (the causal triangles halved) for ~0.31 GB of inputs,
// the forward's scratch and the gradients: ~0.09 ms for the bytes against
// ~0.05 ms at the bf16 peak, so again only tensor cores over all SMs come
// near, and every Q x Q intermediate has to stay on chip: one [Q, Q] f32
// array per head (the plain recompute's L and M) is 537 MB at those shapes.
// Seven passes, each parallel over chunks:
//   B1. ssd_bwd_state_grad, per (head, chunk, batch): G, as pass 2 computes
//       a chunk's state (dY e^{cs} split in two bf16).
//   B2. ssd_bwd_state_pass, per (batch, head, 4 state cells): the reverse
//       recurrence in place; each slot ends holding D_c.
//   B3. ssd_bwd_chunk_dx, per (head, chunk, batch): dX, ddt's terms and the
//       head's dcs. M^T is rebuilt in registers from pass 1's C B^T and cs
//       beside dY X^T, whose accumulator is laid out as the A fragment of
//       the next product, so nothing Q x Q leaves the registers.
//   B4. ssd_bwd_dcb, per (64 x 64 tile at or below the diagonal, chunk,
//       batch): dCB, the sum over heads kept in registers (no per-head
//       partials in memory, no atomics), dY and X of the next head staged
//       by cp.async while this one multiplies.
//   B5. ssd_bwd_dbc, per (64-row tile, chunk, batch): dC, then dB, the sum
//       over heads in registers, H and D split once a head in shared
//       memory; it adds the dcs term of e^{cs} dY . (H C) per head.
//   B6. ssd_bwd_dcs, per (head, chunk, batch): the suffix sum, ddt, and the
//       chunk's share of dA; B7. ssd_bwd_da sums the shares per head in a
//       fixed order. Every sum here and in B3 runs in a fixed order.
// The tiles follow the shapes: a warp takes 16 rows and as many 8-column
// blocks of d_state as there are (N = 16: one, and half the warps of B5
// idle), the chunk's 16-row tiles go to the warps in pairs. Numerics as the
// forward's: bf16 products with f32 sums, each computed operand (e^{cs} dY,
// M, D, H, dCB) split into a bf16 high part plus remainder, every exp,
// cumsum and reduction in f32, L masked before the exp. dx, dB and dC are
// written in bf16, ddt and dA in f32; the backward's own scratch (D, dCB,
// dcs, the shares of dA: ~86 MB at the shapes above) is the caller's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
// The wrapper (kernels/ssd_scan.py) checks shapes against copies of these
// three limits: MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE.
constexpr int kMaxQ = 256;             // largest chunk taken
constexpr int kMaxHD = 64;             // largest head_dim taken
constexpr int kMaxN = 128;             // largest d_state taken
constexpr int kPad = 8;                // bf16 padding per shared row
constexpr int kSlab = 64;              // keys per slab of the state pass
constexpr unsigned kFull = 0xffffffffu;

struct Strides3 { long long b, s, h; };
struct Strides2 { long long b, s; };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (lo, hi) as a bf16 pair `high` and the bf16 pair of what it leaves.
__device__ __forceinline__ void split_bf16(float lo, float hi,
                                           uint32_t& high, uint32_t& rem) {
  high = pack_bf16(lo, hi);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&high);
  rem = pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B for one m16n8k16 tile: bf16 A (row) and B (col), f32 D.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 and receives one register of
// each, laid out as an mma.sync fragment of the transposed matrices.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Start copying `rows` rows of `cols` bf16 (cols % 8 == 0) from global
// memory with row stride `ld_src` into shared memory with row stride
// `ld_dst`, 16 bytes a cp.async, all in flight at once; copy_wait() ends
// them for this thread (a barrier then makes them visible to the block).
__device__ __forceinline__ void copy_rows(bf16* dst, int ld_dst,
                                          const bf16* src, long long ld_src,
                                          int rows, int cols) {
  const int c8 = cols / 8;
  for (int e = threadIdx.x; e < rows * c8; e += blockDim.x) {
    const int r = e / c8, k = e - r * c8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(static_cast<uint32_t>(
                        __cvta_generic_to_shared(dst + r * ld_dst + 8 * k))),
                    "l"(src + r * ld_src + 8 * k)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Pass 1: cb[b, c, i, j] = sum_n C[i, n] B[j, n] on one 64 x 64 tile
// (ti >= tj) of chunk c; 4 warps of 16 rows.
__global__ void __launch_bounds__(128)
ssd_scan_cb(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
            float* __restrict__ cb, int n_chunks, int q, int n, Strides2 sb,
            Strides2 sc) {
  __shared__ __align__(16) bf16 c_s[64 * (kMaxN + kPad)];
  __shared__ __align__(16) bf16 b_s[64 * (kMaxN + kPad)];
  const int chunk = blockIdx.y, batch = blockIdx.z;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int ld = n + kPad;
  const long long t0 = (long long)chunk * q;
  copy_rows(c_s, ld, cm + batch * sc.b + (t0 + 64 * ti) * sc.s, sc.s, 64, n);
  copy_rows(b_s, ld, bm + batch * sb.b + (t0 + 64 * tj) * sb.s, sb.s, 64, n);
  copy_wait();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float acc[8][4] = {};
  const bf16* ca = c_s + (16 * warp + g) * ld + t2;
#pragma unroll
  for (int kk = 0; kk < kMaxN / 16; ++kk) {
    if (kk < n / 16) {
      const uint32_t a0 = ld_pair(ca + 16 * kk);
      const uint32_t a1 = ld_pair(ca + 8 * ld + 16 * kk);
      const uint32_t a2 = ld_pair(ca + 16 * kk + 8);
      const uint32_t a3 = ld_pair(ca + 8 * ld + 16 * kk + 8);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const bf16* bp = b_s + (8 * nb + g) * ld + 16 * kk + t2;
        mma_bf16(acc[nb], a0, a1, a2, a3, ld_pair(bp), ld_pair(bp + 8));
      }
    }
  }
  float* out = cb + (((long long)batch * n_chunks + chunk) * q + 64 * ti
                     + 16 * warp + g) * q + 64 * tj + t2;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    *reinterpret_cast<float2*>(out + 8 * nb) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(out + 8 * q + 8 * nb) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

// Pass 2, per (head, chunk, batch): cs = inclusive cumsum(dt * A), stored
// for pass 4, and the chunk's own state
// states[b, c, h] = sum_j (e^{cs_Q - cs_j} dt_j x_j) (x) B_j  [hd, N],
// with the decay-weighted x split into bf16 high part and remainder.
// Keys go in slabs of 64, x w and B kept in their own layout (keys as
// rows) in shared memory and read as transposed fragments by ldmatrix;
// warp w owns state rows 16 (w % 4).. and half the columns.
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ bm,
                     float* __restrict__ cs_out, float* __restrict__ states,
                     int seq, int n_heads, int hd, int n, int q, Strides3 sx,
                     Strides3 sd, Strides2 sb) {
  constexpr int ldx = kMaxHD + kPad, ldb = kMaxN + kPad;
  __shared__ float dts[kMaxQ], css[kMaxQ], ws[kMaxQ];
  __shared__ __align__(16) bf16 xw_hi[kSlab * ldx];
  __shared__ __align__(16) bf16 xw_lo[kSlab * ldx];
  __shared__ __align__(16) bf16 b_s[kSlab * ldb];
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = (long long)chunk * q;
  const float a_h = a[head];
  for (int j = tid; j < q; j += kThreads)
    dts[j] = dt[batch * sd.b + (t0 + j) * sd.s + head * sd.h];
  __syncthreads();

  // cs: warp 0, q / 32 steps a lane, then a shuffle scan of the lane sums
  if (warp == 0) {
    const int per = q / 32;
    float loc[kMaxQ / 32];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k)
      if (k < per) { run += dts[lane * per + k] * a_h; loc[k] = run; }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const float prev = __shfl_up_sync(kFull, incl, 1);
    const float excl = lane == 0 ? 0.f : prev;
    float* cs_row = cs_out + ((long long)batch * n_heads + head) * seq + t0;
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k)
      if (k < per) {
        css[lane * per + k] = excl + loc[k];
        cs_row[lane * per + k] = excl + loc[k];
      }
  }
  __syncthreads();
  const float cs_last = css[q - 1];
  for (int j = tid; j < q; j += kThreads)
    ws[j] = expf(cs_last - css[j]) * dts[j];

  const int mt = warp % 4, nb0 = 8 * (warp / 4);
  const int mat = lane / 8, mrow = lane % 8;
  float acc[8][4] = {};
  for (int j0 = 0; j0 < q; j0 += kSlab) {
    __syncthreads();               // ws written; the last slab consumed
    const int x8 = hd / 8;
    for (int e = tid; e < kSlab * x8; e += kThreads) {
      const int r = e / x8, k = e - r * x8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + batch * sx.b + (t0 + j0 + r) * sx.s + head * sx.h + 8 * k);
      const uint32_t* vv = reinterpret_cast<const uint32_t*>(&v);
      const float w = ws[j0 + r];
      uint4 hi, lo;
      uint32_t* hh = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* ll = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&vv[i]));
        split_bf16(f.x * w, f.y * w, hh[i], ll[i]);
      }
      *reinterpret_cast<uint4*>(xw_hi + r * ldx + 8 * k) = hi;
      *reinterpret_cast<uint4*>(xw_lo + r * ldx + 8 * k) = lo;
    }
    copy_rows(b_s, ldb, bm + batch * sb.b + (t0 + j0) * sb.s, sb.s, kSlab,
              n);
    copy_wait();
    __syncthreads();
    if (16 * mt < hd) {
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        // A = (x w)^T: matrices (keys 0-7 | 8-15) x (rows 0-7 | 8-15)
        const int a_off = (16 * kk + 8 * (mat >> 1) + mrow) * ldx
                          + 16 * mt + 8 * (mat & 1);
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, xw_hi + a_off);
        ldsm_x4_t(al, xw_lo + a_off);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          if (8 * (nb0 + i) < n) {
            // B: matrices (keys 0-7 | 8-15) of column blocks i, i + 1
            uint32_t bb[4];
            ldsm_x4_t(bb, b_s + (16 * kk + 8 * (mat & 1) + mrow) * ldb
                              + 8 * (nb0 + i + (mat >> 1)));
            mma_bf16(acc[i], ah[0], ah[1], ah[2], ah[3], bb[0], bb[1]);
            mma_bf16(acc[i], al[0], al[1], al[2], al[3], bb[0], bb[1]);
            mma_bf16(acc[i + 1], ah[0], ah[1], ah[2], ah[3], bb[2], bb[3]);
            mma_bf16(acc[i + 1], al[0], al[1], al[2], al[3], bb[2], bb[3]);
          }
        }
      }
    }
  }
  if (16 * mt < hd) {
    const int g = lane / 4, t2 = 2 * (lane % 4);
    float* st = states + (((long long)batch * n_chunks + chunk) * n_heads
                          + head) * hd * n + (16 * mt + g) * n + t2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (8 * (nb0 + i) < n) {
        *reinterpret_cast<float2*>(st + 8 * (nb0 + i)) =
            make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(st + 8 * n + 8 * (nb0 + i)) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  }
}

// Pass 3, per (4 state cells, head, batch): h_c = e^{cs_Q} h_{c-1} + dS_c
// over the chunks in order; each chunk's slot is overwritten with the
// state before the chunk, and the last state goes to h_out. The slots of
// up to 8 chunks are loaded before any is written, so the loads overlap.
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_pass(float* __restrict__ states, const float* __restrict__ cs,
                    float* __restrict__ h_out, int seq, int n_chunks,
                    int n_heads, int cells, int q) {
  constexpr int kBatch = 8;
  const int e4 = blockIdx.x * kThreads + threadIdx.x;
  if (4 * e4 >= cells) return;
  const int head = blockIdx.y, batch = blockIdx.z;
  const float* cs_row = cs + ((long long)batch * n_heads + head) * seq;
  const long long step = (long long)n_heads * cells / 4;   // float4s a chunk
  float4* slot = reinterpret_cast<float4*>(
      states + ((long long)batch * n_chunks * n_heads + head) * cells) + e4;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float4 ds[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < n_chunks) {
        ds[k] = slot[(c0 + k) * step];
        decay[k] = expf(cs_row[(long long)(c0 + k) * q + q - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < n_chunks) {
        slot[(c0 + k) * step] = h;
        h = make_float4(fmaf(h.x, decay[k], ds[k].x),
                        fmaf(h.y, decay[k], ds[k].y),
                        fmaf(h.z, decay[k], ds[k].z),
                        fmaf(h.w, decay[k], ds[k].w));
      }
    }
  }
  reinterpret_cast<float4*>(
      h_out + ((long long)batch * n_heads + head) * cells)[e4] = h;
}

struct OutLayout {        // byte offsets into pass 4's dynamic shared memory
  int ldh, ldx;           // bf16 per h row, per X row
  size_t xs, h_hi, h_lo, cs, dt, kf, total;
};

__host__ __device__ inline OutLayout out_layout(int q, int hd, int n) {
  OutLayout s;
  s.ldh = n + kPad;
  s.ldx = hd + kPad;
  s.xs = 0;
  s.h_hi = s.xs + sizeof(bf16) * q * s.ldx;
  s.h_lo = s.h_hi + sizeof(bf16) * hd * s.ldh;
  s.cs = s.h_lo + sizeof(bf16) * hd * s.ldh;
  s.dt = s.cs + sizeof(float) * q;
  s.kf = s.dt + sizeof(float) * q;
  s.total = s.kf + sizeof(float) * q;
  return s;
}

// Pass 4, per (head, chunk, batch): y = e^{cs_i} (C h_{c-1}^T) + M X with
// M = C B^T . L . dt_j built in registers from pass 1's C B^T, and h and M
// split into bf16 high part and remainder. Warp w takes 16-row query
// tiles w and Q/16 - 1 - w (and so on), so every warp does the same work.
// C and C B^T are read from global memory (L2: every head of the chunk
// reads them), so two blocks fit on an SM. Below the diagonal 16 x 16
// block, L[i,j] = e^{cs_i - cs_top} e^{cs_top - cs_end} e^{cs_end - cs_j}
// with cs_top the first row of the query tile and cs_end the last key of
// the key step: every factor is at most 1, the first is one exp per row,
// the second one per step, the third is kept per key (with dt_j) in
// shared memory; on the diagonal block L is taken directly and masked.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ cm, const float* __restrict__ cb,
                   const float* __restrict__ cs,
                   const float* __restrict__ states,
                   bf16* __restrict__ y, int seq, int n_heads, int hd, int n,
                   int q, Strides3 sx, Strides3 sd, Strides2 sc,
                   Strides3 sy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const OutLayout L = out_layout(q, hd, n);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* h_hi = reinterpret_cast<bf16*>(smem + L.h_hi);
  bf16* h_lo = reinterpret_cast<bf16*>(smem + L.h_lo);
  float* css = reinterpret_cast<float*>(smem + L.cs);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  float* kf = reinterpret_cast<float*>(smem + L.kf);
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = (long long)chunk * q;

  copy_rows(xs, L.ldx, x + batch * sx.b + t0 * sx.s + head * sx.h, sx.s, q,
            hd);
  const float4* hp = reinterpret_cast<const float4*>(
      states + (((long long)batch * n_chunks + chunk) * n_heads + head)
      * hd * n);
#pragma unroll 4
  for (int e = tid; e < hd * n / 4; e += kThreads) {
    const float4 v = hp[e];
    const int p = 4 * e / n, k = 4 * e - p * n;
    uint32_t* dh = reinterpret_cast<uint32_t*>(h_hi + p * L.ldh + k);
    uint32_t* dl = reinterpret_cast<uint32_t*>(h_lo + p * L.ldh + k);
    split_bf16(v.x, v.y, dh[0], dl[0]);
    split_bf16(v.z, v.w, dh[1], dl[1]);
  }
  const float* cs_row = cs + ((long long)batch * n_heads + head) * seq + t0;
  for (int j = tid; j < q; j += kThreads) {
    const float c = cs_row[j];
    const float d = dt[batch * sd.b + (t0 + j) * sd.s + head * sd.h];
    css[j] = c;
    dts[j] = d;
    kf[j] = expf(cs_row[j | 15] - c) * d;
  }
  copy_wait();
  __syncthreads();

  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int mat = lane / 8, mrow = lane % 8;
  const int n_mt = q / 16;
  const float* cb_chunk = cb + ((long long)batch * n_chunks + chunk) * q * q;
  const bf16* c_chunk = cm + batch * sc.b + t0 * sc.s;
  for (int pi = warp; pi < n_mt / 2; pi += kThreads / 32) {
    for (int side = 0; side < 2; ++side) {
      const int mt = side == 0 ? pi : n_mt - 1 - pi;
      const int r0 = 16 * mt + g, r1 = r0 + 8;
      float acc[kMaxHD / 8][4] = {};

      // C h^T with h = h_hi + h_lo, then the per-row decay e^{cs_i}; the
      // next step's C is loaded while this one multiplies
      const bf16* ca = c_chunk + r0 * sc.s + t2;
      uint32_t an[4] = {ld_pair(ca), ld_pair(ca + 8 * sc.s), ld_pair(ca + 8),
                        ld_pair(ca + 8 * sc.s + 8)};
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (kk < n / 16) {
          const uint32_t a0 = an[0], a1 = an[1], a2 = an[2], a3 = an[3];
          if (kk + 1 < n / 16) {
            const bf16* cn = ca + 16 * (kk + 1);
            an[0] = ld_pair(cn);
            an[1] = ld_pair(cn + 8 * sc.s);
            an[2] = ld_pair(cn + 8);
            an[3] = ld_pair(cn + 8 * sc.s + 8);
          }
#pragma unroll
          for (int nb = 0; nb < kMaxHD / 8; ++nb) {
            if (8 * nb < hd) {
              const int off = (8 * nb + g) * L.ldh + 16 * kk + t2;
              mma_bf16(acc[nb], a0, a1, a2, a3, ld_pair(h_hi + off),
                       ld_pair(h_hi + off + 8));
              mma_bf16(acc[nb], a0, a1, a2, a3, ld_pair(h_lo + off),
                       ld_pair(h_lo + off + 8));
            }
          }
        }
      }
      const float cs0 = css[r0], cs1 = css[r1], cs_top = css[16 * mt];
      const float e0 = expf(cs0), e1 = expf(cs1);
#pragma unroll
      for (int nb = 0; nb < kMaxHD / 8; ++nb) {
        acc[nb][0] *= e0;
        acc[nb][1] *= e0;
        acc[nb][2] *= e1;
        acc[nb][3] *= e1;
      }

      // M X over the 16-key steps at or below the diagonal; the next
      // step's C B^T is loaded while this one multiplies
      const float* cb0 = cb_chunk + (long long)r0 * q + t2;
      const float* cb1 = cb0 + 8 * q;
      const float rf0 = expf(cs0 - cs_top), rf1 = expf(cs1 - cs_top);
      float2 nxt[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        nxt[r] = *reinterpret_cast<const float2*>(
            ((r & 1) ? cb1 : cb0) + 8 * (r >> 1));
      for (int kk = 0; kk <= mt; ++kk) {
        float2 cur[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[r] = nxt[r];
        if (kk < mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            nxt[r] = *reinterpret_cast<const float2*>(
                ((r & 1) ? cb1 : cb0) + 16 * (kk + 1) + 8 * (r >> 1));
        }
        uint32_t hi[4], lo[4];
        if (kk < mt) {                      // below the diagonal block
          const float blk = expf(cs_top - css[16 * kk + 15]);
          const float f0 = rf0 * blk, f1 = rf1 * blk;
#pragma unroll
          for (int r = 0; r < 4; ++r) {     // a0..a3: (r0|r1, j|j+8)
            const int j = 16 * kk + t2 + 8 * (r >> 1);
            const float f = (r & 1) ? f1 : f0;
            split_bf16(cur[r].x * f * kf[j], cur[r].y * f * kf[j + 1],
                       hi[r], lo[r]);
          }
        } else {                            // the diagonal block
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = (r & 1) ? r1 : r0;
            const float cs_i = (r & 1) ? cs1 : cs0;
            const int j = 16 * kk + t2 + 8 * (r >> 1);
            const float m_a = j <= i
                ? cur[r].x * expf(cs_i - css[j]) * dts[j] : 0.f;
            const float m_b = j + 1 <= i
                ? cur[r].y * expf(cs_i - css[j + 1]) * dts[j + 1] : 0.f;
            split_bf16(m_a, m_b, hi[r], lo[r]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < kMaxHD / 8; nb += 2) {
          if (8 * nb < hd) {
            // X: matrices (keys 0-7 | 8-15) of column blocks nb, nb + 1
            uint32_t bb[4];
            ldsm_x4_t(bb, xs + (16 * kk + 8 * (mat & 1) + mrow) * L.ldx
                              + 8 * (nb + (mat >> 1)));
            mma_bf16(acc[nb], hi[0], hi[1], hi[2], hi[3], bb[0], bb[1]);
            mma_bf16(acc[nb], lo[0], lo[1], lo[2], lo[3], bb[0], bb[1]);
            mma_bf16(acc[nb + 1], hi[0], hi[1], hi[2], hi[3], bb[2], bb[3]);
            mma_bf16(acc[nb + 1], lo[0], lo[1], lo[2], lo[3], bb[2], bb[3]);
          }
        }
      }

      bf16* y0 = y + batch * sy.b + (t0 + r0) * sy.s + head * sy.h + t2;
      bf16* y1 = y0 + 8 * sy.s;
#pragma unroll
      for (int nb = 0; nb < kMaxHD / 8; ++nb) {
        if (8 * nb < hd) {
          *reinterpret_cast<uint32_t*>(y0 + 8 * nb) =
              pack_bf16(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<uint32_t*>(y1 + 8 * nb) =
              pack_bf16(acc[nb][2], acc[nb][3]);
        }
      }
    }
  }
}

size_t align256(size_t v) { return (v + 255) & ~size_t(255); }

struct Workspace {         // byte offsets into the caller's scratch buffer
  size_t cb, cs, states, total;
};

Workspace workspace(int batch, int seq, int n_heads, int hd, int n, int q) {
  const size_t chunks = (size_t)batch * (seq / q);
  Workspace w;
  w.cb = 0;
  w.cs = align256(w.cb + sizeof(float) * chunks * q * q);
  w.states = align256(w.cs + sizeof(float) * batch * n_heads * seq);
  w.total = w.states + sizeof(float) * chunks * n_heads * hd * n;
  return w;
}

// ---------------------------------------------------------------- backward --
// The seven ssd_bwd_* kernels of one backward call (see the header). They
// read the forward's scratch: C B^T per chunk, cs per head and, in each
// chunk's slot, the state entering the chunk (H below).

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Pass B1, per (head, chunk, batch): the chunk's output gradient with
// respect to the state entering it, G = dY^T diag(e^{cs}) C [hd, N], into
// the chunk's slot of `grads`. The product of pass 2 with dY for x, e^{cs}
// for the weights and C for B: dY e^{cs} split into a bf16 high part and
// remainder, keys in slabs of 64 read as transposed fragments.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_grad(const bf16* __restrict__ gy, const bf16* __restrict__ cm,
                   const float* __restrict__ cs, float* __restrict__ grads,
                   int seq, int n_heads, int hd, int n, int q, Strides3 sg,
                   Strides2 sc) {
  constexpr int ldx = kMaxHD + kPad, ldb = kMaxN + kPad;
  __shared__ float ws[kMaxQ];
  __shared__ __align__(16) bf16 gw_hi[kSlab * ldx];
  __shared__ __align__(16) bf16 gw_lo[kSlab * ldx];
  __shared__ __align__(16) bf16 c_s[kSlab * ldb];
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = (long long)chunk * q;
  const float* cs_row = cs + ((long long)batch * n_heads + head) * seq + t0;
  for (int i = tid; i < q; i += kThreads) ws[i] = expf(cs_row[i]);

  const int mt = warp % 4, nb0 = 8 * (warp / 4);
  const int mat = lane / 8, mrow = lane % 8;
  float acc[8][4] = {};
  for (int i0 = 0; i0 < q; i0 += kSlab) {
    __syncthreads();               // ws written; the last slab consumed
    const int x8 = hd / 8;
    for (int e = tid; e < kSlab * x8; e += kThreads) {
      const int r = e / x8, k = e - r * x8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          gy + batch * sg.b + (t0 + i0 + r) * sg.s + head * sg.h + 8 * k);
      const uint32_t* vv = reinterpret_cast<const uint32_t*>(&v);
      const float w = ws[i0 + r];
      uint4 hi, lo;
      uint32_t* hh = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* ll = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(vv[i]);
        split_bf16(f.x * w, f.y * w, hh[i], ll[i]);
      }
      *reinterpret_cast<uint4*>(gw_hi + r * ldx + 8 * k) = hi;
      *reinterpret_cast<uint4*>(gw_lo + r * ldx + 8 * k) = lo;
    }
    copy_rows(c_s, ldb, cm + batch * sc.b + (t0 + i0) * sc.s, sc.s, kSlab,
              n);
    copy_wait();
    __syncthreads();
    if (16 * mt < hd) {
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        const int a_off = (16 * kk + 8 * (mat >> 1) + mrow) * ldx
                          + 16 * mt + 8 * (mat & 1);
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, gw_hi + a_off);
        ldsm_x4_t(al, gw_lo + a_off);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          if (8 * (nb0 + i) < n) {
            uint32_t bb[4];
            ldsm_x4_t(bb, c_s + (16 * kk + 8 * (mat & 1) + mrow) * ldb
                              + 8 * (nb0 + i + (mat >> 1)));
            mma_bf16(acc[i], ah[0], ah[1], ah[2], ah[3], bb[0], bb[1]);
            mma_bf16(acc[i], al[0], al[1], al[2], al[3], bb[0], bb[1]);
            mma_bf16(acc[i + 1], ah[0], ah[1], ah[2], ah[3], bb[2], bb[3]);
            mma_bf16(acc[i + 1], al[0], al[1], al[2], al[3], bb[2], bb[3]);
          }
        }
      }
    }
  }
  if (16 * mt < hd) {
    const int g = lane / 4, t2 = 2 * (lane % 4);
    float* st = grads + (((long long)batch * n_chunks + chunk) * n_heads
                         + head) * hd * n + (16 * mt + g) * n + t2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (8 * (nb0 + i) < n) {
        *reinterpret_cast<float2*>(st + 8 * (nb0 + i)) =
            make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(st + 8 * n + 8 * (nb0 + i)) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  }
}

// Pass B2, per (4 state cells, head, batch): D_{c-1} = G_c + e^{cs_Q} D_c
// over the chunks in reverse from D = gh (zero if null); each chunk's slot
// ends holding D_c, the gradient of the state leaving the chunk.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(float* __restrict__ grads, const float* __restrict__ cs,
                   const float* __restrict__ gh, int seq, int n_chunks,
                   int n_heads, int cells, int q) {
  constexpr int kBatch = 8;
  const int e4 = blockIdx.x * kThreads + threadIdx.x;
  if (4 * e4 >= cells) return;
  const int head = blockIdx.y, batch = blockIdx.z;
  const float* cs_row = cs + ((long long)batch * n_heads + head) * seq;
  const long long step = (long long)n_heads * cells / 4;   // float4s a chunk
  float4* slot = reinterpret_cast<float4*>(
      grads + ((long long)batch * n_chunks * n_heads + head) * cells) + e4;
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  if (gh != nullptr)
    d = reinterpret_cast<const float4*>(
        gh + ((long long)batch * n_heads + head) * cells)[e4];
  for (int c1 = n_chunks - 1; c1 >= 0; c1 -= kBatch) {
    float4 gc[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c1 - k >= 0) {
        gc[k] = slot[(c1 - k) * step];
        decay[k] = expf(cs_row[(long long)(c1 - k) * q + q - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c1 - k >= 0) {
        slot[(c1 - k) * step] = d;
        d = make_float4(fmaf(d.x, decay[k], gc[k].x),
                        fmaf(d.y, decay[k], gc[k].y),
                        fmaf(d.z, decay[k], gc[k].z),
                        fmaf(d.w, decay[k], gc[k].w));
      }
    }
  }
}

struct DxLayout {         // byte offsets into pass B3's dynamic shared memory
  int ldg, ldd;           // bf16 per dY row, per D row
  size_t gs, d_hi, d_lo, cs, dt, kf, rowd, wu, col, red, total;
};

__host__ __device__ inline DxLayout dx_layout(int q, int hd, int n) {
  DxLayout s;
  s.ldg = hd + kPad;
  s.ldd = n + kPad;
  s.gs = 0;
  s.d_hi = s.gs + sizeof(bf16) * q * s.ldg;
  s.d_lo = s.d_hi + sizeof(bf16) * hd * s.ldd;
  s.cs = s.d_lo + sizeof(bf16) * hd * s.ldd;
  s.dt = s.cs + sizeof(float) * q;
  s.kf = s.dt + sizeof(float) * q;
  s.rowd = s.kf + sizeof(float) * q;
  s.wu = s.rowd + sizeof(float) * q;
  s.col = s.wu + sizeof(float) * q;
  s.red = s.col + sizeof(float) * (kThreads / 32) * q;
  s.total = s.red + sizeof(float) * (kThreads / 32 + 1);
  return s;
}

// Pass B3, per (head, chunk, batch): dX = M^T dY + diag(w) B D^T with
// w_j = e^{cs_Q - cs_j} dt_j, and this head's terms of dcs and ddt. Warp w
// takes 16-row key tiles (rows j) w and Q/16 - 1 - w, as pass 4 takes
// query tiles. Per tile: first the state side V = B D^T (D split in two
// bf16), whose rows dotted with x give u_j = x_j . D B_j; then, over the
// 16-query steps at or right of the diagonal, P^T = X dY^T on the tensor
// cores (its accumulator has the layout of an A fragment), M^T = (C B^T .
// L)^T . dt_j built in registers from pass 1's C B^T beside it, M^T dY
// with M^T split in two bf16, and Z = P^T . M^T summed by row (ddt, dcs of
// the key) and by column (dcs of the query, per warp in shared memory,
// added in a fixed order). Right of the diagonal block L[i,j] =
// e^{cs_i - cs_left} e^{cs_left - cs_end} e^{cs_end - cs_j}, cs_left the
// step's first query and cs_end the tile's last key, each factor at most
// 1. dcs gets the chunk total's term, e^{cs_Q} <D, H> + sum_j w_j u_j, on
// its last step. dX and ddt are written; dcs into the backward's scratch.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_dx(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ bm, const bf16* __restrict__ gy,
                 const float* __restrict__ cb, const float* __restrict__ cs,
                 const float* __restrict__ states,
                 const float* __restrict__ grads, bf16* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dcs, int seq,
                 int n_heads, int hd, int n, int q, Strides3 sx, Strides3 sd,
                 Strides2 sb, Strides3 sg) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const DxLayout L = dx_layout(q, hd, n);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.gs);
  bf16* d_hi = reinterpret_cast<bf16*>(smem + L.d_hi);
  bf16* d_lo = reinterpret_cast<bf16*>(smem + L.d_lo);
  float* css = reinterpret_cast<float*>(smem + L.cs);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  float* kf = reinterpret_cast<float*>(smem + L.kf);
  float* rowd = reinterpret_cast<float*>(smem + L.rowd);
  float* wus = reinterpret_cast<float*>(smem + L.wu);
  float* col = reinterpret_cast<float*>(smem + L.col);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = (long long)chunk * q;

  copy_rows(gs, L.ldg, gy + batch * sg.b + t0 * sg.s + head * sg.h, sg.s, q,
            hd);
  const long long slot =
      (((long long)batch * n_chunks + chunk) * n_heads + head) * hd * n;
  const float4* dp = reinterpret_cast<const float4*>(grads + slot);
  const float4* hp = reinterpret_cast<const float4*>(states + slot);
  float dh = 0.f;
#pragma unroll 4
  for (int e = tid; e < hd * n / 4; e += kThreads) {
    const float4 v = dp[e], h = hp[e];
    dh += v.x * h.x + v.y * h.y + v.z * h.z + v.w * h.w;
    const int p = 4 * e / n, k = 4 * e - p * n;
    uint32_t* dhi = reinterpret_cast<uint32_t*>(d_hi + p * L.ldd + k);
    uint32_t* dlo = reinterpret_cast<uint32_t*>(d_lo + p * L.ldd + k);
    split_bf16(v.x, v.y, dhi[0], dlo[0]);
    split_bf16(v.z, v.w, dhi[1], dlo[1]);
  }
  dh = warp_sum(dh);
  if (lane == 0) red[warp] = dh;
  const float* cs_row = cs + ((long long)batch * n_heads + head) * seq + t0;
  for (int j = tid; j < q; j += kThreads) {
    css[j] = cs_row[j];
    dts[j] = dt[batch * sd.b + (t0 + j) * sd.s + head * sd.h];
    kf[j] = expf(cs_row[j] - cs_row[j & ~15]);
  }
  for (int e = tid; e < kWarps * q; e += kThreads) col[e] = 0.f;
  copy_wait();
  __syncthreads();

  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int mat = lane / 8, mrow = lane % 8;
  const int n_mt = q / 16;
  const float cs_q = css[q - 1];
  const float* cb_chunk = cb + ((long long)batch * n_chunks + chunk) * q * q;
  float* colw = col + warp * q;
  for (int pi = warp; pi < n_mt / 2; pi += kWarps) {
    for (int side = 0; side < 2; ++side) {
      const int mt = side == 0 ? pi : n_mt - 1 - pi;
      const int r0 = 16 * mt + g, r1 = r0 + 8;
      // x rows r0, r1: the A fragments of X dY^T, which are also the pairs
      // at the places of the dX accumulator
      const bf16* x0 = x + batch * sx.b + (t0 + r0) * sx.s + head * sx.h + t2;
      const bf16* x1 = x0 + 8 * sx.s;
      uint32_t xa[kMaxHD / 16][4];
#pragma unroll
      for (int ks = 0; ks < kMaxHD / 16; ++ks) {
        if (ks < hd / 16) {
          xa[ks][0] = ld_pair(x0 + 16 * ks);
          xa[ks][1] = ld_pair(x1 + 16 * ks);
          xa[ks][2] = ld_pair(x0 + 16 * ks + 8);
          xa[ks][3] = ld_pair(x1 + 16 * ks + 8);
        }
      }

      // the state side: V = B D^T with D = d_hi + d_lo
      float acc[kMaxHD / 8][4] = {};
      const bf16* ba = bm + batch * sb.b + (t0 + r0) * sb.s + t2;
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (kk < n / 16) {
          const bf16* bk = ba + 16 * kk;
          const uint32_t a0 = ld_pair(bk), a1 = ld_pair(bk + 8 * sb.s),
                         a2 = ld_pair(bk + 8), a3 = ld_pair(bk + 8 * sb.s + 8);
#pragma unroll
          for (int nb = 0; nb < kMaxHD / 8; ++nb) {
            if (8 * nb < hd) {
              const int off = (8 * nb + g) * L.ldd + 16 * kk + t2;
              mma_bf16(acc[nb], a0, a1, a2, a3, ld_pair(d_hi + off),
                       ld_pair(d_hi + off + 8));
              mma_bf16(acc[nb], a0, a1, a2, a3, ld_pair(d_lo + off),
                       ld_pair(d_lo + off + 8));
            }
          }
        }
      }
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < kMaxHD / 8; ++nb) {
        if (8 * nb < hd) {
          const float2 v0 = unpack_bf16(xa[nb / 2][(nb & 1) ? 2 : 0]);
          const float2 v1 = unpack_bf16(xa[nb / 2][(nb & 1) ? 3 : 1]);
          u0 += acc[nb][0] * v0.x + acc[nb][1] * v0.y;
          u1 += acc[nb][2] * v1.x + acc[nb][3] * v1.y;
        }
      }
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      const float cs0 = css[r0], cs1 = css[r1], dt0 = dts[r0], dt1 = dts[r1];
      const float ew0 = expf(cs_q - cs0), ew1 = expf(cs_q - cs1);
      const float w0 = ew0 * dt0, w1 = ew1 * dt1;
#pragma unroll
      for (int nb = 0; nb < kMaxHD / 8; ++nb) {
        acc[nb][0] *= w0;
        acc[nb][1] *= w0;
        acc[nb][2] *= w1;
        acc[nb][3] *= w1;
      }

      // M^T dY over the 16-query steps at or right of the diagonal
      const float cs_end = css[16 * mt + 15];
      const float rl0 = expf(cs_end - cs0), rl1 = expf(cs_end - cs1);
      float rs0 = 0.f, rs1 = 0.f;     // sum_i P_ij (C B^T)_ij L_ij by key
      // C B^T at the places of a_r (queries i, i + 1 of key r0 | r1), the
      // next step's loaded while this one multiplies
      float2 cbn[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * mt + t2 + 8 * (r >> 1), j = (r & 1) ? r1 : r0;
        cbn[r] = make_float2(cb_chunk[(long long)i * q + j],
                             cb_chunk[(long long)(i + 1) * q + j]);
      }
      for (int kk = mt; kk < n_mt; ++kk) {
        float2 cbc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cbc[r] = cbn[r];
        if (kk + 1 < n_mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 16 * (kk + 1) + t2 + 8 * (r >> 1);
            const int j = (r & 1) ? r1 : r0;
            cbn[r] = make_float2(cb_chunk[(long long)i * q + j],
                                 cb_chunk[(long long)(i + 1) * q + j]);
          }
        }
        float pt[2][4] = {};          // P^T = X dY^T, keys x queries
#pragma unroll
        for (int ks = 0; ks < kMaxHD / 16; ++ks) {
          if (ks < hd / 16) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const bf16* bp = gs + (16 * kk + 8 * h2 + g) * L.ldg
                               + 16 * ks + t2;
              mma_bf16(pt[h2], xa[ks][0], xa[ks][1], xa[ks][2], xa[ks][3],
                       ld_pair(bp), ld_pair(bp + 8));
            }
          }
        }
        const float blk = kk > mt ? expf(css[16 * kk] - cs_end) : 0.f;
        uint32_t hi[4], lo[4];
        float cp[4] = {};             // Z by query: t2, t2 + 1, +8, +9
#pragma unroll
        for (int r = 0; r < 4; ++r) { // a_r: key r0 | r1, queries i, i + 1
          const bool second = r & 1;
          const int j = second ? r1 : r0;
          const int i = 16 * kk + t2 + 8 * (r >> 1);
          float l_a, l_b;
          if (kk > mt) {
            const float f = (second ? rl1 : rl0) * blk;
            l_a = kf[i] * f;
            l_b = kf[i + 1] * f;
          } else {
            const float cs_j = second ? cs1 : cs0;
            l_a = i >= j ? expf(css[i] - cs_j) : 0.f;
            l_b = i + 1 >= j ? expf(css[i + 1] - cs_j) : 0.f;
          }
          const float lm_a = cbc[r].x * l_a, lm_b = cbc[r].y * l_b;
          const float* pv = &pt[r >> 1][2 * (r & 1)];
          const float z_a = pv[0] * lm_a, z_b = pv[1] * lm_b;
          const float dtj = second ? dt1 : dt0;
          if (second) rs1 += z_a + z_b; else rs0 += z_a + z_b;
          cp[2 * (r >> 1)] += z_a * dtj;
          cp[2 * (r >> 1) + 1] += z_b * dtj;
          split_bf16(lm_a * dtj, lm_b * dtj, hi[r], lo[r]);
        }
#pragma unroll
        for (int nb = 0; nb < kMaxHD / 8; nb += 2) {
          if (8 * nb < hd) {
            // dY: matrices (queries 0-7 | 8-15) of column blocks nb, nb + 1
            uint32_t bb[4];
            ldsm_x4_t(bb, gs + (16 * kk + 8 * (mat & 1) + mrow) * L.ldg
                              + 8 * (nb + (mat >> 1)));
            mma_bf16(acc[nb], hi[0], hi[1], hi[2], hi[3], bb[0], bb[1]);
            mma_bf16(acc[nb], lo[0], lo[1], lo[2], lo[3], bb[0], bb[1]);
            mma_bf16(acc[nb + 1], hi[0], hi[1], hi[2], hi[3], bb[2], bb[3]);
            mma_bf16(acc[nb + 1], lo[0], lo[1], lo[2], lo[3], bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cp[k] += __shfl_xor_sync(kFull, cp[k], 4);
          cp[k] += __shfl_xor_sync(kFull, cp[k], 8);
          cp[k] += __shfl_xor_sync(kFull, cp[k], 16);
        }
        if (g == 0) {
          const int i = 16 * kk + t2;
          colw[i] += cp[0];
          colw[i + 1] += cp[1];
          colw[i + 8] += cp[2];
          colw[i + 9] += cp[3];
        }
      }

      bf16* o0 = dx + (((long long)batch * seq + t0 + r0) * n_heads + head)
                      * hd + t2;
      bf16* o1 = o0 + 8LL * n_heads * hd;
#pragma unroll
      for (int nb = 0; nb < kMaxHD / 8; ++nb) {
        if (8 * nb < hd) {
          *reinterpret_cast<uint32_t*>(o0 + 8 * nb) =
              pack_bf16(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<uint32_t*>(o1 + 8 * nb) =
              pack_bf16(acc[nb][2], acc[nb][3]);
        }
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      if ((lane & 3) == 0) {
        float* dd = ddt + ((long long)batch * seq + t0) * n_heads + head;
        dd[(long long)r0 * n_heads] = rs0 + ew0 * u0;
        dd[(long long)r1 * n_heads] = rs1 + ew1 * u1;
        rowd[r0] = -dt0 * rs0 - w0 * u0;
        rowd[r1] = -dt1 * rs1 - w1 * u1;
        wus[r0] = w0 * u0;
        wus[r1] = w1 * u1;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                // the chunk total's term, in a fixed order
    float s = 0.f;
    for (int j = lane; j < q; j += 32) s += wus[j];
    s = warp_sum(s);
    if (lane == 0) {
      float d_h = 0.f;
      for (int w = 0; w < kWarps; ++w) d_h += red[w];
      red[kWarps] = s + expf(cs_q) * d_h;
    }
  }
  __syncthreads();
  float* dcs_row = dcs + ((long long)batch * n_heads + head) * seq + t0;
  for (int i = tid; i < q; i += kThreads) {
    float v = rowd[i];
    for (int w = 0; w < kWarps; ++w) v += col[w * q + i];
    dcs_row[i] = i == q - 1 ? v + red[kWarps] : v;
  }
}

// Pass B4, per (64 x 64 tile at or below the diagonal, chunk, batch): dCB
// = sum_h (dY_h X_h^T) . L_h . dt_h over the heads, the sum kept in
// registers (4 warps of 16 rows). A head's 64 rows of dY and of X are
// staged by cp.async while the head before is multiplied; below the
// diagonal tile L[i,j] dt_j = e^{cs_i - cs_top} (e^{cs_top - cs_j} dt_j)
// with cs_top the tile's first query, both factors at most 1 (beside dt).
__global__ void __launch_bounds__(128)
ssd_bwd_dcb(const bf16* __restrict__ x, const float* __restrict__ dt,
            const bf16* __restrict__ gy, const float* __restrict__ cs,
            float* __restrict__ dcb, int seq, int n_heads, int hd, int q,
            Strides3 sx, Strides3 sd, Strides3 sg) {
  constexpr int ld = kMaxHD + kPad;
  __shared__ __align__(16) bf16 g_s[2][64 * ld];
  __shared__ __align__(16) bf16 x_s[2][64 * ld];
  __shared__ float rv[2][64], cv[2][64], dv[2][64];
  const int chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const bool diag = ti == tj;
  const long long t0 = (long long)chunk * q;
  const long long ri = t0 + 64 * ti, rj = t0 + 64 * tj;   // first rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // head h's dY rows i and X rows j into buffer s by cp.async, and the cs
  // and dt its factors need into registers (thread t < 64: row i = t;
  // else column j = t - 64), one head ahead of their use
  float c_own = 0.f, c_ref = 0.f, d_own = 0.f;
  auto stage = [&](int h, int s) {
    copy_rows(g_s[s], ld, gy + batch * sg.b + ri * sg.s + h * sg.h, sg.s, 64,
              hd);
    copy_rows(x_s[s], ld, x + batch * sx.b + rj * sx.s + h * sx.h, sx.s, 64,
              hd);
    copy_commit();
    const float* c = cs + ((long long)batch * n_heads + h) * seq;
    c_ref = c[ri];
    if (tid < 64) {
      c_own = c[ri + tid];
    } else {
      c_own = c[rj + tid - 64];
      d_own = dt[batch * sd.b + (rj + tid - 64) * sd.s + h * sd.h];
    }
  };

  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  float acc[8][4] = {};
  stage(0, 0);
  for (int h = 0; h < n_heads; ++h) {
    const int s = h & 1;
    // the factors of head h: the rows' (off the diagonal) or cs (on it),
    // the columns' with dt or cs, and dt
    if (tid < 64) {
      rv[s][tid] = diag ? c_own : expf(c_own - c_ref);
    } else {
      cv[s][tid - 64] = diag ? c_own : expf(c_ref - c_own) * d_own;
      dv[s][tid - 64] = d_own;
    }
    if (h + 1 < n_heads) {
      stage(h + 1, s ^ 1);
      copy_wait_n<1>();
    } else {
      copy_wait_n<0>();
    }
    __syncthreads();
    const bf16* gsb = g_s[s];
    const bf16* xsb = x_s[s];
    uint32_t ga[kMaxHD / 16][4];
#pragma unroll
    for (int ks = 0; ks < kMaxHD / 16; ++ks) {
      if (ks < hd / 16) {
        const bf16* ap = gsb + r0 * ld + 16 * ks + t2;
        ga[ks][0] = ld_pair(ap);
        ga[ks][1] = ld_pair(ap + 8 * ld);
        ga[ks][2] = ld_pair(ap + 8);
        ga[ks][3] = ld_pair(ap + 8 * ld + 8);
      }
    }
    const float f0 = rv[s][r0], f1 = rv[s][r1];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float p[4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxHD / 16; ++ks) {
        if (ks < hd / 16) {
          const bf16* bp = xsb + (8 * nb + g) * ld + 16 * ks + t2;
          mma_bf16(p, ga[ks][0], ga[ks][1], ga[ks][2], ga[ks][3],
                   ld_pair(bp), ld_pair(bp + 8));
        }
      }
      const int j = 8 * nb + t2;
      if (!diag) {
        const float c0 = cv[s][j], c1 = cv[s][j + 1];
        acc[nb][0] += p[0] * f0 * c0;
        acc[nb][1] += p[1] * f0 * c1;
        acc[nb][2] += p[2] * f1 * c0;
        acc[nb][3] += p[3] * f1 * c1;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1, jj = j + (e & 1);
          if (jj <= i)
            acc[nb][e] += p[e] * expf((e < 2 ? f0 : f1) - cv[s][jj])
                          * dv[s][jj];
        }
      }
    }
    __syncthreads();               // buffer s consumed before it is refilled
  }
  float* out = dcb + (((long long)batch * n_chunks + chunk) * q + 64 * ti
                      + r0) * q + 64 * tj + t2;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    *reinterpret_cast<float2*>(out + 8 * nb) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(out + 8 * q + 8 * nb) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

struct BcLayout {         // byte offsets into pass B5's dynamic shared memory
  int ldb, ldx, ldh;      // bf16 per B/C row, per dY/X row, per H/D row
  size_t bs, xs, h_hi, h_lo, f, part, total;
};

__host__ __device__ inline BcLayout bc_layout(int hd, int n) {
  BcLayout s;
  s.ldb = n + kPad;
  s.ldx = hd + kPad;
  s.ldh = n + kPad;
  s.bs = 0;
  s.xs = s.bs + sizeof(bf16) * 64 * s.ldb;
  s.h_hi = s.xs + sizeof(bf16) * 2 * 64 * s.ldx;
  s.h_lo = s.h_hi + sizeof(bf16) * hd * s.ldh;
  s.f = s.h_lo + sizeof(bf16) * hd * s.ldh;
  s.part = s.f + sizeof(float) * 64;
  s.total = s.part + sizeof(float) * 2 * 64;
  return s;
}

// Pass B5, per (64-row tile, chunk, batch): first the tile's rows of dC,
// dCB B over the 64-key slabs left of and on the diagonal plus the state
// side sum_h e^{cs_h} dY_h H_h; then its rows of dB, dCB^T C over the
// slabs on and below the diagonal plus sum_h w_h X_h D_h. The sum over
// heads stays in registers (warp w: rows 16 (w % 4).., half the columns).
// dCB is split into two bf16 as it is read; H and D are split once a head
// into shared memory, the next head's rows, state and scalars loaded while
// this head multiplies. Each head's dcs term of the query, e^{cs_i} C_i .
// (dY H)_i, is added to pass B3's dcs.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc(const bf16* __restrict__ x, const float* __restrict__ dt,
            const bf16* __restrict__ bm, const bf16* __restrict__ cm,
            const bf16* __restrict__ gy, const float* __restrict__ cs,
            const float* __restrict__ states, const float* __restrict__ grads,
            const float* __restrict__ dcb, float* __restrict__ dcs,
            bf16* __restrict__ dbm, bf16* __restrict__ dcm, int seq,
            int n_heads, int hd, int n, int q, Strides3 sx, Strides3 sd,
            Strides2 sb, Strides2 sc, Strides3 sg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BcLayout L = bc_layout(hd, n);
  bf16* bs = reinterpret_cast<bf16*>(smem + L.bs);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* h_hi = reinterpret_cast<bf16*>(smem + L.h_hi);
  bf16* h_lo = reinterpret_cast<bf16*>(smem + L.h_lo);
  float* fs = reinterpret_cast<float*>(smem + L.f);
  float* part = reinterpret_cast<float*>(smem + L.part);
  const int tile = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y, n_tiles = q / 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int mat = lane / 8, mrow = lane % 8;
  const int half = warp / 4, nb0 = 8 * half;
  const int r0 = 16 * (warp % 4) + g, r1 = r0 + 8;     // rows in the tile
  const long long t0 = (long long)chunk * q, row0 = t0 + 64 * tile;
  const float* dcb_chunk = dcb + ((long long)batch * n_chunks + chunk) * q * q;
  const long long slot0 =
      ((long long)batch * n_chunks + chunk) * n_heads * hd * n;

  for (int side = 0; side < 2; ++side) {    // 0: dC, rows i; 1: dB, rows j
    float acc[8][4] = {};
    const int s_lo = side == 0 ? 0 : tile;
    const int s_hi = side == 0 ? tile : n_tiles - 1;
    for (int sl = s_lo; sl <= s_hi; ++sl) {
      __syncthreads();                      // the last slab consumed
      if (side == 0)
        copy_rows(bs, L.ldb, bm + batch * sb.b + (t0 + 64 * sl) * sb.s, sb.s,
                  64, n);
      else
        copy_rows(bs, L.ldb, cm + batch * sc.b + (t0 + 64 * sl) * sc.s, sc.s,
                  64, n);
      copy_wait();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {       // a_r: row r0 | r1, keys k, k + 1
          const int row = 64 * tile + ((r & 1) ? r1 : r0);
          const int key = 64 * sl + 16 * kk + t2 + 8 * (r >> 1);
          const float2 v = side == 0
              ? *reinterpret_cast<const float2*>(dcb_chunk
                                                 + (long long)row * q + key)
              : make_float2(dcb_chunk[(long long)key * q + row],
                            dcb_chunk[(long long)(key + 1) * q + row]);
          split_bf16(v.x, v.y, hi[r], lo[r]);
        }
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          if (8 * (nb0 + i) < n) {
            uint32_t bb[4];
            ldsm_x4_t(bb, bs + (16 * kk + 8 * (mat & 1) + mrow) * L.ldb
                              + 8 * (nb0 + i + (mat >> 1)));
            mma_bf16(acc[i], hi[0], hi[1], hi[2], hi[3], bb[0], bb[1]);
            mma_bf16(acc[i], lo[0], lo[1], lo[2], lo[3], bb[0], bb[1]);
            mma_bf16(acc[i + 1], hi[0], hi[1], hi[2], hi[3], bb[2], bb[3]);
            mma_bf16(acc[i + 1], lo[0], lo[1], lo[2], lo[3], bb[2], bb[3]);
          }
        }
      }
    }

    // the state side, a head at a time: dY_h H_h (dC) or X_h D_h (dB)
    uint32_t cf[8][2];                      // C at the accumulator's places
    if (side == 0) {
      const bf16* c0 = cm + batch * sc.b + (row0 + r0) * sc.s + t2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (8 * (nb0 + i) < n) {
          cf[i][0] = ld_pair(c0 + 8 * (nb0 + i));
          cf[i][1] = ld_pair(c0 + 8 * sc.s + 8 * (nb0 + i));
        }
      }
    }
    // head h + 1's rows (cp.async, into the other buffer), state and, for
    // thread t < 64, row t's cs, dt and dcs (into registers) are loaded
    // while head h multiplies
    const float4* st4 = reinterpret_cast<const float4*>(
        (side == 0 ? states : grads) + slot0);
    const bf16* rows = side == 0 ? gy + batch * sg.b + row0 * sg.s
                                 : x + batch * sx.b + row0 * sx.s;
    const long long row_s = side == 0 ? sg.s : sx.s;
    const long long head_s = side == 0 ? sg.h : sx.h;
    const int n4 = hd * n / 4;
    constexpr int kPre = kMaxHD * kMaxN / 4 / kThreads;
    float4 pre[kPre];
    float c_row = 0.f, c_q = 0.f, d_row = 0.f, dcs_next = 0.f, dcs_row = 0.f;
    auto fetch_row = [&](int h) {           // thread t < 64, row t, head h
      const long long at = ((long long)batch * n_heads + h) * seq;
      c_row = cs[at + row0 + tid];
      c_q = cs[at + t0 + q - 1];
      d_row = dt[batch * sd.b + (row0 + tid) * sd.s + h * sd.h];
      if (side == 0) dcs_next = dcs[at + row0 + tid];
    };
    __syncthreads();                        // the last side's buffers read
    copy_rows(xs, L.ldx, rows, row_s, 64, hd);
    copy_commit();
#pragma unroll
    for (int k = 0; k < kPre; ++k)
      if (tid + k * kThreads < n4) pre[k] = st4[tid + k * kThreads];
    if (tid < 64) fetch_row(0);
    for (int h = 0; h < n_heads; ++h) {
      bf16* xh = xs + (h & 1) * 64 * L.ldx;
      __syncthreads();                      // the last head consumed
      if (tid < 64) {
        if (side == 0 && h > 0)
          dcs[((long long)batch * n_heads + h - 1) * seq + row0 + tid] =
              dcs_row + part[tid] + part[64 + tid];
        fs[tid] = side == 0 ? expf(c_row) : expf(c_q - c_row) * d_row;
        dcs_row = dcs_next;
        if (h + 1 < n_heads) fetch_row(h + 1);
      }
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int e = tid + k * kThreads;
        if (e < n4) {
          const int p = 4 * e / n, c = 4 * e - p * n;
          uint32_t* dhi = reinterpret_cast<uint32_t*>(h_hi + p * L.ldh + c);
          uint32_t* dlo = reinterpret_cast<uint32_t*>(h_lo + p * L.ldh + c);
          split_bf16(pre[k].x, pre[k].y, dhi[0], dlo[0]);
          split_bf16(pre[k].z, pre[k].w, dhi[1], dlo[1]);
        }
      }
      if (h + 1 < n_heads) {
        copy_rows(xs + ((h + 1) & 1) * 64 * L.ldx, L.ldx,
                  rows + (h + 1) * head_s, row_s, 64, hd);
        copy_commit();
        const float4* nx = st4 + (long long)(h + 1) * n4;
#pragma unroll
        for (int k = 0; k < kPre; ++k)
          if (tid + k * kThreads < n4) pre[k] = nx[tid + k * kThreads];
      }
      if (h + 1 < n_heads)
        copy_wait_n<1>();                   // head h's rows have arrived
      else
        copy_wait_n<0>();
      __syncthreads();
      float tmp[8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxHD / 16; ++ks) {
        if (ks < hd / 16) {
          const bf16* ap = xh + r0 * L.ldx + 16 * ks + t2;
          const uint32_t a0 = ld_pair(ap), a1 = ld_pair(ap + 8 * L.ldx);
          const uint32_t a2 = ld_pair(ap + 8);
          const uint32_t a3 = ld_pair(ap + 8 * L.ldx + 8);
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            if (8 * (nb0 + i) < n) {
              const int off = (16 * ks + 8 * (mat & 1) + mrow) * L.ldh
                              + 8 * (nb0 + i + (mat >> 1));
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, h_hi + off);
              ldsm_x4_t(bl, h_lo + off);
              mma_bf16(tmp[i], a0, a1, a2, a3, bh[0], bh[1]);
              mma_bf16(tmp[i], a0, a1, a2, a3, bl[0], bl[1]);
              mma_bf16(tmp[i + 1], a0, a1, a2, a3, bh[2], bh[3]);
              mma_bf16(tmp[i + 1], a0, a1, a2, a3, bl[2], bl[3]);
            }
          }
        }
      }
      const float f0 = fs[r0], f1 = fs[r1];
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (8 * (nb0 + i) < n) {
          acc[i][0] += f0 * tmp[i][0];
          acc[i][1] += f0 * tmp[i][1];
          acc[i][2] += f1 * tmp[i][2];
          acc[i][3] += f1 * tmp[i][3];
          if (side == 0) {
            const float2 v0 = unpack_bf16(cf[i][0]);
            const float2 v1 = unpack_bf16(cf[i][1]);
            c0 += v0.x * tmp[i][0] + v0.y * tmp[i][1];
            c1 += v1.x * tmp[i][2] + v1.y * tmp[i][3];
          }
        }
      }
      if (side == 0) {
        c0 = quad_sum(c0);
        c1 = quad_sum(c1);
        if ((lane & 3) == 0) {
          part[64 * half + r0] = f0 * c0;
          part[64 * half + r1] = f1 * c1;
        }
      }
    }
    __syncthreads();
    if (side == 0 && tid < 64)
      dcs[((long long)batch * n_heads + n_heads - 1) * seq + row0 + tid] =
          dcs_row + part[tid] + part[64 + tid];

    bf16* o0 = (side == 0 ? dcm : dbm) + ((long long)batch * seq + row0 + r0)
               * n + t2;
    bf16* o1 = o0 + 8LL * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (8 * (nb0 + i) < n) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * (nb0 + i)) =
            pack_bf16(acc[i][0], acc[i][1]);
        *reinterpret_cast<uint32_t*>(o1 + 8 * (nb0 + i)) =
            pack_bf16(acc[i][2], acc[i][3]);
      }
    }
  }
}

// Pass B6, per (head, chunk, batch), a thread a step: d(dt A)_k =
// sum_{i >= k} dcs_i within the chunk (a suffix sum by warp shuffles, then
// the later warps' totals), ddt_k += A d(dt A)_k, and the chunk's share of
// dA, sum_k dt_k d(dt A)_k, reduced in a fixed order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcs(const float* __restrict__ dt, const float* __restrict__ a,
            const float* __restrict__ dcs, float* __restrict__ ddt,
            float* __restrict__ da_part, int seq, int n_heads, int q,
            Strides3 sd) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sums[kWarps];
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int n_chunks = gridDim.y;
  const int i = threadIdx.x, warp = i / 32, lane = i % 32;
  const long long t = (long long)chunk * q + i;
  float v = i < q ? dcs[((long long)batch * n_heads + head) * seq + t] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += o;
  }
  if (lane == 0) sums[warp] = v;
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) v += sums[w];
  float part = 0.f;
  if (i < q) {
    ddt[((long long)batch * seq + t) * n_heads + head] += a[head] * v;
    part = dt[batch * sd.b + t * sd.s + head * sd.h] * v;
  }
  part = warp_sum(part);
  __syncthreads();                 // every thread has read sums
  if (lane == 0) sums[warp] = part;
  __syncthreads();
  if (i == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sums[w];
    da_part[((long long)batch * n_chunks + chunk) * n_heads + head] = s;
  }
}

// Pass B7, a warp per head: dA = the chunks' shares summed in a fixed
// order.
__global__ void __launch_bounds__(32)
ssd_bwd_da(const float* __restrict__ da_part, float* __restrict__ da,
           int parts, int n_heads) {
  const int head = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
  for (int k = lane; k < parts; k += 32)
    s += da_part[(long long)k * n_heads + head];
  s = warp_sum(s);
  if (lane == 0) da[head] = s;
}

struct BwdWorkspace {      // byte offsets into the backward's scratch buffer
  size_t grads, dcb, dcs, da, total;
};

BwdWorkspace bwd_workspace(int batch, int seq, int n_heads, int hd, int n,
                           int q) {
  const size_t chunks = (size_t)batch * (seq / q);
  BwdWorkspace w;
  w.grads = 0;
  w.dcb = align256(w.grads + sizeof(float) * chunks * n_heads * hd * n);
  w.dcs = align256(w.dcb + sizeof(float) * chunks * q * q);
  w.da = align256(w.dcs + sizeof(float) * batch * n_heads * seq);
  w.total = w.da + sizeof(float) * chunks * n_heads;
  return w;
}

}  // namespace

extern "C" {

// Scratch bytes one call needs: C B^T per chunk, cs per head and the
// chunk states.
long long ssd_scan_workspace_bytes(int batch, int seq, int n_heads, int hd,
                                   int n, int q) {
  return (long long)workspace(batch, seq, n_heads, hd, n, q).total;
}

// Dynamic shared memory of pass 4 (the other passes use static memory).
int ssd_scan_smem_bytes(int q, int hd, int n) {
  return (int)out_layout(q, hd, n).total;
}

// x [B, S, nh, hd] bf16, dt [B, S, nh] f32, A [nh] f32, Bm/Cm [B, S, N]
// bf16 (one group), y [B, S, nh, hd] bf16, h_out [B, nh, hd, N] f32
// contiguous, work: ssd_scan_workspace_bytes of scratch, 256-byte aligned;
// strides in elements, the last dimension contiguous. The caller
// guarantees S % q == 0, q % 64 == 0 (q <= 256), hd % 16 == 0 (hd <= 64),
// n % 16 == 0 (n <= 128) and 16-byte aligned rows of x, B and C. Launches
// the four passes in order on `stream`; returns a cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* h_out, void* work, int batch,
                 int seq, int n_heads, int hd, int n, int q, long long x_sb,
                 long long x_ss, long long x_sh, long long d_sb,
                 long long d_ss, long long d_sh, long long b_sb,
                 long long b_ss, long long c_sb, long long c_ss,
                 long long y_sb, long long y_ss, long long y_sh,
                 void* stream) {
  const Workspace w = workspace(batch, seq, n_heads, hd, n, q);
  unsigned char* base = static_cast<unsigned char*>(work);
  float* cb = reinterpret_cast<float*>(base + w.cb);
  float* cs = reinterpret_cast<float*>(base + w.cs);
  float* states = reinterpret_cast<float*>(base + w.states);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bmb = static_cast<const bf16*>(bm);
  const auto* cmb = static_cast<const bf16*>(cm);
  const Strides3 sx{x_sb, x_ss, x_sh}, sd{d_sb, d_ss, d_sh},
      sy{y_sb, y_ss, y_sh};
  const Strides2 sb{b_sb, b_ss}, sc{c_sb, c_ss};
  const int n_chunks = seq / q, tiles = q / 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  ssd_scan_cb<<<dim3(tiles * (tiles + 1) / 2, n_chunks, batch), 128, 0,
                st>>>(bmb, cmb, cb, n_chunks, q, n, sb, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_chunk_state<<<dim3(n_heads, n_chunks, batch), kThreads, 0, st>>>(
      xb, dtf, static_cast<const float*>(a), bmb, cs, states, seq, n_heads,
      hd, n, q, sx, sd, sb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int cells = hd * n;
  ssd_scan_state_pass<<<dim3((cells / 4 + kThreads - 1) / kThreads, n_heads,
                             batch), kThreads, 0, st>>>(
      states, cs, static_cast<float*>(h_out), seq, n_chunks, n_heads, cells,
      q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int smem = ssd_scan_smem_bytes(q, hd, n);
  err = cudaFuncSetAttribute(ssd_scan_chunk_out,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_chunk_out<<<dim3(n_heads, n_chunks, batch), kThreads, smem,
                       st>>>(xb, dtf, cmb, cb, cs, states,
                             static_cast<bf16*>(y), seq, n_heads, hd, n, q,
                             sx, sd, sc, sy);
  return (int)cudaGetLastError();
}

// Scratch bytes of one backward call: the state gradients, dCB per chunk,
// dcs per head and the chunks' shares of dA.
long long ssd_bwd_workspace_bytes(int batch, int seq, int n_heads, int hd,
                                  int n, int q) {
  return (long long)bwd_workspace(batch, seq, n_heads, hd, n, q).total;
}

// The gradients of ssd_scan_fwd's y and final h with respect to x, dt, A,
// B and C. Inputs as ssd_scan_fwd's, with the same strides; gy [B, S, nh,
// hd] bf16 with strides (rows 16-byte aligned), gh [B, nh, hd, N] f32
// contiguous or null (zero), work: the forward call's scratch, untouched
// since; bwork: ssd_bwd_workspace_bytes of scratch, 256-byte aligned.
// Writes dx [B, S, nh, hd] bf16, ddt [B, S, nh] f32, da [nh] f32, dbm and
// dcm [B, S, N] bf16, all contiguous. Launches the seven passes in order on
// `stream`; returns a cudaError_t.
int ssd_bwd(const void* x, const void* dt, const void* a, const void* bm,
            const void* cm, const void* gy, const void* gh, const void* work,
            void* bwork, void* dx, void* ddt, void* da, void* dbm, void* dcm,
            int batch, int seq, int n_heads, int hd, int n, int q,
            long long x_sb, long long x_ss, long long x_sh, long long d_sb,
            long long d_ss, long long d_sh, long long b_sb, long long b_ss,
            long long c_sb, long long c_ss, long long g_sb, long long g_ss,
            long long g_sh, void* stream) {
  const Workspace w = workspace(batch, seq, n_heads, hd, n, q);
  const BwdWorkspace bw = bwd_workspace(batch, seq, n_heads, hd, n, q);
  const unsigned char* base = static_cast<const unsigned char*>(work);
  const float* cb = reinterpret_cast<const float*>(base + w.cb);
  const float* cs = reinterpret_cast<const float*>(base + w.cs);
  const float* states = reinterpret_cast<const float*>(base + w.states);
  unsigned char* bbase = static_cast<unsigned char*>(bwork);
  float* grads = reinterpret_cast<float*>(bbase + bw.grads);
  float* dcb = reinterpret_cast<float*>(bbase + bw.dcb);
  float* dcs = reinterpret_cast<float*>(bbase + bw.dcs);
  float* da_part = reinterpret_cast<float*>(bbase + bw.da);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bmb = static_cast<const bf16*>(bm);
  const auto* cmb = static_cast<const bf16*>(cm);
  const auto* gyb = static_cast<const bf16*>(gy);
  const Strides3 sx{x_sb, x_ss, x_sh}, sd{d_sb, d_ss, d_sh},
      sg{g_sb, g_ss, g_sh};
  const Strides2 sb{b_sb, b_ss}, sc{c_sb, c_ss};
  const int n_chunks = seq / q, tiles = q / 64, cells = hd * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  ssd_bwd_state_grad<<<dim3(n_heads, n_chunks, batch), kThreads, 0, st>>>(
      gyb, cmb, cs, grads, seq, n_heads, hd, n, q, sg, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_state_pass<<<dim3((cells / 4 + kThreads - 1) / kThreads, n_heads,
                            batch), kThreads, 0, st>>>(
      grads, cs, static_cast<const float*>(gh), seq, n_chunks, n_heads,
      cells, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int dx_smem = (int)dx_layout(q, hd, n).total;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_dx,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dx_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dx<<<dim3(n_heads, n_chunks, batch), kThreads, dx_smem,
                     st>>>(xb, dtf, bmb, gyb, cb, cs, states, grads,
                           static_cast<bf16*>(dx), static_cast<float*>(ddt),
                           dcs, seq, n_heads, hd, n, q, sx, sd, sb, sg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dcb<<<dim3(tiles * (tiles + 1) / 2, n_chunks, batch), 128, 0,
                st>>>(xb, dtf, gyb, cs, dcb, seq, n_heads, hd, q, sx, sd,
                      sg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int bc_smem = (int)bc_layout(hd, n).total;
  err = cudaFuncSetAttribute(ssd_bwd_dbc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bc_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dbc<<<dim3(tiles, n_chunks, batch), kThreads, bc_smem, st>>>(
      xb, dtf, bmb, cmb, gyb, cs, states, grads, dcb, dcs,
      static_cast<bf16*>(dbm), static_cast<bf16*>(dcm), seq, n_heads, hd, n,
      q, sx, sd, sb, sc, sg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dcs<<<dim3(n_heads, n_chunks, batch), kThreads, 0, st>>>(
      dtf, static_cast<const float*>(a), dcs, static_cast<float*>(ddt),
      da_part, seq, n_heads, q, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da<<<n_heads, 32, 0, st>>>(da_part, static_cast<float*>(da),
                                     batch * n_chunks, n_heads);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
