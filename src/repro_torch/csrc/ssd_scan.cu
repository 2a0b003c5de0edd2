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

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
