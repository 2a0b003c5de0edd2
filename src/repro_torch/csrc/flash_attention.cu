// Flash-attention forward for Hopper (sm_90a), bound to Python through
// ctypes by repro_torch/kernels/flash_attention.py, which checks every
// tensor (device, dtype, shape, strides, alignment) before it passes a
// pointer here.
//
// flash_fwd_kernel replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_kernel: online-softmax attention
// with f32 running (max, sum, acc), causal and sliding-window masks, kv
// tiles outside the causal band and the window skipped, output in bf16.
//
// What bounds it: at gemma3-12b's prefill (4 x 2048 tokens, 16 query heads
// over 8 kv heads, head_dim 240) a global layer needs ~1.3e11 tensor-core
// FLOP (two products of 2*d per unmasked (q, k) pair) against 189 MB of
// q/k/v/o, so it is compute-bound: ~0.13 ms at the H100's 989 TFLOP/s bf16
// dense peak against ~0.06 ms for the bytes. The design therefore puts
// both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) and visits only the kv tiles that the causal band and the
// window reach for each q tile. It is a simple first kernel: tiles are
// loaded synchronously (no cp.async/TMA pipeline) and it uses mma.sync,
// not wgmma.
//
// Layout and work split. q, k, v and o stay in the model layout
// [B, T, H, d] (any strides whose rows are 16-byte aligned); query head h
// reads kv head h / (Hq / Hkv), so GQA needs no repeated copy. One block
// per (batch * q-head, 64-row q tile), largest q tiles first; four warps,
// each owning 16 q rows. Per kv tile of 64 keys: Q and K row-major and V
// transposed in shared memory (rows padded by 8 bf16 against bank
// conflicts), S = Q K^T in registers, masks by position (k <= q,
// q - k < window, k < S), online softmax in f32, then O += P V.
//
// Precision. The Pallas kernel multiplies P and V in f32. Rounding P to one
// bf16 for the tensor cores would add ~2^-9 relative error per term, as
// much as the bf16 rounding of the output itself; so P is split into a bf16
// high part and a bf16 remainder and both are multiplied (two mma per
// step), which keeps ~16 bits of P. Masked scores are -inf and their p is
// exactly 0; a row with no valid key yet keeps m = -inf and uses 0 as its
// reference, so exp never sees (-inf) - (-inf) (the Pallas kernel's -1e38
// fill instead gives such rows p = 1 until a later tile rescales them
// away). A row with no valid key at all writes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;   // q rows per block
constexpr int kBlockK = 64;            // keys per kv tile
constexpr int kMaxD = 256;             // largest head_dim taken
constexpr int kMaxDTiles = kMaxD / 8;  // 8-column output tiles
constexpr int kPad = 8;                // bf16 padding per shared row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Strides {            // in elements: batch, sequence, head
  long long b, t, h;
};

// Copy rows [row0, row0 + kBlockQ or kBlockK) of one head into shared
// memory, row-major with leading dimension ld; rows at or past n_rows are
// zero-filled so that masked lanes never multiply garbage.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          Strides st, int b, int h, int row0,
                                          int rows, int n_rows, int d) {
  const int chunks = d / 8;                      // 16-byte pieces per row
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(
          src + b * st.b + (long long)(row0 + r) * st.t + h * st.h + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// V tile transposed: dst[col][key], leading dimension ldt. Consecutive
// threads take consecutive keys of one 8-column chunk, so their 2-byte
// stores fall into consecutive shared-memory words.
__device__ __forceinline__ void load_v_transposed(
    __nv_bfloat16* dst, int ldt, const __nv_bfloat16* src, Strides st, int b,
    int h, int row0, int n_rows, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < kBlockK * chunks; i += kThreads) {
    const int r = i % kBlockK, c = i / kBlockK;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(
          src + b * st.b + (long long)(row0 + r) * st.t + h * st.h + c * 8);
    }
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
    uint16_t* col = reinterpret_cast<uint16_t*>(dst) + (c * 8) * ldt + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[(2 * j) * ldt] = (uint16_t)(w[j] & 0xffffu);
      col[(2 * j + 1) * ldt] = (uint16_t)(w[j] >> 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int seq_q, int seq_kv,
                 int n_heads, int n_kv_heads, int d, Strides sq, Strides sk,
                 Strides sv, Strides so, float scale, int causal,
                 int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + kPad;
  const int ldt = kBlockK + kPad;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + kBlockQ * ld;
  __nv_bfloat16* s_vt = s_k + kBlockK * ld;

  const int n_qt = gridDim.x;
  const int q_tile = n_qt - 1 - blockIdx.x;      // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int h_kv = h / (n_heads / n_kv_heads);
  const int q0 = q_tile * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_dt = d / 8, n_kk = d / 16;

  load_rows(s_q, ld, q, sq, b, h, q0, kBlockQ, seq_q, d);

  // kv tiles this q tile can reach: the causal band ends at its last real
  // row, the window starts window-1 before its first row
  const int q_last = min(q0 + kBlockQ, seq_q) - 1;
  const int k_end = causal ? min(seq_kv, q_last + 1) : seq_kv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBlockK;
  const int kt_end = (k_end + kBlockK - 1) / kBlockK;

  // this thread's two rows, and the warp's row range
  const int w_first = q0 + warp * 16;
  const int row0 = w_first + g, row1 = row0 + 8;

  float acc[kMaxDTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxDTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running row maxima
  float l0 = 0.f, l1 = 0.f;               // this thread's share of row sums

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                      // the previous tile is consumed
    load_rows(s_k, ld, k, sk, b, h_kv, k0, kBlockK, seq_kv, d);
    load_v_transposed(s_vt, ldt, v, sv, b, h_kv, k0, seq_kv, d);
    __syncthreads();

    // skip the tile for this warp when none of its 16 rows reaches it
    const bool before_band = causal && k0 > w_first + 15;
    const bool past_window =
        window > 0 && k0 + kBlockK - 1 < w_first - window + 1;
    if (before_band || past_window) continue;

    // S = Q K^T for 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* qa = s_q + (warp * 16 + g) * ld + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      if (kk < n_kk) {
        const uint32_t a0 = ld_pair(qa + kk * 16);
        const uint32_t a1 = ld_pair(qa + 8 * ld + kk * 16);
        const uint32_t a2 = ld_pair(qa + kk * 16 + 8);
        const uint32_t a3 = ld_pair(qa + 8 * ld + kk * 16 + 8);
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
          const __nv_bfloat16* kb = s_k + (j * 8 + g) * ld + kk * 16 + 2 * t4;
          mma_bf16(s[j], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
        }
      }
    }

    // scale, mask by position, new row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qpos = e < 2 ? row0 : row1;
        bool ok = kpos < seq_kv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no valid key so far keeps -inf; 0 stands in as its
    // reference so that every p and the correction are exactly 0
    const float ref0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ref1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = expf(m0 - ref0), corr1 = expf(m1 - ref1);
    m0 = mn0;
    m1 = mn1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = expf(s[j][0] - ref0);
      s[j][1] = expf(s[j][1] - ref0);
      s[j][2] = expf(s[j][2] - ref1);
      s[j][3] = expf(s[j][3] - ref1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < kMaxDTiles; ++j) {
      if (j < n_dt) {
        acc[j][0] *= corr0;
        acc[j][1] *= corr0;
        acc[j][2] *= corr1;
        acc[j][3] *= corr1;
      }
    }

    // O += P V, with P = P_hi + P_lo in bf16
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const float* p0 = s[2 * kc];
      const float* p1 = s[2 * kc + 1];
      const uint32_t h0 = pack_bf16(p0[0], p0[1]);
      const uint32_t h1 = pack_bf16(p0[2], p0[3]);
      const uint32_t h2 = pack_bf16(p1[0], p1[1]);
      const uint32_t h3 = pack_bf16(p1[2], p1[3]);
      const __nv_bfloat162* hb0 = reinterpret_cast<const __nv_bfloat162*>(&h0);
      const __nv_bfloat162* hb1 = reinterpret_cast<const __nv_bfloat162*>(&h1);
      const __nv_bfloat162* hb2 = reinterpret_cast<const __nv_bfloat162*>(&h2);
      const __nv_bfloat162* hb3 = reinterpret_cast<const __nv_bfloat162*>(&h3);
      const uint32_t r0 = pack_bf16(p0[0] - __low2float(*hb0),
                                    p0[1] - __high2float(*hb0));
      const uint32_t r1 = pack_bf16(p0[2] - __low2float(*hb1),
                                    p0[3] - __high2float(*hb1));
      const uint32_t r2 = pack_bf16(p1[0] - __low2float(*hb2),
                                    p1[1] - __high2float(*hb2));
      const uint32_t r3 = pack_bf16(p1[2] - __low2float(*hb3),
                                    p1[3] - __high2float(*hb3));
      const __nv_bfloat16* vb = s_vt + g * ldt + kc * 16 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kMaxDTiles; ++j) {
        if (j < n_dt) {
          const uint32_t b0 = ld_pair(vb + j * 8 * ldt);
          const uint32_t b1 = ld_pair(vb + j * 8 * ldt + 8);
          mma_bf16(acc[j], h0, h1, h2, h3, b0, b1);
          mma_bf16(acc[j], r0, r1, r2, r3, b0, b1);
        }
      }
    }
  }

  // finish: full row sums across the four lanes of a row, then O / l
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  __nv_bfloat16* o0 = o + b * so.b + (long long)row0 * so.t + h * so.h + 2 * t4;
  __nv_bfloat16* o1 = o + b * so.b + (long long)row1 * so.t + h * so.h + 2 * t4;
#pragma unroll
  for (int j = 0; j < kMaxDTiles; ++j) {
    if (j < n_dt) {
      if (row0 < seq_q) {
        const float a = l0 > 0.f ? acc[j][0] / l0 : 0.f;
        const float c = l0 > 0.f ? acc[j][1] / l0 : 0.f;
        *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(a, c);
      }
      if (row1 < seq_q) {
        const float a = l1 > 0.f ? acc[j][2] / l1 : 0.f;
        const float c = l1 > 0.f ? acc[j][3] / l1 : 0.f;
        *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(a, c);
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for head_dim d.
int flash_attention_smem_bytes(int d) {
  return (int)sizeof(__nv_bfloat16) *
         ((kBlockQ + kBlockK) * (d + kPad) + d * (kBlockK + kPad));
}

int flash_attention_max_head_dim() { return kMaxD; }

// q [B, T, Hq, d], k/v [B, S, Hkv, d], o [B, T, Hq, d], all bf16; strides
// in elements as (batch, sequence, head), the last dimension contiguous.
// window <= 0 means no window. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int batch, int seq_q, int seq_kv, int n_heads,
                        int n_kv_heads, int d, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, long long o_sb, long long o_st,
                        long long o_sh, float scale, int causal, int window,
                        void* stream) {
  const int smem = flash_attention_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * n_heads);
  flash_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      seq_q, seq_kv, n_heads, n_kv_heads, d, Strides{q_sb, q_st, q_sh},
      Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
      Strides{o_sb, o_st, o_sh}, scale, causal, window);
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
