// Mamba-2 SSD chunk scan for Hopper (sm_90a), bound to Python through
// ctypes by repro_torch/kernels/ssd_scan.py, which checks every tensor
// (device, dtype, shape, strides, alignment) before it passes a pointer
// here.
//
// ssd_scan_kernel replaces the Pallas kernel
// src/repro/kernels/ssd_scan.py::_kernel. Per chunk of Q steps it computes
//   cs = cumsum(dt * A)                              (inclusive: L[i,i] = 1)
//   y  = ((C B^T) . L . dt_j) X + (C . e^cs) h_prev^T     (h before the chunk)
//   h  = e^{cs_Q} h_prev + X^T (e^{cs_Q - cs} . dt . B)   (h starts at zero)
// with L[i,j] = e^{cs_i - cs_j} for j <= i and 0 above the diagonal; y is
// written in bf16 (x's dtype) and the final h in f32.
//
// What bounds it: at mamba2-370m's training shapes (8 x 2048 tokens, 32
// heads of 64, d_state 128, chunk 256) a call needs ~4.3e10 FLOP with the
// upper triangle of C B^T skipped, against ~150 MB of x, B, C, dt, y and h:
// ~0.65 ms at the H100's 67 TFLOP/s f32 (CUDA cores) against ~0.045 ms for
// the bytes, so it is compute-bound. This first kernel does all of it in
// f32 on the CUDA cores; tensor cores (TF32 or split bf16), cp.async/TMA
// and sharing C B^T across the heads (B and C are shared, n_groups = 1)
// are later work.
//
// Work split. The Pallas grid runs the chunk axis in order and keeps h in
// VMEM; CUDA blocks run in no order, so one block per (batch, head) loops
// over the chunks itself and keeps h (hd x N f32) in shared memory. Per
// chunk the block stages x (Q x hd), B and C (Q x N) in bf16 in shared
// memory (with h, the M tile and the padding 218,624 bytes at the shapes
// above, so the launch raises the dynamic shared memory limit), the
// warp-0 scan gives cs, and then:
//   1. for each 64-row query tile: y_off = e^{cs_i} C h^T from the state
//      before the chunk, then for each 64-key tile j0 <= i0 the tile
//      M = (C B^T) . L . dt_j in shared memory (never the whole Q x Q
//      matrix) and y += M X;
//   2. only after every y of the chunk has read h: the state update.
// The model layout [B, S, nh, hd] of x and y and [B, S, 1, N] of B and C is
// read with strides, so nothing is transposed. B and C rows are padded by
// one 4-byte word and h rows by one float, so the column reads of 16
// threads fall in 16 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kTile = 64;              // query rows and keys per tile
constexpr int kRows = kTile / 16;      // query rows per thread
// The wrapper (kernels/ssd_scan.py) checks shapes against copies of these
// three limits: MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE.
constexpr int kMaxQ = 256;             // largest chunk taken
constexpr int kMaxHD = 64;             // largest head_dim taken
constexpr int kMaxN = 128;             // largest d_state taken
constexpr int kMaxPC = kMaxHD / 16;    // head_dim columns per thread
constexpr int kMaxNC = kMaxN / 16;     // state columns per thread
constexpr int kLdM = kTile + 1;        // f32 per row of the M tile
constexpr unsigned kFull = 0xffffffffu;

struct Layout {          // byte offsets into dynamic shared memory
  int ldbc, ldh;         // bf16 per B/C row, f32 per h row
  size_t h, m, cs, dt, w, x, b, c, total;
};

__host__ __device__ inline Layout make_layout(int q, int hd, int n) {
  Layout s;
  s.ldbc = n + 2;
  s.ldh = n + 1;
  s.h = 0;
  s.m = s.h + sizeof(float) * hd * s.ldh;
  s.cs = s.m + sizeof(float) * kTile * kLdM;
  s.dt = s.cs + sizeof(float) * q;
  s.w = s.dt + sizeof(float) * q;
  s.x = s.w + sizeof(float) * q;                 // 16-byte aligned
  s.b = s.x + sizeof(__nv_bfloat16) * q * hd;
  s.c = s.b + sizeof(__nv_bfloat16) * q * s.ldbc;
  s.total = s.c + sizeof(__nv_bfloat16) * q * s.ldbc;
  return s;
}

struct Strides3 { long long b, s, h; };
struct Strides2 { long long b, s; };

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ a,
                const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm,
                __nv_bfloat16* __restrict__ y, float* __restrict__ h_out,
                int seq, int n_heads, int hd, int n, int q, Strides3 sx,
                Strides3 sd, Strides2 sb, Strides2 sc, Strides3 sy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(q, hd, n);
  float* hs = reinterpret_cast<float*>(smem + L.h);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* css = reinterpret_cast<float*>(smem + L.cs);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + L.b);
  __nv_bfloat16* cms = reinterpret_cast<__nv_bfloat16*>(smem + L.c);

  const int head = blockIdx.x, batch = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int pc = hd / 16, nc = n / 16;
  const float a_h = a[head];

  for (int e = tid; e < hd * L.ldh; e += kThreads) hs[e] = 0.f;

  const int n_chunks = seq / q;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const long long t0 = (long long)chunk * q;
    // ---- stage the chunk: x, B, C (16 bytes a load), dt ----
    const int x8 = hd / 8, n8 = n / 8;
    for (int e = tid; e < q * x8; e += kThreads) {
      const int j = e / x8, k = e - j * x8;
      const __nv_bfloat16* src =
          x + batch * sx.b + (t0 + j) * sx.s + head * sx.h + 8 * k;
      *reinterpret_cast<uint4*>(xs + j * hd + 8 * k) =
          *reinterpret_cast<const uint4*>(src);
    }
    for (int e = tid; e < 2 * q * n8; e += kThreads) {
      const int which = e / (q * n8), r = e - which * q * n8;
      const int j = r / n8, k = r - j * n8;
      const uint4 v = which == 0
          ? *reinterpret_cast<const uint4*>(bm + batch * sb.b +
                                            (t0 + j) * sb.s + 8 * k)
          : *reinterpret_cast<const uint4*>(cm + batch * sc.b +
                                            (t0 + j) * sc.s + 8 * k);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          (which == 0 ? bs : cms) + j * L.ldbc + 8 * k);
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    for (int j = tid; j < q; j += kThreads)
      dts[j] = dt[batch * sd.b + (t0 + j) * sd.s + head * sd.h];
    __syncthreads();

    // ---- cs = inclusive cumsum(dt * A): warp 0, q / 32 steps a lane ----
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
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k)
        if (k < per) css[lane * per + k] = excl + loc[k];
    }
    __syncthreads();
    const float cs_last = css[q - 1];
    for (int j = tid; j < q; j += kThreads)
      ws[j] = expf(cs_last - css[j]) * dts[j];

    // ---- y, one 64-row query tile at a time; reads h before the chunk ----
    for (int i0 = 0; i0 < q; i0 += kTile) {
      float acc[kRows][kMaxPC];
      // y_off = e^{cs_i} sum_n C[i,n] h[p,n]
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kMaxPC; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < n; k += 2) {
        float2 cv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          cv[r] = ld_bf2(cms + (i0 + ty + 16 * r) * L.ldbc + k);
#pragma unroll
        for (int c = 0; c < kMaxPC; ++c) {
          if (c < pc) {
            const float* hp = hs + (tx + 16 * c) * L.ldh + k;
            const float h0 = hp[0], h1 = hp[1];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r][c] = fmaf(cv[r].x, h0, fmaf(cv[r].y, h1, acc[r][c]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = expf(css[i0 + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < kMaxPC; ++c) acc[r][c] *= e;
      }
      // y_diag over the key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        float s[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        for (int k = 0; k < n; k += 2) {
          float2 cv[kRows], bv[4];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            cv[r] = ld_bf2(cms + (i0 + ty + 16 * r) * L.ldbc + k);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] = ld_bf2(bs + (j0 + tx + 16 * c) * L.ldbc + k);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              s[r][c] = fmaf(cv[r].x, bv[c].x, fmaf(cv[r].y, bv[c].y, s[r][c]));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            ms[(ty + 16 * r) * kLdM + tx + 16 * c] =
                j <= i ? s[r][c] * expf(css[i] - css[j]) * dts[j] : 0.f;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < kTile; ++jj) {
          float mv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) mv[r] = ms[(ty + 16 * r) * kLdM + jj];
          const __nv_bfloat16* xr = xs + (j0 + jj) * hd + tx;
#pragma unroll
          for (int c = 0; c < kMaxPC; ++c) {
            if (c < pc) {
              const float xv = __bfloat162float(xr[16 * c]);
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                acc[r][c] = fmaf(mv[r], xv, acc[r][c]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        __nv_bfloat16* yr = y + batch * sy.b + (t0 + i0 + ty + 16 * r) * sy.s +
                            head * sy.h + tx;
#pragma unroll
        for (int c = 0; c < kMaxPC; ++c)
          if (c < pc) yr[16 * c] = __float2bfloat16(acc[r][c]);
      }
    }
    __syncthreads();   // every y of the chunk has read h

    // ---- h = e^{cs_Q} h + sum_j w_j x_j B_j^T; thread owns (p, n) cells ----
    {
      float hacc[kMaxPC][kMaxNC];
#pragma unroll
      for (int r = 0; r < kMaxPC; ++r)
#pragma unroll
        for (int c = 0; c < kMaxNC; ++c) hacc[r][c] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float wj = ws[j];
        float xv[kMaxPC], bv[kMaxNC];
#pragma unroll
        for (int r = 0; r < kMaxPC; ++r)
          xv[r] = r < pc ? __bfloat162float(xs[j * hd + ty + 16 * r]) * wj : 0.f;
#pragma unroll
        for (int c = 0; c < kMaxNC; ++c)
          bv[c] = c < nc ? __bfloat162float(bs[j * L.ldbc + tx + 16 * c]) : 0.f;
#pragma unroll
        for (int r = 0; r < kMaxPC; ++r)
#pragma unroll
          for (int c = 0; c < kMaxNC; ++c)
            hacc[r][c] = fmaf(xv[r], bv[c], hacc[r][c]);
      }
      const float decay = expf(cs_last);
#pragma unroll
      for (int r = 0; r < kMaxPC; ++r)
#pragma unroll
        for (int c = 0; c < kMaxNC; ++c)
          if (r < pc && c < nc) {
            float* hp = hs + (ty + 16 * r) * L.ldh + tx + 16 * c;
            *hp = *hp * decay + hacc[r][c];
          }
    }
    __syncthreads();   // h is whole before the next chunk reads it
  }

  float* ho = h_out + ((long long)batch * n_heads + head) * hd * n;
  for (int e = tid; e < hd * n; e += kThreads) {
    const int p = e / n, k = e - p * n;
    ho[e] = hs[p * L.ldh + k];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for chunk q, head_dim hd and d_state n.
int ssd_scan_smem_bytes(int q, int hd, int n) {
  return (int)make_layout(q, hd, n).total;
}

// x [B, S, nh, hd] bf16, dt [B, S, nh] f32, A [nh] f32, Bm/Cm [B, S, N]
// bf16 (one group), y [B, S, nh, hd] bf16, h_out [B, nh, hd, N] f32
// contiguous; strides in elements, the last dimension contiguous. The
// caller guarantees S % q == 0, q % 64 == 0 (q <= 256), hd % 16 == 0
// (hd <= 64), n % 16 == 0 (n <= 128) and 16-byte aligned rows of x, B and
// C. Returns a cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* h_out, int batch, int seq,
                 int n_heads, int hd, int n, int q, long long x_sb,
                 long long x_ss, long long x_sh, long long d_sb,
                 long long d_ss, long long d_sh, long long b_sb,
                 long long b_ss, long long c_sb, long long c_ss,
                 long long y_sb, long long y_ss, long long y_sh,
                 void* stream) {
  const int smem = ssd_scan_smem_bytes(q, hd, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_heads, batch);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_out), seq, n_heads, hd, n, q,
      Strides3{x_sb, x_ss, x_sh}, Strides3{d_sb, d_ss, d_sh},
      Strides2{b_sb, b_ss}, Strides2{c_sb, c_ss},
      Strides3{y_sb, y_ss, y_sh});
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
