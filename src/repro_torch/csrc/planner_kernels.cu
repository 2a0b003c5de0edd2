// Fused admission-sweep kernels of the carbon-aware planner, for Hopper
// (sm_90a). Bound to Python through ctypes by
// repro_torch/core/scheduler/grid_cuda.py, which checks every tensor
// (device, dtype, shape, contiguity) before it passes a pointer here.
//
// rate_prefix_kernel replaces grid_pallas._rate_prefix_kernel
// (src/repro/core/scheduler/grid_pallas.py:77). It writes 12 bytes per
// (pair, hop, grid step): the f32 rate and its f64 exclusive prefix, 37.7 MB
// for the largest chunk of a 4096-job window, about 11 us at the H100's
// 3.35 TB/s. The arithmetic per step (one cosf, one expf, a few f64 time
// ops) is far below the byte bound, so the design only has to stream: one
// block per (pair, hop) row, threads over consecutive steps so every store
// is coalesced, the hourly noise rows read through L1, and a loop over time
// tiles with a block-wide f64 scan plus a running carry in place of the
// TPU's sequential grid axis and its VMEM carry.
//
// sweep_kernel replaces grid_pallas._sweep_kernel
// (src/repro/core/scheduler/grid_pallas.py:125). It is gather-bound: per
// (cell, slot, leg, hop) three scattered 8-byte reads (E[hi], E[k], r[hi])
// that mostly hit the 50 MB L2, since rate_prefix has just written E and r.
// One warp per cell, lanes over start slots, a loop over slot tiles; each
// lane keeps its (cost, emissions) and a warp shuffle reduction takes the
// first minimum by (cost, slot), so ties go to the lower slot as numpy's
// argmin does. Only three doubles per cell are written.
//
// Precision follows the reference: time and index math in double, the CI
// chain in float with full-precision cosf/expf (no --use_fast_math), sums
// in double. Built with --fmad=false, so each operation rounds as the plain
// torch version's does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRateThreads = 256;
constexpr int kRateWarps = kRateThreads / 32;
constexpr int kSweepWarps = 4;
constexpr int kCellCols = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Python's float floor division (numpy, jax and torch `//` on floats).
__device__ __forceinline__ double floordiv(double a, double b) {
  const double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0 && ((b < 0.0) != (mod < 0.0))) div -= 1.0;
  if (div == 0.0) return copysign(0.0, a / b);
  double fl = floor(div);
  if (div - fl > 0.5) fl += 1.0;
  return fl;
}

// Python's float modulo: the result takes the sign of the divisor.
__device__ __forceinline__ double pymod(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m += b;
  return m;
}

// pp (A, H, 6) f32 [base, amp, dip, noise_amp, peak, band]; zn, hn (A, H, W)
// f32; rel0 (A,) f64; tc (5,) f64 [h_of_day0, day_frac_s, dow0, cal_a,
// cal_b] -> r (A, H, T) f32, e (A, H, T) f64 exclusive prefix of r.
// Grid: one block per (pair, hop) row.
__global__ void __launch_bounds__(kRateThreads)
rate_prefix_kernel(const float* __restrict__ pp, const float* __restrict__ zn,
                   const float* __restrict__ hn,
                   const double* __restrict__ rel0,
                   const double* __restrict__ tc, float* __restrict__ r_out,
                   double* __restrict__ e_out, int n_hops, int t_pad,
                   int w_hours, double dt_s) {
  __shared__ double warp_tot[kRateWarps];
  const int row = blockIdx.x;
  const int pair = row / n_hops;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = pp + (size_t)row * 6;
  const float base = p[0], amp = p[1], dip = p[2];
  const float namp = p[3], peak = p[4], band = p[5];
  const float* zn_row = zn + (size_t)row * w_hours;
  const float* hn_row = hn + (size_t)row * w_hours;
  float* r_row = r_out + (size_t)row * t_pad;
  double* e_row = e_out + (size_t)row * t_pad;
  const double r0 = rel0[pair];
  const double h_of_day0 = tc[0], day_frac_s = tc[1];
  const int dow0 = (int)tc[2];
  const float cal_a = (float)tc[3], cal_b = (float)tc[4];
  const float two_pi = (float)(2.0 * 3.141592653589793);

  double carry = 0.0;
  for (int t0 = 0; t0 < t_pad; t0 += kRateThreads) {
    const int t = t0 + threadIdx.x;
    float r = 0.0f;
    if (t < t_pad) {
      // time and index math in double: hour boundaries land exactly
      const double t_rel = r0 + dt_s * (double)t;
      const int hour = min(max((int)floordiv(t_rel, 3600.0), 0), w_hours - 1);
      const float hod = (float)pymod(h_of_day0 + t_rel / 3600.0, 24.0);
      int dow = (dow0 + (int)floor((t_rel + day_frac_s) / 86400.0)) % 7;
      if (dow < 0) dow += 7;
      // the CI value chain in float
      float v = base + amp * cosf(two_pi * (hod - peak) / 24.0f);
      const float x = (hod - 13.0f) / 2.5f;
      v = v - dip * expf(-0.5f * (x * x));
      if (dow == 5 || dow == 6) v = v * 0.94f;
      v = v + namp * zn_row[hour];
      v = fmaxf(v, 1.0f);
      v = fmaxf(cal_a * v + cal_b, 0.5f);
      r = v * (1.0f + 0.02f * band + 0.005f * hn_row[hour]);
    }
    // r is rounded to float before it is widened and summed in double
    const double r64 = (double)r;
    double incl = r64;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    double before = 0.0, tile = 0.0;
#pragma unroll
    for (int w = 0; w < kRateWarps; ++w) {
      const double s = warp_tot[w];
      if (w < warp) before += s;
      tile += s;
    }
    __syncthreads();  // warp_tot is written again by the next tile
    if (t < t_pad) {
      r_row[t] = r;
      e_row[t] = carry + ((before + incl) - r64);
    }
    carry += tile;
  }
}

// e, r (A, H, T) from rate_prefix; scl (A, S) f64; pidx (C, 2) i32;
// wd (C, 2, H) f64; sla (C, 8) f64 [n_steps, rem_s, n_valid, dur_s,
// w_perf/slack, w_carbon, budget_g, submitted_t] -> best (C, 3) f64
// [cost, emissions, slot]. Grid: one warp per cell.
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_kernel(const double* __restrict__ e, const float* __restrict__ r,
             const double* __restrict__ scl, const int* __restrict__ pidx,
             const double* __restrict__ wd, const double* __restrict__ sla,
             double* __restrict__ best, int n_cells, int n_hops, int t_pad,
             int n_slots, int stride, double dt_s, double slot_s) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (cell >= n_cells) return;  // whole warps only: shuffles stay full
  const double* row = sla + (size_t)cell * kCellCols;
  const int n = (int)row[0];
  const double rem = row[1], n_valid = row[2], dur = row[3];
  const double wp = row[4], wc = row[5], budget = row[6], sub = row[7];
  const int pair[2] = {pidx[2 * cell], pidx[2 * cell + 1]};
  const double* w = wd + (size_t)cell * 2 * n_hops;

  double b_cost = INFINITY, b_emis = INFINITY;
  int b_slot = 0;
  for (int s0 = 0; s0 < n_slots; s0 += 32) {
    const int s = s0 + lane;
    double cost = INFINITY, emis = INFINITY;
    if (s < n_slots) {
      const int k = s * stride;
      // valid slots satisfy k + n - 1 <= T - 1 by grid construction; the
      // clamps only tame padded slots and cells, which mask to +inf below
      const int hi = min(max(k + n - 1, 0), t_pad - 1);
      const int kc = min(k, t_pad - 1);
      emis = 0.0;
      for (int leg = 0; leg < 2; ++leg) {
        double seg_w = 0.0, last_w = 0.0;
        for (int h = 0; h < n_hops; ++h) {
          const size_t rb = ((size_t)pair[leg] * n_hops + h) * t_pad;
          const double wh = w[leg * n_hops + h];
          seg_w += wh * (e[rb + hi] - e[rb + kc]);
          last_w += wh * (double)r[rb + hi];
        }
        const double leg_g = (seg_w * dt_s + last_w * rem) / 3.6e6;
        emis += leg_g * scl[(size_t)pair[leg] * n_slots + s];
      }
      // numpy's op order for the perf term: (sub + slot_s*k + dur) - sub
      const double ts = sub + slot_s * (double)s;
      cost = wc * emis + wp * ((ts + dur) - sub);
      if (!((double)s < n_valid && emis <= budget)) cost = INFINITY;
    }
    int slot = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double oc = __shfl_down_sync(kFullMask, cost, off);
      const double oe = __shfl_down_sync(kFullMask, emis, off);
      const int os = __shfl_down_sync(kFullMask, slot, off);
      if (oc < cost || (oc == cost && os < slot)) {
        cost = oc;
        emis = oe;
        slot = os;
      }
    }
    if (cost < b_cost) {  // strict: an earlier tile keeps a tie
      b_cost = cost;
      b_emis = emis;
      b_slot = slot;
    }
  }
  if (lane == 0) {
    best[(size_t)cell * 3 + 0] = b_cost;
    best[(size_t)cell * 3 + 1] = b_emis;
    best[(size_t)cell * 3 + 2] = (double)b_slot;
  }
}

}  // namespace

extern "C" {

int planner_rate_prefix(const float* pp, const float* zn, const float* hn,
                        const double* rel0, const double* tc, float* r,
                        double* e, int n_pairs, int n_hops, int t_pad,
                        int w_hours, double dt_s, void* stream) {
  rate_prefix_kernel<<<n_pairs * n_hops, kRateThreads, 0,
                       (cudaStream_t)stream>>>(pp, zn, hn, rel0, tc, r, e,
                                               n_hops, t_pad, w_hours, dt_s);
  return (int)cudaGetLastError();
}

int planner_sweep(const double* e, const float* r, const double* scl,
                  const int* pidx, const double* wd, const double* sla,
                  double* best, int n_cells, int n_hops, int t_pad,
                  int n_slots, int stride, double dt_s, double slot_s,
                  void* stream) {
  const int blocks = (n_cells + kSweepWarps - 1) / kSweepWarps;
  sweep_kernel<<<blocks, kSweepWarps * 32, 0, (cudaStream_t)stream>>>(
      e, r, scl, pidx, wd, sla, best, n_cells, n_hops, t_pad, n_slots,
      stride, dt_s, slot_s);
  return (int)cudaGetLastError();
}

const char* planner_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
