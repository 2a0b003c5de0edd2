// Fused admission-sweep kernels of the carbon-aware planner, for Hopper
// (sm_90a). Bound to Python through ctypes by
// repro_torch/core/scheduler/grid_cuda.py, which checks every tensor
// (device, dtype, shape, contiguity) before it passes a pointer here.
//
// rate_prefix_kernel replaces grid_pallas._rate_prefix_kernel
// (src/repro/core/scheduler/grid_pallas.py:77). It writes 12 bytes per
// (pair, hop, grid step): the f32 rate and its f64 exclusive prefix, 25 MB
// for the first chunk of a 4096-job window, about 8 us at the H100's
// 3.35 TB/s. Design:
//  * A thread-block cluster per pair splits the time axis into segments of
//    kRateSeg steps, one CTA each (up to 8 CTAs; a row longer than 8
//    segments takes several rounds). Each CTA reads the per-hop totals of
//    the cluster's other segments from their shared memory, so every row
//    is scanned in a single pass. The cluster barrier is split: r, which
//    needs no carry, is stored while the other CTAs arrive.
//  * The f64 time math (hour index, hour of day, weekend, and the solar
//    dip's exp, which depends on the hour of day alone) is evaluated once
//    per (pair, step) into shared memory and shared by the pair's hops.
//    Python's floor division and modulo are the floor and remainder of the
//    exact quotient; they are formed here by a multiply and two exact
//    comparisons instead of fmod, with the same results.
//  * One warp per hop: each lane owns kRateRun consecutive steps, computes
//    their rates and their f64 sum serially, and one warp scan over the
//    lanes' sums gives every step's prefix. The rates wait in the staging
//    buffer, not in registers, so a thread needs at most 64 and four CTAs
//    fit on an SM.
//  * The hours a segment touches of the hop's zone and hop noise rows are
//    staged in shared memory; r and E go out through a per-warp staging
//    buffer (each lane's run is transposed there) as coalesced 16-byte
//    stores, or 4- and 8-byte ones where t_pad is no multiple of 4.
//
// sweep_kernel replaces grid_pallas._sweep_kernel
// (src/repro/core/scheduler/grid_pallas.py:125). It is gather-bound: per
// (cell, slot, leg, live hop) three scattered reads (E[hi], E[k], r[hi])
// that mostly hit the 50 MB L2, since rate_prefix has just written E and r.
// Design:
//  * One warp per cell; lane = leg * 16 + slot in a tile of 16 slots, so
//    both legs of 16 slots are gathered at once. Tiles stop at n_valid:
//    slots past it cost +inf whatever they hold.
//  * Each leg's hops with a non-zero weight are compacted into a list in
//    shared memory (ballot + popc) and only those are gathered. This is
//    exact: weights are >= 0 and E, r finite, so a dead hop only ever added
//    +0.0. The gather loop is unrolled to 8 hops with predication, so all
//    of a lane's reads are in flight before any is used.
//  * The two legs meet by one shuffle, and a 16-lane shuffle tree takes the
//    first minimum by (cost, slot); a later tile replaces the best only if
//    strictly cheaper, so ties go to the lower slot as numpy's argmin does.
//
// Precision follows the reference: time and index math in double, the CI
// chain in float with full-precision cosf/expf (no --use_fast_math), sums
// in double. Built with --fmad=false, so each operation rounds as the plain
// torch version's does; only the order of the f64 sums differs from it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRateWarps = 8;
constexpr int kRateThreads = kRateWarps * 32;
constexpr int kRateRun = 16;                    // consecutive steps per lane
constexpr int kRateSeg = 32 * kRateRun;         // steps per CTA and round
constexpr int kRateStride = kRateRun + 1;       // staging row, padded
constexpr int kRateBlocksPerSm = 4;             // <= 64 registers a thread
constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kWeekendBit = 1 << 30;
constexpr int kSweepWarps = 4;                  // cells per CTA
constexpr int kSlotTile = 16;                   // slots per half-warp
constexpr int kHopUnroll = 8;                   // live hops gathered at once
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

// Below this magnitude every k * b that the two functions below form (k an
// integer, b 3600 or 24) is exact.
constexpr double kExactRange = 4503599627370496.0 / 4096.0;   // 2^40

// floordiv(a, b) for b > 0 without fmod: Python's floor division of
// floats is the floor of the exact quotient a / b. floor(a * (1 / b)) is
// within one of it, and two exact comparisons correct it.
__device__ __forceinline__ double floordiv_pos(double a, double b,
                                               double inv_b) {
  if (!(fabs(a) < kExactRange)) return floordiv(a, b);
  double k = floor(a * inv_b);
  if (k * b > a) {
    k -= 1.0;
  } else if ((k + 1.0) * b <= a) {
    k += 1.0;
  }
  return k == 0.0 ? copysign(0.0, a) : k;
}

// pymod(a, 24) without fmod: for a >= 0 it is a - 24 k with k the exact
// floor of a / 24, a difference that is exact (Sterbenz for k >= 1).
__device__ __forceinline__ double pymod24(double a) {
  if (!(a >= 0.0 && a < kExactRange)) return pymod(a, 24.0);
  return a - 24.0 * floordiv_pos(a, 24.0, 1.0 / 24.0);
}

__device__ __forceinline__ int hour_index(double t_rel, int w_hours) {
  return min(max((int)floordiv_pos(t_rel, 3600.0, 1.0 / 3600.0), 0),
             w_hours - 1);
}

// Stores steps [0, n) of a segment from a warp's staging buffer, where
// step s sits at (s / kRateRun) * kRateStride + s % kRateRun: V consecutive
// steps a lane, as one 16-byte store for V > 1 (n and the row's start a
// multiple of V then).
template <int V, typename T>
__device__ __forceinline__ void store_segment(T* __restrict__ row,
                                              const T* stage, int n,
                                              int lane) {
  static_assert(V == 1 || V * sizeof(T) == 16, "one 16-byte vector");
#pragma unroll
  for (int k = 0; k < kRateRun / V; ++k) {
    const int s = (k * 32 + lane) * V;
    if (s >= n) continue;
    const T* q = stage + (s / kRateRun) * kRateStride + s % kRateRun;
    if constexpr (V == 1) {
      row[s] = q[0];
    } else if constexpr (V == 4) {
      *reinterpret_cast<float4*>(row + s) = make_float4(q[0], q[1], q[2],
                                                        q[3]);
    } else {
      *reinterpret_cast<double2*>(row + s) = make_double2(q[0], q[1]);
    }
  }
}

// The two halves of a cluster barrier: memory operations before the arrive
// are visible to every CTA of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Hours of a noise row that one segment of kRateSeg steps can touch.
int noise_window(int w_hours, double dt_s) {
  const double span = fabs(dt_s) * (kRateSeg - 1) / 3600.0;
  if (!(span < (double)w_hours)) return w_hours;
  const int win = (int)span + 3;
  return win < w_hours ? win : w_hours;
}

int rate_cluster(int t_pad) {
  const int segs = (t_pad + kRateSeg - 1) / kRateSeg;
  return segs < kMaxCluster ? segs : kMaxCluster;
}

// Dynamic shared memory of rate_prefix_kernel: the per-step time math
// (hour | weekend, hour of day, dip exp), the staging buffers, the noise
// windows, the per-hop carries and the published segment totals.
size_t rate_smem_bytes(int n_hops, int w_hours, double dt_s) {
  return (size_t)kRateSeg * 3 * 4
         + (size_t)kRateWarps * 32 * kRateStride * sizeof(double)
         + (size_t)kRateWarps * 2 * noise_window(w_hours, dt_s) * 4
         + (size_t)n_hops * sizeof(double)
         + kRateWarps * sizeof(double);
}

// pp (A, H, 6) f32 [base, amp, dip, noise_amp, peak, band]; zn, hn (A, H, W)
// f32; rel0 (A,) f64; tc (5,) f64 [h_of_day0, day_frac_s, dow0, cal_a,
// cal_b] -> r (A, H, T) f32, e (A, H, T) f64 exclusive prefix of r.
// Grid (cluster, A): the cluster of one pair's CTAs runs along x.
__global__ void __launch_bounds__(kRateThreads, kRateBlocksPerSm)
rate_prefix_kernel(const float* __restrict__ pp, const float* __restrict__ zn,
                   const float* __restrict__ hn,
                   const double* __restrict__ rel0,
                   const double* __restrict__ tc, float* __restrict__ r_out,
                   double* __restrict__ e_out, int n_hops, int t_pad,
                   int w_hours, double dt_s, int n_win) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_stage = reinterpret_cast<double*>(smem);
  double* s_carry = s_stage + kRateWarps * 32 * kRateStride;
  double* s_tot = s_carry + n_hops;                 // [kRateWarps]
  int* s_hour = reinterpret_cast<int*>(s_tot + kRateWarps);
  float* s_hod = reinterpret_cast<float*>(s_hour + kRateSeg);
  float* s_ex = s_hod + kRateSeg;
  float* s_noise = s_ex + kRateSeg;                 // [warp][zn | hn][n_win]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_cta = (int)cluster.num_blocks();
  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double r0 = rel0[pair];
  const double h_of_day0 = tc[0], day_frac_s = tc[1];
  const int dow0 = (int)tc[2];
  const float cal_a = (float)tc[3], cal_b = (float)tc[4];
  const float two_pi = (float)(2.0 * 3.141592653589793);
  float* zn_w = s_noise + warp * 2 * n_win;
  float* hn_w = zn_w + n_win;
  double* stage = s_stage + warp * 32 * kRateStride;

  for (int h = tid; h < n_hops; h += kRateThreads) s_carry[h] = 0.0;
  const int n_rounds = (t_pad + n_cta * kRateSeg - 1) / (n_cta * kRateSeg);
  const int n_groups = (n_hops + kRateWarps - 1) / kRateWarps;
  // every row starts 16-byte aligned, and so does every segment
  const bool aligned = (t_pad & 3) == 0;
  int iter = 0;
  for (int round = 0; round < n_rounds; ++round) {
    const int t_seg = (round * n_cta + rank) * kRateSeg;
    const int n_steps = max(0, min(kRateSeg, t_pad - t_seg));
    // the hours this segment touches: the hour index is monotone in t
    int h_lo = 0, n_h = 0;
    if (n_steps > 0) {
      const int a = hour_index(r0 + dt_s * (double)t_seg, w_hours);
      const int b = hour_index(r0 + dt_s * (double)(t_seg + n_steps - 1),
                               w_hours);
      h_lo = min(a, b);
      n_h = max(a, b) - h_lo + 1;   // <= n_win by noise_window's bound
    }
    __syncthreads();  // the last round's readers of the time math are done
    // time math once per (pair, step), stored lane-major: step
    // lane * kRateRun + j sits at j * 32 + lane, so a warp reads one word
    // per bank
    for (int p = tid; p < kRateSeg; p += kRateThreads) {
      const int s = (p & 31) * kRateRun + (p >> 5);
      if (s >= n_steps) continue;
      // time and index math in double: hour boundaries land exactly
      const double t_rel = r0 + dt_s * (double)(t_seg + s);
      const int hour = hour_index(t_rel, w_hours);
      const float hod = (float)pymod24(h_of_day0 + t_rel / 3600.0);
      int dow = (dow0 + (int)floor((t_rel + day_frac_s) / 86400.0)) % 7;
      if (dow < 0) dow += 7;
      const float x = (hod - 13.0f) / 2.5f;
      s_hour[p] = hour | ((dow == 5 || dow == 6) ? kWeekendBit : 0);
      s_hod[p] = hod;
      s_ex[p] = expf(-0.5f * (x * x));
    }
    __syncthreads();
    for (int g = 0; g < n_groups; ++g, ++iter) {
      const int hop = g * kRateWarps + warp;
      const bool live = hop < n_hops && n_steps > 0;   // warp-uniform
      const size_t row = (size_t)pair * n_hops + hop;
      float* st_r = reinterpret_cast<float*>(stage) + lane * kRateStride;
      double incl = 0.0, seg_tot = 0.0;
      if (live) {
        for (int i = lane; i < n_h; i += 32) {
          zn_w[i] = zn[row * w_hours + h_lo + i];
          hn_w[i] = hn[row * w_hours + h_lo + i];
        }
        __syncwarp();
        const float* q = pp + row * 6;
        const float base = q[0], amp = q[1], dip = q[2];
        const float namp = q[3], peak = q[4];
        const float band_term = 1.0f + 0.02f * q[5];
        double lane_sum = 0.0;
#pragma unroll
        for (int j = 0; j < kRateRun; ++j) {
          const int at = j * 32 + lane;
          float r = 0.0f;
          if (lane * kRateRun + j < n_steps) {
            const int hw = s_hour[at];
            const int hi = (hw & ~kWeekendBit) - h_lo;
            // the CI value chain in float, in the plain version's order
            float v = base + amp * cosf(two_pi * (s_hod[at] - peak) / 24.0f);
            v = v - dip * s_ex[at];
            if (hw & kWeekendBit) v = v * 0.94f;
            v = v + namp * zn_w[hi];
            v = fmaxf(v, 1.0f);
            v = fmaxf(cal_a * v + cal_b, 0.5f);
            r = v * (band_term + 0.005f * hn_w[hi]);
          }
          st_r[j] = r;
          // r is rounded to float before it is widened and summed in double
          lane_sum += (double)r;
        }
        incl = lane_sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double y = __shfl_up_sync(kFullMask, incl, off);
          if (lane >= off) incl += y;
        }
        seg_tot = __shfl_sync(kFullMask, incl, 31);
      }
      // publish this segment's total to the cluster; the last iteration's
      // readers of the slot are done once its second barrier completes
      if (iter > 0) cluster_wait();
      if (lane == 0) s_tot[warp] = seg_tot;
      cluster_arrive();
      if (live) {  // r needs no carry: it goes out while the barrier runs
        __syncwarp();
        const float* stf = reinterpret_cast<const float*>(stage);
        float* r_row = r_out + row * t_pad + t_seg;
        if (aligned) {
          store_segment<4>(r_row, stf, n_steps, lane);
        } else {
          store_segment<1>(r_row, stf, n_steps, lane);
        }
      }
      cluster_wait();
      double before = 0.0, round_tot = 0.0;
      if (live) {
        // the totals of the pair's earlier segments in this round, and of
        // the whole round for the next one, summed in rank order by every
        // CTA alike; lane q reads rank q's
        const double v = lane < n_cta
            ? *cluster.map_shared_rank(s_tot + warp, lane) : 0.0;
        for (int q = 0; q < n_cta; ++q) {
          const double vq = __shfl_sync(kFullMask, v, q);
          if (q < rank) before += vq;
          round_tot += vq;
        }
      }
      cluster_arrive();  // this CTA is done reading the others' totals
      if (live) {
        float r[kRateRun];
#pragma unroll
        for (int j = 0; j < kRateRun; ++j) r[j] = st_r[j];
        const double carry = s_carry[hop];
        double excl = __shfl_up_sync(kFullMask, incl, 1);
        if (lane == 0) excl = 0.0;
        double run = (carry + before) + excl;
        __syncwarp();  // every lane holds its rates: E overwrites them
        double* st = stage + lane * kRateStride;
#pragma unroll
        for (int j = 0; j < kRateRun; ++j) {
          st[j] = run;
          run += (double)r[j];
        }
        __syncwarp();
        if (lane == 0) s_carry[hop] = carry + round_tot;
        double* e_row = e_out + row * t_pad + t_seg;
        if (aligned) {
          store_segment<2>(e_row, stage, n_steps, lane);
        } else {
          store_segment<1>(e_row, stage, n_steps, lane);
        }
        __syncwarp();  // the staging buffer and noise window are reused
      }
    }
  }
  cluster_wait();  // no CTA leaves while another may read its totals
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * kSweepWarps + warp;
  if (cell >= n_cells) return;  // whole warps only: shuffles stay full
  // per warp: each leg's live hops as (row, weight), in hop order
  double* s_w = reinterpret_cast<double*>(smem) + warp * 2 * n_hops;
  int* s_row = reinterpret_cast<int*>(reinterpret_cast<double*>(smem)
                                      + kSweepWarps * 2 * n_hops)
               + warp * 2 * n_hops;
  const double* row = sla + (size_t)cell * kCellCols;
  const double n_valid = row[2];
  double* out = best + (size_t)cell * 3;
  if (!(0 < n_slots && 0.0 < n_valid)) {  // no slot can be feasible
    if (lane == 0) {
      out[0] = INFINITY;
      out[1] = INFINITY;
      out[2] = 0.0;
    }
    return;
  }
  const int n = (int)row[0];
  const double rem = row[1], dur = row[3];
  const double wp = row[4], wc = row[5], budget = row[6], sub = row[7];
  const unsigned lt_mask = (1u << lane) - 1u;
  int n_live0 = 0, n_live1 = 0;
  for (int leg = 0; leg < 2; ++leg) {
    const int pair = pidx[2 * cell + leg];
    const double* w = wd + ((size_t)cell * 2 + leg) * n_hops;
    int cnt = 0;
    for (int h0 = 0; h0 < n_hops; h0 += 32) {
      const int h = h0 + lane;
      const double wh = h < n_hops ? w[h] : 0.0;
      const bool keep = h < n_hops && wh != 0.0;
      const unsigned ball = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int at = leg * n_hops + cnt + __popc(ball & lt_mask);
        s_row[at] = pair * n_hops + h;
        s_w[at] = wh;
      }
      cnt += __popc(ball);
    }
    (leg == 0 ? n_live0 : n_live1) = cnt;
  }
  __syncwarp();
  const int leg = lane >> 4;
  const int sl = lane & (kSlotTile - 1);
  const int cnt = leg == 0 ? n_live0 : n_live1;
  const int* rows = s_row + leg * n_hops;
  const double* ws = s_w + leg * n_hops;
  const double* scl_row = scl + (size_t)pidx[2 * cell + leg] * n_slots;

  double b_cost = INFINITY, b_emis = INFINITY;
  int b_slot = 0;
  for (int s0 = 0; s0 < n_slots && (double)s0 < n_valid; s0 += kSlotTile) {
    const int s = s0 + sl;
    const bool valid = s < n_slots && (double)s < n_valid;
    double g = 0.0;
    if (valid) {
      const int k = s * stride;
      // valid slots satisfy k + n - 1 <= T - 1 by grid construction; the
      // clamps only tame rows of cells that are not
      const int hi = min(max(k + n - 1, 0), t_pad - 1);
      const int kc = min(k, t_pad - 1);
      double eh[kHopUnroll], ek[kHopUnroll];
      float rh[kHopUnroll];
#pragma unroll
      for (int j = 0; j < kHopUnroll; ++j) {
        if (j < cnt) {
          const size_t rb = (size_t)rows[j] * t_pad;
          eh[j] = __ldg(e + rb + hi);
          ek[j] = __ldg(e + rb + kc);
          rh[j] = __ldg(r + rb + hi);
        }
      }
      double seg_w = 0.0, last_w = 0.0;
#pragma unroll
      for (int j = 0; j < kHopUnroll; ++j) {
        if (j < cnt) {
          seg_w += ws[j] * (eh[j] - ek[j]);
          last_w += ws[j] * (double)rh[j];
        }
      }
      for (int j = kHopUnroll; j < cnt; ++j) {
        const size_t rb = (size_t)rows[j] * t_pad;
        seg_w += ws[j] * (__ldg(e + rb + hi) - __ldg(e + rb + kc));
        last_w += ws[j] * (double)__ldg(r + rb + hi);
      }
      const double leg_g = (seg_w * dt_s + last_w * rem) / 3.6e6;
      g = leg_g * scl_row[s];
    }
    // the legs meet: (0 + leg 0) + leg 1, the plain version's order
    const double other = __shfl_xor_sync(kFullMask, g, kSlotTile);
    double emis = leg == 0 ? (0.0 + g) + other : (0.0 + other) + g;
    // numpy's op order for the perf term: (sub + slot_s*k + dur) - sub
    const double ts = sub + slot_s * (double)s;
    double cost = wc * emis + wp * ((ts + dur) - sub);
    if (!(valid && emis <= budget)) {
      cost = INFINITY;
      emis = INFINITY;
    }
    int slot = s;
    // first minimum by (cost, slot) over the tile's 16 slots; both halves
    // of the warp hold the same values and reduce alike
#pragma unroll
    for (int off = kSlotTile / 2; off > 0; off >>= 1) {
      const double oc = __shfl_xor_sync(kFullMask, cost, off);
      const double oe = __shfl_xor_sync(kFullMask, emis, off);
      const int os = __shfl_xor_sync(kFullMask, slot, off);
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
    out[0] = b_cost;
    out[1] = b_emis;
    out[2] = (double)b_slot;
  }
}

size_t sweep_smem_bytes(int n_hops) {
  return (size_t)kSweepWarps * 2 * n_hops * (sizeof(double) + sizeof(int));
}

}  // namespace

extern "C" {

int planner_rate_prefix(const float* pp, const float* zn, const float* hn,
                        const double* rel0, const double* tc, float* r,
                        double* e, int n_pairs, int n_hops, int t_pad,
                        int w_hours, double dt_s, void* stream) {
  const size_t smem = rate_smem_bytes(n_hops, w_hours, dt_s);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rate_prefix_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_cta = rate_cluster(t_pad);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cta, n_pairs, 1);
  cfg.blockDim = dim3(kRateThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rate_prefix_kernel, pp, zn, hn, rel0, tc, r,
                           e, n_hops, t_pad, w_hours, dt_s,
                           noise_window(w_hours, dt_s));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int planner_sweep(const double* e, const float* r, const double* scl,
                  const int* pidx, const double* wd, const double* sla,
                  double* best, int n_cells, int n_hops, int t_pad,
                  int n_slots, int stride, double dt_s, double slot_s,
                  void* stream) {
  const int blocks = (n_cells + kSweepWarps - 1) / kSweepWarps;
  const size_t smem = sweep_smem_bytes(n_hops);
  sweep_kernel<<<blocks, kSweepWarps * 32, smem, (cudaStream_t)stream>>>(
      e, r, scl, pidx, wd, sla, best, n_cells, n_hops, t_pad, n_slots,
      stride, dt_s, slot_s);
  return (int)cudaGetLastError();
}

// The dynamic shared memory each kernel launches with, for reports.
int planner_rate_prefix_smem_bytes(int n_hops, int w_hours, double dt_s) {
  return (int)rate_smem_bytes(n_hops, w_hours, dt_s);
}

int planner_sweep_smem_bytes(int n_hops) {
  return (int)sweep_smem_bytes(n_hops);
}

const char* planner_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
