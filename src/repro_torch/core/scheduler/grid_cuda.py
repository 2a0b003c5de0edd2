"""Fused planner kernels on Hopper: the admission sweep in two CUDA kernels
(``TorchCarbonPlanner(batch_backend="fused")``).

The counterpart of the reference's ``grid_pallas.py``. The lattice path
(:func:`grid_torch.batch_cell_emissions`) materializes a full ``(C, 2, S)``
emission tensor and leaves the per-cell feasible-argmin to the host; here
the whole per-cell chain — CI evaluation, f64 prefix-sum accumulation over
the rate grid, the per-(anchor, path) gather, SLA masking and the per-cell
argmin over start slots — runs on the card, so only three scalars per cell
(best cost / emissions / slot) come back.

Two kernels, in ``repro_torch/csrc/planner_kernels.cu`` (built with
``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch_kernels/``
and bound through ``ctypes``):

* :func:`rate_prefix` — device-CI rates per (anchor, path) pair x hop x
  grid step, and their exclusive f64 prefix along time (replaces
  ``grid_pallas._rate_prefix_kernel``). A thread-block cluster per pair
  splits the time axis into 512-step segments, and each CTA reads the
  other segments' per-hop totals from their shared memory; the time math
  is shared by the pair's hops, and each lane sums a run of 16 steps;
* :func:`sweep` — per cell x start slot: prefix gathers for both legs,
  drift scale, SLA mask, first-min argmin over slots (replaces
  ``grid_pallas._sweep_kernel``). One warp per cell, half-warps over the
  two legs of 16 slots, only the hops with a non-zero weight and the slots
  before ``n_valid`` gathered.

Each wrapper takes its plain torch version (:func:`rate_prefix_plain`,
:func:`sweep_plain`) only for CPU tensors; on CUDA tensors it launches
its kernel or raises. ``wrapper.launches`` counts kernel launches.
Equivalence with the numpy ``plan_batch`` oracle (same cells, emissions
<= 1e-4 relative) is pinned by the port's tests.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._build import KernelSource, load
from repro_torch._device import resolve_device
from repro_torch.core.carbon.field import CarbonField
from repro_torch.core.carbon.path import NetworkPath
from repro_torch.core.scheduler.grid_torch import (
    HOP_NOISE_F32, BAND_F32, TWO_PI_F32, WEEKEND_F32, _B_CELLS, CellTask,
    ChunkTables, DeviceTables, _chunk_tables, _iter_chunks, tables_to_device,
    true_div)

# pairs*hops*grid budget per chunk: the reference's, so chunk boundaries
# (and with them the floats) match it
_MAX_ELEMS_PALLAS = 2 * 1024 * 1024

# per-cell f64 row fed to the sweep kernel: [n_steps, rem_s, n_valid,
# dur_s, w_perf/slack, w_carbon, budget_g, submitted_t]
_CELL_COLS = 8

# no fast math: the CI chain needs full-precision cosf/expf, and no FMA
# contraction keeps each op rounded as in the plain torch version
_SOURCE = KernelSource("planner_kernels", ("--fmad=false",))


# --- build and bind ----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = load(_SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.planner_rate_prefix.argtypes = [ptr] * 7 + [i32] * 4 + [f64, ptr]
    lib.planner_rate_prefix.restype = i32
    lib.planner_sweep.argtypes = [ptr] * 7 + [i32] * 5 + [f64, f64, ptr]
    lib.planner_sweep.restype = i32
    lib.planner_rate_prefix_smem_bytes.argtypes = [i32, i32, f64]
    lib.planner_rate_prefix_smem_bytes.restype = i32
    lib.planner_sweep_smem_bytes.argtypes = [i32]
    lib.planner_sweep_smem_bytes.restype = i32
    lib.planner_error_string.argtypes = [i32]
    lib.planner_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if (x.dtype == dtype and x.shape == shape and x.is_contiguous()
            and x.device == device):
        return
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, dev: torch.device, *args) -> int:
    """Call a library entry point with ``args`` and ``dev``'s current
    stream (its raw handle: no ``Stream`` object is built per call),
    switching the current device only when it is another."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _library().planner_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


# --- kernel 1: rates and their exclusive f64 prefix -------------------------

def rate_prefix_plain(pp: torch.Tensor, zn: torch.Tensor, hn: torch.Tensor,
                      rel0: torch.Tensor, tc: torch.Tensor, *, dt_s: float,
                      t_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`rate_prefix`: the same dtypes and the
    same order of operations, one op per step."""
    w_hours = zn.shape[2]
    h_of_day0, day_frac_s, dow0, cal_a, cal_b = tc.tolist()
    t_idx = torch.arange(t_pad, dtype=torch.float64, device=pp.device)
    t_rel = rel0[:, None, None] + dt_s * t_idx                  # (A,1,T) f64
    hour = torch.div(t_rel, 3600.0, rounding_mode="floor").long() \
        .clamp(0, w_hours - 1)
    hod = ((h_of_day0 + true_div(t_rel, 3600.0)) % 24.0).float()
    dow = (int(dow0)
           + torch.floor(true_div(t_rel + day_frac_s, 86400.0)).long()) % 7
    base, amp, dip = pp[:, :, 0:1], pp[:, :, 1:2], pp[:, :, 2:3]
    namp, peak, band = pp[:, :, 3:4], pp[:, :, 4:5], pp[:, :, 5:6]
    v = base + amp * torch.cos(true_div(TWO_PI_F32 * (hod - peak), 24.0))
    v = v - dip * torch.exp(-0.5 * true_div(hod - 13.0, 2.5) ** 2)
    v = torch.where((dow == 5) | (dow == 6), v * WEEKEND_F32, v)
    hb = hour.expand(v.shape)
    v = v + namp * torch.gather(zn, 2, hb)
    v = torch.clamp_min(v, 1.0)
    v = torch.clamp_min(float(np.float32(cal_a)) * v
                        + float(np.float32(cal_b)), 0.5)
    r = v * (1.0 + BAND_F32 * band + HOP_NOISE_F32 * torch.gather(hn, 2, hb))
    r64 = r.double()
    return r, torch.cumsum(r64, dim=2) - r64


def rate_prefix(pp: torch.Tensor, zn: torch.Tensor, hn: torch.Tensor,
                rel0: torch.Tensor, tc: torch.Tensor, *, dt_s: float,
                t_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-CI rates and their exclusive f64 prefix over the time axis.

    Inputs per (pair, hop) row: ``pp`` (A, H, 6) f32 [base, amp, dip,
    noise_amp, peak, band]; ``zn``/``hn`` (A, H, W) f32 hourly zone/hop
    noise; ``rel0`` (A,) f64 anchor-relative start; ``tc`` (5,) f64
    [h_of_day0, day_frac_s, dow0, cal_a, cal_b]. Returns ``r`` (A, H, T)
    f32 and the exclusive prefix ``E`` (A, H, T) f64 of ``r`` widened.
    """
    if pp.device.type == "cpu":
        return rate_prefix_plain(pp, zn, hn, rel0, tc, dt_s=dt_s,
                                 t_pad=t_pad)
    dev = pp.device
    if dev.type != "cuda":
        raise ValueError(f"rate_prefix runs on cuda or cpu, not {dev}")
    a, h, w = zn.shape
    _check("pp", pp, torch.float32, (a, h, 6), dev)
    _check("zn", zn, torch.float32, (a, h, w), dev)
    _check("hn", hn, torch.float32, (a, h, w), dev)
    _check("rel0", rel0, torch.float64, (a,), dev)
    _check("tc", tc, torch.float64, (5,), dev)
    r = torch.empty((a, h, t_pad), dtype=torch.float32, device=dev)
    e = torch.empty((a, h, t_pad), dtype=torch.float64, device=dev)
    if r.numel() == 0:
        return r, e
    err = _launch(_library().planner_rate_prefix, dev,
                  pp.data_ptr(), zn.data_ptr(), hn.data_ptr(),
                  rel0.data_ptr(), tc.data_ptr(), r.data_ptr(), e.data_ptr(),
                  a, h, t_pad, w, float(dt_s))
    _raise_on(err, "rate_prefix")
    rate_prefix.launches += 1
    return r, e


rate_prefix.launches = 0


# --- kernel 2: gather, SLA mask, first-min argmin over slots ----------------

def sweep_plain(e: torch.Tensor, r: torch.Tensor, scl: torch.Tensor,
                pidx: torch.Tensor, wd: torch.Tensor, sla: torch.Tensor, *,
                stride: int, dt_s: float, slot_s: float) -> torch.Tensor:
    """Plain torch version of :func:`sweep` over the whole (cell, slot)
    table at once; ``torch.argmin`` returns the first minimum, as the
    kernel's (cost, slot) order does."""
    a, h_hops, t_pad = e.shape
    dev = e.device
    s_pad = scl.shape[1]
    slots = torch.arange(s_pad, device=dev)
    n = sla[:, 0].long()
    rem, nval, dur = sla[:, 1], sla[:, 2], sla[:, 3]
    wp, wc, budget, sub = sla[:, 4], sla[:, 5], sla[:, 6], sla[:, 7]
    k = slots * stride                                         # (S,)
    hi = (k[None, :] + n[:, None] - 1).clamp(0, t_pad - 1)     # (C,S)
    kc = k.clamp(max=t_pad - 1)
    p = pidx.long()                                            # (C,2)
    hh = torch.arange(h_hops, device=dev)
    rowbase = (p[:, :, None] * h_hops + hh[None, None, :]) * t_pad
    e_flat, r_flat = e.reshape(-1), r.reshape(-1)
    idx_hi = rowbase[..., None] + hi[:, None, None, :]         # (C,2,H,S)
    seg = e_flat[idx_hi] - e_flat[rowbase[..., None] + kc]
    last = r_flat[idx_hi].double()
    leg = true_div((wd[..., None] * seg).sum(dim=2) * dt_s
                   + (wd[..., None] * last).sum(dim=2) * rem[:, None, None],
                   3.6e6)
    emis = (leg * scl[p]).sum(dim=1)                           # (C,S)
    ts = sub[:, None] + slot_s * slots.double()[None, :]
    cost = wc[:, None] * emis + wp[:, None] * ((ts + dur[:, None])
                                               - sub[:, None])
    feas = (slots.double()[None, :] < nval[:, None]) & (emis <= budget[:, None])
    cost = torch.where(feas, cost, torch.inf)
    j = torch.argmin(cost, dim=1)
    c_best = cost.gather(1, j[:, None])[:, 0]
    found = c_best < torch.inf
    e_best = torch.where(found, emis.gather(1, j[:, None])[:, 0], torch.inf)
    return torch.stack([c_best, e_best, torch.where(found, j, 0).double()],
                       dim=1)


def sweep(e: torch.Tensor, r: torch.Tensor, scl: torch.Tensor,
          pidx: torch.Tensor, wd: torch.Tensor, sla: torch.Tensor, *,
          stride: int, dt_s: float, slot_s: float) -> torch.Tensor:
    """Per cell: the first start slot minimizing the SLA cost among the
    feasible ones. Returns (C, 3) f64 [cost, emissions, slot]; an
    all-infeasible cell gives [+inf, +inf, 0].

    Inputs: ``e``/``r`` from :func:`rate_prefix`; ``scl`` (A, S) f64
    drift-scale table; ``pidx`` (C, 2) i32 cell -> pair rows, each in
    [0, A) (``tables_to_device`` checks this on the host, so the kernel
    does not); ``wd`` (C, 2, H) f64 device-power weights; ``sla`` (C, 8)
    f64 rows (see ``_CELL_COLS``).
    """
    if e.device.type == "cpu":
        return sweep_plain(e, r, scl, pidx, wd, sla, stride=stride,
                           dt_s=dt_s, slot_s=slot_s)
    dev = e.device
    if dev.type != "cuda":
        raise ValueError(f"sweep runs on cuda or cpu, not {dev}")
    a, h, t_pad = e.shape
    c, s_pad = pidx.shape[0], scl.shape[1]
    _check("e", e, torch.float64, (a, h, t_pad), dev)
    _check("r", r, torch.float32, (a, h, t_pad), dev)
    _check("scl", scl, torch.float64, (a, s_pad), dev)
    _check("pidx", pidx, torch.int32, (c, 2), dev)
    _check("wd", wd, torch.float64, (c, 2, h), dev)
    _check("sla", sla, torch.float64, (c, _CELL_COLS), dev)
    best = torch.empty((c, 3), dtype=torch.float64, device=dev)
    if c == 0:
        return best
    err = _launch(_library().planner_sweep, dev,
                  e.data_ptr(), r.data_ptr(), scl.data_ptr(), pidx.data_ptr(),
                  wd.data_ptr(), sla.data_ptr(), best.data_ptr(), c, h, t_pad,
                  s_pad, int(stride), float(dt_s), float(slot_s))
    _raise_on(err, "sweep")
    sweep.launches += 1
    return best


sweep.launches = 0


# --- one chunk: host tables -> kernel inputs -> per-cell winners -------------

@dataclasses.dataclass
class FusedInputs:
    """The two kernels' inputs for one chunk, on one device."""
    pp: torch.Tensor                   # (A, H, 6) f32
    zn: torch.Tensor                   # (A, H, W) f32
    hn: torch.Tensor                   # (A, H, W) f32
    rel0: torch.Tensor                 # (A,) f64
    tc: torch.Tensor                   # (5,) f64
    scl: torch.Tensor                  # (A, S) f64
    pidx: torch.Tensor                 # (C, 2) i32
    wd: torch.Tensor                   # (C, 2, H) f64
    sla: torch.Tensor                  # (C, 8) f64
    t_pad: int


def scale_table(tables: ChunkTables, slot_s: float,
                scale_fn: Optional[Callable[[NetworkPath, np.ndarray],
                                            np.ndarray]]) -> np.ndarray:
    """The drift-scale hook evaluated host-side into an (A, S) table: a
    pair's slot times are anchor + slot_s * k, the same floats the numpy
    path hands ``emission_scale_fn`` per job."""
    a_pad, s_pad = tables.path_idx.shape[0], tables.n_slots_pad
    scl = np.ones((a_pad, s_pad))
    if scale_fn is not None:
        for a in range(tables.n_pairs):
            ts = tables.pair_anchors[a] + slot_s * np.arange(s_pad)
            scl[a] = scale_fn(tables.pair_paths[a], ts)
    return scl


def sla_table(tables: ChunkTables, sla_rows: np.ndarray) -> np.ndarray:
    """(C_pad, 8) per-cell rows; pad cells get n_valid = 0, so every slot
    masks to +inf and the pads never win."""
    sla = np.zeros((tables.pair_idx.shape[0], _CELL_COLS))
    sla[:, 0] = tables.n_steps                          # pads: 1
    sla[:, 1] = tables.rem                              # pads: 0
    sla[:, 6] = np.inf                                  # pads: no budget
    sla[:len(sla_rows), 2:] = sla_rows
    return sla


def fused_inputs(d: DeviceTables, sla: np.ndarray,
                 scl: np.ndarray) -> FusedInputs:
    """Gather the per-zone parameters onto (pair, hop) rows: the rate
    kernel evaluates device CI directly, with no (anchor x zone) lattice
    detour."""
    dev = d.znoise.device
    zid = d.zone_idx[d.path_idx]                        # (A, H)
    pp = torch.cat([d.zcols[:, zid].permute(1, 2, 0),
                    d.band[d.path_idx][..., None]], dim=2).contiguous()
    return FusedInputs(
        pp=pp, zn=d.znoise[zid].contiguous(),
        hn=d.hnoise[d.path_idx].contiguous(),
        rel0=d.rel0a[d.anchor_idx].contiguous(), tc=d.tc,
        scl=torch.as_tensor(scl, dtype=torch.float64, device=dev),
        pidx=d.pair_idx, wd=d.w_dev,
        sla=torch.as_tensor(sla, dtype=torch.float64, device=dev),
        t_pad=d.n_grid_pad)


def fused_best(x: FusedInputs, *, dt_s: float, stride: int,
               slot_s: float) -> torch.Tensor:
    """Both kernels on one chunk: (C_pad, 3) f64 [cost, emis, slot]."""
    r, e = rate_prefix(x.pp, x.zn, x.hn, x.rel0, x.tc, dt_s=dt_s,
                       t_pad=x.t_pad)
    return sweep(e, r, x.scl, x.pidx, x.wd, x.sla, stride=stride,
                 dt_s=dt_s, slot_s=slot_s)


def batch_cell_best(field: CarbonField, cells: Sequence[CellTask],
                    sla_rows: Sequence[Sequence[float]], *,
                    dt_s: float = 60.0, slot_stride: int = 60,
                    slot_s: float = 3600.0,
                    scale_fn: Optional[Callable[[NetworkPath, np.ndarray],
                                                np.ndarray]] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused admission sweep: the winning (cost, emissions, slot) of every
    cell, computed in the two kernels — the ``(C, 2, S)`` emission tensor
    the lattice path materializes never exists.

    ``sla_rows`` carries one ``[n_valid, dur_s, w_perf/slack, w_carbon,
    budget_g, submitted_t]`` row per cell (``n_valid`` = the count of
    deadline-feasible leading slots, computed host-side because that mask
    is monotone in the slot index; ``budget_g`` = +inf when the SLA has no
    carbon budget). ``scale_fn`` is the planner's ``emission_scale_fn``
    drift hook, evaluated host-side into a per-(anchor, path) slot table.

    Returns ``(cost, emis, slot)`` arrays over cells; ``cost = +inf``
    means no feasible slot (the caller falls back per job). Runs on
    ``device`` (``cuda`` unless given); on ``cpu`` the kernels' plain
    versions run instead.
    """
    dev = resolve_device(device)
    sla_rows = np.asarray(sla_rows, dtype=np.float64)
    if sla_rows.shape != (len(cells), 6):
        raise ValueError(f"sla_rows must be (n_cells, 6), got "
                         f"{sla_rows.shape}")
    cost = np.full(len(cells), np.inf)
    emis = np.full(len(cells), np.inf)
    slot = np.zeros(len(cells), dtype=np.int64)
    for chunk in _iter_chunks(cells, slot_stride, _MAX_ELEMS_PALLAS):
        t = _chunk_tables(field, [cells[j] for j in chunk], dt_s=dt_s,
                          slot_stride=slot_stride, cell_bucket=_B_CELLS)
        x = fused_inputs(tables_to_device(t, dev),
                         sla_table(t, sla_rows[chunk]),
                         scale_table(t, slot_s, scale_fn))
        best = fused_best(x, dt_s=dt_s, stride=slot_stride,
                          slot_s=slot_s)[:len(chunk)].cpu().numpy()
        idx = np.asarray(chunk, dtype=np.int64)
        cost[idx] = best[:, 0]
        emis[idx] = best[:, 1]
        slot[idx] = best[:, 2].astype(np.int64)
    return cost, emis, slot
