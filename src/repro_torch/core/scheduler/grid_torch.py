"""Planner grid scoring on torch: the fleet lattice and the per-leg scorer.

The counterpart of the reference's ``grid_jax.py``. Its fleet scorer
(``batch_cell_emissions``): the (job x FTN x replica x slot) grids of many
jobs are padded/masked into one stacked cell table (the numpy builder
below, copied from the reference) and scored with plain torch ops on the
planner's device. This is the ``batch_backend="torch"`` path and the one
``TorchCarbonPlanner.rescore_batch`` uses for large sweeps; the fused
CUDA kernels of ``grid_cuda`` consume the same tables; with ``shard`` its
cell axis splits over devices (:class:`MeshConfig`, the reference's
``shard_map``). Its per-leg scorer
(:class:`TorchGridScorer`, the reference's ``JaxGridScorer``) scores all
start slots of one leg for ``plan()`` and ``rescore()`` with
``backend="torch"``, on the ``make_window`` / ``window_ci_torch`` view.

Layer contract: **numpy is the pinned oracle**. Both paths recompute
what ``CarbonField.transfer_emissions_g`` defines, with the reference's
precision split: time and index math in f64 (hour boundaries and
day-of-week flips land exactly where numpy puts them), the CI value chain
in f32, prefix sums accumulated in f64 (~1e-7 relative to the oracle).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.carbon.energy import HostPowerModel
from repro_torch.core.carbon.field import (TWO_PI_F32, WEEKEND_F32,
                                           CarbonField, CarbonWindow,
                                           default_field, make_window,
                                           true_div, window_ci_torch,
                                           window_to)
from repro_torch.core.carbon.intensity import REGIONS, get_calibration
from repro_torch.core.carbon.path import NetworkPath
from repro_torch.runtime.pspec import HostMesh

_WINDOW_HOURS = 24 * 14                # per-anchor horizon (2 weeks)
_GRID_BUCKET = 512                     # rate-grid length rounding

# --- fleet-batched scoring -------------------------------------------------
#
# One call scores every (job, FTN, replica) cell of a whole fleet: ragged
# per-job grids are padded/masked into rectangular tables, a stacked
# (anchor, path) axis carries the per-hop CI grids, and a batch dimension
# over the job-cell axis turns prefix-sum gathers into per-cell emission
# rows.

_B_PAIRS = 64                          # (anchor, path) axis bucket
_B_CELLS = 64                          # job-cell axis bucket
_B_SLOTS = 16                          # start-slot axis bucket
_B_HOURS = 168                         # window-hours bucket (one week)
_B_ZONES = 8                           # zone axis bucket
_MAX_GRID = 1 << 15                    # per-cell rate-grid cap (~22 days)
_MAX_ELEMS = 32 * 1024 * 1024          # pairs*hops*grid budget per call


@dataclasses.dataclass(frozen=True)
class LegTask:
    """One leg of one grid cell: a path plus its device-power weights."""
    path: NetworkPath
    anchor: float                      # grid anchor (the job's first slot)
    w_dev: np.ndarray                  # (n_hops,) device power draw, W


@dataclasses.dataclass(frozen=True)
class CellTask:
    """One (job, FTN, replica) cell: 1–2 legs sharing a slot/step layout."""
    legs: Tuple[LegTask, ...]
    n_slots: int                       # candidate starts: anchor + k*slot
    n_steps: int                       # dt_s steps per transfer
    rem_s: float                       # pro-rated final-step seconds


def _round_up(n: int, b: int) -> int:
    return int(math.ceil(max(n, 1) / b)) * b


def _iter_chunks(cells: Sequence[CellTask], slot_stride: int,
                 max_elems: int) -> Iterator[List[int]]:
    """Split a fleet of cells into anchor-sorted chunks whose
    pairs*hops*grid element count stays under ``max_elems`` (pathological
    fleets with thousands of distinct anchors would otherwise materialize
    a multi-GB CI grid in one call). Yields lists of original indices —
    shared by the torch lattice path and the fused CUDA path, so both see
    identical chunk boundaries for a given budget (and the same as the
    reference's for the same budget)."""
    order = sorted(range(len(cells)),
                   key=lambda i: cells[i].legs[0].anchor)
    i = 0
    while i < len(order):
        chunk: List[int] = []
        pairs: Dict[Tuple, None] = {}
        grid_max = hops_max = 0
        while i < len(order):
            c = cells[order[i]]
            trial = dict(pairs)
            for leg in c.legs:
                # discover_path memoizes paths: identity is a stable key
                trial.setdefault((leg.anchor, id(leg.path)), None)
            g = max(grid_max, (c.n_slots - 1) * slot_stride + c.n_steps)
            h = max(hops_max, max(leg.path.n_hops for leg in c.legs))
            if chunk and len(trial) * h * g > max_elems:
                break
            pairs, grid_max, hops_max = trial, g, h
            chunk.append(order[i])
            i += 1
        yield chunk



@dataclasses.dataclass
class ChunkTables:
    """Host-built padded tables for one anchor-sorted chunk of cells.

    One builder serves both fleet scorers: the torch lattice
    (:func:`batch_cell_emissions`) and the fused CUDA kernels
    (``grid_cuda``) consume the same arrays, so padding/masking
    semantics — zero-weight pad hops, ``n_steps=1`` pad cells, bucketed
    axis lengths — are defined exactly once. A copy of the reference's
    numpy builder: the two agree array for array.
    """
    zcols: Tuple[np.ndarray, ...]      # base/amp/dip/namp/peak (n_z,) f32
    znoise: np.ndarray                 # (n_z, hours) f32, pre-scaled
    cal_a: np.float32
    cal_b: np.float32
    h_of_day0: float                   # t0w-derived traced time constants
    day_frac_s: float
    dow0: int
    zone_idx: np.ndarray               # (n_p, n_hops) i32
    band: np.ndarray                   # (n_p, n_hops) f32
    hnoise: np.ndarray                 # (n_p, n_hops, hours) f32
    rel0a: np.ndarray                  # (n_anch,) f64, anchor - t0w
    anchor_idx: np.ndarray             # (n_a,) i32 pair -> anchor row
    path_idx: np.ndarray               # (n_a,) i32 pair -> path row
    pair_idx: np.ndarray               # (n_c, 2) i32 cell -> pair rows
    w_dev: np.ndarray                  # (n_c, 2, n_hops) f64
    n_steps: np.ndarray                # (n_c,) i32 (pads: 1)
    rem: np.ndarray                    # (n_c,) f64 (pads: 0)
    n_grid_pad: int
    n_slots_pad: int
    n_hops: int
    n_pairs: int                       # live (anchor, path) pairs
    pair_paths: List[NetworkPath]      # per live pair, kernel row order
    pair_anchors: List[float]          # per live pair, kernel row order


def _chunk_tables(field: CarbonField, cells: Sequence[CellTask], *,
                  dt_s: float, slot_stride: int,
                  cell_bucket: int) -> ChunkTables:
    # --- dedupe (anchor, path) pairs and paths ----------------------------
    paths: Dict[Tuple, int] = {}
    path_objs: List[NetworkPath] = []
    anchors: Dict[float, int] = {}
    pair_ids: Dict[Tuple, int] = {}
    pair_path: List[int] = []
    pair_anchor: List[int] = []
    n_grid = 1
    for c in cells:
        n_grid = max(n_grid, (c.n_slots - 1) * slot_stride + c.n_steps)
        for leg in c.legs:
            pk = id(leg.path)          # memoized paths: identity is stable
            if pk not in paths:
                paths[pk] = len(path_objs)
                path_objs.append(leg.path)
            if leg.anchor not in anchors:
                anchors[leg.anchor] = len(anchors)
            ak = (leg.anchor, pk)
            if ak not in pair_ids:
                pair_ids[ak] = len(pair_path)
                pair_path.append(paths[pk])
                pair_anchor.append(anchors[leg.anchor])
    n_hops = max(p.n_hops for p in path_objs)
    n_slots = max(c.n_slots for c in cells)
    zones = sorted({h.zone for p in path_objs for h in p.hops})
    # --- window: one hour-aligned anchor covering every pair's grid -------
    t0w = 3600.0 * math.floor(min(anchors) / 3600.0)
    t_end = max(a + n_grid * dt_s for a in anchors)
    hours = _round_up(int(math.ceil((t_end - t0w) / 3600.0)) + 1, _B_HOURS)
    hour0 = int(t0w // 3600.0)
    hour_idx = np.arange(hour0, hour0 + hours)
    n_z = _round_up(len(zones), _B_ZONES)
    znoise = np.zeros((n_z, hours), dtype=np.float32)
    for zi_, z in enumerate(zones):
        znoise[zi_] = (field._zone_noise.lookup(z, hour_idx) - 0.5) * 2.0
    regs = [REGIONS[z] for z in zones]

    def _zcol(attr):
        col = np.zeros(n_z, dtype=np.float32)
        col[:len(regs)] = [getattr(r, attr) for r in regs]
        return col

    cal_a, cal_b = get_calibration()
    # --- per-path hop tables (padded to n_hops; pads weigh 0) -------------
    n_p = _round_up(len(path_objs), 2)
    zone_idx = np.zeros((n_p, n_hops), dtype=np.int32)
    band = np.zeros((n_p, n_hops), dtype=np.float32)
    hnoise = np.zeros((n_p, n_hops, hours), dtype=np.float32)
    for pi, p in enumerate(path_objs):
        for hi_, h in enumerate(p.hops):
            zone_idx[pi, hi_] = zones.index(h.zone)
            band[pi, hi_] = field._hop_band(h.ip)
            hnoise[pi, hi_] = field._hop_noise.lookup(h.ip, hour_idx) - 0.5
    # --- anchor, pair and cell tables -------------------------------------
    n_anch = _round_up(len(anchors), 32)
    rel0a = np.zeros(n_anch)
    rel0a[:len(anchors)] = np.fromiter(anchors, dtype=np.float64,
                                       count=len(anchors)) - t0w
    n_a = _round_up(len(pair_path), _B_PAIRS)
    path_idx = np.zeros(n_a, dtype=np.int32)
    path_idx[:len(pair_path)] = pair_path
    anchor_idx = np.zeros(n_a, dtype=np.int32)
    anchor_idx[:len(pair_anchor)] = pair_anchor
    n_c = _round_up(len(cells), cell_bucket)
    pair_idx = np.zeros((n_c, 2), dtype=np.int32)
    w_dev = np.zeros((n_c, 2, n_hops))
    n_steps = np.ones(n_c, dtype=np.int32)
    rem = np.zeros(n_c)
    for ci_, c in enumerate(cells):
        for li, leg in enumerate(c.legs):
            pair_idx[ci_, li] = pair_ids[(leg.anchor, id(leg.path))]
            w_dev[ci_, li, :leg.path.n_hops] = leg.w_dev
        n_steps[ci_] = c.n_steps
        rem[ci_] = c.rem_s
    inv_pair: List[Optional[Tuple[float, int]]] = [None] * len(pair_ids)
    for (anchor, _pk), row in pair_ids.items():
        inv_pair[row] = (anchor, pair_path[row])
    return ChunkTables(
        zcols=tuple(_zcol(a) for a in ("base_ci", "diurnal_amp",
                                       "solar_dip", "noise", "peak_hour")),
        znoise=znoise, cal_a=np.float32(cal_a), cal_b=np.float32(cal_b),
        h_of_day0=(t0w / 3600.0) % 24.0,
        day_frac_s=t0w - 86400.0 * math.floor(t0w / 86400.0),
        dow0=int(t0w // 86400.0) % 7,
        zone_idx=zone_idx, band=band, hnoise=hnoise, rel0a=rel0a,
        anchor_idx=anchor_idx, path_idx=path_idx, pair_idx=pair_idx,
        w_dev=w_dev, n_steps=n_steps, rem=rem,
        n_grid_pad=_round_up(n_grid, _GRID_BUCKET),
        n_slots_pad=_round_up(n_slots, _B_SLOTS),
        n_hops=n_hops, n_pairs=len(pair_ids),
        pair_paths=[path_objs[p] for _, p in inv_pair],
        pair_anchors=[a for a, _ in inv_pair])



# the hop band's f32 constants (the zone chain's are in ``field``)
BAND_F32 = float(np.float32(0.02))
HOP_NOISE_F32 = float(np.float32(0.005))


@dataclasses.dataclass
class DeviceTables:
    """One chunk's :class:`ChunkTables` as tensors on the planner's device.

    Float tables keep the builder's dtypes (f32 CI parameters and noise,
    f64 times and weights); index tables are int64 for torch indexing,
    except ``pair_idx`` which stays int32, the type the sweep kernel reads.
    ``tc`` packs the anchor-derived time constants and the calibration
    as f64 ``[h_of_day0, day_frac_s, dow0, cal_a, cal_b]``.
    """
    zcols: torch.Tensor                # (5, n_z) f32 base/amp/dip/namp/peak
    znoise: torch.Tensor               # (n_z, hours) f32
    zone_idx: torch.Tensor             # (n_p, n_hops) i64
    band: torch.Tensor                 # (n_p, n_hops) f32
    hnoise: torch.Tensor               # (n_p, n_hops, hours) f32
    rel0a: torch.Tensor                # (n_anch,) f64
    anchor_idx: torch.Tensor           # (n_a,) i64
    path_idx: torch.Tensor             # (n_a,) i64
    pair_idx: torch.Tensor             # (n_c, 2) i32
    w_dev: torch.Tensor                # (n_c, 2, n_hops) f64
    n_steps: torch.Tensor              # (n_c,) i64
    rem: torch.Tensor                  # (n_c,) f64
    tc: torch.Tensor                   # (5,) f64
    n_grid_pad: int
    n_slots_pad: int


def tables_to_device(tables, device: Union[str, torch.device]
                     ) -> DeviceTables:
    """Carry one chunk's host tables onto ``device``.

    Reads only the :class:`ChunkTables` fields by name, so it takes this
    module's tables or the reference package's ``ChunkTables`` (the same
    numpy arrays) unchanged: the tests feed both implementations from one
    set of tables through here.
    """
    dev = torch.device(device)
    # the sweep kernel trusts its pair rows: bound them before any gather
    n_a = len(tables.path_idx)
    if tables.pair_idx.size and not (0 <= tables.pair_idx.min()
                                     and tables.pair_idx.max() < n_a):
        raise ValueError(f"pair_idx must lie in [0, {n_a})")

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev,
                               dtype=dtype)

    f32, f64, i64 = torch.float32, torch.float64, torch.int64
    return DeviceTables(
        zcols=put(np.stack(tables.zcols), f32),
        znoise=put(tables.znoise, f32),
        zone_idx=put(tables.zone_idx, i64),
        band=put(tables.band, f32),
        hnoise=put(tables.hnoise, f32),
        rel0a=put(tables.rel0a, f64),
        anchor_idx=put(tables.anchor_idx, i64),
        path_idx=put(tables.path_idx, i64),
        pair_idx=put(tables.pair_idx, torch.int32),
        w_dev=put(tables.w_dev, f64),
        n_steps=put(tables.n_steps, i64),
        rem=put(tables.rem, f64),
        tc=put([tables.h_of_day0, tables.day_frac_s, float(tables.dow0),
                float(tables.cal_a), float(tables.cal_b)], f64),
        n_grid_pad=int(tables.n_grid_pad),
        n_slots_pad=int(tables.n_slots_pad))


def _pair_grids(d: DeviceTables, *, dt_s: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-2 of :func:`_lattice` on the tables' device: the (A, H,
    T+1) f64 prefix sums and the (A, H, T) f32 device-CI grids."""
    dev = d.znoise.device
    n_grid = d.n_grid_pad
    f64 = torch.float64
    zbase, zamp, zdip, znamp, zpeak = (col[None, :, None] for col in d.zcols)
    n_z, w_hours = d.znoise.shape
    n_hops = d.zone_idx.shape[1]
    h_of_day0, day_frac_s, dow0, cal_a, cal_b = d.tc.tolist()
    # time/index math in f64 (hour boundaries must land exactly)
    t_rel = (d.rel0a[:, None]
             + dt_s * torch.arange(n_grid, dtype=f64, device=dev)[None, :])
    hour_rel = torch.div(t_rel, 3600.0, rounding_mode="floor").long() \
        .clamp(0, w_hours - 1)                                      # (N,T)
    hod = ((h_of_day0 + true_div(t_rel, 3600.0)) % 24.0).float()[:, None, :]
    dow = ((int(dow0)
            + torch.floor(true_div(t_rel + day_frac_s, 86400.0)).long())
           % 7)[:, None, :]
    # the CI value chain in f32
    v = zbase + zamp * torch.cos(true_div(TWO_PI_F32 * (hod - zpeak), 24.0))
    v = v - zdip * torch.exp(-0.5 * true_div(hod - 13.0, 2.5) ** 2)
    v = torch.where((dow == 5) | (dow == 6), v * WEEKEND_F32, v)
    zrange = torch.arange(n_z, device=dev)
    v = v + znamp * d.znoise[zrange[None, :, None], hour_rel[:, None, :]]
    v = torch.clamp_min(v, 1.0)
    v = torch.clamp_min(float(np.float32(cal_a)) * v
                        + float(np.float32(cal_b)), 0.5)            # (N,Z,T)
    # stage 2: gather the lattice into (anchor, path) device-CI grids
    zrow = d.anchor_idx[:, None] * n_z + d.zone_idx[d.path_idx]     # (A,H)
    ci = v.reshape(-1, n_grid)[zrow]                                # (A,H,T)
    hseq = torch.arange(n_hops, device=dev)
    u = d.hnoise[d.path_idx[:, None, None], hseq[None, :, None],
                 hour_rel[d.anchor_idx][:, None, :]]                # (A,H,T)
    ci = ci * (1.0 + BAND_F32 * d.band[d.path_idx][:, :, None]
               + HOP_NOISE_F32 * u)
    prefix = torch.cat([torch.zeros(ci.shape[:2] + (1,), dtype=f64,
                                    device=dev),
                        torch.cumsum(ci.double(), dim=2)], dim=2)   # (A,H,T+1)
    return prefix, ci


def _cell_rows(prefix: torch.Tensor, ci: torch.Tensor,
               pair_idx: torch.Tensor, n_steps: torch.Tensor,
               w_dev: torch.Tensor, rem: torch.Tensor, *, n_slots: int,
               slot_stride: int, dt_s: float) -> torch.Tensor:
    """Stage 3 of :func:`_lattice` for some cells, on the device of its
    tensors: each cell's prefix segments gathered over a batch dimension
    (the reference's ``vmap``); padded slots clamp into the grid (their
    values are sliced away by the caller). Returns (C, 2, S) f64."""
    dev = prefix.device
    n_grid = ci.shape[2]
    hseq = torch.arange(ci.shape[1], device=dev)
    kk = slot_stride * torch.arange(n_slots, device=dev)            # (S,)
    hi = kk[None, :] + n_steps[:, None] - 1                         # (C,S)
    p4 = pair_idx.long()[:, :, None, None]
    h4 = hseq[None, None, :, None]
    seg = (prefix[p4, h4, hi.clamp(max=n_grid)[:, None, None, :]]
           - prefix[p4, h4, kk.clamp(max=n_grid)[None, None, None, :]])
    last = ci[p4, h4, hi.clamp(max=n_grid - 1)[:, None, None, :]].double()
    return true_div(torch.einsum("clh,clhs->cls", w_dev, seg) * dt_s
                    + torch.einsum("clh,clhs->cls", w_dev, last)
                    * rem[:, None, None], 3.6e6)                    # (C,2,S)


def _lattice(d: DeviceTables, *, slot_stride: int, dt_s: float,
             devices: Sequence[torch.device] = ()) -> torch.Tensor:
    """The fleet scorer for one chunk (shapes: Z zones, W hours, N
    anchors, A (anchor, path) pairs, H hops, C cells, S slots, T grid
    steps). Returns the (C, 2, S) f64 emission table on the tables'
    device.

    Stage 1 evaluates zone CI on the (anchor x zone x grid) lattice, so
    the trig/noise chain runs once per anchor-zone, not once per hop.
    Stage 2 gathers the lattice into per-(anchor, path) device-CI grids
    (sub-metering band x hourly hop noise) and prefix-sums them in f64.
    Stage 3 gathers each cell's prefix segments over a batch dimension.

    With two or more ``devices`` (the reference's ``shard_map`` over a
    mesh's cell axis) stages 1-2 still run once, here; their grids are
    copied once to each distinct other device, and stage 3 runs on each
    device in turn over an even slice of the cell axis (C must divide),
    the slices' tables joined in device order.
    """
    prefix, ci = _pair_grids(d, dt_s=dt_s)
    kw = dict(n_slots=d.n_slots_pad, slot_stride=slot_stride, dt_s=dt_s)
    cells = (d.pair_idx, d.n_steps, d.w_dev, d.rem)
    if len(devices) < 2:
        return _cell_rows(prefix, ci, *cells, **kw)
    n_c = d.pair_idx.shape[0]
    if n_c % len(devices):
        raise ValueError(f"{n_c} cells do not split over {len(devices)} "
                         f"devices")
    rows = n_c // len(devices)
    grids = {prefix.device: (prefix, ci)}
    out = []
    for i, sd in enumerate(devices):
        sd = torch.device(sd)
        if sd not in grids:
            grids[sd] = (prefix.to(sd), ci.to(sd))
        part = [t[i * rows:(i + 1) * rows].to(sd) for t in cells]
        out.append(_cell_rows(*grids[sd], *part, **kw).to(prefix.device))
    return torch.cat(out)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declared devices for the batched planner's cell-axis split (the
    reference's ``grid_jax.MeshConfig``): which platform's devices, how
    many of them, and the name of the one mesh axis the cell axis splits
    over. ``build()`` resolves it into a 1-D :class:`HostMesh`.

    ``platform="cpu"`` gives ``n_devices`` copies of the CPU device (one
    if unset): the port's counterpart of the reference's
    ``--xla_force_host_platform_device_count``, which lets the split run,
    and be held against the unsplit path, on a host without accelerators.
    ``"cuda"`` (the default) gives the visible ``cuda:i``, truncated to
    ``n_devices``.
    """
    axis: str = "cells"
    n_devices: Optional[int] = None    # None = every matching device
    platform: Optional[str] = None     # None = cuda, the port's default

    def __post_init__(self):
        if not self.axis:
            raise ValueError("MeshConfig.axis must be a non-empty name")
        if self.n_devices is not None and self.n_devices < 1:
            raise ValueError(f"MeshConfig.n_devices must be >= 1 or None, "
                             f"got {self.n_devices}")

    def devices(self) -> List[torch.device]:
        """The devices this config selects, in ``cuda:i`` order."""
        platform = self.platform or "cuda"
        if platform == "cpu":
            return [torch.device("cpu")] * (self.n_devices or 1)
        if platform != "cuda":
            raise ValueError(f"MeshConfig.platform must be 'cuda', 'cpu' "
                             f"or None, got {self.platform!r}")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        return devs if self.n_devices is None else devs[:self.n_devices]

    def build(self) -> HostMesh:
        """A 1-D :class:`HostMesh` over :meth:`devices`."""
        devs = self.devices()
        if not devs:
            raise ValueError(f"MeshConfig{dataclasses.astuple(self)!r} "
                             f"matches no devices")
        return HostMesh(devs, (self.axis,))


def _split_devices(shard, device: torch.device) -> List[torch.device]:
    """What ``shard`` selects (see :func:`batch_cell_emissions`)."""
    if isinstance(shard, MeshConfig):
        return shard.devices()
    if shard is None or shard:
        return MeshConfig(platform=device.type).devices()
    return []


def batch_cell_emissions(field: CarbonField, cells: Sequence[CellTask], *,
                         dt_s: float = 60.0, slot_stride: int = 60,
                         device: Optional[Union[str, torch.device]] = None,
                         shard=None) -> List[np.ndarray]:
    """Score every cell's (leg, start-slot) emission table, one torch pass
    per memory chunk on ``device`` (``cuda`` unless given). Returns, per
    cell, a ``(n_legs, n_slots)`` f64 array matching
    ``CarbonField.transfer_emissions_g`` per leg to ~1e-7 relative.

    ``slot_stride`` is the slot spacing in dt_s steps (the planner's
    ``slot_s / dt_s``; both legs of a cell share the slot/step layout).
    ``shard`` selects the split of the cell axis over devices, as the
    reference's: ``True`` every visible device of ``device``'s platform,
    ``False`` none, a :class:`MeshConfig` its devices, and ``None`` every
    visible device when there is more than one. Fewer than two devices
    run the unsplit path: the split never changes a result.
    """
    dev = resolve_device(device)
    return cell_emissions_on(field, cells, _split_devices(shard, dev),
                             dt_s=dt_s, slot_stride=slot_stride, device=dev)


def cell_emissions_on(field: CarbonField, cells: Sequence[CellTask],
                      devices: Sequence[Union[str, torch.device]], *,
                      dt_s: float = 60.0, slot_stride: int = 60,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> List[np.ndarray]:
    """:func:`batch_cell_emissions` split over an explicit device list (the
    reference's ``_kernel(mesh=)``; a device may repeat): each chunk's
    cell axis pads to a multiple of ``lcm(64, len(devices))`` and stage 3
    of the lattice runs on each device in turn. Fewer than two devices
    run the unsplit path on ``device``."""
    dev = resolve_device(device)
    devs = [torch.device(d) for d in devices] if len(devices) >= 2 else []
    bucket = math.lcm(_B_CELLS, max(len(devs), 1))
    out: List[Optional[np.ndarray]] = [None] * len(cells)
    for chunk in _iter_chunks(cells, slot_stride, _MAX_ELEMS):
        sub = [cells[j] for j in chunk]
        t = _chunk_tables(field, sub, dt_s=dt_s, slot_stride=slot_stride,
                          cell_bucket=bucket)
        emis = _lattice(tables_to_device(t, dev), slot_stride=slot_stride,
                        dt_s=dt_s, devices=devs).cpu().numpy()
        for row, (j, c) in enumerate(zip(chunk, sub)):
            out[j] = emis[row, :len(c.legs), :c.n_slots]
    return out                         # type: ignore[return-value]


# --- the per-leg scorer (plan() and rescore() with backend="torch") ---------

class _PathWindow:
    """Dense view of one path over [t0, t0 + hours h) on the scorer's
    device: the zone window plus the per-hop sub-metering band and hourly
    noise that turn zone CI into device CI (``CarbonField.hop_ci_matrix``
    semantics). All noise is hashed on the host when the window is built
    and carried to the device once."""

    def __init__(self, field: CarbonField, path: NetworkPath, t0: float,
                 hours: int, device: torch.device):
        zones = tuple(dict.fromkeys(h.zone for h in path.hops))
        self.window: CarbonWindow = window_to(
            make_window(zones, t0, hours, field), device)
        self.t0, self.hours = float(t0), int(hours)
        hour0 = int(t0 // 3600.0)
        hour_idx = np.arange(hour0, hour0 + hours)
        self.zone_idx = torch.as_tensor(
            [zones.index(h.zone) for h in path.hops], dtype=torch.int64,
            device=device)
        self.hop_band = torch.as_tensor(
            np.array([field._hop_band(h.ip) for h in path.hops],
                     dtype=np.float32), device=device)
        self.hop_noise = torch.as_tensor(np.stack(
            [field._hop_noise.lookup(h.ip, hour_idx) - 0.5
             for h in path.hops]).astype(np.float32), device=device)

    def covers(self, t_lo: float, t_hi: float) -> bool:
        return (t_lo >= self.t0
                and t_hi <= self.t0 + 3600.0 * self.hours - 1e-6)


def leg_rate(pw: _PathWindow, w_dev: torch.Tensor,
             rel: torch.Tensor) -> torch.Tensor:
    """The emission rate r = w_dev . device CI / 3.6e6 (g/s, f64) of one
    path at ``rel`` (f64 seconds since ``pw.t0``), on the window's device:
    zone CI from the window in f32, times the hop band, weighted in f64.
    The hour index is f64 time math with a true division, as numpy's."""
    zci = window_ci_torch(pw.window, pw.zone_idx[:, None], rel[None, :],
                          device=rel.device)                         # (H,T)
    hour_frac = pw.t0 - 3600.0 * math.floor(pw.t0 / 3600.0)
    hour_rel = torch.floor(true_div(rel + hour_frac, 3600.0)).long() \
        .clamp(0, pw.hours - 1)
    band = (1.0 + BAND_F32 * pw.hop_band[:, None]
            + HOP_NOISE_F32 * pw.hop_noise[:, hour_rel])
    return true_div(w_dev @ (zci * band).double(), 3.6e6)


class TorchGridScorer:
    """The per-leg backend of ``TorchCarbonPlanner(backend="torch")``: a
    per-planner cache of path windows on ``device`` (``cuda`` unless
    given), each anchored at an hour boundary with a two-week horizon and
    rebuilt when a leg's grid leaves it.

    Counters: ``windows_built`` (anchors), ``legs`` (legs scored on the
    device) and ``numpy_legs`` (legs whose starts sit off a common dt_s
    grid, which go to the numpy field as in the reference; the planner's
    slot scans are always aligned)."""

    def __init__(self, field: Optional[CarbonField] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.field = field or default_field()
        self.device = resolve_device(device)
        self._windows: Dict[Tuple, _PathWindow] = {}
        self.windows_built = 0
        self.legs = 0
        self.numpy_legs = 0

    def _path_window(self, path: NetworkPath, t_lo: float,
                     t_hi: float) -> _PathWindow:
        key = (path.src, path.dst, path.hops)
        pw = self._windows.get(key)
        if pw is None or not pw.covers(t_lo, t_hi):
            t0 = 3600.0 * math.floor(t_lo / 3600.0)
            hours = max(int(math.ceil((t_hi - t0) / 3600.0)) + 1,
                        _WINDOW_HOURS)
            hours = int(math.ceil(hours / _WINDOW_HOURS)) * _WINDOW_HOURS
            pw = _PathWindow(self.field, path, t0, hours, self.device)
            self._windows[key] = pw
            self.windows_built += 1
        return pw

    def leg_emissions_g(self, path: NetworkPath, sender: HostPowerModel,
                        receiver: HostPowerModel, bytes_moved: float,
                        t0s: np.ndarray, throughput_gbps: float, *,
                        parallelism: int = 1, concurrency: int = 1,
                        dt_s: float = 60.0) -> np.ndarray:
        """``CarbonField.transfer_emissions_g`` for slot-aligned starts:
        the rate on the device's dt_s grid, its f64 prefix sum and each
        start's slot integral, one copy of the emissions to the host."""
        t0s = np.atleast_1d(np.asarray(t0s, dtype=np.float64))
        if throughput_gbps <= 0:
            return np.full(t0s.shape, np.inf)
        duration_s = bytes_moved * 8.0 / (throughput_gbps * 1e9)
        n_steps = max(int(math.ceil(duration_s / dt_s - 1e-12)), 1)
        rem = duration_s - (n_steps - 1) * dt_s
        offsets = (t0s - t0s.min()) / dt_s
        k = np.rint(offsets).astype(np.int64)
        if offsets.size and np.max(np.abs(offsets - k)) >= 1e-9:
            self.numpy_legs += 1
            return self.field.transfer_emissions_g(
                path, sender, receiver, bytes_moved, t0s, throughput_gbps,
                parallelism=parallelism, concurrency=concurrency, dt_s=dt_s)
        n_grid = int(k.max()) + n_steps
        n_pad = int(math.ceil(n_grid / _GRID_BUCKET)) * _GRID_BUCKET
        t_lo = float(t0s.min())
        pw = self._path_window(path, t_lo, t_lo + n_pad * dt_s)
        dev, f64 = self.device, torch.float64
        w_dev = torch.as_tensor(self.field._device_weights(
            path, sender, receiver, throughput_gbps, parallelism,
            concurrency), dtype=f64, device=dev)
        rel = (t_lo - pw.t0) + dt_s * torch.arange(n_pad, dtype=f64,
                                                   device=dev)
        r = leg_rate(pw, w_dev, rel)
        prefix = torch.cat([torch.zeros(1, dtype=f64, device=dev),
                            torch.cumsum(r[:n_grid], 0)])
        lo = torch.as_tensor(k, device=dev)
        hi = lo + (n_steps - 1)
        self.legs += 1
        return ((prefix[hi] - prefix[lo]) * dt_s
                + r[hi] * rem).cpu().numpy()
