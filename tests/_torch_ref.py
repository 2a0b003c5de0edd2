"""Shared inputs for the port's tests, and the reference run that feeds them.

The port (``repro_torch``) is held against the JAX package (``repro``).
On jax >= 0.9 the reference's jax and Pallas planner paths do not import
(``from jax.experimental import enable_x64`` is gone), and nothing in the
reference may change. So the reference runs in a child process that first
sets ``jax.experimental.enable_x64 = jax.enable_x64``, drives the
reference's own planner on the cases below, and writes what its kernels
saw and returned to an ``.npz`` file. The alias lives and dies with that
process: the test process never sees it.

    python tests/_torch_ref.py OUT.npz grid|fused|planner

Cases are plain data, built into jobs by :func:`make_jobs` against either
package's planner module, so both implementations plan identical inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

REPO = Path(__file__).resolve().parents[1]
T0 = 1713052800.0                      # PAPER_WINDOW_T0 of both packages
DT_S, SLOT_S, STRIDE = 60.0, 3600.0, 60

# the planner_scale deployment's FTNs (benchmarks/perf.py) and, for the
# edge cases, tests/test_grid_pallas.py's
SCALE_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
              ("tacc", "cascade_lake", 10.0))
EDGE_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
             ("site_qc", "cascade_lake", 40.0),
             ("tacc", "cascade_lake", 10.0))

# (uuid, size_bytes, replicas, dst, deadline_s, carbon_budget_g, submit)
EDGE_CASES: Dict[str, List[tuple]] = {
    "zero_cells": [],
    "single_slot": [(f"ss{i}", 30e9, ("uc",), "tacc", 3700.0 + i * 10.0,
                     None, T0 + i * 13.0) for i in range(3)],
    "all_masked": [("late", 2000e9, ("uc", "m1"), "tacc", 60.0, None, T0)],
    "one_step_clamp": [(f"tiny{i}", 1e9 + i * 2e8, ("uc", "m1"), "tacc",
                        6 * 3600.0, None, T0 + i * 950.0) for i in range(4)],
    "carbon_budget": [(f"bg{i}", (100 + 40 * i) * 1e9, ("uc", "m1"), "tacc",
                       24 * 3600.0, None if i % 2 else 90.0,
                       T0 + i * 1700.0) for i in range(8)],
}


def scale_spec(i: int) -> tuple:
    """planner_scale's job generator (benchmarks/perf.py::planner_scale)."""
    return (f"s{i}", (20 + (13 * i) % 600) * 1e9,
            ("uc", "m1") if i % 3 else ("uc",), "tacc",
            (12 + i % 36) * 3600.0, None, T0 + (i % 288) * 300.0)


def scale_ids(n_anchors: int, per_anchor: int) -> List[int]:
    """planner_scale job ids sharing ``n_anchors`` submission times (ids
    288 apart share one), so a small batch stays within one or two
    chunks."""
    return [j + 288 * m for m in range(per_anchor) for j in range(n_anchors)]


SCALE_CASES: Dict[str, List[tuple]] = {
    "grid": [scale_spec(i) for i in scale_ids(4, 4)],
    "drift": [scale_spec(i) for i in scale_ids(4, 2)],
    "planner": [scale_spec(i) for i in scale_ids(8, 8)],
}


@contextlib.contextmanager
def deadline(seconds: int):
    """Raise ``TimeoutError`` in the main thread if the block runs past
    ``seconds``: a case that starts worker processes bounds itself, so a
    hung worker fails that case instead of holding the whole run."""
    def expired(signum, frame):
        raise TimeoutError(f"case ran past its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def warm_up_torch() -> None:
    """Run torch's vectorized math once, multi-threaded, before any test
    compares numbers. With torch 2.13's CPU build, the first parallel
    call of a transcendental op in a process can return low-accuracy
    values (about 1.5e-4 off for cos) on one worker thread's share of
    the tensor; every later call is exact and repeatable."""
    import torch
    w = torch.linspace(-3.0, 3.0, 1 << 21, dtype=torch.float64)
    torch.exp(w)
    torch.cos(w.float())


def fresh_default_fields() -> None:
    """Drop both packages' process-wide default carbon field, so the next
    ``default_field()`` on either side starts cold. A warm field answers
    from the hop-CI prefix-sum grids it cached for earlier windows, and
    those can differ from a cold field's in the last bit; a comparison of
    port and reference must start both from the same state, whatever ran
    before it in the process."""
    from repro.core.carbon import field as r_field
    from repro_torch.core.carbon import field as t_field
    for mod in (r_field, t_field):
        mod._DEFAULT, mod._DEFAULT_PID = None, None


def make_jobs(planner_mod, specs) -> list:
    return [planner_mod.TransferJob(u, size, reps, dst,
                                    planner_mod.SLA(deadline_s=dl,
                                                    carbon_budget_g=bg),
                                    sub)
            for u, size, reps, dst, dl, bg, sub in specs]


def make_ftns(overlay_mod, specs) -> list:
    return [overlay_mod.FTN(*s) for s in specs]


def drift(path, ts):
    """A deterministic emission_scale_fn: works on either package's
    paths (it reads only the hop count and the times)."""
    return 1.0 + 0.1 * np.sin(np.asarray(ts) / 7200.0 + path.n_hops)


# --- the fleet control plane ------------------------------------------------
# tests/test_controlplane.py's, tests/test_sharded.py's and tests/test_obs.py's
# fleets: FTNs, and job specs as (uuid, size_bytes, replicas, deadline_s,
# submit) to "tacc"
FLEET_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
              ("site_qc", "cascade_lake", 40.0),
              ("tacc", "cascade_lake", 10.0))
SHOCK_ZONES = ("CA-QC", "US-NY-NYIS")


def heavy_specs(n: int = 12, t_off_h: float = 10.0,
                deadline_h: float = 24.0) -> List[tuple]:
    """test_controlplane's ``_heavy``: 2 TB archival copies from uc."""
    return [(f"h{i}", 2000e9 + i * 1e9, ("uc",), deadline_h * 3600.0,
             T0 + t_off_h * 3600.0 + i * 600.0) for i in range(n)]


def sharded_specs(n: int = 12) -> List[tuple]:
    """test_sharded's ``_jobs``."""
    return [(f"s{i}", (300 + 100 * i) * 1e9,
             ("uc", "site_ne") if i % 2 else ("uc",),
             (8 + i % 6) * 3600.0, T0 + i * 1200.0) for i in range(n)]


def obs_specs(n: int = 18, spread_s: float = 1200.0) -> List[tuple]:
    """test_obs's ``_jobs``."""
    return [(f"o{i}", (300 + 53 * i % 1500) * 1e9,
             ("uc", "site_ne") if i % 2 else ("uc",),
             (8 + i % 6) * 3600.0, T0 + i * spread_s) for i in range(n)]


def fleet_jobs(planner_mod, specs) -> list:
    return [planner_mod.TransferJob(u, size, reps, "tacc",
                                    planner_mod.SLA(deadline_s=dl), sub)
            for u, size, reps, dl, sub in specs]


def shock(fleet, at_h: float = 5.0, hours: float = 5.0) -> None:
    fleet.inject_shock(T0 + at_h * 3600.0, 6.0, duration_s=hours * 3600.0,
                       zones=SHOCK_ZONES)


def no_wall(snap) -> dict:
    """test_obs's ``_no_wall``: a metrics snapshot minus its wall-clock
    series."""
    return {kind: [e for e in snap.get(kind, ()) if "wall" not in e["name"]]
            for kind in ("counters", "gauges", "histograms")}


def report_fields(rep, ignore=("wall_s", "jobs_per_s", "metrics")) -> dict:
    """A FleetReport as plain data, comparable across the two packages
    (their dataclasses never compare equal to each other): outcome rows as
    tuples, spans as tuples; ``metrics`` without its wall series."""
    out = {}
    for f in dataclasses.fields(rep):
        if f.name in ignore:
            continue
        v = getattr(rep, f.name)
        if f.name == "outcomes":
            v = [dataclasses.astuple(o) for o in v]
        elif f.name == "trace":
            v = [tuple(sp) for sp in v]
        out[f.name] = v
    if "metrics" not in ignore:
        out["metrics"] = None if rep.metrics is None \
            else no_wall(rep.metrics)
    return out


def assert_reports_identical(got, want, **kw) -> None:
    """Bit-identical FleetReports field by field (test_obs's
    ``_assert_identical``), metrics compared without their wall series."""
    a, b = report_fields(got, **kw), report_fields(want, **kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


OUTCOME_ROW = ("job_uuid", "source", "ftn_sequence", "start_t",
               "migrations", "replanned", "sla_miss", "feasible")
COUNTERS = ("n_jobs", "n_completed", "migrations", "replan_events",
            "plans_changed", "sla_misses", "n_events", "n_steps")


def assert_same_decisions(got, want, rel: float = 1e-4) -> None:
    """The kernel backends against the numpy oracle: every job the same
    outcome row (cell, FTN sequence, migrations, re-plan, SLA miss), the
    same counters, emissions within ``rel``."""
    import pytest
    assert [tuple(getattr(o, k) for k in OUTCOME_ROW) for o in got.outcomes] \
        == [tuple(getattr(o, k) for k in OUTCOME_ROW) for o in want.outcomes]
    assert [getattr(got, k) for k in COUNTERS] == \
        [getattr(want, k) for k in COUNTERS]
    for g, w in zip(got.outcomes, want.outcomes):
        assert g.planned_emissions_g == pytest.approx(w.planned_emissions_g,
                                                      rel=rel)
        assert g.actual_emissions_g == pytest.approx(w.actual_emissions_g,
                                                     rel=rel)
    for k in ("total_planned_g", "total_actual_g", "ledger_total_g"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=rel)


def run_reference(what: str, out: Path, timeout: float = 240.0
                  ) -> Dict[str, np.ndarray]:
    """Run this file as the reference child process; return its arrays."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out), what],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    if proc.returncode != 0:
        raise RuntimeError(f"reference run {what!r} failed:\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def ref_tables(arrs: Dict[str, np.ndarray], prefix: str):
    """Rebuild the reference's own ``ChunkTables`` from saved arrays (its
    paths re-resolved through the reference's memoized discover_path)."""
    from repro.core.carbon.path import discover_path
    from repro.core.scheduler.grid_jax import ChunkTables

    def g(name):
        return arrs[f"{prefix}/{name}"]
    return ChunkTables(
        zcols=tuple(g("zcols")), znoise=g("znoise"),
        cal_a=np.float32(g("cal_a")), cal_b=np.float32(g("cal_b")),
        h_of_day0=float(g("h_of_day0")), day_frac_s=float(g("day_frac_s")),
        dow0=int(g("dow0")), zone_idx=g("zone_idx"), band=g("band"),
        hnoise=g("hnoise"), rel0a=g("rel0a"), anchor_idx=g("anchor_idx"),
        path_idx=g("path_idx"), pair_idx=g("pair_idx"), w_dev=g("w_dev"),
        n_steps=g("n_steps"), rem=g("rem"),
        n_grid_pad=int(g("n_grid_pad")), n_slots_pad=int(g("n_slots_pad")),
        n_hops=int(g("n_hops")), n_pairs=int(g("n_pairs")),
        pair_paths=[discover_path(str(s), str(d))
                    for s, d in g("pair_paths")],
        pair_anchors=list(g("pair_anchors")))


TABLE_ARRAYS = ("znoise", "zone_idx", "band", "hnoise", "rel0a",
                "anchor_idx", "path_idx", "pair_idx", "w_dev", "n_steps",
                "rem")
TABLE_SCALARS = ("cal_a", "cal_b", "h_of_day0", "day_frac_s", "dow0",
                 "n_grid_pad", "n_slots_pad", "n_hops", "n_pairs")


def table_arrays(t) -> Dict[str, np.ndarray]:
    """A ``ChunkTables`` (either package's) as named arrays."""
    d = {k: np.asarray(getattr(t, k)) for k in TABLE_ARRAYS + TABLE_SCALARS}
    d["zcols"] = np.stack(t.zcols)
    d["pair_anchors"] = np.asarray(t.pair_anchors, dtype=np.float64)
    d["pair_paths"] = np.array([(p.src, p.dst) for p in t.pair_paths],
                               dtype=str).reshape(-1, 2)
    return d


def plan_arrays(plans) -> Dict[str, np.ndarray]:
    return {"start_t": np.array([p.start_t for p in plans]),
            "source": np.array([p.source for p in plans], dtype=str),
            "ftn": np.array([p.ftn for p in plans], dtype=str),
            "feasible": np.array([p.feasible for p in plans], dtype=bool),
            "emis": np.array([p.predicted_emissions_g for p in plans]),
            "cost": np.array([p.cost for p in plans]),
            "alternatives": np.array([p.alternatives for p in plans])}


# --- the child process -------------------------------------------------------

def _revive():
    import jax
    import jax.experimental
    # the reference imports this name; jax >= 0.9 keeps it at the top level
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.core.scheduler import grid_jax, grid_pallas
    if not (grid_jax.HAVE_JAX and grid_pallas.PALLAS_AVAILABLE):
        raise RuntimeError("the reference's jax/Pallas paths did not load")
    return grid_jax, grid_pallas


def _child_grid(out: Dict[str, np.ndarray]) -> None:
    grid_jax, _ = _revive()
    from repro.core.scheduler import overlay, planner
    pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                               batch_backend="jax")
    seen = {}
    real = grid_jax.batch_cell_emissions

    def record(field, cells, **kw):
        seen["cells"] = cells
        seen["emis"] = real(field, cells, **kw)
        return seen["emis"]

    grid_jax.batch_cell_emissions = record
    pl.plan_batch_jax(make_jobs(planner, SCALE_CASES["grid"]))
    cells = seen["cells"]
    for j, e in enumerate(seen["emis"]):
        out[f"grid/emis/{j}"] = np.asarray(e)
    out["grid/n_cells"] = np.asarray(len(cells))
    for budget in ("default", "small"):
        max_elems = grid_jax._MAX_ELEMS if budget == "default" else 100_000
        chunks = list(grid_jax._iter_chunks(cells, STRIDE, max_elems))
        out[f"grid/{budget}/n_chunks"] = np.asarray(len(chunks))
        for i, ch in enumerate(chunks):
            out[f"grid/{budget}/{i}/chunk"] = np.asarray(ch)
            t = grid_jax._chunk_tables(pl.field, [cells[j] for j in ch],
                                       dt_s=DT_S, slot_stride=STRIDE,
                                       cell_bucket=grid_jax._B_CELLS)
            for k, v in table_arrays(t).items():
                out[f"grid/{budget}/{i}/tab/{k}"] = v


class _PallasCapture:
    """Stands in for ``grid_pallas.pl``: each ``pallas_call`` runs as is
    and what it returns is kept."""

    def __init__(self, pl):
        self._pl = pl
        self.outputs: list = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *a, **k):
        call = self._pl.pallas_call(*a, **k)

        def run(*args):
            res = call(*args)
            self.outputs.append(res)
            return res
        return run


def _child_fused(out: Dict[str, np.ndarray]) -> None:
    _, grid_pallas = _revive()
    from repro.core.scheduler import overlay, planner
    capture = _PallasCapture(grid_pallas.pl)
    grid_pallas.pl = capture
    tables, inputs = [], []
    real_tables = grid_pallas._chunk_tables

    def record_tables(*a, **k):
        tables.append(real_tables(*a, **k))
        return tables[-1]

    def eager_fused(*args, **kw):       # unjitted, so the capture is concrete
        inputs.append(args)
        return grid_pallas._fused(*args, **kw)

    grid_pallas._chunk_tables = record_tables
    grid_pallas._fused_call = lambda: eager_fused
    cases = dict(EDGE_CASES, drift=SCALE_CASES["drift"])
    for name, specs in cases.items():
        ftns = SCALE_FTNS if name == "drift" else EDGE_FTNS
        pl = planner.CarbonPlanner(make_ftns(overlay, ftns),
                                   batch_backend="pallas")
        if name == "drift":
            pl.emission_scale_fn = drift
        del tables[:], inputs[:], capture.outputs[:]
        plans = pl.plan_batch_jax(make_jobs(planner, specs))
        if pl.batch_backend != "pallas":
            raise RuntimeError(f"{name}: the reference left its Pallas path")
        for k, v in plan_arrays(plans).items():
            out[f"{name}/plans/{k}"] = v
        out[f"{name}/n_chunks"] = np.asarray(len(tables))
        for i, (t, args) in enumerate(zip(tables, inputs)):
            for k, v in table_arrays(t).items():
                out[f"{name}/{i}/tab/{k}"] = v
            for k, v in zip(("pp", "zn", "hn", "rel0", "tc", "pidx", "wd",
                             "sla", "scl"), args):
                out[f"{name}/{i}/in/{k}"] = np.asarray(v)
            r, e = capture.outputs[2 * i]
            out[f"{name}/{i}/out/r"] = np.asarray(r)
            out[f"{name}/{i}/out/e"] = np.asarray(e)
            out[f"{name}/{i}/out/best"] = np.asarray(capture.outputs[2 * i + 1])


def _child_planner(out: Dict[str, np.ndarray]) -> None:
    _revive()
    from repro.core.scheduler import overlay, planner
    for scaled in (False, True):
        pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                                   batch_backend="pallas")
        if scaled:
            pl.emission_scale_fn = drift
        plans = pl.plan_batch(make_jobs(planner, SCALE_CASES["planner"]))
        if pl.batch_backend != "pallas":
            raise RuntimeError("the reference left its Pallas path")
        for k, v in plan_arrays(plans).items():
            out[f"pallas/{'drift' if scaled else 'plain'}/{k}"] = v


if __name__ == "__main__":
    path, what = Path(sys.argv[1]), sys.argv[2]
    arrays: Dict[str, np.ndarray] = {}
    {"grid": _child_grid, "fused": _child_fused,
     "planner": _child_planner}[what](arrays)
    np.savez(path, **arrays)
