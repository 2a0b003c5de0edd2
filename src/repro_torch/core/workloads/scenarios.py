"""Named workload scenarios: the sweep axis for examples, benches, tests.

A :class:`Scenario` bundles what a fleet experiment needs — FTN overlay,
one or more :class:`Workload` streams, a horizon, and any pre-announced
carbon shocks — behind a name, so "run the bursty day" means the same
fleet everywhere. Arrival-pattern diversity (steady vs diurnal vs MMPP
burst) and spatial-CI diversity (clean-hydro relay vs dirty corridor,
plus the shocks) are exactly where carbon-aware schedulers differentiate,
which is why every scenario carries both.

Endpoints and zones come from the topology registry
(``core/carbon/path.py``); all scenarios target the uc/site_* -> tacc
corridor the paper measures, with the Quebec hydro relay as the
clean-but-shockable alternative.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

from repro_torch.core.carbon import lattice as _lattice
from repro_torch.core.scheduler.overlay import FTN
from repro_torch.core.scheduler.planner import TransferJob
from repro_torch.core.workloads.generators import (
    DiurnalArrivals, LognormalSizes, MMPPArrivals, ParetoSizes,
    PoissonArrivals, UniformSizes, Workload, merge_streams)


@dataclasses.dataclass(frozen=True)
class ScenarioShock:
    """A pre-announced CI drift, offset-relative to the scenario t0."""
    t_off_s: float
    factor: float
    duration_s: float
    zones: Optional[Tuple[str, ...]] = None


def _default_ftns() -> Tuple[FTN, ...]:
    return (FTN("uc", "skylake", 10.0), FTN("m1", "apple_m1", 1.2),
            FTN("site_qc", "cascade_lake", 40.0),
            FTN("tacc", "cascade_lake", 10.0))


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    workloads: Tuple[Workload, ...]
    horizon_s: float = 24 * 3600.0
    shocks: Tuple[ScenarioShock, ...] = ()
    ftns: Tuple[FTN, ...] = dataclasses.field(default_factory=_default_ftns)
    # optional topology hook run before the scenario resolves endpoints —
    # the lattice scenarios install their ZoneLattice here, lazily and
    # idempotently, so importing this module never mutates registries
    setup: Optional[Callable[[], None]] = None

    def prepare(self) -> "Scenario":
        """Run the setup hook (idempotent). Called by ``jobs()`` and
        ``get_scenario`` so both streaming and batch entry points see the
        scenario's topology installed before any path resolves."""
        if self.setup is not None:
            self.setup()
        return self

    def jobs(self, seed: int, t0: float) -> Iterator[TransferJob]:
        """The scenario's deterministic arrival stream: every workload
        seeded off ``seed`` (offset by its index, so streams stay
        independent), merged by submission time."""
        self.prepare()
        return merge_streams(*(
            w.jobs(seed + 1000 * i, t0, self.horizon_s)
            for i, w in enumerate(self.workloads)))


_BULK_REPLICAS = (("site_ne", "site_or", "site_qc"), ("uc", "site_ne"),
                  ("uc",))

# --- mesoscale lattice scenarios -------------------------------------------
# Endpoint names and tiers are pure functions of the lattice spec, so the
# *uninstalled* preset is enough to define the scenarios at import time;
# the setup hook installs the real topology on first use.
_LAT200 = _lattice.preset(200)
_LAT_EDGE = tuple(_LAT200.endpoints("edge"))
_LAT_METRO = tuple(_LAT200.endpoints("metro"))
_LAT_CORE = tuple(_LAT200.endpoints("core"))
_LAT_DST = _LAT_CORE[len(_LAT_CORE) // 2]      # a central core hub


def _install_lat200() -> None:
    _lattice.default_lattice(200)


def _edge_tier_sets(n_sets: int = 16) -> Tuple[Tuple[str, ...], ...]:
    """Cross-tier candidate sets: each job can source from two edge caches
    plus a metro or core replica, striding the whole lattice so the
    planner's space shift sweeps mesoscale CI variation, not one corner."""
    sets = []
    for i in range(n_sets):
        e1 = _LAT_EDGE[(7 * i) % len(_LAT_EDGE)]
        e2 = _LAT_EDGE[(7 * i + 93) % len(_LAT_EDGE)]
        m = _LAT_METRO[i % len(_LAT_METRO)]
        c = _LAT_CORE[i % len(_LAT_CORE)]
        sets.append((e1, e2, m) if i % 2 else (e1, m, c))
    return tuple(sets)


def _fanout_sets(stride: int = 25) -> Tuple[Tuple[str, ...], ...]:
    """25 disjoint 8-replica sets covering all 200 cells — the 100+-zone
    fan-out the lattice planner sweep is sized for."""
    eps = tuple(_LAT200.endpoints())
    return tuple(tuple(eps[i::stride]) for i in range(stride))


def _lattice_ftns(dst: str) -> Tuple[FTN, ...]:
    ftns = [FTN(name, "lat_core", 100.0)
            for name in _LAT_CORE[:3] if name != dst]
    ftns.append(FTN(_LAT_METRO[0], "lat_metro", 25.0))
    ftns.append(FTN(dst, "lat_core", 100.0))
    return tuple(ftns)

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="steady_poisson",
        description="Memoryless baseline: homogeneous Poisson arrivals, "
                    "lognormal sizes — the no-structure control every "
                    "policy should at least not lose on.",
        workloads=(Workload(
            "poisson", PoissonArrivals(rate_per_h=50.0),
            LognormalSizes(median_gb=150.0, sigma=0.8),
            replica_sets=_BULK_REPLICAS),)),
    Scenario(
        name="diurnal_day",
        description="Business-hours fleet: arrival rate peaks mid-"
                    "afternoon exactly when solar pushes CI down — the "
                    "time-shifting regime of Fig. 3.",
        workloads=(Workload(
            "diurnal", DiurnalArrivals(rate_per_h=60.0, amplitude=0.7,
                                       peak_hour=14.0),
            UniformSizes(lo_gb=50.0, hi_gb=500.0),
            replica_sets=_BULK_REPLICAS),)),
    Scenario(
        name="bursty_day",
        description="Diurnal base traffic with MMPP bursts riding on it "
                    "(checkpoint fan-outs, dataset drops): the admission-"
                    "control and backfill regime.",
        workloads=(
            Workload("base", DiurnalArrivals(rate_per_h=30.0, amplitude=0.6,
                                             peak_hour=13.0),
                     UniformSizes(lo_gb=50.0, hi_gb=400.0),
                     replica_sets=_BULK_REPLICAS),
            Workload("burst", MMPPArrivals(rate_calm_per_h=4.0,
                                           rate_burst_per_h=360.0,
                                           mean_calm_s=4.0 * 3600.0,
                                           mean_burst_s=12.0 * 60.0),
                     UniformSizes(lo_gb=20.0, hi_gb=150.0),
                     replica_sets=(("site_ne", "site_qc"), ("site_or",)),
                     deadline_h=(2.0, 6.0))),
        shocks=(ScenarioShock(t_off_s=11 * 3600.0, factor=6.0,
                              duration_s=6 * 3600.0,
                              zones=("CA-QC", "US-NY-NYIS")),)),
    Scenario(
        name="edge_lattice_day",
        description="Mesoscale lattice day: diurnal edge-cache traffic "
                    "across the 200-zone lattice feeding a core hub, every "
                    "job's replica set spanning edge/metro/core tiers — "
                    "the cross-tier space-shifting regime CarbonEdge "
                    "motivates.",
        workloads=(Workload(
            "edge", DiurnalArrivals(rate_per_h=24.0, amplitude=0.6,
                                    peak_hour=14.0),
            UniformSizes(lo_gb=20.0, hi_gb=120.0),
            replica_sets=_edge_tier_sets(), dst=_LAT_DST,
            deadline_h=(3.0, 10.0)),),
        ftns=_lattice_ftns(_LAT_DST),
        setup=_install_lat200),
    Scenario(
        name="metro_space_shift",
        description="Space shift at 100+-zone fan-out: steady arrivals "
                    "where every job carries an 8-replica candidate set "
                    "striding all 200 lattice cells, so each admission "
                    "sweep ranks the whole mesoscale field.",
        workloads=(Workload(
            "fanout", PoissonArrivals(rate_per_h=40.0),
            LognormalSizes(median_gb=60.0, sigma=0.7),
            replica_sets=_fanout_sets(), dst=_LAT_DST,
            deadline_h=(4.0, 12.0)),),
        horizon_s=12 * 3600.0,
        ftns=_lattice_ftns(_LAT_DST),
        setup=_install_lat200),
    Scenario(
        name="heavy_tail_mix",
        description="Elephants and mice: Pareto(1.3) sizes over steady "
                    "arrivals — a few TB-scale jobs dominate the byte "
                    "count and become the migration candidates.",
        workloads=(Workload(
            "tail", PoissonArrivals(rate_per_h=40.0),
            ParetoSizes(alpha=1.3, scale_gb=40.0, cap_gb=3000.0),
            replica_sets=(("uc",), ("uc", "site_ne")),
            deadline_h=(6.0, 20.0)),)),
]}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name].prepare()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(SCENARIOS)}") from None
