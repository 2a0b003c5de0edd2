"""Workload-scenario library: seeded arrival-stream generators.

Real fleets never see their jobs up front — transfers arrive as a stream,
and a carbon-aware scheduler wins or loses on *arrival-pattern* and
*spatial-CI* diversity (cf. the temporal-shifting and CarbonEdge lines of
related work). This package is the scenario axis: every generator is a
deterministic iterator of :class:`TransferJob` arrivals given
``(seed, horizon)``, so a streamed run, a batched run and a re-run on
another machine all see byte-identical fleets.

``generators`` holds the composable pieces (arrival processes, size laws,
the :class:`Workload` assembler, stream merging); ``scenarios`` is the
named registry (`steady_poisson`, `diurnal_day`, `bursty_day`,
`heavy_tail_mix`) the examples, benches and tests sweep.
"""
from repro_torch.core.workloads.generators import (
    ArrivalProcess, DiurnalArrivals, FixedSizes, LognormalSizes, MMPPArrivals,
    ParetoSizes, PoissonArrivals, ReplayArrivals, SizeLaw, UniformSizes,
    Workload, as_stream, merge_streams)
from repro_torch.core.workloads.scenarios import (SCENARIOS, Scenario,
                                                  ScenarioShock, get_scenario)

__all__ = [
    "ArrivalProcess", "PoissonArrivals", "DiurnalArrivals", "MMPPArrivals",
    "ReplayArrivals", "SizeLaw", "ParetoSizes", "LognormalSizes",
    "UniformSizes", "FixedSizes", "Workload", "as_stream", "merge_streams",
    "Scenario", "ScenarioShock", "SCENARIOS", "get_scenario",
]
