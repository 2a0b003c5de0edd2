"""Fleet control plane: one event-driven runtime for queue/planner/engine/
overlay.

``events`` holds the typed event records and the heap-based :class:`EventLoop`
(the single simulation clock every layer shares); ``controller`` holds the
:class:`FleetController` that orchestrates admit -> plan -> dispatch -> step ->
observe -> re-plan/migrate -> complete and emits a :class:`FleetReport`;
``sharded`` partitions a fleet across controllers (:class:`ShardedFleet`).
"""
from repro_torch.core.controlplane.events import (Event, EventLoop,
                                                  ForecastShock, JobArrival,
                                                  JobComplete, JobReady,
                                                  MigrationCheck, ReplanTick,
                                                  StepTick)


def __getattr__(name):
    # controller pulls in the scheduler stack, which itself imports
    # controlplane.events — resolve lazily to keep the package acyclic
    if name in ("FleetController", "FleetReport", "JobOutcome"):
        from repro_torch.core.controlplane import controller
        return getattr(controller, name)
    if name in ("ShardedFleet", "PumpQuanta", "quantum_schedule"):
        from repro_torch.core.controlplane import sharded
        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Event", "EventLoop", "JobArrival", "JobReady", "StepTick", "ReplanTick",
    "MigrationCheck", "ForecastShock", "JobComplete",
    "FleetController", "FleetReport", "JobOutcome", "ShardedFleet",
    "PumpQuanta", "quantum_schedule",
]
