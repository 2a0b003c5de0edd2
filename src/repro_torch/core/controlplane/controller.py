"""The FleetController: admit -> plan -> dispatch -> step -> observe ->
re-plan/migrate -> complete, on one event clock.

The paper's headline result is *end-to-end* carbon savings: plans must
survive contact with stochastic throughput and drifting carbon intensity
(§4.3, §5), which means re-planning queued jobs and migrating in-flight
ones while transfers run. The controller composes the existing layers into
that closed loop:

* **admit** — ``JobArrival`` hands the job to the :class:`CarbonAwareQueue`
  (admission policy over the shared :class:`EventLoop`); the planner picks
  its (start, source, FTN) grid cell and a ``JobReady`` event is scheduled
  at the chosen slot.
* **dispatch** — ``JobReady`` starts a :class:`TransferEngine` state for the
  planned route. A relay plan (source -> FTN -> dst) runs as one
  store-and-forward stream at the bottleneck-leg rate, matching the
  planner's duration/emission model.
* **step/observe** — each ``StepTick`` advances one transfer by one
  (pro-rated) engine step; the controller samples the *measured* path CI
  (forecast trace x any active :class:`ForecastShock`), feeds the ledger
  and accumulates actual emissions as device-power x CI x step.
* **re-plan** — ``ReplanTick`` sweeps still-queued jobs through the
  planner's incremental ``plan_batch`` (jobs whose cell re-scores within
  ``drift_tol`` keep it; the rest get a full grid scan). A
  ``ForecastShock`` triggers an immediate full re-plan.
* **migrate** — ``MigrationCheck`` polls in-flight transfers against the
  :class:`OverlayScheduler` threshold; a migration checkpoints the engine
  state (``TransferState.checkpoint``) and resumes the remaining bytes on
  the greener FTN — bytes already moved are never re-transferred.

``run()`` drains the loop and emits a :class:`FleetReport` with per-job
planned-vs-actual emissions, migrations, SLA misses and fleet throughput.

Layer contract:

* the controller owns **all** observation wiring — ``TransferEngine.step``
  stays a pure resumable step (see ``core.transfer.engine``); ledger,
  Pmeter and CI sampling happen here, and re-integrating every job's
  ledger (``FleetReport.ledger_total_g``) must reproduce the step
  accumulator exactly;
* one controller, one clock — everything advances on the shared
  :class:`EventLoop` (monotone, deterministic; see
  ``core.controlplane.events``); scale-out means *more controllers*, not
  threads inside one: ``core.controlplane.sharded.ShardedFleet``
  partitions jobs across independent controllers over one shared
  :class:`CarbonField` and merges their reports
  (:meth:`FleetReport.merged` — totals and the ledger audit are sums, so
  merging is exact and associative). The same independence is what lets
  ``core.controlplane.parallel`` run each controller to completion in
  its own worker process over a frozen field snapshot: a controller
  never reads another's state, so a worker-per-shard run is
  bit-identical to the sequential drain, and the resumable
  :meth:`pump` doubles as the per-quantum barrier a parallel streaming
  caller pumps workers with;
* throughput learning is attributed to the leg that *bound* the rate —
  (source, relay) when leg 1 bound, (relay, dst) when leg 2 did, nothing
  when an FTN NIC cap clamped the stream (the achieved rate then says
  nothing about either pair) — and the observation fires at the
  ``JobComplete`` event so it lands in event-time order even when engine
  steps are batched between migration-check boundaries.

A copy of the reference's ``core/controlplane/controller.py``: the default
planner is a :class:`TorchCarbonPlanner` on ``device`` (``cuda`` unless the
caller passes ``"cpu"``), so admission and re-plan sweeps of eight or more
jobs run the planner kernels of ``grid_cuda``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon.energy import (HOST_PROFILES,
                                            host_profile_for_endpoint)
from repro_torch.core.carbon.field import CarbonField, default_field
from repro_torch.core.carbon.path import NetworkPath, discover_path
from repro_torch.core.carbon.score import TransferLedger
from repro_torch.core.controlplane.events import (EventLoop, ForecastShock,
                                                  JobArrival, JobComplete,
                                                  JobReady, MigrationCheck,
                                                  ReplanTick, StepTick)
from repro_torch.core.obs import metrics as obs_metrics
from repro_torch.core.obs.observer import as_observer
from repro_torch.core.obs.trace import Span
from repro_torch.core.scheduler.overlay import (FTN, MigrationEvent,
                                                OverlayScheduler)
from repro_torch.core.scheduler.planner import (Plan, TorchCarbonPlanner,
                                                TransferJob)
from repro_torch.core.scheduler.queue import CarbonAwareQueue
from repro_torch.core.transfer.engine import TransferEngine, TransferState


@dataclasses.dataclass
class _JobRecord:
    """Mutable per-job state, from admission to the report row."""
    job: TransferJob
    plan: Plan                          # latest (re-)plan; what dispatch uses
    admitted_plan: Plan
    state: Optional[TransferState] = None
    ledger: Optional[TransferLedger] = None
    source: str = ""
    current_ftn: Optional[FTN] = None
    paths: Tuple[NetworkPath, ...] = ()
    base_gbps: float = 0.0
    power_fn: Optional[Callable[[float], float]] = None  # gbps -> watts
    # (gbps, t) -> (total watts, gCO2/s): hop-resolved emission rate
    rate_fn: Optional[Callable[[float, float], Tuple[float, float]]] = None
    # per-leg gbps -> (hops,) device-power closures for the current route
    leg_w_fns: Tuple[Callable, ...] = ()
    # steps awaiting vectorized emission accounting: (t1, bytes, gbps, dt)
    pending: List[Tuple[float, float, float, float]] = \
        dataclasses.field(default_factory=list)
    # (src, dst) leg the achieved rate teaches at JobComplete (the leg
    # that bound the rate; None when an FTN NIC cap clamped the stream)
    observe_leg: Optional[Tuple[str, str]] = None
    power_segments: List[Tuple[float, Callable[[float], float]]] = \
        dataclasses.field(default_factory=list)  # (t_from, power_fn) history
    # the picklable shadow of power_segments: (t_from, src, ftn name|None,
    # relay node) per segment — everything _route_power needs to rebuild
    # the closure history bit-identically after a checkpoint restore
    route_log: List[Tuple[float, str, Optional[str], str]] = \
        dataclasses.field(default_factory=list)
    dispatch_t: float = 0.0
    completed_t: Optional[float] = None
    actual_g: float = 0.0
    bytes_wire: float = 0.0             # cumulative bytes on the wire
    migrations: int = 0
    replanned: bool = False
    sla_miss: bool = False
    ftn_sequence: Tuple[str, ...] = ()

    def __getstate__(self) -> dict:
        """Checkpoint support: the route closures (device-power /
        emission-rate functions) do not pickle and are pure functions of
        ``route_log`` + the carbon field, so the owning controller rebuilds
        them on restore (``FleetController._rebuild_routes``)."""
        d = self.__dict__.copy()
        d["paths"] = ()
        d["power_fn"] = None
        d["rate_fn"] = None
        d["leg_w_fns"] = ()
        d["power_segments"] = []
        return d


@dataclasses.dataclass(frozen=True)
class JobOutcome:
    """One FleetReport row: what was promised vs what happened."""
    job_uuid: str
    source: str
    ftn_sequence: Tuple[str, ...]
    start_t: float
    completed_t: float
    planned_emissions_g: float
    actual_emissions_g: float
    planned_duration_s: float
    actual_duration_s: float
    migrations: int
    replanned: bool
    sla_miss: bool
    feasible: bool


@dataclasses.dataclass
class FleetReport:
    """Fleet-level accounting for one controller run.

    ``total_actual_g`` is accumulated step-by-step during the run;
    ``ledger_total_g`` re-integrates every job's :class:`TransferLedger`
    after the fact — the two must agree (the example asserts within 5%),
    which catches dropped samples or double counting across migrations.
    """
    outcomes: List[JobOutcome]
    n_jobs: int
    n_completed: int
    total_planned_g: float
    total_actual_g: float
    ledger_total_g: float
    migrations: int
    replan_events: int
    plans_changed: int
    sla_misses: int
    n_events: int
    n_steps: int
    sim_span_s: float
    wall_s: float
    jobs_per_s: float
    # supervisor-surfaced fault handling: one human-readable line per
    # degradation (worker respawn, backend fallback, parallel -> off).
    # Empty on the sequential no-fault oracle, so report equality pins
    # still hold; merged() concatenates in shard order.
    degradations: Tuple[str, ...] = ()
    # obs-enabled runs only: the deterministic sim-clock span trace
    # (merged shard-major, like outcomes) and the metrics-registry
    # snapshot (merged exactly — counts add, histogram buckets add
    # elementwise). Both empty/None with obs off, so report equality
    # pins still hold.
    trace: Tuple[Span, ...] = ()
    metrics: Optional[dict] = None

    @classmethod
    def merged(cls, reports: Sequence["FleetReport"],
               wall_s: Optional[float] = None) -> "FleetReport":
        """Merge shard reports into one fleet report (exact and
        associative: every total, counter and the ledger audit are plain
        sums, so a merge of merges equals the merge of the union —
        ``tests/test_sharded.py`` property-tests this over arbitrary
        partitions).

        ``outcomes`` concatenate in shard order. ``sim_span_s`` is the
        longest shard's span (shards share the clock origin).
        ``wall_s`` defaults to the summed shard walls — the sequential
        in-process cost; a coordinator that ran shards concurrently
        passes its measured wall — and ``jobs_per_s`` is derived from it.
        """
        outcomes = [o for r in reports for o in r.outcomes]
        n_completed = sum(r.n_completed for r in reports)
        wall = sum(r.wall_s for r in reports) if wall_s is None else wall_s
        snaps = [r.metrics for r in reports
                 if getattr(r, "metrics", None)]
        return cls(
            outcomes=outcomes,
            n_jobs=sum(r.n_jobs for r in reports),
            n_completed=n_completed,
            total_planned_g=sum(r.total_planned_g for r in reports),
            total_actual_g=sum(r.total_actual_g for r in reports),
            ledger_total_g=sum(r.ledger_total_g for r in reports),
            migrations=sum(r.migrations for r in reports),
            replan_events=sum(r.replan_events for r in reports),
            plans_changed=sum(r.plans_changed for r in reports),
            sla_misses=sum(r.sla_misses for r in reports),
            n_events=sum(r.n_events for r in reports),
            n_steps=sum(r.n_steps for r in reports),
            sim_span_s=max((r.sim_span_s for r in reports), default=0.0),
            wall_s=wall,
            jobs_per_s=n_completed / wall if wall > 0 else 0.0,
            degradations=tuple(d for r in reports
                               for d in getattr(r, "degradations", ())),
            trace=tuple(sp for r in reports
                        for sp in getattr(r, "trace", ())),
            metrics=obs_metrics.merged(snaps) if snaps else None)

    def summary(self) -> str:
        dev = (self.total_actual_g / self.total_planned_g - 1.0) * 100 \
            if self.total_planned_g else 0.0
        deg = f"\ndegradations: {'; '.join(self.degradations)}" \
            if self.degradations else ""
        return (
            f"fleet: {self.n_completed}/{self.n_jobs} jobs in "
            f"{self.sim_span_s / 3600:.1f} simulated h "
            f"({self.wall_s:.1f} s wall, {self.jobs_per_s:.0f} jobs/s)\n"
            f"emissions: planned {self.total_planned_g / 1000:.1f} kg, "
            f"actual {self.total_actual_g / 1000:.1f} kg ({dev:+.1f}%), "
            f"ledger audit {self.ledger_total_g / 1000:.1f} kg\n"
            f"adaptation: {self.migrations} migrations, "
            f"{self.replan_events} re-plan sweeps "
            f"({self.plans_changed} plans changed), "
            f"{self.sla_misses} SLA misses\n"
            f"runtime: {self.n_events} events, {self.n_steps} engine steps"
            f"{deg}")


class FleetController:
    """Event-driven fleet runtime over planner + queue + engine + overlay.

    Policies are plain methods keyed by event type (see ``_HANDLERS``); to
    add one, define an ``Event`` subclass, push it, and register a handler —
    the ROADMAP architecture notes walk through an example.

    ``device`` goes to the default planner (``cuda`` unless given; without
    a GPU pass ``"cpu"``, or construction raises); a passed ``planner``
    keeps its own.
    """

    def __init__(self, ftns: Sequence[FTN], *,
                 planner: Optional[TorchCarbonPlanner] = None,
                 engine: Optional[TransferEngine] = None,
                 field: Optional[CarbonField] = None,
                 replan_every_s: float = 3600.0,
                 migrate_check_every_s: float = 900.0,
                 migration_threshold: float = 400.0,
                 hysteresis: float = 0.9,
                 drift_tol: float = 0.05,
                 max_migrations_per_job: int = 4,
                 obs=None,
                 device=None):
        self.field = field or default_field()
        self.ftns = list(ftns)
        self._ftn_by_name = {f.name: f for f in self.ftns}
        self.planner = planner or TorchCarbonPlanner(
            self.ftns, field=self.field, device=device)
        # observability (core.obs): spans + metrics live as plain
        # controller state, so they checkpoint/replay and ride the worker
        # pipe protocol for free; obs=None keeps every hot path untouched
        self.obs = as_observer(obs)
        if self.obs is not None:
            self.planner.observe_with(self.obs)
        # re-plans during a shock see the drift: the planner's forecast
        # emission integral is scaled by the measured zone factors
        # (persistence nowcast over the shock window)
        self.planner.emission_scale_fn = self._emission_scale
        self.events = EventLoop()
        self.queue = CarbonAwareQueue(self.planner, events=self.events)
        # one ThroughputModel: completions observed by the engine feed the
        # planner's next predictions
        self.engine = engine or TransferEngine(
            model=self.planner.throughput, field=self.field)
        self.overlay = OverlayScheduler(self.ftns,
                                        threshold=migration_threshold,
                                        hysteresis=hysteresis)
        self.replan_every_s = replan_every_s
        self.migrate_check_every_s = migrate_check_every_s
        self.drift_tol = drift_tol
        self.max_migrations_per_job = max_migrations_per_job
        # streaming callers (core.controlplane.streaming) hook completions
        # here: each callable sees (t, job) at the JobComplete event, in
        # event-time order — the backfill policy's capacity signal
        self.completion_hooks: List[Callable[[float, TransferJob], None]] = []
        self._records: Dict[str, _JobRecord] = {}
        self._active: Dict[str, _JobRecord] = {}
        self._shocks: List[ForecastShock] = []
        self._outstanding = 0
        self._ticks_armed = False
        self._next_migration_t = float("inf")
        self._until = float("inf")
        self._t_first: Optional[float] = None
        self._t_last = 0.0
        self._wall_s = 0.0             # accumulated pump() wall time
        self.migrations = 0
        self.replan_events = 0
        self.plans_changed = 0
        self.sla_misses = 0
        self.n_steps = 0
        self.n_events = 0

    # --- checkpoint support (controlplane.persistence) ----------------------
    def __getstate__(self) -> Dict:
        """One pickle of the controller is the whole-shard checkpoint: the
        event heap, queue, ledger, records and noise anchors all travel in
        a single dump so shared identity (queue handles aliasing heap
        entries, the one ThroughputModel) survives via the pickle memo.
        Completion hooks are caller wiring — callers re-register them on
        restore (see ``StreamingGateway``)."""
        d = self.__dict__.copy()
        d["completion_hooks"] = []
        return d

    def __setstate__(self, d: Dict) -> None:
        self.__dict__.update(d)
        self.completion_hooks = []
        # the planner's drift hook is a bound method of this controller —
        # nulled by TorchCarbonPlanner.__getstate__, re-wired here
        self.planner.emission_scale_fn = self._emission_scale
        for rec in self._records.values():
            self._rebuild_routes(rec)

    def _rebuild_routes(self, rec: "_JobRecord") -> None:
        """Replay a restored record's ``route_log`` through
        :meth:`_route_power`, repopulating the closure history
        (``power_segments``) and the current-route closures that
        ``_JobRecord.__getstate__`` dropped. Bit-identical to the
        uninterrupted run because ``_route_power`` is a pure function of
        the route and the carbon field — the (drifted) throughput model
        never enters."""
        rec.power_segments = []
        if not rec.route_log:
            return
        for t, source, ftn_name, relay in rec.route_log:
            ftn = (self._ftn_by_name[ftn_name]
                   if ftn_name is not None else None)
            _legs, paths, power_fn, rate_fn, w_fns = \
                self._route_power(rec.job, source, ftn, relay)
            rec.power_segments.append((t, power_fn))
        rec.paths, rec.leg_w_fns = paths, w_fns
        rec.power_fn, rec.rate_fn = power_fn, rate_fn

    # --- submission / drift injection --------------------------------------
    def submit(self, job: TransferJob, plan: Optional[Plan] = None,
               at: Optional[float] = None) -> None:
        """Enqueue one arrival. ``plan`` optionally carries an
        admission-time plan (the sharded fleet's batched admission); None
        means the queue plans the job when the arrival fires. ``at``
        schedules the arrival later than its submission — a streaming
        gateway's micro-batch close delay (never earlier: the clock
        floor still applies)."""
        self._outstanding += 1
        t = job.submitted_t if at is None else max(at, job.submitted_t)
        self.events.push(JobArrival(t=max(t, self.events.now),
                                    job=job, plan=plan))

    def submit_many(self, jobs: Sequence[TransferJob],
                    plans: Optional[Sequence[Optional[Plan]]] = None) -> None:
        """Enqueue many arrivals; ``plans`` optionally carries precomputed
        admission plans positionally (a gateway's micro-batched planning —
        parity with :meth:`submit`'s ``plan=``)."""
        if plans is not None and len(plans) != len(jobs):
            raise ValueError(f"plans ({len(plans)}) must match jobs "
                             f"({len(jobs)})")
        for i, job in enumerate(jobs):
            self.submit(job, plan=plans[i] if plans is not None else None)

    def inject_shock(self, t: float, factor: float, *,
                     duration_s: float = float("inf"),
                     zones: Optional[Sequence[str]] = None) -> None:
        """Schedule a CI drift: measured CI of paths crossing ``zones``
        becomes ``factor`` x the forecast trace for ``duration_s``."""
        self.events.push(ForecastShock(
            t=t, factor=factor, until=t + duration_s,
            zones=tuple(zones) if zones is not None else None))

    # --- measured CI (forecast trace x active shocks) -----------------------
    def _zone_factor(self, zone: str, t: float) -> float:
        f = 1.0
        for s in self._shocks:
            if s.t - 1e-9 <= t <= s.until and (s.zones is None
                                               or zone in s.zones):
                f *= s.factor
        return f

    def _emission_scale(self, path: NetworkPath,
                        ts: "np.ndarray") -> "np.ndarray":
        """Planner drift hook: per-start-slot multiplier on a leg's
        forecast emissions — the hop-mean of the active zone shock factors
        for starts inside a shock window (a coarse persistence nowcast;
        the hop-resolved truth is what the controller then measures)."""
        scale = np.ones(np.shape(ts))
        for s in self._shocks:
            zf = [s.factor if (s.zones is None or h.zone in s.zones)
                  else 1.0 for h in path.hops]
            f_path = sum(zf) / len(zf)
            if f_path != 1.0:
                scale = np.where((ts >= s.t - 1e-9) & (ts <= s.until),
                                 scale * f_path, scale)
        return scale

    def _zone_scale_at(self, t: float
                       ) -> Optional[Callable[[str], float]]:
        """zone -> shock multiplier hook at time t (None when no shock)."""
        if not self._shocks:
            return None
        return lambda zone: self._zone_factor(zone, t)

    def measured_path_ci(self, path: NetworkPath, t: float) -> float:
        """What the in-flight transfer actually sees: the forecast trace with
        any active shock applied *per shocked zone* (hops in clean zones
        keep their forecast CI — a drift in MISO does not dirty NYISO)."""
        return self.field.path_ci_scalar(path, t,
                                         zone_scale=self._zone_scale_at(t))

    def _observed_ci(self, rec: _JobRecord, t: float) -> float:
        tot = sum(self.measured_path_ci(p, t) for p in rec.paths)
        return tot / max(len(rec.paths), 1)

    # --- the loop -----------------------------------------------------------
    def run(self, until: Optional[float] = None) -> FleetReport:
        """Drain to ``until`` (or fully) and report. ``run`` is a terminal
        :meth:`pump` + :meth:`_report`; a streaming caller pumps in
        watermark increments instead and calls ``run`` once at the end —
        the report's wall is the accumulated pump time either way."""
        self.pump(until)
        return self._report(self._wall_s)

    def pump(self, until: Optional[float] = None, *,
             strict: bool = False,
             horizon: Optional[float] = None) -> int:
        """Resumable drain: process events with ``t <= until`` (or
        ``t < until`` when ``strict`` — the streaming gateway's watermark
        cut, so a micro-batch anchored *at* the watermark can still be
        admitted ahead of same-instant runtime events). Unlike a terminal
        ``run``, nothing past the cut is popped or dropped, so pumping in
        increments replays exactly the run a single drain would have —
        pinned by ``tests/test_streaming.py``. Returns the number of
        events processed.

        ``horizon`` is the in-flight *step-batch* clamp and defaults to
        ``until`` (the terminal-run freeze). A streaming caller passes
        its own run horizon instead: a watermark cut must not fragment
        step batches — that would change the event count vs a batch run —
        while the final horizon still freezes transfers exactly where a
        terminal ``run(until)`` would."""
        wall0 = time.perf_counter()
        if horizon is None:
            horizon = until
        self._until = float("inf") if horizon is None else horizon
        n0 = self.n_events
        try:
            while True:
                t = self.events.peek_t()
                if t is None or (until is not None
                                 and (t >= until if strict else t > until)):
                    break
                ev = self.events.pop()
                self.n_events += 1
                if self._t_first is None:
                    self._t_first = ev.t
                self._t_last = max(self._t_last, ev.t)
                self._HANDLERS[type(ev)](self, ev)
        finally:
            self._wall_s += time.perf_counter() - wall0
        return self.n_events - n0

    def _arm_ticks(self, t: float) -> None:
        if not self._ticks_armed:
            self._ticks_armed = True
            self.events.push(ReplanTick(t=t + self.replan_every_s))
            self.events.push(MigrationCheck(t=t + self.migrate_check_every_s))
            self._next_migration_t = t + self.migrate_check_every_s

    # --- handlers -----------------------------------------------------------
    def _on_arrival(self, ev: JobArrival) -> None:
        self._arm_ticks(ev.t)
        plan = self.queue.submit(ev.job, plan=ev.plan)
        self._records[ev.job.uuid] = _JobRecord(
            job=ev.job, plan=plan, admitted_plan=plan)
        if self.obs is not None:
            # the admit span carries the counterfactual anchor: greedy_g
            # is the best feasible slot-0 cell from the admission grid
            self.obs.span(
                "admit", ev.t, ev.job.uuid,
                ftn=plan.ftn, source=plan.source,
                replica0=ev.job.replicas[0],
                start_t=plan.start_t, submitted_t=ev.job.submitted_t,
                planned_g=plan.predicted_emissions_g,
                greedy_g=plan.greedy_g,
                ci=plan.predicted_avg_ci, feasible=plan.feasible)
            self.obs.counter("fleet_jobs_admitted_total").inc()

    def _on_ready(self, ev: JobReady) -> None:
        self.queue.claim(ev)
        rec = self._records[ev.job.uuid]
        if (ev.plan.source, ev.plan.ftn, ev.plan.start_t) != (
                rec.admitted_plan.source, rec.admitted_plan.ftn,
                rec.admitted_plan.start_t):
            rec.replanned = True
        rec.plan = ev.plan
        self._dispatch(rec, ev.t)

    def _dispatch(self, rec: _JobRecord, t: float) -> None:
        job, plan = rec.job, rec.plan
        rec.source = plan.source
        rec.current_ftn = self._ftn_by_name.get(plan.ftn)
        rec.dispatch_t = t
        rec.ftn_sequence = (plan.ftn,)
        rec.ledger = TransferLedger(job.uuid)
        rec.state = self.engine.start(
            job.uuid, plan.source, plan.ftn, job.size_bytes, t,
            parallelism=job.parallelism, concurrency=job.concurrency,
            pipelining=job.pipelining)
        self._reroute(rec, t)
        self._active[job.uuid] = rec
        self.events.push(StepTick(t=t, job_uuid=job.uuid))
        if self.obs is not None:
            self.obs.span("dispatch", t, job.uuid,
                          ftn=plan.ftn, source=plan.source,
                          gbps=rec.base_gbps,
                          ci=self._observed_ci(rec, t),
                          replanned=rec.replanned)
            self.obs.gauge("fleet_inflight").set(len(self._active))

    def _route_for(self, job: TransferJob, source: str,
                   ftn: Optional[FTN], relay_node: str
                   ) -> Tuple[Tuple[NetworkPath, ...], float,
                              Callable[[float], float],
                              Callable[[float, float], Tuple[float, float]],
                              Tuple[Callable, ...],
                              Optional[Tuple[str, str]]]:
        """(paths, bottleneck gbps, gbps->watts power model,
        (gbps, t)->(watts, gCO2/s) measured emission rate, per-leg device
        weight closures, and the (src, dst) leg the achieved rate should
        teach — None when nothing binds) for running ``job`` as
        source -> relay_node [-> job.dst] — shared by dispatch,
        post-migration rerouting and the migration emission guard."""
        legs, paths, power_fn, rate_fn, w_fns = \
            self._route_power(job, source, ftn, relay_node)
        leg_gbps = [self.engine.model.predict(a, b, job.parallelism,
                                              job.concurrency)
                    for a, b in legs]
        base = min(leg_gbps)
        if ftn is not None:
            base = min(base, ftn.max_gbps)
        # the achieved rate teaches the model about the leg that bound it
        # — leg 1, or (relay, dst) when the second hop is the bottleneck;
        # an FTN NIC cap binds neither and would poison the correction
        observe_leg: Optional[Tuple[str, str]] = None
        if base >= leg_gbps[0] - 1e-12:
            observe_leg = legs[0]
        elif len(legs) > 1 and base >= leg_gbps[1] - 1e-12:
            observe_leg = legs[1]
        return paths, base, power_fn, rate_fn, w_fns, observe_leg

    def _route_power(self, job: TransferJob, source: str,
                     ftn: Optional[FTN], relay_node: str
                     ) -> Tuple[List[Tuple[str, str]],
                                Tuple[NetworkPath, ...],
                                Callable[[float], float],
                                Callable[[float, float],
                                         Tuple[float, float]],
                                Tuple[Callable, ...]]:
        """The closure half of :meth:`_route_for` — (legs, paths, power_fn,
        rate_fn, per-leg weight fns). A pure function of the route and the
        carbon field (the throughput model never enters), which is what
        lets a checkpoint restore replay a record's ``route_log`` into a
        bit-identical closure history (:meth:`_rebuild_routes`)."""
        legs: List[Tuple[str, str]] = [(source, relay_node)]
        if relay_node != job.dst:
            legs.append((relay_node, job.dst))
        paths = tuple(discover_path(a, b) for a, b in legs)
        relay_pm = (ftn.power_model if ftn is not None
                    else host_profile_for_endpoint(relay_node))
        sender_pm = HOST_PROFILES[self.engine.src_profile]
        receivers = [relay_pm] if len(paths) == 1 else \
            [relay_pm, host_profile_for_endpoint(job.dst)]
        senders = [sender_pm] if len(paths) == 1 else [sender_pm, relay_pm]
        w_fns = tuple(self.field.device_weight_fn(p, s, r, job.parallelism,
                                                  job.concurrency)
                      for p, s, r in zip(paths, senders, receivers))

        def power_fn(gbps, _fns=w_fns):
            """Total device watts at a rate; broadcasts over gbps arrays
            (the vectorized ledger audit integrates whole segments)."""
            tot = 0.0
            for fn in _fns:
                tot = tot + fn(gbps).sum(axis=0)
            return tot

        def rate_fn(gbps: float, t: float, _paths=paths, _fns=w_fns
                    ) -> Tuple[float, float]:
            """(total watts, gCO2/s) at the *measured* per-hop CI — the
            same device-power x device-CI product the planner integrates,
            so planned-vs-actual deviations mean drift, not model skew."""
            scale = self._zone_scale_at(t)
            w_tot, rate = 0.0, 0.0
            for p, fn in zip(_paths, _fns):
                w = fn(gbps)
                w_tot += float(w.sum())
                rate += self.field.path_device_rate_scalar(
                    p, w, t, zone_scale=scale)
            return w_tot, rate / 3.6e6

        return legs, paths, power_fn, rate_fn, w_fns

    def _reroute(self, rec: _JobRecord, t: float) -> None:
        """(Re)derive paths, bottleneck rate and device power for the
        current route — on dispatch and after every migration. Callers
        must :meth:`_flush` the old route's pending steps first."""
        paths, base, power_fn, rate_fn, w_fns, observe_leg = \
            self._route_for(rec.job, rec.state.src, rec.current_ftn,
                            rec.state.dst)
        rec.paths, rec.base_gbps = paths, base
        rec.power_fn, rec.rate_fn = power_fn, rate_fn
        rec.leg_w_fns = w_fns
        # the controller observes at the JobComplete event, not inside the
        # engine step: batched stepping may *process* a completion early,
        # and the observation must land in event-time order
        rec.state.observe_on_finish = False
        rec.observe_leg = observe_leg
        rec.power_segments.append((t, power_fn))
        rec.route_log.append((t, rec.state.src,
                              rec.current_ftn.name
                              if rec.current_ftn is not None else None,
                              rec.state.dst))

    def _on_step(self, ev: StepTick) -> None:
        rec = self._active.get(ev.job_uuid)
        if rec is None:
            return
        st = rec.state
        # Steps run back-to-back up to the next migration-check boundary —
        # the only policy that reads in-flight state (stepping is pure
        # congestion x rate mechanics; measured CI never enters it, so
        # crossing a shock instant mid-batch is exact *because* scoring is
        # deferred to a flush that runs after the shock event popped). A
        # transfer that can no longer migrate steps straight to
        # completion. The batch never passes the run horizon: a `until`
        # cut must freeze jobs in flight exactly like per-event stepping.
        boundary = self._next_migration_t \
            if (rec.current_ftn is not None
                and rec.migrations < self.max_migrations_per_job) \
            else float("inf")
        boundary = min(boundary, self._until)
        path, base = rec.paths[0], rec.base_gbps
        while True:
            obs = self.engine.step(st, path=path, base_gbps=base)
            self.n_steps += 1
            rec.bytes_wire += obs.bytes_delta
            # emission accounting is deferred: steps buffer until the
            # route changes (migration) or the job ends, then one
            # vectorized _flush scores the whole segment
            rec.pending.append((st.t_now, rec.bytes_wire, obs.gbps,
                                obs.step_s))
            if obs.finished:
                # scored at the JobComplete event, not here: a shock that
                # fires mid-batch (t_shock <= t_finish) must pop first so
                # the flush sees it
                self._complete(rec, st.t_now)
                return
            if st.t_now >= boundary - 1e-9:
                break
        self.events.push(StepTick(t=st.t_now, job_uuid=ev.job_uuid))

    def _flush(self, rec: _JobRecord) -> None:
        """Score a segment of buffered steps against the *current* route:
        actual emissions accumulate as device-power x measured device-CI x
        step seconds (the hop-resolved product the planner integrates),
        and each step lands in the ledger with the power-weighted
        effective CI — so re-integrating the ledger (power x ci x dt)
        reproduces this accounting. Must run before a reroute retires the
        segment's route and before reporting."""
        if not rec.pending:
            return
        ts, bytes_w, gbps, step_s = map(np.asarray, zip(*rec.pending))
        rec.pending.clear()
        w_tot = np.zeros(ts.shape)
        rate = np.zeros(ts.shape)
        for p, w_fn in zip(rec.paths, rec.leg_w_fns):
            W = w_fn(gbps)                               # (hops, n)
            w_tot += W.sum(axis=0)
            M = self.field.hop_ci_matrix(p, ts)
            if self._shocks:
                M = M * self._zone_scale_rows(p, ts)
            rate += (W * M).sum(axis=0)
        g_per_s = rate / 3.6e6
        seg_g = float((g_per_s * step_s).sum())
        rec.actual_g += seg_g
        ci_led = g_per_s * 3.6e6 / np.maximum(w_tot, 1e-9)
        for t, b, ci, g in zip(ts, bytes_w, ci_led, gbps):
            rec.ledger.record(float(t), float(b), float(ci), float(g))
        if self.obs is not None:
            # one aggregated span per flushed step segment (per route)
            self.obs.span("step", float(ts[-1]), rec.job.uuid,
                          n_steps=int(len(ts)),
                          bytes_wire=float(bytes_w[-1]), actual_g=seg_g)

    def _zone_scale_rows(self, path: NetworkPath,
                         ts: np.ndarray) -> np.ndarray:
        """(hops, n_ts) shock multipliers — the vectorized counterpart of
        :meth:`_zone_factor` (same multiplicative shock order)."""
        cache: Dict[str, np.ndarray] = {}
        rows = []
        for h in path.hops:
            r = cache.get(h.zone)
            if r is None:
                r = np.ones(ts.shape)
                for s in self._shocks:
                    if s.zones is None or h.zone in s.zones:
                        r = np.where((ts >= s.t - 1e-9) & (ts <= s.until),
                                     r * s.factor, r)
                cache[h.zone] = r
            rows.append(r)
        return np.stack(rows)

    def _complete(self, rec: _JobRecord, t: float) -> None:
        del self._active[rec.job.uuid]
        rec.completed_t = t
        deadline = rec.job.submitted_t + rec.job.sla.deadline_s
        rec.sla_miss = t > deadline + 1e-6
        if rec.sla_miss:
            self.sla_misses += 1
        self._outstanding -= 1
        self.events.push(JobComplete(t=t, job_uuid=rec.job.uuid))

    def _on_complete(self, ev: JobComplete) -> None:
        """Feed the achieved rate to the leg that bound it — (source,
        relay) when leg 1 bound, (relay, dst) when the relay's second hop
        was the bottleneck (the ROADMAP open item: leg-2 learning was
        forfeited before), nothing under an FTN NIC cap. The observation
        happens *here*, at the completion's event time, so batched
        stepping cannot leak future throughput into earlier re-plans.
        Policies that react to completions (e.g. backfill admission)
        also hook here."""
        rec = self._records[ev.job_uuid]
        # settle the final segment now: every ForecastShock at or before
        # the completion instant has popped, so the flush scores the
        # batch-stepped tail against the CI it actually saw
        self._flush(rec)
        if rec.observe_leg is not None:
            st = rec.state
            achieved = ((st.bytes_done - st.bytes_at_start) * 8.0 / 1e9
                        / max(st.t_now - st.t_started, 1e-9))
            self.engine.model.observe(*rec.observe_leg,
                                      rec.job.parallelism,
                                      rec.job.concurrency, achieved)
            if self.obs is not None:
                self.obs.span("observe", ev.t, rec.job.uuid,
                              src=rec.observe_leg[0],
                              dst=rec.observe_leg[1],
                              achieved_gbps=achieved)
        if self.obs is not None:
            self.obs.span(
                "complete", ev.t, rec.job.uuid,
                planned_g=rec.plan.predicted_emissions_g,
                actual_g=rec.actual_g, sla_miss=rec.sla_miss,
                migrations=rec.migrations,
                duration_s=ev.t - rec.dispatch_t,
                ftn_sequence=rec.ftn_sequence)
            self.obs.counter("fleet_jobs_completed_total").inc()
            if rec.sla_miss:
                self.obs.counter("fleet_sla_miss_total").inc()
            self.obs.gauge("fleet_inflight").set(len(self._active))
        for hook in self.completion_hooks:
            hook(ev.t, rec.job)

    def _on_replan(self, ev: ReplanTick) -> None:
        if len(self.queue):
            changed = self.queue.replan_pending(ev.t,
                                                drift_tol=self.drift_tol)
            self.replan_events += 1
            self.plans_changed += changed
            if self.obs is not None:
                self.obs.span("plan", ev.t, cause="replan_tick",
                              queued=len(self.queue), changed=changed)
                self.obs.counter("fleet_replan_sweeps_total").inc()
                self.obs.histogram("fleet_queue_depth") \
                    .observe(len(self.queue))
        if self._outstanding > 0:
            self.events.push(ReplanTick(t=ev.t + self.replan_every_s))
        else:
            self._ticks_armed = False

    def _on_migration_check(self, ev: MigrationCheck) -> None:
        """The §4.3 migration decision as a controller policy: the overlay's
        CI threshold detects drift on the *measured* route, but the target is
        chosen by projected remaining emissions over each candidate's full
        route (end-system power is idle-dominated, so a CI-only ranking can
        hand the job to a node that multiplies energy by its slowdown). A
        hand-off must cut projected remaining gCO2 by the overlay's
        hysteresis margin and still meet the SLA deadline."""
        if self.obs is not None:
            self.obs.histogram("fleet_inflight_at_check") \
                .observe(len(self._active))
        for uuid, rec in list(self._active.items()):
            if rec.current_ftn is None:
                continue               # infeasible fallback runs direct
            if rec.migrations >= self.max_migrations_per_job:
                continue               # no hand-off thrash under long drift
            ci = self._observed_ci(rec, ev.t)
            if ci <= self.overlay.threshold:
                continue
            deadline_t = rec.job.submitted_t + rec.job.sla.deadline_s
            rem_bits = rec.state.remaining * 8.0
            g_stay = rec.rate_fn(rec.base_gbps, ev.t)[1] \
                * rem_bits / (rec.base_gbps * 1e9)
            best = None                # (g_move, ftn)
            for ftn in self.ftns:
                if ftn.name == rec.current_ftn.name:
                    continue
                _, base, _, rate, _, _ = self._route_for(rec.job, rec.source,
                                                         ftn, ftn.name)
                rem_s = rem_bits / (base * 1e9)
                if rec.state.t_now + rem_s > deadline_t + 1e-6:
                    continue           # greener-but-late violates the SLA
                g_move = rate(base, ev.t)[1] * rem_s
                if best is None or g_move < best[0]:
                    best = (g_move, ftn)
            if best is None or best[0] >= self.overlay.hysteresis * g_stay:
                continue
            g_move, ftn = best
            self.overlay.events.append(MigrationEvent(
                t=ev.t, from_ftn=rec.current_ftn.name, to_ftn=ftn.name,
                bytes_done=rec.state.bytes_done, ci_at_migration=ci))
            self._flush(rec)           # retire the old route's segment
            if self.obs is not None:
                self.obs.span("migrate", ev.t, uuid,
                              from_ftn=rec.current_ftn.name,
                              to_ftn=ftn.name, ci=ci,
                              g_stay=g_stay, g_move=g_move,
                              bytes_done=rec.state.bytes_done)
                self.obs.counter("fleet_migrations_total").inc()
            token = rec.state.checkpoint()
            rec.migrations += 1
            self.migrations += 1
            rec.current_ftn = ftn
            rec.ftn_sequence += (ftn.name,)
            rec.state = self.engine.start(
                uuid, rec.source, ftn.name, rec.job.size_bytes,
                rec.state.t_now, parallelism=rec.job.parallelism,
                concurrency=rec.job.concurrency,
                pipelining=rec.job.pipelining, resume=token)
            self._reroute(rec, rec.state.t_now)
        if self._outstanding > 0:
            self.events.push(
                MigrationCheck(t=ev.t + self.migrate_check_every_s))
            self._next_migration_t = ev.t + self.migrate_check_every_s
        else:
            self._ticks_armed = False
            self._next_migration_t = float("inf")

    def _on_shock(self, ev: ForecastShock) -> None:
        self._shocks.append(ev)
        if self.obs is not None:
            self.obs.span("shock", ev.t, factor=ev.factor, until=ev.until,
                          zones=ev.zones)
        # forecast drift: full re-plan of everything still queued, now
        if len(self.queue):
            changed = self.queue.replan_pending(ev.t, drift_tol=None)
            self.replan_events += 1
            self.plans_changed += changed
            if self.obs is not None:
                self.obs.span("plan", ev.t, cause="shock",
                              queued=len(self.queue), changed=changed)
                self.obs.counter("fleet_replan_sweeps_total").inc()

    _HANDLERS = {
        JobArrival: _on_arrival,
        JobReady: _on_ready,
        StepTick: _on_step,
        JobComplete: _on_complete,
        ReplanTick: _on_replan,
        MigrationCheck: _on_migration_check,
        ForecastShock: _on_shock,
    }

    # --- reporting ----------------------------------------------------------
    def _ledger_emissions_g(self, rec: _JobRecord) -> float:
        """Re-integrate a job's ledger samples against its route power
        history — the after-the-fact audit of the step accumulator. Each
        sample charges the segment (route) active at its *start*; whole
        segments integrate as one vectorized power x ci x dt pass."""
        if rec.ledger is None or not rec.ledger.samples:
            return 0.0
        samples = rec.ledger.samples
        n = len(samples)
        ts = np.fromiter((s.t for s in samples), np.float64, n)
        ci = np.fromiter((s.ci for s in samples), np.float64, n)
        gb = np.fromiter((s.throughput_gbps for s in samples), np.float64, n)
        prevs = np.concatenate([[rec.dispatch_t], ts[:-1]])
        dts = ts - prevs
        starts = np.array([t for t, _ in rec.power_segments])
        seg_idx = np.maximum(
            np.searchsorted(starts, prevs + 1e-9, side="right") - 1, 0)
        g = 0.0
        for j, (_, power_fn) in enumerate(rec.power_segments):
            m = seg_idx == j
            if m.any():
                g += float((power_fn(gb[m]) * ci[m] * dts[m] / 3.6e6).sum())
        return g

    def _report(self, wall_s: float) -> FleetReport:
        outcomes = []
        total_planned = total_actual = ledger_total = 0.0
        n_completed = 0
        for rec in self._records.values():
            # jobs cut off by an `until` horizon (in flight, or completed
            # with their JobComplete event past the cut) still settle
            self._flush(rec)
        for rec in self._records.values():
            done = rec.completed_t is not None
            if done:
                n_completed += 1
            total_planned += rec.plan.predicted_emissions_g \
                if rec.plan.feasible else 0.0
            total_actual += rec.actual_g
            ledger_total += self._ledger_emissions_g(rec)
            outcomes.append(JobOutcome(
                job_uuid=rec.job.uuid, source=rec.source,
                ftn_sequence=rec.ftn_sequence,
                start_t=rec.dispatch_t,
                completed_t=rec.completed_t if done else float("nan"),
                planned_emissions_g=rec.plan.predicted_emissions_g,
                actual_emissions_g=rec.actual_g,
                planned_duration_s=rec.plan.predicted_duration_s,
                actual_duration_s=(rec.completed_t - rec.dispatch_t)
                if done else float("nan"),
                migrations=rec.migrations, replanned=rec.replanned,
                sla_miss=rec.sla_miss, feasible=rec.plan.feasible))
        span = (self._t_last - self._t_first) if self._t_first is not None \
            else 0.0
        trace: Tuple[Span, ...] = ()
        metrics = None
        if self.obs is not None:
            if self.obs.registry is not None:
                # event/step totals mirror into the registry once, here,
                # so the pump hot loop never pays per-event instruments
                reg = self.obs.registry
                reg.counter("fleet_events_total").value = \
                    float(self.n_events)
                reg.counter("fleet_engine_steps_total").value = \
                    float(self.n_steps)
            trace = self.obs.trace()
            metrics = self.obs.metrics_snapshot()
        return FleetReport(
            outcomes=outcomes, n_jobs=len(self._records),
            n_completed=n_completed, total_planned_g=total_planned,
            total_actual_g=total_actual, ledger_total_g=ledger_total,
            migrations=self.migrations, replan_events=self.replan_events,
            plans_changed=self.plans_changed, sla_misses=self.sla_misses,
            n_events=self.n_events, n_steps=self.n_steps,
            sim_span_s=span, wall_s=wall_s,
            jobs_per_s=n_completed / wall_s if wall_s > 0 else 0.0,
            trace=trace, metrics=metrics)
