"""Sharded fleet scale-out: partitioned controllers over one carbon field.

The :class:`FleetController` is single-threaded by design — one event loop,
one monotone clock, deterministic replay. Scale-out therefore means *more
controllers*, not threads inside one: :class:`ShardedFleet` partitions the
job stream across N independent ``FleetController`` instances that share a
single :class:`CarbonField` (one noise/trace cache — the expensive hashed
state — is warmed once and read by every shard) and exposes the same
``submit / submit_many / inject_shock / run`` API. Each shard owns its own
planner, throughput model, engine and overlay, so shard runs are exactly
the runs the same jobs would have had on a lone controller fed only that
partition — which is what makes :meth:`FleetReport.merged` an *exact*
merge: totals, counters and the ledger re-integration audit are plain sums.

Admission is batched: ``submit_many`` plans the whole fleet's window
through one fleet-level ``plan_batch`` — with the default fused batch
backend that is one pass of the two CUDA planner kernels per memory chunk
(``scheduler/grid_cuda.py``), not a per-job grid scan — and hands the
precomputed plans to the controllers via ``JobArrival.plan``. In-run
re-plan sweeps batch the same way through the shard's own planner, so
drifted queues re-score as one call too.

Partitioning is deterministic and process-stable (blake2b, not Python's
salted ``hash``):

* ``"hash"`` — uuid-hashed, uniform spread (the default);
* ``"source"`` — by first replica endpoint, so a site's jobs land on one
  shard and its throughput-model corrections stay coherent;
* any callable ``job -> int``.

Execution is sequential in-process by default (``parallel="off"`` — the
pinned deterministic oracle); ``parallel="fork" | "spawn" | "auto"``
swaps the in-process controllers for :class:`ShardProxy` handles onto a
:class:`ParallelShardRunner` — one worker process per shard over a frozen
carbon-field snapshot, same API, bit-identical merged totals on the same
shard planner backend (see ``core.controlplane.parallel``).

A copy of the reference's ``core/controlplane/sharded.py``: the shard and
admission planners are :class:`TorchCarbonPlanner` on ``device`` (``cuda``
unless the caller passes ``"cpu"``). A CUDA context does not survive a
fork, so fork workers plan on the numpy oracle on the CPU, and a fork
fleet whose shards would plan on the card is refused.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.carbon.field import CarbonField, default_field
from repro_torch.core.controlplane.controller import (FleetController,
                                                      FleetReport)
from repro_torch.core.controlplane.parallel import (
    FORK_SAFE_BACKEND, FaultPlan, ParallelShardRunner, ShardSpec,
    SupervisionPolicy, resolve_mode)
from repro_torch.core.obs import metrics as obs_metrics
from repro_torch.core.obs.metrics import log_bounds
from repro_torch.core.obs.observer import ObsConfig, as_observer
from repro_torch.core.scheduler.overlay import FTN
from repro_torch.core.scheduler.planner import (TorchCarbonPlanner,
                                                TransferJob)

# supervisor recovery-latency histogram bounds: 1 ms .. 1000 s
_RECOVERY_BOUNDS = log_bounds(1e-3, 1e3, per_decade=2)


def _stable_hash(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass(frozen=True)
class PumpQuanta:
    """Adaptive pump-quantum schedule for :meth:`ShardedFleet.pump_all`.

    A fixed-size pump quantum wastes barriers: far from any batch close or
    announced shock nothing interesting happens per quantum, while right
    at a boundary a coarse quantum over-shoots the instant the caller
    actually cares about. ``PumpQuanta`` declares a two-speed schedule —
    ``coarse_s`` strides through idle sim time, ``fine_s`` strides inside
    ``band_s`` of the next *boundary* (a batch close, a shock onset) — and
    :func:`quantum_schedule` expands it into the exact ascending cut list
    a pump loop runs.

    The schedule is a pure function of ``(t0, t1, boundaries, quanta)``:
    no wall clock, no fleet state, so two runs over the same sim inputs
    pump through identical cuts (pinned by ``tests/test_pipeline.py``).
    """
    coarse_s: float = 3600.0
    fine_s: float = 300.0
    band_s: float = 900.0

    def __post_init__(self):
        if self.fine_s <= 0:
            raise ValueError(f"fine_s must be > 0, got {self.fine_s}")
        if self.coarse_s < self.fine_s:
            raise ValueError(f"coarse_s ({self.coarse_s}) must be >= "
                             f"fine_s ({self.fine_s})")
        if self.band_s < 0:
            raise ValueError(f"band_s must be >= 0, got {self.band_s}")


def quantum_schedule(t0: float, t1: float, boundaries: Sequence[float],
                     quanta: PumpQuanta) -> List[float]:
    """Expand a :class:`PumpQuanta` into the ascending pump cuts covering
    ``(t0, t1]``: each cut steps ``fine_s`` when the next boundary (any of
    ``boundaries`` ahead of the cursor, or ``t1`` itself — the batch close
    is always a boundary) is within ``band_s``, else ``coarse_s``, and
    never strides *past* a boundary — the schedule lands exactly on each
    one, which is what makes the fine band meaningful. The final cut is
    exactly ``t1``. Degenerate spans (``t1 <= t0`` or an unbounded
    ``t1``) collapse to ``[t1]`` — one pump, today's behavior."""
    if not t1 > t0 or not math.isfinite(t1) or not math.isfinite(t0):
        return [t1]
    bounds = sorted({float(b) for b in boundaries if t0 < b < t1})
    cuts: List[float] = []
    t, bi = t0, 0
    while t < t1 - 1e-9:
        while bi < len(bounds) and bounds[bi] <= t + 1e-9:
            bi += 1
        nb = bounds[bi] if bi < len(bounds) else t1
        if nb - t <= quanta.band_s + 1e-9:
            # inside the fine band: stride fine_s, land exactly on the
            # boundary
            nxt = min(t + quanta.fine_s, nb, t1)
        else:
            # idle: stride coarse_s, but clamp at the band's edge so the
            # approach to the boundary always runs fine
            nxt = min(t + quanta.coarse_s, nb - quanta.band_s, t1)
        if t1 - nxt < 1e-9:
            nxt = t1
        cuts.append(nxt)
        t = nxt
    return cuts or [t1]


class ShardedFleet:
    """N partitioned :class:`FleetController` shards, one merged report.

    ``batch_backend`` is forwarded to the fleet-level admission planner
    (``"fused"``, the default, runs the admission sweep's scoring chain
    and per-cell argmin in the two CUDA kernels of ``grid_cuda``;
    ``"torch"`` scores the lattice as torch ops; ``"numpy"`` is the
    per-job oracle). ``shard_backend`` is the *shard planners'* batch
    backend — the in-run re-plan sweeps — and defaults to
    ``batch_backend``, except under ``parallel="fork"`` where it defaults
    to the numpy oracle (CUDA does not survive a fork; asking for
    ``"fused"``, or ``"torch"`` on ``cuda``, under fork raises
    ``ValueError``). ``device`` places every planner (``cuda`` unless
    given; without a GPU pass ``"cpu"``, or construction raises); fork
    workers plan on the CPU. Remaining keyword arguments are forwarded to
    every ``FleetController``.

    ``parallel`` selects the shard execution engine: ``"off"`` (default)
    drains shards sequentially in-process — the pinned oracle — while
    ``"fork"`` / ``"spawn"`` / ``"auto"`` run one worker process per
    shard over a frozen snapshot of ``field``, started lazily at the
    first shard command (so the snapshot captures the admission-warmed
    caches). ``"auto"`` picks spawn when the shards plan on ``cuda`` with
    a backend other than numpy, else the platform's cheapest start. A
    spawn worker opens its own CUDA context. A parallel fleet
    should be :meth:`close`\\ d (or used as a context manager) to reap
    its workers.
    """

    def __init__(self, ftns: Sequence[FTN], *, n_shards: int = 4,
                 field: Optional[CarbonField] = None,
                 partition: Union[str, Callable[[TransferJob], int]] = "hash",
                 batch_backend: str = "fused",
                 parallel: str = "off",
                 shard_backend: Optional[str] = None,
                 supervision: Optional["SupervisionPolicy"] = None,
                 fault_plan: Optional["FaultPlan"] = None,
                 device=None,
                 **controller_kw):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if not callable(partition) and partition not in ("hash", "source"):
            raise ValueError(f"partition must be 'hash', 'source' or a "
                             f"callable, got {partition!r}")
        if parallel not in ("off", "fork", "spawn", "auto"):
            raise ValueError(f"parallel must be 'off', 'fork', 'spawn' or "
                             f"'auto', got {parallel!r}")
        device = resolve_device(device)
        self.field = field or default_field()
        if parallel == "auto" and device.type == "cuda" and (
                shard_backend or batch_backend) != FORK_SAFE_BACKEND:
            # shards that plan on the card need a fresh interpreter
            parallel = "spawn"
        self.parallel = parallel if parallel == "off" \
            else resolve_mode(parallel)
        if shard_backend is None:
            shard_backend = FORK_SAFE_BACKEND \
                if self.parallel == "fork" else batch_backend
        if self.parallel == "fork" and (
                shard_backend == "fused"
                or (shard_backend == "torch" and device.type == "cuda")):
            raise ValueError(
                f"parallel='fork' cannot run shard_backend="
                f"{shard_backend!r} on {device}: CUDA does not survive a "
                f"fork (use parallel='spawn', or shard_backend='numpy')")
        self.shard_backend = shard_backend
        # where a worker's shard planner runs: a fork child never touches
        # CUDA, so it plans on the CPU
        self._shard_device = "cpu" if self.parallel == "fork" \
            else str(device)
        self.partition = partition
        self.ftns = list(ftns)
        self._controller_kw = dict(controller_kw)
        # observability: each shard controller builds its *own* observer
        # from the obs= kwarg (a shared observer instance would interleave
        # spans in-process and diverge from the per-worker copies a
        # parallel run pickles — breaking the off/parallel bit-identity
        # contract), while the coordinator keeps a separate observer for
        # fleet-level spans (admission, gateway, supervisor degradations)
        obs_kw = controller_kw.get("obs")
        if obs_kw is not None and not isinstance(obs_kw, (bool, ObsConfig)):
            raise ValueError(
                "ShardedFleet obs= must be None, a bool or an ObsConfig "
                "(each shard builds its own observer; a shared "
                "FleetObserver would break the off/parallel bit-identity)")
        self.obs = as_observer(obs_kw)
        self._obs_folded = 0           # runner recoveries folded so far
        if self.parallel != "off":
            clash = {"planner", "engine", "field"} & set(controller_kw)
            if clash:
                raise ValueError(
                    f"parallel workers rebuild their own {sorted(clash)} "
                    f"from the shard spec; pass planner knobs via "
                    f"shard_backend / batch_backend instead")
        if fault_plan is not None and self.parallel == "off":
            raise ValueError("fault_plan needs worker processes to fault; "
                             "use parallel='fork'|'spawn'|'auto'")
        self.supervision = supervision
        self._runner: Optional[ParallelShardRunner] = None
        if self.parallel == "off":
            self.controllers = [
                FleetController(
                    ftns, field=self.field,
                    planner=TorchCarbonPlanner(ftns, field=self.field,
                                               batch_backend=shard_backend,
                                               device=device),
                    **controller_kw)
                for _ in range(n_shards)]
        else:
            self._runner = ParallelShardRunner(
                n_shards, self._shard_specs, mode=self.parallel,
                supervision=supervision, fault_plan=fault_plan)
            self.controllers = self._runner.proxies
        # fleet-level admission planner: scores every submitted job's grid
        # in ONE batched call (base-capacity throughput model — in-run
        # corrections are the shards' re-plan sweeps' job). Shocks
        # injected *before* a submit are priced into admission via the
        # same nowcast scale the controllers use; drift injected after
        # admission is the re-plan sweeps' job.
        self.planner = TorchCarbonPlanner(ftns, field=self.field,
                                          batch_backend=batch_backend,
                                          device=device)
        self.planner.emission_scale_fn = self._emission_scale
        if self.obs is not None:
            self.planner.observe_with(self.obs)
        self._shocks: List[tuple] = []   # (t, factor, until, zones|None)

    @property
    def n_shards(self) -> int:
        return len(self.controllers)

    @property
    def degradations(self) -> tuple:
        """Supervisor-surfaced fault handling so far (worker respawns,
        backend fallbacks, parallel -> off) — empty for a sequential
        fleet and for a fault-free parallel run."""
        if self._runner is None:
            return ()
        return tuple(self._runner.degradations)

    def _shard_specs(self) -> List[ShardSpec]:
        """Worker blueprints, built lazily at worker start: the field is
        frozen *then*, so whatever warmed it (typically the fleet-level
        admission ``plan_batch``) ships with the snapshot instead of
        being re-hashed N times."""
        spec = ShardSpec(
            ftns=tuple(self.ftns),
            controller_kw=tuple(sorted(self._controller_kw.items())),
            batch_backend=self.shard_backend,
            frozen=self.field.freeze(),
            device=self._shard_device)
        return [spec] * len(self.controllers)

    def shard_of(self, job: TransferJob) -> int:
        if callable(self.partition):
            return int(self.partition(job)) % self.n_shards
        key = job.uuid if self.partition == "hash" else job.replicas[0]
        return _stable_hash(key) % self.n_shards

    # --- the FleetController API, fleet-wide -------------------------------
    def submit(self, job: TransferJob, plan=None, at=None) -> None:
        """Route one arrival to its shard; ``plan`` optionally carries a
        precomputed admission plan and ``at`` a deferred arrival instant
        (the streaming gateway's micro-batched admission), same as
        :meth:`FleetController.submit`."""
        self.controllers[self.shard_of(job)].submit(job, plan=plan, at=at)

    def submit_many(self, jobs: Sequence[TransferJob]) -> None:
        """Batched admission: the *whole* fleet's (job x FTN x replica x
        slot) grid stack is scored in one fleet-level ``plan_batch`` call
        (the two planner kernels on the fused batch backend), then each
        shard's arrivals are enqueued as one plan-carrying group — shards
        never replan at arrival, only at their drift sweeps, and a parallel
        fleet ships each shard one wire message instead of one per job.
        Grouping is stable, so per-shard arrival order (and thus the
        event seq tiebreak) is identical to a per-job submit loop."""
        jobs = list(jobs)
        plans = self.planner.plan_batch(jobs)
        if self.obs is not None and jobs:
            self.obs.span("plan", min(j.submitted_t for j in jobs),
                          cause="admission", n_jobs=len(jobs),
                          cells=self.planner.last_batch_cells)
        by_shard: List[tuple] = [([], []) for _ in self.controllers]
        for job, plan in zip(jobs, plans):
            js, ps = by_shard[self.shard_of(job)]
            js.append(job)
            ps.append(plan)
        for ctl, (js, ps) in zip(self.controllers, by_shard):
            if js:
                ctl.submit_many(js, plans=ps)

    def inject_shock(self, t: float, factor: float, *,
                     duration_s: float = float("inf"),
                     zones: Optional[Sequence[str]] = None) -> None:
        self._shocks.append((t, factor, t + duration_s,
                             tuple(zones) if zones is not None else None))
        for ctl in self.controllers:
            ctl.inject_shock(t, factor, duration_s=duration_s, zones=zones)

    def _emission_scale(self, path, ts):
        """Admission-time counterpart of
        ``FleetController._emission_scale``: per-start-slot multiplier on
        a leg's forecast emissions from the already-announced shock
        schedule (hop-mean of the zone factors inside each window)."""
        scale = np.ones(np.shape(ts))
        for t0, factor, until, zones in self._shocks:
            zf = [factor if (zones is None or h.zone in zones) else 1.0
                  for h in path.hops]
            f_path = sum(zf) / len(zf)
            if f_path != 1.0:
                scale = np.where((ts >= t0 - 1e-9) & (ts <= until),
                                 scale * f_path, scale)
        return scale

    def pump_all(self, until: Optional[float] = None, *,
                 strict: bool = False,
                 horizon: Optional[float] = None,
                 quanta: Optional[PumpQuanta] = None,
                 boundaries: Sequence[float] = ()) -> int:
        """One bounded time quantum across every shard (the streaming
        gateway's watermark pump): sequentially in-process, or as one
        barriered concurrent quantum over the worker pool. Returns the
        total events processed.

        With ``quanta`` set the single quantum becomes an adaptive
        schedule (:func:`quantum_schedule`): coarse sub-quanta while no
        boundary is near, fine sub-quanta inside the band around the next
        one. Boundaries are the caller's ``boundaries`` (the gateway
        passes upcoming batch closes) plus every announced shock's onset
        and end; the schedule starts at the earliest *due* event, so idle
        sim spans cost one barrier, not span/coarse_s of them. Worker hang
        deadlines rescale with each sub-quantum's share of a coarse one
        (``ParallelShardRunner.pump_all(deadline_scale=...)``). The
        schedule is pure sim-state arithmetic — every mode pumps through
        identical cuts, so determinism contracts are untouched."""
        if quanta is None or until is None or not math.isfinite(until):
            return self._pump_quantum(until, strict=strict, horizon=horizon)
        peeks = [t for t in (ctl.events.peek_t()
                             for ctl in self.controllers) if t is not None]
        if not peeks:                  # nothing due: one (empty) barrier
            return self._pump_quantum(until, strict=strict, horizon=horizon)
        t0 = max(min(peeks),
                 max(ctl.events.now for ctl in self.controllers))
        bounds = list(boundaries)
        for t, _factor, t_end, _zones in self._shocks:
            bounds.append(t)
            if math.isfinite(t_end):
                bounds.append(t_end)
        # the step-batch clamp stays the FULL pump's (horizon defaults to
        # the pump bound, never a sub-quantum cut) — a cut that fragmented
        # step batches would change the event stream vs the single-quantum
        # pump, breaking its exact-replay contract
        eff_horizon = until if horizon is None else horizon
        total, prev = 0, t0
        for cut in quantum_schedule(t0, until, bounds, quanta):
            scale = min(max((cut - prev) / quanta.coarse_s, 0.1), 1.0)
            total += self._pump_quantum(cut, strict=strict,
                                        horizon=eff_horizon,
                                        deadline_scale=scale)
            prev = cut
        return total

    def _pump_quantum(self, until: Optional[float], *, strict: bool,
                      horizon: Optional[float],
                      deadline_scale: float = 1.0) -> int:
        if self._runner is not None:
            return self._runner.pump_all(until, strict=strict,
                                         horizon=horizon,
                                         deadline_scale=deadline_scale)
        return sum(ctl.pump(until, strict=strict, horizon=horizon)
                   for ctl in self.controllers)

    def run_shards(self, until: Optional[float] = None) -> List[FleetReport]:
        """Drain every shard and return the per-shard reports in shard
        order (also kept on ``self.shard_reports``) — sequentially
        in-process, or concurrently across the worker pool."""
        if self._runner is not None:
            reports = self._runner.run_all(until)
        else:
            reports = [ctl.run(until) for ctl in self.controllers]
        self.shard_reports = reports
        return reports

    def run(self, until: Optional[float] = None) -> FleetReport:
        """Drain every shard and merge. With ``parallel="off"`` shards run
        sequentially in-process; otherwise each runs to completion in its
        own worker and only the report crosses back — either way the
        merge is the exact-sum :meth:`FleetReport.merged` over the same
        shard order, and the merged ``jobs_per_s`` uses the measured
        coordinator wall."""
        wall0 = time.perf_counter()
        reports = self.run_shards(until)
        rep = FleetReport.merged(
            reports, wall_s=time.perf_counter() - wall0)
        deg = self.degradations
        if deg:
            rep = dataclasses.replace(
                rep, degradations=rep.degradations + deg)
        return self.attach_obs(rep)

    def attach_obs(self, rep: FleetReport) -> FleetReport:
        """Fold the coordinator's observability state into a merged
        report: supervisor recoveries become degrade spans/metrics, then
        coordinator spans (admission, gateway, degradations) lead and
        shard traces follow shard-major — same stable order as
        outcomes/degradations. Also called by the streaming gateway,
        which builds its own merge from ``run_shards``."""
        if self.obs is None:
            return rep
        self._fold_supervisor_obs()
        snaps = [s for s in (self.obs.metrics_snapshot(), rep.metrics)
                 if s]
        return dataclasses.replace(
            rep,
            trace=self.obs.trace() + rep.trace,
            metrics=obs_metrics.merged(snaps) if snaps else rep.metrics)

    def _fold_supervisor_obs(self) -> None:
        """Fold supervisor recovery records gathered so far into the
        coordinator observer: one ``degrade`` span each (pinned at
        t=-1.0 — recoveries have no sim-clock instant — so they sort
        ahead of event spans) plus respawn/recovery-latency metrics.
        Only the deterministic fields enter the span; the measured
        recovery wall goes to metrics, which replay tests exclude."""
        recs = list(getattr(self._runner, "recoveries", None) or ())
        for r in recs[self._obs_folded:]:
            self.obs.span("degrade", -1.0,
                          shard=r.get("shard"),
                          outcome=str(r.get("outcome")),
                          reason=str(r.get("reason")),
                          attempts=r.get("attempts"),
                          replayed=r.get("replayed"),
                          from_checkpoint=r.get("from_checkpoint"))
            self.obs.counter("sup_recoveries_total",
                             outcome=str(r.get("outcome"))).inc()
            wall = r.get("wall_s")
            if wall is not None:
                self.obs.histogram("sup_recovery_wall_s",
                                   bounds=_RECOVERY_BOUNDS).observe(wall)
        self._obs_folded = len(recs)

    # --- worker lifecycle ---------------------------------------------------
    def close(self) -> None:
        """Reap the worker pool (no-op for sequential fleets; idempotent).
        Workers are per-fleet, so a fleet is single-use once closed."""
        if self._runner is not None:
            self._runner.close()

    def __enter__(self) -> "ShardedFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
