"""Streaming fleet gateway: online micro-batched admission + backfill.

``submit_many`` assumes the whole fleet is known up front; real fleets see
an *arrival stream* and must admit online against a stochastic carbon
field. The :class:`StreamingGateway` sits in front of a
:class:`FleetController` or :class:`ShardedFleet` and closes that gap:

* **micro-batched admission** — arrivals accumulate into micro-batches
  (up to ``window_s`` of arrival time or ``max_batch`` jobs); a batch
  *closes* on its window timer (or at its last member's arrival when
  ``max_batch`` filled it early), is planned by ONE ``plan_batch`` call
  on the gateway's admission planner (the two CUDA planner kernels once
  the batch is big enough — never per-job grid scoring on the hot path) and
  handed to the controllers as plan-carrying ``JobArrival`` events AT the
  close instant — the member's micro-batch admission latency, which the
  gateway reports (p50/p95/max);
* **watermark rule** — before a batch closing at ``t_close`` is admitted,
  every controller is pumped *strictly below* ``t_close``
  (``FleetController.pump(t_close, strict=True)``). Admissions therefore
  always land at or ahead of the clock — the monotone-clock contract of
  ``core.controlplane.events`` is preserved by construction — and with
  ``window_s=0`` the close IS the arrival instant, so a streamed run
  replays a ``submit_many`` run of the same materialized list event for
  event;
* **capacity-gated deferral + backfill** — with ``max_inflight`` set, the
  gateway admits at most that many uncompleted jobs and parks the rest in
  a deferred set. A hook on ``JobComplete`` frees capacity and promotes
  deferred jobs: FIFO order by default, and with ``backfill=True`` the
  deferred set is *re-scored* (one batched plan over submission-rebased
  copies) and the projected-greenest job is promoted instead — unless a
  job's remaining slack has gone critical, in which case the SLA guard
  admits the most urgent job first, exactly like migration's
  greener-but-late veto;
* **double-buffered (pipelined) admission** — with ``pipeline="on"`` the
  gateway plans micro-batch N+1 on a dedicated planner thread *while* the
  workers drain toward batch N+1's close: the plan call is dispatched
  right before the watermark pump and its result claimed right after, at
  the batch close, exactly where the sequential path would have computed
  it. Plans are pure functions of (job, announced shock schedule) and the
  planner thread touches no fleet state, so ``pipeline="off"`` remains
  the bit-identical oracle — same merge, same trace, same ledger — and
  the only thing that moves is wall time (``overlap_fraction`` /
  ``admit_stall_ms`` in :class:`GatewayStats`, ``gw_pipeline_*``
  metrics). Both modes plan on the same dedicated *batch planner* — a
  clone of the admission planner with a PRIVATE carbon field and metrics
  registry — so planner-internal cache evolution is identical across
  modes and the planner thread shares no mutable caches with the
  coordinator, whose in-process pumps and mid-pump deferral re-scores
  keep hitting the fleet field. The clone's private metrics fold exactly
  into the shared registry at every checkpoint capture and at the end of
  each drive. When the gateway cannot isolate the batch planner this way
  — a custom planner *subclass* (shared instance, re-entered by
  promotion re-scores that fire inside the pump), or a bare controller
  whose transfer engine live-feeds the planner's throughput model
  between dispatch and claim — ``pipeline="on"`` plans at the batch
  close on the coordinator instead (no overlap, identical plans), so the
  oracle contract holds unconditionally.

The gateway plans with a dedicated admission planner (base-capacity
throughput model; for a :class:`ShardedFleet` the fleet-level planner,
which already prices pre-announced shocks). Admission planning is a pure
function of the job and the announced shock schedule, which is what makes
the watermark-time plan identical to the plan an arrival-time scan would
have produced, and what makes the pipelined plan identical to the
sequential one.

A copy of the reference's ``core/controlplane/streaming.py``: the batch
planner is a :class:`TorchCarbonPlanner` on the gateway's ``device``, and
the pipelined planner thread launches the planner kernels on the same
card as the coordinator's shards (one default stream, so the launches of
the two threads serialise). ``tests/test_torch_streaming.py`` pins the
gateway to the reference's and the two pipeline modes to each other.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.controlplane.controller import (FleetController,
                                                      FleetReport)
from repro_torch.core.controlplane.sharded import PumpQuanta
from repro_torch.core.obs.metrics import MetricsRegistry
from repro_torch.core.scheduler.planner import (Plan, TorchCarbonPlanner,
                                                TransferJob)


@dataclasses.dataclass
class _Deferred:
    """One capacity-parked arrival awaiting promotion."""
    job: TransferJob
    seq: int                           # FIFO order (arrival order)


@dataclasses.dataclass(frozen=True)
class GatewayStats:
    """What the gateway itself did (the controllers' work is in the
    :class:`FleetReport`): micro-batch shape, admission latency (the gap
    between a job's arrival and its JobArrival being scheduled — includes
    any capacity wait), and backfill activity."""
    n_jobs: int
    n_batches: int
    max_batch: int
    mean_batch: float
    admission_p50_s: float
    admission_p95_s: float
    admission_max_s: float
    n_deferred: int
    n_promotions: int
    n_backfill_promotions: int         # promotions that bypassed FIFO order
    n_urgent_promotions: int           # SLA guard overrode the green choice
    # pipelined admission (all zero with pipeline="off"): wall-clock
    # occupancy of the double buffer. overlap_fraction is the share of
    # admission-planning wall time hidden behind the worker drain;
    # admit_stall_ms is the mean residual wait at the batch close for a
    # plan still in flight.
    pipeline: str = "off"
    n_pipelined_batches: int = 0
    plan_wall_s: float = 0.0           # planner-thread wall, summed
    stall_wall_s: float = 0.0          # coordinator claim wait, summed
    overlap_fraction: float = 0.0
    admit_stall_ms: float = 0.0


class StreamingGateway:
    """Online admission in front of a fleet (single controller or shards).

    ``fleet`` — a :class:`FleetController` or :class:`ShardedFleet`.
    ``window_s`` — micro-batch accumulation window: arrivals within
    ``window_s`` of the batch's first job are admitted together (0 means
    one batch per distinct arrival instant).
    ``max_batch`` — hard cap on a micro-batch (closes the batch early).
    ``max_inflight`` — fleet-wide admitted-but-uncompleted cap; ``None``
    disables deferral entirely (pure pass-through admission).
    ``backfill`` — promote deferred jobs by projected emissions instead of
    FIFO when capacity frees (SLA-guarded; see :meth:`_select_deferred`).
    ``urgency_margin`` — a deferred job is *urgent* once its remaining
    slack is below ``urgency_margin x`` its projected duration.
    ``backfill_lookahead`` — how many deferred jobs (oldest first) a
    backfill re-score considers per promotion; bounds the per-completion
    planning cost to O(lookahead) however deep the burst backlog gets
    (jobs beyond the window advance into it as promotions drain it).
    ``planner`` — admission planner override; defaults to the fleet-level
    planner (``ShardedFleet.planner``) or the controller's own.
    ``device`` — where the gateway's batch planner (the clone of the
    admission planner that plans every micro-batch) runs: ``cuda`` unless
    given; without a GPU pass ``"cpu"``, or construction raises.
    ``pipeline`` — ``"off"`` (sequential oracle, the default), ``"on"``
    (double-buffered: plan micro-batch N+1 on a planner thread while the
    workers drain toward its close), or ``"auto"`` (currently ``"on"``).
    Bit-identical outputs either way; only wall time moves. Overlap
    needs a batch planner the gateway can isolate (see
    :meth:`_clone_planner`); with a custom planner subclass or a bare
    controller's live-corrected planner, ``"on"`` plans at the batch
    close like ``"off"`` and records zero pipelined batches.
    ``quanta`` — optional
    :class:`~repro_torch.core.controlplane.sharded.PumpQuanta`:
    the watermark pumps run as an adaptive quantum schedule (coarse when
    no batch close or shock boundary is near, fine inside ``band_s`` of
    one) instead of one monolithic quantum. Supervisor command deadlines
    rescale with the quantum. Only meaningful for fleets exposing
    ``pump_all`` (a :class:`ShardedFleet`); a bare controller pumps as
    before. Outcome-neutral without capacity gating — with
    ``max_inflight`` set, sub-quantum barriers can reorder completion
    hooks across shards and hence change (deterministically) which job a
    promotion picks, so the knob is opt-in and independent of
    ``pipeline``.
    ``frontends`` — ``"fleet"`` (one admission sweep per micro-batch, the
    default) or ``"shard"`` (the sweep splits per target shard and plans
    shard groups separately — per-job plans are pure, so the plans are
    bit-identical; the split bounds any one planner call to a shard's
    share of the batch).
    ``checkpoint_every_s`` — durable streaming: capture a
    :class:`~repro_torch.core.controlplane.persistence.FleetCheckpoint`
    of the fleet *and* the gateway's own admission state every so many
    sim seconds of batch closes (kept on ``last_checkpoint`` and handed to
    ``checkpoint_fn`` when given). A restored gateway
    (``persistence.restore_gateway``) continues via :meth:`resume`.
    """

    def __init__(self, fleet, *, window_s: float = 300.0,
                 max_batch: int = 512,
                 max_inflight: Optional[int] = None,
                 backfill: bool = False,
                 urgency_margin: float = 2.0,
                 backfill_lookahead: int = 64,
                 planner: Optional[TorchCarbonPlanner] = None,
                 pipeline: str = "off",
                 quanta: Optional[PumpQuanta] = None,
                 frontends: str = "fleet",
                 checkpoint_every_s: Optional[float] = None,
                 checkpoint_fn=None, device=None):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1 or None, "
                             f"got {max_inflight}")
        if backfill_lookahead < 1:
            raise ValueError(f"backfill_lookahead must be >= 1, "
                             f"got {backfill_lookahead}")
        if checkpoint_every_s is not None and checkpoint_every_s <= 0:
            raise ValueError(f"checkpoint_every_s must be > 0 or None, "
                             f"got {checkpoint_every_s}")
        if pipeline not in ("off", "on", "auto"):
            raise ValueError(f"pipeline must be 'off', 'on' or 'auto', "
                             f"got {pipeline!r}")
        if frontends not in ("fleet", "shard"):
            raise ValueError(f"frontends must be 'fleet' or 'shard', "
                             f"got {frontends!r}")
        if quanta is not None and not isinstance(quanta, PumpQuanta):
            raise TypeError(f"quanta must be a PumpQuanta or None, "
                            f"got {type(quanta).__name__}")
        self.fleet = fleet
        self.controllers: List[FleetController] = list(
            getattr(fleet, "controllers", None) or [fleet])
        self.planner = planner if planner is not None \
            else getattr(fleet, "planner")
        self.window_s = window_s
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self.backfill = backfill
        self.urgency_margin = urgency_margin
        self.backfill_lookahead = backfill_lookahead
        self.pipeline = "on" if pipeline == "auto" else pipeline
        self.quanta = quanta
        self.frontends = frontends
        # pipelined-admission occupancy (wall clock; metrics-only data —
        # never spans, per the trace determinism contract)
        self.plan_wall_s = 0.0
        self.stall_wall_s = 0.0
        self.n_pipelined_batches = 0
        # the gateway plans micro-batches on a dedicated BATCH PLANNER: a
        # clone of the admission planner sharing its field, throughput
        # model and live shock pricing. Used in BOTH pipeline modes, so
        # planner-internal cache evolution is identical across modes, and
        # the pipelined planner thread never shares an instance with the
        # deferral/backfill re-scores (which stay on self.planner, on the
        # coordinator thread).
        self._batch_planner = self._clone_planner(self.planner,
                                                  resolve_device(device))
        # the planner thread may only run concurrently with the watermark
        # pump when the batch planner is the private clone above (own
        # field, own registry) and nothing the coordinator mutates
        # mid-pump feeds its inputs. A bare controller's transfer engine
        # observes achieved throughput into its planner's model as jobs
        # step/complete — between dispatch and claim — which would make
        # an overlapped plan diverge from the plan-at-close oracle. When
        # unsafe, pipeline="on" plans at the batch close exactly like
        # "off" (zero pipelined batches in stats).
        self._overlap_safe = (
            self._batch_planner is not self.planner
            and not any(
                getattr(ctl, "engine", None) is not None
                and ctl.engine.model is self._batch_planner.throughput
                for ctl in self.controllers))
        self._inflight: set = set()    # gateway-admitted, not yet complete
        self._deferred: List[_Deferred] = []
        self._seq = 0
        self._latency: List[float] = []
        self._arrival_t: dict = {}     # uuid -> true arrival time
        self._batch_sizes: List[int] = []
        self.n_promotions = 0
        self.n_backfill_promotions = 0
        self.n_urgent_promotions = 0
        self._n_deferred_total = 0
        # durability state: how many arrivals have been *consumed* (joined
        # an admitted/deferred micro-batch — a pulled-but-unbatched
        # arrival is NOT consumed and is re-pulled on resume), the stream
        # time-order watermark, and the checkpoint cadence
        self.checkpoint_every_s = checkpoint_every_s
        self.checkpoint_fn = checkpoint_fn
        self.last_checkpoint = None
        self._consumed = 0
        self._prev_t = -float("inf")
        self._next_ckpt_t: Optional[float] = None
        # observability: the gateway shares the fleet's observer — the
        # coordinator's for a ShardedFleet (gateway spans lead the merged
        # trace), the controller's own for a bare FleetController (spans
        # interleave on the one clock). Deterministic either way.
        self.obs = getattr(fleet, "obs", None)
        if max_inflight is not None:
            for ctl in self.controllers:
                ctl.completion_hooks.append(self._on_complete)

    @staticmethod
    def _clone_planner(src: TorchCarbonPlanner,
                       device=None) -> TorchCarbonPlanner:
        """A dedicated batch planner for micro-batch admission: a fresh
        ``TorchCarbonPlanner`` on ``device`` (the source's unless given)
        sharing the source's FTNs, throughput model and
        live shock pricing (``emission_scale_fn`` is a bound method of
        the fleet, so the clone prices shocks injected later too) — but
        with a PRIVATE carbon field (thawed from a snapshot of the
        source's) and a private metrics registry. The field's noise
        tables and grid caches mutate on lookup (window re-anchor/extend
        is a non-atomic del+rebind), so the pipelined planner thread
        must never share them with the coordinator, whose in-process
        pumps and mid-pump deferral re-scores hit the source field
        concurrently; the hashed noise is a pure function, so the
        private copy plans bit-identically. Registry instruments are
        plain ``+=`` writes with the same hazard, so the clone records
        into its own registry, folded exactly into the shared one at
        quiescent points (:meth:`_fold_batch_planner_metrics`).

        A planner *subclass* (custom admission policy) is not cloned:
        the subclass's own plan_batch is the policy. The shared instance
        is then never used from two threads — completion hooks fire
        *inside* the watermark pump, i.e. between plan dispatch and
        claim, so a capacity promotion would re-enter it from the
        coordinator mid-plan — because ``_overlap_safe`` turns the
        planner-thread dispatch off and the batch close plans inline,
        exactly like ``pipeline="off"``."""
        if type(src) is not TorchCarbonPlanner:
            return src
        clone = TorchCarbonPlanner(
            src.ftns, throughput=src.throughput, slot_s=src.slot_s,
            ci_fn=src.ci_fn, field=src.field.freeze().thaw(),
            batch_backend=src.batch_backend,
            device=src.device if device is None else device)
        clone.emission_scale_fn = src.emission_scale_fn
        clone.capture_greedy = src.capture_greedy
        if src._metrics is not None:
            clone._metrics = MetricsRegistry()
        return clone

    # --- the open loop ------------------------------------------------------
    def run(self, stream: Iterable[TransferJob],
            until: Optional[float] = None) -> FleetReport:
        """Drive the fleet open-loop from an arrival stream and return the
        merged report. Arrivals past ``until`` are never admitted (same
        visibility a terminal ``run(until)`` gives ``submit_many``)."""
        return self._drive(iter(stream), until)

    def resume(self, stream: Iterable[TransferJob],
               until: Optional[float] = None) -> FleetReport:
        """Continue a restored run (``persistence.restore_gateway``):
        re-feed the SAME arrival stream the interrupted run was consuming
        — streams are replayable *inputs*, not state — and the gateway
        skips the ``_consumed`` arrivals that already joined a micro-batch
        before the checkpoint. A pulled-but-unbatched arrival was not yet
        consumed, so it is re-pulled here and the run continues exactly
        where the cut fell."""
        it = iter(stream)
        for _ in range(self._consumed):
            if next(it, None) is None:
                break
        return self._drive(it, until)

    def _pull(self, it: Iterator[TransferJob]) -> Optional[TransferJob]:
        job = next(it, None)
        if job is not None and job.submitted_t < self._prev_t - 1e-9:
            raise ValueError(
                f"arrival stream is not time-ordered: {job.uuid} at "
                f"t={job.submitted_t} after t={self._prev_t}")
        if job is not None:
            self._prev_t = job.submitted_t
        return job

    def _drive(self, it: Iterator[TransferJob],
               until: Optional[float]) -> FleetReport:
        wall0 = time.perf_counter()
        horizon = float("inf") if until is None else until
        # double buffer: with pipeline="on", the micro-batch plan sweep is
        # dispatched to a single planner thread BEFORE the watermark pump
        # and claimed right after it, at the batch close — planning
        # overlaps the worker drain instead of serializing behind it. The
        # pool lives for one _drive; the finally below joins the thread
        # so no plan call ever outlives (or races) the run. Without an
        # isolatable batch planner (_overlap_safe) no pool is built and
        # _admit plans at the close, the "off" path.
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="gw-plan") \
            if self.pipeline == "on" and self._overlap_safe else None
        try:
            pending = self._pull(it)
            while pending is not None:
                if pending.submitted_t > horizon:
                    break
                t_open = pending.submitted_t
                batch = [pending]
                pending = self._pull(it)
                while (pending is not None and len(batch) < self.max_batch
                       and pending.submitted_t <= t_open + self.window_s
                       and pending.submitted_t <= horizon):
                    batch.append(pending)
                    pending = self._pull(it)
                # the batch closes on its window timer — or at its last
                # member's arrival when max_batch filled it early (the
                # gateway has seen every member by then), and never past
                # the run horizon (the cut flushes an open batch, exactly
                # the visibility a terminal run(until) gives submit_many).
                # Members are admitted AT the close (their micro-batch
                # latency); with window_s=0 the close is the arrival
                # instant itself and a streamed run replays a submit_many
                # run exactly.
                t_close = batch[-1].submitted_t \
                    if len(batch) >= self.max_batch \
                    else min(t_open + self.window_s, horizon)
                fut: Optional[Future] = None
                if pool is not None:
                    fut = pool.submit(self._plan_timed, list(batch))
                # watermark: the clock must sit strictly below the close
                # before the batch's JobArrivals are pushed — admission
                # can then never violate the monotone-clock contract.
                # Step batching clamps at the run horizon, not the
                # watermark (a cut that fragmented step batches would
                # change the event stream vs the batch-mode run).
                self._pump_all(t_close, strict=True, horizon=horizon,
                               boundary=t_close)
                plans = None
                if fut is not None:
                    t_claim = time.perf_counter()
                    plans, plan_wall = fut.result()
                    self.stall_wall_s += time.perf_counter() - t_claim
                    self.plan_wall_s += plan_wall
                    self.n_pipelined_batches += 1
                    if self.obs is not None:
                        self.obs.histogram(
                            "gw_pipeline_plan_wall_s").observe(plan_wall)
                        self.obs.counter("gw_pipeline_batches_total").inc()
                self._admit(batch, t_close, plans=plans)
                # the batch is durable fleet state now — only here do its
                # members count as consumed (resume re-pulls anything
                # later). The plan future was claimed above, so a capture
                # here never races the planner thread; a crash BETWEEN
                # dispatch and close leaves the batch unconsumed in the
                # last checkpoint and resume() replays it exactly.
                self._consumed += len(batch)
                self._maybe_checkpoint(t_close)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            # the planner thread is joined: fold its private metrics into
            # the shared registry (exact, covers the "off" path too)
            self._fold_batch_planner_metrics()
        # stream exhausted (or horizon cut): drain everything still queued,
        # re-draining after completion hooks promote deferred jobs
        def _due(ctl: FleetController) -> bool:
            t = ctl.events.peek_t()
            return t is not None and (until is None or t <= until)

        while True:
            self._pump_all(until)
            if not any(_due(ctl) for ctl in self.controllers):
                if not self._deferred:
                    break
                # capacity can never free again inside the horizon
                # (nothing due is in flight): over-admit one job rather
                # than strand the deferred tail, then re-drain
                now = max(ctl.events.now for ctl in self.controllers)
                self._promote(now, force=True)
        run_shards = getattr(self.fleet, "run_shards", None)
        reports = run_shards(until) if run_shards is not None \
            else [ctl.run(until) for ctl in self.controllers]
        rep = FleetReport.merged(reports,
                                 wall_s=time.perf_counter() - wall0)
        deg = tuple(getattr(self.fleet, "degradations", ()))
        if deg:
            rep = dataclasses.replace(
                rep, degradations=rep.degradations + deg)
        # a sharded fleet folds its coordinator observer (which holds the
        # gateway's spans) here, since this merge bypassed fleet.run();
        # a bare controller already carried them out in its own report
        attach = getattr(self.fleet, "attach_obs", None)
        if attach is not None:
            rep = attach(rep)
        return rep

    def _maybe_checkpoint(self, t_close: float) -> None:
        """Capture a fleet+gateway checkpoint when the batch-close clock
        crosses the cadence boundary (cadence anchors at the first close,
        so a warm-up burst is not charged a capture per batch)."""
        if self.checkpoint_every_s is None:
            return
        if self._next_ckpt_t is None:
            self._next_ckpt_t = t_close + self.checkpoint_every_s
            return
        if t_close + 1e-9 < self._next_ckpt_t:
            return
        from repro_torch.core.controlplane import persistence
        # the plan future is always claimed before a capture, so the
        # batch planner is quiescent: fold its private metrics first so
        # the captured registry counts every plan sweep up to the cut
        self._fold_batch_planner_metrics()
        self.last_checkpoint = persistence.capture(self.fleet, gateway=self)
        if self.checkpoint_fn is not None:
            self.checkpoint_fn(self.last_checkpoint)
        while self._next_ckpt_t <= t_close + 1e-9:
            self._next_ckpt_t += self.checkpoint_every_s

    def _pump_all(self, t: Optional[float], *, strict: bool = False,
                  horizon: Optional[float] = None,
                  boundary: Optional[float] = None) -> None:
        """Advance every controller through one bounded quantum. A fleet
        that exposes ``pump_all`` (the sharded fleet) owns the sweep — in
        parallel mode that is one barriered concurrent quantum across the
        worker pool, completions re-fired shard-major, so the watermark
        rule drives all shards at once without touching any shard's
        monotone clock. With ``quanta`` set, the fleet sweep runs as an
        adaptive quantum schedule instead (fine near the batch close
        passed as ``boundary`` and near shock onsets, coarse elsewhere)."""
        pump_all = getattr(self.fleet, "pump_all", None)
        if pump_all is not None:
            if self.quanta is not None:
                pump_all(t, strict=strict, horizon=horizon,
                         quanta=self.quanta,
                         boundaries=() if boundary is None else (boundary,))
            else:
                pump_all(t, strict=strict, horizon=horizon)
        else:
            for ctl in self.controllers:
                ctl.pump(t, strict=strict, horizon=horizon)

    # --- admission planning -------------------------------------------------
    def _plan_timed(self, jobs: List[TransferJob]):
        """Planner-thread entry: one admission sweep plus its wall time
        (wall goes to metrics/stats only — never spans)."""
        t0 = time.perf_counter()
        plans = self._plan_batch(jobs)
        return plans, time.perf_counter() - t0

    def _plan_batch(self, jobs: List[TransferJob]) -> List[Plan]:
        """One micro-batch admission sweep on the dedicated batch planner.
        ``frontends="shard"`` splits the sweep per target shard (ascending
        shard id, original order within a group — per-job plans are pure,
        so the reassembled list is bit-identical to the unsplit sweep)."""
        if self.frontends == "shard":
            shard_of = getattr(self.fleet, "shard_of", None)
            if shard_of is not None:
                groups: Dict[int, List[int]] = {}
                for i, job in enumerate(jobs):
                    groups.setdefault(shard_of(job), []).append(i)
                out: List[Optional[Plan]] = [None] * len(jobs)
                for sid in sorted(groups):
                    idxs = groups[sid]
                    for i, plan in zip(idxs, self._batch_planner.plan_batch(
                            [jobs[i] for i in idxs])):
                        out[i] = plan
                return out
        return self._batch_planner.plan_batch(list(jobs))

    def _fold_batch_planner_metrics(self) -> None:
        """Fold the batch planner's private registry into the shared one
        (exact elementwise addition — :meth:`MetricsRegistry.absorb`),
        then reset it. Called only from the coordinator thread at points
        where no plan future is in flight (checkpoint capture, end of a
        drive), so planner metric totals come out identical to a run
        that recorded them in place — without the planner thread ever
        writing an instrument another thread holds."""
        bp = self._batch_planner
        if bp is self.planner or bp._metrics is None:
            return
        if self.planner._metrics is not None:
            self.planner._metrics.absorb(bp._metrics)
        bp._metrics = MetricsRegistry()

    # --- admission ----------------------------------------------------------
    def _admit(self, batch: Sequence[TransferJob], t_close: float,
               plans: Optional[List[Plan]] = None) -> None:
        """Admit one micro-batch at its close instant: ONE plan_batch call
        for the whole batch (pre-computed by the planner thread when
        pipelined — ``plans``), then per-job capacity gating —
        over-capacity jobs join the deferred set (their plan is recomputed
        against the conditions at promotion time, so the admission plan is
        dropped)."""
        self._batch_sizes.append(len(batch))
        if self.obs is not None:
            self.obs.histogram("gw_batch_jobs").observe(float(len(batch)))
            self.obs.counter("gw_batches_total").inc()
        if plans is None:
            plans = self._plan_batch(list(batch))
        for job, plan in zip(batch, plans):
            self._arrival_t[job.uuid] = job.submitted_t
            if (self.max_inflight is not None
                    and len(self._inflight) >= self.max_inflight):
                self._deferred.append(_Deferred(job=job, seq=self._seq))
                self._seq += 1
                self._n_deferred_total += 1
                if self.obs is not None:
                    self.obs.span("defer", t_close, job=job.uuid,
                                  cause="capacity",
                                  inflight=len(self._inflight))
                    self.obs.counter("gw_deferrals_total").inc()
            else:
                self._submit(job, plan, at=t_close)

    def _submit(self, job: TransferJob, plan: Optional[Plan],
                at: float) -> None:
        lat = max(0.0, at - self._arrival_t[job.uuid])
        self._latency.append(lat)
        if self.obs is not None:
            self.obs.histogram("gw_admission_latency_s").observe(lat)
        if self.max_inflight is not None:
            self._inflight.add(job.uuid)
        self.fleet.submit(job, plan=plan, at=at)

    # --- deferral / backfill ------------------------------------------------
    def _on_complete(self, t: float, job: TransferJob) -> None:
        """Completion hook (fires inside a controller's JobComplete
        handler, in event-time order): free the capacity slot and promote
        deferred work into it."""
        if job.uuid not in self._inflight:
            return                     # not gateway-admitted; not ours
        self._inflight.discard(job.uuid)
        self._promote(t)

    def _rebased(self, d: _Deferred, now: float) -> TransferJob:
        """The deferred job as the planner should see it *now*: submission
        rebased to the promotion instant with the remaining slack (the
        absolute deadline never extends — same arithmetic as
        ``CarbonAwareQueue.replan_pending``)."""
        job = d.job
        return dataclasses.replace(
            job, submitted_t=now,
            sla=dataclasses.replace(
                job.sla,
                deadline_s=max(job.submitted_t + job.sla.deadline_s - now,
                               1.0)))

    def _promote(self, now: float, *, force: bool = False) -> None:
        """Fill free capacity from the deferred set. FIFO unless
        ``backfill``; ``force`` lets exactly one job through a full
        capacity gate (the terminal drain's stall-breaker)."""
        while self._deferred:
            forced = False
            if self.max_inflight is not None \
                    and len(self._inflight) >= self.max_inflight:
                if not force:
                    return
                force = False          # over-admit one, then gate again
                forced = True
            idx, plan, urgent = self._select_deferred(now)
            d = self._deferred.pop(idx)
            fifo_head = all(d.seq <= o.seq for o in self._deferred) \
                if self._deferred else True
            self.n_promotions += 1
            if urgent:
                self.n_urgent_promotions += 1
                cause = "urgent"
            elif self.backfill and not fifo_head:
                self.n_backfill_promotions += 1
                cause = "backfill"
            else:
                cause = "fifo"
            if self.obs is not None:
                self.obs.span("promote", now, job=d.job.uuid, cause=cause,
                              forced=forced,
                              wait_s=max(0.0, now - d.job.submitted_t))
                self.obs.counter("gw_promotions_total", cause=cause).inc()
            # the ORIGINAL job is submitted (its absolute deadline is what
            # the controller's SLA accounting reads); the plan carries the
            # rebased start decision
            self._submit(d.job, plan, at=now)

    def _select_deferred(self, now: float) -> Tuple[int, Plan, bool]:
        """Pick the next deferred job to promote. Returns
        ``(index, rebased plan, urgent?)``.

        FIFO mode re-plans only the head (capacity order is arrival
        order). Backfill mode re-scores the ``backfill_lookahead`` oldest
        deferred jobs in one batched plan over submission-rebased copies
        (bounded per-completion cost — deeper backlog advances into the
        window as it drains), then:

        * **SLA guard first** — any job whose remaining slack is below
          ``urgency_margin x`` its projected duration (or whose rebased
          plan has gone infeasible) is promoted earliest-deadline-first,
          whatever its emissions;
        * otherwise the projected-greenest candidate is promoted —
          counted as a *backfill* promotion when it jumps the FIFO order.

        Subclasses override this to change the admission policy.
        """
        if not self.backfill:
            idx = min(range(len(self._deferred)),
                      key=lambda i: self._deferred[i].seq)
            plan = self.planner.plan_batch(
                [self._rebased(self._deferred[idx], now)])[0]
            return idx, plan, False
        # the deferred list stays in seq (arrival) order: promotions pop
        # from the middle but never reorder, so the lookahead window is a
        # plain prefix
        window = self._deferred[:self.backfill_lookahead]
        rebased = [self._rebased(d, now) for d in window]
        plans = self.planner.plan_batch(rebased)
        urgent: List[Tuple[float, int]] = []   # (absolute deadline, idx)
        for i, (d, rb, plan) in enumerate(zip(window, rebased, plans)):
            slack = rb.sla.deadline_s
            if (not plan.feasible
                    or slack < self.urgency_margin
                    * plan.predicted_duration_s):
                urgent.append((d.job.submitted_t + d.job.sla.deadline_s, i))
        if urgent:
            _, idx = min(urgent)
            return idx, plans[idx], True
        idx = min(range(len(plans)),
                  key=lambda i: (plans[i].predicted_emissions_g,
                                 window[i].seq))
        return idx, plans[idx], False

    # --- reporting ----------------------------------------------------------
    def stats(self) -> GatewayStats:
        lat = np.asarray(self._latency) if self._latency else np.zeros(1)
        sizes = self._batch_sizes or [0]
        return GatewayStats(
            n_jobs=len(self._arrival_t),
            n_batches=len(self._batch_sizes),
            max_batch=max(sizes),
            mean_batch=float(np.mean(sizes)),
            admission_p50_s=float(np.percentile(lat, 50)),
            admission_p95_s=float(np.percentile(lat, 95)),
            admission_max_s=float(lat.max()),
            n_deferred=self._n_deferred_total,
            n_promotions=self.n_promotions,
            n_backfill_promotions=self.n_backfill_promotions,
            n_urgent_promotions=self.n_urgent_promotions,
            pipeline=self.pipeline,
            n_pipelined_batches=self.n_pipelined_batches,
            plan_wall_s=self.plan_wall_s,
            stall_wall_s=self.stall_wall_s,
            overlap_fraction=(
                min(max(1.0 - self.stall_wall_s / self.plan_wall_s, 0.0),
                    1.0) if self.plan_wall_s > 0 else 0.0),
            admit_stall_ms=(
                1000.0 * self.stall_wall_s / self.n_pipelined_batches
                if self.n_pipelined_batches else 0.0))
