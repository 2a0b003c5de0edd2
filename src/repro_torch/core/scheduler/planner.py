"""The joint planner: time × space × overlay under an SLA [paper §5].

Searches the (start slot, source replica, FTN) grid, predicting duration
from the throughput model and emissions from the [14] power models, and
minimizes a QoS-weighted objective:

    cost = w_carbon · gCO₂(plan) + w_perf · (finish − submit) / deadline

subject to: finish before the deadline; optional carbon budget. This is the
"SLA" §5 proposes: the user picks the carbon/performance trade-off.

``plan()`` scores the whole grid with array ops on the shared
:class:`CarbonField` — every (FTN, source) leg evaluates all start slots
from one prefix-sum emission pass. ``plan_reference()`` keeps the scalar
nested-loop implementation as the oracle the equivalence tests compare
against; ``plan_batch()`` scores a whole admission window at once on the
planner's device: the torch lattice (``grid_torch``) or the two fused
CUDA kernels (``grid_cuda``).

The port of the reference's ``planner.py``: the same semantics, the same
plans, with ``plan_batch_torch`` in place of ``plan_batch_jax``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device

from repro_torch.core.carbon.energy import HOST_PROFILES, host_profile_for_endpoint
from repro_torch.core.carbon.field import CarbonField, default_field
from repro_torch.core.carbon.path import NetworkPath, discover_path
from repro_torch.core.carbon.score import (carbonscore, transfer_emissions_g,
                                     transfer_emissions_g_reference)
from repro_torch.core.obs.metrics import log_bounds
from repro_torch.core.scheduler import grid_cuda
from repro_torch.core.scheduler.grid_torch import (_MAX_GRID, CellTask,
                                                   LegTask, TorchGridScorer,
                                                   batch_cell_emissions)
from repro_torch.core.scheduler.overlay import FTN
from repro_torch.core.scheduler.time_shift import expected_transfer_ci
from repro_torch.core.transfer.throughput import ThroughputModel

# plan_batch wall-time histogram bounds: 10 µs .. 100 s (fixed so every
# shard's buckets merge exactly)
_WALL_BOUNDS = log_bounds(1e-5, 1e2, per_decade=2)


@dataclasses.dataclass(frozen=True)
class SLA:
    deadline_s: float                  # relative to submission
    carbon_budget_g: Optional[float] = None
    w_carbon: float = 1.0
    w_perf: float = 0.0                # 0 = pure carbon minimization


@dataclasses.dataclass(frozen=True)
class TransferJob:
    uuid: str
    size_bytes: float
    replicas: Tuple[str, ...]          # candidate sources (space shifting)
    dst: str                           # final destination endpoint
    sla: SLA
    submitted_t: float
    parallelism: int = 4
    concurrency: int = 2
    pipelining: int = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    job_uuid: str
    start_t: float
    source: str
    ftn: str
    path: NetworkPath
    predicted_gbps: float
    predicted_duration_s: float
    predicted_emissions_g: float
    predicted_avg_ci: float
    predicted_carbonscore: float
    cost: float
    feasible: bool
    alternatives: int = 0
    # counterfactual anchor for the attribution rollups (core.obs): the
    # emissions of the greedy-now baseline — dispatch immediately on the
    # fastest (FTN, replica) cell, no time/space deliberation. Captured
    # only under observability (None otherwise — NaN would break the
    # Plan equality the replay tests pin).
    greedy_g: Optional[float] = None


def _plan_cost(sla: SLA, emissions_g: float, finish_rel_s) -> float:
    """The SLA objective: w_carbon·emissions + w_perf·normalized duration.

    The perf term is the job's wall-clock span normalized by the deadline —
    it must NOT rescale with emissions (the seed multiplied the two, so
    w_perf silently grew with job size). Accepts scalars or arrays.
    """
    slack = max(sla.deadline_s, 1.0)
    return sla.w_carbon * emissions_g + sla.w_perf * finish_rel_s / slack


class TorchCarbonPlanner:
    """The joint planner on torch. ``plan()``/``rescore()`` score each leg
    on ``backend``: ``"numpy"`` (default), the pinned oracle field, or
    ``"torch"``, ``grid_torch.TorchGridScorer`` on ``device``;
    ``plan_batch()`` scores whole admission windows on ``device``
    (``cuda`` unless given; without a GPU pass ``"cpu"``, or construction
    raises).

    ``batch_backend`` picks the full-scan path of ``plan_batch``:
    ``"fused"`` (default) runs the two CUDA kernels of ``grid_cuda``
    (their plain torch versions on the CPU), ``"torch"`` the lattice of
    ``grid_torch``, ``"numpy"`` the per-job scan of ``plan()`` (on
    ``backend``'s scorer). A kernel that fails to build or launch raises:
    there is no fallback.
    """

    def __init__(self, ftns: Sequence[FTN],
                 throughput: Optional[ThroughputModel] = None,
                 slot_s: float = 3600.0,
                 ci_fn: Optional[Callable[[NetworkPath, float], float]] = None,
                 field: Optional[CarbonField] = None,
                 backend: str = "numpy",
                 batch_backend: str = "fused",
                 device: Optional[Union[str, torch.device]] = None):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"backend must be 'numpy' or 'torch', got "
                             f"{backend!r}")
        if batch_backend not in ("numpy", "torch", "fused"):
            raise ValueError(f"batch_backend must be 'numpy', 'torch' or "
                             f"'fused', got {batch_backend!r}")
        self.device = resolve_device(device)
        self.ftns = list(ftns)
        self._ftn_by_name = {f.name: f for f in self.ftns}
        self.throughput = throughput or ThroughputModel()
        self.slot_s = slot_s
        self.ci_fn = ci_fn             # forecast hook; None = oracle trace
        self.field = field or default_field()
        self.backend = backend
        self._scorer: Optional[TorchGridScorer] = None
        self.batch_backend = batch_backend
        # drift hook (the fleet controller's forecast-shock nowcast): a
        # (path, start_times) -> multiplier-array applied to the forecast
        # emission integral, so re-plans during measured CI drift can
        # route around it instead of re-deriving the same shocked plan
        self.emission_scale_fn: Optional[
            Callable[[NetworkPath, np.ndarray], np.ndarray]] = None
        # observability (core.obs): with capture_greedy on, every Plan
        # carries the greedy-now counterfactual; _metrics is the owning
        # observer's registry for plan_batch timing
        self.capture_greedy = False
        self._metrics = None

    def observe_with(self, obs) -> None:
        """Attach a :class:`~repro_torch.core.obs.observer.FleetObserver`:
        turns on greedy-now capture and routes plan_batch timing /
        cell counts into its metrics registry."""
        self.capture_greedy = True
        self._metrics = obs.registry

    def __getstate__(self) -> dict:
        """Pickle support for checkpoints and worker processes:
        ``emission_scale_fn`` is the owning controller's bound hook, which
        the controller re-wires in its own ``__setstate__``, so a planner
        never drags a stale owner through a checkpoint; ``device`` travels
        as its name. The per-leg scorer, which holds device tensors, is
        dropped and rebuilt on first use; the batch paths build their
        tables per call."""
        d = self.__dict__.copy()
        d["emission_scale_fn"] = None
        d["device"] = str(self.device)
        d["_scorer"] = None
        return d

    def __setstate__(self, d: dict) -> None:
        """The device is restored as named and not queried: a restore may
        place the planner elsewhere (``persistence.restore(device=...)``)
        before it plans."""
        self.__dict__.update(d)
        self.device = torch.device(d["device"])

    @property
    def scorer(self) -> Optional[TorchGridScorer]:
        """The per-leg torch scorer (``backend="torch"``), built on the
        planner's device at first use; None on the numpy backend."""
        if self.backend == "torch" and self._scorer is None:
            self._scorer = TorchGridScorer(self.field, device=self.device)
        return self._scorer

    def _leg_emissions(self, path: NetworkPath, receiver, job: TransferJob,
                       ts: np.ndarray, gbps: float) -> np.ndarray:
        """Emission integral for one leg over all candidate starts — the
        grid-scoring hot path of ``plan()``/``rescore()``, dispatched by
        backend (numpy is the pinned oracle; torch runs the same integral
        on the planner's device)."""
        scorer = self.scorer
        score = (scorer.leg_emissions_g if scorer is not None
                 else self.field.transfer_emissions_g)
        emis = score(
            path, HOST_PROFILES["storage_frontend"], receiver,
            job.size_bytes, ts, gbps,
            parallelism=job.parallelism, concurrency=job.concurrency)
        if self.emission_scale_fn is not None:
            emis = emis * self.emission_scale_fn(path, np.atleast_1d(ts))
        return emis

    def _ci(self, path: NetworkPath, t0: float, dur: float) -> float:
        if self.ci_fn is not None:
            return self.ci_fn(path, t0)
        return expected_transfer_ci(path, t0, dur)

    def _ci_vec(self, path: NetworkPath, t0s: np.ndarray, dur: float
                ) -> np.ndarray:
        if self.ci_fn is not None:
            return np.array([self.ci_fn(path, float(t)) for t in t0s])
        return self.field.expected_transfer_ci(path, t0s, dur)

    def _resolve_greedy(self, job: TransferJob,
                        captured: Optional[float]) -> Optional[float]:
        """The greedy-now counterfactual for a finished plan: the slot-0
        emission of the fastest cell, read off the already-scored grid
        (``captured``, free) when the scan produced one, else one
        fallback integral (fused grids never materialize slot values;
        infeasible fallbacks never scanned)."""
        if not self.capture_greedy:
            return None
        return captured if captured is not None \
            else self._greedy_now_g(job)

    def _greedy_now_g(self, job: TransferJob) -> Optional[float]:
        """The counterfactual baseline: start *now* (slot 0) on the
        fastest (FTN, replica) cell — what a carbon-blind dispatcher
        would do. Fallback path only (see :meth:`_resolve_greedy`): one
        single-slot emission integral on the numpy oracle path."""
        best = None                    # (dur, ftn, legs, gbps)
        for ftn, src, legs, gbps, dur in self._candidates(job):
            if gbps <= 0:
                continue
            if best is None or dur < best[0]:
                best = (dur, ftn, legs, gbps)
        if best is None:
            return None
        dur, ftn, legs, gbps = best
        ts = np.array([job.submitted_t])
        g = 0.0
        for (a, b) in legs:
            p = discover_path(a, b)
            emis = self.field.transfer_emissions_g(
                p, HOST_PROFILES["storage_frontend"], ftn.power_model,
                job.size_bytes, ts, gbps,
                parallelism=job.parallelism, concurrency=job.concurrency)
            if self.emission_scale_fn is not None:
                emis = emis * self.emission_scale_fn(p, ts)
            g += float(np.asarray(emis).reshape(-1)[0])
        return g

    def _candidates(self, job: TransferJob
                    ) -> Iterator[Tuple[FTN, str, List[Tuple[str, str]],
                                        float, float]]:
        """(ftn, source, legs, predicted_gbps, predicted_duration) for every
        (FTN × replica) cell of the grid — shared by plan()/plan_reference()
        so both scan the identical candidate set in the identical order."""
        for ftn in self.ftns:
            # an FTN relays source → ftn → dst; a direct transfer is the
            # degenerate FTN co-located with dst.
            for src in job.replicas:
                legs = [(src, ftn.name)]
                if ftn.name != job.dst:
                    legs.append((ftn.name, job.dst))
                gbps = min(self.throughput.predict(a, b, job.parallelism,
                                                   job.concurrency)
                           for a, b in legs)
                gbps = min(gbps, ftn.max_gbps)
                dur = job.size_bytes * 8.0 / (gbps * 1e9)
                yield ftn, src, legs, gbps, dur

    def _slot_starts(self, job: TransferJob, dur: float,
                     deadline_t: float) -> np.ndarray:
        """Candidate start times: every slot that finishes by the deadline,
        or just the immediate start when none fits (SLA-first)."""
        latest = deadline_t - dur
        n = 1
        if latest + 1e-9 >= job.submitted_t:
            n = int((latest + 1e-9 - job.submitted_t) // self.slot_s) + 1
        return job.submitted_t + self.slot_s * np.arange(n)

    # --- vectorized fast path ---------------------------------------------
    def plan(self, job: TransferJob) -> Plan:
        deadline_t = job.submitted_t + job.sla.deadline_s
        best: Optional[Tuple] = None   # (cost, emis, t, ftn, src, paths,
        n_alt = 0                      #  gbps, dur)
        g0: Optional[Tuple] = None     # (dur, emis[0]): greedy-now capture
        for ftn, src, legs, gbps, dur in self._candidates(job):
            ts = self._slot_starts(job, dur, deadline_t)
            emis = np.zeros(ts.shape)
            paths = [discover_path(a, b) for (a, b) in legs]
            for p in paths:
                emis += self._leg_emissions(p, ftn.power_model, job, ts, gbps)
            # ts[0] is always the submission instant, so the scan already
            # scored the carbon-blind start-now cell — keep the fastest
            if self.capture_greedy and gbps > 0 \
                    and (g0 is None or dur < g0[0]):
                g0 = (dur, float(emis[0]))
            feasible = ts + dur <= deadline_t + 1e-9
            if job.sla.carbon_budget_g is not None:
                feasible &= emis <= job.sla.carbon_budget_g
            cost = _plan_cost(job.sla, emis, ts + dur - job.submitted_t)
            n_alt += len(ts)
            if not feasible.any():
                continue
            i = int(np.argmin(np.where(feasible, cost, np.inf)))
            if best is None or cost[i] < best[0]:
                best = (float(cost[i]), float(emis[i]), float(ts[i]),
                        ftn, src, paths, gbps, dur)
        if best is None:
            return self._fallback(job, n_alt,
                                  greedy=g0[1] if g0 else None)
        return self._finish_plan(job, best, n_alt,
                                 greedy=g0[1] if g0 else None)

    def _finish_plan(self, job: TransferJob, best: Tuple,
                     n_alt: int, greedy: Optional[float] = None) -> Plan:
        """Materialize the winning cell into a Plan. The avg-CI/carbonscore
        annotations never enter the cost, so they are sampled once for the
        winner here instead of for every candidate slot of the scan (~30%
        of the old grid-scan cost); plan() and plan_batch_torch() share this
        tail so both report bit-identical annotations."""
        cost_i, emis_i, t_i, ftn, src, paths, gbps, dur = best
        t_arr = np.array([t_i])
        avg_ci = sum(float(self._ci_vec(p, t_arr, dur)[0])
                     for p in paths) / len(paths)
        return Plan(
            job_uuid=job.uuid, start_t=t_i, source=src, ftn=ftn.name,
            path=discover_path(src, ftn.name), predicted_gbps=gbps,
            predicted_duration_s=dur, predicted_emissions_g=emis_i,
            predicted_avg_ci=avg_ci,
            predicted_carbonscore=carbonscore(job.size_bytes, avg_ci, dur),
            cost=cost_i, feasible=True, alternatives=n_alt,
            greedy_g=self._resolve_greedy(job, greedy))

    def _finish_plans(self, items: Sequence[Tuple]) -> List[Plan]:
        """:meth:`_finish_plan` for many winners at once: the midpoint
        CI samples of every winner sharing a path evaluate in one
        ``path_ci`` call (identical floats — same per-element math and
        summation order as ``expected_transfer_ci``)."""
        if self.ci_fn is not None or len(items) < 4:
            return [self._finish_plan(job, best, n_alt, greedy)
                    for job, best, n_alt, greedy in items]
        by_path: dict = {}
        legs_n: List[List[Tuple]] = []
        for j, (job, best, n_alt, _greedy) in enumerate(items):
            _, _, t_i, _, _, paths, _, dur = best
            row = []
            for p in paths:
                n = max(int(dur // 900.0), 1)
                mids = t_i + (np.arange(n) + 0.5) * dur / n
                key = (p.src, p.dst, p.hops)
                ent = by_path.setdefault(key, (p, []))
                ent[1].append(mids)
                row.append((key, len(ent[1]) - 1, n))
            legs_n.append(row)
        vals: dict = {}
        for key, (p, chunks) in by_path.items():
            v = self.field.path_ci(p, np.concatenate(chunks))
            bounds = np.cumsum([0] + [len(c) for c in chunks])
            vals[key] = [v[bounds[i]:bounds[i + 1]]
                         for i in range(len(chunks))]
        out = []
        for (job, best, n_alt, greedy), row in zip(items, legs_n):
            cost_i, emis_i, t_i, ftn, src, paths, gbps, dur = best
            avg_ci = sum(float(vals[key][slot].sum() / n)
                         for key, slot, n in row) / len(row)
            out.append(Plan(
                job_uuid=job.uuid, start_t=t_i, source=src, ftn=ftn.name,
                path=discover_path(src, ftn.name), predicted_gbps=gbps,
                predicted_duration_s=dur, predicted_emissions_g=emis_i,
                predicted_avg_ci=avg_ci,
                predicted_carbonscore=carbonscore(job.size_bytes, avg_ci,
                                                  dur),
                cost=cost_i, feasible=True, alternatives=n_alt,
                greedy_g=self._resolve_greedy(job, greedy)))
        return out

    def plan_batch(self, jobs: Sequence[TransferJob],
                   previous: Optional[Sequence[Optional[Plan]]] = None,
                   drift_tol: Optional[float] = None) -> List[Plan]:
        """Fleet-scale planning: one call, shared caches. On the numpy
        batch backend the first plan warms the path/noise/trace caches and
        the rest reuse them; with ``batch_backend="torch"`` or ``"fused"``
        the whole fleet's grids are stacked and scored on the planner's
        device by :meth:`plan_batch_torch`.

        Incremental mode (the control plane's forecast-drift path): with
        ``previous`` plans and a ``drift_tol``, each job's old grid cell is
        first re-scored under current conditions; if it is still feasible
        and its predicted *emissions* moved by at most ``drift_tol``
        (relative), the job keeps its cell without a full grid scan —
        O(1 cell) instead of O(FTN x replica x slot). Emissions, not cost,
        is the drift metric: the w_perf term is measured from the job's
        submission base, which a queue rebase shifts without any real
        change in conditions. ``drift_tol=0.0`` degenerates to a full
        re-plan of every job whose conditions changed at all — and the
        drifted jobs are themselves re-planned as one batch.
        """
        if self._metrics is None:
            return self._plan_batch(jobs, previous, drift_tol)
        t0 = time.perf_counter()
        plans = self._plan_batch(jobs, previous, drift_tol)
        # wall time goes to metrics only, never into spans — traces stay
        # deterministic under replay, timings do not
        self._metrics.histogram("planner_plan_batch_wall_s",
                                bounds=_WALL_BOUNDS) \
            .observe(time.perf_counter() - t0)
        self._metrics.counter("planner_plan_batches_total",
                              backend=self.batch_backend).inc()
        self._metrics.counter("planner_cells_scored_total").inc(
            float(sum(p.alternatives for p in plans if p is not None)))
        return plans

    def _plan_batch(self, jobs: Sequence[TransferJob],
                    previous: Optional[Sequence[Optional[Plan]]] = None,
                    drift_tol: Optional[float] = None) -> List[Plan]:
        if previous is None or drift_tol is None:
            return self._plan_batch_full(list(jobs))
        jobs, previous = list(jobs), list(previous)
        out: List[Optional[Plan]] = [None] * len(jobs)
        miss: List[int] = []
        for i, (prev, re) in enumerate(zip(previous,
                                           self.rescore_batch(jobs,
                                                              previous))):
            if (re is not None and re.feasible
                    and abs(re.predicted_emissions_g
                            - prev.predicted_emissions_g)
                    <= drift_tol * max(prev.predicted_emissions_g, 1e-12)):
                out[i] = re
            else:
                miss.append(i)
        if miss:
            for i, plan in zip(miss,
                               self._plan_batch_full([jobs[i]
                                                      for i in miss])):
                out[i] = plan
        return out                     # type: ignore[return-value]

    # below these sizes the batch path's fixed dispatch cost loses to
    # the numpy per-job scan, so small sweeps stay on the oracle.
    # Re-scores are single-cell (one slot, one anchor each): the kernel's
    # per-anchor lattice only amortizes on very large sweeps.
    _BATCH_MIN_JOBS = 8
    _RESCORE_MIN_CELLS = 512

    # observability: cell count of the most recent plan_batch_torch call —
    # the scale bench reads it to report peak admission-grid size.
    last_batch_cells = 0

    def _plan_batch_full(self, jobs: Sequence[TransferJob]) -> List[Plan]:
        if self.batch_backend in ("torch", "fused") \
                and len(jobs) >= self._BATCH_MIN_JOBS:
            return self.plan_batch_torch(jobs)
        return [self.plan(job) for job in jobs]

    def plan_batch_torch(self, jobs: Sequence[TransferJob], *,
                         shard=None) -> List[Plan]:
        """Batched fleet planning on the planner's device: every job's
        (FTN x replica x slot) grid is stacked into one padded/masked cell
        table and scored per memory chunk.

        The numpy :meth:`plan_batch` is the pinned oracle: this path must
        pick the same grid cells with emissions within 1e-4 relative
        (in practice ~1e-7 — f32 CI chain, f64 time math). Jobs whose
        layout the batch path cannot host (non-dt-aligned slots, a rate
        grid past the per-cell cap) fall back to the numpy :meth:`plan`.

        With ``batch_backend="fused"`` the cell tables feed
        ``grid_cuda.batch_cell_best``: the scoring chain *and* each cell's
        feasible-argmin run in the two kernels, so only the per-cell winner
        (cost, emissions, slot) crosses back to the host. With ``"torch"``
        the lattice of ``grid_torch.batch_cell_emissions`` returns each
        cell's (leg, slot) emission table and the host takes the argmin.
        ``shard`` is forwarded to that lattice's split of the cell axis
        over devices: ``None``/``True``/``False`` or a
        :class:`~repro_torch.core.scheduler.grid_torch.MeshConfig`. It
        does not apply to the fused kernels.
        """
        dt_s = 60.0
        stride = self.slot_s / dt_s
        if stride != int(stride) or stride <= 0:
            return [self.plan(job) for job in jobs]
        stride = int(stride)
        cells, sla_rows, meta = self._batch_cells(jobs, dt_s, stride)
        self.last_batch_cells = len(cells)
        fused = None                   # (cost, emis, slot) per cell
        tables: List[np.ndarray] = []
        if cells and self.batch_backend == "fused":
            fused = grid_cuda.batch_cell_best(
                self.field, cells, sla_rows, dt_s=dt_s, slot_stride=stride,
                slot_s=self.slot_s, scale_fn=self.emission_scale_fn,
                device=self.device)
        elif cells:
            tables = batch_cell_emissions(self.field, cells, dt_s=dt_s,
                                          slot_stride=stride,
                                          device=self.device, shard=shard)
        plans: List[Optional[Plan]] = []
        winners: List[Tuple[int, Tuple[TransferJob, Tuple, int]]] = []
        for job, jcells in zip(jobs, meta):
            if jcells is None:
                plans.append(self.plan(job))
                continue
            deadline_t = job.submitted_t + job.sla.deadline_s
            best: Optional[Tuple] = None
            n_alt = 0
            g0: Optional[Tuple] = None   # (dur, emis[0]) greedy capture
            for idx, ftn, src, paths, gbps, dur, ts in jcells:
                n_alt += len(ts)
                if idx is None:
                    continue
                if fused is not None:  # in-kernel mask + argmin
                    c_cost = float(fused[0][idx])
                    if not math.isfinite(c_cost):
                        continue
                    if best is None or c_cost < best[0]:
                        i = int(fused[2][idx])
                        best = (c_cost, float(fused[1][idx]),
                                float(ts[i]), ftn, src, paths, gbps, dur)
                    continue
                tab = tables[idx]      # (n_legs, n_slots)
                if self.emission_scale_fn is not None:
                    tab = tab * np.stack(
                        [self.emission_scale_fn(p, ts) for p in paths])
                emis = tab.sum(axis=0)
                # slot 0 is the submission instant: the scored grid gives
                # the carbon-blind start-now cell for free (the fused path
                # never materializes slot values — _resolve_greedy falls
                # back to one integral there)
                if self.capture_greedy and gbps > 0 \
                        and (g0 is None or dur < g0[0]):
                    g0 = (dur, float(emis[0]))
                feasible = ts + dur <= deadline_t + 1e-9
                if job.sla.carbon_budget_g is not None:
                    feasible &= emis <= job.sla.carbon_budget_g
                cost = _plan_cost(job.sla, emis, ts + dur - job.submitted_t)
                if not feasible.any():
                    continue
                i = int(np.argmin(np.where(feasible, cost, np.inf)))
                if best is None or cost[i] < best[0]:
                    best = (float(cost[i]), float(emis[i]), float(ts[i]),
                            ftn, src, paths, gbps, dur)
            if best is None:
                plans.append(self._fallback(job, n_alt,
                                            greedy=g0[1] if g0 else None))
            else:
                winners.append((len(plans),
                                (job, best, n_alt, g0[1] if g0 else None)))
                plans.append(None)     # filled by the batched finisher
        for (slot, _), plan in zip(winners,
                                   self._finish_plans([w for _, w
                                                       in winners])):
            plans[slot] = plan
        return plans                   # type: ignore[return-value]

    def _batch_cells(self, jobs: Sequence[TransferJob], dt_s: float,
                     stride: int) -> Tuple[List[CellTask], List[Tuple],
                                           List[Optional[List[Tuple]]]]:
        """The stacked cell table of :meth:`plan_batch_torch`: per cell a
        :class:`CellTask` and its SLA row, per job the list of its cells
        (``None`` when a cell's rate grid exceeds ``_MAX_GRID`` and the
        job must go to the numpy :meth:`plan`)."""
        sender = HOST_PROFILES["storage_frontend"]
        cells: List[CellTask] = []
        sla_rows: List[Tuple] = []     # per cell, aligned with ``cells``
        meta: List[Optional[List[Tuple]]] = []
        wcache: dict = {}              # (path, recv, gbps, par, con) -> w

        def leg_w(p, pm, gbps, par, con):
            k = (id(p), pm.name, gbps, par, con)
            w = wcache.get(k)
            if w is None:
                w = wcache[k] = self.field.device_weight_fn(
                    p, sender, pm, par, con)(gbps)
            return w

        for job in jobs:
            deadline_t = job.submitted_t + job.sla.deadline_s
            jcells: Optional[List[Tuple]] = []
            job_cell0 = len(cells)
            for ftn, src, legs, gbps, dur in self._candidates(job):
                ts = self._slot_starts(job, dur, deadline_t)
                paths = [discover_path(a, b) for (a, b) in legs]
                if gbps <= 0:          # inf emissions: never feasible
                    jcells.append((None, ftn, src, paths, gbps, dur, ts))
                    continue
                n_steps = max(int(math.ceil(dur / dt_s - 1e-12)), 1)
                if (len(ts) - 1) * stride + n_steps > _MAX_GRID:
                    jcells = None      # degenerate rate grid: numpy plan()
                    del cells[job_cell0:]   # drop its half-built cells
                    del sla_rows[job_cell0:]
                    break
                jcells.append((len(cells), ftn, src, paths, gbps, dur, ts))
                cells.append(CellTask(
                    legs=tuple(LegTask(
                        path=p, anchor=float(ts[0]),
                        w_dev=leg_w(p, ftn.power_model, gbps,
                                    job.parallelism, job.concurrency))
                        for p in paths),
                    n_slots=len(ts), n_steps=n_steps,
                    rem_s=dur - (n_steps - 1) * dt_s))
                # the deadline mask is monotone in the slot index, so the
                # fused kernel takes it as a host-side count; the budget
                # mask depends on in-kernel emissions and stays in-kernel
                sla_rows.append((
                    float(np.sum(ts + dur <= deadline_t + 1e-9)), dur,
                    job.sla.w_perf / max(job.sla.deadline_s, 1.0),
                    job.sla.w_carbon,
                    job.sla.carbon_budget_g
                    if job.sla.carbon_budget_g is not None else np.inf,
                    job.submitted_t))
            meta.append(jcells)
        return cells, sla_rows, meta

    def rescore_batch(self, jobs: Sequence[TransferJob],
                      previous: Sequence[Optional[Plan]]
                      ) -> List[Optional[Plan]]:
        """:meth:`rescore` for a whole sweep. On the torch and fused batch
        backends all surviving cells (one slot each) score in one torch
        lattice call (``grid_torch.batch_cell_emissions``; within float
        noise, ~1e-7, of per-job rescore — a sweep with ``drift_tol=0.0``
        should therefore use the numpy backend, where re-scores are
        bit-stable); otherwise falls back to per-job :meth:`rescore`. The
        fused backend re-scores on the lattice too — a re-score needs the
        cell's *value*, not a fused argmin over slots. ``None`` entries
        mean the cell no longer exists and the caller must full-plan."""
        if self.batch_backend not in ("torch", "fused") \
                or len(jobs) < self._RESCORE_MIN_CELLS:
            return [self.rescore(j, p) if p is not None else None
                    for j, p in zip(jobs, previous)]
        dt_s = 60.0
        sender = HOST_PROFILES["storage_frontend"]
        out: List[Optional[Plan]] = [None] * len(jobs)
        cells: List[CellTask] = []
        meta: List[Tuple] = []
        for i, (job, prev) in enumerate(zip(jobs, previous)):
            if prev is None:
                continue
            ftn = self._ftn_by_name.get(prev.ftn)
            if ftn is None or prev.start_t < job.submitted_t - 1e-9:
                continue               # stale cell: caller full-plans
            legs = [(prev.source, ftn.name)]
            if ftn.name != job.dst:
                legs.append((ftn.name, job.dst))
            gbps = min(self.throughput.predict(a, b, job.parallelism,
                                               job.concurrency)
                       for a, b in legs)
            gbps = min(gbps, ftn.max_gbps)
            dur = job.size_bytes * 8.0 / (gbps * 1e9)
            n_steps = max(int(math.ceil(dur / dt_s - 1e-12)), 1)
            if n_steps > _MAX_GRID:
                out[i] = self.rescore(job, prev)
                continue
            paths = [discover_path(a, b) for (a, b) in legs]
            meta.append((i, job, prev, ftn, gbps, dur, paths))
            cells.append(CellTask(
                legs=tuple(LegTask(
                    path=p, anchor=float(prev.start_t),
                    w_dev=self.field.device_weight_fn(
                        p, sender, ftn.power_model, job.parallelism,
                        job.concurrency)(gbps)) for p in paths),
                n_slots=1, n_steps=n_steps,
                rem_s=dur - (n_steps - 1) * dt_s))
        if cells:
            tables = batch_cell_emissions(self.field, cells, dt_s=dt_s,
                                          slot_stride=1, device=self.device)
            for (i, job, prev, ftn, gbps, dur, paths), tab in zip(meta,
                                                                  tables):
                ts = np.array([prev.start_t])
                if self.emission_scale_fn is not None:
                    tab = tab * np.stack(
                        [self.emission_scale_fn(p, ts) for p in paths])
                emis = float(tab.sum())
                deadline_t = job.submitted_t + job.sla.deadline_s
                feasible = prev.start_t + dur <= deadline_t + 1e-9
                if job.sla.carbon_budget_g is not None:
                    feasible = feasible and emis <= job.sla.carbon_budget_g
                cost = float(_plan_cost(job.sla, emis,
                                        prev.start_t + dur
                                        - job.submitted_t))
                out[i] = dataclasses.replace(
                    prev, predicted_gbps=gbps, predicted_duration_s=dur,
                    predicted_emissions_g=emis, cost=cost,
                    feasible=bool(feasible))
        return out

    def rescore(self, job: TransferJob, prev: Plan) -> Optional[Plan]:
        """Re-evaluate one existing plan's (source, FTN, start) cell under
        current forecasts/throughput. Returns the refreshed Plan (possibly
        infeasible), or None when the cell no longer exists — start slot in
        the past, unknown FTN (the infeasible fallback's pseudo-cell) — in
        which case the caller must run a full :meth:`plan`."""
        ftn = self._ftn_by_name.get(prev.ftn)
        if ftn is None or prev.start_t < job.submitted_t - 1e-9:
            return None
        deadline_t = job.submitted_t + job.sla.deadline_s
        legs = [(prev.source, ftn.name)]
        if ftn.name != job.dst:
            legs.append((ftn.name, job.dst))
        gbps = min(self.throughput.predict(a, b, job.parallelism,
                                           job.concurrency)
                   for a, b in legs)
        gbps = min(gbps, ftn.max_gbps)
        dur = job.size_bytes * 8.0 / (gbps * 1e9)
        ts = np.array([prev.start_t])
        emis = np.zeros(1)
        for (a, b) in legs:
            p = discover_path(a, b)
            emis += self._leg_emissions(p, ftn.power_model, job, ts, gbps)
        feasible = prev.start_t + dur <= deadline_t + 1e-9
        if job.sla.carbon_budget_g is not None:
            feasible = feasible and float(emis[0]) <= job.sla.carbon_budget_g
        cost = float(_plan_cost(job.sla, float(emis[0]),
                                prev.start_t + dur - job.submitted_t))
        # the avg-CI/carbonscore annotations are kept from the previous
        # plan: they do not enter the cost, and re-sampling them would cost
        # more than the whole O(1) re-score
        return dataclasses.replace(
            prev, predicted_gbps=gbps, predicted_duration_s=dur,
            predicted_emissions_g=float(emis[0]),
            cost=cost, feasible=bool(feasible))

    # --- scalar reference oracle ------------------------------------------
    def plan_reference(self, job: TransferJob) -> Plan:
        """The seed's nested-loop scan, kept as the correctness oracle for
        the vectorized ``plan()`` (tests assert both pick the same
        (start, source, ftn) cell with emissions within 1e-6)."""
        deadline_t = job.submitted_t + job.sla.deadline_s
        best: Optional[Plan] = None
        n_alt = 0
        for ftn, src, legs, gbps, dur in self._candidates(job):
            t = job.submitted_t
            while t + dur <= deadline_t + 1e-9 or t == job.submitted_t:
                emis, ci_acc = 0.0, 0.0
                for (a, b) in legs:
                    p = discover_path(a, b)
                    emis += transfer_emissions_g_reference(
                        p, HOST_PROFILES["storage_frontend"],
                        ftn.power_model, job.size_bytes, t, gbps,
                        parallelism=job.parallelism,
                        concurrency=job.concurrency)
                    ci_acc += self._ci(p, t, dur)
                avg_ci = ci_acc / len(legs)
                feasible = t + dur <= deadline_t + 1e-9
                if job.sla.carbon_budget_g is not None:
                    feasible &= emis <= job.sla.carbon_budget_g
                cost = _plan_cost(job.sla, emis, t + dur - job.submitted_t)
                n_alt += 1
                cand = Plan(
                    job_uuid=job.uuid, start_t=t, source=src,
                    ftn=ftn.name, path=discover_path(src, ftn.name),
                    predicted_gbps=gbps, predicted_duration_s=dur,
                    predicted_emissions_g=emis, predicted_avg_ci=avg_ci,
                    predicted_carbonscore=carbonscore(
                        job.size_bytes, avg_ci, dur),
                    cost=cost, feasible=feasible)
                if feasible and (best is None or cand.cost < best.cost):
                    best = cand
                t += self.slot_s
        if best is None:
            return self._fallback(job, n_alt, reference=True)
        return dataclasses.replace(best, alternatives=n_alt)

    def _fallback(self, job: TransferJob, n_alt: int, *,
                  reference: bool = False,
                  greedy: Optional[float] = None) -> Plan:
        """SLA-infeasible: start now on the best-throughput direct path.
        The receiver power model is derived from the actual destination
        endpoint (the seed hard-coded the TPU-host profile)."""
        src = job.replicas[0]
        gbps = self.throughput.predict(src, job.dst, job.parallelism,
                                       job.concurrency)
        dur = job.size_bytes * 8.0 / (gbps * 1e9)
        p = discover_path(src, job.dst)
        emis_fn = (transfer_emissions_g_reference if reference
                   else transfer_emissions_g)
        emis = emis_fn(
            p, HOST_PROFILES["storage_frontend"],
            host_profile_for_endpoint(job.dst), job.size_bytes,
            job.submitted_t, gbps)
        ci = self._ci(p, job.submitted_t, dur)
        return Plan(job.uuid, job.submitted_t, src, job.dst, p, gbps,
                    dur, emis, ci,
                    carbonscore(job.size_bytes, ci, dur),
                    cost=math.inf, feasible=False, alternatives=n_alt,
                    greedy_g=None if reference
                    else self._resolve_greedy(job, greedy))
