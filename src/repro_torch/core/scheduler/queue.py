"""Carbon-aware admission policy: jobs wait for their planned start slot;
urgent jobs (exhausted slack) preempt greener-but-later ones. Priorities
follow the data-center convention the paper cites [12]: priority bounds how
far a job may be shifted in time/space.

The queue no longer keeps a private heap — it is an *admission policy over
an event loop* (``core.controlplane.events``): ``submit`` plans a job and
pushes a :class:`JobReady` event at the planned start slot. Standalone use
(``CarbonAwareQueue(planner)``) creates a private loop and ``due(now)``
drains it; under the :class:`FleetController` the queue shares the
controller's loop, the controller pops the ``JobReady`` events itself, and
the queue's remaining jobs are admission state (``replan_pending`` cancels
and re-pushes them when forecasts drift).

A copy of the reference's ``core/scheduler/queue.py`` over
:class:`TorchCarbonPlanner`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.controlplane.events import EventLoop, JobReady
from repro_torch.core.scheduler.planner import (Plan, TorchCarbonPlanner,
                                                TransferJob)


class CarbonAwareQueue:
    def __init__(self, planner: TorchCarbonPlanner,
                 events: Optional[EventLoop] = None):
        self.planner = planner
        self.events = events if events is not None else EventLoop()
        self._pending: Dict[str, "object"] = {}   # uuid -> event-loop handle
        self.done: List[Tuple[TransferJob, Plan]] = []

    def _push(self, job: TransferJob, plan: Plan) -> None:
        self._pending[job.uuid] = self.events.push(
            JobReady(t=max(plan.start_t, self.events.now), job=job,
                     plan=plan))

    def submit(self, job: TransferJob,
               plan: Optional[Plan] = None) -> Plan:
        """Admit one job: plan it (unless the caller already did — the
        sharded fleet's batched admission passes precomputed plans) and
        schedule its JobReady at the chosen start slot."""
        if plan is None:
            plan = self.planner.plan(job)
        self._push(job, plan)
        return plan

    def submit_many(self, jobs: List[TransferJob],
                    plans: Optional[List[Plan]] = None) -> List[Plan]:
        """Fleet admission: all grids scored in one ``plan_batch`` call
        (the two CUDA kernels on the fused batch backend; shared
        CarbonField caches on numpy); one enqueue path (submit) keeps the
        ordering logic single. ``plans`` optionally carries precomputed plans
        positionally (parity with ``submit(job, plan)`` — a streaming
        gateway's batched micro-batch plans are not recomputed here)."""
        if plans is None:
            plans = self.planner.plan_batch(jobs)
        elif len(plans) != len(jobs):
            raise ValueError(f"plans ({len(plans)}) must match jobs "
                             f"({len(jobs)})")
        return [self.submit(job, plan) for job, plan in zip(jobs, plans)]

    def claim(self, ev: JobReady) -> None:
        """A caller popped this queue's JobReady from a shared loop: drop it
        from the pending set (it is now the caller's to dispatch)."""
        self._pending.pop(ev.job.uuid, None)

    def due(self, now: float) -> List[Tuple[TransferJob, Plan]]:
        """Pop every job whose planned start has arrived (standalone use —
        under a controller the loop's JobReady events arrive by themselves)."""
        out = []
        while True:
            ev = self.events.pop_due(now)
            if ev is None:
                break
            assert isinstance(ev, JobReady), (
                "due() drains a queue-owned loop; under a shared loop the "
                "controller pops events")
            self.claim(ev)
            out.append((ev.job, ev.plan))
        return out

    def replan_pending(self, now: float, *,
                       drift_tol: Optional[float] = None) -> int:
        """Re-plan queued jobs against fresh forecasts (carbon is
        stochastic, §5). Returns how many plans changed.

        Each waiting job is rebased to ``now`` with its remaining slack
        (``deadline_s`` shrinks by the time already spent waiting, floored
        at 1 s). With ``drift_tol`` set, planning goes through the
        incremental ``plan_batch`` mode: a previous plan whose re-scored
        emissions moved by at most ``drift_tol`` (relative) keeps its grid
        cell without a full scan.
        """
        handles = list(self._pending.items())
        entries: List[Tuple[TransferJob, Plan]] = []
        for uuid, h in handles:
            self.events.cancel(h)
            ev = h.event
            entries.append((ev.job, ev.plan))
            del self._pending[uuid]
        shifted = [dataclasses.replace(
            job, submitted_t=now,
            sla=dataclasses.replace(
                job.sla,
                deadline_s=max(job.submitted_t + job.sla.deadline_s
                               - now, 1.0)))
            for job, _ in entries]
        previous = [plan for _, plan in entries] if drift_tol is not None \
            else None
        plans = self.planner.plan_batch(shifted, previous=previous,
                                        drift_tol=drift_tol)
        changed = 0
        for (job, old_plan), plan in zip(entries, plans):
            if (plan.source, plan.ftn, plan.start_t) != (
                    old_plan.source, old_plan.ftn, old_plan.start_t):
                changed += 1
            # re-enqueue the ORIGINAL job: its absolute deadline
            # (submitted_t + deadline_s) is what successive replans shrink
            # against, so waiting never extends the SLA
            self._push(job, plan)
        return changed

    def __len__(self) -> int:
        return len(self._pending)
