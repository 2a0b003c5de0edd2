"""Typed event records + the heap-based event loop (one simulation clock).

Every layer of the fleet runtime — admission, dispatch, engine stepping,
re-planning, migration polling, forecast drift — advances by popping events
off one shared :class:`EventLoop`. The loop is a plain ``(t, seq)`` min-heap
with lazy cancellation: ``push`` returns a handle, ``cancel`` marks it dead,
``pop`` skips dead entries. Ties break by insertion order, so the runtime is
fully deterministic for a fixed submission sequence.

Layer contract (what every consumer may assume, and must preserve):

* **one monotone clock** — ``now`` only moves forward; pushing an event
  behind the clock raises, so a handler bug cannot silently reorder
  causality. Nothing in the runtime keeps a private clock.
* **deterministic replay** — for a fixed submission sequence the pop order
  is a pure function of (t, insertion seq); sharded fleets rely on this to
  make every shard's run independently reproducible.
* **events are plain records** — all policy lives in the controller's
  handler table (``FleetController._HANDLERS``); an event type carries data
  only. To add a policy, subclass :class:`Event` and register a handler
  (see ``docs/extending.md`` for the worked example).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:                     # types only; no runtime import cycle
    from repro_torch.core.scheduler.planner import Plan, TransferJob


@dataclasses.dataclass
class Event:
    """Base record: ``t`` is the simulation timestamp the event fires at."""
    t: float


@dataclasses.dataclass
class JobArrival(Event):
    """A job enters the system at its submission time (admission).

    ``plan`` optionally carries an admission-time plan computed before the
    event fired (the sharded fleet's batched admission); None means the
    queue plans the job when the arrival is handled."""
    job: "TransferJob" = None
    plan: "Optional[Plan]" = None


@dataclasses.dataclass
class JobReady(Event):
    """A planned start slot arrived: dispatch the job onto the engine."""
    job: "TransferJob" = None
    plan: "Plan" = None


@dataclasses.dataclass
class StepTick(Event):
    """Advance one in-flight transfer by one engine step."""
    job_uuid: str = ""


@dataclasses.dataclass
class ReplanTick(Event):
    """Periodic sweep: re-plan still-queued jobs against fresh conditions."""


@dataclasses.dataclass
class MigrationCheck(Event):
    """Periodic sweep: poll in-flight transfers for threshold migration."""


@dataclasses.dataclass
class ForecastShock(Event):
    """Carbon-intensity drift: from ``t`` until ``until``, the *measured* CI
    of paths crossing ``zones`` (None = every zone) is ``factor`` x the
    forecast trace the planner used. Models the §5 'highly stochastic'
    forecast error that forces closed-loop re-planning and migration."""
    factor: float = 1.0
    until: float = float("inf")
    zones: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class JobComplete(Event):
    """Bookkeeping record emitted when a job's final leg finishes."""
    job_uuid: str = ""


@dataclasses.dataclass(order=True)
class _Entry:
    t: float
    seq: int
    event: Event = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(default=False, compare=False)


class EventLoop:
    """Min-heap of events with a single monotone simulation clock.

    ``now`` only moves forward — pushing an event in the past raises, so a
    handler bug cannot silently reorder causality.
    """

    def __init__(self, t0: float = 0.0):
        self._heap: List[_Entry] = []
        self._seq = 0
        self._alive = 0
        self.now = t0

    def push(self, event: Event) -> _Entry:
        if event.t < self.now - 1e-9:
            raise ValueError(
                f"event at t={event.t} is before the clock ({self.now})")
        e = _Entry(event.t, self._seq, event)
        self._seq += 1
        self._alive += 1
        heapq.heappush(self._heap, e)
        return e

    def cancel(self, handle: _Entry) -> None:
        if not handle.cancelled:
            handle.cancelled = True
            self._alive -= 1

    def _drop_dead(self) -> None:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)

    def peek_t(self) -> Optional[float]:
        self._drop_dead()
        return self._heap[0].t if self._heap else None

    def pop(self) -> Optional[Event]:
        """Next live event; advances the clock to its timestamp."""
        self._drop_dead()
        if not self._heap:
            return None
        e = heapq.heappop(self._heap)
        self._alive -= 1
        self.now = max(self.now, e.t)
        return e.event

    def pop_due(self, now: float) -> Optional[Event]:
        """Pop the head only if it fires at or before ``now``."""
        t = self.peek_t()
        if t is None or t > now + 1e-9:
            return None
        return self.pop()

    def __len__(self) -> int:
        return self._alive

    @property
    def empty(self) -> bool:
        return self._alive == 0
