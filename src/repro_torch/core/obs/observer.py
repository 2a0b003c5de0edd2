"""Observation state carried by a controller or coordinator.

:class:`FleetObserver` bundles the span buffer and the metrics registry
behind one object that is *plain picklable data*: stored on a
``FleetController`` it rides checkpoints, journal replay and the worker
pipe protocol untouched, which is what makes traces replay-consistent
for free.  ``ObsConfig`` is the frozen, hashable knob that travels
through ``ShardedFleet(**controller_kw)`` and ``ShardSpec`` to worker
processes.

Determinism contract: span payloads come exclusively from sim-clock
state.  Wall-clock timings (plan_batch wall, recovery latency) go into
the metrics registry only, which the bit-identity tests exclude.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, Union

from repro_torch.core.obs.metrics import (Counter, Gauge, Histogram,
                                          MetricsRegistry, NULL_INSTRUMENT)
from repro_torch.core.obs.trace import Span

__all__ = ["ObsConfig", "FleetObserver", "as_observer"]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Which pillars to pay for.  Frozen + picklable: rides
    ``controller_kw`` through shard specs to worker processes."""
    trace: bool = True
    metrics: bool = True


class FleetObserver:
    """Span buffer + metrics registry for one controller (or the fleet
    coordinator).  All methods are hot-path cheap; when a pillar is
    disabled the corresponding calls are no-ops."""

    def __init__(self, config: Optional[ObsConfig] = None) -> None:
        self.config = config or ObsConfig()
        self.spans: List[Span] = []
        self._seq = 0
        self.registry: Optional[MetricsRegistry] = (
            MetricsRegistry() if self.config.metrics else None)

    # --- tracing ----------------------------------------------------------
    @property
    def tracing(self) -> bool:
        return self.config.trace

    def span(self, kind: str, t: float, job: str = "",
             **attrs: Any) -> None:
        """Record one span at sim time ``t`` (no-op unless tracing)."""
        if not self.config.trace:
            return
        self._seq += 1
        self.spans.append(Span(float(t), self._seq, kind, job,
                               tuple(sorted(attrs.items()))))

    def trace(self) -> Tuple[Span, ...]:
        return tuple(self.spans)

    # --- metrics ----------------------------------------------------------
    def counter(self, name: str, **labels: Any) -> Union[Counter, Any]:
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels: Any) -> Union[Gauge, Any]:
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str,
                  bounds: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Union[Histogram, Any]:
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.histogram(name, bounds=bounds, **labels)

    def metrics_snapshot(self) -> Optional[dict]:
        return self.registry.snapshot() if self.registry is not None else None


def as_observer(obs: Union[None, bool, ObsConfig, FleetObserver]
                ) -> Optional[FleetObserver]:
    """Normalize the ``obs=`` kwarg accepted across the control plane:
    ``None``/``False`` → observability off (zero overhead), ``True`` →
    default :class:`ObsConfig`, a config → fresh observer, an observer →
    itself (shared state, e.g. gateway and coordinator)."""
    if obs is None or obs is False:
        return None
    if obs is True:
        return FleetObserver(ObsConfig())
    if isinstance(obs, ObsConfig):
        return FleetObserver(obs)
    if isinstance(obs, FleetObserver):
        return obs
    raise TypeError(f"obs must be None/bool/ObsConfig/FleetObserver, "
                    f"got {type(obs).__name__}")
