"""Overlay network of FTNs [paper §4.3]: choose WHICH node executes the
transfer, and migrate mid-job when a carbon threshold is exceeded.

Fig. 5's finding: the Buffalo M1 FTN beats the UC FTN for downloads from
TACC — shorter path (6 vs 8 hops) through a cleaner grid (NYISO vs MISO).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon.energy import HOST_PROFILES, HostPowerModel
from repro_torch.core.carbon.path import NetworkPath, discover_path


@dataclasses.dataclass(frozen=True)
class FTN:
    """A file-transfer node in the overlay."""
    name: str                  # endpoint name (path registry key)
    profile: str               # HOST_PROFILES key
    max_gbps: float

    @property
    def power_model(self) -> HostPowerModel:
        return HOST_PROFILES[self.profile]


@dataclasses.dataclass(frozen=True)
class FTNChoice:
    ftn: FTN
    path: NetworkPath
    expected_ci: float
    ranking: Tuple[Tuple[str, float], ...]


def best_ftn(ftns: Sequence[FTN], source: str, t: float, *,
             ci_fn: Optional[Callable[[NetworkPath, float], float]] = None,
             field=None) -> FTNChoice:
    """Pick the FTN whose end-to-end path from ``source`` is greenest (the
    FTN is the receiving end system — its region counts, per Fig. 1).
    Without a forecast hook the CI reads go through the shared CarbonField,
    so repeated calls (migration polling) hit the hashed-noise cache."""
    if ci_fn is None:
        from repro_torch.core.carbon.field import default_field
        fld = field or default_field()
        ci_fn = lambda p, tt: float(fld.path_ci(p, tt))  # noqa: E731
    scored: List[Tuple[FTN, NetworkPath, float]] = []
    for f in ftns:
        p = discover_path(source, f.name)
        ci = ci_fn(p, t)
        scored.append((f, p, ci))
    scored.sort(key=lambda x: x[2])
    f, p, ci = scored[0]
    return FTNChoice(ftn=f, path=p, expected_ci=ci,
                     ranking=tuple((s[0].name, s[2]) for s in scored))


@dataclasses.dataclass
class MigrationEvent:
    t: float
    from_ftn: str
    to_ftn: str
    bytes_done: float
    ci_at_migration: float


@dataclasses.dataclass
class OverlayScheduler:
    """Threshold-triggered FTN migration (§4.3): when the measured CI of the
    active path exceeds ``threshold``, re-plan; if another FTN is at least
    ``hysteresis`` better, hand the remaining bytes over (the transfer
    engine checkpoints its offsets — see core.transfer.migrate)."""
    ftns: Sequence[FTN]
    threshold: float = 400.0
    hysteresis: float = 0.9            # new CI must be < hysteresis * current
    events: List[MigrationEvent] = dataclasses.field(default_factory=list)

    def maybe_migrate(self, *, source: str, current: FTN, t: float,
                      current_ci: float, bytes_done: float,
                      ci_fn: Optional[Callable[[NetworkPath, float],
                                               float]] = None
                      ) -> Optional[FTNChoice]:
        """``ci_fn`` lets the control plane rank alternatives under the
        *measured* (drifted) CI rather than the forecast trace, so a shock
        that trips the threshold does not hand the job to an equally
        shocked FTN."""
        if current_ci <= self.threshold:
            return None
        choice = best_ftn(self.ftns, source, t, ci_fn=ci_fn)
        if (choice.ftn.name != current.name
                and choice.expected_ci < self.hysteresis * current_ci):
            self.events.append(MigrationEvent(
                t=t, from_ftn=current.name, to_ftn=choice.ftn.name,
                bytes_done=bytes_done, ci_at_migration=current_ci))
            return choice
        return None
