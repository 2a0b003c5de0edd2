"""Shifting in time [paper §4.1]: same source, destination and FTN — only
the start time moves, within a deadline window. On the paper's UC→TACC
trace this alone is worth ≈1.91× (min 255.714 vs max 488.6 gCO₂/kWh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.carbon.path import NetworkPath


@dataclasses.dataclass(frozen=True)
class TimeShiftDecision:
    start_t: float
    expected_ci: float
    expected_finish_t: float
    baseline_ci: float          # CI if started immediately
    savings_factor: float       # baseline / chosen


def expected_transfer_ci(path: NetworkPath, t0: float, duration_s: float,
                         step_s: float = 900.0,
                         ci_fn: Optional[Callable[[float], float]] = None
                         ) -> float:
    """Mean path CI over [t0, t0+duration] (the transfer samples CI live)."""
    f = ci_fn or path.ci
    if duration_s <= 0:
        return f(t0)
    n = max(int(duration_s // step_s), 1)
    tot = sum(f(t0 + (i + 0.5) * duration_s / n) for i in range(n))
    return tot / n


def best_start_time(path: NetworkPath, *, now: float, deadline: float,
                    predicted_duration_s: float, slot_s: float = 3600.0,
                    ci_fn: Optional[Callable[[float], float]] = None,
                    field=None) -> TimeShiftDecision:
    """Scan candidate start slots in [now, deadline - duration] and pick the
    lowest expected average CI. ``ci_fn`` lets callers pass a *forecast*
    instead of the oracle trace (§5); without one, the whole slot scan is a
    single vectorized query against the shared CarbonField."""
    latest = deadline - predicted_duration_s
    if latest < now:
        # cannot fit before the deadline: start immediately (SLA first)
        ci0 = expected_transfer_ci(path, now, predicted_duration_s,
                                   ci_fn=ci_fn)
        return TimeShiftDecision(now, ci0, now + predicted_duration_s,
                                 ci0, 1.0)
    if ci_fn is None:
        from repro_torch.core.carbon.field import default_field
        f = field or default_field()
        ts = now + slot_s * np.arange(int((latest + 1e-9 - now) // slot_s)
                                      + 1)
        cis = f.expected_transfer_ci(path, ts, predicted_duration_s)
        i = int(np.argmin(cis))        # first minimum, like the scalar scan
        best_t, best_ci = float(ts[i]), float(cis[i])
        baseline = float(cis[0])       # ts[0] == now
        return TimeShiftDecision(
            start_t=best_t, expected_ci=best_ci,
            expected_finish_t=best_t + predicted_duration_s,
            baseline_ci=baseline,
            savings_factor=(baseline / best_ci) if best_ci > 0 else 1.0)
    best_t, best_ci = now, None
    t = now
    while t <= latest + 1e-9:
        ci = expected_transfer_ci(path, t, predicted_duration_s, ci_fn=ci_fn)
        if best_ci is None or ci < best_ci:
            best_t, best_ci = t, ci
        t += slot_s
    baseline = expected_transfer_ci(path, now, predicted_duration_s,
                                    ci_fn=ci_fn)
    return TimeShiftDecision(
        start_t=best_t, expected_ci=best_ci,
        expected_finish_t=best_t + predicted_duration_s,
        baseline_ci=baseline,
        savings_factor=(baseline / best_ci) if best_ci > 0 else 1.0)
