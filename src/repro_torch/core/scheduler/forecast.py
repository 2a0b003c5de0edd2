"""Carbon-intensity forecasting (§5: carbon is 'highly stochastic'; the
scheduler must predict, not just observe).

Two forecasters over sampled history:
  * persistence — tomorrow ≈ today (the Electricity-Maps free-tier baseline)
  * harmonic — least-squares fit of mean + 24 h + 12 h harmonics; captures
    the diurnal/solar structure that drives Fig. 3's ≈2× swing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PersistenceForecaster:
    history_t: Sequence[float]
    history_ci: Sequence[float]
    period_s: float = 86400.0

    def predict(self, t: float) -> float:
        ts = np.asarray(self.history_t)
        target = t
        if target > ts[-1]:
            # fold back by whole periods in one step (the equivalent loop
            # was O(t/period) for far-future queries): the smallest k with
            # t - k*period <= ts[-1] — an exact multiple lands ON ts[-1],
            # matching the loop's strict `>` condition
            target -= self.period_s * math.ceil(
                (target - ts[-1]) / self.period_s)
        i = int(np.argmin(np.abs(ts - target)))
        return float(self.history_ci[i])

    def predict_reference(self, t: float) -> float:
        """The seed's subtract-until loop, kept as the oracle
        :meth:`predict`'s modular fold is pinned to
        (``tests/test_scheduler.py``)."""
        ts = np.asarray(self.history_t)
        target = t
        while target > ts[-1]:
            target -= self.period_s
        i = int(np.argmin(np.abs(ts - target)))
        return float(self.history_ci[i])


@dataclasses.dataclass
class HarmonicForecaster:
    """ci(t) ≈ a0 + Σ_k [a_k cos(2πkt/T) + b_k sin(2πkt/T)], T = 24 h."""
    history_t: Sequence[float]
    history_ci: Sequence[float]
    n_harmonics: int = 2
    period_s: float = 86400.0
    _coef: np.ndarray = dataclasses.field(default=None, init=False, repr=False)

    def _design(self, ts: np.ndarray) -> np.ndarray:
        cols = [np.ones_like(ts)]
        for k in range(1, self.n_harmonics + 1):
            w = 2 * math.pi * k * ts / self.period_s
            cols.append(np.cos(w))
            cols.append(np.sin(w))
        return np.stack(cols, axis=1)

    def fit(self) -> "HarmonicForecaster":
        ts = np.asarray(self.history_t, dtype=float)
        ys = np.asarray(self.history_ci, dtype=float)
        X = self._design(ts)
        self._coef, *_ = np.linalg.lstsq(X, ys, rcond=None)
        return self

    def predict(self, t: float) -> float:
        if self._coef is None:
            self.fit()
        X = self._design(np.asarray([float(t)]))
        return float((X @ self._coef)[0])

    def rmse(self) -> float:
        if self._coef is None:
            self.fit()
        ts = np.asarray(self.history_t, dtype=float)
        ys = np.asarray(self.history_ci, dtype=float)
        pred = self._design(ts) @ self._coef
        return float(np.sqrt(np.mean((pred - ys) ** 2)))


def make_forecaster(kind: str, history_t, history_ci):
    if kind == "persistence":
        return PersistenceForecaster(history_t, history_ci)
    if kind == "harmonic":
        return HarmonicForecaster(history_t, history_ci).fit()
    raise ValueError(kind)
