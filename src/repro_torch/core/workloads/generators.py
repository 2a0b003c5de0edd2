"""Seeded workload generators: arrival processes x size laws -> job streams.

Everything here is a *deterministic iterator*: a :class:`Workload` with a
seed and a horizon always yields the same :class:`TransferJob` sequence,
draw for draw (one ``numpy`` PCG64 stream per iteration, consumed in a
fixed order), so the streaming-equivalence tests can compare a streamed
run against a ``submit_many`` run of the same materialized list, and a
bench re-run reproduces its fleet exactly.

Layer contract:

* arrival offsets are **nondecreasing** and live in ``[0, horizon_s)`` —
  the streaming gateway's watermark rule depends on it (property-tested in
  ``tests/test_torch_workloads.py``);
* generators are pure producers: no field/planner imports, so scenario
  sweeps can be materialized without warming any cache;
* composition is explicit — :func:`merge_streams` interleaves finished
  streams by submission time (stable on ties), which is how the
  "diurnal + burst day" scenarios are built.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler.planner import SLA, TransferJob


# --- arrival processes ------------------------------------------------------
class ArrivalProcess:
    """Base: yields nondecreasing arrival offsets in ``[0, horizon_s)``.

    ``times`` consumes the caller's RNG lazily; all randomness flows
    through it, so a (seed, horizon) pair pins the whole stream.
    """

    def times(self, rng: np.random.Generator,
              horizon_s: float) -> Iterator[float]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson stream: exponential interarrivals."""
    rate_per_h: float = 60.0

    def times(self, rng, horizon_s):
        mean_s = 3600.0 / self.rate_per_h
        t = rng.exponential(mean_s)
        while t < horizon_s:
            yield t
            t += rng.exponential(mean_s)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Nonhomogeneous Poisson with a diurnal rate modulation (thinning):

        lam(t) = rate_per_h * (1 + amplitude * cos(2*pi*(t - peak)/24h))

    Candidates are drawn at the envelope rate ``rate*(1+amplitude)`` and
    accepted with probability ``lam(t)/lam_max`` — the standard Lewis &
    Shedler construction, exact for any bounded rate function.
    """
    rate_per_h: float = 60.0
    amplitude: float = 0.6             # in [0, 1): peak/trough contrast
    peak_hour: float = 14.0            # local hour of the arrival peak

    def times(self, rng, horizon_s):
        lam_max = self.rate_per_h * (1.0 + self.amplitude)
        mean_s = 3600.0 / lam_max
        peak_s = self.peak_hour * 3600.0
        t = rng.exponential(mean_s)
        while t < horizon_s:
            lam = self.rate_per_h * (1.0 + self.amplitude * math.cos(
                2.0 * math.pi * (t - peak_s) / 86400.0))
            if rng.uniform() < lam / lam_max:
                yield t
            t += rng.exponential(mean_s)


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process: calm <-> burst.

    Dwell times are exponential; within a state arrivals are Poisson at
    the state's rate. Interarrivals that would cross a state switch are
    redrawn at the new rate — valid because the exponential is memoryless.
    Burstiness (index of dispersion > 1) is what makes capacity-gated
    admission and backfill interesting.
    """
    rate_calm_per_h: float = 20.0
    rate_burst_per_h: float = 400.0
    mean_calm_s: float = 3.0 * 3600.0
    mean_burst_s: float = 15.0 * 60.0

    def times(self, rng, horizon_s):
        t, burst = 0.0, False
        switch_t = rng.exponential(self.mean_calm_s)
        while t < horizon_s:
            rate = self.rate_burst_per_h if burst else self.rate_calm_per_h
            dt = rng.exponential(3600.0 / rate)
            if t + dt >= switch_t:
                t = switch_t
                burst = not burst
                switch_t = t + rng.exponential(
                    self.mean_burst_s if burst else self.mean_calm_s)
                continue               # memoryless: redraw at the new rate
            t += dt
            if t < horizon_s:
                yield t


@dataclasses.dataclass(frozen=True)
class ReplayArrivals(ArrivalProcess):
    """Trace replay: a recorded offset sequence, clipped to the horizon."""
    offsets: Tuple[float, ...]

    def __post_init__(self):
        if any(b < a for a, b in zip(self.offsets, self.offsets[1:])):
            raise ValueError("replay offsets must be nondecreasing")
        if self.offsets and self.offsets[0] < 0:
            raise ValueError("replay offsets must be >= 0")

    def times(self, rng, horizon_s):
        for t in self.offsets:
            if t >= horizon_s:
                break
            yield t


# --- size laws --------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SizeLaw:
    """Base: draws a transfer size in GB, clamped to [min_gb, cap_gb]."""
    min_gb: float = 1.0
    cap_gb: float = 4000.0

    def _draw_gb(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def sample_gb(self, rng: np.random.Generator) -> float:
        return float(min(max(self._draw_gb(rng), self.min_gb), self.cap_gb))


@dataclasses.dataclass(frozen=True)
class ParetoSizes(SizeLaw):
    """Heavy-tail Pareto-I sizes: scale_gb * (1 + Lomax(alpha)). With
    alpha <= 2 the variance is infinite before the cap — the classic
    elephant/mice mix of wide-area transfer traces."""
    alpha: float = 1.3
    scale_gb: float = 50.0

    def _draw_gb(self, rng):
        return self.scale_gb * (1.0 + rng.pareto(self.alpha))


@dataclasses.dataclass(frozen=True)
class LognormalSizes(SizeLaw):
    median_gb: float = 200.0
    sigma: float = 1.0

    def _draw_gb(self, rng):
        return float(self.median_gb * np.exp(rng.normal(0.0, self.sigma)))


@dataclasses.dataclass(frozen=True)
class UniformSizes(SizeLaw):
    lo_gb: float = 50.0
    hi_gb: float = 500.0

    def _draw_gb(self, rng):
        return rng.uniform(self.lo_gb, self.hi_gb)


@dataclasses.dataclass(frozen=True)
class FixedSizes(SizeLaw):
    gb: float = 200.0

    def _draw_gb(self, rng):
        return self.gb


# --- the assembler ----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Workload:
    """Arrival process x size law x SLA mix -> a TransferJob stream.

    ``jobs(seed, t0, horizon_s)`` is the deterministic iterator: one PCG64
    stream seeded once, drawn in a fixed per-job order (arrival draw(s),
    then size, replica set, deadline, w_perf), so equal (seed, horizon)
    always reproduce the same fleet.
    """
    name: str
    arrivals: ArrivalProcess
    sizes: SizeLaw
    replica_sets: Tuple[Tuple[str, ...], ...] = (("uc",),)
    dst: str = "tacc"
    deadline_h: Tuple[float, float] = (4.0, 12.0)
    w_perf_choices: Tuple[float, ...] = (0.0, 0.2)
    parallelism: int = 4
    concurrency: int = 2
    pipelining: int = 4

    def jobs(self, seed: int, t0: float,
             horizon_s: float) -> Iterator[TransferJob]:
        rng = np.random.default_rng(np.random.PCG64(seed))
        for i, off in enumerate(self.arrivals.times(rng, horizon_s)):
            size_gb = self.sizes.sample_gb(rng)
            reps = self.replica_sets[int(rng.integers(
                len(self.replica_sets)))]
            dl_h = float(rng.uniform(*self.deadline_h))
            w_perf = self.w_perf_choices[int(rng.integers(
                len(self.w_perf_choices)))]
            yield TransferJob(
                uuid=f"{self.name}-{i:05d}", size_bytes=size_gb * 1e9,
                replicas=reps, dst=self.dst,
                sla=SLA(deadline_s=dl_h * 3600.0, w_perf=w_perf),
                submitted_t=t0 + off, parallelism=self.parallelism,
                concurrency=self.concurrency, pipelining=self.pipelining)


def merge_streams(*streams: Iterable[TransferJob]) -> Iterator[TransferJob]:
    """Interleave job streams by submission time (stable on exact ties:
    earlier stream first — heapq.merge semantics), preserving the
    nondecreasing-arrival contract the gateway depends on."""
    return heapq.merge(*streams, key=lambda j: j.submitted_t)


def as_stream(jobs: Sequence[TransferJob]) -> Iterator[TransferJob]:
    """A materialized job list as an arrival stream: sorted by submission
    time (stable, so same-instant jobs keep their list order — exactly the
    order ``submit_many`` would admit them)."""
    return iter(sorted(jobs, key=lambda j: j.submitted_t))
