"""Transfer-level carbon accounting.

Two metrics:

1. ``carbonscore`` — the paper's Eq. (1), implemented exactly as published:

       carbonscore = bytes / (CI × duration)

   interpreted as throughput-per-carbon ("carbon intensity per bit per
   second" in the paper's wording); HIGHER is better. Note the formula is a
   performance/carbon heuristic, not a mass of CO₂.

2. ``transfer_emissions_g`` — dimensional gCO₂eq, integrating the [14]
   power models over the transfer (end systems + per-hop device shares ×
   local CI). This is the §5 "future work" the framework completes, and
   what the scheduler actually minimizes under SLA.

``TransferLedger`` samples both live during a transfer (§3.4: "track both
numbers over the duration of the entire file transfer").

``transfer_emissions_g`` is served by the vectorized CarbonField prefix-sum
integral; ``transfer_emissions_g_batch`` scores many start times in one
pass, and ``transfer_emissions_g_reference`` keeps the scalar seed loop as
the equivalence-test oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.core.carbon.energy import HostPowerModel, hop_power_w
from repro_torch.core.carbon.path import NetworkPath

if TYPE_CHECKING:                      # avoid import cycle at runtime
    from repro_torch.core.carbon.field import CarbonField


def carbonscore(bytes_moved: float, avg_ci: float, duration_s: float) -> float:
    """Eq. (1). Guards zero CI/duration (dead transfer => score 0)."""
    if avg_ci <= 0 or duration_s <= 0:
        return 0.0
    return bytes_moved / (avg_ci * duration_s)


def transfer_emissions_g(path: NetworkPath, sender: HostPowerModel,
                         receiver: HostPowerModel, bytes_moved: float,
                         t0: float, throughput_gbps: float, *,
                         parallelism: int = 1, concurrency: int = 1,
                         dt_s: float = 60.0,
                         field: Optional["CarbonField"] = None) -> float:
    """gCO₂eq for moving ``bytes_moved`` along ``path`` starting at t0.

    Fast path: delegates to the shared :class:`CarbonField`'s prefix-sum
    integral (one vectorized pass instead of a per-minute Python loop).
    ``transfer_emissions_g_reference`` keeps the original scalar loop as the
    oracle the equivalence tests compare against.
    """
    from repro_torch.core.carbon.field import default_field
    f = field or default_field()
    out = f.transfer_emissions_g(path, sender, receiver, bytes_moved,
                                 t0, throughput_gbps,
                                 parallelism=parallelism,
                                 concurrency=concurrency, dt_s=dt_s)
    return float(out[0])


def transfer_emissions_g_batch(path: NetworkPath, sender: HostPowerModel,
                               receiver: HostPowerModel, bytes_moved: float,
                               t0s, throughput_gbps: float, *,
                               parallelism: int = 1, concurrency: int = 1,
                               dt_s: float = 60.0,
                               field: Optional["CarbonField"] = None
                               ) -> np.ndarray:
    """Emissions for every candidate start time in ``t0s`` at once (the
    planner's slot scan): one cumulative-sum pass over a shared dt_s grid."""
    from repro_torch.core.carbon.field import default_field
    f = field or default_field()
    return f.transfer_emissions_g(path, sender, receiver, bytes_moved,
                                  t0s, throughput_gbps,
                                  parallelism=parallelism,
                                  concurrency=concurrency, dt_s=dt_s)


def transfer_emissions_g_reference(path: NetworkPath, sender: HostPowerModel,
                                   receiver: HostPowerModel,
                                   bytes_moved: float, t0: float,
                                   throughput_gbps: float, *,
                                   parallelism: int = 1, concurrency: int = 1,
                                   dt_s: float = 60.0) -> float:
    """Scalar reference oracle: per-step Python-loop integral (the seed
    implementation, kept verbatim for equivalence testing)."""
    if throughput_gbps <= 0:
        return float("inf")
    duration_s = bytes_moved * 8.0 / (throughput_gbps * 1e9)
    g = 0.0
    t, remaining = t0, duration_s
    p_send = sender.transfer_power_w(throughput_gbps,
                                     parallelism=parallelism,
                                     concurrency=concurrency)
    p_recv = receiver.transfer_power_w(throughput_gbps,
                                       parallelism=parallelism,
                                       concurrency=concurrency)
    while remaining > 0:
        step = min(dt_s, remaining)
        # end systems at their local CI (first/last hop zones)
        ci_src = path.hops[0].ci(t)
        ci_dst = path.hops[-1].ci(t)
        g += p_send * ci_src * step / 3.6e6   # W·s × g/kWh → g
        g += p_recv * ci_dst * step / 3.6e6
        # intermediate devices at their own regional CI
        for hop in path.hops[1:-1]:
            g += (hop_power_w(hop.info.org, throughput_gbps)
                  * hop.ci(t) * step / 3.6e6)
        t += step
        remaining -= step
    return g


@dataclasses.dataclass
class LedgerSample:
    t: float
    bytes_total: float
    ci: float
    throughput_gbps: float


@dataclasses.dataclass
class TransferLedger:
    """Live per-transfer accounting (paper §3.4)."""
    job_uuid: str
    samples: List[LedgerSample] = dataclasses.field(default_factory=list)

    def record(self, t: float, bytes_total: float, ci: float,
               throughput_gbps: float) -> None:
        self.samples.append(LedgerSample(t, bytes_total, ci, throughput_gbps))

    @property
    def bytes_moved(self) -> float:
        return self.samples[-1].bytes_total if self.samples else 0.0

    @property
    def duration_s(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        return self.samples[-1].t - self.samples[0].t

    @property
    def avg_ci(self) -> float:
        if not self.samples:
            return 0.0
        return sum(s.ci for s in self.samples) / len(self.samples)

    def score(self) -> float:
        return carbonscore(self.bytes_moved, self.avg_ci, self.duration_s)
