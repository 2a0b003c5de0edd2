"""Bandwidth prediction from historical logs [paper §3.4: "This prediction
would take into account the previously viewed throughput of jobs given the
same file source and destination as well as the application parameters"].

Base capacity comes from the link registry; application parameters
(parallelism/concurrency, per [60]) follow a diminishing-returns law; the
model then learns a per-(src,dst) correction from observed samples (EWMA),
exactly the "historical log" loop of [54].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

# physical path capacity between endpoint pairs (Gbps); Table 2 NICs bound
# the testbed nodes, site links bound the cluster sites.
LINK_GBPS: Dict[Tuple[str, str], float] = {
    ("uc", "tacc"): 10.0,
    ("m1", "tacc"): 1.2,
    ("site_ca", "tacc"): 100.0,
    ("site_or", "tacc"): 100.0,
    ("site_ne", "tacc"): 100.0,
    ("site_qc", "tacc"): 40.0,
    ("site_de", "tacc"): 25.0,
    ("site_ca", "site_or"): 200.0,
    ("site_qc", "site_de"): 25.0,
}
DEFAULT_GBPS = 10.0

# Pluggable capacity resolution for endpoint families too large to
# enumerate pairwise (the zone lattice's O(zones²) cell pairs): a provider
# maps (src, dst) to Gbps or None to decline. The static registry wins,
# then providers in registration order, then DEFAULT_GBPS.
CapacityProvider = Callable[[str, str], Optional[float]]
CAPACITY_PROVIDERS: List[CapacityProvider] = []


def register_capacity_provider(provider: CapacityProvider) -> None:
    """Install a link-capacity provider (idempotent per callable)."""
    if provider not in CAPACITY_PROVIDERS:
        CAPACITY_PROVIDERS.append(provider)


def base_capacity(src: str, dst: str) -> float:
    cap = LINK_GBPS.get((src, dst)) or LINK_GBPS.get((dst, src))
    if cap is not None:
        return cap
    for provider in CAPACITY_PROVIDERS:
        cap = provider(src, dst)
        if cap is not None:
            return cap
    return DEFAULT_GBPS


def stream_efficiency(parallelism: int, concurrency: int) -> float:
    """Diminishing returns in the stream count (cf. [60], [62]): one stream
    reaches ~45% of capacity; ~8 streams saturate."""
    streams = max(parallelism * concurrency, 1)
    return 1.0 - 0.55 * math.exp(-(streams - 1) / 3.0)


@dataclasses.dataclass
class ThroughputModel:
    ewma_alpha: float = 0.3
    correction: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)
    history: List[Tuple[str, str, int, int, float]] = dataclasses.field(
        default_factory=list)

    def predict(self, src: str, dst: str, parallelism: int = 4,
                concurrency: int = 2) -> float:
        cap = base_capacity(src, dst)
        eff = stream_efficiency(parallelism, concurrency)
        corr = self.correction.get((src, dst), 1.0)
        return max(cap * eff * corr, 1e-3)

    def observe(self, src: str, dst: str, parallelism: int,
                concurrency: int, achieved_gbps: float) -> None:
        cap = base_capacity(src, dst) * stream_efficiency(parallelism,
                                                          concurrency)
        ratio = achieved_gbps / max(cap, 1e-9)
        prev = self.correction.get((src, dst), 1.0)
        self.correction[(src, dst)] = ((1 - self.ewma_alpha) * prev
                                       + self.ewma_alpha * ratio)
        self.history.append((src, dst, parallelism, concurrency,
                             achieved_gbps))
