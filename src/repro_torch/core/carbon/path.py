"""Network-path discovery and per-hop carbon intensity [paper §3.2–3.3].

``discover_path`` plays traceroute's role over a declarative route registry
(a TPU-fleet WAN is single-operator: routes are known, not probed — see
DESIGN.md §2). A ``NetworkPath`` geolocates every hop and exposes the
hop-by-hop and aggregate carbon intensity that Fig. 2 visualizes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon.geo import IPInfo, geolocate, haversine_km
from repro_torch.core.carbon.intensity import calibrated_ci


@dataclasses.dataclass(frozen=True)
class Hop:
    ip: str
    info: IPInfo
    rtt_ms: float

    @property
    def zone(self) -> str:
        return self.info.zone

    def ci(self, t: float) -> float:
        """Hop CI = regional CI plus a small per-device band (Fig 2 shows
        distinct boxes per IP within one region — sub-metering differences)."""
        import hashlib
        h = hashlib.blake2b(f"{self.ip}:{int(t // 3600)}".encode(),
                            digest_size=8).digest()
        u = int.from_bytes(h, "big") / 2**64 - 0.5
        base = hashlib.blake2b(self.ip.encode(), digest_size=8).digest()
        ub = int.from_bytes(base, "big") / 2**64 - 0.5
        return calibrated_ci(self.zone, t) * (1.0 + 0.02 * ub + 0.005 * u)


@dataclasses.dataclass(frozen=True)
class NetworkPath:
    src: str
    dst: str
    hops: Tuple[Hop, ...]          # includes both end systems

    @property
    def n_hops(self) -> int:
        return len(self.hops)

    def hop_cis(self, t: float) -> List[float]:
        return [h.ci(t) for h in self.hops]

    def ci(self, t: float) -> float:
        """Average carbon intensity over the full path at time t (§3.4).
        Uses the regional (zone) values: the per-device band in Hop.ci is
        sub-metering noise (Fig 2 box widths), not signal — and this keeps
        the UC→TACC path average pinned to the published Fig 3 extremes."""
        tot = sum(calibrated_ci(h.zone, t) for h in self.hops)
        return tot / len(self.hops)

    def hourly_ci(self, t0: float, hours: int) -> List[float]:
        return [self.ci(t0 + h * 3600.0) for h in range(hours)]

    def distance_km(self) -> float:
        d = 0.0
        for a, b in zip(self.hops, self.hops[1:]):
            d += haversine_km((a.info.lat, a.info.lon),
                              (b.info.lat, b.info.lon))
        return d


# --- route registry ---------------------------------------------------------
# endpoint name -> NIC address
ENDPOINTS: Dict[str, str] = {
    "uc": "192.5.87.1",            # Chameleon UC (Skylake, Table 2)
    "tacc": "129.114.0.1",         # Chameleon TACC (Cascade Lake, Table 2)
    "m1": "128.205.1.1",           # DIDCLab Apple M1 (Table 2)
    "site_ca": "203.0.113.10",
    "site_or": "203.0.113.20",
    "site_ne": "203.0.113.30",
    "site_qc": "203.0.113.40",
    "site_de": "203.0.113.50",
}

# (src, dst) -> intermediate hop IPs (Fig. 2: UC→TACC crosses MISO → SPP →
# ERCOT; Fig. 5: M1→TACC is the shorter NYISO→ERCOT path with fewer hops)
ROUTES: Dict[Tuple[str, str], Sequence[str]] = {
    ("uc", "tacc"): ("192.5.87.254", "198.51.100.11", "198.51.100.22",
                     "198.51.100.23", "198.51.100.31", "129.114.0.50"),
    ("m1", "tacc"): ("128.205.1.2", "198.51.100.41", "198.51.100.31",
                     "129.114.0.50"),
    ("site_ca", "site_or"): ("198.51.100.22",),
    ("site_ca", "tacc"): ("198.51.100.23", "198.51.100.31"),
    ("site_or", "tacc"): ("198.51.100.22", "198.51.100.23", "198.51.100.31"),
    ("site_ne", "tacc"): ("198.51.100.23", "198.51.100.31"),
    ("site_qc", "tacc"): ("198.51.100.41", "198.51.100.31"),
    ("site_de", "tacc"): ("198.51.100.41", "198.51.100.31"),
    ("site_qc", "site_de"): ("198.51.100.41",),
}


def _reverse(key: Tuple[str, str]) -> Optional[Sequence[str]]:
    rev = ROUTES.get((key[1], key[0]))
    return tuple(reversed(rev)) if rev is not None else None


# Pluggable route resolution: a provider maps (src, dst) endpoint names to
# an intermediate-hop IP tuple, or None to decline. The zone lattice
# (core/carbon/lattice.py) resolves its O(zones²) cell-pair routes through
# one provider closure instead of materializing them all in ROUTES; the
# static registry above still wins for the named testbed pairs.
RouteProvider = Callable[[str, str], Optional[Sequence[str]]]
ROUTE_PROVIDERS: List[RouteProvider] = []


def register_route_provider(provider: RouteProvider) -> None:
    """Install a route provider (idempotent per callable identity). Clears
    the ``discover_path`` memo: pairs previously resolved through the
    default-core fallback must re-resolve through the new provider."""
    if provider not in ROUTE_PROVIDERS:
        ROUTE_PROVIDERS.append(provider)
        discover_path.cache_clear()


def register_endpoints(endpoints: Dict[str, str]) -> None:
    """Bulk-extend the endpoint registry (idempotent for identical entries;
    conflicting re-registration raises)."""
    for name, ip in endpoints.items():
        prev = ENDPOINTS.get(name)
        if prev is not None and prev != ip:
            raise ValueError(f"endpoint {name!r} already registered at "
                             f"{prev!r}")
        ENDPOINTS[name] = ip


@functools.lru_cache(maxsize=None)
def discover_path(src: str, dst: str, *, base_rtt_ms: float = 0.4
                  ) -> NetworkPath:
    """Traceroute stand-in: resolve the hop list for (src, dst) and geolocate
    every hop. RTT grows with great-circle distance (~1 ms per 100 km).

    Memoized: the route registry is static, ``NetworkPath``/``Hop`` are
    frozen, and the planner's grid scan asks for the same handful of paths
    thousands of times per plan."""
    if src == dst:
        ip = ENDPOINTS[src]
        h = Hop(ip, geolocate(ip), base_rtt_ms)
        return NetworkPath(src, dst, (h, h))
    mids = ROUTES.get((src, dst))
    if mids is None:
        mids = _reverse((src, dst))
    if mids is None:
        for provider in ROUTE_PROVIDERS:
            mids = provider(src, dst)
            if mids is not None:
                break
    if mids is None:
        # default: route through the Dallas I2 core
        mids = ("198.51.100.22", "198.51.100.31")
    ips = [ENDPOINTS[src], *mids, ENDPOINTS[dst]]
    hops: List[Hop] = []
    prev: Optional[IPInfo] = None
    rtt = base_rtt_ms
    for ip in ips:
        info = geolocate(ip)
        if prev is not None:
            rtt += haversine_km((prev.lat, prev.lon),
                                (info.lat, info.lon)) / 100.0
        hops.append(Hop(ip, info, round(rtt, 3)))
        prev = info
    return NetworkPath(src, dst, tuple(hops))


def path_ci(src: str, dst: str, t: float) -> float:
    return discover_path(src, dst).ci(t)
