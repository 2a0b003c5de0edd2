"""Geolocation of hops: the offline stand-in for IP-API [paper §3.3].

A deterministic registry maps the framework's address space (site routers,
WAN hops, host NICs) to (lat, lon, grid zone). Unknown addresses fall back
to a hash-derived location inside a declared zone, mirroring how the paper
tolerates partially-maskable traceroute results (§3.2).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class IPInfo:
    ip: str
    lat: float
    lon: float
    zone: str                 # grid region zone id (intensity.REGIONS key)
    org: str = ""
    city: str = ""


# The paper's testbed (Table 2) + the WAN between: UC (Chicago) → I2 →
# TACC (Austin), and DIDCLab Buffalo. Addresses are RFC-5737/private-style
# documentation values — the registry plays the role of the IP-API database.
IP_DB: Dict[str, IPInfo] = {i.ip: i for i in [
    # UC / Chameleon Chicago
    IPInfo("192.5.87.1",    41.790, -87.600, "US-MIDW-MISO", "UChicago",   "Chicago"),
    IPInfo("192.5.87.254",  41.789, -87.601, "US-MIDW-MISO", "UChicago",  "Chicago"),
    IPInfo("198.51.100.11", 41.878, -87.636, "US-MIDW-MISO", "StarLight", "Chicago"),
    # Internet2 backbone
    IPInfo("198.51.100.22", 39.099, -94.578, "US-CENT-SWPP", "Internet2", "Kansas City"),
    IPInfo("198.51.100.23", 35.467, -97.516, "US-CENT-SWPP", "Internet2", "Oklahoma City"),
    IPInfo("198.51.100.31", 32.776, -96.797, "US-TEX-ERCO",  "Internet2", "Dallas"),
    # TACC Austin
    IPInfo("129.114.0.1",   30.390, -97.726, "US-TEX-ERCO",  "TACC",      "Austin"),
    IPInfo("129.114.0.50",  30.390, -97.725, "US-TEX-ERCO",  "TACC",      "Austin"),
    # DIDCLab Buffalo (M1)
    IPInfo("128.205.1.1",   43.000, -78.790, "US-NY-NYIS",   "UBuffalo",  "Buffalo"),
    IPInfo("128.205.1.2",   43.001, -78.789, "US-NY-NYIS",   "UBuffalo",  "Buffalo"),
    IPInfo("198.51.100.41", 40.712, -74.006, "US-NY-NYIS",   "I2-NYC",    "New York"),
    # extra US sites for the multi-site cluster topology
    IPInfo("203.0.113.10",  37.240, -121.780, "US-CAL-CISO", "SiteCA",    "San Jose"),
    IPInfo("203.0.113.20",  45.600, -121.180, "US-NW-BPAT",  "SiteOR",    "The Dalles"),
    IPInfo("203.0.113.30",  41.260, -95.860,  "US-CENT-SWPP","SiteNE",    "Omaha"),
    IPInfo("203.0.113.40",  45.500, -73.570,  "CA-QC",       "SiteQC",    "Montreal"),
    IPInfo("203.0.113.50",  50.110,   8.680,  "DE",          "SiteDE",    "Frankfurt"),
]}


def geolocate(ip: str, default_zone: str = "US-MIDW-MISO") -> IPInfo:
    """IP → (lat, lon, zone). Deterministic fallback for unknown addresses."""
    if ip in IP_DB:
        return IP_DB[ip]
    h = hashlib.blake2b(ip.encode(), digest_size=8).digest()
    u1 = int.from_bytes(h[:4], "big") / 2**32
    u2 = int.from_bytes(h[4:], "big") / 2**32
    return IPInfo(ip, 25.0 + 24.0 * u1, -124.0 + 57.0 * u2, default_zone,
                  org="unknown")


def haversine_km(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    import math
    lat1, lon1, lat2, lon2 = map(math.radians, (a[0], a[1], b[0], b[1]))
    dlat, dlon = lat2 - lat1, lon2 - lon1
    h = (math.sin(dlat / 2) ** 2
         + math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2)
    return 2 * 6371.0 * math.asin(math.sqrt(h))


# --- lattice topology helpers ----------------------------------------------
# The mesoscale zone lattice (core/carbon/lattice.py) lays hundreds of zones
# on a regular (row, col) grid over a geographic bounding box; hop graphs
# between cells are haversine-derived (RTT and hub selection both follow
# great-circle distance, the same rule discover_path applies to the named
# testbed routes).

def lattice_latlon(rows: int, cols: int,
                   lat0: float, lat1: float,
                   lon0: float, lon1: float) -> Dict[Tuple[int, int],
                                                     Tuple[float, float]]:
    """Cell (r, c) -> (lat, lon): rows span [lat1, lat0] north→south and
    cols span [lon0, lon1] west→east, cells sitting at box centers so two
    lattices over the same bbox with different resolutions never collide
    exactly with each other's grid lines."""
    if rows < 1 or cols < 1:
        raise ValueError("lattice needs rows >= 1 and cols >= 1")
    out: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for r in range(rows):
        for c in range(cols):
            lat = lat1 + (lat0 - lat1) * (r + 0.5) / rows
            lon = lon0 + (lon1 - lon0) * (c + 0.5) / cols
            out[(r, c)] = (round(lat, 6), round(lon, 6))
    return out


def nearest_of(point: Tuple[float, float],
               candidates: Dict[str, Tuple[float, float]]) -> str:
    """The candidate key geographically nearest to ``point`` (haversine;
    deterministic tie-break on the key). How an edge cell picks its metro
    hub and a metro hub its core hub."""
    if not candidates:
        raise ValueError("no candidates")
    return min(candidates,
               key=lambda k: (haversine_km(point, candidates[k]), k))


def register_ips(infos: Dict[str, IPInfo]) -> None:
    """Bulk-extend the IP registry (idempotent for identical records;
    conflicting re-registration raises — a silently re-homed hop would
    shift every cached path CI built through it)."""
    for ip, info in infos.items():
        prev = IP_DB.get(ip)
        if prev is not None and prev != info:
            raise ValueError(f"ip {ip!r} already registered differently")
        IP_DB[ip] = info
