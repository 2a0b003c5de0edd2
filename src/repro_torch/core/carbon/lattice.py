"""Mesoscale zone lattice: hundreds of zones on a geographic grid.

The paper prices its shifts over a handful of balancing authorities, but
mesoscale carbon-intensity variation *within* a region is large enough to
change placement decisions (CarbonEdge), and pricing the network path at
that fan-out is exactly what this repo's per-hop model is for. A
:class:`ZoneLattice` lays ``rows × cols`` zones over a bounding box and
wires the whole existing stack to them:

* every cell gets a deterministic :class:`GridRegion` trace (blake2b-derived
  parameters, same diurnal/solar/weekend/noise formula as the named zones,
  so ``CarbonField.zone_ci``, the torch lattice and the CUDA planner
  kernels already evaluate it),
* cells are tiered **edge / metro / core**: metro hubs sit at block
  centers, a strided subset of them are core hubs, and each cell's hub
  assignment is haversine-nearest (``geo.nearest_of``) — distinct
  :mod:`energy` power curves (``lat_edge`` / ``lat_metro`` / ``lat_core``
  host profiles, ``LatMetro``/``LatCore`` hop classes) flow through
  ``device_weight_fn`` unchanged,
* hop graphs are edge → metro → core → metro → edge over per-cell router
  IPs, resolved lazily through a :func:`path.register_route_provider`
  closure (O(zones²) pairs never materialize), with RTTs haversine-derived
  by ``discover_path``; a bridge through the I2 core connects lattice
  cells to the named testbed endpoints,
* link capacities come from a :func:`throughput.register_capacity_provider`
  closure (min of the endpoint tiers' line rates).

``install()`` is idempotent and records itself with
``field.register_field_setup`` so a frozen field thawed in a spawn worker
replays the registration before any query resolves.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon import geo
from repro_torch.core.carbon.energy import register_endpoint_profiles
from repro_torch.core.carbon.field import register_field_setup
from repro_torch.core.carbon.geo import IPInfo, lattice_latlon, nearest_of
from repro_torch.core.carbon.intensity import GridRegion, register_region
from repro_torch.core.carbon.path import (discover_path, register_endpoints,
                                          register_route_provider)
from repro_torch.core.transfer.throughput import register_capacity_provider

Cell = Tuple[int, int]

# line rate each tier's access link runs at (Gbps); a pair's capacity is
# the min of its endpoint tiers, so edge→core is edge-bound
TIER_GBPS: Dict[str, float] = {"edge": 2.5, "metro": 25.0, "core": 100.0}
TIER_PROFILES: Dict[str, str] = {"edge": "lat_edge", "metro": "lat_metro",
                                 "core": "lat_core"}

# the I2 core pair that bridges lattice traffic to the named testbed
# endpoints (Kansas City / Dallas, see geo.IP_DB)
_BRIDGE_IPS = ("198.51.100.22", "198.51.100.31")


class ZoneLattice:
    """A rows × cols zone grid with tiered cells and derived hop graphs.

    Everything is a pure function of the constructor arguments (the
    ``spec``): zone parameters, tiers, hub assignments, IPs and routes all
    derive from blake2b hashes and haversine geometry — two processes
    building the same spec agree bit-for-bit, which is what lets a frozen
    field ship just the spec across a spawn boundary.
    """

    def __init__(self, rows: int, cols: int, tag: str = "MESO", *,
                 lat_s: float = 36.0, lat_n: float = 45.0,
                 lon_w: float = -104.0, lon_e: float = -84.0,
                 metro_block: int = 4, core_stride: int = 2,
                 seed: str = "v1"):
        if rows < 1 or cols < 1:
            raise ValueError("lattice needs rows >= 1 and cols >= 1")
        if not tag.isalnum():
            raise ValueError(f"tag must be alphanumeric, got {tag!r}")
        if metro_block < 1 or core_stride < 1:
            raise ValueError("metro_block and core_stride must be >= 1")
        self.rows, self.cols, self.tag = int(rows), int(cols), str(tag)
        self.bbox = (float(lat_s), float(lat_n), float(lon_w), float(lon_e))
        self.metro_block, self.core_stride = int(metro_block), int(core_stride)
        self.seed = str(seed)
        self.spec: Tuple = (self.rows, self.cols, self.tag, *self.bbox,
                            self.metro_block, self.core_stride, self.seed)
        if rows > 250 or cols > 62:
            raise ValueError("lattice exceeds the IP allocation plan "
                             "(rows <= 250, cols <= 62)")

        self.cells: List[Cell] = [(r, c) for r in range(rows)
                                  for c in range(cols)]
        self.latlon: Dict[Cell, Tuple[float, float]] = lattice_latlon(
            rows, cols, lat_s, lat_n, lon_w, lon_e)

        # --- tiers: block-center metro hubs, strided core hubs ------------
        b = self.metro_block
        hubs = {(min(br * b + b // 2, rows - 1),
                 min(bc * b + b // 2, cols - 1)): (br, bc)
                for br in range((rows + b - 1) // b)
                for bc in range((cols + b - 1) // b)}
        self.metro_hubs: List[Cell] = sorted(hubs)
        self.core_hubs: List[Cell] = sorted(
            h for h, (br, bc) in hubs.items()
            if br % self.core_stride == 0 and bc % self.core_stride == 0)
        # haversine-nearest hub assignment (geo.nearest_of keys by str)
        metro_pts = {self._ckey(h): self.latlon[h] for h in self.metro_hubs}
        core_pts = {self._ckey(h): self.latlon[h] for h in self.core_hubs}
        self.metro_of: Dict[Cell, Cell] = {
            cell: self._cunkey(nearest_of(self.latlon[cell], metro_pts))
            for cell in self.cells}
        self.core_of: Dict[Cell, Cell] = {
            hub: self._cunkey(nearest_of(self.latlon[hub], core_pts))
            for hub in self.metro_hubs}

        # --- names and addresses ------------------------------------------
        d = hashlib.blake2b(f"lat-octet:{self.tag}".encode(),
                            digest_size=2).digest()
        self._octet = 16 + int.from_bytes(d, "big") % 200
        self._endpoint_of: Dict[Cell, str] = {
            cell: f"lat_{self.tag.lower()}_r{cell[0]:02d}c{cell[1]:02d}"
            for cell in self.cells}
        self._cell_of: Dict[str, Cell] = {
            ep: cell for cell, ep in self._endpoint_of.items()}
        self.regions: Dict[Cell, GridRegion] = {
            cell: self._make_region(cell) for cell in self.cells}
        self._installed = False

    # --- naming helpers ----------------------------------------------------
    @staticmethod
    def _ckey(cell: Cell) -> str:
        return f"{cell[0]:03d},{cell[1]:03d}"

    @staticmethod
    def _cunkey(key: str) -> Cell:
        r, c = key.split(",")
        return (int(r), int(c))

    def zone_id(self, cell: Cell) -> str:
        return f"LAT-{self.tag}-R{cell[0]:02d}C{cell[1]:02d}"

    def endpoint(self, cell: Cell) -> str:
        return self._endpoint_of[cell]

    def node_ip(self, cell: Cell) -> str:
        return f"10.{self._octet}.{cell[0]}.{cell[1] * 4 + 1}"

    def metro_ip(self, hub: Cell) -> str:
        return f"10.{self._octet}.{hub[0]}.{hub[1] * 4 + 2}"

    def core_ip(self, hub: Cell) -> str:
        return f"10.{self._octet}.{hub[0]}.{hub[1] * 4 + 3}"

    def tier(self, cell: Cell) -> str:
        if cell in self.core_of and self.core_of[cell] == cell:
            return "core"
        if cell in self.core_of:
            return "metro"
        return "edge"

    def endpoints(self, tier: Optional[str] = None) -> List[str]:
        """All cell endpoint names, optionally restricted to one tier,
        in row-major cell order."""
        return [self._endpoint_of[cell] for cell in self.cells
                if tier is None or self.tier(cell) == tier]

    @property
    def zones(self) -> List[str]:
        return [self.zone_id(cell) for cell in self.cells]

    # --- deterministic per-zone trace parameters ---------------------------
    def _u(self, cell: Cell, part: str) -> float:
        msg = f"{self.seed}:{self.tag}:{cell[0]}:{cell[1]}:{part}"
        d = hashlib.blake2b(msg.encode(), digest_size=8).digest()
        return int.from_bytes(d, "big") / 2**64

    def _make_region(self, cell: Cell) -> GridRegion:
        base = 60.0 + 540.0 * self._u(cell, "base")
        return GridRegion(
            name=f"{self.zone_id(cell)} ({self.tier(cell)})",
            zone=self.zone_id(cell),
            base_ci=round(base, 6),
            diurnal_amp=round(base * (0.08 + 0.18 * self._u(cell, "amp")), 6),
            solar_dip=round(base * 0.30 * self._u(cell, "dip"), 6),
            noise=round(base * (0.02 + 0.05 * self._u(cell, "noise")), 6),
            peak_hour=round(17.0 + 4.0 * self._u(cell, "peak"), 6))

    # --- hop graph ---------------------------------------------------------
    def route_mids(self, src: str, dst: str) -> Optional[Tuple[str, ...]]:
        """Intermediate hop IPs for a (src, dst) endpoint pair, or None if
        neither side belongs to this lattice. Within the lattice the route
        climbs edge → metro → core and descends; to a foreign endpoint it
        bridges through the nearest core hub and the I2 core."""
        a, b_ = self._cell_of.get(src), self._cell_of.get(dst)
        if a is None and b_ is None:
            return None
        if a is not None and b_ is not None:
            ma, mb = self.metro_of[a], self.metro_of[b_]
            mids: List[str] = [self.metro_ip(ma)]
            if ma != mb:
                ka, kb = self.core_of[ma], self.core_of[mb]
                mids.append(self.core_ip(ka))
                if kb != ka:
                    mids.append(self.core_ip(kb))
                mids.append(self.metro_ip(mb))
            return tuple(dict.fromkeys(mids))
        if a is not None:
            ma = self.metro_of[a]
            return tuple(dict.fromkeys(
                (self.metro_ip(ma), self.core_ip(self.core_of[ma]))
            )) + _BRIDGE_IPS
        mb = self.metro_of[b_]
        return _BRIDGE_IPS + tuple(dict.fromkeys(
            (self.core_ip(self.core_of[mb]), self.metro_ip(mb))))

    def capacity(self, src: str, dst: str) -> Optional[float]:
        """Pairwise Gbps: min of the endpoint tiers' line rates; a pair
        with a foreign side is bound by the lattice side alone."""
        tiers = [self.tier(cell) for cell in
                 (self._cell_of.get(src), self._cell_of.get(dst))
                 if cell is not None]
        if not tiers:
            return None
        return min(TIER_GBPS[t] for t in tiers)

    def tier_of_endpoint(self, name: str) -> Optional[str]:
        cell = self._cell_of.get(name)
        return None if cell is None else self.tier(cell)

    # --- registration ------------------------------------------------------
    def install(self) -> "ZoneLattice":
        """Wire this lattice into the live registries (regions, geo, path,
        energy, throughput) and record the step for spawn-worker replay.
        Idempotent; a previously-installed identical spec is returned
        as-is. Conflicting IP-octet hashes across different tags raise."""
        prev = _INSTALLED.get(self.spec)
        if prev is not None:
            return prev
        for other in _INSTALLED.values():
            if other._octet == self._octet:
                raise ValueError(
                    f"lattice tag {self.tag!r} hashes to the same IP octet "
                    f"as installed tag {other.tag!r}; pick another tag")
        infos: Dict[str, IPInfo] = {}
        profiles: Dict[str, str] = {}
        endpoints: Dict[str, str] = {}
        for cell in self.cells:
            lat, lon = self.latlon[cell]
            zid, tier = self.zone_id(cell), self.tier(cell)
            register_region(self.regions[cell])
            ip = self.node_ip(cell)
            infos[ip] = IPInfo(ip, lat, lon, zid, f"Lat{self.tag}",
                               f"cell {cell[0]},{cell[1]}")
            endpoints[self._endpoint_of[cell]] = ip
            profiles[self._endpoint_of[cell]] = TIER_PROFILES[tier]
        for hub in self.metro_hubs:
            lat, lon = self.latlon[hub]
            ip = self.metro_ip(hub)
            infos[ip] = IPInfo(ip, lat, lon, self.zone_id(hub), "LatMetro",
                               f"metro {hub[0]},{hub[1]}")
        for hub in self.core_hubs:
            lat, lon = self.latlon[hub]
            ip = self.core_ip(hub)
            infos[ip] = IPInfo(ip, lat, lon, self.zone_id(hub), "LatCore",
                               f"core {hub[0]},{hub[1]}")
        geo.register_ips(infos)
        register_endpoints(endpoints)
        register_endpoint_profiles(profiles)
        _INSTALLED[self.spec] = self
        register_route_provider(_route_provider)
        register_capacity_provider(_capacity_provider)
        # the provider set may be unchanged (second lattice), but the
        # provider's answers changed — drop memoized fallback routes
        discover_path.cache_clear()
        register_field_setup("repro_torch.core.carbon.lattice:install_spec",
                             self.spec)
        self._installed = True
        return self


# --- module registry and provider closures ---------------------------------
_INSTALLED: Dict[Tuple, ZoneLattice] = {}


def _route_provider(src: str, dst: str) -> Optional[Sequence[str]]:
    for lat in _INSTALLED.values():
        mids = lat.route_mids(src, dst)
        if mids is not None:
            return mids
    return None


def _capacity_provider(src: str, dst: str) -> Optional[float]:
    for lat in _INSTALLED.values():
        cap = lat.capacity(src, dst)
        if cap is not None:
            return cap
    return None


def install_spec(spec: Sequence) -> ZoneLattice:
    """Rebuild-and-install from a spec tuple — the ``register_field_setup``
    entrypoint a thawing spawn worker replays."""
    spec = tuple(spec)
    got = _INSTALLED.get(spec)
    if got is not None:
        return got
    rows, cols, tag, lat_s, lat_n, lon_w, lon_e, block, stride, seed = spec
    return ZoneLattice(rows, cols, tag, lat_s=lat_s, lat_n=lat_n,
                       lon_w=lon_w, lon_e=lon_e, metro_block=block,
                       core_stride=stride, seed=seed).install()


def installed() -> Dict[Tuple, ZoneLattice]:
    return dict(_INSTALLED)


def tier_of_endpoint(name: str) -> Optional[str]:
    """Tier of a lattice endpoint across all installed lattices (None for
    foreign endpoints) — what the cross-tier placement asserts read."""
    for lat in _INSTALLED.values():
        tier = lat.tier_of_endpoint(name)
        if tier is not None:
            return tier
    return None


# canonical sizes the benches and tests sweep: 8 / 64 / 200 zones
_PRESETS: Dict[int, Tuple[int, int, str, int, int]] = {
    # zones -> (rows, cols, tag, metro_block, core_stride)
    8: (2, 4, "MESO8", 2, 2),
    64: (8, 8, "MESO64", 4, 2),
    200: (10, 20, "MESO200", 4, 2),
}


def preset(zones: int) -> ZoneLattice:
    """An *uninstalled* canonical lattice — cheap to construct, used where
    only the deterministic names/tiers are needed (scenario definitions at
    import time). The installed instance from :func:`default_lattice` is
    value-identical."""
    try:
        rows, cols, tag, block, stride = _PRESETS[zones]
    except KeyError:
        raise KeyError(f"no lattice preset for {zones} zones; "
                       f"available: {sorted(_PRESETS)}") from None
    return ZoneLattice(rows, cols, tag, metro_block=block,
                       core_stride=stride)


def default_lattice(zones: int = 200) -> ZoneLattice:
    """Install-and-return one of the canonical lattices (8 / 64 / 200
    zones). Idempotent — every caller shares one instance per size."""
    return preset(zones).install()
