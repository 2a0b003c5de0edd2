"""End-system and network-device power models [paper §3.1, §5; Alan et al.
'Energy-aware data transfer algorithms' (ref [14])].

The paper's point (Fig. 1): end systems carry 25–90 % of transfer energy,
so they must be modeled, not ignored. RAPL/perf are unavailable here, so we
use the linear utilization model from [14]:

    P(t) = P_idle + c_cpu·u_cpu + c_mem·u_mem + c_nic·(thrpt/nic_speed)

Hop devices (routers/switches) use per-bit energy shares — the established
approach when devices expose no telemetry (§2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HostPowerModel:
    name: str
    idle_w: float              # baseline draw
    cpu_w: float               # full-load CPU delta
    mem_w: float               # full-pressure memory delta
    nic_w: float               # full-line-rate NIC delta
    nic_speed_gbps: float
    cores: int

    def power_w(self, cpu_util: float, mem_util: float,
                nic_gbps: float) -> float:
        u_nic = min(nic_gbps / self.nic_speed_gbps, 1.0)
        return (self.idle_w + self.cpu_w * min(max(cpu_util, 0.0), 1.0)
                + self.mem_w * min(max(mem_util, 0.0), 1.0)
                + self.nic_w * u_nic)

    def transfer_power_w(self, nic_gbps: float, *, parallelism: int = 1,
                         concurrency: int = 1) -> float:
        """Power while driving a transfer: CPU utilization scales with the
        stream count (observed behaviour in [14]/[24])."""
        streams = parallelism * concurrency
        cpu = min(0.05 + 0.02 * streams + 0.4 * nic_gbps / self.nic_speed_gbps,
                  1.0)
        mem = min(0.10 + 0.05 * nic_gbps / self.nic_speed_gbps, 1.0)
        return self.power_w(cpu, mem, nic_gbps)


# Table 2 nodes + TPU-host class for the cluster substrate.
HOST_PROFILES: Dict[str, HostPowerModel] = {
    # Cascade Lake baremetal @ TACC: 2×24c, 192 GiB, 10 Gbps
    "cascade_lake": HostPowerModel("cascade_lake", 110.0, 320.0, 45.0, 20.0,
                                   10.0, 48),
    # Skylake baremetal @ UC
    "skylake": HostPowerModel("skylake", 100.0, 280.0, 40.0, 20.0, 10.0, 40),
    # Apple M1 MacBook Pro @ DIDCLab (1.2 Gbps)
    "apple_m1": HostPowerModel("apple_m1", 6.0, 28.0, 6.0, 3.0, 1.2, 8),
    # v5e TPU host (CPU side only — the transfer path's "end system")
    "tpu_host": HostPowerModel("tpu_host", 180.0, 350.0, 60.0, 35.0, 100.0, 112),
    # object-store / filer frontend
    "storage_frontend": HostPowerModel("storage_frontend", 150.0, 250.0,
                                       80.0, 30.0, 50.0, 64),
    # mesoscale lattice device tiers (core/carbon/lattice.py): an edge
    # cache node is small and NIC-bound, a metro PoP a mid-size server, a
    # core hub a beefy frontend — three distinct power curves so a
    # cross-tier placement changes the [14] utilization integral, not just
    # the zone trace under it.
    "lat_edge": HostPowerModel("lat_edge", 18.0, 55.0, 10.0, 6.0, 2.5, 8),
    "lat_metro": HostPowerModel("lat_metro", 75.0, 190.0, 30.0, 15.0,
                                25.0, 32),
    "lat_core": HostPowerModel("lat_core", 210.0, 360.0, 70.0, 40.0,
                               100.0, 128),
}


# endpoint name (path.ENDPOINTS key) -> HOST_PROFILES key. The Table-2
# testbed nodes map to their measured hardware; the cluster sites are TPU
# hosts; anything unknown is treated as a storage frontend.
ENDPOINT_PROFILES: Dict[str, str] = {
    "uc": "skylake",
    "tacc": "cascade_lake",
    "m1": "apple_m1",
    "site_ca": "tpu_host",
    "site_or": "tpu_host",
    "site_ne": "tpu_host",
    "site_qc": "tpu_host",
    "site_de": "tpu_host",
}


def host_profile_for_endpoint(endpoint: str) -> HostPowerModel:
    """Receiver/sender power model for a named endpoint (paper Table 2)."""
    return HOST_PROFILES[ENDPOINT_PROFILES.get(endpoint, "storage_frontend")]


# per-hop device classes: (watts attributable at line rate, line rate Gbps).
# Backbone routers burn hundreds of watts per port; campus gear less. We
# charge transfers the utilization-proportional share (the traffic-
# engineering convention the paper cites [27, 64]).
HOP_CLASSES: Dict[str, Dict[str, float]] = {
    "campus": {"port_w": 40.0, "line_gbps": 10.0},
    "metro": {"port_w": 90.0, "line_gbps": 100.0},
    "backbone": {"port_w": 250.0, "line_gbps": 400.0},
}


def classify_hop(org: str) -> str:
    if org in ("Internet2", "I2-NYC", "LatCore"):
        return "backbone"
    if org in ("StarLight", "LatMetro"):
        return "metro"
    return "campus"


def register_endpoint_profiles(profiles: Dict[str, str]) -> None:
    """Bulk-extend the endpoint → host-profile map (idempotent for
    identical entries; conflicting re-registration raises). Every value
    must name an existing HOST_PROFILES entry."""
    for name, profile in profiles.items():
        if profile not in HOST_PROFILES:
            raise KeyError(f"unknown host profile {profile!r}")
        prev = ENDPOINT_PROFILES.get(name)
        if prev is not None and prev != profile:
            raise ValueError(f"endpoint {name!r} already mapped to {prev!r}")
        ENDPOINT_PROFILES[name] = profile


def hop_power_w(org: str, nic_gbps: float) -> float:
    c = HOP_CLASSES[classify_hop(org)]
    return c["port_w"] * min(nic_gbps / c["line_gbps"], 1.0)
