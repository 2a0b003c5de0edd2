"""Pmeter-analogue telemetry: the exact metric set of paper Table 1.

``Pmeter.measure()`` emits one record per interval from the simulated host/
transfer state (psutil/netstat are pointless inside this runtime — the
fields and record flow match the open-source tool the paper builds on
[github.com/didclab/pmeter]).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import uuid
from typing import Callable, Dict, List, Optional

from repro_torch.core.carbon.energy import HOST_PROFILES, HostPowerModel


@dataclasses.dataclass
class HostMetrics:
    core_count: int
    free_memory: int
    max_memory: int
    memory: int
    min_cpu_frequency_mhz: float
    max_cpu_frequency_mhz: float
    current_cpu_frequency_mhz: float
    cpu_architecture: str
    cpu_utilization: float


@dataclasses.dataclass
class NetworkMetrics:
    drop_out: int
    drop_in: int
    error_in: int
    error_out: int
    dst_latency_ms: float
    src_rtt_ms: float
    dst_rtt_ms: float
    nic_mtu: int
    network_interface: str
    packet_sent: int
    packet_received: int
    nic_speed_mbps: float
    read_throughput_bps: float
    write_throughput_bps: float


@dataclasses.dataclass
class TransferMetrics:
    job_uuid: str
    source_latency_ms: float
    job_size_bytes: int
    transfer_node_id: str
    buffer_size: int
    parallelism: int
    concurrency: int
    pipelining: int
    bytes_received: int
    bytes_sent: int


@dataclasses.dataclass
class PmeterRecord:
    t: float
    host: HostMetrics
    network: NetworkMetrics
    transfer: Optional[TransferMetrics]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


_ARCH = {"cascade_lake": "x86_64", "skylake": "x86_64", "apple_m1": "arm64",
         "tpu_host": "x86_64", "storage_frontend": "x86_64"}


class Pmeter:
    """Per-node metric collector, fed by the transfer engine.

    When constructed with a grid ``zone``, the collector also prices every
    record against the shared :class:`CarbonField` (one hashed-noise cache
    for the whole process) so live gCO₂ accounting costs an array lookup,
    not a fresh trace evaluation per sample.
    """

    def __init__(self, node_id: str, profile: str = "tpu_host",
                 interface: str = "eth0", mtu: int = 9000,
                 zone: Optional[str] = None, field=None,
                 clock: Optional[Callable[[], float]] = None):
        self.node_id = node_id
        self.profile: HostPowerModel = HOST_PROFILES[profile]
        self.profile_name = profile
        self.interface = interface
        self.mtu = mtu
        self.zone = zone
        self._field = field
        # time source for measure(t=None): inject the event loop's sim
        # clock (e.g. ``lambda: ctl.events.now``) so records replay
        # deterministically; without one, measure() falls back to wall
        # time — the seed tool's behavior
        self.clock = clock
        self.records: List[PmeterRecord] = []
        self._pkts_sent = 0
        self._pkts_recv = 0

    @property
    def field(self):
        if self._field is None:
            from repro_torch.core.carbon.field import default_field
            self._field = default_field()
        return self._field

    def ci(self, t: float) -> float:
        """Local grid CI at time t (0.0 when the node has no zone)."""
        if self.zone is None:
            return 0.0
        return float(self.field.zone_ci(self.zone, t))

    def emissions_g(self) -> float:
        """gCO₂eq accumulated over the recorded samples: P(rec)·CI(zone)
        integrated with left-step weights over the record timestamps."""
        if self.zone is None or len(self.records) < 2:
            return 0.0
        import numpy as np
        ts = np.array([r.t for r in self.records])
        powers = np.array([self.power_w(r) for r in self.records])
        cis = self.field.zone_ci(self.zone, ts)
        steps = np.diff(ts)
        return float((powers[:-1] * cis[:-1] * steps).sum() / 3.6e6)

    def measure(self, t: Optional[float] = None, *, cpu_util: float,
                mem_util: float,
                tx_gbps: float, rx_gbps: float, rtt_src_ms: float = 0.2,
                rtt_dst_ms: float = 20.0,
                transfer: Optional[TransferMetrics] = None) -> PmeterRecord:
        if t is None:
            t = self.clock() if self.clock is not None else time.time()
        p = self.profile
        mem_total = 192 * 2**30 if p.cores >= 40 else 16 * 2**30
        used = int(mem_total * min(mem_util, 1.0))
        self._pkts_sent += int(tx_gbps * 1e9 / 8 / self.mtu)
        self._pkts_recv += int(rx_gbps * 1e9 / 8 / self.mtu)
        rec = PmeterRecord(
            t=t,
            host=HostMetrics(
                core_count=p.cores,
                free_memory=mem_total - used,
                max_memory=mem_total,
                memory=used,
                min_cpu_frequency_mhz=800.0,
                max_cpu_frequency_mhz=3800.0,
                current_cpu_frequency_mhz=800.0 + 3000.0 * min(cpu_util, 1.0),
                cpu_architecture=_ARCH[self.profile_name],
                cpu_utilization=round(min(cpu_util, 1.0), 4),
            ),
            network=NetworkMetrics(
                drop_out=0, drop_in=int(1e-6 * self._pkts_recv),
                error_in=0, error_out=0,
                dst_latency_ms=rtt_dst_ms / 2,
                src_rtt_ms=rtt_src_ms, dst_rtt_ms=rtt_dst_ms,
                nic_mtu=self.mtu, network_interface=self.interface,
                packet_sent=self._pkts_sent, packet_received=self._pkts_recv,
                nic_speed_mbps=p.nic_speed_gbps * 1000.0,
                read_throughput_bps=rx_gbps * 1e9,
                write_throughput_bps=tx_gbps * 1e9,
            ),
            transfer=transfer,
        )
        self.records.append(rec)
        return rec

    def power_w(self, rec: PmeterRecord) -> float:
        nic_gbps = (rec.network.read_throughput_bps
                    + rec.network.write_throughput_bps) / 1e9
        mem_util = rec.host.memory / rec.host.max_memory
        return self.profile.power_w(rec.host.cpu_utilization, mem_util,
                                    nic_gbps)


def new_job_uuid(node_id: Optional[str] = None,
                 seq: Optional[int] = None) -> str:
    """A job UUID string. With ``(node_id, seq)`` context the UUID is
    blake2b-derived and therefore identical under replay — the
    determinism contract everything in this runtime keeps; without
    context it falls back to a random ``uuid4`` (the seed behavior)."""
    if node_id is None and seq is None:
        return str(uuid.uuid4())
    d = hashlib.blake2b(f"pmeter:{node_id}:{seq}".encode(),
                        digest_size=16).digest()
    return str(uuid.UUID(bytes=d))
