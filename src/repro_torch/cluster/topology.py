"""Cluster model: geographically distributed sites, each hosting pods of
GPUs; sites sit in grid regions (carbon), are joined by DCN links (the WAN
the paper's scheduler governs), and expose storage replicas (space
shifting).

``paper_testbed()`` reproduces Table 2 (UC + TACC Chameleon nodes and the
Buffalo M1); ``default_cluster()`` is the production multi-site fleet used
by the examples and the elastic/fault machinery.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.overlay import FTN


# One NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data
# sheet: dense (not sparse) bf16 tensor-core FLOP/s, f32 and f64
# non-tensor FLOP/s, HBM3 bytes/s, and NVLink 4's 900 GB/s per GPU counted
# one way (450e9 B/s). The roofline's collective term divides each device's
# wire bytes by that one-way figure: a ring over NVSwitch sends on every
# link of a GPU at once while it receives on them, so a device's sends
# share 450 GB/s, as a TPU's go over its ICI links.
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12
H100_HBM_BPS = 3.35e12
H100_NVLINK_BPS = 450e9


@dataclasses.dataclass(frozen=True)
class Pod:
    name: str
    site: str
    n_chips: int = 256
    mesh_shape: Tuple[int, int] = (16, 16)
    # one NVIDIA H100 SXM (see above): dense bf16 tensor-core peak, HBM
    # size and bandwidth, NVLink one way
    chip_peak_flops: float = H100_BF16_FLOPS
    chip_hbm_gb: float = 80.0
    chip_hbm_bps: float = H100_HBM_BPS
    chip_link_bps: float = H100_NVLINK_BPS


@dataclasses.dataclass(frozen=True)
class Site:
    name: str                    # endpoint key in core.carbon.path
    zone: str                    # grid region
    pods: Tuple[Pod, ...]
    storage_replicas: Tuple[str, ...] = ()   # dataset ids held here
    host_profile: str = "tpu_host"
    dcn_gbps: float = 100.0

    @property
    def n_chips(self) -> int:
        return sum(p.n_chips for p in self.pods)

    def as_ftn(self) -> FTN:
        return FTN(self.name, self.host_profile, self.dcn_gbps)


@dataclasses.dataclass
class Cluster:
    sites: Dict[str, Site]

    @property
    def pods(self) -> List[Pod]:
        return [p for s in self.sites.values() for p in s.pods]

    def site_of(self, pod_name: str) -> Site:
        for s in self.sites.values():
            if any(p.name == pod_name for p in s.pods):
                return s
        raise KeyError(pod_name)

    def replicas_of(self, dataset: str) -> List[str]:
        return [s.name for s in self.sites.values()
                if dataset in s.storage_replicas]

    def ftns(self) -> List[FTN]:
        return [s.as_ftn() for s in self.sites.values()]

    def zone_of(self, site: str) -> str:
        return self.sites[site].zone


def paper_testbed() -> Cluster:
    """Table 2: two Chameleon baremetal nodes + the DIDCLab M1."""
    return Cluster(sites={
        "tacc": Site("tacc", "US-TEX-ERCO",
                     (Pod("tacc-node", "tacc", n_chips=1, mesh_shape=(1, 1)),),
                     storage_replicas=("dataset-A",),
                     host_profile="cascade_lake", dcn_gbps=10.0),
        "uc": Site("uc", "US-MIDW-MISO",
                   (Pod("uc-node", "uc", n_chips=1, mesh_shape=(1, 1)),),
                   storage_replicas=("dataset-A",),
                   host_profile="skylake", dcn_gbps=10.0),
        "m1": Site("m1", "US-NY-NYIS",
                   (Pod("m1-node", "m1", n_chips=1, mesh_shape=(1, 1)),),
                   host_profile="apple_m1", dcn_gbps=1.2),
    })


def default_cluster() -> Cluster:
    """Production fleet: 2 pods per primary site (the 2×16×16 dry-run mesh
    spans site_or's two pods), replicas spread for space shifting."""
    mk = lambda site, i: Pod(f"{site}-pod{i}", site)
    return Cluster(sites={
        "site_or": Site("site_or", "US-NW-BPAT",
                        (mk("site_or", 0), mk("site_or", 1)),
                        storage_replicas=("tokens-v1", "ckpt-main")),
        "site_ca": Site("site_ca", "US-CAL-CISO",
                        (mk("site_ca", 0), mk("site_ca", 1)),
                        storage_replicas=("tokens-v1",)),
        "site_ne": Site("site_ne", "US-CENT-SWPP", (mk("site_ne", 0),),
                        storage_replicas=("tokens-v1", "ckpt-main")),
        "site_qc": Site("site_qc", "CA-QC", (mk("site_qc", 0),),
                        storage_replicas=("tokens-v1", "ckpt-main")),
        "site_de": Site("site_de", "DE", (mk("site_de", 0),),
                        storage_replicas=("tokens-v1",)),
    })
