"""Elastic scaling: pods join/leave (failures, carbon-driven migration,
preemption) → re-mesh plan + job migration through the overlay scheduler.

This is the paper's §4.3 applied to the JOB rather than a file: the
"remaining work" is the training state; the "FTN" is the destination pod;
the checkpoint is the hand-off token. Carbon-triggered migration fires when
a site's CI exceeds the threshold and a greener site has capacity.

A copy of the reference's jax-free ``cluster/elastic.py`` on the port's
cluster and carbon modules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.topology import Cluster, Pod, Site
from repro_torch.core.carbon.intensity import calibrated_ci
from repro_torch.core.carbon.path import discover_path
from repro_torch.core.scheduler.time_shift import expected_transfer_ci


@dataclasses.dataclass(frozen=True)
class ReMeshPlan:
    """How to continue after a capacity change."""
    pods: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]          # (pod, data, model)
    global_batch: int                    # rescaled to keep per-chip batch
    needs_restore: bool                  # params must be re-laid-out
    migration_bytes: float               # checkpoint bytes crossing the DCN
    reason: str


@dataclasses.dataclass
class ElasticPlanner:
    cluster: Cluster
    base_batch: int = 256
    base_pods: int = 2
    carbon_threshold: float = 400.0

    def _mesh_for(self, n_pods: int) -> Tuple[int, ...]:
        return (n_pods, 16, 16) if n_pods > 1 else (16, 16)

    def on_pod_loss(self, active: Sequence[str], lost: str,
                    ckpt_bytes: float) -> ReMeshPlan:
        """Synchronous DP over pods: drop the pod, shrink batch pro rata,
        restore the (replicated-over-pod) params on the survivors."""
        remaining = tuple(p for p in active if p != lost)
        if not remaining:
            raise RuntimeError("no pods left")
        batch = self.base_batch * len(remaining) // self.base_pods
        return ReMeshPlan(
            pods=remaining, mesh_shape=self._mesh_for(len(remaining)),
            global_batch=max(batch, 16), needs_restore=False,
            migration_bytes=0.0,
            reason=f"pod_loss:{lost}")

    def on_pod_join(self, active: Sequence[str], joined: str,
                    ckpt_bytes: float) -> ReMeshPlan:
        pods = tuple(active) + (joined,)
        batch = self.base_batch * len(pods) // self.base_pods
        return ReMeshPlan(
            pods=pods, mesh_shape=self._mesh_for(len(pods)),
            global_batch=batch, needs_restore=True,
            migration_bytes=ckpt_bytes,   # new pod pulls params via DCN
            reason=f"pod_join:{joined}")

    def carbon_migration(self, active_site: str, t: float,
                         ckpt_bytes: float,
                         duration_left_s: float) -> Optional[ReMeshPlan]:
        """§4.3 for the job: if the active site is dirty and a greener site
        with capacity exists AND the move pays for itself (remaining work ×
        ΔCI > migration cost), emit a migration plan."""
        cur_zone = self.cluster.zone_of(active_site)
        cur_ci = calibrated_ci(cur_zone, t)
        if cur_ci <= self.carbon_threshold:
            return None
        best_site, best_ci = None, cur_ci
        for s in self.cluster.sites.values():
            if s.name == active_site or not s.pods:
                continue
            ci = calibrated_ci(s.zone, t)
            if ci < best_ci:
                best_site, best_ci = s, ci
        if best_site is None:
            return None
        # energy-weighted payback test (power ≈ fleet draw × remaining time)
        # the reference's fleet power model (~300 W a chip), kept so the
        # port decides migrations exactly as the reference does
        fleet_kw = 0.3 * sum(p.n_chips for p in best_site.pods)
        saved_g = fleet_kw * (duration_left_s / 3600.0) * (cur_ci - best_ci)
        path = discover_path(active_site, best_site.name)
        move_ci = expected_transfer_ci(path, t, 600.0)
        move_g = (ckpt_bytes / 1e9) * 0.02 * move_ci     # ~0.02 kWh/GB moved
        if saved_g <= move_g:
            return None
        n = len(best_site.pods)
        return ReMeshPlan(
            pods=tuple(p.name for p in best_site.pods),
            mesh_shape=self._mesh_for(n),
            global_batch=self.base_batch * n // self.base_pods,
            needs_restore=True, migration_bytes=ckpt_bytes,
            reason=(f"carbon:{active_site}@{cur_ci:.0f}"
                    f"->{best_site.name}@{best_ci:.0f}"))
