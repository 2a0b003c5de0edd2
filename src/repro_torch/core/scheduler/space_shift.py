"""Shifting in space [paper §4.2]: the dataset is replicated (CDN-style);
pick the source replica whose region/path is greenest. The paper's extreme:
Wyoming (index 1919) vs Vermont (index 1) — 1919× from source choice alone.

At lattice scale (hundreds of candidate zones, see
``core/carbon/lattice.py``) the scalar per-replica loop re-evaluates each
zone once per path it appears on; :func:`best_source_batch` ranks many
replica sets in one pass — every distinct zone's CI evaluates exactly once
through the shared ``CarbonField`` — with :func:`best_source` kept as the
scalar oracle (``tests/test_torch_workloads.py`` pins both to the
reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon.path import NetworkPath, discover_path


@dataclasses.dataclass(frozen=True)
class SourceChoice:
    source: str
    path: NetworkPath
    expected_ci: float
    ranking: Tuple[Tuple[str, float], ...]    # all candidates, sorted

    @property
    def savings_factor(self) -> float:
        worst = self.ranking[-1][1]
        return worst / self.expected_ci if self.expected_ci > 0 else 1.0


def best_source(replicas: Sequence[str], dst: str, t: float, *,
                duration_s: float = 0.0,
                ci_fn: Optional[Callable[[NetworkPath, float], float]] = None
                ) -> SourceChoice:
    """Rank replica sites by expected path CI to ``dst`` and pick the min."""
    if not replicas:
        raise ValueError("no replicas")
    scored = []
    paths = {}
    for src in replicas:
        p = discover_path(src, dst)
        paths[src] = p
        ci = ci_fn(p, t) if ci_fn else p.ci(t)
        scored.append((src, ci))
    scored.sort(key=lambda kv: kv[1])
    src, ci = scored[0]
    return SourceChoice(source=src, path=paths[src], expected_ci=ci,
                        ranking=tuple(scored))


def best_source_batch(replica_sets: Sequence[Sequence[str]], dst: str,
                      t: float, *, field=None) -> List[SourceChoice]:
    """Rank many replica sets at once (the lattice-scale fan-out path).

    Semantics match ``best_source(reps, dst, t)`` per set: score is the
    path-mean calibrated zone CI at ``t``, min wins, ties break in replica
    order (stable sort). The fan-out win: each distinct zone across every
    candidate path evaluates once through one vectorized ``CarbonField``
    call instead of once per (replica, hop).
    """
    if field is None:
        from repro_torch.core.carbon.field import default_field
        field = default_field()
    srcs = sorted({s for reps in replica_sets for s in reps})
    if not srcs or any(not reps for reps in replica_sets):
        raise ValueError("no replicas")
    paths: Dict[str, NetworkPath] = {s: discover_path(s, dst) for s in srcs}
    zones = sorted({h.zone for p in paths.values() for h in p.hops})
    vals = field.ci(zones, np.asarray([t], dtype=np.float64))
    zone_ci = {z: float(vals[i, 0]) for i, z in enumerate(zones)}
    # same accumulation order as NetworkPath.ci: sum over hops, then /n
    path_ci = {s: sum(zone_ci[h.zone] for h in p.hops) / p.n_hops
               for s, p in paths.items()}
    out: List[SourceChoice] = []
    for reps in replica_sets:
        scored = sorted(((s, path_ci[s]) for s in reps),
                        key=lambda kv: kv[1])
        src, ci = scored[0]
        out.append(SourceChoice(source=src, path=paths[src], expected_ci=ci,
                                ranking=tuple(scored)))
    return out
