"""Shifting in space [paper §4.2]: the dataset is replicated (CDN-style);
pick the source replica whose region/path is greenest. The paper's extreme:
Wyoming (index 1919) vs Vermont (index 1) — 1919× from source choice alone.

The reference's scalar ``best_source``, which the training data pipeline
calls; its lattice-scale ``best_source_batch`` comes with the zone lattice
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

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
