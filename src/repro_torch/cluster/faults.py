"""Fault injection and straggler modeling for the training runtime.

At thousand-node scale the MTBF of the fleet is hours, so the loop must
survive: (a) hard node/pod failures → restore from the last checkpoint,
(b) stragglers → step-time tail; mitigated by timeout-skip with gradient
re-weighting (see runtime.train_loop). Deterministic (seeded) so tests can
assert exact recovery behaviour. A copy of the reference's jax-free
``cluster/faults.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Optional, Sequence, Tuple


def _u(seed: str) -> float:
    h = hashlib.blake2b(seed.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2**64


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str                     # 'node' | 'pod' | 'network'
    pod: str
    recover_steps: int            # steps of downtime if unhandled


@dataclasses.dataclass
class FaultInjector:
    """Per-step Bernoulli failures with fleet-size scaling.

    p_node_per_step ≈ n_nodes × step_time / MTBF_node. With 1000 nodes,
    30 s steps and 5e6 s (≈58 d) node MTBF that is ~6e-3 per step.
    """
    pods: Sequence[str]
    seed: int = 0
    nodes_per_pod: int = 64
    mtbf_node_s: float = 5e6
    step_time_s: float = 30.0
    p_network_blip: float = 1e-3

    def events_at(self, step: int) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        for pod in self.pods:
            p_fail = (self.nodes_per_pod * self.step_time_s
                      / self.mtbf_node_s)
            if _u(f"{self.seed}:{pod}:{step}:node") < p_fail:
                out.append(FaultEvent(step, "node", pod, recover_steps=3))
            if _u(f"{self.seed}:{pod}:{step}:net") < self.p_network_blip:
                out.append(FaultEvent(step, "network", pod, recover_steps=1))
        return out


@dataclasses.dataclass
class StragglerModel:
    """Step-time multiplier per pod: log-normal body + heavy tail.

    ``is_straggler`` flags pods whose step exceeds the timeout multiple —
    the loop then drops their microbatch contribution and re-weights
    (gradient average over the survivors stays unbiased).
    """
    pods: Sequence[str]
    seed: int = 0
    sigma: float = 0.08
    p_tail: float = 0.01
    tail_mult: float = 3.0
    timeout_mult: float = 2.0

    def step_time_mult(self, pod: str, step: int) -> float:
        u1 = _u(f"{self.seed}:{pod}:{step}:ln")
        u2 = _u(f"{self.seed}:{pod}:{step}:tail")
        # Box-Muller-ish lognormal from one uniform (cheap + deterministic)
        z = math.sqrt(-2.0 * math.log(max(u1, 1e-12))) * math.cos(
            2 * math.pi * _u(f"{self.seed}:{pod}:{step}:ph"))
        mult = math.exp(self.sigma * z)
        if u2 < self.p_tail:
            mult *= self.tail_mult
        return mult

    def is_straggler(self, pod: str, step: int) -> bool:
        return self.step_time_mult(pod, step) > self.timeout_mult

    def effective_step_time(self, step: int, *, base_s: float = 30.0,
                            drop_stragglers: bool = True
                            ) -> Tuple[float, List[str]]:
        """Synchronous step time = max over participating pods."""
        mults = {p: self.step_time_mult(p, step) for p in self.pods}
        dropped = [p for p, m in mults.items()
                   if drop_stragglers and m > self.timeout_mult]
        alive = {p: m for p, m in mults.items() if p not in dropped}
        if not alive:
            alive = mults
            dropped = []
        if drop_stragglers:
            # survivors capped at the timeout — that IS the mitigation
            t = base_s * min(max(alive.values()), self.timeout_mult)
        else:
            t = base_s * max(mults.values())
        return t, dropped
