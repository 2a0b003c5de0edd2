"""Carbon-adaptive local SGD (DiLoCo-style) for the cross-pod axis.

Each pod optimizes locally; every H steps the pods exchange parameter
deltas over the DCN and apply an outer update. The paper's time-shifting
lever applied to gradient traffic: H stretches when the current carbon
intensity is high (dirty hours → fewer, compressed syncs) and shrinks when
green. Divergence is bounded by H_max; the outer momentum keeps the
trajectory close to synchronous SGD (Douillard et al., DiLoCo).

The reference's ``optim/localsgd.py`` over the port's state dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.optim.compression import (CompressionState, compress_tree,
                                           decompress_tree)


@dataclasses.dataclass
class CarbonSyncController:
    """Maps current CI → sync period H ∈ [h_min, h_max], linear in CI
    between the green/dirty thresholds."""
    h_min: int = 1
    h_max: int = 16
    ci_green: float = 250.0
    ci_dirty: float = 450.0

    def period(self, ci: float) -> int:
        if ci <= self.ci_green:
            return self.h_min
        if ci >= self.ci_dirty:
            return self.h_max
        f = (ci - self.ci_green) / (self.ci_dirty - self.ci_green)
        return int(round(self.h_min + f * (self.h_max - self.h_min)))


@dataclasses.dataclass
class OuterOptState:
    anchor: Dict[str, torch.Tensor]    # params at last sync (f32)
    momentum: Dict[str, torch.Tensor]
    compression: Optional[CompressionState]


def outer_init(params: Mapping[str, torch.Tensor]) -> OuterOptState:
    return OuterOptState(
        anchor={k: p.detach().float().clone() for k, p in params.items()},
        momentum={k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                  for k, p in params.items()},
        compression=None)


def pod_sync(pod_params: List[Mapping[str, torch.Tensor]],
             outer: OuterOptState, *, outer_lr: float = 0.7,
             outer_beta: float = 0.9, scheme: str = "none",
             k_frac: float = 0.01
             ) -> Tuple[List[Dict[str, torch.Tensor]], OuterOptState, int]:
    """One cross-pod sync: average the per-pod deltas vs the anchor
    (optionally compressed — this is the DCN payload), apply a Nesterov-ish
    outer update, broadcast the result back. Returns (new per-pod params,
    new outer state, wire bytes per pod)."""
    n = len(pod_params)
    wire, comp_state, sent = 0, outer.compression, []
    for pp in pod_params:
        delta = {k: p.float() - outer.anchor[k] for k, p in pp.items()}
        payload, comp_state, nbytes = compress_tree(
            delta, scheme, k_frac=k_frac, state=comp_state)
        sent.append(decompress_tree(payload, scheme))
        wire += nbytes
    mean_delta = {k: sum(s[k] for s in sent) / n for k in outer.anchor}
    mom = {k: outer_beta * outer.momentum[k] + mean_delta[k]
           for k in outer.anchor}
    anchor = {k: outer.anchor[k] + outer_lr * mom[k] for k in outer.anchor}
    new_params = [{k: anchor[k].to(p.dtype) for k, p in pp.items()}
                  for pp in pod_params]
    return new_params, OuterOptState(anchor, mom, comp_state), wire // n
