"""AdamW with f32 master weights over (possibly bf16) parameters.

The reference's ``optim/adamw.py`` over the port's state dicts (``{name:
tensor}``). Where the reference returns new trees, :func:`adamw_update`
updates the optimizer state and the parameters in place, which saves a
copy of every f32 buffer per step.

Weight decay applies to the leaves the reference decays: those of two or
more dimensions *in the reference's stacked tree*, where every decoder
leaf carries a leading scan-group axis. So a decoder layer's 1-D leaves
(norm scales, ``A_log``, ``D``, ``dt_bias``) are decayed, as in the
reference, while the final norm is not (:func:`decays`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping

import torch

from repro_torch.core.obs import runtime as obs

STACKED_PREFIX = "decoder.layers."


@dataclasses.dataclass
class OptState:
    step: int                          # updates taken so far
    master: Dict[str, torch.Tensor]    # f32 copy of the parameters
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Mapping[str, torch.Tensor]) -> OptState:
    f32 = torch.float32
    return OptState(
        step=0,
        master={k: p.detach().to(f32, copy=True) for k, p in params.items()},
        m={k: torch.zeros(p.shape, dtype=f32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=f32, device=p.device)
           for k, p in params.items()})


def abstract_opt_state(abstract_params: Mapping[str, torch.Tensor]
                       ) -> OptState:
    """The optimizer state as meta tensors (the reference's dry-run
    tree): f32 master, m and v of each parameter's shape, and the step
    as an int32 scalar (the live state counts it in a Python int)."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        master={k: f32(p) for k, p in abstract_params.items()},
        m={k: f32(p) for k, p in abstract_params.items()},
        v={k: f32(p) for k, p in abstract_params.items()})


def decays(name: str, t: torch.Tensor) -> bool:
    """Whether the reference decays this leaf: ndim >= 2 of its stacked
    form (decoder layers gain the scan-group axis)."""
    return t.dim() + (1 if name.startswith(STACKED_PREFIX) else 0) >= 2


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt: OptState,
                 params: Mapping[str, torch.Tensor], *, lr: float,
                 beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    """One step, in place: ``opt`` advances and each parameter becomes its
    new master weight in the parameter's dtype. Returns the metrics
    {"grad_norm", "clip_scale"} as 0-dim device tensors."""
    with obs.span("adamw.update"):
        opt.step += 1
        gnorm = global_norm(grads.values())
        scale = (torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
                 if grad_clip > 0 else torch.ones_like(gnorm))
        b1c = 1.0 - beta1 ** opt.step
        b2c = 1.0 - beta2 ** opt.step
        for k, g in grads.items():
            m, v, w = opt.m[k], opt.v[k], opt.master[k]
            g = g.float() * scale
            m.mul_(beta1).add_(g, alpha=1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            wd = weight_decay if decays(k, params[k]) else 0.0
            w.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * w))
            params[k].copy_(w)
    return {"grad_norm": gnorm, "clip_scale": scale}
