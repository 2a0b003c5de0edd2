"""Random weights in the port's naming, made on the device from the seed.

The normal leaves are drawn as one flat buffer in the type they are served
in, a few large ``normal_`` calls of one ``torch.Generator`` on the
device, and then scaled leaf by leaf; each leaf is a view of the buffer.
The few small leaves (norm scales, Mamba-2's A_log, D and dt_bias) follow
their own init rules from one ``uniform_`` call. The same tensors go to
the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

# elements a normal_ call fills (2 GiB of bf16)
DRAW = 1 << 30


def make_weights(cfg, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """``{state dict key: tensor}`` for ``cfg`` (the port's
    ``ModelConfig``) on ``device``, from ``seed``."""
    from repro_torch.models.params import layer_spec_tree, torch_dtype
    specs = layer_spec_tree(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dtype = torch_dtype(cfg.dtype)
    normal = [(k, s) for k, s in specs.items() if s.init == "normal"]
    total = sum(math.prod(s.shape) for _, s in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, DRAW):
        flat[i:i + DRAW].normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, s in normal:
        n = math.prod(s.shape)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        out[k] = flat[off:off + n].view(s.shape).mul_(
            min(s.scale, 1.0 / math.sqrt(fan_in)))
        off += n
    drawn = [(k, s) for k, s in specs.items() if s.init in ("ssm_a",
                                                            "ssm_dt")]
    u = torch.empty(sum(math.prod(s.shape) for _, s in drawn),
                    dtype=torch.float32, device=device).uniform_(
                        generator=gen)
    off = 0
    for k, s in drawn:
        n = math.prod(s.shape)
        v = u[off:off + n].view(s.shape)
        off += n
        if s.init == "ssm_a":       # A_log = log U[1, 16]
            out[k] = torch.log(1.0 + 15.0 * v)
        else:                       # dt_bias = softplus^-1 U[1e-3, 1e-1]
            out[k] = torch.log(torch.expm1(1e-3 + (1e-1 - 1e-3) * v))
    for k, s in specs.items():
        if s.init == "zeros":
            out[k] = torch.zeros(s.shape, dtype=dtype, device=device)
        elif s.init == "ones":
            out[k] = torch.ones(s.shape, dtype=dtype, device=device)
    missing = set(specs) - set(out)
    if missing:
        raise ValueError(f"no init rule for {sorted(missing)[:5]}")
    return out
