"""Plain torch oracles for the port's kernels (the allclose targets)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, T, d]; k/v: [B, Hkv, S, d] -> [B, Hq, T, d].

    Masked softmax in f32 over positions ``k <= q`` (causal) and
    ``q - k < window``; query head h reads kv head ``h // (Hq // Hkv)``.
    """
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qh = q.reshape(B, Hkv, g, T, d).float()
    scores = torch.einsum("bkgtd,bksd->bkgts", qh,
                          k.float()) / math.sqrt(d)
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return out.reshape(B, Hq, T, d).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence, the ground truth.

    x: [B,S,nh,hd]; dt: [B,S,nh] (>0); A: [nh] (<0); Bm/Cm: [B,S,N]
    returns (y [B,S,nh,hd] in x's dtype, h_final [B,nh,hd,N] f32). One
    step per token: slow, for the tests only."""
    bsz, s, nh, hd = x.shape
    f32 = torch.float32
    h = torch.zeros((bsz, nh, hd, Bm.shape[-1]), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)
        da = torch.exp(dtt * A.to(f32)[None])
        inc = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].to(f32),
                           Bm[:, t].to(f32))
        h = h * da[..., None, None] + inc
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), h
