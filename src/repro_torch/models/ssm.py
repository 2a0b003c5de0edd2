"""Mamba-2 / SSD (state-space duality) block, arXiv:2405.21060: the
training path.

The same block as the reference's ``models/ssm.py`` for ``state=None``:
in-projection, the depthwise causal conv as ``width`` shifted adds, the
SSD scan (the chunked algorithm, or with ``use_kernel`` the CUDA kernel
through :func:`repro_torch.kernels.ops.ssd_scan`), the D skip, the gated
RMSNorm and the out-projection. The chunked algorithm itself,
``ssd_chunked`` with its ``_segsum_decay``, lives beside the kernel as its
plain version (:mod:`repro_torch.kernels.ssd_scan`).

Layout: x [B, S, nh, hd]; B/C [B, S, G, N]; dt [B, S, nh].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import rms_norm

NOT_PORTED = ("SSM {} comes with the SSM serving item of the port "
              "(ROADMAP.md, queue 1, item 2); this slice trains")


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifts. x: [B, S, C], w: [width, C]."""
    width = w.shape[0]
    out = x * w[-1][None, None, :]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[-1 - i][None, None, :]
    return out


def mamba_block(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: SSMConfig, *, state=None, norm_eps: float = 1e-6,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, Optional[object]]:
    """Full Mamba-2 block over a whole sequence. x: [B, S, d_model] ->
    (out [B, S, d_model], None).

    params: in_proj [d, 2*d_in + 2*G*N + nh], conv [w, d_in + 2GN],
            A_log/D/dt_bias [nh], gate_norm [d_in], out_proj [d_in, d].
    """
    if state is not None:
        raise NotImplementedError(NOT_PORTED.format("decode state"))
    B, S, d = x.shape
    d_in = cfg.d_inner(d)
    nh = cfg.n_heads(d)
    G, N, hd = cfg.n_groups, cfg.d_state, cfg.headdim
    conv_ch = d_in + 2 * G * N

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_ch, nh], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xBC = F.silu(_causal_conv(xBC, params["conv"].to(x.dtype)))

    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    if use_kernel:
        y, _ = ops.ssd_scan(xs, dt, A, Bm, Cm, cfg.chunk_size)
    else:
        y, _ = ssd_chunked(xs, dt, A, Bm, Cm, cfg.chunk_size)

    y = y + xs * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z), params["gate_norm"], norm_eps)
    return y @ params["out_proj"].to(x.dtype), None
