"""Mamba-2 / SSD (state-space duality) block, arXiv:2405.21060.

The reference's ``models/ssm.py``. Whole-sequence path (training,
prefill): in-projection, the depthwise causal conv as ``width`` shifted
adds, the SSD scan (the chunked algorithm, or with ``use_kernel`` the CUDA
kernel through :func:`repro_torch.kernels.ops.ssd_scan`), the D skip, the
gated RMSNorm and the out-projection. Decode path: O(1) recurrent state
update per token, the conv over a rolling window of the last ``width``
inputs. The chunked algorithm itself, ``ssd_chunked`` with its
``_segsum_decay``, lives beside the kernel as its plain version
(:mod:`repro_torch.kernels.ssd_scan`).

Layout: x [B, S, nh, hd]; B/C [B, S, G, N]; dt [B, S, nh];
state [B, nh, hd, N].
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.core.obs import runtime as obs
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import rms_norm
from repro_torch.runtime import pspec as PS


class SSMState(NamedTuple):
    conv: torch.Tensor   # [B, w-1, conv_channels] rolling input window
    h: torch.Tensor      # [B, nh, hd, N] f32


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifts. x: [B, S, C], w: [width, C]. Each
    shifted tap is multiplied and added into the later positions in place
    (one pass over the output), not padded and copied first."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        out[:, i:].addcmul_(x[:, :-i], w[-1 - i])
    return out


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x [B, nh, hd], dt [B, nh], Bm/Cm [B, G, N],
    h [B, nh, hd, N] -> (y [B, nh, hd] in x's dtype, h_next f32)."""
    nh, G = x.shape[1], Bm.shape[1]
    rep = nh // G
    dt = dt.float()
    da = torch.exp(dt * A.float()[None, :])                   # [B, nh]
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=1)      # [B, nh, N]
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=1)
    inc = torch.einsum("bh,bhp,bhn->bhpn", dt, x.float(), Bh)
    h_next = h * da[:, :, None, None] + inc
    y = torch.einsum("bhpn,bhn->bhp", h_next, Ch)
    return y.to(x.dtype), h_next


def mamba_block(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: SSMConfig, *, state: Optional[SSMState] = None,
                norm_eps: float = 1e-6, use_kernel: bool = False,
                final_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba-2 block. x: [B, S, d_model] (S == 1 to decode, when
    ``state`` is given) -> (out [B, S, d_model], new state or None).

    Without ``state`` the block runs the whole sequence from a zero state;
    with ``final_state`` it also returns the decode state after its last
    token (the reference's ``_ssm_prefill``): the last ``width - 1`` conv
    inputs, before the conv, and the scan's final state, taken from the
    kernel on the kernel path.

    The elementwise chains between the GEMMs and the scan (conv and SiLU;
    D skip, gate and gated norm) run in f32 and round to x's dtype once,
    before the next GEMM or scan, as one fused kernel would: rounding each
    step to bf16 drifts a 48-layer stack ~6 % of max |logit| from an f32
    forward (ROADMAP.md, faults).

    params: in_proj [d, 2*d_in + 2*G*N + nh], conv [w, d_in + 2GN],
            A_log/D/dt_bias [nh], gate_norm [d_in], out_proj [d_in, d].
    """
    B, S, d = x.shape
    d_in = cfg.d_inner(d)
    nh = cfg.n_heads(d)
    G, N, hd, w = cfg.n_groups, cfg.d_state, cfg.headdim, cfg.conv_width
    conv_ch = d_in + 2 * G * N

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_ch, nh], dim=-1)
    with obs.span("ssm.f32"):
        dt = F.softplus(dt.float() + params["dt_bias"].float())
        A = -torch.exp(params["A_log"].float())

        if state is None:
            conv_tail = xBC[:, -(w - 1):, :]
            xBC = F.silu(_causal_conv(xBC.float(), params["conv"].float())
                         ).to(x.dtype)
        else:
            window = torch.cat([state.conv, xBC], dim=1)      # [B, w, C]
            conv_out = torch.einsum("bwc,wc->bc", window.float(),
                                    params["conv"].float())
            xBC = F.silu(conv_out)[:, None, :].to(x.dtype)

    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = PS.logical_constraint(xs.reshape(B, S, nh, hd),
                               ("batch", None, "heads", None))
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)

    new_state = None
    if state is None:
        if use_kernel:
            y, h_fin = ops.ssd_scan(xs, dt, A, Bm, Cm, cfg.chunk_size)
        else:
            y, h_fin = ssd_chunked(xs, dt, A, Bm, Cm, cfg.chunk_size)
        if final_state:
            new_state = SSMState(conv=conv_tail, h=h_fin)
    else:
        y1, h_next = ssd_decode_step(state.h, xs[:, 0], dt[:, 0], A,
                                     Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
        new_state = SSMState(conv=window[:, 1:, :], h=h_next)

    with obs.span("ssm.f32"):
        y = y.float() + xs.float() * params["D"].float()[None, None, :, None]
        y = y.reshape(B, S, d_in)
        y = rms_norm(y * F.silu(z.float()), params["gate_norm"], norm_eps)
    return y.to(x.dtype) @ params["out_proj"].to(x.dtype), new_state


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device] = "cpu") -> SSMState:
    d_in = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_ch = d_in + 2 * cfg.n_groups * cfg.d_state
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, nh, cfg.headdim, cfg.d_state),
                      dtype=torch.float32, device=device),
    )
