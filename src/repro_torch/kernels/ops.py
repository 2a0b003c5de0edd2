"""Differentiable wrappers around the port's kernels.

The counterpart of the reference's ``kernels/ops.py``: each kernel becomes
a ``torch.autograd.Function`` whose forward runs the kernel (its wrapper
takes the plain version for CPU tensors) and whose backward recomputes the
function with autograd through a plain torch version, the reference's
recompute-backward pattern until a dedicated backward kernel lands. The
layout work that ``ops.py`` does there is in the kernel wrappers here:
both kernels read the model layout with strides.

* :func:`flash_attention` recomputes through
  :func:`~repro_torch.kernels.ref.flash_attention_ref`, as ``_fa_bwd``
  does.
* :func:`ssd_scan` recomputes through the chunked
  :func:`~repro_torch.kernels.ssd_scan.ssd_chunked`, not through the
  sequential oracle that the reference's ``_ssd_bwd`` uses: the two
  compute the same function, and in eager torch the sequential scan would
  keep one state per token (2,048 of 8.4 MB per layer at mamba2-370m's
  training shapes) and launch thousands of kernels per layer.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def _recompute_grads(fn, inputs: Sequence[torch.Tensor],
                     needs: Sequence[bool], grads_out):
    """Gradients of ``fn(*inputs)`` for the inputs flagged in ``needs``,
    recomputed with autograd; ``None`` output gradients are skipped."""
    leaves = [t.detach().requires_grad_(need) for t, need in
              zip(inputs, needs)]
    with torch.enable_grad():
        outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    wanted = [t for t in leaves if t.requires_grad]
    if not pairs or not wanted:
        return [None] * len(leaves)
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in leaves]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _fa.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v):
            return _fa.flash_attention_plain(q, k, v, causal=ctx.causal,
                                             window=ctx.window)
        return (*_recompute_grads(plain, ctx.saved_tensors,
                                  ctx.needs_input_grad[:3], (g,)),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q ``[B, T, Hq, d]``, k/v ``[B, S, Hkv, d]`` -> ``[B, T, Hq, d]``
    (model layout), differentiable; see
    :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    return _FlashAttention.apply(q, k, v, causal, window)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        def plain(x, dt, A, Bm, Cm):
            return _ssd.ssd_chunked(x, dt, A, Bm, Cm, ctx.chunk)
        return (*_recompute_grads(plain, ctx.saved_tensors,
                                  ctx.needs_input_grad[:5], (gy, gh)),
                None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x ``[B, S, nh, hd]``, dt ``[B, S, nh]``, Bm/Cm ``[B,
    S, 1, N]`` -> (y ``[B, S, nh, hd]``, h_final ``[B, nh, hd, N]``),
    differentiable; see :func:`repro_torch.kernels.ssd_scan.ssd_scan`."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
