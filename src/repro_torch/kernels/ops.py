"""Differentiable wrappers around the port's kernels.

The counterpart of the reference's ``kernels/ops.py``: each kernel becomes
a ``torch.autograd.Function`` whose forward runs the kernel (its wrapper
takes the plain version for CPU tensors). The layout work that ``ops.py``
does there is in the kernel wrappers here: both kernels read the model
layout with strides.

* :func:`flash_attention` recomputes its backward with autograd through
  :func:`~repro_torch.kernels.ref.flash_attention_ref`, as ``_fa_bwd``
  does.
* :func:`ssd_scan` keeps the forward kernels' scratch (C Bᵀ per chunk, cs
  per head, the state entering each chunk) and takes its backward from
  :func:`~repro_torch.kernels.ssd_scan.ssd_scan_bwd`: on CUDA the backward
  kernels, which read that scratch and run no forward pass again; on the
  CPU its plain closed form
  :func:`~repro_torch.kernels.ssd_scan.ssd_chunked_bwd`. The reference's
  ``_ssd_bwd`` recomputes through the sequential oracle instead. On meta
  tensors the backward recomputes through the chunked
  :func:`~repro_torch.kernels.ssd_scan.ssd_chunked` with autograd, so that
  a meta trace (the dry run, held to the reference's recompute) counts
  what it counted before the kernels; ``chip_smoke.py``'s
  ``ssd_backward_gap`` gives what it counts beyond them.
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
        y, h, work = _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk, scratch=True)
        # only the CUDA kernels' scratch feeds the backward
        ctx.save_for_backward(x, dt, A, Bm, Cm, work if x.is_cuda else None)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        *ins, work = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        if ins[0].device.type == "meta":
            def plain(x, dt, A, Bm, Cm):
                return _ssd.ssd_chunked(x, dt, A, Bm, Cm, ctx.chunk)
            return (*_recompute_grads(plain, ins, needs, (gy, gh)), None)
        if (gy is None and gh is None) or not any(needs):
            return (None,) * 6
        grads = _ssd.ssd_scan_bwd(*ins, ctx.chunk, gy, gh, work)
        return (*(g if need else None for g, need in zip(grads, needs)),
                None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x ``[B, S, nh, hd]``, dt ``[B, S, nh]``, Bm/Cm ``[B,
    S, 1, N]`` -> (y ``[B, S, nh, hd]``, h_final ``[B, nh, hd, N]``),
    differentiable; see :func:`repro_torch.kernels.ssd_scan.ssd_scan`."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
