"""Mamba-2 SSD chunk scan on Hopper: a hand-written CUDA kernel for the
training path's state-space scan, with its plain torch version.

The counterpart of the reference's ``kernels/ssd_scan.py::_kernel`` (the
Pallas chunk scan with the state carried in VMEM) together with the
layout work that the reference's ``kernels/ops.py::ssd_scan`` does around
it: the kernel, ``repro_torch/csrc/ssd_scan.cu``, reads the model layout
``x [B, S, nh, hd]``, ``B/C [B, S, 1, N]`` with strides, so nothing is
transposed here. It is built with ``nvcc`` for ``sm_90a`` at first use and
bound through ``ctypes``.

The plain version is :func:`ssd_chunked`, the reference's chunked SSD
algorithm (``models/ssm.py::ssd_chunked`` there; the port's model code
imports it from here). It computes the same function as the kernel and as
the sequential oracle :func:`~repro_torch.kernels.ref.ssd_scan_ref`.

What bounds the kernel on the card: at mamba2-370m's training shapes (8 x
2048 tokens, 32 heads of 64, d_state 128, chunk 256) a call needs ~4.3e10
FLOP (the upper triangle of C Bᵀ skipped) for ~150 MB: ~0.045 ms for the
bytes at 3.35 TB/s, ~0.043 ms at the bf16 tensor-core peak. The source
runs it as four passes that are parallel over chunks (C Bᵀ once per
chunk for all heads; each chunk's own state; the recurrence over chunks;
the outputs), with every product on the tensor cores and each computed
f32 operand split into a bf16 high part and remainder; a call launches
the four kernels in order and counts one launch.

:func:`ssd_scan` takes the plain version only for CPU tensors; on CUDA
tensors it launches the kernels or raises. ``ssd_scan.launches`` counts
calls that launched them (one per call, for the four passes).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch._build import KernelSource, load

_SOURCE = KernelSource("ssd_scan")
# The largest chunk, head_dim and d_state the kernel takes: kMaxQ, kMaxHD
# and kMaxN in csrc/ssd_scan.cu, which must be changed with these.
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [i64] * 13 + [ptr]
    lib.ssd_scan_workspace_bytes.argtypes = [i32] * 6
    lib.ssd_scan_workspace_bytes.restype = i64
    lib.ssd_scan_smem_bytes.argtypes = [i32] * 3
    lib.ssd_scan_smem_bytes.restype = i32
    lib.ssd_scan_fwd.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    """The bound library, built and declared once per process."""
    return load(_SOURCE, _declare)


# ------------------------------------------------------------ plain version --
def _segsum_decay(dt_a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt_a: [..., Q, nh] per-step log decay. Returns (cumsum [..., Q, nh],
    the within-chunk decay matrix L [..., Q, Q, nh] with
    L[i, j] = exp(cs_i - cs_j), lower-triangular inclusive).

    The exponent is masked before ``exp``, not after as the reference
    does: above the diagonal cs_i - cs_j > 0 can overflow, and the
    gradient of a masked-after inf is 0 * inf = NaN."""
    cs = torch.cumsum(dt_a, dim=-2)
    diff = cs[..., :, None, :] - cs[..., None, :, :]
    q = dt_a.shape[-2]
    tri = torch.ones((q, q), dtype=torch.bool, device=dt_a.device).tril()
    return cs, torch.exp(diff.masked_fill(~tri[..., None], -math.inf))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32, the plain version of :func:`ssd_scan`.

    x [B, S, nh, hd]; dt [B, S, nh] (post-softplus, > 0); A [nh] (< 0);
    Bm/Cm [B, S, G, N] with heads ``g * (nh // G) ...`` reading group g.
    Returns (y [B, S, nh, hd] in x's dtype, h_final [B, nh, hd, N] f32).
    The heads are split as (G, nh // G) and broadcast against B and C
    rather than repeated, so nothing of size nh x N is copied.
    """
    bsz, s, nh, hd = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = nh // g
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"seq {s} is not divisible by chunk {chunk}")
    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, g, rep, hd).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, nh).to(f32)
    bc = Bm.reshape(bsz, nc, chunk, g, n).to(f32)
    cc = Cm.reshape(bsz, nc, chunk, g, n).to(f32)

    cs, L = _segsum_decay(dtc * A.to(f32))       # [B,nc,Q,nh], [B,nc,Q,Q,nh]
    total = cs[:, :, -1, :]                       # [B,nc,nh]

    # within-chunk (quadratic) term
    cb = torch.einsum("bcign,bcjgn->bcgij", cc, bc)           # [B,nc,G,Q,Q]
    m = cb[:, :, :, None] * L.permute(0, 1, 4, 2, 3).reshape(
        bsz, nc, g, rep, chunk, chunk)
    m = m * dtc.permute(0, 1, 3, 2).reshape(bsz, nc, g, rep, 1, chunk)
    y_diag = torch.einsum("bcgrij,bcjgrp->bcigrp", m, xc)

    # chunk state contributions: sum_j exp(total - cs_j) dt_j x_j (x) B_j
    w = (torch.exp(total[:, :, None, :] - cs) * dtc).reshape(
        bsz, nc, chunk, g, rep)
    sc = torch.einsum("bcjgr,bcjgrp,bcjgn->bcgrpn", w, xc, bc).reshape(
        bsz, nc, nh, hd, n)

    # cross-chunk recurrence; each chunk reads the state before it
    h = torch.zeros((bsz, nh, hd, n), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + sc[:, c]
    hp = torch.stack(h_prevs, dim=1).reshape(bsz, nc, g, rep, hd, n)

    # inter-chunk output term
    decay_in = torch.exp(cs).reshape(bsz, nc, chunk, g, rep)
    y_off = torch.einsum("bcign,bcgrpn,bcigr->bcigrp", cc, hp, decay_in)
    y = (y_diag + y_off).reshape(bsz, s, nh, hd)
    return y.to(x.dtype), h


# ------------------------------------------------------------------ wrapper --
def _check_kernel_input(name: str, t: torch.Tensor, dtype: torch.dtype,
                        device: torch.device, aligned: bool) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"the SSD kernel takes {name} in {dtype}; got "
                         f"{t.dtype}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} needs a contiguous last dimension; got "
                         f"strides {t.stride()}")
    if aligned and (any(st % 8 for st in t.stride()[:-1])
                    or t.data_ptr() % 16):
        raise ValueError(f"{name} needs 16-byte aligned rows; got strides "
                         f"{t.stride()}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in the model layout: x ``[B, S, nh, hd]``, dt ``[B, S,
    nh]``, A ``[nh]``, Bm/Cm ``[B, S, 1, N]`` -> (y ``[B, S, nh, hd]`` in
    x's dtype, h_final ``[B, nh, hd, N]`` f32), the state starting at zero.

    One B/C group (``n_groups == 1``, Mamba-2's default) and ``S % chunk
    == 0``, as the reference asserts, else ``ValueError``. On CUDA the
    kernel takes bf16 x, B and C and f32 dt and A, ``chunk % 64 == 0`` up
    to :data:`MAX_CHUNK`, ``hd % 16 == 0`` up to :data:`MAX_HEAD_DIM` and
    ``N % 16 == 0`` up to :data:`MAX_STATE`, any strides whose rows are
    16-byte aligned.
    """
    bsz, s, nh, hd = x.shape
    if Bm.dim() != 4 or Bm.shape[:2] != (bsz, s) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be [B, S, G, N] like each other; "
                         f"got {tuple(Bm.shape)} and {tuple(Cm.shape)}")
    if Bm.shape[2] != 1:
        raise ValueError(f"the SSD scan takes n_groups == 1 (Mamba-2's "
                         f"default); got {Bm.shape[2]} groups")
    if dt.shape != (bsz, s, nh) or A.shape != (nh,):
        raise ValueError(f"dt must be [B, S, nh] and A [nh]; got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} is not divisible by chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {dev}")
    n = Bm.shape[3]
    if chunk % 64 or chunk > MAX_CHUNK or hd % 16 or hd > MAX_HEAD_DIM \
            or n % 16 or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunk % 64 == 0 up to "
                         f"{MAX_CHUNK}, head_dim % 16 == 0 up to "
                         f"{MAX_HEAD_DIM} and d_state % 16 == 0 up to "
                         f"{MAX_STATE}; got {chunk}, {hd}, {n}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        _check_kernel_input(name, t, torch.bfloat16, dev, aligned=True)
    for name, t in (("dt", dt), ("A", A)):
        _check_kernel_input(name, t, torch.float32, dev, aligned=False)
    A = A.contiguous()
    y = torch.empty((bsz, s, nh, hd), dtype=x.dtype, device=dev)
    h = torch.empty((bsz, nh, hd, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, h.zero_()
    with torch.cuda.device(dev):
        lib = _library()
        # C B^T per chunk, cs per head and the chunk states (csrc says more)
        work = torch.empty(lib.ssd_scan_workspace_bytes(bsz, s, nh, hd, n,
                                                        chunk),
                           dtype=torch.uint8, device=dev)
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h.data_ptr(), work.data_ptr(), bsz,
            s, nh, hd, n, chunk, *x.stride()[:3], *dt.stride(),
            *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({err})")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
