"""Flash attention on Hopper: a hand-written CUDA kernel for the prefill's
self-attention, with its plain torch version.

The counterpart of the reference's ``kernels/flash_attention.py::_kernel``
(the Pallas online-softmax forward) together with the layout work that
the reference's ``kernels/ops.py::flash_attention`` does around it. The
kernel, ``repro_torch/csrc/flash_attention.cu``, reads the model layout
``[B, T, H, d]`` directly, maps query head h to kv head ``h // (Hq //
Hkv)`` itself and masks ragged ends by the true lengths, so nothing is
transposed, repeated or padded here. It is built with ``nvcc`` for
``sm_90a`` at first use and bound through ``ctypes``.

What bounds it on the card: at gemma3-12b's prefill (4 x 2048 tokens, 16
query heads over 8 kv heads, head_dim 240, bf16) a layer needs ~1.3e11
tensor-core FLOP (global) or ~9.7e10 (window 1024) for 189 MB of q, k, v
and o: ~0.13 ms at 989 TFLOP/s bf16 against ~0.06 ms at 3.35 TB/s, so it
is compute-bound. The kernel is warp-specialised for Hopper: a producer
warp streams K and V tiles by TMA into two-stage rings of shared memory
guarded by mbarriers, and two consumer warpgroups run both products with
``wgmma`` (P from registers, V read transposed by the instruction),
visiting only the kv tiles the causal band and the window reach; the
source says more. TMA needs 16-byte aligned rows, which the checks below
ask for.

:func:`flash_attention` takes the plain version only for CPU tensors; on
CUDA tensors it launches the kernel or raises. ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch._build import KernelSource, load
from repro_torch.kernels.ref import flash_attention_ref

_SOURCE = KernelSource("flash_attention")
MAX_HEAD_DIM = 256                  # kMaxD in the source


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                                        + [ctypes.c_float, i32, i32, ptr])
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention.cu and its wrapper disagree on "
                           "the largest head_dim")


def _library() -> ctypes.CDLL:
    """The bound library, built and declared once per process."""
    return load(_SOURCE, _declare)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of :func:`flash_attention`: the f32 masked
    softmax of :func:`~repro_torch.kernels.ref.flash_attention_ref`, in
    the model layout."""
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)


def _check_kernel_input(name: str, x: torch.Tensor,
                        device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernel takes bfloat16; {name} is "
                         f"{x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dimension and "
                         f"16-byte aligned rows; got strides {x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Self-attention over positions ``0..T-1`` (queries) and ``0..S-1``
    (keys): q ``[B, T, Hq, d]``, k/v ``[B, S, Hkv, d]`` -> ``[B, T, Hq,
    d]`` in q's dtype. ``causal`` keeps keys ``k <= q``; ``window`` keeps
    ``q - k < window``.

    On CUDA the kernel takes bf16 with ``d % 16 == 0`` and ``d <=``
    :data:`MAX_HEAD_DIM`, any strides whose rows are 16-byte aligned.
    """
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, S, Hkv, {d}] like each other;"
                         f" got {tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv "
                         f"heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, x, dev)
    o = torch.empty((B, T, Hq, d), dtype=q.dtype, device=dev)
    if o.numel() == 0 or S == 0:
        return o.zero_()
    with torch.cuda.device(dev):
        lib = _library()
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, S,
            Hq, Hkv, d, *(s for x in (q, k, v, o) for s in x.stride()[:3]),
            1.0 / math.sqrt(d), int(causal), window or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
