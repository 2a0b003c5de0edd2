"""Core NN layers: norms, RoPE, attention (naive, blockwise, flash), FFNs.

Pure functions over tensors, as in the reference's ``models/layers.py``.
Shapes use the convention
  x: [B, S, d_model]   q: [B, T, nq, h]   k/v: [B, S, nkv, h]

The attention mask is always derived from *positions* (``q_pos``/``kv_pos``)
so the same code path serves prefill, decode against a ring-buffer KV cache
(stored absolute positions, -1 = empty slot), and sliding windows.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.runtime import pspec as PS

NEG_INF = -2.0e38  # fp32-safe
ATTN_IMPLS = ("naive", "blockwise", "flash")


def check_attn_impl(impl: str) -> str:
    """``flash`` is the port's counterpart of the reference's ``pallas``;
    ``pallas`` itself, and anything else unknown, is refused."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{impl!r} (the port's kernel path is 'flash')")
    return impl


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


# ----------------------------------------------------------------- rope ----
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, n, h]; positions: [S] or [B, S] (absolute token positions).
    Rotates the split halves of the head dim (not interleaved pairs)."""
    dtype = x.dtype
    h = x.shape[-1]
    freqs = rope_freqs(h, theta, x.device)                  # [h/2]
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]   # [S, h/2]
        ang = ang[None, :, None, :]                         # [1,S,1,h/2]
    else:
        ang = positions.float()[..., None] * freqs          # [B,S,h/2]
        ang = ang[:, :, None, :]                            # [B,S,1,h/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ------------------------------------------------------------ attention ----
def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """Boolean mask [*, T, S]; True = attend. kv_pos == -1 marks empty slots."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q:[B,T,nq,h] k,v:[B,S,nkv,h] mask:[B?,T,S] -> [B,T,nq,h]."""
    B, T, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qh = q.reshape(B, T, nkv, g, h)
    scores = torch.einsum("btkgh,bskh->bkgts", qh.float(), k.float()) * scale
    while mask.dim() < 3:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, nq, h).to(v.dtype)


class _Recompute(threading.local):
    on = False


_RECOMPUTE = _Recompute()


@contextlib.contextmanager
def _recomputing():
    """The scope of a KV block's recompute (a checkpoint's ``context_fn``
    runs it on whichever thread autograd recomputes on)."""
    prev, _RECOMPUTE.on = _RECOMPUTE.on, True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


class _BlockPV(torch.autograd.Function):
    """One KV block's ``p @ v`` ([B, nkv, g, T, bk] x [B, bk, nkv, h] ->
    [B, nkv, g, T, h]) saving its two operands. In the block's recompute
    the backward needs those operands, not the product, so the product is
    not formed again, as XLA drops the reference's dead dot of its
    remat."""

    @staticmethod
    def forward(ctx, p, vb):
        ctx.save_for_backward(p, vb)
        if _RECOMPUTE.on:
            return p.new_empty(p.shape[:-1] + vb.shape[-1:])
        return torch.einsum("bkgts,bskh->bkgth", p, vb)

    @staticmethod
    def backward(ctx, g):
        p, vb = ctx.saved_tensors
        dp = dv = None
        if ctx.needs_input_grad[0]:
            dp = torch.einsum("bkgth,bskh->bkgts", g, vb)
        if ctx.needs_input_grad[1]:
            dv = torch.einsum("bkgts,bkgth->bskh", p, g)
        return dp, dv


def _kv_block(qh, kb, vb, kv_pos_b, q_pos, m, l, acc, causal, window,
              scale, remat: bool):
    """One KV block of the online softmax: the block's scores, mask,
    running max, probabilities, correction, ``l`` and ``acc`` ->
    (m, l, acc). ``remat`` forms ``p @ v`` through :class:`_BlockPV`."""
    s = torch.einsum("btkgh,bskh->bkgts", qh, kb.float()) * scale
    msk = _mask(q_pos, kv_pos_b, causal, window)            # [T, bk]
    s = torch.where(msk[None, None, None], s, NEG_INF)
    m_cur = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_cur[..., None])
    corr = torch.exp(m - m_cur)
    l = l * corr + p.sum(-1)
    pv = (_BlockPV.apply(p, vb.float()) if remat
          else torch.einsum("bkgts,bskh->bkgth", p, vb.float()))
    acc = acc * corr[..., None] + pv
    return m_cur, l, acc


def _blockwise_sdpa(q, k, v, q_pos, kv_pos, causal, window, scale,
                    block_kv: int):
    """Flash-style online-softmax loop over KV blocks. Memory O(T * block_kv).

    With grad enabled and more than one block each block's step runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    of its scan step): the backward saves no block's scores or
    probabilities, it recomputes them, ``QK^T`` once a block. One block is
    the whole row and the reference's compiled trip-1 scan recomputes
    nothing, so neither does this."""
    B, T, nq, h = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    nb = -(-S // block_kv)
    pad = nb * block_kv - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qh = q.reshape(B, T, nkv, g, h).float()
    m = torch.full((B, nkv, g, T), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, nkv, g, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nkv, g, T, h), dtype=torch.float32,
                      device=q.device)
    remat = torch.is_grad_enabled() and nb > 1
    for i in range(nb):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        args = (qh, k[:, blk], v[:, blk], kv_pos[blk], q_pos, m, l, acc,
                causal, window, scale, remat)
        m, l, acc = (checkpoint(_kv_block, *args, use_reentrant=False,
                                context_fn=_recompute_context())
                     if remat else _kv_block(*args))
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, nq, h).to(v.dtype)


def _recompute_context():
    """A KV block checkpoint's ``context_fn``: its recompute skips the
    dead ``p @ v`` and counts, inside a cell's cost trace, where its
    forward counted (``cost_analysis.recount``)."""
    from repro_torch.runtime import cost_analysis as CA
    recount = CA.recount()

    @contextlib.contextmanager
    def recompute():
        with _recomputing(), recount():
            yield
    return lambda: (contextlib.nullcontext(), recompute())


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: None, one name, or a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(entry, coord: Dict[str, int], mesh) -> Tuple[int, int]:
    """(index, count) of the block that mesh coordinate ``coord`` holds
    along a dimension whose spec entry is ``entry``: row-major over the
    entry's axes, as ``shard_map`` numbers them."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + coord[a]
        n *= mesh.shape[a]
    return idx, n


def _join(blocks: Dict[Tuple[int, ...], torch.Tensor],
          counts: Sequence[int], prefix: Tuple[int, ...] = ()
          ) -> torch.Tensor:
    """The tensor whose block ``idx`` along each dimension is
    ``blocks[idx]``, joined dimension by dimension in block order."""
    d = len(prefix)
    if d == len(counts):
        return blocks[prefix]
    parts = [_join(blocks, counts, prefix + (i,)) for i in range(counts[d])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)


def shard_map(f: Callable[..., torch.Tensor], *, mesh: PS.HostMesh,
              in_specs: Sequence[Tuple], out_specs: Tuple) -> Callable:
    """The counterpart of the reference's ``shard_map_compat`` over a
    :class:`~repro_torch.runtime.pspec.HostMesh`, as a loop: the mapped
    function calls ``f(coord, *slices)`` once per mesh coordinate, in
    row-major order, where ``coord`` maps each axis name to this
    coordinate's index on it (the counterpart of ``lax.axis_index``) and
    each argument is sliced by its spec in ``in_specs`` and moved to the
    coordinate's device. ``f`` returns one tensor; the outputs are
    assembled by ``out_specs`` on the first argument's device, and must
    tile: every coordinate's output of one shape. Along mesh axes that
    ``out_specs`` does not name the outputs are replicas and the first is
    kept, as the reference's ``check_vma=False`` takes one. There are no
    collectives: ``f`` sees only its own slices. Autograd runs through
    the slices, moves and joins.

    Under a shape-only mesh, inside a cell's cost trace and only there,
    the mapped function runs one coordinate's body on meta slices and
    returns a meta output of the joined shape
    (``runtime.cost_analysis.one_coordinate``)."""
    if not isinstance(mesh, PS.HostMesh):
        return _one_coordinate_map(f, mesh, in_specs, out_specs)

    def mapped(*args: torch.Tensor) -> torch.Tensor:
        _check_splits(args, in_specs, mesh)
        blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
        shapes = set()
        for pos in np.ndindex(*mesh.devices.shape):
            coord = dict(zip(mesh.axis_names, (int(i) for i in pos)))
            local = []
            for a, spec in zip(args, in_specs):
                for d, entry in enumerate(spec):
                    i, n = _block(entry, coord, mesh)
                    size = a.shape[d] // n
                    a = a.narrow(d, i * size, size)
                local.append(a.to(mesh.devices[pos]))
            y = f(coord, *local)
            shapes.add(tuple(y.shape))
            key = tuple(_block(e, coord, mesh)[0] for e in out_specs)
            if key not in blocks:
                blocks[key] = y.to(args[0].device)
        if len(shapes) != 1:
            raise ValueError(f"outputs of shapes {sorted(shapes)} do not "
                             f"tile")
        counts = [_block(e, dict.fromkeys(mesh.axis_names, 0), mesh)[1]
                  for e in out_specs]
        return _join(blocks, counts)

    return mapped


def _check_splits(args: Sequence[torch.Tensor], in_specs: Sequence[Tuple],
                  mesh) -> None:
    """Raises unless there is one spec an argument and each spec's mesh
    axes divide the dimension they split."""
    if len(args) != len(in_specs):
        raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                         f"in_specs")
    origin = dict.fromkeys(mesh.axis_names, 0)
    for a, spec in zip(args, in_specs):
        for d, entry in enumerate(spec):
            if a.shape[d] % _block(entry, origin, mesh)[1]:
                raise ValueError(f"dimension {d} of {tuple(a.shape)} does "
                                 f"not split over {_axes(entry)}")


def _one_coordinate_map(f: Callable[..., torch.Tensor], mesh,
                        in_specs: Sequence[Tuple], out_specs: Tuple
                        ) -> Callable:
    from repro_torch.runtime import cost_analysis as CA
    if CA.active() is None:
        raise TypeError(f"shard_map needs a HostMesh, not "
                        f"{type(mesh).__name__}: a shape-only mesh places "
                        f"nothing (outside a cell's cost trace)")

    def mapped(*args: torch.Tensor) -> torch.Tensor:
        _check_splits(args, in_specs, mesh)
        return CA.one_coordinate(
            lambda coord, *local: (f(coord, *local),), CA.corners(mesh),
            args, in_specs, (out_specs,))[0]

    return mapped


def rank_attention(q, k, v, *, q_start: int, causal: bool,
                   window: Optional[int], impl: str,
                   block_kv: int) -> torch.Tensor:
    """One rank of :func:`seq_parallel_attention`: queries q [B, Sl, nq,
    h] at positions ``q_start .. q_start + Sl - 1`` over the whole
    sequence's k/v [B, S_kv, nkv, h] at positions ``0 .. S_kv - 1``.

    A causal sliding window with ``Sl + window < S_kv`` attends a band:
    this rank's queries see only [q_start - window + 1, q_start + Sl), so
    the ``Sl + window`` keys from ``clip(q_start - window, 0, S_kv -
    band)`` are sliced out (gemma3-12b's local layers at 4 x 2048 tokens
    over 4 ranks: 1536 of 2048 keys a rank). Then the naive path for
    ``impl == "naive"`` or a key length of at most ``block_kv``, else the
    blockwise one (``flash`` included, as the reference sends
    ``pallas`` there: its kernel takes no query offset)."""
    Sl, S_kv = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_pos = q_start + torch.arange(Sl, device=q.device)
    start = 0
    if window is not None and causal and Sl + window < S_kv:
        band = Sl + window
        start = min(max(q_start - window, 0), S_kv - band)
        k, v = k[:, start:start + band], v[:, start:start + band]
    kv_pos = start + torch.arange(k.shape[1], device=q.device)
    if impl == "naive" or k.shape[1] <= block_kv:
        return _sdpa(q, k, v, _mask(q_pos, kv_pos, causal, window), scale)
    return _blockwise_sdpa(q, k, v, q_pos, kv_pos, causal, window, scale,
                           block_kv)


def seq_parallel_attention(q, k, v, *, causal: bool, window: Optional[int],
                           impl: str, block_kv: int) -> torch.Tensor:
    """Context-parallel self-attention (the reference's
    ``seq_parallel_attention``): the QUERY sequence splits over the
    'model' axis of the active :class:`~repro_torch.runtime.pspec.HostMesh`
    (``seq_model``), the batch over the batch axes, k/v are whole on every
    rank; rank ``r`` of the model axis attends its queries from position
    ``r * Sl`` (:func:`rank_attention`) and the ranks' outputs join in
    order (:func:`shard_map`). Chosen where splitting the heads would pad
    the KV heads over the model axis (``use_seq_parallel``)."""
    spec_q = PS.resolve(("batch", "seq_model", None, None), shape=q.shape)
    spec_kv = PS.resolve(("batch", None, None, None), shape=k.shape)
    if spec_q[1] is None:
        raise ValueError(f"no model axis splits the sequence of "
                         f"{q.shape[1]} under the active scope")
    mesh = PS.active_mesh()

    def local(coord, ql, kl, vl):
        r, _ = _block(spec_q[1], coord, mesh)
        return rank_attention(ql, kl, vl, q_start=r * ql.shape[1],
                              causal=causal, window=window, impl=impl,
                              block_kv=block_kv)

    return shard_map(local, mesh=mesh, in_specs=(spec_q, spec_kv, spec_kv),
                     out_specs=spec_q)(q, k, v)


def use_seq_parallel(q, k) -> bool:
    """The reference's predicate for context-parallel self-attention: an
    active mesh whose rules replicate the heads over 'model'
    (``pspec.seq_attn_rules``, or ``"fsdp"``) while the cache's sequence
    splits over a model axis larger than 1, on a full self-attention
    (T == S) whose length that axis divides. Under ``"2d"`` heads map to
    'model', so it never holds."""
    if PS.active_mesh() is None:
        return False
    if PS.logical_axis_size("heads") != 1:
        return False                       # heads are model-sharded
    n_model = PS.logical_axis_size("seq_model")
    if n_model <= 1:
        return False
    S, T = k.shape[1], q.shape[1]
    return T == S and S % n_model == 0


def attention(q, k, v, *, q_pos, kv_pos, causal: bool = True,
              window: Optional[int] = None, impl: str = "blockwise",
              block_kv: int = 1024) -> torch.Tensor:
    """Grouped-query attention; see module docstring for shapes. ``flash``
    takes self-attention (``T == S``, positions ``0..T-1``) to the kernel."""
    check_attn_impl(impl)
    scale = 1.0 / math.sqrt(q.shape[-1])
    T, S = q.shape[1], k.shape[1]
    if impl == "flash" and T > 1 and T == S:
        return ops.flash_attention(q, k, v, causal, window)
    if T == 1 or impl == "naive" or S <= block_kv:
        return _sdpa(q, k, v, _mask(q_pos, kv_pos, causal, window), scale)
    return _blockwise_sdpa(q, k, v, q_pos, kv_pos, causal, window, scale,
                           block_kv)


def attention_projections(params: Dict[str, torch.Tensor], x, *, n_heads,
                          n_kv_heads, head_dim):
    """x:[B,S,d] -> q:[B,S,nq,h], k,v:[B,S,nkv,h] using fused wqkv; the
    three are views into one projection."""
    B, S, _ = x.shape
    qkv = x @ params["wqkv"].to(x.dtype)
    if "bqkv" in params:
        qkv = qkv + params["bqkv"].to(x.dtype)
    q_sz = n_heads * head_dim
    kv_sz = n_kv_heads * head_dim
    q, k, v = torch.split(qkv, [q_sz, kv_sz, kv_sz], dim=-1)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


# ----------------------------------------------------------------- ffn -----
def ffn(params: Dict[str, torch.Tensor], x, *,
        gated: bool = True) -> torch.Tensor:
    if gated:
        h = F.silu(x @ params["wg"].to(x.dtype)) * (
            x @ params["wu"].to(x.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wu"].to(x.dtype), approximate="tanh")
    return h @ params["wd"].to(x.dtype)
