"""Core NN layers: norms, RoPE, attention (naive, blockwise, flash), FFNs.

Pure functions over tensors, as in the reference's ``models/layers.py``.
Shapes use the convention
  x: [B, S, d_model]   q: [B, T, nq, h]   k/v: [B, S, nkv, h]

The attention mask is always derived from *positions* (``q_pos``/``kv_pos``)
so the same code path serves prefill, decode against a ring-buffer KV cache
(stored absolute positions, -1 = empty slot), and sliding windows.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

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


def _blockwise_sdpa(q, k, v, q_pos, kv_pos, causal, window, scale,
                    block_kv: int):
    """Flash-style online-softmax loop over KV blocks. Memory O(T * block_kv)."""
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
    for i in range(nb):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        s = torch.einsum("btkgh,bskh->bkgts", qh, k[:, blk].float()) * scale
        msk = _mask(q_pos, kv_pos[blk], causal, window)     # [T, bk]
        s = torch.where(msk[None, None, None], s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m - m_cur)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", p, v[:, blk].float())
        m = m_cur
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, nq, h).to(v.dtype)


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
