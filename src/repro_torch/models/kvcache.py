"""Decode caches.

Attention sub-layers use either a full-length cache [B, S_max, nkv, h] or a
ring buffer [B, W, nkv, h] for sliding-window layers; keys are stored
post-RoPE, so slot validity/positions are derived from the scalar step
counter (no per-slot position storage). SSM sub-layers carry an
SSMState as ``{"conv", "h"}``; with an encoder every layer also holds the
encoder's cross-attention keys and values, ``{"xk", "xv"}``. The reference
stacks its cache tree over scan groups; the port keeps one dict per layer,
in layer order, as its layer stack is a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.runtime import pspec


def ring_positions(cur: int, size: int, window: bool,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Absolute positions stored in each cache slot, -1 where empty.
    cur = number of tokens already written."""
    i = torch.arange(size, device=device)
    if not window:
        return torch.where(i < cur, i, -1)
    last = cur - 1
    p = last - torch.remainder(last - i, size)
    return torch.where((i < cur) & (p >= 0), p, -1)


def cache_sizes(cfg: ModelConfig, spec: P.SubLayerSpec, s_max: int) -> int:
    if spec.is_global or cfg.sliding_window is None:
        return s_max
    return min(cfg.sliding_window, s_max)


def layer_specs(cfg: ModelConfig) -> List[P.SubLayerSpec]:
    """The sub-layer spec of every decoder layer, in order."""
    specs = P.block_specs(cfg)
    return [specs[i % len(specs)] for i in range(cfg.n_layers)]


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int,
                   enc_len: int = 0) -> List[Dict[str, torch.Tensor]]:
    """The decode cache as meta tensors (no storage), one dict per decoder
    layer: ``k``/``v`` [B, size, nkv, h] for attention, ``conv`` [B, w-1,
    conv_ch] and ``h`` [B, nh, hd, N] (f32) for SSM layers, and
    ``xk``/``xv`` [B, enc_len, nkv, h] with an encoder."""
    dtype = P.torch_dtype(cfg.dtype)
    nkv, hd = cfg.n_kv_heads, cfg.head_dim

    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    out = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            sz = cache_sizes(cfg, spec, s_max)
            sub = {"k": meta(batch, sz, nkv, hd),
                   "v": meta(batch, sz, nkv, hd)}
        else:
            s = cfg.ssm
            d_in = s.d_inner(cfg.d_model)
            conv_ch = d_in + 2 * s.n_groups * s.d_state
            sub = {"conv": meta(batch, s.conv_width - 1, conv_ch),
                   "h": meta(batch, s.n_heads(cfg.d_model), s.headdim,
                             s.d_state, dt=torch.float32)}
        if cfg.encoder_layers:
            sub["xk"] = meta(batch, enc_len, nkv, hd)
            sub["xv"] = meta(batch, enc_len, nkv, hd)
        out.append(sub)
    return out


def zero_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0,
               *, device: Union[str, torch.device] = "cpu"
               ) -> List[Dict[str, torch.Tensor]]:
    """:func:`abstract_cache` as zeroed tensors on ``device``."""
    return [{k: torch.zeros(t.shape, dtype=t.dtype, device=device)
             for k, t in sub.items()}
            for sub in abstract_cache(cfg, batch, s_max, enc_len)]


def cache_logical_axes(cfg: ModelConfig, seq_shard: bool
                       ) -> List[Dict[str, Tuple[Any, ...]]]:
    """Logical sharding axes per cache leaf, one dict per decoder layer.
    seq_shard=True shards the KV sequence dim over 'data' (long-context
    batch=1 decode). When the KV-head count does not divide the model
    axis of the active scope, the sequence dim takes the model axis
    instead (replicating a 32k cache would dominate HBM)."""
    kv_divides = (cfg.n_kv_heads % max(pspec.logical_axis_size("kv_heads"),
                                       1) == 0)
    kv_ax = "kv_heads" if kv_divides else None
    seq_ax: Any = "seq_shard" if seq_shard else None
    if not kv_divides:
        seq_ax = ("seq_shard", "seq_model") if seq_shard else "seq_model"
    out = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            sub = {"k": ("batch", seq_ax, kv_ax, None),
                   "v": ("batch", seq_ax, kv_ax, None)}
        else:
            sub = {"conv": ("batch", None, "ssm_inner"),
                   "h": ("batch", "ssm_inner", None, None)}
        if cfg.encoder_layers:
            sub["xk"] = ("batch", None, "kv_heads", None)
            sub["xv"] = ("batch", None, "kv_heads", None)
        out.append(sub)
    return out
