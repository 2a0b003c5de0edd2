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

from typing import Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.ssm import init_ssm_state


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


def zero_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0,
               *, device: Union[str, torch.device] = "cpu"
               ) -> List[Dict[str, torch.Tensor]]:
    """One zeroed cache dict per decoder layer: ``k``/``v`` [B, size, nkv,
    h] for attention, ``conv`` [B, w-1, conv_ch] and ``h`` [B, nh, hd, N]
    (f32) for SSM layers, and ``xk``/``xv`` [B, enc_len, nkv, h] with an
    encoder."""
    dtype = P.torch_dtype(cfg.dtype)
    nkv, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    out = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            sz = cache_sizes(cfg, spec, s_max)
            sub = {"k": zeros(batch, sz, nkv, hd),
                   "v": zeros(batch, sz, nkv, hd)}
        else:
            st = init_ssm_state(batch, cfg.d_model, cfg.ssm, dtype, device)
            sub = {"conv": st.conv, "h": st.h}
        if cfg.encoder_layers:
            sub["xk"] = zeros(batch, enc_len, nkv, hd)
            sub["xv"] = zeros(batch, enc_len, nkv, hd)
        out.append(sub)
    return out
