"""Decode caches.

Attention sub-layers use either a full-length cache [B, S_max, nkv, h] or a
ring buffer [B, W, nkv, h] for sliding-window layers; keys are stored
post-RoPE, so slot validity/positions are derived from the scalar step
counter (no per-slot position storage). The reference stacks its cache
tree over scan groups; the port keeps one ``{"k", "v"}`` dict per layer,
in layer order, as its layer stack is a Python loop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P

_NOT_PORTED = ("{} caches come with the {} slice of the port (ROADMAP.md, "
               "queue 1)")


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


def zero_cache(cfg: ModelConfig, batch: int, s_max: int, *,
               device: Union[str, torch.device] = "cpu"
               ) -> List[Dict[str, torch.Tensor]]:
    """One zeroed ``{"k", "v"}`` cache per decoder layer."""
    if cfg.encoder_layers:
        raise NotImplementedError(_NOT_PORTED.format(
            "Cross-attention", "encoder-decoder"))
    dtype = P.torch_dtype(cfg.dtype)
    out = []
    for spec in layer_specs(cfg):
        if spec.mixer != "attn":
            raise NotImplementedError(_NOT_PORTED.format("SSM",
                                                         "SSM serving"))
        shape = (batch, cache_sizes(cfg, spec, s_max), cfg.n_kv_heads,
                 cfg.head_dim)
        out.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)})
    return out
