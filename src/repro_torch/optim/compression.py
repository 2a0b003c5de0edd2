"""Gradient/delta compression for the cross-pod (DCN) sync — the traffic
class the paper's scheduler governs. int8 quantization (~4× fewer bytes)
and top-k sparsification with error feedback (~1/k_frac fewer bytes).
Compression composes with time shifting: fewer bytes AND greener bytes.

The reference's ``optim/compression.py`` over the port's state dicts
(``{name: tensor}``) in place of pytrees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


# ----------------------------------------------------------------- int8 ----
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ----------------------------------------------------------------- top-k ---
def compress_topk(x: torch.Tensor, k_frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    k = max(int(flat.shape[0] * k_frac), 1)
    idx = torch.topk(torch.abs(flat), k).indices
    return flat[idx], idx


def decompress_topk(vals: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = torch.zeros(int(torch.Size(shape).numel()), dtype=vals.dtype,
                       device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


# ------------------------------------------------------------- tree-level --
@dataclasses.dataclass
class CompressionState:
    """Error-feedback residuals (one per leaf) for top-k."""
    residual: Dict[str, torch.Tensor]


def init_compression_state(tree: Tree) -> CompressionState:
    return CompressionState(residual={
        k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for k, x in tree.items()})


def compress_tree(tree: Tree, scheme: str, *, k_frac: float = 0.01,
                  state: Optional[CompressionState] = None):
    """Returns (payload, new_state, bytes_on_wire)."""
    if scheme == "none":
        return dict(tree), state, sum(x.numel() * 4 for x in tree.values())
    if scheme == "int8":
        out = {k: quantize_int8(x.float()) for k, x in tree.items()}
        return out, state, sum(x.numel() + 4 for x in tree.values())
    if scheme == "topk":
        if state is None:
            raise ValueError("topk needs error-feedback state")
        payload, res, n = {}, {}, 0
        for k, x in tree.items():
            xe = x.float() + state.residual[k]
            vals, idx = compress_topk(xe, k_frac)
            res[k] = xe - decompress_topk(vals, idx, xe.shape)
            payload[k] = (vals, idx, xe.shape)
            n += vals.numel() * 8            # 4B value + 4B index
        return payload, CompressionState(res), n
    raise ValueError(scheme)


def decompress_tree(payload, scheme: str) -> Dict[str, torch.Tensor]:
    if scheme == "none":
        return dict(payload)
    if scheme == "int8":
        return {k: dequantize_int8(*qs) for k, qs in payload.items()}
    if scheme == "topk":
        return {k: decompress_topk(*vis) for k, vis in payload.items()}
    raise ValueError(scheme)


def tree_bytes(tree: Tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())
