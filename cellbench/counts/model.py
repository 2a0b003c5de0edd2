"""Model FLOPs of a step: 6·N·tokens to train and 2·N·tokens to serve,
N the active parameters without the embedding table, as the port's
``runtime/roofline.py`` ``model_flops`` counts them (``ModelConfig.
param_counts``), frozen here over a configuration file's sizes."""
from __future__ import annotations

from typing import Any, Dict


def _is_attn(m: Dict[str, Any], i: int) -> bool:
    if m["family"] == "ssm":
        return False
    period = m.get("attn_period", 0)
    return period <= 0 or i % period == m.get("attn_offset", 0)


def active_params(m: Dict[str, Any]) -> int:
    """Active parameters of a decoder (embedding and head included)."""
    d = m["d_model"]
    h = m.get("d_head") or d // m["n_heads"]
    nq, nkv = m["n_heads"], m["n_kv_heads"]
    gated = m.get("ffn_gated", True)
    attn = d * nq * h + 2 * d * nkv * h + nq * h * d
    if m.get("qkv_bias"):
        attn += (nq + 2 * nkv) * h
    ssm = 0
    if m.get("ssm"):
        s = m["ssm"]
        d_in = s["expand"] * d
        nh = d_in // s["headdim"]
        gn = s.get("n_groups", 1) * s["d_state"]
        ssm = (d * (2 * d_in + 2 * gn + nh) + s["conv_width"] * (d_in + 2 * gn)
               + d_in * d + 2 * nh + d_in)
    moe = m.get("moe")
    total = 0
    for i in range(m["n_layers"]):
        norms = 2 * d
        mix = ssm if (m["family"] == "ssm" or not _is_attn(m, i)) else attn
        if m["family"] == "ssm":
            ffn, norms = 0, d
        elif moe and i % moe.get("every_k_layers", 1) == 0:
            one = (3 if gated else 2) * d * moe["d_ff_expert"]
            ffn = (moe["top_k"] + moe.get("n_shared_experts", 0)) * one \
                + d * moe["n_experts"]
            if moe.get("dense_residual"):
                ffn += (3 if gated else 2) * d * m["d_ff"]
        else:
            ffn = (3 if gated else 2) * d * m["d_ff"]
        total += mix + ffn + norms
    emb = m["vocab_size"] * d
    head = 0 if m.get("tie_embeddings") else emb
    return total + emb + head + d


def flops_per_token(m: Dict[str, Any], train: bool) -> float:
    """6·N (train) or 2·N (serve) with N = active parameters less the
    embedding table."""
    n = active_params(m) - m["vocab_size"] * m["d_model"]
    return (6.0 if train else 2.0) * n
