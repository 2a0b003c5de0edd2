"""Roofline terms for one NVIDIA H100 SXM from a cell's traced cost
(``runtime.cost_analysis.analyze_cell``), as the reference's
``runtime/roofline.py`` does for TPU v5e from its compiled HLO:

  compute    t = dot_FLOPs_per_chip / 989 TFLOP/s (dense bf16 tensor cores)
  memory     t = HBM_bytes_per_chip / 3.35 TB/s (HBM3)
  collective t = collective_wire_bytes_per_chip / 450 GB/s (NVLink 4, one way)

The peaks are ``cluster/topology.py``'s, NVIDIA's data sheet figures.
MODEL_FLOPS is the analytic 6·N·D (train) / 2·N·D (inference) with
N_active for MoE, as the reference's.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.cluster.topology import (H100_BF16_FLOPS, H100_HBM_BPS,
                                          H100_NVLINK_BPS)
from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = H100_BF16_FLOPS     # bf16 per chip
HBM_BW = H100_HBM_BPS            # bytes/s per chip
LINK_BW = H100_NVLINK_BPS        # bytes/s per chip, one way


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs (global, matmul-only 6ND/2ND convention)."""
    pc = cfg.param_counts()
    n_active = pc["active"]
    # exclude embedding table from the per-token multiplier (standard 6ND
    # counts use non-embedding params; the unembed matmul IS compute)
    n_eff = n_active - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_eff * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_eff * tokens
    # decode: one token per sequence
    return 2.0 * n_eff * shape.global_batch


def roofline_report(rec: Dict, cfg: ModelConfig, shape: ShapeConfig, *,
                    peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                    link_bw: float = LINK_BW) -> Dict:
    """The three terms and the bound of ``rec`` (``{"hlo": analyze_cell's
    dict, "chips": n}``, the reference's record layout), with the
    reference's keys. ``roofline_fraction`` is the model FLOPs' share of
    the peak over the slowest term."""
    hlo = rec["hlo"]
    chips = rec["chips"]
    flops_chip = hlo["dot_flops_per_chip"]
    mem_chip = hlo["mem_bytes_per_chip"]
    coll_chip = hlo["collective_total_per_chip"]

    t_compute = flops_chip / peak_flops
    t_memory = mem_chip / hbm_bw
    t_coll = coll_chip / link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bound = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    mf_chip = mf / chips
    t_step = max(t_compute, t_memory, t_coll)
    mfu = (mf_chip / peak_flops) / t_step if t_step > 0 else 0.0

    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound": bound,
        "model_flops_global": mf,
        "hlo_flops_per_chip": flops_chip,
        "useful_flops_ratio": (mf_chip / flops_chip) if flops_chip else 0.0,
        "roofline_fraction": mfu,
        "hbm_bytes_per_chip": mem_chip,
        "collective_bytes_per_chip": coll_chip,
    }
