"""A throwaway benchmark root at CPU-test size, made from files alone: a
``BENCHMARK.json`` whose cells are tiny copies of the real ones (same
families, mixes of the same kinds, the same metrics), with their
configuration, traffic and limit files. The harness reads it through
``--root`` and runs it with ``--device cpu``."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from cellbench.bench import ROOT

TRAIN, SERVE = "tiny-ssm.tiny-train", "tiny-hybrid.tiny-serve"
REAL = {"mamba2-370m.train-8x2048": TRAIN,
        "jamba-v0.1-52b-16l.serve-coding": SERVE}

CONFIGS: Dict[str, Dict] = {
    "tiny-ssm": {
        "family": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 1,
        "n_kv_heads": 1, "d_ff": 0, "vocab_size": 256,
        "ssm": {"d_state": 16, "headdim": 16, "expand": 2, "conv_width": 4,
                "chunk_size": 32, "n_groups": 1},
        "tie_embeddings": True, "dtype": "float32",
        "run": {"attn_impl": "flash", "remat": "block", "lr": 3e-4,
                "warmup_steps": 100, "total_steps": 1000, "beta1": 0.9,
                "beta2": 0.95, "weight_decay": 0.1, "grad_clip": 1.0}},
    "tiny-hybrid": {
        "family": "hybrid", "n_layers": 8, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 1, "d_head": 16, "d_ff": 128, "vocab_size": 256,
        "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 128,
                "every_k_layers": 2, "capacity_factor": 1.25},
        "ssm": {"d_state": 16, "headdim": 16, "expand": 2, "conv_width": 4,
                "chunk_size": 32, "n_groups": 1},
        "attn_period": 8, "attn_offset": 4, "rope_theta": 0.0,
        "dtype": "float32",
        "run": {"attn_impl": "flash", "remat": "none", "lr": 3e-4,
                "warmup_steps": 100, "total_steps": 1000, "beta1": 0.9,
                "beta2": 0.95, "weight_decay": 0.1, "grad_clip": 1.0}},
}
TRAFFIC: Dict[str, Dict] = {
    "tiny-train": {"kind": "train", "batch": 2, "seq_len": 64,
                   "first_steps": 3},
    "tiny-serve": {"kind": "serve", "loop": "closed", "clients": 3,
                   "prompt_tokens": {"dist": "loguniform", "lo": 32,
                                     "hi": 96, "multiple": 32},
                   "output_tokens": {"dist": "loguniform", "lo": 2, "hi": 6},
                   "block": 6},
}
# float32 program against the float32 reference on the CPU: the gaps are
# round-off; the limits sit far under what the control and the faults read
LIMITS: Dict[str, Dict] = {
    TRAIN: {"numbers": {"grad1": {"limit": 1e-3}, "change": {"limit": 1e-2}}},
    SERVE: {"sample_tokens": 10,
            "numbers": {"logit_gap_mean": {"limit": 1e-3}}},
}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_root(root: Path) -> Path:
    """Write the tiny benchmark under ``root`` and return it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        write(root / "cellbench" / "configs" / f"{name}.json", cfg)
    for name, mix in TRAFFIC.items():
        write(root / "cellbench" / "traffic" / f"{name}.json", mix)
    for name, lim in LIMITS.items():
        write(root / "cellbench" / "limits" / f"{name}.json", lim)
    spec["configs"] = [{"name": n, "source": "cellbench/testing.py",
                        "file": f"cellbench/configs/{n}.json", "reduced": [],
                        "why": "CPU test size"} for n in CONFIGS]
    spec["workloads"] = [
        {"name": TRAIN, "config": "tiny-ssm", "traffic": "tiny-train",
         "chips": 1, "why": "CPU test size"},
        {"name": SERVE, "config": "tiny-hybrid", "traffic": "tiny-serve",
         "chips": 1, "why": "CPU test size"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({REAL[w] for w in m["workloads"]
                                     if w in REAL})
    write(root / "BENCHMARK.json", spec)
    return root
