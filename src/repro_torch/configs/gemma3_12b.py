"""Gemma-3 12B — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*; unverified]. 48L, d_model 3840, 16H (GQA kv=8),
d_ff 15360, vocab 262144, sliding window 1024 on local layers,
every 6th layer global.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_period=6,
    rope_theta=1_000_000.0,
    notes="5:1 local:global; local layers window=1024 -> sub-quadratic KV",
)
