"""Kimi K2 — trillion-parameter MoE, 32B active.

[arXiv:2501.kimi2 paper-table; unverified]. 61L, d_model 7168, 64H (GQA kv=8),
expert d_ff 2048, vocab 163840, MoE 384 routed experts top-8 (+1 shared).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  every_k_layers=1, n_shared_experts=1),
    notes="DeepSeek-style routed+shared experts; spec mandates GQA (not MLA)",
)
