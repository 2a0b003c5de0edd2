"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]. 32L, d_model 4096, 32H (GQA kv=8), d_ff 14336,
vocab 65536. One attention layer per 8 (attn:mamba = 1:7); MoE on every
other layer (e/o per the Jamba paper), 16 experts top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every_k_layers=2),
    ssm=SSMConfig(d_state=16, headdim=64, expand=2, conv_width=4, chunk_size=256),
    attn_period=8,
    attn_offset=4,          # Jamba places the attn layer mid-block
    rope_theta=0.0,         # Jamba attention layers are NoPE (no positional enc.)
    notes="Mamba+attn 1:7 interleave, MoE every other layer",
)
