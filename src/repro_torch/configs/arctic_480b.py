"""Snowflake Arctic 480B — dense-MoE hybrid: 128 experts top-2 in parallel
with an always-on dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]. 35L, d_model 7168, 56H (GQA kv=8),
dense d_ff 4864, vocab 32000, MoE 128e top-2 (expert d_ff 4864).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  every_k_layers=1, dense_residual=True),
    notes="dense residual FFN parallel to the MoE branch on every layer",
)
