"""Mamba2-370m — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified]. 48L, d_model 1024, d_ff 0 (no separate FFN;
the Mamba block carries the channel mixing), vocab 50280, ssm_state 128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,              # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk_size=256),
    tie_embeddings=True,
    notes="SSD; decode state is O(1) per layer",
)
