"""StarCoder2-15B — dense GQA code model. [arXiv:2402.19173; hf].

40L, d_model 6144, 48H (GQA kv=4), d_ff 24576, vocab 49152, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    ffn_gated=False,        # StarCoder2 uses a plain GELU MLP
    rope_theta=100_000.0,
    notes="GQA kv=4, RoPE theta 1e5",
)
