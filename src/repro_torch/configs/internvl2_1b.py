"""InternVL2-1B backbone — InternViT frontend (STUB) + Qwen2-0.5B-class LM.

[arXiv:2404.16821; hf]. 24L, d_model 896, 14H (GQA kv=2), d_ff 4864,
vocab 151655. The vision frontend is a STUB per the brief:
``input_specs()`` provides precomputed patch embeddings [B, 256, d_model]
prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="Qwen2-arch LM decoder; 256 patch tokens prepended",
)
