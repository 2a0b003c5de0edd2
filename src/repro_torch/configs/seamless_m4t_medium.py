"""SeamlessM4T-medium backbone — encoder-decoder, multimodal (audio).

[arXiv:2308.11596; hf]. 12L enc + 12L dec, d_model 1024, 16H (kv=16),
d_ff 4096, vocab 256206. The audio frontend is a STUB per the brief:
``input_specs()`` provides precomputed frame embeddings [B, T_src, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    ffn_gated=False,        # classic transformer ReLU/GELU FFN
    frontend="audio",
    notes="enc-dec; decoder cross-attends precomputed audio frame embeddings",
)
