"""Config dataclasses for models, shapes, meshes and runs.

Every assigned architecture is expressed as a ``ModelConfig``; the four
input-shape regimes are ``ShapeConfig``s. ``reduced()`` produces the
CPU-smoke-testable shrink of any config (same family / wiring, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts wiring."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    # every k-th layer is MoE (1 = every layer). Non-MoE layers use dense d_ff.
    every_k_layers: int = 1
    # Arctic-style dense FFN residual running in parallel with the MoE branch.
    dense_residual: bool = False
    # DeepSeek/Kimi-style always-on shared experts.
    n_shared_experts: int = 0
    # router options
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block wiring (arXiv:2405.21060)."""
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None     # defaults to d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): one attention layer per `attn_period` layers, rest SSM.
    attn_period: int = 0             # 0 = homogeneous (all attn or all ssm)
    attn_offset: int = 0             # index within each period that is attention
    # local:global attention (Gemma-3): every `global_period`-th layer is global,
    # the rest use `sliding_window`.
    sliding_window: Optional[int] = None
    global_period: int = 0           # 0 = all layers global
    # encoder-decoder
    encoder_layers: int = 0          # >0 => enc-dec; n_layers = decoder layers
    # frontends (stubs per the brief: precomputed embeddings are inputs)
    frontend: Optional[str] = None   # None | 'audio' | 'vision'
    n_frontend_tokens: int = 0       # VLM: patch tokens prepended to the text
    qkv_bias: bool = False           # Qwen1.5
    ffn_gated: bool = True           # SwiGLU (False => 2-matrix GELU FFN)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # True if *every* attention layer is full/global attention (controls the
    # long_500k sub-quadratic skip rule).
    notes: str = ""

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decoder (enc-dec included)

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid stacks: is decoder layer `layer_idx` an attention layer?"""
        if self.family == "ssm":
            return False
        if self.attn_period <= 0:
            return True
        return layer_idx % self.attn_period == self.attn_offset

    def is_global_attn_layer(self, layer_idx: int) -> bool:
        if self.global_period <= 0:
            return True
        return layer_idx % self.global_period == self.global_period - 1

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.every_k_layers == 0

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is tractable (SSM / hybrid / mostly-local)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None and self.global_period > 0

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----
    def param_counts(self) -> dict:
        """Returns {'total': N, 'active': N_active} parameter counts."""
        d, h = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        out_head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            p = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * h
            return p

        def dense_ffn(d_ff: int) -> int:
            # SwiGLU: gate, up, down; non-gated: up, down
            return (3 if self.ffn_gated else 2) * d * d_ff

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.d_inner(d)
            nh = s.n_heads(d)
            zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
            conv = s.conv_width * (d_in + 2 * s.n_groups * s.d_state)
            out = d_in * d
            extra = 2 * nh + d_in  # A_log, D, dt_bias-ish
            return zxbcdt + conv + out + extra

        total = active = 0
        n_dec = self.n_layers
        for li in range(n_dec):
            norms = 2 * d
            if self.family == "ssm" or (self.attn_period > 0 and not self.is_attn_layer(li)):
                mix_t = mix_a = ssm_params()
            else:
                mix_t = mix_a = attn_params()
            if self.family == "ssm":
                ffn_t = ffn_a = 0
                norms = d
            elif self.is_moe_layer(li):
                m = self.moe
                one = (3 if self.ffn_gated else 2) * d * m.d_ff_expert
                ffn_t = m.n_experts * one + d * m.n_experts
                ffn_a = m.top_k * one + d * m.n_experts
                if m.n_shared_experts:
                    ffn_t += m.n_shared_experts * one
                    ffn_a += m.n_shared_experts * one
                if m.dense_residual:
                    ffn_t += dense_ffn(self.d_ff)
                    ffn_a += dense_ffn(self.d_ff)
            else:
                ffn_t = ffn_a = dense_ffn(self.d_ff)
            total += mix_t + ffn_t + norms
            active += mix_a + ffn_a + norms
        # encoder stack (attention + dense FFN, bidirectional + cross-attn on decoder)
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
            xattn = n_dec * (attn_params() + d)  # decoder cross-attention
            total += enc + xattn
            active += enc + xattn
        total += emb + out_head + d  # final norm
        active += emb + out_head + d
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shape regimes.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class RunConfig:
    """Everything a launcher needs besides the model + shape."""
    arch: str
    shape: str = "train_4k"
    # distribution
    multi_pod: bool = False
    sharding: str = "2d"             # '2d' (tp+fsdp) | 'fsdp' | 'dp'
    remat: str = "block"             # 'none' | 'block' | 'full'
    attn_impl: str = "blockwise"     # 'naive' | 'blockwise' | 'flash'
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatch: int = 0              # 0 = no gradient accumulation
    # cross-pod sync (the paper's shiftable traffic class)
    local_sgd_h: int = 1             # steps between cross-pod syncs (1 = every step)
    grad_compression: str = "none"   # 'none' | 'int8' | 'topk'
    # carbon
    carbon_aware: bool = True
    carbon_threshold: float = 400.0  # gCO2/kWh migration threshold (paper §4.3)
    seed: int = 0


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256, d_ff: Optional[int] = None,
            n_experts: Optional[int] = None) -> ModelConfig:
    """Shrink a config to CPU-smoke scale, preserving family wiring."""
    scale = d_model / cfg.d_model
    n_heads = max(1, min(cfg.n_heads, 4))
    # keep the GQA ratio if possible
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // ratio)
    head = max(8, d_model // n_heads)
    upd = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=head,
        d_ff=d_ff if d_ff is not None else max(4, int(cfg.d_ff * scale)) or 4 * d_model,
        vocab_size=vocab,
    )
    if cfg.moe is not None:
        ne = n_experts if n_experts is not None else min(cfg.moe.n_experts, 4)
        upd["moe"] = replace(
            cfg.moe, n_experts=ne, top_k=min(cfg.moe.top_k, ne),
            d_ff_expert=max(8, int(cfg.moe.d_ff_expert * scale)))
    if cfg.ssm is not None:
        upd["ssm"] = replace(cfg.ssm, d_state=16, headdim=16, chunk_size=32)
    if cfg.encoder_layers:
        upd["encoder_layers"] = max(1, layers // 2)
    if cfg.sliding_window:
        upd["sliding_window"] = 16
    if cfg.n_frontend_tokens:
        upd["n_frontend_tokens"] = 4
    # hybrid: keep a 1-in-(attn_period) attention layer visible at tiny depth
    if cfg.attn_period:
        upd["attn_period"] = min(cfg.attn_period, layers)
        upd["attn_offset"] = 0
    # keep one local + one global layer visible at tiny depth
    if cfg.global_period:
        upd["global_period"] = min(cfg.global_period, max(2, layers // 2))
    return replace(cfg, **upd)
