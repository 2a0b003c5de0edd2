"""The decoder and encoder stacks as ``torch.nn`` modules.

The reference scans ``n_groups`` repetitions of a ``period``-long block
pattern with stacked parameters; here the stack is a Python loop over one
module per layer (layer ``g * period + i`` is the reference's group ``g``,
sub-layer ``i``). One code path serves train (the plain full forward),
prefill and decode — the mode only changes positions, masking source, and
cache handling. Every family runs every mode: ``dense``, ``ssm``
(Mamba-2), ``moe`` (routed experts in the FFN), ``hybrid`` (Mamba-2 and
attention layers interleaved, MoE on some), ``encdec`` (a bidirectional
encoder and cross-attention in every decoder layer) and ``vlm``. The
decoder returns the MoE auxiliary loss beside its output, summed per
group of ``period`` layers and then over the groups, as the reference
sums it in and across its scan.

With ``run.remat != "none"`` a training forward checkpoints each group of
``period`` decoder layers and each encoder layer
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` around a
scan step): the backward pass reruns the forward, kernels included.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import kvcache as KC
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models.layers import (apply_rope, attention,
                                       attention_projections, ffn, rms_norm,
                                       use_seq_parallel)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import SSMState, mamba_block
from repro_torch.runtime import pspec as PS

Cache = Dict[str, torch.Tensor]


class ParamGroup(nn.Module):
    """A sub-layer's weights, registered under the reference's names."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self._parameters)


def _group(state: Mapping[str, torch.Tensor], prefix: str) -> ParamGroup:
    return ParamGroup({k[len(prefix):]: v for k, v in state.items()
                       if k.startswith(prefix)
                       and "." not in k[len(prefix):]})


# ------------------------------------------------------------- sublayers ---
def _attn_sublayer(cfg: ModelConfig, run: RunConfig, spec: P.SubLayerSpec,
                   p: Dict[str, torch.Tensor], x: torch.Tensor, *, mode: str,
                   cur: Optional[int],
                   cache: Optional[Cache]) -> torch.Tensor:
    """Self-attention sub-layer. In prefill and decode it writes the layer's
    keys and values into ``cache`` in place (the reference returns a new
    cache; writing in place saves a copy of every layer's cache per
    token)."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attention_projections(
        p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim)
    window = None if spec.is_global else cfg.sliding_window
    use_rope = cfg.rope_theta > 0

    if mode in ("train", "prefill"):
        pos = torch.arange(S, device=x.device)
        if use_rope:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if use_seq_parallel(q, k):
            # context parallelism: the heads do not split over the model
            # axis (looked up at call time, so a recorder can wrap it)
            out = layers.seq_parallel_attention(
                q, k, v, causal=True, window=window, impl=run.attn_impl,
                block_kv=run.attn_block_kv)
        else:
            q = PS.logical_constraint(q, ("batch", None, "heads", None))
            k = PS.logical_constraint(k, ("batch", None, "kv_heads", None))
            out = attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                            window=window, impl=run.attn_impl,
                            block_kv=run.attn_block_kv)
        if mode == "prefill":
            sz = cache["k"].shape[1]
            if S >= sz:
                ks, vs = k[:, S - sz:], v[:, S - sz:]
                if sz < S or (window is not None and sz == window):
                    # ring order: position p sits in slot p % sz
                    roll = S % sz
                    ks = torch.roll(ks, roll, dims=1)
                    vs = torch.roll(vs, roll, dims=1)
                cache["k"].copy_(ks)
                cache["v"].copy_(vs)
            else:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
    elif mode == "decode":                           # S == 1
        pos_q = torch.full((1,), cur, device=x.device)
        if use_rope:
            q = apply_rope(q, pos_q, cfg.rope_theta)
            k = apply_rope(k, pos_q, cfg.rope_theta)
        sz = cache["k"].shape[1]
        is_ring = window is not None and sz <= window
        slot = cur % sz if is_ring else min(cur, sz - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        kv_pos = KC.ring_positions(cur + 1, sz, window=is_ring,
                                   device=x.device)
        out = attention(q, cache["k"], cache["v"], q_pos=pos_q,
                        kv_pos=kv_pos, causal=True, window=window,
                        impl="naive")
    else:
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


def _cross_sublayer(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, mode: str,
                    enc_out: Optional[torch.Tensor],
                    cache: Optional[Cache]) -> torch.Tensor:
    """Cross-attention to the encoder's output: naive and non-causal, every
    query at position 0. Prefill writes the encoder's keys and values into
    ``cache`` in place; decode reads them from there."""
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"].to(x.dtype)).reshape(B, S, nq, hd)
    if mode == "decode":
        k, v = cache["xk"], cache["xv"]
    else:
        k, v = torch.chunk(enc_out @ p["wkv"].to(x.dtype), 2, dim=-1)
        k = k.reshape(B, -1, nkv, hd)
        v = v.reshape(B, -1, nkv, hd)
        if mode == "prefill":
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
    out = attention(q, k, v, q_pos=torch.zeros(S, dtype=torch.long,
                                               device=x.device),
                    kv_pos=torch.arange(k.shape[1], device=x.device),
                    causal=False, impl="naive")
    return out.reshape(B, S, nq * hd) @ p["wo"].to(x.dtype)


def _ffn_sublayer(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return ffn(p, h, gated=cfg.ffn_gated)


def _moe_sublayer(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return moe_ffn(p, h, cfg.moe, gated=cfg.ffn_gated)


def _ssm_sublayer(cfg: ModelConfig, run: RunConfig,
                  p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                  mode: str, cache: Optional[Cache]) -> torch.Tensor:
    """Mamba-2 sub-layer; the CUDA SSD kernel runs on the port's kernel
    path (``attn_impl == "flash"``, the reference's ``"pallas"``). Prefill
    (the reference's ``_ssm_prefill``) mixes the whole prompt and writes the
    decode state after its last token into ``cache`` in place; decode
    steps that state, in place."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    state = None
    if mode == "decode":
        state = SSMState(conv=cache["conv"], h=cache["h"])
    out, new_state = mamba_block(p, h, cfg.ssm, state=state,
                                 norm_eps=cfg.norm_eps,
                                 use_kernel=(run.attn_impl == "flash"),
                                 final_state=(mode == "prefill"))
    if new_state is not None:
        cache["conv"].copy_(new_state.conv)
        cache["h"].copy_(new_state.h)
    return out


# -------------------------------------------------------------- the stack ---
class DecoderLayer(nn.Module):
    """One mixer sub-layer (attention or Mamba-2), cross-attention to the
    encoder when there is one, and the dense FFN or the MoE."""

    def __init__(self, cfg: ModelConfig, spec: P.SubLayerSpec,
                 state: Mapping[str, torch.Tensor], prefix: str):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        if spec.mixer == "attn":
            self.attn = _group(state, prefix + "attn.")
        else:
            self.ssm = _group(state, prefix + "ssm.")
        if cfg.encoder_layers:
            self.cross = _group(state, prefix + "cross.")
        if spec.has_ffn and spec.is_moe:
            self.moe = _group(state, prefix + "moe.")
        elif spec.has_ffn:
            self.ffn = _group(state, prefix + "ffn.")

    def forward(self, x: torch.Tensor, run: RunConfig, *, mode: str,
                cur: Optional[int], cache: Optional[Cache],
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (x, the MoE's aux loss, or None without one)."""
        if self.spec.mixer == "attn":
            x = x + _attn_sublayer(self.cfg, run, self.spec,
                                   self.attn.params(), x, mode=mode,
                                   cur=cur, cache=cache)
        else:
            x = x + _ssm_sublayer(self.cfg, run, self.ssm.params(), x,
                                  mode=mode, cache=cache)
        if self.cfg.encoder_layers:
            x = x + _cross_sublayer(self.cfg, self.cross.params(), x,
                                    mode=mode, enc_out=enc_out, cache=cache)
        aux = None
        if self.spec.has_ffn and self.spec.is_moe:
            y, aux = _moe_sublayer(self.cfg, self.moe.params(), x)
            x = x + y
        elif self.spec.has_ffn:
            x = x + _ffn_sublayer(self.cfg, self.ffn.params(), x)
        return PS.logical_constraint(x, ("batch", None, None)), aux


class Decoder(nn.Module):
    """``n_layers`` decoder layers and the final norm."""

    def __init__(self, cfg: ModelConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, spec, state, f"decoder.layers.{i}.")
            for i, spec in enumerate(KC.layer_specs(cfg)))
        self.norm = nn.Parameter(state["decoder.norm"], requires_grad=False)

    def forward(self, x: torch.Tensor, run: RunConfig, *, mode: str,
                cache: Optional[List[Cache]] = None,
                cur: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, S, d] -> (the final-normed hidden states, the MoE aux
        loss summed over layers, f32, or None without MoE layers, so that a
        model without experts launches nothing for it); ``cache`` (one dict
        per layer) is written in place in prefill and decode; ``enc_out``
        [B, S_enc, d] is the encoder's output in train and prefill (decode
        reads it from the cache)."""
        if (cache is None) != (mode == "train"):
            raise ValueError("prefill and decode take a cache, train none")
        remat = (mode == "train" and run.remat != "none"
                 and torch.is_grad_enabled())
        period = P.block_period(self.cfg)
        aux = None
        for g in range(0, len(self.layers), period):
            caches = None if cache is None else cache[g:g + period]
            args = (x, self.layers[g:g + period], run, mode, cur, caches,
                    enc_out)
            x, aux_g = (checkpoint(_run_group, *args, use_reentrant=False,
                                   context_fn=_in_scope(PS.current_scope()))
                        if remat else _run_group(*args))
            aux = _add_aux(aux, aux_g)
        return rms_norm(x, self.norm, self.cfg.norm_eps), aux


def _in_scope(scope):
    """A checkpoint's ``context_fn``: its recompute, which autograd may run
    on another thread, re-enters the forward's sharding scope (the MoE's
    mesh branch and sequence-parallel attention read it)."""
    return lambda: (contextlib.nullcontext(), PS.sharding_scope(*scope))


def _add_aux(total: Optional[torch.Tensor],
             aux: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A running aux sum that stays None until a term comes."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _run_group(x: torch.Tensor, layers: nn.ModuleList, run: RunConfig,
               mode: str, cur: Optional[int],
               caches: Optional[List[Cache]],
               enc_out: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One group of ``period`` layers -> (x, the group's aux sum, or None
    without MoE layers)."""
    aux = None
    for i, layer in enumerate(layers):
        x, aux_l = layer(x, run, mode=mode, cur=cur,
                         cache=None if caches is None else caches[i],
                         enc_out=enc_out)
        aux = _add_aux(aux, aux_l)
    return x, aux


class EncoderLayer(nn.Module):
    """Bidirectional self-attention and the FFN (the reference's
    ``run_encoder`` scan body)."""

    def __init__(self, cfg: ModelConfig, state: Mapping[str, torch.Tensor],
                 prefix: str):
        super().__init__()
        self.cfg = cfg
        self.attn = _group(state, prefix + "attn.")
        self.ffn = _group(state, prefix + "ffn.")

    def forward(self, x: torch.Tensor, run: RunConfig) -> torch.Tensor:
        cfg, p = self.cfg, self.attn.params()
        B, S, _ = x.shape
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = attention_projections(
            p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim)
        pos = torch.arange(S, device=x.device)
        if cfg.rope_theta > 0:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        out = attention(q, k, v, q_pos=pos, kv_pos=pos, causal=False,
                        impl=run.attn_impl, block_kv=run.attn_block_kv)
        x = x + out.reshape(B, S, cfg.n_heads * cfg.head_dim) \
            @ p["wo"].to(x.dtype)
        return x + _ffn_sublayer(cfg, self.ffn.params(), x)


class Encoder(nn.Module):
    """The reference's ``run_encoder``: ``encoder_layers`` bidirectional
    layers over precomputed frontend frames [B, S, d], and a final norm.
    On the kernel path its attention is the flash kernel, non-causal."""

    def __init__(self, cfg: ModelConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, state, f"encoder.layers.{i}.")
            for i in range(cfg.encoder_layers))
        self.norm = nn.Parameter(state["encoder.norm"], requires_grad=False)

    def forward(self, frames: torch.Tensor, run: RunConfig) -> torch.Tensor:
        remat = run.remat != "none" and torch.is_grad_enabled()
        x = frames
        for layer in self.layers:
            x = (checkpoint(layer, x, run, use_reentrant=False) if remat
                 else layer(x, run))
        return rms_norm(x, self.norm, self.cfg.norm_eps)
