"""Model-level API: the ``Transformer`` module, embedding, losses,
prefill/decode steps, the plain full forward, ``input_specs`` (meta-tensor
stand-ins for a cell's inputs) and ``make_batch``.

Batch layouts per shape kind, as in the reference's ``models/model.py``:
  train:   {tokens [B,S_txt], targets [B,S_txt], (+frontend)}
  prefill: {tokens [B,S_txt], (+frontend)}  -> (last_logits, cache)
  decode:  {token [B,1], cache, cur}        -> (logits, cache)

Frontend stubs, as in the reference: 'audio' (``encdec``) supplies encoder
frames [B, S//4, d_model]; 'vision' (``vlm``) supplies patch embeddings
[B, 256, d_model] prepended to the text sequence (text length = S - 256).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import kvcache as KC
from repro_torch.models.convert import unstack
from repro_torch.models.layers import check_attn_impl
from repro_torch.models.params import init_params
from repro_torch.models.transformer import (Cache, Decoder, Encoder,
                                            ParamGroup)
from repro_torch.runtime import pspec as PS

AUDIO_DOWNSAMPLE = 4  # audio frontend emits one frame per 4 target positions


class Transformer(nn.Module):
    """Embedding, encoder (with ``cfg.encoder_layers``), decoder stack and
    output head over a state dict in the port's naming (``embed.tok``,
    ``encoder.layers.{i}.attn.wqkv``, ..., ``encoder.norm``,
    ``decoder.layers.{i}.attn.wqkv``, ..., ``decoder.norm``, ``lm_head``).
    The tensors become the parameters as they are: no copy."""

    def __init__(self, cfg: ModelConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamGroup({"tok": state["embed.tok"]})
        self.encoder = Encoder(cfg, state) if cfg.encoder_layers else None
        self.decoder = Decoder(cfg, state)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(state["lm_head"], requires_grad=False)
        have, want = set(self.state_dict()), set(state)
        if have != want:
            raise ValueError(f"state dict does not fit {cfg.name}: missing "
                             f"{sorted(have - want)[:5]}, unexpected "
                             f"{sorted(want - have)[:5]}")


def build_model(cfg: ModelConfig, *, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Transformer:
    """A model with random weights from a generator seeded with ``seed``
    on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    return Transformer(cfg, unstack(init_params(cfg, seed=seed, device=dev),
                                    cfg))


# ------------------------------------------------------------- embeddings --
def embed(model: Transformer, tokens: torch.Tensor,
          patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [B, S, d]; a ``vlm`` prepends ``patches`` [B, P, d]
    first, and both are scaled, as in the reference."""
    x = model.embed.tok[tokens]
    if model.cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    # the scale is rounded to the param dtype first: bf16 gives 62.0 for
    # sqrt(3840), as the reference's jnp.asarray(d ** 0.5, x.dtype) does
    x = x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype,
                         device=x.device)
    return PS.logical_constraint(x, ("batch", None, None))


def encode(model: Transformer, run: RunConfig,
           frames: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The encoder's output over ``frames`` [B, S_enc, d] for an
    ``encdec`` model, cast to the model's dtype first; None otherwise."""
    if model.cfg.family != "encdec":
        return None
    if frames is None:
        raise ValueError(f"{model.cfg.name} encodes audio frames; none "
                         f"were given")
    return model.encoder(frames.to(model.embed.tok.dtype), run)


def unembed(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    w = (model.embed.tok.T if model.cfg.tie_embeddings
         else model.lm_head)
    return PS.logical_constraint(x @ w.to(x.dtype), ("batch", None, "vocab"))


# ------------------------------------------------------------------ loss ---
def _nll_sum(model: Transformer, x: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    logits = unembed(model, x).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(model: Transformer, x: torch.Tensor, targets: torch.Tensor,
                 chunk: int = 0) -> Tuple[torch.Tensor, float]:
    """Cross-entropy over next-token targets; with ``chunk`` dividing the
    sequence (and shorter than it) a loop over sequence chunks, each
    checkpointed, so no more than one chunk's [B, chunk, V] f32 logits is
    live in the forward or the backward pass. Returns (sum_nll, n_tokens).
    """
    B, S, _ = x.shape
    if chunk <= 0 or S % chunk != 0 or S == chunk:
        return _nll_sum(model, x, targets), float(B * S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xs, ts = x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        tot = tot + (checkpoint(_nll_sum, model, xs, ts, use_reentrant=False)
                     if torch.is_grad_enabled() else _nll_sum(model, xs, ts))
    return tot, float(B * S)


def loss_fn(model: Transformer, run: RunConfig,
            batch: Mapping[str, torch.Tensor], *, xent_chunk: int = 2048
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy, plus ``aux_loss_weight`` times the
    MoE auxiliary loss (summed over the MoE layers) for a model with
    experts. An ``encdec`` batch carries ``frames`` for the encoder; a
    ``vlm`` batch carries ``patches``, whose positions are not scored.
    Returns (loss, {"nll", "aux"}), both detached."""
    check_attn_impl(run.attn_impl)
    enc_out = encode(model, run, batch.get("frames"))
    x, aux = model.decoder(embed(model, batch["tokens"],
                                 batch.get("patches")),
                           run, mode="train", enc_out=enc_out)
    if model.cfg.family == "vlm":
        x = x[:, model.cfg.n_frontend_tokens:, :]
    nll_sum, denom = chunked_xent(model, x, batch["targets"], xent_chunk)
    nll = nll_sum / denom
    loss = nll
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        loss = loss + model.cfg.moe.aux_loss_weight * aux
    return loss, {"nll": nll.detach(), "aux": aux.detach()}


# ------------------------------------------------------------- serving -----
@torch.inference_mode()
def prefill(model: Transformer, run: RunConfig, tokens: torch.Tensor,
            s_max: int, *, frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens [B, S] (after ``patches`` [B, P, d] for a ``vlm``; with
    ``frames`` [B, S_enc, d] for an ``encdec``) -> (f32 logits at the last
    position [B, V], cache)."""
    check_attn_impl(run.attn_impl)
    enc_out = encode(model, run, frames)
    cache = KC.zero_cache(model.cfg, tokens.shape[0], s_max,
                          0 if enc_out is None else enc_out.shape[1],
                          device=tokens.device)
    x, _ = model.decoder(embed(model, tokens, patches), run, mode="prefill",
                         cache=cache, enc_out=enc_out)
    logits = unembed(model, x[:, -1:, :])[:, 0]
    return logits.float(), cache


@torch.inference_mode()
def decode_step(model: Transformer, run: RunConfig, token: torch.Tensor,
                cache: List[Cache], cur: int
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """token [B, 1]; cur = number of tokens already in the cache. The cache
    is updated in place and returned."""
    x, _ = model.decoder(embed(model, token), run, mode="decode",
                         cache=cache, cur=cur)
    logits = unembed(model, x)[:, 0]
    return logits.float(), cache


@torch.inference_mode()
def forward_hidden(model: Transformer, run: RunConfig, tokens: torch.Tensor,
                   *, frames: Optional[torch.Tensor] = None,
                   patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain full forward: tokens [B, S] (and ``frames`` or
    ``patches`` as :func:`prefill` takes them) -> final hidden states
    [B, P + S, d], no cache. Unembed only the positions a caller needs: at
    gemma3-12b's vocabulary all of them would be [B, S, 262144] f32."""
    check_attn_impl(run.attn_impl)
    x, _ = model.decoder(embed(model, tokens, patches), run, mode="train",
                         enc_out=encode(model, run, frames))
    return x


# ------------------------------------------------------------ input batch --
def text_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len - (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, object]:
    """Meta-tensor stand-ins (no storage) for every model input of a cell,
    as the reference's: train ``tokens``/``targets`` int32 [B, S_txt],
    prefill ``tokens``, with an ``encdec``'s f32 ``frames`` [B, S//4, d]
    or a ``vlm``'s f32 ``patches`` [B, P, d]; decode ``token`` [B, 1], the
    ``cache`` of an S-token context (:func:`KC.abstract_cache`) and
    ``cur`` (an int32 scalar; the model API takes an int)."""
    B, S = shape.global_batch, shape.seq_len
    stl = text_len(cfg, S)

    def meta(*size, dt=torch.int32):
        return torch.empty(size, dtype=dt, device="meta")

    if shape.kind == "decode":
        enc_len = S // AUDIO_DOWNSAMPLE if cfg.family == "encdec" else 0
        return {"token": meta(B, 1),
                "cache": KC.abstract_cache(cfg, B, S, enc_len),
                "cur": meta()}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    spec: Dict[str, object] = {"tokens": meta(B, stl)}
    if shape.kind == "train":
        spec["targets"] = meta(B, stl)
    if cfg.family == "encdec":
        spec["frames"] = meta(B, S // AUDIO_DOWNSAMPLE, cfg.d_model,
                              dt=torch.float32)
    if cfg.family == "vlm":
        spec["patches"] = meta(B, cfg.n_frontend_tokens, cfg.d_model,
                               dt=torch.float32)
    return spec


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator) -> Dict[str, object]:
    """:func:`input_specs` realized on the CPU, drawn with ``generator``
    in their order: token ids (int64) uniform in ``[0, min(vocab, 255))``
    (the reference's range), an ``encdec``'s ``frames`` or a ``vlm``'s
    ``patches`` as f32 normals times 0.02 as the reference draws them,
    and for decode a zeroed cache and ``cur`` 0."""
    hi = min(cfg.vocab_size, 255)
    out: Dict[str, object] = {}
    for k, t in input_specs(cfg, shape).items():
        if k == "cache":
            out[k] = [{n: torch.zeros(c.shape, dtype=c.dtype)
                       for n, c in sub.items()} for sub in t]
        elif k == "cur":
            out[k] = 0
        elif t.dtype == torch.int32:
            out[k] = torch.randint(0, hi, tuple(t.shape), generator=generator,
                                   dtype=torch.int64)
        else:
            out[k] = torch.randn(tuple(t.shape), generator=generator) * 0.02
    return out
