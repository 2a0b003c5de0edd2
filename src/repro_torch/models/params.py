"""Parameter specs: one tree describing shape, dtype, logical sharding axes
and init for every weight, the same tree as the reference's
``models/params.py``. :func:`init_params` realizes it as torch tensors from
a ``torch.Generator`` with the reference's init distributions (the values
differ from JAX's for the same seed). :func:`unstack_leaves` names the
stacked leaves by layer, the port's layout; :func:`abstract_params`,
:func:`param_logical_axes` and :func:`param_shardings` give the same tree
in that layout as meta tensors, logical axes and ``NamedSharding``
records (the reference's dry-run trees; the port places nothing).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import pspec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# elements of a normal leaf drawn at once (1 GiB in f32): init's peak is
# the weights plus one such slice
INIT_SLICE = 1 << 28


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Any, ...]          # logical axis per dim (see runtime.pspec)
    init: str = "normal"              # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None       # default: cfg.dtype


def _attn_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    sp: Dict[str, ParamSpec] = {}
    if cross:
        sp["wq"] = ParamSpec((d, nq * h), ("fsdp", "heads"))
        sp["wkv"] = ParamSpec((d, 2 * nkv * h), ("fsdp", "kv_heads"))
    else:
        sp["wqkv"] = ParamSpec((d, (nq + 2 * nkv) * h), ("fsdp", "heads"))
        if cfg.qkv_bias:
            sp["bqkv"] = ParamSpec(((nq + 2 * nkv) * h,), ("heads",),
                                   init="zeros")
    sp["wo"] = ParamSpec((nq * h, d), ("heads", "fsdp"))
    sp["ln"] = ParamSpec((d,), (None,), init="zeros")
    return sp


def _ffn_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    sp = {"wu": ParamSpec((d, d_ff), ("fsdp", "ffn")),
          "wd": ParamSpec((d_ff, d), ("ffn", "fsdp")),
          "ln": ParamSpec((d,), (None,), init="zeros")}
    if cfg.ffn_gated:
        sp["wg"] = ParamSpec((d, d_ff), ("fsdp", "ffn"))
    return sp


def _moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    sp = {"router": ParamSpec((d, m.n_experts), ("fsdp", None)),
          "wu": ParamSpec((m.n_experts, d, fe), ("expert", "fsdp", None)),
          "wd": ParamSpec((m.n_experts, fe, d), ("expert", None, "fsdp")),
          "ln": ParamSpec((d,), (None,), init="zeros")}
    if cfg.ffn_gated:
        sp["wg"] = ParamSpec((m.n_experts, d, fe), ("expert", "fsdp", None))
    for prefix, on in (("shared", m.n_shared_experts > 0),
                       ("dense", m.dense_residual)):
        if not on:
            continue
        width = (m.d_ff_expert * m.n_shared_experts if prefix == "shared"
                 else cfg.d_ff)
        sp[f"{prefix}_wu"] = ParamSpec((d, width), ("fsdp", "ffn"))
        sp[f"{prefix}_wd"] = ParamSpec((width, d), ("ffn", "fsdp"))
        if cfg.ffn_gated:
            sp[f"{prefix}_wg"] = ParamSpec((d, width), ("fsdp", "ffn"))
    return sp


def _ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    z = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    return {
        "in_proj": ParamSpec((d, z), ("fsdp", "ssm_inner")),
        "conv": ParamSpec((s.conv_width, conv_ch), (None, "ssm_inner"),
                          init="normal", scale=0.1),
        "A_log": ParamSpec((nh,), ("ssm_inner",), init="ssm_a"),
        "D": ParamSpec((nh,), ("ssm_inner",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_inner",), init="ssm_dt"),
        "gate_norm": ParamSpec((d_in,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamSpec((d_in, d), ("ssm_inner", "fsdp")),
        "ln": ParamSpec((d,), (None,), init="zeros"),
    }


# ------------------------------------------------------- block structure ---
@dataclasses.dataclass(frozen=True)
class SubLayerSpec:
    index: int                 # position within the repeating group
    mixer: str                 # 'attn' | 'ssm'
    is_global: bool            # full-context attention (vs sliding window)
    is_moe: bool
    has_ffn: bool


def block_period(cfg: ModelConfig) -> int:
    p = 1
    for v in (cfg.attn_period, cfg.global_period,
              cfg.moe.every_k_layers if cfg.moe else 1):
        if v and v > 1:
            p = p * v // math.gcd(p, v)
    return int(p)


def block_specs(cfg: ModelConfig) -> Tuple[SubLayerSpec, ...]:
    period = block_period(cfg)
    out = []
    for i in range(period):
        mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
        out.append(SubLayerSpec(
            index=i,
            mixer=mixer,
            is_global=cfg.is_global_attn_layer(i),
            is_moe=cfg.is_moe_layer(i) and cfg.family != "ssm",
            has_ffn=cfg.d_ff > 0 or cfg.moe is not None,
        ))
    return tuple(out)


def n_groups(cfg: ModelConfig) -> int:
    period = block_period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of "
                         f"{period}")
    return cfg.n_layers // period


def _sublayer_specs(cfg: ModelConfig, spec: SubLayerSpec) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    if spec.mixer == "attn":
        tree["attn"] = _attn_specs(cfg)
    else:
        tree["ssm"] = _ssm_specs(cfg)
    if cfg.encoder_layers:
        tree["cross"] = _attn_specs(cfg, cross=True)
    if spec.has_ffn:
        tree["moe" if spec.is_moe else "ffn"] = (
            _moe_specs(cfg) if spec.is_moe else _ffn_specs(cfg, cfg.d_ff))
    return tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in sorted-key order, as ``jax.tree`` flattens
    a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _stack(tree: Any, g: int) -> Any:
    """Prepend the scan (group) axis to every spec in `tree`."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(g,) + s.shape, logical=(None,) + s.logical), tree)


def param_spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": {"tok": ParamSpec((cfg.vocab_size, d), ("vocab", "fsdp"))},
        "decoder": {
            "blocks": _stack(
                {f"sub{s.index}": _sublayer_specs(cfg, s)
                 for s in block_specs(cfg)}, n_groups(cfg)),
            "norm": ParamSpec((d,), (None,), init="zeros"),
        },
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((d, cfg.vocab_size), ("fsdp", "vocab"))
    if cfg.encoder_layers:
        enc_sub = {"attn": _attn_specs(cfg), "ffn": _ffn_specs(cfg, cfg.d_ff)}
        tree["encoder"] = {
            "blocks": _stack(enc_sub, cfg.encoder_layers),
            "norm": ParamSpec((d,), (None,), init="zeros"),
        }
    return tree


# ------------------------------------------------------------ realization --
def _init_leaf(spec: ParamSpec, cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype or cfg.dtype)
    f32 = torch.float32
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=f32, device=device).uniform_(
            lo, hi, generator=gen)
        # A_log ~ log(Uniform[1,16]); dt_bias = softplus^-1(Uniform[1e-3,1e-1])
        return torch.log(u) if spec.init == "ssm_a" \
            else torch.log(torch.expm1(u))
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    sc = min(spec.scale, 1.0 / math.sqrt(fan_in))
    n = math.prod(spec.shape)
    # drawn in f32 slices of the flat view, each cast into the result as it
    # comes: the f32 temporary stays one slice (a leaf of at most one slice
    # is one draw of its whole size, as ``randn(shape)`` would make it)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    flat = out.view(-1)
    for i in range(0, n, INIT_SLICE):
        m = min(INIT_SLICE, n - i)
        flat[i:i + m] = torch.randn(m, dtype=f32, device=device,
                                    generator=gen).mul_(sc)
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """The spec tree as tensors on ``device``, drawn leaf by leaf in the
    reference's flattening order from one generator seeded with ``seed``.
    Stacked over scan groups, as the reference's tree is."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, Any] = {}
    for path, spec in tree_leaves(param_spec_tree(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_leaf(spec, cfg, gen, device)
    return out


def unstack_leaves(tree: Dict[str, Any], cfg: ModelConfig,
                   take: Callable[[Any, int], Any]) -> Dict[str, Any]:
    """A tree in the reference's stacked layout -> ``{state dict key:
    take(leaf, j)}``: decoder layer ``g * period + i`` takes
    ``take(blocks["sub{i}"][...], g)``, encoder layer ``i`` takes
    ``take(encoder.blocks[...], i)``; the other leaves keep their paths,
    joined with dots, and are not passed to ``take``."""
    period = block_period(cfg)
    out: Dict[str, Any] = {}
    for path, leaf in tree_leaves(tree):
        if path[:2] == ("decoder", "blocks"):
            i = int(path[2][len("sub"):])
            rest = ".".join(path[3:])
            for g in range(n_groups(cfg)):
                out[f"decoder.layers.{g * period + i}.{rest}"] = take(leaf, g)
        elif path[:2] == ("encoder", "blocks"):
            rest = ".".join(path[2:])
            for i in range(cfg.encoder_layers):
                out[f"encoder.layers.{i}.{rest}"] = take(leaf, i)
        else:
            out[".".join(path)] = leaf
    return out


def _unstacked_spec(spec: ParamSpec, _: int) -> ParamSpec:
    """A stacked leaf's spec for one layer: the group axis dropped."""
    return dataclasses.replace(spec, shape=spec.shape[1:],
                               logical=spec.logical[1:])


def layer_spec_tree(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The spec tree in the port's layout: ``{state dict key: spec}``."""
    return unstack_leaves(param_spec_tree(cfg), cfg, _unstacked_spec)


def _leaf_dtype(spec: ParamSpec, cfg: ModelConfig) -> torch.dtype:
    if spec.init in ("ssm_a", "ssm_dt"):
        return torch.float32
    return torch_dtype(spec.dtype or cfg.dtype)


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every weight as a meta tensor of its shape and dtype (no storage),
    by state dict key."""
    return {k: torch.empty(s.shape, dtype=_leaf_dtype(s, cfg),
                           device="meta")
            for k, s in layer_spec_tree(cfg).items()}


def param_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Any, ...]]:
    return {k: s.logical for k, s in layer_spec_tree(cfg).items()}


def param_shardings(cfg: ModelConfig
                    ) -> Dict[str, Optional[pspec.NamedSharding]]:
    """Each weight's ``NamedSharding`` under the active scope (None
    outside a mesh)."""
    return {k: pspec.named_sharding(s.logical, shape=s.shape)
            for k, s in layer_spec_tree(cfg).items()}


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape)
               for _, s in tree_leaves(param_spec_tree(cfg)))
