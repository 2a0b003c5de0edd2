"""Mixture-of-experts layer: sort-based (MegaBlocks-style) capacity
dispatch, the reference's ``models/moe.py`` on one device.

Tokens are ranked within their routed expert by a stable argsort,
scattered into a capacity-bounded ``[E, C, d]`` buffer, run through
batched expert products (``torch.bmm``) and gathered back weighted by the
router's probabilities. An assignment ranked at or past the capacity is
dropped: it scatters into a spare expert row that is cut off before the
products, and its weight in the combine is 0. Arctic-style dense residual
branches and DeepSeek/Kimi-style shared experts follow ``MoEConfig``.

Under an active mesh (``runtime.pspec.sharding_scope`` with a
``HostMesh``) :func:`moe_ffn` takes the reference's expert-parallel branch
(its ``shard_map`` over the mesh) as explicit loops over the mesh's
positions in rank order: tokens split over the batch axes, each shard
dispatched at its own capacity, each model rank running its own slice of
the experts; under a shape-only mesh, as one coordinate's body (a
cell's cost trace, ``runtime.cost_analysis``). Each step here is a
module-level function that :func:`moe_ffn` and the branch look up when
they run. On one device, the route, the dispatch, the expert products
and the combine are each a span of :mod:`repro_torch.core.obs.runtime`
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``),
beside the dispatch's counters (:func:`count_dispatch`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.obs import runtime as obs
from repro_torch.models.layers import ffn
from repro_torch.runtime import pspec as PS


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: ceil(T * k / E * capacity_factor), rounded up to
    a multiple of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS f32 products in full f32 (no TF32) inside the block,
    whatever the process-wide switch says.

    The switch is the process's own: while a block runs, every thread's f32
    products go without TF32. Blocks of several threads take turns under
    one lock, so each restores the value it found and the switch comes
    back as it was, also when the block raises."""
    m = torch.backends.cuda.matmul
    with _TF32_LOCK:
        prev = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = prev


class _RouterLogits(torch.autograd.Function):
    """x @ w in f32 with the forward's and the backward's products both
    under :func:`ieee_f32`, so the router's gradient does not follow the
    process's TF32 switch where its logits do not."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        with ieee_f32():
            return x @ w

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        with ieee_f32():
            gx = g @ w.t() if ctx.needs_input_grad[0] else None
            gw = x.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (top_p [T, k] f32, top_i [T, k], aux scalar f32).

    The router runs in true f32, its backward too; top-k is a stable
    descending sort, so a tie goes to the lower expert index, as
    ``lax.top_k``. The choices are renormalised; aux is the Switch
    load-balancing loss E * sum(me * ce) over the mean probability and the
    top-1 share of each expert."""
    logits = _RouterLogits.apply(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    T = x.shape[0]
    me = probs.mean(0)
    top1 = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x.device)
    top1.scatter_add_(0, top_i[:, 0], torch.ones(T, device=x.device))
    aux = cfg.n_experts * torch.sum(me * (top1 / T))
    return top_p, top_i, aux


def dispatch_indices(top_i: torch.Tensor, n_experts: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ranks each (token, choice) assignment within its expert, in flat
    order (token-major). Returns (expert [A], slot [A], keep [A]), A = T*k;
    assignments ranked at or past ``cap`` are dropped (slot clamped to
    cap - 1, keep False). All integer arithmetic, no host sync."""
    A = top_i.numel()
    e_flat = top_i.reshape(A)
    order = torch.argsort(e_flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=top_i.device)
    counts.scatter_add_(0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts                   # [E]
    rank_sorted = (torch.arange(A, device=top_i.device)
                   - starts[e_flat[order]])
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return e_flat, torch.clamp(rank, max=cap - 1), rank < cap


def scatter(xt: torch.Tensor, e_flat: torch.Tensor, slot: torch.Tensor,
            keep: torch.Tensor, n_experts: int, cap: int,
            top_k: int) -> torch.Tensor:
    """Each kept assignment's token row into its expert's slot: [E, C, d].
    A dropped one goes to the spare row E, which is cut off."""
    tok = torch.arange(e_flat.shape[0], device=xt.device) // top_k
    e_scatter = torch.where(keep, e_flat, n_experts)
    buf = torch.zeros((n_experts + 1, cap, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    buf.index_put_((e_scatter, slot), xt[tok])
    return buf[:n_experts]


def experts(p: Dict[str, torch.Tensor], buf: torch.Tensor,
            gated: bool) -> torch.Tensor:
    """The batched expert FFN: [E, C, d] @ [E, d, f] -> [E, C, f] @ [E, f,
    d], gated SiLU or tanh-GELU."""
    dt = buf.dtype
    if gated:
        h = F.silu(torch.bmm(buf, p["wg"].to(dt))) * torch.bmm(
            buf, p["wu"].to(dt))
    else:
        h = F.gelu(torch.bmm(buf, p["wu"].to(dt)), approximate="tanh")
    return torch.bmm(h, p["wd"].to(dt))


def combine(out_buf: torch.Tensor, e_flat: torch.Tensor, slot: torch.Tensor,
            top_p: torch.Tensor, keep: torch.Tensor, top_k: int
            ) -> torch.Tensor:
    """Gather each assignment's expert output, weight it by its router
    probability (0 if dropped) in f32 and sum over the k choices: [T, d]
    f32."""
    got = out_buf[e_flat, slot]                                 # [A, d]
    w = (top_p.reshape(-1) * keep).float()
    y = got.float() * w[:, None]
    return y.reshape(-1, top_k, y.shape[-1]).sum(1)


def count_dispatch(keep: torch.Tensor, slots: int) -> None:
    """The dispatch's counters (:mod:`repro_torch.core.obs.runtime`):
    ``moe.assignments`` (T * k) and ``moe.slots`` (the rows the expert
    products compute, E * capacity) on the host, ``moe.kept`` and
    ``moe.dropped`` (past the capacity) on the device."""
    kept = keep.sum()
    obs.count("moe.assignments", keep.numel())
    obs.count("moe.slots", slots)
    obs.count_device("moe.kept", kept)
    obs.count_device("moe.dropped", keep.numel() - kept)


def _branch(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
            gated: bool) -> torch.Tensor:
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    return ffn({n: p[f"{prefix}_{n}"] for n in names}, x, gated=gated)


def expert_parallel(p: Dict[str, torch.Tensor], xt: torch.Tensor,
                    cfg: MoEConfig, gated: bool, mesh: PS.HostMesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over ``mesh`` (the reference's
    ``_routed_shardmap`` and ``_routed_local``): xt [T, d] -> (y [T, d]
    in xt's dtype, aux).

    The tokens split evenly over the batch axes that ``resolve(("batch",
    None))`` picks for xt (none when they do not divide T: every shard
    sees all tokens). Each token shard routes its own tokens and
    dispatches them at ``capacity(T_loc)``. Model rank r of the expert
    axis keeps the assignments to its experts [r*E_loc, (r+1)*E_loc) and
    runs those experts on views of the weights moved to its device (the
    FSDP gather is the identity here); its f32 combine is cast to xt's
    dtype before the sum over ranks, which runs in rank order on the
    shard's rank-0 device. aux is the mean of the shards' aux. The
    shards' outputs join in shard order on xt's device. It opens no
    ``moe.*`` span and counts nothing (:func:`count_dispatch`): those are
    the single-device branch's.

    Under a shape-only mesh, inside a cell's cost trace and only there,
    one coordinate's body runs instead (:func:`_one_coordinate`): what one
    device of the reference's ``shard_map`` runs, its routing
    included."""
    batch_axes = PS.resolve(("batch", None), shape=xt.shape)[0]
    model_axis = PS.resolve(("expert", "fsdp", None))[0]
    b_axes = (() if batch_axes is None else
              (batch_axes,) if isinstance(batch_axes, str) else batch_axes)
    b_sizes = [mesh.shape[a] for a in b_axes]
    n_batch = int(np.prod(b_sizes, dtype=np.int64))
    n_model = mesh.shape[model_axis] if model_axis else 1
    if cfg.n_experts % n_model:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{n_model} model ranks")
    e_loc = cfg.n_experts // n_model
    T, k = xt.shape[0], cfg.top_k
    t_loc = T // n_batch
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    if not isinstance(mesh, PS.HostMesh):
        return _one_coordinate(p, xt, cfg, gated, mesh, batch_axes,
                               model_axis, names)

    def device(b: int, r: int) -> torch.device:
        coord = dict(zip(b_axes, np.unravel_index(b, b_sizes)))
        if model_axis:
            coord[model_axis] = r
        return mesh.devices[tuple(int(coord.get(a, 0))
                                  for a in mesh.axis_names)]

    ys, auxes = [], []
    for b in range(n_batch):
        dev0 = device(b, 0)
        x_b = xt[b * t_loc:(b + 1) * t_loc].to(dev0)
        top_p, top_i, aux = route(p["router"].to(dev0), x_b, cfg)
        cap = capacity(t_loc, cfg)
        e_flat, slot, keep = dispatch_indices(top_i, cfg.n_experts, cap)
        y_b = None
        for r in range(n_model):
            dev, off = device(b, r), r * e_loc
            part = _rank_part(
                *(t.to(dev) for t in (x_b, top_p, e_flat, slot, keep)),
                {n: p[n][off:off + e_loc].to(dev) for n in names}, off,
                cap, k, gated).to(xt.dtype).to(dev0)
            y_b = part if y_b is None else y_b + part
        ys.append(y_b.to(xt.device))
        auxes.append(aux.to(xt.device))
    return torch.cat(ys), torch.stack(auxes).mean()


def _rank_part(x: torch.Tensor, top_p: torch.Tensor, e_flat: torch.Tensor,
               slot: torch.Tensor, keep: torch.Tensor,
               w: Dict[str, torch.Tensor], off: int, cap: int, k: int,
               gated: bool) -> torch.Tensor:
    """One model rank's share of a token shard's routed output, f32: the
    assignments to its experts [off, off + E_loc) (``w`` holds their
    weights) scattered, run and combined."""
    e_loc = next(iter(w.values())).shape[0]
    keep = keep & (e_flat >= off) & (e_flat < off + e_loc)
    e_r = torch.clamp(e_flat - off, 0, e_loc - 1)
    buf = scatter(x, e_r, slot, keep, e_loc, cap, k)
    return combine(experts(w, buf, gated), e_r, slot, top_p, keep, k)


def _one_coordinate(p: Dict[str, torch.Tensor], xt: torch.Tensor,
                    cfg: MoEConfig, gated: bool, mesh: PS.AbstractMesh,
                    batch_axes, model_axis, names
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`expert_parallel` under a shape-only mesh: one coordinate
    routes its token shard, dispatches it at its own capacity and runs its
    rank's experts; the sum over the model ranks and the mean of aux over
    the token shards are the reference's psum and pmean, counted as
    all-reduces."""
    from repro_torch.runtime import cost_analysis as CA
    if CA.active() is None:
        raise TypeError(f"the expert-parallel MoE needs a HostMesh, not "
                        f"{type(mesh).__name__}: a shape-only mesh places "
                        f"nothing (outside a cell's cost trace)")
    spec_x = (batch_axes, None)
    n_batch = PS.axis_size(batch_axes)
    n_model = mesh.shape[model_axis] if model_axis else 1
    w_spec = (model_axis, None, None)

    def body(coord, x_b, router, *w):
        top_p, top_i, aux = route(router, x_b, cfg)
        cap = capacity(x_b.shape[0], cfg)
        e_flat, slot, keep = dispatch_indices(top_i, cfg.n_experts, cap)
        off = coord[model_axis] * w[0].shape[0] if model_axis else 0
        y = _rank_part(x_b, top_p, e_flat, slot, keep, dict(zip(names, w)),
                       off, cap, cfg.top_k, gated).to(x_b.dtype)
        CA.record_collective("all-reduce", y.numel() * y.element_size(),
                             n_model)
        CA.record_collective("all-reduce", aux.element_size(), n_batch)
        return y, aux

    return CA.one_coordinate(
        body, CA.corners(mesh), [xt, p["router"]] + [p[n] for n in names],
        [spec_x, (None, None)] + [w_spec] * len(names), [spec_x, ()])


def _branch_counted(p: Dict[str, torch.Tensor], prefix: str,
                    xt: torch.Tensor, gated: bool) -> torch.Tensor:
    """An always-on branch under a shape-only mesh, counted at the layout
    of the expert-parallel output it is added to: tokens over the batch
    axes, its 'ffn' dimension over the axes the rules give it."""
    from repro_torch.runtime import cost_analysis as CA
    names = [f"{prefix}_{n}" for n in (("wg", "wu", "wd") if gated
                                       else ("wu", "wd"))]
    w = p[names[0]]
    split = (PS.axis_size(PS.resolve(("batch", None), shape=xt.shape)[0])
             * PS.axis_size(PS.resolve((None, "ffn"), shape=w.shape)[1]))
    return CA.counted_at(
        split, lambda x, *ws: (_branch(dict(zip(names, ws)), prefix, x,
                                       gated),),
        xt, *(p[n] for n in names))[0]


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig, *,
            gated: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux scalar). The routed experts'
    combine is cast to x's dtype once (once a model rank under a mesh:
    :func:`expert_parallel`); the shared experts and the dense residual
    are added after, on all tokens, in x's dtype, as the reference does."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    mesh = PS.active_mesh()
    if mesh is not None:
        y, aux = expert_parallel(p, xt, cfg, gated, mesh)
    else:
        with obs.span("moe.route"):
            top_p, top_i, aux = route(p["router"], xt, cfg)
        cap = capacity(T, cfg)
        with obs.span("moe.dispatch"):
            e_flat, slot, keep = dispatch_indices(top_i, cfg.n_experts, cap)
            buf = PS.logical_constraint(
                scatter(xt, e_flat, slot, keep, cfg.n_experts, cap,
                        cfg.top_k),
                ("expert", "capacity", None))
        if obs.recording():
            count_dispatch(keep, cfg.n_experts * cap)
        with obs.span("moe.experts"):
            out_buf = PS.logical_constraint(experts(p, buf, gated),
                                            ("expert", "capacity", None))
        with obs.span("moe.combine"):
            y = combine(out_buf, e_flat, slot, top_p, keep,
                        cfg.top_k).to(x.dtype)
    branch = (_branch if mesh is None or isinstance(mesh, PS.HostMesh)
              else _branch_counted)
    if cfg.n_shared_experts:
        y = y + branch(p, "shared", xt, gated)
    if cfg.dense_residual:
        y = y + branch(p, "dense", xt, gated)
    return y.reshape(B, S, d), aux
