"""The step builders and the sharding trees of their arguments, as the
reference's ``runtime/steps.py``: the train step (microbatch accumulation
included), the prefill and serve steps, the batch and optimizer-state
``NamedSharding`` trees resolved under the active ``sharding_scope``, and
the per-cell choice of context-parallel attention, and ``lower_cell``:
a cell's step with its meta arguments and shardings, ready for
``runtime.cost_analysis.analyze_cell`` to trace where the reference
lowers it through XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import kvcache as KC
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.layers import check_attn_impl
from repro_torch.optim.adamw import (OptState, abstract_opt_state,
                                    adamw_update)
from repro_torch.optim.schedule import lr_schedule
from repro_torch.runtime import pspec


# ----------------------------------------------------------- sharding trees
def batch_shardings(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A ``NamedSharding`` (None outside a mesh) for every leaf of
    ``M.input_specs(cfg, shape)``: the batch dimension over 'batch', the
    rest whole; the decode cache by :func:`KC.cache_logical_axes`, its
    sequence split over 'data' for a batch of one."""
    spec = M.input_specs(cfg, shape)
    if shape.kind == "decode":
        axes = KC.cache_logical_axes(cfg,
                                     seq_shard=(shape.global_batch == 1))
        return {
            "token": pspec.named_sharding(("batch", None),
                                          shape=(shape.global_batch, 1)),
            "cache": [{k: pspec.named_sharding(ax[k], shape=c[k].shape)
                       for k in c} for ax, c in zip(axes, spec["cache"])],
            "cur": pspec.named_sharding(()),
        }
    return {k: pspec.named_sharding(("batch",) + (None,) * (t.dim() - 1),
                                    shape=t.shape)
            for k, t in spec.items()}


def opt_shardings(cfg: ModelConfig, zero_pod: bool = True) -> OptState:
    """Optimizer-state shardings: the parameters'. With ``zero_pod`` on a
    mesh that has a 'pod' axis the f32 master, m and v also split over
    'pod' (ZeRO-1 across pods: 'fsdp' resolves to 'pod' before its own
    axes), while the parameters stay pod-replicated."""
    mesh = pspec.active_mesh()
    if zero_pod and mesh is not None and "pod" in mesh.axis_names:
        rules = pspec.current_scope()[1]
        fsdp = rules.get("fsdp")
        fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp or ())
        with pspec.sharding_scope(mesh, dict(rules, fsdp=("pod",) + fsdp)):
            ps = P.param_shardings(cfg)
    else:
        ps = P.param_shardings(cfg)
    return OptState(step=pspec.named_sharding(()), master=ps, m=ps, v=ps)


def choose_seq_attn(cfg: ModelConfig, shape: ShapeConfig,
                    min_waste: float = 2.0) -> bool:
    """Context-parallel attention for this cell under the active scope?
    Yes when splitting heads would pad the KV heads ``min_waste`` times or
    more on the model axis and the sequence splits evenly (train and
    prefill only: decode attends a cache)."""
    if shape.kind == "decode":
        return False
    n_model = pspec.logical_axis_size("heads")
    if n_model <= 1 or cfg.n_kv_heads % n_model == 0:
        return False
    if shape.seq_len % n_model != 0:
        return False
    return (n_model / cfg.n_kv_heads) >= min_waste


# ------------------------------------------------------------ step builders
def make_prefill_step(cfg: ModelConfig, run: RunConfig,
                      s_max: int) -> Callable:
    """``prefill_step(model, batch) -> (last logits, cache)`` over a
    prefill batch of :func:`M.input_specs`' layout."""
    check_attn_impl(run.attn_impl)

    def prefill_step(model: M.Transformer, batch: Mapping[str, Any]):
        return M.prefill(model, run, batch["tokens"], s_max,
                         frames=batch.get("frames"),
                         patches=batch.get("patches"))
    return prefill_step


def make_serve_step(cfg: ModelConfig, run: RunConfig) -> Callable:
    """``serve_step(model, token, cache, cur) -> (logits, cache)``: one
    decode step, the cache updated in place."""
    check_attn_impl(run.attn_impl)

    def serve_step(model: M.Transformer, token: torch.Tensor, cache,
                   cur: int):
        return M.decode_step(model, run, token, cache, cur)
    return serve_step


def make_train_step(cfg: ModelConfig, run: RunConfig) -> Callable:
    """``train_step(model, opt, batch) -> metrics``: the loss and its
    gradients with respect to every parameter of ``model`` (averaged over
    ``run.microbatch`` equal slices of every batch entry, an ``encdec``'s
    frames or a ``vlm``'s patches too, when it is > 1), then one
    AdamW step that updates ``model``'s parameters and ``opt`` in place.
    The metrics are {"loss", "lr", "grad_norm", "clip_scale", "aux"} (the
    MoE auxiliary loss, 0 without experts; the mean over microbatches
    with them) and "nll" without microbatching, tensors on the model's
    device except the float "lr"."""
    check_attn_impl(run.attn_impl)

    def train_step(model: M.Transformer, opt: OptState,
                   batch: Mapping[str, torch.Tensor]) -> Dict[str, object]:
        params = dict(model.named_parameters())
        names, tensors = list(params), list(params.values())
        if run.microbatch and run.microbatch > 1:
            n = run.microbatch
            B = batch["tokens"].shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split into {n} "
                                 f"microbatches")
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in tensors]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tensors[0].device)
            asum = torch.zeros_like(lsum)
            for i in range(n):
                mb = {k: v[i * (B // n):(i + 1) * (B // n)]
                      for k, v in batch.items()}
                l, mm = M.loss_fn(model, run, mb)
                for acc, g in zip(gsum, torch.autograd.grad(l, tensors)):
                    acc.add_(g)
                lsum = lsum + l.detach()
                asum = asum + mm["aux"]
            grads = [g / n for g in gsum]
            loss = lsum / n
            metrics: Dict[str, object] = {"aux": asum / n}
        else:
            loss, metrics = M.loss_fn(model, run, batch)
            grads = torch.autograd.grad(loss, tensors)
            loss = loss.detach()

        lr = lr_schedule(opt.step, base_lr=run.lr,
                         warmup_steps=run.warmup_steps,
                         total_steps=run.total_steps)
        om = adamw_update(dict(zip(names, grads)), opt, params, lr=lr,
                          beta1=run.beta1, beta2=run.beta2,
                          weight_decay=run.weight_decay,
                          grad_clip=run.grad_clip)
        return {"loss": loss, "lr": lr, **metrics, **om}

    return train_step


# --------------------------------------------------------------- lowering --
@dataclasses.dataclass
class LoweredCell:
    """A cell's step and its meta arguments under the scope it was lowered
    in: the port's counterpart of the reference's ``jax.stages.Lowered``.
    ``args`` follow the model (``abstract_params``, by state dict key):
    train ``(opt, batch)`` with ``abstract_opt_state``'s step a Python int
    (``lr_schedule`` reads it as a number), prefill ``(batch,)``, decode
    ``(token, cache, cur)`` with a full cache, ``cur = S - 1``. ``donate``
    is recorded as the reference's argument: torch steps update their
    arguments in place, so it changes nothing here."""
    kind: str
    cfg: ModelConfig
    run: RunConfig
    shape: ShapeConfig
    step: Callable
    params: Dict[str, torch.Tensor]
    args: Tuple[Any, ...]
    param_shardings: Dict[str, Any]
    batch_shardings: Dict[str, Any]
    opt_shardings: Optional[OptState]
    mesh: Optional[pspec.AbstractMesh]
    rules: Dict
    donate: bool

    def instantiate(self) -> Tuple[M.Transformer, Tuple[Any, ...]]:
        """The model over the meta parameters (taking gradients for a
        train step) and the step's other arguments."""
        model = M.Transformer(self.cfg, self.params)
        if self.kind == "train":
            model.requires_grad_(True)
        return model, self.args

    def input_layouts(self) -> Iterator[Tuple[torch.Tensor, Any]]:
        """(meta input, its ``NamedSharding``) for every tensor input."""
        if self.kind == "decode":
            token, cache, _ = self.args
            yield token, self.batch_shardings["token"]
            for c, sh in zip(cache, self.batch_shardings["cache"]):
                for k in c:
                    yield c[k], sh[k]
            return
        for k, t in self.args[-1].items():
            yield t, self.batch_shardings[k]


def lower_cell(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
               donate: bool = True) -> Tuple[LoweredCell, str]:
    """The step of one (arch x shape) cell under the active sharding
    scope, switched to ``seq_attn_rules`` when :func:`choose_seq_attn`
    holds, as the reference's. Returns (lowered, kind)."""
    if choose_seq_attn(cfg, shape):
        mesh, rules = pspec.current_scope()
        with pspec.sharding_scope(mesh, pspec.seq_attn_rules(rules)):
            return _lower_cell_inner(cfg, run, shape, donate)
    return _lower_cell_inner(cfg, run, shape, donate)


def _lower_cell_inner(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                      donate: bool = True) -> Tuple[LoweredCell, str]:
    mesh, rules = pspec.current_scope()
    p_abs = P.abstract_params(cfg)
    b_abs = M.input_specs(cfg, shape)
    cell = dict(cfg=cfg, run=run, shape=shape, params=p_abs,
                param_shardings=P.param_shardings(cfg),
                batch_shardings=batch_shardings(cfg, shape),
                opt_shardings=None, mesh=mesh, rules=rules, donate=donate)
    if shape.kind == "train":
        opt = abstract_opt_state(p_abs)
        opt.step = 0
        return LoweredCell(kind="train", step=make_train_step(cfg, run),
                           args=(opt, b_abs),
                           **dict(cell, opt_shardings=opt_shardings(cfg))
                           ), "train"
    if shape.kind == "prefill":
        return LoweredCell(kind="prefill",
                           step=make_prefill_step(cfg, run,
                                                  s_max=shape.seq_len),
                           args=(b_abs,), **cell), "prefill"
    return LoweredCell(kind="decode", step=make_serve_step(cfg, run),
                       args=(b_abs["token"], b_abs["cache"],
                             shape.seq_len - 1), **cell), "decode"
