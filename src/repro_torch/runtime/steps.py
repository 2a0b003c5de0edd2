"""The train step: the reference's ``runtime/steps.py::
make_train_step``, microbatch accumulation included. The sharding trees
and the lowering of each cell wait for the port's mesh layer (ROADMAP.md,
queue 1, last item).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.models.layers import check_attn_impl
from repro_torch.optim.adamw import OptState, adamw_update
from repro_torch.optim.schedule import lr_schedule


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
