"""Training cells: the port's ``Trainer`` at the mix's batch, on the
``TokenPipeline``'s seeded tokens.

Set-up builds one ``Trainer`` on the benchmark's weights and runs its
first steps through ``Trainer.run_steps``, the window's own call and
feed: step 1 alone, so that the optimizer's first moment gives the first
gradient as AdamW took it (m / (1 - beta1)), then the rest, after which
the float32 master weights give each leaf's change. The same object then
runs the window: whole steps, their number set from the last set-up
steps' time so that the window lasts about ``--seconds``, ending on a
device synchronisation. After the window the reference follows the first
steps from the same weights on the same batches, worked out again from
the seed, and the judge compares the two.
"""
from __future__ import annotations

import math
import tempfile
import time

import torch

from cellbench import judge
from cellbench.drivers import (Ctx, Outcome, Window, finite, free, peak,
                               per_token, sync)
from cellbench.generate import pipeline_tokens
from cellbench.reference import decoder as ref_decoder
from cellbench.reference import family
from cellbench.weights import make_weights


def run(ctx: Ctx) -> Outcome:
    from repro_torch.runtime.train_loop import TrainLoopConfig, Trainer
    mix, cfg = ctx.cell.traffic, ctx.cfg
    B, S, first = mix["batch"], mix["seq_len"], mix["first_steps"]
    w = make_weights(cfg, ctx.seed, ctx.device)
    ctx.phase("weights")
    with tempfile.TemporaryDirectory(prefix="cellbench-ckpt-") as ck:
        # no checkpoint is due: one save of a full model's state writes
        # gigabytes, more than a run may write
        loop = TrainLoopConfig(ckpt_every=1 << 40, ckpt_dir=ck)
        tr = Trainer(cfg, ctx.run, loop, batch_override=B, seq_override=S,
                     device=ctx.device, params=w)
        ctx.phase("program")
        losses = []
        step_fn = tr.step_fn

        def recorded(model, opt, batch):
            out = step_fn(model, opt, batch)
            losses.append(out["loss"])
            return out

        tr.step_fn = recorded
        tr.run_steps(1)
        grad1 = {k: float(m.norm()) / (1 - ctx.run.beta1)
                 for k, m in tr.opt.m.items()}
        tr.start_step = 1
        t = time.perf_counter()
        tr.run_steps(first)
        sync(ctx)
        t_step = (time.perf_counter() - t) / (first - 1)
        change = {k: float((tr.opt.master[k] - w[k].float()).norm())
                  for k in w}
        tr.step_fn = step_fn
        ctx.phase("first steps")
        prog = {"loss": [float(x) for x in losses], "grad1": grad1,
                "change": change}
        n = max(2, math.ceil(ctx.seconds / t_step))
        if ctx.trace:
            # each step as a host range, which the breakdown's idle gaps
            # are named by
            ctx.spans.wrap(tr, "step_fn", "train.step_fn")
        tr.start_step = first
        logged = len(tr.history)
        with Window(ctx):
            tr.run_steps(first + n)
        ctx.memory_peak = peak(ctx)
        bad = sum(not finite([h["loss"]]) for h in tr.history[logged:])
        del tr, step_fn, recorded
        free(ctx)

    m = ctx.cell.model_fields()
    batches = []
    for i in range(first):
        tok, tgt = pipeline_tokens(ctx.seed, B, S, m["vocab_size"], 0, i)
        batches.append((torch.from_numpy(tok).to(ctx.device),
                        torch.from_numpy(tgt).to(ctx.device)))
    ref = ref_decoder.train_follow(w, m, family(m["family"]).kinds(m),
                                   ctx.cell.run_fields(), batches)
    tokens = n * B * S
    return Outcome(
        metrics={"train_tokens_per_s": tokens / ctx.window_s,
                 "energy_mj_per_token": per_token(ctx.energy_j, tokens)},
        counts={"tokens": tokens, "steps": n, "energy_j": ctx.energy_j},
        numbers=judge.train_numbers(prog, ref),
        attempted=n, failed=bad,
        extra={"program": prog, "reference": ref, "weights": w,
               "batches": batches})
