#!/usr/bin/env python3
"""Which batch of a moe or hybrid training cut fits one GPU, and how far
its kernel path and plain path route apart without a replay.

    python3 scripts/train_fit.py [--seq 2048] [--cut jamba|arctic|kimi]

For each cut of ``chip_smoke.MOE_TRAIN_PHASES`` (published widths, depth
and expert count cut), in a process of its own (``--cut``) so that no
cut finds memory another left behind: builds the model with random
weights from seed 0 and its AdamW state on the card (16 bytes a
parameter with the bf16 gradients), then runs one train step
(``runtime.steps.make_train_step``, ``remat="block"``, the kernel path)
at batch 1, 2, 4 and 8 x ``--seq`` tokens, smallest first, until a step
runs out of device memory: one JSON line a batch with the step's seconds
and peak GB, or the error. Then, without the optimizer state, one loss
and gradient at the smallest batch and at the largest that fitted on the
kernel path (flash, the SSD kernel) and on the plain path (blockwise
attention, the chunked scan), each routing on its own: the relative
differences of loss, gradient norm and aux, the top-k choices that
differ per MoE layer, and whether each layer's ``remat`` recompute chose
as its forward did. Prints the card's name and power limit. Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def tokens(cfg, batch: int, seq: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=gen).to("cuda")
            for k in ("tokens", "targets")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--cut", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_fit: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke
    if args.cut is None:
        emit({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()})
        return max(subprocess.run(
            [sys.executable, __file__, "--seq", str(args.seq), "--cut",
             p[1]]).returncode for p in chip_smoke.MOE_TRAIN_PHASES)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step

    calls: list = []
    real_route = moe.route

    def recorded(w, x, cfg):
        out = real_route(w, x, cfg)
        calls.append((id(w), out[1]))
        return out

    moe.route = recorded
    for _, label, arch, layers, experts, _ in chip_smoke.MOE_TRAIN_PHASES:
        if label != args.cut:
            continue
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers, moe=dataclasses
                                  .replace(full.moe, n_experts=experts))
        model = M.build_model(cfg, seed=0, device="cuda")
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt = adamw.adamw_init(params)
        run = RunConfig(arch=arch, attn_impl="flash", remat="block", seed=0,
                        warmup_steps=2, total_steps=3)
        step = make_train_step(cfg, run)
        torch.cuda.synchronize()
        emit({"cut": label, "arch": arch, "layers": layers,
              "experts": experts, "params": sum(p.numel()
                                                for p in params.values()),
              "state_gb": torch.cuda.memory_allocated() / 1e9})
        fits = []
        for b in (1, 2, 4, 8):
            batch = tokens(cfg, b, args.seq, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                t0 = time.perf_counter()
                m = step(model, opt, batch)
                torch.cuda.synchronize()
                emit({"cut": label, "batch": b,
                      "step_s": time.perf_counter() - t0,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "loss": float(m["loss"])})
                fits.append(b)
            except torch.cuda.OutOfMemoryError as err:
                emit({"cut": label, "batch": b,
                      "out_of_memory": str(err).splitlines()[0]})
                break
            finally:
                del batch
                calls.clear()
                torch.cuda.empty_cache()
        del opt
        torch.cuda.empty_cache()
        for b in sorted({fits[0], fits[-1]}) if fits else ():
            batch = tokens(cfg, b, args.seq, 1)
            res = {}
            for impl in ("flash", "blockwise"):
                calls.clear()
                loss, mm = M.loss_fn(model, dataclasses.replace(
                    run, attn_impl=impl), batch)
                grads = torch.autograd.grad(loss, list(params.values()))
                res[impl] = (float(loss.detach()),
                             float(adamw.global_norm(grads)),
                             float(mm["aux"]), list(calls))
                del grads
            (lk, gk, ak, ck), (lp, gp, ap, cp) = (res["flash"],
                                                  res["blockwise"])
            n = len(ck) // 2
            emit({"cut": label, "compare_batch": b,
                  "loss_rel_diff": rel(lk, lp),
                  "gnorm_rel_diff": rel(gk, gp),
                  "aux_rel_diff": rel(ak, ap),
                  "flips_by_layer": [
                      int((a[1].sort(-1)[0] != c[1].sort(-1)[0]).any(-1)
                          .sum()) for a, c in zip(ck[:n], cp[:n])],
                  "remat_same_choices": all(
                      f[0] == r[0] and torch.equal(f[1], r[1])
                      for f, r in zip(ck[:n], ck[n:]))})
            del batch, res
            calls.clear()
            torch.cuda.empty_cache()
        del model, params
        torch.cuda.empty_cache()
    moe.route = real_route
    return 0


if __name__ == "__main__":
    sys.exit(main())
