#!/usr/bin/env python3
"""Time the port's cached decode step of one served model on one GPU, for
any checkout of the port.

    python3 scripts/time_decode.py [--src DIR] [--label NAME]
                                   [--arch mamba2-370m] [--rounds 5]
                                   [--steps 32]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), builds ``--arch`` at full size with random weights from seed 0
on the card, prefills 4 prompts of 2048 random tokens on the kernel path
(``attn_impl="flash"``), then runs greedy decode steps as ``Server`` does:
8 warm steps, ``--rounds`` rounds of ``--steps`` steps timed on the
host's clock (one synchronize at each round's end), and 4 steps under
``torch.profiler``, whose device events (kernels, copies and sets) are
counted and summed per step. Prints one JSON line with the card's name
and power limit. Pointing ``--src`` at an unpacked earlier commit times
that commit's decode with the same code, so two versions are compared on
one card in one call: parent, change, change, parent. Exits 2 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
BATCH, PROMPT_LEN, WARM, PROFILED = 4, 2048, 8, 4


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    cfg = get_config(args.arch)
    run = RunConfig(arch=args.arch, attn_impl="flash", remat="none", seed=0)
    model = M.build_model(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=torch.Generator().manual_seed(0)
                           ).cuda()
    n_steps = WARM + args.rounds * args.steps + PROFILED
    logits, cache = M.prefill(model, run, tokens, PROMPT_LEN + n_steps)
    cur = PROMPT_LEN

    def step():
        nonlocal logits, cache, cur
        logits, cache = M.decode_step(model, run, logits.argmax(-1)[:, None],
                                      cache, cur)
        cur += 1

    for _ in range(WARM):
        step()
    torch.cuda.synchronize()
    rounds_ms = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        rounds_ms.append((time.perf_counter() - t0) * 1e3 / args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(json.dumps({"decode_timing": {
        "label": args.label, "src": args.src, "arch": args.arch,
        "card": card(), "batch": BATCH, "prompt_len": PROMPT_LEN,
        "steps_per_round": args.steps, "round_ms_per_step": rounds_ms,
        "mean_ms_per_step": sum(rounds_ms) / len(rounds_ms),
        "min_round_ms_per_step": min(rounds_ms),
        "profiled_steps": PROFILED,
        "device_events_per_step": len(dev) / PROFILED,
        "device_ms_per_step": device_ms / PROFILED,
        "profiled_wall_ms_per_step": prof_wall_ms / PROFILED,
        "busy_share": device_ms / prof_wall_ms,
        "finite": bool(torch.isfinite(logits).all())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
