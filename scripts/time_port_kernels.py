#!/usr/bin/env python3
"""Time the port's kernels at the main path's shapes, on one GPU, for any
checkout of the port.

    python3 scripts/time_port_kernels.py [--src DIR] [--label NAME]
                                         [--arms planner,flash,ssd,steps]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), builds the kernels of the chosen arms, holds each against its
plain version and times it with ``chip_smoke.py``'s own checks: the
planner's ``rate_prefix`` and ``sweep`` on the first and the last chunk of
a 4096-job ``planner_scale`` window, and every launch of one such window;
flash attention at gemma3-12b's prefill shapes (global, window 1024 and
ragged); the SSD scan at mamba2-370m's training shapes; with ``steps``,
gemma3-12b's prefill and mamba2-370m's train step on the kernel path at
full size (CUDA-event ms) and the host time of one wrapper call at a
small shape (what the dispatch to a kernel costs). Prints one JSON
line per check, the device time of one call of each by kernel name
(``torch.profiler``; for the planner also the mean of 20 back-to-back
calls) and a summary line. Pointing ``--src`` at an unpacked earlier
commit times that commit's kernels with the same code, so two versions
are compared on one card in one run: parent, change, change, parent,
every run with the same ``--arms`` (each arm's kernels build and run
before the next arm's, so a run's arms are part of its conditions).
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def device_split(arms, fa, ssd, cfg, tcfg, cs) -> dict:
    """Device time by kernel name (``torch.profiler``) of one flash call
    (global case) and one SSD call at the main path's shapes, for those
    of the two among ``arms``."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    fns = {}
    if "flash" in arms:
        q, k, v = (torch.randn((cs.SERVE_BATCH, cs.PROMPT_LEN, h,
                                cfg.head_dim), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        fns["flash_global"] = lambda: fa.flash_attention(q, k, v)
    if "ssd" in arms:
        ins = cs.ssd_training_inputs(tcfg, gen)
        fns["ssd"] = lambda: ssd.ssd_scan(*ins, tcfg.ssm.chunk_size)
    return profiled_ms(fns)


def profiled_ms(fns: dict, calls: int = 1) -> dict:
    """Device ms by kernel name (``torch.profiler``) per call of each
    function: the mean over ``calls`` back-to-back warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out[name] = {e.key[:60]: e.self_device_time_total / 1e3 / calls
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
    return out


def window_kernel_ms(planner, jobs) -> dict:
    """Every planner kernel launch of one ``plan_batch`` window under
    ``torch.profiler``, in launch order (device ms each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    planner.plan_batch(jobs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        planner.plan_batch(jobs)
        torch.cuda.synchronize()
    out = {"rate_prefix": [], "sweep": []}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in out:
            if f"{name}_kernel" in e.name:
                out[name].append(e.time_range.elapsed_us() / 1e3)
    return out


def planner_arm(cs, built) -> dict:
    """Both planner kernels on the first and the last chunk of window 0
    of ``planner_scale``, as ``chip_smoke.py`` phase 3 checks them."""
    from repro_torch.core.scheduler import grid_cuda
    from repro_torch.core.scheduler import grid_torch as gt
    from repro_torch.core.scheduler import planner as tp
    ftns, job = cs.planner_scale_jobs(tp)
    planner = tp.TorchCarbonPlanner(ftns, device="cuda",
                                    batch_backend="fused")
    log = built[grid_cuda._SOURCE.name][1]
    # a checkout from before the shared-memory getters reports ptxas alone
    report = (cs.planner_resources
              if hasattr(grid_cuda._library(), "planner_sweep_smem_bytes")
              else lambda gc, x, log: cs.planner_ptxas(log))
    out = {}
    for name, (x, n_cells) in cs.window_chunks(planner, job, grid_cuda,
                                               gt).items():
        case = cs.check_chunk(grid_cuda, x, n_cells)
        for k, res in report(grid_cuda, x, log).items():
            case[k].update(res)
        r, e = grid_cuda.rate_prefix(x.pp, x.zn, x.hn, x.rel0, x.tc,
                                     dt_s=cs.DT_S, t_pad=x.t_pad)
        fns = {"rate_prefix": lambda: grid_cuda.rate_prefix(
                   x.pp, x.zn, x.hn, x.rel0, x.tc, dt_s=cs.DT_S,
                   t_pad=x.t_pad),
               "sweep": lambda: grid_cuda.sweep(
                   e, r, x.scl, x.pidx, x.wd, x.sla, stride=cs.STRIDE,
                   dt_s=cs.DT_S, slot_s=cs.SLOT_S)}
        case["device_ms_by_kernel"] = profiled_ms(fns)
        case["device_ms_by_kernel_mean_of_20"] = profiled_ms(fns, calls=20)
        cs.emit({"planner_check": {"chunk": name, **case}})
        out[name] = case
    launches = window_kernel_ms(planner, [job(i) for i in range(cs.WINDOW)])
    out["window"] = {name: {"launches": len(ms), "total_ms": sum(ms),
                            "first_ms": ms[0], "last_ms": ms[-1],
                            "min_ms": min(ms), "max_ms": max(ms)}
                     for name, ms in launches.items()}
    cs.emit({"planner_window_device_ms": {**out["window"],
                                          "each": launches}})
    return out


STEPS_TIMED = 5
HOST_CALLS = 200


def step_ms(cs, arch: str, kind: str, batch: int, seq: int) -> dict:
    """CUDA-event ms of one step of ``arch`` on the kernel path at full
    size, random weights from SEED (median of STEPS_TIMED after a warm
    call)."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import steps
    cfg = get_config(arch)
    run = RunConfig(arch=arch, attn_impl="flash", seed=cs.SEED)
    shape = ShapeConfig(f"{kind}_{seq}", seq_len=seq, global_batch=batch,
                        kind=kind)
    model = M.build_model(cfg, seed=cs.SEED, device="cuda")
    data = {k: v.cuda() for k, v in M.make_batch(
        cfg, shape, torch.Generator().manual_seed(cs.SEED)).items()}
    if kind == "train":
        model.requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, run)

        def call():
            return step(model, opt, data)
    else:
        step = steps.make_prefill_step(cfg, run, s_max=seq)

        def call():
            return step(model, data)
    call()
    times = []
    for _ in range(STEPS_TIMED):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    del model, data, step
    torch.cuda.empty_cache()
    return {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
            "ms": statistics.median(times), "timed_ms": times}


def host_us(fa, ssd) -> dict:
    """Host microseconds a call of each wrapper takes to return, the mean
    of HOST_CALLS back-to-back calls at a small shape whose kernels take
    less device time than that."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(1, 128, 2, 64, generator=gen, **bf16)
    x = torch.randn(1, 256, 2, 64, generator=gen, **bf16)
    dt = torch.rand(1, 256, 2, generator=gen, device="cuda")
    a = -torch.ones(2, device="cuda")
    bc = torch.randn(1, 256, 1, 128, generator=gen, **bf16)
    out = {}
    for name, fn in (("flash_attention", lambda: fa.flash_attention(q, q, q)),
                     ("ssd_scan", lambda: ssd.ssd_scan(x, dt, a, bc, bc))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = 1e6 * host / HOST_CALLS
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--arms", default="planner,flash,ssd",
                    help="comma-separated: planner, flash, ssd, steps")
    args = ap.parse_args()
    arms = set(args.arms.split(","))
    if not arms <= {"planner", "flash", "ssd", "steps"}:
        ap.error(f"unknown arms: {sorted(arms)}")
    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    # before chip_smoke, which puts this checkout's src first and imports
    # repro_torch from there
    import repro_torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not from {src}")
    from repro_torch._build import build
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import grid_cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    card = cs.gpu_line()
    print(card, flush=True)
    sources = {"planner": [grid_cuda._SOURCE], "flash": [fa._SOURCE],
               "ssd": [ssd._SOURCE], "steps": [fa._SOURCE, ssd._SOURCE]}
    t0 = time.perf_counter()
    built = build(*dict.fromkeys(src for a in sorted(arms)
                                 for src in sources[a]))
    build_s = time.perf_counter() - t0
    for _, log in built.values():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print("ptxas:", line.strip(), flush=True)
    summary = {"label": args.label, "src": str(src), "card": card,
               "build_s": build_s}
    if "planner" in arms:
        planner = planner_arm(cs, built)
        chunks = ("first", "last")
        for k in ("rate_prefix", "sweep"):
            summary[f"{k}_ms"] = {c: planner[c][k]["ms"] for c in chunks}
            summary[f"{k}_bound_share"] = {
                c: planner[c][k]["bound_share"] for c in chunks}
            summary[f"{k}_window_device_ms"] = planner["window"][k]
    if "flash" in arms:
        f_use = cs.ptxas_usage(built[fa._SOURCE.name][1], cs.FLASH_KERNEL)
        flash = cs.check_flash(fa, get_config(cs.ARCH), f_use or None)
        summary["flash_ms"] = {c["case"]: c["ms"] for c in flash}
        summary["sdpa_ms"] = {c["case"]: c["library_ms"] for c in flash}
    if "ssd" in arms:
        s_use = cs.ptxas_usage(built[ssd._SOURCE.name][1],
                               cs.SSD_KERNEL_PREFIX)
        summary["ssd_ms"] = cs.check_ssd(ssd, get_config(cs.TRAIN_ARCH),
                                         s_use or None)["ms"]
    if arms & {"flash", "ssd"}:
        cs.emit({"device_ms_by_kernel": device_split(
            arms, fa, ssd, get_config(cs.ARCH), get_config(cs.TRAIN_ARCH),
            cs)})
    if "steps" in arms:
        summary["host_us_per_call"] = host_us(fa, ssd)
        summary["steps_ms"] = [
            step_ms(cs, "gemma3-12b", "prefill", cs.SERVE_BATCH,
                    cs.PROMPT_LEN),
            step_ms(cs, cs.TRAIN_ARCH, "train", cs.TRAIN_BATCH,
                    cs.TRAIN_SEQ)]
    cs.emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
