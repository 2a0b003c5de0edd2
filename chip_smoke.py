#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the planner's two CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
``sm_90a``, into ``build/repro_torch_kernels/``), holds each against its
plain torch version on the tables of a real 4096-job admission window,
then drives the port's main path — ``TorchCarbonPlanner.plan_batch`` over
four 4096-job windows of the ``planner_scale`` deployment — and checks 32
sampled plans against the port's numpy oracle. Every phase that fails
raises, so the exit code is non-zero; without a CUDA device the script
exits 2 and prints no result. The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WINDOW = 4096                  # jobs per admission window (planner_scale)
N_WINDOWS = 4
N_SAMPLED = 32                 # oracle spot check, as planner_scale samples
N_TIMED = 25                   # CUDA-event timings per kernel (median)
DT_S, SLOT_S, STRIDE = 60.0, 3600.0, 60

# H100 SXM peaks: HBM bytes/s, f32 and f64 non-tensor FLOP/s (NVIDIA's
# data sheet)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12

REPO = Path(__file__).resolve().parent
KERNEL_SRC = "src/repro_torch/csrc/planner_kernels.cu"


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, n: int = N_TIMED) -> float:
    """Median of ``n`` warm single-call timings by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def planner_scale_jobs(mod):
    """The ``planner_scale`` deployment (benchmarks/perf.py): FTNs, and a
    job generator over sizes 20-619 GB, deadlines 12-47 h and submissions
    spread over 24 h in 300 s steps."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    ftns = [mod.FTN("uc", "skylake", 10.0), mod.FTN("m1", "apple_m1", 1.2),
            mod.FTN("tacc", "cascade_lake", 10.0)]

    def job(i: int):
        return mod.TransferJob(
            f"s{i}", (20 + (13 * i) % 600) * 1e9,
            ("uc", "m1") if i % 3 else ("uc",), "tacc",
            mod.SLA(deadline_s=(12 + i % 36) * 3600.0),
            t0 + (i % 288) * 300.0)

    return ftns, job


def rate_prefix_bound_ms(x) -> tuple:
    """Least time for rate_prefix on these inputs: each input read once,
    r (f32) and E (f64) written once, against ~27 f32 and ~16 f64
    operations per (pair, hop, step) — the CI chain and the time math plus
    the scan's add."""
    a, h, _ = x.zn.shape
    steps = a * h * x.t_pad
    nbytes = (4 * (x.pp.numel() + x.zn.numel() + x.hn.numel())
              + 8 * (x.rel0.numel() + x.tc.numel()) + 12 * steps)
    ops_s = max(27 * steps / F32_FLOPS, 16 * steps / F64_FLOPS)
    return 1e3 * max(nbytes / HBM_BPS, ops_s), (
        "bytes" if nbytes / HBM_BPS >= ops_s else "operations")


def sweep_bound_ms(x, n_cells: int) -> tuple:
    """Least time for sweep on this chunk's data: the result depends only
    on live cells, hops with a non-zero weight and slots before n_valid,
    so count the distinct E, r and scale entries those read (8, 4, 8
    bytes), each live cell's rows, and the (cost, emis, slot) written;
    operations are ~5 f64 per (cell, leg, hop, slot) plus ~14 per
    (cell, leg, slot)."""
    dev = x.sla.device
    a, h, t_pad = x.zn.shape[0], x.zn.shape[1], x.t_pad
    s_pad = x.scl.shape[1]
    sla, pidx = x.sla[:n_cells], x.pidx[:n_cells].long()
    slots = torch.arange(s_pad, device=dev)
    valid = slots[None, :] < sla[:, 2].long()[:, None]          # (C,S)
    live = x.wd[:n_cells] != 0                                  # (C,2,H)
    k = slots * STRIDE
    hi = (k[None, :] + sla[:, 0].long()[:, None] - 1).clamp(0, t_pad - 1)
    rows = (pidx[:, :, None] * h + torch.arange(h, device=dev)) * t_pad
    mask = live[..., None] & valid[:, None, None, :]            # (C,2,H,S)
    at_hi = (rows[..., None] + hi[:, None, None, :])[mask]
    at_k = (rows[..., None] + k.clamp(max=t_pad - 1))[mask]
    n_e = torch.unique(torch.cat([at_hi, at_k])).numel()
    n_r = torch.unique(at_hi).numel()
    leg_valid = live.any(dim=2)[:, :, None] & valid[:, None, :]  # (C,2,S)
    n_scl = torch.unique((pidx[:, :, None] * s_pad + slots)[leg_valid]).numel()
    nbytes = (8 * n_e + 4 * n_r + 8 * n_scl
              + n_cells * (8 * 8 + 2 * 4 + 8 * int(live[0].numel()))
              + n_cells * 3 * 8)
    ops = 5 * int(mask.sum()) + 14 * int(leg_valid.sum())
    return 1e3 * max(nbytes / HBM_BPS, ops / F64_FLOPS), (
        "bytes" if nbytes / HBM_BPS >= ops / F64_FLOPS else "operations")


def check_kernels(planner, job, grid_cuda, gt) -> list:
    """Phase 3: both kernels against their plain versions on the first
    chunk of a real window, with the main path's own table builders."""
    dev = planner.device
    jobs = [job(i) for i in range(WINDOW)]
    cells, sla_rows, _ = planner._batch_cells(jobs, DT_S, STRIDE)
    chunk = next(gt._iter_chunks(cells, STRIDE, grid_cuda._MAX_ELEMS_PALLAS))
    t = gt._chunk_tables(planner.field, [cells[j] for j in chunk], dt_s=DT_S,
                         slot_stride=STRIDE, cell_bucket=gt._B_CELLS)
    x = grid_cuda.fused_inputs(
        gt.tables_to_device(t, dev),
        grid_cuda.sla_table(t, np.asarray(sla_rows)[chunk]),
        grid_cuda.scale_table(t, SLOT_S, None))
    emit({"check_chunk": {"cells": len(chunk), "pairs": t.n_pairs,
                          "rows": list(x.zn.shape[:2]), "t_pad": x.t_pad,
                          "slots": x.scl.shape[1]}})

    def rate(fn):
        return lambda: fn(x.pp, x.zn, x.hn, x.rel0, x.tc, dt_s=DT_S,
                          t_pad=x.t_pad)

    r_k, e_k = rate(grid_cuda.rate_prefix)()
    r_p, e_p = rate(grid_cuda.rate_prefix_plain)()
    torch.cuda.synchronize()
    # r: f32 rounding only (1e-6 relative); E: f64 summation order only,
    # judged against each row's total
    r_rel = float(((r_k - r_p).abs() / r_p.abs()).max())
    row_tot = (e_p[..., -1] + r_p[..., -1].double())[..., None]
    e_rel = float(((e_k - e_p).abs() / row_tot).max())
    rp_abs = max(float((r_k - r_p).abs().max()),
                 float((e_k - e_p).abs().max()))
    if not (r_rel <= 1e-6 and e_rel <= 1e-9):
        raise RuntimeError(f"rate_prefix disagrees with its plain version: "
                           f"r rel {r_rel:.3e}, E rel to row total "
                           f"{e_rel:.3e}")

    def sw(fn):
        return lambda: fn(e_k, r_k, x.scl, x.pidx, x.wd, x.sla,
                          stride=STRIDE, dt_s=DT_S, slot_s=SLOT_S)

    b_k = sw(grid_cuda.sweep)()
    b_p = sw(grid_cuda.sweep_plain)()
    torch.cuda.synchronize()
    n_slot = int((b_k[:, 2] != b_p[:, 2]).sum())
    fin = torch.isfinite(b_p[:, :2])
    if not torch.equal(fin, torch.isfinite(b_k[:, :2])):
        raise RuntimeError("sweep: kernel and plain version disagree on "
                           "which cells are feasible")
    diff = (b_k[:, :2] - b_p[:, :2])[fin].abs()
    sw_rel = float((diff / b_p[:, :2][fin].abs()).max()) if diff.numel() \
        else 0.0
    sw_abs = float(diff.max()) if diff.numel() else 0.0
    if n_slot or not sw_rel <= 1e-9:
        raise RuntimeError(f"sweep disagrees with its plain version: "
                           f"{n_slot} slot mismatches, cost/emis rel "
                           f"{sw_rel:.3e}")
    rp_bound, rp_by = rate_prefix_bound_ms(x)
    sw_bound, sw_by = sweep_bound_ms(x, len(chunk))
    rows = [
        {"name": "rate_prefix", "route": "cuda", "source": KERNEL_SRC,
         "replaces": "src/repro/core/scheduler/grid_pallas.py:77",
         "max_abs_err": rp_abs, "max_rel_err": max(r_rel, e_rel),
         "r_max_rel_err": r_rel, "e_max_rel_err_of_row_total": e_rel,
         "ms": median_ms(rate(grid_cuda.rate_prefix)),
         "plain_ms": median_ms(rate(grid_cuda.rate_prefix_plain)),
         "bound_ms": rp_bound, "bound_by": rp_by, "library_ms": None},
        {"name": "sweep", "route": "cuda", "source": KERNEL_SRC,
         "replaces": "src/repro/core/scheduler/grid_pallas.py:125",
         "max_abs_err": sw_abs, "max_rel_err": sw_rel,
         "slot_mismatches": n_slot,
         "feasible_cells": int(fin[:len(chunk), 0].sum()),
         "ms": median_ms(sw(grid_cuda.sweep)),
         "plain_ms": median_ms(sw(grid_cuda.sweep_plain)),
         "bound_ms": sw_bound, "bound_by": sw_by, "library_ms": None},
    ]
    return rows


class SplitTimer:
    """Times the stages of one window: host table builds by the host
    clock, and each kernel by CUDA events recorded around its launch in
    the bound library, so the wrappers and their launch counts run as
    they are."""

    LAUNCHES = {"rate_prefix": "planner_rate_prefix",
                "sweep": "planner_sweep"}

    def __init__(self, grid_cuda):
        self.gc = grid_cuda
        self.lib = grid_cuda._library()
        self.orig_tables = grid_cuda._chunk_tables
        self.orig_launch = {k: getattr(self.lib, sym)
                            for k, sym in self.LAUNCHES.items()}
        self.reset()

    def reset(self):
        self.table_s, self.chunks = 0.0, 0
        self.events = {k: [] for k in self.LAUNCHES}

    def __enter__(self):
        def tables(*a, **k):
            t0 = time.perf_counter()
            out = self.orig_tables(*a, **k)
            self.table_s += time.perf_counter() - t0
            self.chunks += 1
            return out

        def timed(name):
            launch = self.orig_launch[name]

            def run(*a):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                err = launch(*a)
                stop.record()
                self.events[name].append((start, stop))
                return err
            return run

        self.gc._chunk_tables = tables
        for name, sym in self.LAUNCHES.items():
            setattr(self.lib, sym, timed(name))
        return self

    def __exit__(self, *exc):
        self.gc._chunk_tables = self.orig_tables
        for name, sym in self.LAUNCHES.items():
            setattr(self.lib, sym, self.orig_launch[name])

    def kernel_ms(self) -> dict:
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self.events.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scheduler import grid_cuda
    from repro_torch.core.scheduler import grid_torch as gt
    from repro_torch.core.scheduler import planner as tp

    # 1. device
    card = gpu_line()
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    lib, log = grid_cuda.build_kernels()
    grid_cuda._library()
    emit({"build_s": time.perf_counter() - t0, "library": lib.name})
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)

    # 3. kernels against their plain versions
    ftns, job = planner_scale_jobs(tp)
    planner = tp.TorchCarbonPlanner(ftns, device="cuda",
                                    batch_backend="fused")
    kernels = check_kernels(planner, job, grid_cuda, gt)
    kernel_fns = {"rate_prefix": grid_cuda.rate_prefix,
                  "sweep": grid_cuda.sweep}

    # 4. the main path: plan_batch over 4096-job windows
    for fn in kernel_fns.values():
        fn.launches = 0
    total_chunks, total_jobs, wall_total = 0, 0, 0.0
    with SplitTimer(grid_cuda) as split:
        for w in range(N_WINDOWS):
            split.reset()
            jobs = [job(i) for i in range(w * WINDOW, (w + 1) * WINDOW)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans = planner.plan_batch(jobs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kms = split.kernel_ms()
            if len(plans) != len(jobs) or any(
                    p is None or p.job_uuid != j.uuid
                    for p, j in zip(plans, jobs)):
                raise RuntimeError(f"window {w}: plans do not match jobs")
            feas = [p for p in plans if p.feasible]
            if not feas or not all(
                    np.isfinite(p.predicted_emissions_g)
                    and p.predicted_emissions_g > 0 for p in feas):
                raise RuntimeError(f"window {w}: no feasible plan, or a "
                                   f"non-finite / non-positive emission")
            total_chunks += split.chunks
            total_jobs += len(jobs)
            wall_total += wall
            kernel_s = sum(kms.values()) / 1e3
            emit({"window": w, "jobs": len(jobs),
                  "cells": planner.last_batch_cells,
                  "chunks": split.chunks, "feasible": len(feas),
                  "wall_s": wall, "host_table_build_s": split.table_s,
                  "kernel_ms": kms,
                  "host_planning_other_s": wall - split.table_s - kernel_s,
                  "kernel_share": kernel_s / wall})
    launches = {n: fn.launches for n, fn in kernel_fns.items()}
    emit({"main_path": {"windows": N_WINDOWS, "jobs": total_jobs,
                        "jobs_per_s": total_jobs / wall_total,
                        "chunks": total_chunks, "launches": launches}})
    if not (total_chunks > 0
            and all(n == total_chunks for n in launches.values())):
        raise RuntimeError(f"kernel launches {launches} != chunks "
                           f"{total_chunks}")
    for row in kernels:
        row["launches"] = launches[row["name"]]

    # 5. oracle: sampled plans against the port's numpy plan_batch
    idxs = sorted({int(i) for i in
                   np.linspace(0, total_jobs - 1, N_SAMPLED).round()})
    sample = [job(i) for i in idxs]
    got = planner.plan_batch(sample)
    want = tp.TorchCarbonPlanner(ftns, device="cuda",
                                 batch_backend="numpy").plan_batch(sample)
    mism, rel = 0, 0.0
    for g, w in zip(got, want):
        if (g.start_t, g.source, g.ftn, g.feasible) != \
                (w.start_t, w.source, w.ftn, w.feasible):
            mism += 1
        elif w.feasible:
            rel = max(rel, abs(g.predicted_emissions_g
                               - w.predicted_emissions_g)
                      / max(w.predicted_emissions_g, 1e-12))
    emit({"oracle": {"sampled": len(sample), "mismatches": mism,
                     "max_emis_rel_err": rel}})
    if mism or not rel <= 1e-4:
        raise RuntimeError(f"fused plans diverge from the numpy oracle: "
                           f"{mism} mismatches, emissions rel {rel:.3e}")

    # 6. results
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
