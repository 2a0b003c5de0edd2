#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, started together, ``sm_90a``, into ``build/repro_torch_kernels/``)
and drives the port's three paths:

* fleet admission planning: the planner's two kernels against their plain
  torch versions on the tables of a real 4096-job admission window, then
  ``TorchCarbonPlanner.plan_batch`` over four 4096-job windows of the
  ``planner_scale`` deployment, with 32 sampled plans checked against the
  port's numpy oracle;
* the fleet control plane's closed loop: ``examples/fleet_day.py``'s first
  act (4000 jobs over 24 simulated hours, a 4-shard ``ShardedFleet``, a 6x
  forecast shock at 11:00 for six hours) on the default fused backend,
  admission and the shards' re-plan sweeps planning through the two
  planner kernels, then the same day on the numpy oracle: every job the
  same admission cell and outcome row, emissions within 1e-4, and
  fleet_day's own acceptance (all jobs done, a migration, a re-plan, the
  merged ledger audit within 1e-9);
* serving gemma3-12b at full width and depth (48 layers, d_model 3840,
  vocab 262144, random weights from a seed): the flash-attention kernel
  against its plain version at the prefill's shapes (global, window 1024
  and a ragged length), then ``Server`` answering 8 requests of 2048-token
  prompts with 32 new tokens each, the cached logits checked against a
  plain full forward and the flash prefill against the naive one;
* training mamba2-370m at full width and depth (48 layers, d_model 1024,
  vocab 50280, 32 SSD heads of 64, d_state 128, chunk 256, random weights
  from a seed) on 8 x 2048-token batches: the SSD chunk-scan kernel
  against its plain version at the training shapes, one train step on the
  kernel path against the same step on the plain chunked path, then
  ``Trainer`` for 6 steps with a checkpoint every 3 and a bit-exact
  restore, and a ``torch.profiler`` split of one step.

Every phase that fails raises, so the exit code is non-zero; without a
CUDA device the script exits 2 and prints no result. The last line of
stdout is one JSON object ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
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

# H100 SXM peaks: HBM bytes/s, f32 and f64 non-tensor FLOP/s, bf16 dense
# tensor-core FLOP/s (NVIDIA's data sheet)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
BF16_TC_FLOPS = 989e12

REPO = Path(__file__).resolve().parent
KERNEL_SRC = "src/repro_torch/csrc/planner_kernels.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/csrc/ssd_scan.cu"
# Names by which the profiler and ptxas find the kernels: the flash kernel
# (one template per head_dim chunk count), and every pass an SSD call
# launches. Neither may contain a word of GEMM_NAMES.
FLASH_KERNEL = "flash_fwd_wgmma"
SSD_KERNEL_PREFIX = "ssd_scan_"
SSD_PASSES = ("ssd_scan_cb", "ssd_scan_chunk_state", "ssd_scan_state_pass",
              "ssd_scan_chunk_out")

# serving: gemma3-12b at full width and depth, 8 requests in static batches
# of 4, 2048-token prompts, 32 new tokens each
DEVICE = "cuda"
ARCH = "gemma3-12b"
SERVE_BATCH, N_REQUESTS, PROMPT_LEN, MAX_NEW = 4, 8, 2048, 32
S_MAX = 2080
SEED = 0
# training: mamba2-370m at full width and depth, 8 x 2048 tokens a step,
# 6 Trainer steps with a checkpoint every 3 (under build/, git-ignored)
TRAIN_ARCH = "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CKPT_EVERY = 8, 2048, 6, 3
TRAIN_CKPT_DIR = REPO / "build" / "chip_smoke_train_ckpt"
# One step on the kernel path against the same step on the plain chunked
# path, same weights and batch, bf16: the two scans' y differ only by bf16
# rounding flips (relative RMS ~1e-4 per layer, SSD_Y_REL_RMS_TOL), which
# 48 layers carry into the loss (a mean over 16,384 tokens) and into the
# gradient's global norm: ~1e-4 and ~1e-3 relative at most.
STEP_LOSS_TOL_REL = 1e-4
STEP_GNORM_TOL_REL = 1e-3
# flash check at the prefill's shapes: (name, T = S, window)
FLASH_CASES = (("global", PROMPT_LEN, None), ("local", PROMPT_LEN, 1024),
               ("ragged", 2000, None))

# The flash kernel against its plain version, both rounded to bf16. Its f32
# result differs from the plain one only by sum order and by P being
# multiplied as a bf16 high part plus a bf16 remainder, so the bf16 outputs
# differ only where a rounding boundary falls between them. Bound on
# ||kernel - plain|| / ||plain||: rounding P to one bf16 (~2e-3), an
# accumulator in bf16 (~4e-3) or a dropped window mask (~0.2) all exceed it
# (tests/test_torch_flash.py emulates each). Elementwise, two correct
# results may differ by one bf16 ulp of the largest output.
FLASH_REL_RMS_TOL = 5e-4
# Logits of two bf16 computations of the same tokens, relative to the
# largest |logit|: cached decode against the full forward (GEMMs of one row
# against 2079 rows) and flash against naive prefill attention round at
# different places, ~2^-9 relative each, over 96 sub-layers. A cache slot,
# position or mask that is wrong moves logits by O(max |logit|), as the
# off-by-one control shows.
LOGIT_TOL_REL = 5e-2
# The SSD kernel against its plain version (ssd_chunked) on the same bf16
# inputs. Both accumulate in f32 and differ by sum order, by the kernel's
# own cumsum and exp, and by its tensor-core operands: M, the decay-weighted
# x and the state h go in as a bf16 high part plus remainder (~16 bits). y
# (rounded to bf16 by both) differs only where a rounding boundary falls
# between them, h (f32) by little more than f32 rounding. Bounds on
# ||kernel - plain|| / ||plain||: a state that is not carried across
# chunks, an exclusive cumsum, a missing dt_j weight, a bf16 accumulator,
# or one bf16 rounding of M or of the state update's operand each break
# one of them (tests/test_torch_ssd.py emulates each).
SSD_Y_REL_RMS_TOL = 1e-3
SSD_H_REL_RMS_TOL = 1e-4


def ptxas_usage(log: str, name: str) -> dict:
    """Registers, spills and static shared memory that ``nvcc -Xptxas -v``
    reported for each kernel whose mangled name contains ``name``."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if name in m.group(1) else None
            if entry:
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[entry]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


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


# The planner kernels against their plain versions: r within f32 rounding
# (1e-6 relative); E within f64 summation order, judged against each row's
# total (1e-9); sweep picks the same slot for every cell, agrees on which
# cells are feasible, and costs and emissions agree within f64 summation
# order (1e-9 relative). An inclusive prefix, a carry dropped between runs
# or segments, r summed in f32, ties going to the later slot or a live hop
# skipped each break one of them (tests/test_torch_fused.py emulates each).
RATE_R_TOL_REL, RATE_E_TOL_OF_ROW = 1e-6, 1e-9
SWEEP_TOL_REL = 1e-9
# Names by which ptxas reports the two planner kernels.
PLANNER_KERNELS = {"rate_prefix": "rate_prefix_kernel",
                   "sweep": "sweep_kernel"}


def rate_prefix_errors(r_k, e_k, r_p, e_p) -> dict:
    """rate_prefix's (r, E) against its plain version's."""
    row_tot = (e_p[..., -1] + r_p[..., -1].double())[..., None]
    return {"r_max_rel_err": float(((r_k - r_p).abs() / r_p.abs()).max()),
            "e_max_rel_err_of_row_total":
                float(((e_k - e_p).abs() / row_tot).max()),
            "max_abs_err": max(float((r_k - r_p).abs().max()),
                               float((e_k - e_p).abs().max()))}


def rate_prefix_ok(err: dict) -> bool:
    return (err["r_max_rel_err"] <= RATE_R_TOL_REL
            and err["e_max_rel_err_of_row_total"] <= RATE_E_TOL_OF_ROW)


def sweep_errors(b_k, b_p) -> dict:
    """sweep's (cost, emis, slot) rows against its plain version's."""
    fin = torch.isfinite(b_p[:, :2])
    diff = (b_k[:, :2] - b_p[:, :2])[fin].abs()
    return {"slot_mismatches": int((b_k[:, 2] != b_p[:, 2]).sum()),
            "feasible_agree": bool(torch.equal(fin,
                                               torch.isfinite(b_k[:, :2]))),
            "max_rel_err": float((diff / b_p[:, :2][fin].abs()).max())
            if diff.numel() else 0.0,
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0}


def sweep_ok(err: dict) -> bool:
    return (err["feasible_agree"] and err["slot_mismatches"] == 0
            and err["max_rel_err"] <= SWEEP_TOL_REL)


def window_chunks(planner, job, grid_cuda, gt) -> dict:
    """The first and the last chunk of window 0, built by the main path's
    own table builders: ``{name: (kernel inputs, live cells)}``."""
    jobs = [job(i) for i in range(WINDOW)]
    cells, sla_rows, _ = planner._batch_cells(jobs, DT_S, STRIDE)
    chunks = list(gt._iter_chunks(cells, STRIDE, grid_cuda._MAX_ELEMS_PALLAS))
    out = {}
    for name, chunk in (("first", chunks[0]), ("last", chunks[-1])):
        t = gt._chunk_tables(planner.field, [cells[j] for j in chunk],
                             dt_s=DT_S, slot_stride=STRIDE,
                             cell_bucket=gt._B_CELLS)
        x = grid_cuda.fused_inputs(
            gt.tables_to_device(t, planner.device),
            grid_cuda.sla_table(t, np.asarray(sla_rows)[chunk]),
            grid_cuda.scale_table(t, SLOT_S, None))
        out[name] = (x, len(chunk))
        emit({"check_chunk": {"chunk": name, "of": len(chunks),
                              "cells": len(chunk), "pairs": t.n_pairs,
                              "cells_padded": x.sla.shape[0],
                              "rows": list(x.zn.shape[:2]), "t_pad": x.t_pad,
                              "slots": x.scl.shape[1]}})
    return out


def planner_ptxas(log: str) -> dict:
    """Registers, spills and static shared memory ptxas gave each planner
    kernel, from the build's ``-Xptxas -v`` log."""
    return {name: next(iter(ptxas_usage(log, kernel).values()), {})
            for name, kernel in PLANNER_KERNELS.items()}


def planner_resources(grid_cuda, x, log: str) -> dict:
    """``planner_ptxas``, and the dynamic shared memory each planner kernel
    launches with on these inputs."""
    lib = grid_cuda._library()
    _, h, w = x.zn.shape
    out = planner_ptxas(log)
    out["rate_prefix"]["smem_bytes"] = \
        lib.planner_rate_prefix_smem_bytes(h, w, DT_S)
    out["sweep"]["smem_bytes"] = lib.planner_sweep_smem_bytes(h)
    return out


def check_chunk(grid_cuda, x, n_cells: int) -> dict:
    """Both kernels against their plain versions on one chunk, timed, with
    their bounds: ``{"rate_prefix": {...}, "sweep": {...}}``."""

    def rate(fn):
        return lambda: fn(x.pp, x.zn, x.hn, x.rel0, x.tc, dt_s=DT_S,
                          t_pad=x.t_pad)

    r_k, e_k = rate(grid_cuda.rate_prefix)()
    r_p, e_p = rate(grid_cuda.rate_prefix_plain)()
    torch.cuda.synchronize()
    rp_err = rate_prefix_errors(r_k, e_k, r_p, e_p)
    if not rate_prefix_ok(rp_err):
        raise RuntimeError(f"rate_prefix disagrees with its plain version: "
                           f"{rp_err}")

    def sw(fn):
        return lambda: fn(e_k, r_k, x.scl, x.pidx, x.wd, x.sla,
                          stride=STRIDE, dt_s=DT_S, slot_s=SLOT_S)

    b_k = sw(grid_cuda.sweep)()
    b_p = sw(grid_cuda.sweep_plain)()
    torch.cuda.synchronize()
    sw_err = sweep_errors(b_k, b_p)
    if not sweep_ok(sw_err):
        raise RuntimeError(f"sweep disagrees with its plain version: "
                           f"{sw_err}")
    rp_bound, rp_by = rate_prefix_bound_ms(x)
    sw_bound, sw_by = sweep_bound_ms(x, n_cells)
    out = {
        "rate_prefix": {**rp_err, "max_rel_err": max(
            rp_err["r_max_rel_err"], rp_err["e_max_rel_err_of_row_total"]),
            "ms": median_ms(rate(grid_cuda.rate_prefix)),
            "plain_ms": median_ms(rate(grid_cuda.rate_prefix_plain)),
            "bound_ms": rp_bound, "bound_by": rp_by},
        "sweep": {**sw_err,
                  "feasible_cells": int(torch.isfinite(b_p[:n_cells, 0])
                                        .sum()),
                  "ms": median_ms(sw(grid_cuda.sweep)),
                  "plain_ms": median_ms(sw(grid_cuda.sweep_plain)),
                  "bound_ms": sw_bound, "bound_by": sw_by}}
    for row in out.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
    return out


def check_kernels(planner, job, grid_cuda, gt, log: str) -> list:
    """Phase 3: both kernels against their plain versions on the first
    and the last chunk of a real window, with the main path's own table
    builders; the first chunk's times go into the kernels line, with the
    registers and shared memory read from the build ``log``."""
    chunks = window_chunks(planner, job, grid_cuda, gt)
    cases = {}
    for name, (x, n_cells) in chunks.items():
        cases[name] = check_chunk(grid_cuda, x, n_cells)
        for k, res in planner_resources(grid_cuda, x, log).items():
            cases[name][k].update(res)
        emit({"planner_check": {"chunk": name, **cases[name]}})
    # the kernels line takes only what this run measured, and the bound;
    # launch geometry and ptxas figures stay in the planner_check lines
    measured = {"rate_prefix": ("max_rel_err", "r_max_rel_err",
                                "e_max_rel_err_of_row_total"),
                "sweep": ("max_rel_err", "slot_mismatches",
                          "feasible_cells")}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by")
    source = {"rate_prefix": "src/repro/core/scheduler/grid_pallas.py:77",
              "sweep": "src/repro/core/scheduler/grid_pallas.py:125"}
    rows = []
    for name, replaces in source.items():
        first, last = cases["first"][name], cases["last"][name]
        rows.append({"name": name, "route": "cuda", "source": KERNEL_SRC,
                     "replaces": replaces,
                     "max_abs_err": max(first["max_abs_err"],
                                        last["max_abs_err"]),
                     **{k: first[k] for k in measured[name] + timed},
                     "library_ms": None,
                     "last_chunk": {k: last[k] for k in (
                         "max_abs_err",) + measured[name] + timed}})
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


# --- the fleet day: the control plane's closed loop --------------------------

# examples/fleet_day.py's first act, copied (that file imports the reference):
# 4000 jobs over 24 simulated hours through a 4-shard ShardedFleet, and at
# 11:00 a 6x forecast shock on the Quebec and New York grids for six hours.
FLEET_N_JOBS, FLEET_N_SHARDS = 4000, 4
FLEET_SHOCK_ZONES = ("CA-QC", "US-NY-NYIS")
# the ROADMAP's contract for plans: the same cells, emissions within 1e-4
FLEET_EMIS_TOL_REL = 1e-4
# fleet_day's own acceptance (examples/fleet_day.py:128-133)
FLEET_AUDIT_TOL_REL = 1e-9


def fleet_day_ftns(ov) -> list:
    return [ov.FTN("uc", "skylake", 10.0), ov.FTN("m1", "apple_m1", 1.2),
            ov.FTN("site_qc", "cascade_lake", 40.0),
            ov.FTN("tacc", "cascade_lake", 10.0)]


def _fleet_u(i: int, tag: str) -> float:
    """Deterministic pseudo-random in [0, 1) (fleet_day's ``_u``)."""
    d = hashlib.blake2b(f"fleet_day:{tag}:{i}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(d, "big") / 2**64


def fleet_day_jobs(tp, t0: float) -> list:
    """fleet_day's ``make_jobs``: every fifth job a 1-3 TB archival copy
    from ``uc`` (deadline 8-24 h), the rest 50-500 GB over three site
    replicas (3-12 h); w_perf 0.2 on odd jobs."""
    jobs = []
    for i in range(FLEET_N_JOBS):
        arrival = t0 + 24 * 3600.0 * _fleet_u(i, "arrival")
        if i % 5 == 0:
            size = (1000 + 2000 * _fleet_u(i, "size")) * 1e9
            replicas, deadline_h = ("uc",), 8 + 16 * _fleet_u(i, "dl")
        else:
            size = (50 + 450 * _fleet_u(i, "size")) * 1e9
            replicas = ("site_ne", "site_or", "site_qc")
            deadline_h = 3 + 9 * _fleet_u(i, "dl")
        jobs.append(tp.TransferJob(
            f"day{i:04d}", size, replicas, "tacc",
            tp.SLA(deadline_s=deadline_h * 3600.0,
                   w_carbon=1.0, w_perf=0.2 if i % 2 else 0.0),
            arrival))
    return jobs


def _sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


class CallTimer:
    """Wraps one bound method of an object: counts its calls, their
    synchronized wall seconds and the kernel launches made inside them."""

    def __init__(self, obj, attr: str, kernel_fns: dict):
        self.fn, self.kernel_fns = getattr(obj, attr), kernel_fns
        self.calls, self.wall_s = 0, 0.0
        self.calls_launching = 0
        self.launches = {n: 0 for n in kernel_fns}
        setattr(obj, attr, self)

    def __call__(self, *a, **k):
        before = {n: fn.launches for n, fn in self.kernel_fns.items()}
        _sync()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        _sync()
        self.wall_s += time.perf_counter() - t0
        self.calls += 1
        made = {n: fn.launches - before[n]
                for n, fn in self.kernel_fns.items()}
        self.calls_launching += any(made.values())
        for n, c in made.items():
            self.launches[n] += c
        return out


def run_fleet_day(sharded, ov, tp, t0: float, kernel_fns: dict,
                  **backends) -> tuple:
    """One fleet day through the port's entry points, as fleet_day runs
    it: ``submit_many`` (one fleet-level ``plan_batch``), the shock, then
    ``run()``. Returns (fleet, report, stats): admission, re-plan sweeps
    (and the re-scores inside them) and drain timed apart, each with the
    kernel launches made inside."""
    fleet = sharded.ShardedFleet(
        fleet_day_ftns(ov), n_shards=FLEET_N_SHARDS,
        migration_threshold=250.0, replan_every_s=3600.0,
        migrate_check_every_s=900.0, obs=True, device=DEVICE, **backends)
    jobs = fleet_day_jobs(tp, t0)
    admit = CallTimer(fleet.planner, "plan_batch", kernel_fns)
    sweeps = [CallTimer(ctl.queue, "replan_pending", kernel_fns)
              for ctl in fleet.controllers]
    # inside the sweeps: re-scoring each queued job's old cell
    rescores = [CallTimer(ctl.planner, "rescore_batch", kernel_fns)
                for ctl in fleet.controllers]
    _sync()
    w0 = time.perf_counter()
    fleet.submit_many(jobs)
    _sync()
    submit_s = time.perf_counter() - w0
    fleet.inject_shock(t0 + 11 * 3600.0, 6.0, duration_s=6 * 3600.0,
                       zones=FLEET_SHOCK_ZONES)
    before = {n: fn.launches for n, fn in kernel_fns.items()}
    w0 = time.perf_counter()
    report = fleet.run()
    _sync()
    drain_s = time.perf_counter() - w0
    stats = {
        "submit_many_s": submit_s, "admission_plan_batch_s": admit.wall_s,
        "admission_cells": fleet.planner.last_batch_cells,
        "admission_launches": admit.launches, "drain_s": drain_s,
        "replan_sweeps": sum(t.calls for t in sweeps),
        "replan_sweeps_launching": sum(t.calls_launching for t in sweeps),
        "replan_sweeps_s": sum(t.wall_s for t in sweeps),
        "replan_rescore_s": sum(t.wall_s for t in rescores),
        "replan_launches": {n: sum(t.launches[n] for t in sweeps)
                            for n in kernel_fns},
        "drain_launches": {n: fn.launches - before[n]
                           for n, fn in kernel_fns.items()}}
    return fleet, report, stats


def fleet_summary(fleet, report, stats: dict) -> dict:
    """What the fleet_main_path line prints, and the day's own gates
    (fleet_day's acceptance): every job completed, every shard had one,
    at least one migration, re-plan and changed plan, and the merged
    ledger audit re-integrates the step accounting."""
    audit = abs(report.ledger_total_g - report.total_actual_g) \
        / max(report.total_actual_g, 1e-12)
    sizes = [r.n_jobs for r in fleet.shard_reports]
    out = {**stats, "jobs_per_s": report.jobs_per_s,
           "n_completed": report.n_completed, "shard_jobs": sizes,
           "migrations": report.migrations,
           "replan_events": report.replan_events,
           "plans_changed": report.plans_changed,
           "sla_misses": report.sla_misses, "n_events": report.n_events,
           "n_steps": report.n_steps, "trace_spans": len(report.trace),
           "total_planned_g": report.total_planned_g,
           "total_actual_g": report.total_actual_g,
           "ledger_audit_rel_err": audit}
    if report.n_completed != FLEET_N_JOBS or len(report.outcomes) \
            != FLEET_N_JOBS:
        raise RuntimeError(f"fleet day completed {report.n_completed} of "
                           f"{FLEET_N_JOBS} jobs")
    if sum(sizes) != FLEET_N_JOBS or min(sizes) < 1:
        raise RuntimeError(f"fleet day: jobs per shard {sizes}")
    if not (report.migrations >= 1 and report.replan_events >= 1
            and report.plans_changed >= 1):
        raise RuntimeError(
            f"fleet day did not adapt: {report.migrations} migrations, "
            f"{report.replan_events} re-plans, {report.plans_changed} "
            f"plans changed")
    if not audit < FLEET_AUDIT_TOL_REL:
        raise RuntimeError(f"fleet day: merged ledger audit off by "
                           f"{audit:.3e}")
    return out


def fleet_cells(fleet) -> dict:
    """Each job's admission cell, from its shard's record."""
    return {u: (r.admitted_plan.source, r.admitted_plan.ftn,
                r.admitted_plan.start_t, r.admitted_plan.predicted_emissions_g)
            for ctl in fleet.controllers for u, r in ctl._records.items()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def compare_fleet_days(fleet, report, oracle_fleet, oracle) -> dict:
    """The kernel day against the numpy day: every job the same admission
    cell and the same outcome row; totals and each job's planned
    emissions within FLEET_EMIS_TOL_REL. A job that differs is printed
    with both days' cells, rows and planned emissions (a re-plan that
    flipped at the drift_tol edge shows as ``replanned`` differing)."""
    cells, want_cells = fleet_cells(fleet), fleet_cells(oracle_fleet)
    row = lambda o: (o.source, o.ftn_sequence, o.migrations, o.replanned,
                     o.sla_miss)
    want = {o.job_uuid: o for o in oracle.outcomes}
    bad, emis_rel = [], 0.0
    for o in report.outcomes:
        w = want.get(o.job_uuid)
        c, wc = cells.get(o.job_uuid), want_cells.get(o.job_uuid)
        if w is None or c is None or wc is None or c[:3] != wc[:3] \
                or row(o) != row(w):
            bad.append({"job": o.job_uuid, "cell": c, "oracle_cell": wc,
                        "row": row(o), "oracle_row": w and row(w),
                        "planned_g": o.planned_emissions_g,
                        "oracle_planned_g": w and w.planned_emissions_g})
            continue
        emis_rel = max(emis_rel, _rel(o.planned_emissions_g,
                                      w.planned_emissions_g),
                       _rel(c[3], wc[3]))
    out = {"jobs": len(report.outcomes), "mismatches": len(bad),
           "max_planned_rel_err": emis_rel,
           "total_planned_rel_err": _rel(report.total_planned_g,
                                         oracle.total_planned_g),
           "total_actual_rel_err": _rel(report.total_actual_g,
                                        oracle.total_actual_g)}
    if bad:
        for b in bad[:20]:
            emit({"fleet_mismatch": b})
        raise RuntimeError(f"fleet day: {len(bad)} jobs differ from the "
                           f"numpy day")
    if not max(emis_rel, out["total_planned_rel_err"],
               out["total_actual_rel_err"]) <= FLEET_EMIS_TOL_REL:
        raise RuntimeError(f"fleet day: emissions off the numpy day: {out}")
    return out


def fleet_day(kernel_fns: dict, split=None) -> dict:
    """The fleet day on the default fused backend with the planner
    kernels' launch counts reset just before it, then the same day on the
    numpy oracle; every gate raises. Returns the fleet_main_path line.
    With ``split`` (a live :class:`SplitTimer`) the line also carries the
    fused day's kernel ms by CUDA events around each launch, its host
    table builds, and the device's busy share of the day's wall time."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    from repro_torch.core.controlplane import sharded
    from repro_torch.core.scheduler import overlay as ov
    from repro_torch.core.scheduler import planner as tp

    if split is not None:
        split.reset()
    for fn in kernel_fns.values():
        fn.launches = 0
    fleet, report, stats = run_fleet_day(sharded, ov, tp, t0, kernel_fns)
    day_launches = {n: fn.launches for n, fn in kernel_fns.items()}
    line = fleet_summary(fleet, report, stats)
    line["launches"] = day_launches
    if split is not None:
        kms = split.kernel_ms()
        line.update(kernel_ms=kms, chunks=split.chunks,
                    host_table_build_s=split.table_s,
                    device_busy_share=sum(kms.values()) / 1e3
                    / (stats["submit_many_s"] + stats["drain_s"]))
    if not all(day_launches[n] > 0 for n in kernel_fns):
        raise RuntimeError(f"fleet day launched the planner kernels "
                           f"{day_launches} times")
    ofleet, oreport, ostats = run_fleet_day(
        sharded, ov, tp, t0, kernel_fns, batch_backend="numpy",
        shard_backend="numpy")
    oracle = fleet_summary(ofleet, oreport, ostats)
    line["numpy_day"] = {k: oracle[k] for k in (
        "drain_s", "submit_many_s", "admission_plan_batch_s",
        "replan_sweeps", "replan_sweeps_s", "replan_rescore_s",
        "jobs_per_s", "migrations",
        "replan_events", "plans_changed", "sla_misses", "total_planned_g",
        "total_actual_g")}
    line["vs_numpy_day"] = compare_fleet_days(fleet, report, ofleet, oreport)
    return line


# --- serving gemma3-12b through the flash kernel ----------------------------

def power_limit_w(line: str) -> float:
    """The power limit of an nvidia-smi ``name, 700.00 W`` line."""
    return float(line.rsplit(",", 1)[1].split()[0])


def flash_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's output against its plain version's: the largest
    absolute error and its bound (one bf16 ulp of the largest plain
    output), and the relative RMS error (see FLASH_REL_RMS_TOL)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    return {"max_abs_err": float((g - w).abs().max()),
            "max_abs_tol": 2.0 ** (math.floor(math.log2(top)) - 7)
            if top > 0 else 0.0,
            "rel_rms_err": float((g - w).norm() / w.norm())}


def ssd_errors(y: torch.Tensor, h: torch.Tensor, y_plain: torch.Tensor,
               h_plain: torch.Tensor) -> dict:
    """The SSD kernel's (y, h) against its plain version's: relative RMS
    errors (see SSD_Y_REL_RMS_TOL, SSD_H_REL_RMS_TOL), the largest absolute
    error of y and its bound (one bf16 ulp of the largest plain output)."""
    g, w = y.float(), y_plain.float()
    top = float(w.abs().max())
    return {"y_rel_rms_err": float((g - w).norm() / w.norm()),
            "h_rel_rms_err": float((h.float() - h_plain.float()).norm()
                                   / h_plain.float().norm()),
            "max_abs_err": float((g - w).abs().max()),
            "max_abs_tol": 2.0 ** (math.floor(math.log2(top)) - 7)
            if top > 0 else 0.0}


def ssd_ok(err: dict) -> bool:
    return (err["y_rel_rms_err"] <= SSD_Y_REL_RMS_TOL
            and err["h_rel_rms_err"] <= SSD_H_REL_RMS_TOL
            and err["max_abs_err"] <= err["max_abs_tol"])


def flash_bound_ms(b: int, t: int, hq: int, hkv: int, d: int,
                   window) -> tuple:
    """Least time for one flash call on these inputs: 4*d tensor-core FLOP
    (QK^T and PV) per unmasked (q, k) pair at the bf16 dense peak, against
    q, k and v read once and o written once."""
    keys = torch.arange(1, t + 1, dtype=torch.float64)
    if window is not None:
        keys = keys.clamp(max=window)
    ops_s = 4 * d * float(keys.sum()) * b * hq / BF16_TC_FLOPS
    bytes_s = 2 * (2 * b * t * hq * d + 2 * b * t * hkv * d) / HBM_BPS
    return 1e3 * max(ops_s, bytes_s), (
        "operations" if ops_s >= bytes_s else "bytes")


def check_flash(fa, cfg, usage=None) -> list:
    """The flash kernel against its plain version at gemma3-12b's prefill
    shapes (4 sequences, 16 query heads over 8 kv heads, head_dim 240,
    bf16); ``scaled_dot_product_attention`` on the same inputs and mask is
    timed as the library yardstick only. ``usage`` (from
    :func:`ptxas_usage`) adds the kernel's registers and shared memory."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cases = []
    for name, t, window in FLASH_CASES:
        q, k, v = (torch.randn((SERVE_BATCH, t, h, d), generator=gen,
                               device=DEVICE).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))

        def kernel():
            return fa.flash_attention(q, k, v, causal=True, window=window)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = flash_errors(got, want)
        del got, want
        if not (err["rel_rms_err"] <= FLASH_REL_RMS_TOL
                and err["max_abs_err"] <= err["max_abs_tol"]):
            raise RuntimeError(f"flash kernel disagrees with its plain "
                               f"version ({name}): {err}")
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
                  .contiguous() for x in (k, v))
        pos = torch.arange(t, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[:, None] - pos[None, :] < (window or t + 1))

        def library():
            if window is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)

        bound, by = flash_bound_ms(SERVE_BATCH, t, hq, hkv, d, window)
        case = {"case": name, "q": list(q.shape), "kv": list(k.shape),
                "window": window, **err, "tol_rel_rms": FLASH_REL_RMS_TOL,
                **flash_resources(fa, d, usage),
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "library_ms": median_ms(library), "bound_ms": bound,
                "bound_by": by}
        case["bound_share"] = bound / case["ms"]
        emit({"flash_check": case})
        cases.append(case)
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return cases


class ServeProbe:
    """Instruments the serve loop without changing it: a host clock around
    each synchronized prefill, the logits of every prefill and decode step
    kept, and CUDA events around every flash kernel launch in the bound
    library, so the wrappers and their launch counts run as they are."""

    def __init__(self, serve_loop, fa):
        self.sl, self.lib = serve_loop, fa._library()
        self.orig = (serve_loop.prefill, serve_loop.decode_step,
                     self.lib.flash_attention_fwd)
        self.epochs: list = []
        self._events: list = []

    def __enter__(self):
        prefill, decode, launch = self.orig

        def timed_prefill(model, run, tokens, s_max):
            self._events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(model, run, tokens, s_max)
            torch.cuda.synchronize()
            self.epochs.append({"prefill_s": time.perf_counter() - t0,
                                "tokens": tokens, "logits": [logits],
                                "flash": self._events})
            return logits, cache

        def kept_decode(model, run, token, cache, cur):
            logits, cache = decode(model, run, token, cache, cur)
            self.epochs[-1]["logits"].append(logits)
            return logits, cache

        def timed_launch(*a):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(*a)
            stop.record()
            self._events.append((start, stop))
            return err

        self.sl.prefill, self.sl.decode_step = timed_prefill, kept_decode
        self.lib.flash_attention_fwd = timed_launch
        return self

    def __exit__(self, *exc):
        self.sl.prefill, self.sl.decode_step, \
            self.lib.flash_attention_fwd = self.orig

    @staticmethod
    def flash_ms(epoch) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in epoch["flash"])


def serve(fa, sl, cfg, run, power_w: float):
    """The serving main path: ``Server`` answers N_REQUESTS requests in
    static batches on the card; returns the server, the probe and the
    flash launches counted over the path."""
    t0 = time.perf_counter()
    srv = sl.Server(cfg, run, batch=SERVE_BATCH, s_max=S_MAX, chip_count=1,
                    chip_power_w=power_w, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.model.parameters())
    emit({"serve_setup": {
        "arch": cfg.name, "layers": len(srv.model.decoder.layers),
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "window": cfg.sliding_window,
        "params": n_params, "param_counts": cfg.param_counts()["total"],
        "weights_gb": sum(p.numel() * p.element_size()
                          for p in srv.model.parameters()) / 1e9,
        "init_s": time.perf_counter() - t0, "site": srv.site,
        "chip_power_w": power_w}})
    if n_params != cfg.param_counts()["total"] \
            or len(srv.model.decoder.layers) != cfg.n_layers:
        raise RuntimeError("the served model is not gemma3-12b at full "
                           "size")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN))
    for i in range(N_REQUESTS):
        srv.submit(sl.Request(rid=i, prompt=torch.as_tensor(prompts[i]),
                              max_new_tokens=MAX_NEW))
    sites = set(srv.cluster.sites)
    fa.flash_attention.launches = 0
    with ServeProbe(sl, fa) as probe:
        while srv.queue:
            before = fa.flash_attention.launches
            done = srv.step_epoch()
            ep = probe.epochs[-1]
            if len(done) != SERVE_BATCH or any(
                    len(c.tokens) != MAX_NEW or c.emissions_mg <= 0
                    or c.site not in sites
                    or not all(0 <= t < cfg.vocab_size for t in c.tokens)
                    for c in done):
                raise RuntimeError(f"epoch {len(probe.epochs) - 1}: "
                                   f"malformed completions")
            want = torch.stack([lg.argmax(-1) for lg in ep["logits"]],
                               dim=1).cpu()
            if any(c.tokens != want[j].tolist()
                   for j, c in enumerate(done)):
                raise RuntimeError("completions are not the argmax of the "
                                   "logits the loop computed")
            lat, pre = done[0].latency_s, ep["prefill_s"]
            flash_ms = probe.flash_ms(ep)
            emit({"epoch": len(probe.epochs) - 1, "site": done[0].site,
                  "rids": [c.rid for c in done], "latency_s": lat,
                  "prefill_s": pre,
                  "decode_ms_per_step": (lat - pre) / (MAX_NEW - 1) * 1e3,
                  "gen_tokens_per_s": SERVE_BATCH * MAX_NEW / lat,
                  "prompt_tokens_per_s": SERVE_BATCH * PROMPT_LEN / pre,
                  "mg_co2_per_request": done[0].emissions_mg,
                  "flash_launches": fa.flash_attention.launches - before,
                  "flash_ms_in_prefill": flash_ms,
                  "flash_share_of_prefill": flash_ms / 1e3 / pre})
    launches = fa.flash_attention.launches
    n_prefill = len(probe.epochs)
    lat = sum(c.latency_s for c in srv.completions) / SERVE_BATCH
    emit({"serve_main_path": {
        "requests": len(srv.completions), "prefills": n_prefill,
        "flash_launches": launches,
        "gen_tokens_per_s": len(srv.completions) * MAX_NEW / lat,
        "wall_s": lat}})
    if launches != cfg.n_layers * n_prefill:
        raise RuntimeError(f"flash launches {launches} != {cfg.n_layers} "
                           f"layers x {n_prefill} prefills")
    return srv, probe, launches


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def check_logits(M, srv, probe) -> dict:
    """First epoch: the cached path's logits (prefill's last position and
    every decode step) against a plain full forward over prompt and
    generated tokens (naive attention, no cache), and the flash prefill
    against the naive one. A control compares each cached step with the
    full forward's next position: a cache off by one slot would look like
    it."""
    ep = probe.epochs[0]
    model = srv.model
    naive = dataclasses.replace(srv.run, attn_impl="naive")
    cached = torch.stack(ep["logits"], dim=1)                  # [B, 32, V]
    fed = torch.stack([lg.argmax(-1) for lg in ep["logits"][:-1]], dim=1)
    seq = torch.cat([ep["tokens"], fed], dim=1)                # [B, 2079]
    h = M.forward_hidden(model, naive, seq)
    full = M.unembed(model, h[:, PROMPT_LEN - 1:]).float()     # [B, 32, V]
    del h
    naive_prefill, cache = M.prefill(model, naive, ep["tokens"], S_MAX)
    del cache
    res = {"positions": int(full.shape[1]),
           "finite": bool(torch.isfinite(cached).all()
                          and torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()),
           "cached_vs_full_rel": rel_err(cached, full),
           "cached_vs_full_prefill_pos_rel": rel_err(cached[:, 0],
                                                     full[:, 0]),
           "control_off_by_one_rel": rel_err(cached[:, 1:], full[:, :-1]),
           "flash_vs_naive_prefill_rel": rel_err(ep["logits"][0],
                                                 naive_prefill),
           "argmax_agree_cached_full": float(
               (cached.argmax(-1) == full.argmax(-1)).float().mean()),
           "tol_rel": LOGIT_TOL_REL}
    emit({"logit_check": res})
    if not (res["finite"]
            and res["cached_vs_full_rel"] <= LOGIT_TOL_REL
            and res["flash_vs_naive_prefill_rel"] <= LOGIT_TOL_REL
            and res["control_off_by_one_rel"] > LOGIT_TOL_REL):
        raise RuntimeError(f"logit check failed: {res}")
    return res


def profile_serving(M, srv, tokens) -> dict:
    """Device time by kernel over one prefill and three decode steps
    (``torch.profiler``), and the device's busy share of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof) -> dict:
        out = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
        return out

    def split(ks: dict, wall_s: float) -> dict:
        flash = sum(v for k, v in ks.items() if FLASH_KERNEL in k)
        gemm = sum(v for k, v in ks.items()
                   if any(w in k.lower() for w in
                          ("gemm", "nvjet", "xmma", "cutlass", "cublas")))
        total = sum(ks.values())
        top = sorted(ks.items(), key=lambda kv: -kv[1])[:8]
        return {"wall_ms": wall_s * 1e3, "device_ms": total,
                "busy_share": total / (wall_s * 1e3),
                "flash_ms": flash, "gemm_ms": gemm,
                "other_ms": total - flash - gemm,
                "top": [[k[:90], v] for k, v in top]}

    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        logits, cache = M.prefill(srv.model, srv.run, tokens, S_MAX)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
    tok = logits.argmax(-1)[:, None]
    with profile(activities=act) as prof_d:
        t0 = time.perf_counter()
        for i in range(3):
            logits, cache = M.decode_step(srv.model, srv.run, tok, cache,
                                          PROMPT_LEN + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    return {"prefill": split(kernels(prof), pre_s),
            "decode_3_steps": split(kernels(prof_d), dec_s)}


# --- training mamba2-370m through the SSD kernel ----------------------------

def ssd_bound_ms(b: int, s: int, nh: int, hd: int, n: int,
                 chunk: int) -> tuple:
    """Least time for one SSD scan on these inputs: per (batch, head,
    chunk) C B^T and M X over the Q(Q+1)/2 pairs at or below the diagonal,
    C h^T and the state update, at the bf16 dense tensor-core peak (x, B
    and C are bf16), against x, B, C, dt and A read once and y and the
    final h written once."""
    pairs = chunk * (chunk + 1) // 2
    per = pairs * 2 * n + pairs * 2 * hd + chunk * hd * 2 * n \
        + hd * n * 2 * chunk
    ops = per * b * nh * (s // chunk)
    nbytes = (2 * 2 * b * s * nh * hd + 2 * 2 * b * s * n + 4 * b * s * nh
              + 4 * nh + 4 * b * nh * hd * n)
    ops_s, bytes_s = ops / BF16_TC_FLOPS, nbytes / HBM_BPS
    return 1e3 * max(ops_s, bytes_s), (
        "operations" if ops_s >= bytes_s else "bytes"), ops


def ssd_training_inputs(cfg, gen):
    """Inputs at the training shapes with the model's ranges: x, B, C unit
    normals in bf16; dt = softplus(normal / 2 + dt_bias), dt_bias drawn as
    the init draws it; A = -Uniform[1, 16], as exp(A_log) at init."""
    s = cfg.ssm
    nh, hd, n = s.n_heads(cfg.d_model), s.headdim, s.d_state
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    x = torch.randn(shape + (nh, hd), generator=gen, device=DEVICE)
    bias = torch.log(torch.expm1(torch.empty(nh, device=DEVICE).uniform_(
        1e-3, 1e-1, generator=gen)))
    dt = torch.nn.functional.softplus(
        torch.randn(shape + (nh,), generator=gen, device=DEVICE) * 0.5 + bias)
    A = -torch.empty(nh, device=DEVICE).uniform_(1.0, 16.0, generator=gen)
    bm, cm = (torch.randn(shape + (1, n), generator=gen, device=DEVICE)
              for _ in range(2))
    return (x.to(torch.bfloat16), dt, A, bm.to(torch.bfloat16),
            cm.to(torch.bfloat16))


def flash_resources(fa, d: int, usage) -> dict:
    """The registers and spills ptxas gave the flash kernel instance for
    head_dim d, and the dynamic shared memory it launches with."""
    if usage is None:
        return {}
    chunks = -(-d // 64)
    inst = [u for e, u in usage.items() if f"ILi{chunks}E" in e]
    return {"registers": inst[0].get("registers") if inst else None,
            "spill_bytes": inst[0].get("spill_bytes") if inst else None,
            "smem_bytes": fa._library().flash_attention_smem_bytes(d)}


def check_ssd(ssd, cfg, usage=None) -> dict:
    """The SSD kernel against its plain version (``ssd_chunked``) at the
    training shapes; no single PyTorch call computes the scan, so there is
    no library yardstick. ``usage`` (from :func:`ptxas_usage`) adds each
    pass's registers and shared memory."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    ins = ssd_training_inputs(cfg, gen)
    chunk = cfg.ssm.chunk_size

    def kernel():
        return ssd.ssd_scan(*ins, chunk)

    def plain():
        return ssd.ssd_chunked(*ins, chunk)

    (y, h), (y_p, h_p) = kernel(), plain()
    torch.cuda.synchronize()
    err = ssd_errors(y, h, y_p, h_p)
    del y, h, y_p, h_p
    if not ssd_ok(err):
        raise RuntimeError(f"SSD kernel disagrees with its plain version: "
                           f"{err}")
    x = ins[0]
    bound, by, ops = ssd_bound_ms(*x.shape, cfg.ssm.d_state, chunk)
    case = {"x": list(x.shape), "B": list(ins[3].shape), "chunk": chunk,
            **err, "tol_y_rel_rms": SSD_Y_REL_RMS_TOL,
            "tol_h_rel_rms": SSD_H_REL_RMS_TOL,
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "flop": ops,
            "bound_ms_f32_cuda_cores": 1e3 * ops / F32_FLOPS}
    case["bound_share"] = bound / case["ms"]
    if usage is not None:
        s = cfg.ssm
        dyn = ssd._library().ssd_scan_smem_bytes(chunk, s.headdim,
                                                 s.d_state)
        case["passes"] = {
            next((p for p in SSD_PASSES if p in e), e): {
                **u, "dynamic_smem_bytes": dyn if "chunk_out" in e else 0}
            for e, u in usage.items()}
    emit({"ssd_check": case})
    del ins
    torch.cuda.empty_cache()
    return case


def loss_and_gnorm(M, adamw, model, run, batch) -> tuple:
    """The loss of one batch and the global norm of its gradient with
    respect to every parameter (no update)."""
    params = [p for _, p in model.named_parameters()]
    loss, _ = M.loss_fn(model, run, batch)
    grads = torch.autograd.grad(loss, params)
    gnorm = adamw.global_norm(grads)
    torch.cuda.synchronize()
    return float(loss.detach()), float(gnorm)


def check_train_step(M, adamw, ssd, cfg, run, batch) -> dict:
    """One train step's loss and gradient norm on the kernel path
    (``flash``) against the plain chunked path (``blockwise``, the
    reference's ``use_kernel=False``), same weights and batch."""
    model = M.build_model(cfg, seed=SEED, device=DEVICE).requires_grad_(True)
    before = ssd.ssd_scan.launches
    t0 = time.perf_counter()
    loss_k, gn_k = loss_and_gnorm(M, adamw, model, run, batch)
    kernel_s = time.perf_counter() - t0
    launches = ssd.ssd_scan.launches - before
    t0 = time.perf_counter()
    loss_p, gn_p = loss_and_gnorm(
        M, adamw, model, dataclasses.replace(run, attn_impl="blockwise"),
        batch)
    plain_s = time.perf_counter() - t0
    res = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "gnorm_kernel": gn_k, "gnorm_plain": gn_p,
           "gnorm_rel_diff": abs(gn_k - gn_p) / abs(gn_p),
           "tol_loss_rel": STEP_LOSS_TOL_REL,
           "tol_gnorm_rel": STEP_GNORM_TOL_REL,
           "kernel_path_s": kernel_s, "plain_path_s": plain_s,
           "ssd_launches_kernel_path": launches}
    emit({"train_step_check": res})
    del model
    torch.cuda.empty_cache()
    if not (math.isfinite(loss_k) and math.isfinite(gn_k)
            and res["loss_rel_diff"] <= STEP_LOSS_TOL_REL
            and res["gnorm_rel_diff"] <= STEP_GNORM_TOL_REL
            and launches == 2 * cfg.n_layers):
        raise RuntimeError(f"the kernel path's train step disagrees with "
                           f"the plain one: {res}")
    return res


class StepProbe:
    """Instruments ``Trainer.step_fn`` without changing it: a synchronized
    host clock, the SSD launches, the peak device memory and the site and
    simulated time of every step."""

    def __init__(self, tr, ssd):
        self.tr, self.ssd, self.orig = tr, ssd, tr.step_fn
        self.rows: list = []

    def __enter__(self):
        def timed(model, opt, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = self.ssd.ssd_scan.launches
            t0 = time.perf_counter()
            m = self.orig(model, opt, batch)
            torch.cuda.synchronize()
            self.rows.append({
                "wall_s": time.perf_counter() - t0,
                "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "ssd_launches": self.ssd.ssd_scan.launches - before,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "site": self.tr.site, "t": self.tr.t})
            return m
        self.tr.step_fn = timed
        return self

    def __exit__(self, *exc):
        self.tr.step_fn = self.orig


def train(tl, ssd, cfg, run, power_w: float) -> tuple:
    """The training main path (:func:`train_and_restore`) in a fresh
    checkpoint directory, which is deleted again afterwards."""
    import shutil
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    try:
        return train_and_restore(tl, ssd, cfg, run, power_w)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)


def train_and_restore(tl, ssd, cfg, run, power_w: float) -> tuple:
    """``Trainer`` runs TRAIN_STEPS steps with a checkpoint every
    CKPT_EVERY; a fresh ``Trainer`` on the same directory restores the last
    step bit for bit. Returns the trainer and the SSD launches counted over
    the path."""
    from repro_torch.core.carbon.intensity import calibrated_ci
    from repro_torch.models.params import count_params
    loop = tl.TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=CKPT_EVERY,
                              ckpt_dir=str(TRAIN_CKPT_DIR), log_every=1,
                              chip_power_w=power_w)
    t0 = time.perf_counter()
    tr = tl.Trainer(cfg, run, loop, batch_override=TRAIN_BATCH,
                    seq_override=TRAIN_SEQ, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.params.values())
    emit({"train_setup": {
        "arch": cfg.name, "layers": len(tr.model.decoder.layers),
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "ssd_heads": cfg.ssm.n_heads(cfg.d_model),
        "headdim": cfg.ssm.headdim, "d_state": cfg.ssm.d_state,
        "chunk": cfg.ssm.chunk_size, "params": n_params,
        "spec_params": count_params(cfg),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": run.remat,
        "init_s": time.perf_counter() - t0, "site": tr.site,
        "chip_power_w": power_w}})
    if n_params != count_params(cfg) \
            or len(tr.model.decoder.layers) != cfg.n_layers:
        raise RuntimeError("the trained model is not mamba2-370m at full "
                           "size")
    ssd.ssd_scan.launches = 0
    with StepProbe(tr, ssd) as probe:
        t0 = time.perf_counter()
        out = tr.run_steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ssd.ssd_scan.launches
    per_step = cfg.n_layers * (2 if run.remat != "none" else 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, r in enumerate(probe.rows):
        ci = calibrated_ci(tr.cluster.zone_of(r["site"]), r["t"])
        emit({"train_step": i + 1, "wall_s": r["wall_s"],
              "tokens_per_s": tokens / r["wall_s"], "loss": r["loss"],
              "grad_norm": r["grad_norm"], "ssd_launches": r["ssd_launches"],
              "ssd_launches_expected": per_step, "peak_gb": r["peak_gb"],
              "site": r["site"], "ci_g_per_kwh": ci,
              "g_co2": r["wall_s"] * power_w / 3.6e6 * ci})
    emit({"train_main_path": {
        "steps": len(probe.rows), "final_step": out["final_step"],
        "ssd_launches": launches, "wall_s": wall,
        "tokens_per_s": tokens * len(probe.rows) / wall,
        "events": out["events"], "final_loss": out["final_loss"]}})
    if len(probe.rows) != TRAIN_STEPS or out["final_step"] != TRAIN_STEPS:
        raise RuntimeError(f"trainer ran {len(probe.rows)} steps, not "
                           f"{TRAIN_STEPS}")
    if not all(math.isfinite(r["loss"]) for r in probe.rows):
        raise RuntimeError("a training loss is not finite")
    if any(r["ssd_launches"] != per_step for r in probe.rows) \
            or launches != per_step * TRAIN_STEPS:
        raise RuntimeError(f"SSD launches {launches} != {cfg.n_layers} "
                           f"layers x 2 (remat) x {TRAIN_STEPS} steps")
    t0 = time.perf_counter()
    back = tl.Trainer(cfg, run, loop, batch_override=TRAIN_BATCH,
                      seq_override=TRAIN_SEQ, device=DEVICE)
    same = all(torch.equal(back.params[k], v) for k, v in tr.params.items())
    emit({"train_restore": {"start_step": back.start_step,
                            "events": back.events, "params_bit_equal": same,
                            "opt_step": back.opt.step,
                            "restore_s": time.perf_counter() - t0}})
    if back.start_step != TRAIN_STEPS or not same \
            or back.opt.step != TRAIN_STEPS:
        raise RuntimeError("the restored trainer differs from the trained "
                           "one")
    del back
    torch.cuda.empty_cache()
    return tr, launches


PLAIN_BWD = "ssd_plain_backward"
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def profile_training(ops, tr) -> dict:
    """Device time of one train step (``torch.profiler``), split
    exclusively by kernel: everything launched inside the plain SSD
    backward (a ``record_function`` range around ``_SSDScan.backward``:
    its einsums' GEMMs and its elementwise work), and outside it the
    GEMMs, the SSD kernel and all other device work; the rest of the
    wall time is host gaps (the device's idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    orig = ops._SSDScan.backward

    def labelled(ctx, gy, gh):
        with record_function(PLAIN_BWD):
            return orig(ctx, gy, gh)

    batch = tr.pipeline.next_batch(tr.t)
    ops._SSDScan.backward = staticmethod(labelled)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.step_fn(tr.model, tr.opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops._SSDScan.backward = orig

    def inside(evt) -> bool:
        while evt is not None:
            if evt.name == PLAIN_BWD:
                return True
            evt = evt.cpu_parent
        return False

    split = {"gemm_ms": 0.0, "ssd_kernel_ms": 0.0, "other_ms": 0.0,
             "ssd_plain_backward_ms": 0.0}
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        in_bwd = inside(evt)
        for k in evt.kernels:
            ms = k.duration / 1e3
            by_name[k.name] = by_name.get(k.name, 0.0) + ms
            key = ("ssd_plain_backward_ms" if in_bwd
                   else "ssd_kernel_ms" if SSD_KERNEL_PREFIX in k.name
                   else "gemm_ms" if any(w in k.name.lower()
                                         for w in GEMM_NAMES)
                   else "other_ms")
            split[key] += ms
    total = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": total,
            "busy_share": total / wall_ms, "idle_share": 1 - total / wall_ms,
            **split, "top": [[k[:90], v] for k, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scheduler import grid_cuda
    from repro_torch.core.scheduler import grid_torch as gt
    from repro_torch.core.scheduler import planner as tp
    from repro_torch._build import build
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import serve_loop as sl
    from repro_torch.runtime import train_loop as tl

    # 1. device
    card = gpu_line()
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    built = build(grid_cuda._SOURCE, fa._SOURCE, ssd._SOURCE)
    grid_cuda._library()
    fa._library()
    ssd._library()
    emit({"build_s": time.perf_counter() - t0,
          "libraries": {n: lib.name for n, (lib, _) in built.items()}})
    for _, log in built.values():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "smem")):
                print("ptxas:", line.strip(), flush=True)

    # 3. kernels against their plain versions
    ftns, job = planner_scale_jobs(tp)
    planner = tp.TorchCarbonPlanner(ftns, device="cuda",
                                    batch_backend="fused")
    kernels = check_kernels(planner, job, grid_cuda, gt,
                            built[grid_cuda._SOURCE.name][1])
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

    # 6. the fleet day: ShardedFleet -> FleetController x 4 ->
    # CarbonAwareQueue -> plan_batch -> the planner kernels, then the same
    # day on the numpy oracle
    with SplitTimer(grid_cuda) as split:
        emit({"fleet_main_path": fleet_day(kernel_fns, split)})

    # 7. the flash kernel against its plain version at the prefill's shapes
    cfg = get_config(ARCH)
    flash_cases = check_flash(
        fa, cfg, ptxas_usage(built[fa._SOURCE.name][1], FLASH_KERNEL))

    # 8. the serving main path. cuBLAS reduces bf16 GEMMs in f32 (no
    # reduced-precision reduction) and f32 GEMMs in full f32 (no TF32), so
    # the logit check below compares roundings to bf16 only.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(arch=ARCH, attn_impl="flash", remat="none", seed=SEED)
    srv, probe, flash_launches = serve(fa, sl, cfg, run, power_limit_w(card))

    # 9. logits: cached path against the plain full forward
    check_logits(M, srv, probe)
    emit({"profile": profile_serving(M, srv, probe.epochs[0]["tokens"])})
    del srv, probe
    torch.cuda.empty_cache()

    # 10. training mamba2-370m: the SSD kernel against its plain version, one
    # step on the kernel path against the plain path, then the Trainer
    tcfg = get_config(TRAIN_ARCH)
    ssd_case = check_ssd(
        ssd, tcfg, ptxas_usage(built[ssd._SOURCE.name][1], SSD_KERNEL_PREFIX))
    trun = RunConfig(arch=TRAIN_ARCH, attn_impl="flash", remat="block",
                     seed=SEED, warmup_steps=2, total_steps=TRAIN_STEPS)
    from repro_torch.data.pipeline import TokenPipeline
    batch = TokenPipeline(vocab_size=tcfg.vocab_size, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, seed=SEED,
                          device=DEVICE).next_batch()
    check_train_step(M, adamw, ssd, tcfg, trun, batch)
    del batch
    tr, ssd_launches = train(tl, ssd, tcfg, trun, power_limit_w(card))
    emit({"train_profile": profile_training(ops, tr)})
    del tr
    torch.cuda.empty_cache()

    # 11. results
    worst = max(flash_cases, key=lambda c: c["rel_rms_err"])
    kernels.append(
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
         "replaces": "src/repro/kernels/flash_attention.py:30",
         "launches": flash_launches,
         "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
         "rel_rms_err": worst["rel_rms_err"],
         **{k: flash_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
         "timed_case": flash_cases[0]["case"],
         "cases": {c["case"]: {k: c[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
             "rel_rms_err")} for c in flash_cases}})
    kernels.append(
        {"name": "ssd_scan", "route": "cuda", "source": SSD_SRC,
         "replaces": "src/repro/kernels/ssd_scan.py:26",
         "launches": ssd_launches,
         **{k: ssd_case[k] for k in (
             "max_abs_err", "y_rel_rms_err", "h_rel_rms_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
