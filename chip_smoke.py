#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, started together, ``sm_90a``, into ``build/repro_torch_kernels/``)
and drives the port's paths:

* fleet admission planning: the planner's two kernels against their plain
  torch versions on the tables of a real 4096-job admission window, then
  ``TorchCarbonPlanner.plan_batch`` over four 4096-job windows of the
  ``planner_scale`` deployment, with 32 sampled plans checked against the
  port's numpy oracle; then the per-leg torch scorer
  (``TorchCarbonPlanner(backend="torch")``) on ``planner_scan``'s
  deployment: one ``plan()``, the 200-job batch through ``plan_batch``'s
  per-job scan and 32 re-scores under a drift hook, each equal to the
  numpy backend's cells with emissions and cost within 1e-4, no leg off
  the card, ``plan()`` timed on both backends and profiled; then (4c) a
  4096-job window on ``batch_backend="torch"`` with the lattice's cell
  axis split over three copies of the card (three shards, which do not
  divide the 64-cell bucket): tables within 1e-9 of unsplit, the same
  plans, the numpy oracle's cells, and ``shard=MeshConfig(n_devices=2)``
  resolving to the one card with the unsplit run's launches by name;
* the fleet control plane's closed loop: ``examples/fleet_day.py``'s first
  act (4000 jobs over 24 simulated hours, a 4-shard ``ShardedFleet``, a 6x
  forecast shock at 11:00 for six hours) on the default fused backend,
  admission and the shards' re-plan sweeps planning through the two
  planner kernels, then the same day on the numpy oracle: every job the
  same admission cell and outcome row, emissions within 1e-4, and
  fleet_day's own acceptance (all jobs done, a migration, a re-plan, the
  merged ledger audit within 1e-9);
* the fleet's worker processes, checkpoints and streaming gateway: the
  same day on four spawn workers (a CUDA context each, the fused kernels
  in their re-plan sweeps) with two seeded worker kills, a checkpoint to
  disk at hour 12 and a restore onto fresh workers, bit-identical to the
  in-process day with the same count of fused plans;
  ``examples/fleet_durable.py`` on fork workers after CUDA is live (numpy
  shards, fused admission) equal to its oracle; ``examples/fleet_stream.py``'s
  bursty day through a ``StreamingGateway`` on the fused kernels, pipeline
  off and on, bit-identical, the gateway's planner thread launching both
  kernels; and ``examples/fleet_day.py``'s act three, the 200-zone lattice
  day with fused admission, making the numpy day's decisions;
* serving gemma3-12b at full width and depth (48 layers, d_model 3840,
  vocab 262144, random weights from a seed): the flash-attention kernel
  against its plain version at the prefill's shapes (global, window 1024
  and a ragged length), then ``Server`` answering 8 requests of 2048-token
  prompts with 32 new tokens each, the cached logits checked against a
  plain full forward and the flash prefill against the naive one; then
  (9b) the same prompts' prefill under a 1 x 4 ``HostMesh`` of the card
  with ``seq_attn_rules("2d")``: sequence-parallel attention, each rank on
  the blockwise path, the 40 local layers on the band of 1536 keys, each
  call held as it happens to the naive path (relative RMS 1e-2) and the
  logits to the unmeshed flash prefill (0.05 of max |logit|), a control
  whose ranks' query offset is off by one key block failing both, the
  meshed and unmeshed prefills timed;
* training mamba2-370m at full width and depth (48 layers, d_model 1024,
  vocab 50280, 32 SSD heads of 64, d_state 128, chunk 256, random weights
  from a seed) on 8 x 2048-token batches: the SSD chunk-scan kernel
  against its plain version at the training shapes, one train step on the
  kernel path against the same step on the plain chunked path, then
  ``Trainer`` for 6 steps with a checkpoint every 3 and a bit-exact
  restore, and a ``torch.profiler`` split of one step;
* serving mamba2-370m at full size: the SSD kernel against its plain
  version at the serving prefill's shapes (4 x 2048 tokens), then
  ``Server`` answering 8 requests of 2048-token prompts with 32 new tokens
  each (the SSD kernel in prefill, its final state the decode state,
  O(1) recurrent decode), the cached logits checked against a plain full
  forward;
* seamless-m4t-medium at full size (12 encoder and 12 decoder layers,
  d_model 1024, 16 heads of 64, vocab 256206): the flash kernel against
  its plain version at the encoder's non-causal shapes (512 frames and a
  ragged 500) and the decoder's causal one, prefill with 512 audio frames
  and 31 decode steps through the model API (cached logits against a
  plain full forward), and one train step of 4 x 2048 tokens on the
  kernel path against the plain path;
* internvl2-1b at full size (24 layers, d_model 896, 14 query heads over
  2 kv heads of 64, vocab 151655): the flash kernel at GQA 14:2 against
  its plain version, ``Server`` answering 8 text-only requests, prefill
  with 256 patch embeddings and 1792 text tokens and 31 decode steps
  (cached logits against a plain full forward), and one train step, as
  seamless's;
* the moe and hybrid families at full width, depth cut to one card
  (phases 14-16): jamba-v0.1-52b at 16 layers (two 8-layer periods of
  seven Mamba-2 layers, d_state 16 and 128 heads, and one NoPE attention
  layer, 32 query heads over 8 of 128; 16 experts top-2 on every other
  layer), arctic-480b at 2 layers (56 heads over 8 of 128; 128 experts
  top-2 beside a dense residual FFN) and kimi-k2 at 1 layer (64 heads
  over 8 of 112; 384 experts top-8 and a shared expert): the flash
  kernel (and jamba's SSD kernel) against its plain version at each
  model's prefill shapes, ``Server`` answering 8 (jamba) or 4 requests of
  2048-token prompts with 32 new tokens, a profile of one prefill and
  three decode steps, and the MoE logit gate (see MOE_PHASES), which
  prints each MoE layer's dropped assignments and top-k flips; jamba and
  kimi-k2 then run the same prompts under a 2 x 2 ``HostMesh`` of the
  card (``"2d"`` rules: the MoE's expert-parallel branch, two token
  shards at their own capacity, two model ranks), each MoE call held
  against the single-device MoE of each shard, and under a 1 x 2 mesh,
  whose cached logits must sit within 0.05 of the unmeshed ones;
* the same three families trained at full width with depth and expert
  count cut to one card (phases 17-19, MOE_TRAIN_PHASES): jamba-v0.1-52b
  one 8-layer period with 3 of 16 experts at 2 x 2048 tokens,
  arctic-480b one layer with 8 of 128 at 8 x 2048, kimi-k2 one layer with
  16 of 384 at 4 x 2048: ``launch.train --full`` refused with its byte
  count, the flash kernel (and jamba's SSD kernel) against its plain
  version at the training shapes, one train step on the kernel path
  against the plain path routing as the kernel path chose (loss, aux,
  gradient norms; every recompute routing as its forward), then three
  ``Trainer`` steps with their seconds, tokens/s, peak memory, launches
  and gCO2, and a profile of one more step; kimi-k2's cut also takes one
  step under a 1 x 2 mesh (8 experts a rank) and one under a 1 x 4 mesh
  with ``seq_attn_rules("2d")`` (4 experts a rank, attention
  sequence-parallel forward and backward, the routing replayed), each
  held to the unmeshed step;
* the roofline (phase 20): gemma3-12b's served 4 x 2048 prefill and
  mamba2-370m's 8 x 2048 train step on the blockwise path, each traced on
  meta tensors through ``steps.lower_cell`` and
  ``cost_analysis.analyze_cell`` on a one-device mesh and run on the card
  under ``FlopCounterMode``: the two dot-FLOP counts equal, the CUDA-event
  ms at least the H100 roofline's compute term, the terms printed with
  the card's name and power limit; the card's peak memory over one call
  within [0.8, 1.25] of the trace's arguments plus its peak of live
  temporaries;
* the dry run (phase 21): ``python -m repro_torch.launch.dryrun`` on
  kimi-k2's ``train_4k`` and mamba2-370m's ``long_500k`` at full size over
  both production meshes (16 x 16 and 2 x 16 x 16, shape only, traced on
  the card's host), each record with the reference's keys and rendered by
  ``scripts/roofline_table.py``.

Every phase that fails raises, so the exit code is non-zero; without a
CUDA device the script exits 2 and prints no result. Each phase prints its
seconds. The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

WINDOW = 4096                  # jobs per admission window (planner_scale)
N_WINDOWS = 4
N_SAMPLED = 32                 # oracle spot check, as planner_scale samples
N_TIMED = 25                   # CUDA-event timings per kernel (median)
DT_S, SLOT_S, STRIDE = 60.0, 3600.0, 60

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
# H100 SXM peaks (NVIDIA's data sheet), defined once in the port: HBM
# bytes/s, f32 and f64 non-tensor FLOP/s, bf16 dense tensor-core FLOP/s
from repro_torch.cluster.topology import (  # noqa: E402
    H100_BF16_FLOPS as BF16_TC_FLOPS, H100_F32_FLOPS as F32_FLOPS,
    H100_F64_FLOPS as F64_FLOPS, H100_HBM_BPS as HBM_BPS)

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
# flash check at the prefill's shapes: (name, T = S, window, causal)
FLASH_CASES = (("global", PROMPT_LEN, None, True),
               ("local", PROMPT_LEN, 1024, True),
               ("ragged", 2000, None, True))
# 11-13: the SSM, encoder-decoder and vision-language families at full
# width and depth, random weights from SEED, PROMPT_LEN positions a
# sequence in batches of SERVE_BATCH (and MAX_NEW new tokens)
SSM_ARCH, ENCDEC_ARCH, VLM_ARCH = ("mamba2-370m", "seamless-m4t-medium",
                                   "internvl2-1b")
N_FRAMES = PROMPT_LEN // 4     # audio frames: one per 4 target positions
# mamba2's plain full forward runs its scan at chunk 32: prompt and new
# tokens, 2080 = 65 x 32, are not whole chunks of 256. The chunked scan
# computes the same function at any chunk (only its sum order differs;
# tests/test_torch_ssm_serving.py holds three chunks to 1e-5).
SSM_FULL_CHUNK = 32
# seamless's encoder (T = S = 512 frames, and a ragged 500) and decoder,
# non-causal and causal; internvl2's prefill (GQA 14:2); head_dim 64
ENCDEC_FLASH_CASES = (("seamless_encoder", N_FRAMES, None, False),
                      ("seamless_encoder_ragged", N_FRAMES - 12, None, False),
                      ("seamless_decoder", PROMPT_LEN, None, True))
VLM_FLASH_CASES = (("internvl2_gqa14to2", PROMPT_LEN, None, True),)

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


class PhaseClock:
    """Each phase's wall seconds: ``mark(name)`` closes the phase that
    began at the previous mark and prints it."""

    def __init__(self):
        self.phases: dict = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now
        emit({"phase": name, "s": self.phases[name]})


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
        self._lock = threading.Lock()
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
            with self._lock:
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


# --- 4b: the per-leg scorer behind plan() and rescore() ---------------------
#
# TorchCarbonPlanner(backend="torch") scores each (FTN x replica) leg of a
# plan() or rescore() on the card (grid_torch.TorchGridScorer, torch ops,
# no kernel of its own). Held against backend="numpy", the pinned oracle:
# the same cell, emissions and cost within LEG_TOL_REL, as the reference
# holds its jax scorer (tests/test_controlplane.py); the torch side runs
# the f32 CI chain of the lattice (~1e-7 relative).

LEG_TOL_REL = 1e-4
N_PLAN_TIMED = 20              # plan() timings per backend (median)
N_RESCORED = 32


def planner_scan_jobs(mod):
    """``benchmarks/perf.py::planner_scan``'s deployment: its FTNs, its job
    (300 GB from uc or m1 to tacc, 48 h deadline) and its 200-job batch
    (50-449 GB, submissions over 4 h in 600 s steps)."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    ftns = [mod.FTN("uc", "skylake", 10.0), mod.FTN("m1", "apple_m1", 1.2),
            mod.FTN("tacc", "cascade_lake", 10.0)]
    job = mod.TransferJob("bench", 300e9, ("uc", "m1"), "tacc",
                          mod.SLA(deadline_s=48 * 3600.0), t0)
    batch = [mod.TransferJob(f"b{i}", (50 + (7 * i) % 400) * 1e9,
                             ("uc", "m1"), "tacc",
                             mod.SLA(deadline_s=48 * 3600.0),
                             t0 + (i % 24) * 600.0) for i in range(200)]
    return ftns, job, batch


def plan_diffs(got, want) -> dict:
    """Plans against the oracle's: cells (start, source, FTN, feasible)
    that differ, and the largest relative emission and cost difference
    over the cells that agree (an infinite cost must be infinite on both
    sides)."""
    cells, emis, cost = 0, 0.0, 0.0
    for g, w in zip(got, want):
        if (g.start_t, g.source, g.ftn, g.feasible) != \
                (w.start_t, w.source, w.ftn, w.feasible):
            cells += 1
            continue
        emis = max(emis, _rel(g.predicted_emissions_g,
                              w.predicted_emissions_g))
        cost = max(cost, _rel(g.cost, w.cost) if math.isfinite(w.cost)
                   else (0.0 if g.cost == w.cost else math.inf))
    return {"plans": len(got), "cell_mismatches": cells
            + abs(len(got) - len(want)), "max_emis_rel_err": emis,
            "max_cost_rel_err": cost}


def busy_ms(prof) -> float:
    """The ms in which the device ran at least one of a profile's device
    events (kernels, copies, sets): the union of their intervals, so work
    that overlaps is counted once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_events(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its device events (kernels,
    copies, sets), their device ms and the wall ms, and its launches: the
    host's runtime calls that start device work (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...) by name. The profiler
    records those as the host makes them; a device event comes from an
    asynchronous activity buffer, and phase 4c once saw one fewer than the
    same call launched (``scripts/cell_split_events.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    launches = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CPU
        and e.name.startswith("cu")
        and any(w in e.name for w in ("Launch", "Memcpy", "Memset")))
    return {"device_events": len(dev), "device_ms": ms,
            "launches": dict(sorted(launches.items())),
            "profiled_wall_ms": wall_ms,
            "busy_share": busy_ms(prof) / wall_ms}


def leg_scorer(tp) -> dict:
    """``plan()``, ``plan_batch()`` (``batch_backend="numpy"``: a
    ``plan()`` a job) and ``rescore()`` on the torch backend against the
    numpy backend on ``planner_scan``'s deployment: one plan (then timed,
    the two backends in turns, and profiled), the 200-job batch, and 32
    of its plans re-scored under a drift hook (as
    ``tests/_torch_ref.py::drift``). Every leg on the card: numpy legs 0."""
    ftns, job, batch = planner_scan_jobs(tp)
    fast = tp.TorchCarbonPlanner(ftns, device=DEVICE, backend="torch",
                                 batch_backend="numpy")
    oracle = tp.TorchCarbonPlanner(ftns, device=DEVICE,
                                   batch_backend="numpy")
    one = plan_diffs([fast.plan(job)], [oracle.plan(job)])
    times = {"torch": [], "numpy": []}
    for _ in range(N_PLAN_TIMED):
        for name, pl in (("numpy", oracle), ("torch", fast)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pl.plan(job)
            times[name].append((time.perf_counter() - t0) * 1e6)
    legs0 = fast.scorer.legs
    prof = device_events(lambda: fast.plan(job))
    legs_a_plan = fast.scorer.legs - legs0
    t0 = time.perf_counter()
    got = fast.plan_batch(batch)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = oracle.plan_batch(batch)
    batch_numpy_s = time.perf_counter() - t0
    many = plan_diffs(got, want)

    def drift(path, ts):
        return 1.0 + 0.1 * np.sin(np.asarray(ts) / 7200.0 + path.n_hops)

    picks = np.linspace(0, len(batch) - 1, N_RESCORED).round().astype(int)
    rescored = []
    for pl in (fast, oracle):
        pl.emission_scale_fn = drift
        rescored.append([pl.rescore(batch[i], got[i]) for i in picks])
        pl.emission_scale_fn = None
    if any(p is None for plans in rescored for p in plans):
        raise RuntimeError("a re-score found its plan's cell gone")
    re = plan_diffs(*rescored)
    sc = fast.scorer
    res = {"plan": one, "batch": many, "rescore": re,
           "plan_us_numpy": statistics.median(times["numpy"]),
           "plan_us_torch": statistics.median(times["torch"]),
           "plan_us_rounds": times, "legs_a_plan": legs_a_plan,
           "device_events_a_plan": prof["device_events"],
           "device_ms_a_plan": prof["device_ms"],
           "plan_busy_share": prof["busy_share"],
           "batch_s_torch": batch_s, "batch_s_numpy": batch_numpy_s,
           "windows_built": sc.windows_built, "legs": sc.legs,
           "numpy_legs": sc.numpy_legs, "tol_rel": LEG_TOL_REL}
    emit({"leg_scorer": res})
    bad = [k for k, d in (("plan", one), ("batch", many), ("rescore", re))
           if d["cell_mismatches"] or not (
               d["max_emis_rel_err"] <= LEG_TOL_REL
               and d["max_cost_rel_err"] <= LEG_TOL_REL)]
    if bad or len(got) != len(batch) or sc.numpy_legs or not sc.legs:
        raise RuntimeError(f"the per-leg torch scorer disagrees with numpy "
                           f"({bad}) or left the card: {res}")
    return res


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


class ThreadLaunches:
    """Counts the planner kernels' launches per launching thread, at the
    bound library's entry points (each wrapper calls its entry point once
    per launch, on the thread that launches), under a lock: the streaming
    gateway's planner thread and the coordinator launch at once, and a
    before/after read of the wrappers' shared counts would mix them."""

    SYMBOLS = SplitTimer.LAUNCHES

    def __init__(self, lib):
        self.lib = lib
        self._lock = threading.Lock()
        self._by_thread: dict = {}
        self._orig = {sym: getattr(lib, sym) for sym in self.SYMBOLS.values()}

    def __enter__(self):
        for name, sym in self.SYMBOLS.items():
            def counted(*a, _launch=self._orig[sym], _name=name):
                err = _launch(*a)
                if err == 0:
                    key = (threading.get_ident(), _name)
                    with self._lock:
                        self._by_thread[key] = self._by_thread.get(key, 0) + 1
                return err
            setattr(self.lib, sym, counted)
        return self

    def __exit__(self, *exc):
        for sym, launch in self._orig.items():
            setattr(self.lib, sym, launch)

    def mine(self) -> dict:
        """Launches the calling thread made so far, per kernel."""
        me = threading.get_ident()
        with self._lock:
            return {n: self._by_thread.get((me, n), 0) for n in self.SYMBOLS}


class CallTimer:
    """Wraps one bound method of an object: counts its calls, their
    synchronized wall seconds and the kernel launches the calling thread
    made inside them (``threads``, a live :class:`ThreadLaunches`); the
    tallies update under a lock."""

    def __init__(self, obj, attr: str, threads):
        self.fn, self.threads = getattr(obj, attr), threads
        self._lock = threading.Lock()
        self.calls, self.wall_s = 0, 0.0
        self.calls_launching = 0
        self.launches = {n: 0 for n in threads.SYMBOLS}
        setattr(obj, attr, self)

    def __call__(self, *a, **k):
        before = self.threads.mine()
        _sync()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        _sync()
        wall = time.perf_counter() - t0
        after = self.threads.mine()
        made = {n: after[n] - before[n] for n in self.launches}
        with self._lock:
            self.wall_s += wall
            self.calls += 1
            self.calls_launching += any(made.values())
            for n, c in made.items():
                self.launches[n] += c
        return out


def run_fleet_day(sharded, ov, tp, t0: float, kernel_fns: dict, threads,
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
    admit = CallTimer(fleet.planner, "plan_batch", threads)
    sweeps = [CallTimer(ctl.queue, "replan_pending", threads)
              for ctl in fleet.controllers]
    # inside the sweeps: re-scoring each queued job's old cell
    rescores = [CallTimer(ctl.planner, "rescore_batch", threads)
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


def compare_fleet_days(fleet, report, oracle_fleet, oracle,
                       phase: str = "fleet day") -> dict:
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
        raise RuntimeError(f"{phase}: {len(bad)} jobs differ from the "
                           f"numpy day")
    if not max(emis_rel, out["total_planned_rel_err"],
               out["total_actual_rel_err"]) <= FLEET_EMIS_TOL_REL:
        raise RuntimeError(f"{phase}: emissions off the numpy day: {out}")
    return out


def fleet_day(kernel_fns: dict, threads, split=None) -> tuple:
    """The fleet day on the default fused backend with the planner
    kernels' launch counts reset just before it, then the same day on the
    numpy oracle; every gate raises (the shards' re-plan sweeps must
    launch both kernels). ``threads`` is a live :class:`ThreadLaunches`.
    Returns the fleet_main_path line and the fused day's report.
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
    fleet, report, stats = run_fleet_day(sharded, ov, tp, t0, kernel_fns,
                                         threads)
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
    if not all(stats["replan_launches"][n] > 0 for n in kernel_fns):
        raise RuntimeError(f"fleet day: the re-plan sweeps launched the "
                           f"planner kernels {stats['replan_launches']} "
                           f"times")
    ofleet, oreport, ostats = run_fleet_day(
        sharded, ov, tp, t0, kernel_fns, threads, batch_backend="numpy",
        shard_backend="numpy")
    oracle = fleet_summary(ofleet, oreport, ostats)
    line["numpy_day"] = {k: oracle[k] for k in (
        "drain_s", "submit_many_s", "admission_plan_batch_s",
        "replan_sweeps", "replan_sweeps_s", "replan_rescore_s",
        "jobs_per_s", "migrations",
        "replan_events", "plans_changed", "sla_misses", "total_planned_g",
        "total_actual_g")}
    line["vs_numpy_day"] = compare_fleet_days(fleet, report, ofleet, oreport)
    line["fused_plan_batches"] = fused_plan_batches(report)
    return line, report


# --- the fleet's worker processes, checkpoint/restore and streaming ---------

# Phase 6b: the fleet day on four spawn workers, one CUDA context each,
# hourly barriers, two seeded worker kills before the cut at hour 12, a
# checkpoint to disk, the coordinator closed and the run restored onto
# fresh workers. The merge must be phase 6's in-process fused day bit for
# bit: a kernel's reductions run in a fixed order whichever process
# launches it (rate_prefix sums its cluster's segment totals in rank
# order), and every worker thaws the coordinator's field snapshot.
WORKER_FAULT_SEED, WORKER_CUT_H = 3, 12
FLEET_CKPT = REPO / "build" / "chip_smoke_fleet.ckpt"
# the report fields phase 6b holds to phase 6's, and 6d's two runs to each
# other
SAME_FIELDS = ("total_planned_g", "total_actual_g", "ledger_total_g",
               "outcomes", "trace", "n_events", "n_steps", "migrations")
# examples/fleet_durable.py and examples/fleet_stream.py, copied (both
# import the reference): 48 jobs on fork workers with a seeded fault plan
# and a coordinator kill at hour 6; the bursty_day stream through a gateway
DURABLE_SEED, DURABLE_KILL_AT, DURABLE_CKPT = 11, 6, \
    REPO / "build" / "chip_smoke_durable.ckpt"
STREAM_SEED, STREAM_WINDOW_S, STREAM_MAX_BATCH, STREAM_MAX_INFLIGHT = \
    42, 600.0, 128, 224
LATTICE_SEED = 7


def fused_plan_batches(report) -> float:
    """The merged ``planner_plan_batches_total{backend="fused"}``: every
    ``plan_batch`` a fused planner ran, in the coordinator or a worker."""
    return sum(c["value"] for c in (report.metrics or {}).get("counters", ())
               if c["name"] == "planner_plan_batches_total"
               and c["labels"].get("backend") == "fused")


def only_respawns(degradations, phase: str) -> None:
    """A worker that cannot launch a kernel reports an error, and the
    supervisor's ladder would plan its shard on numpy or in-process: on
    the card that hides the kernel, so any rung but a respawn fails."""
    bad = [d for d in degradations if "respawned" not in d]
    if bad:
        raise RuntimeError(f"{phase}: degradations other than respawns: "
                           f"{bad}")


def same_report(got, want, phase: str) -> None:
    diff = [f for f in SAME_FIELDS if getattr(got, f) != getattr(want, f)]
    if diff:
        raise RuntimeError(f"{phase}: the merge differs in {diff}")


def fleet_workers(day_line: dict, day_report, kernel_fns: dict) -> dict:
    """Phase 6b: the fleet day on spawn workers through the fused kernels,
    kills, checkpoint and restore; returns the fleet_workers line. The
    coordinator's admission must launch the kernels as often as phase 6's
    did (``day_line``); the workers' launches show in the merged count of
    fused plans."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    from repro_torch.core.controlplane import parallel, persistence, sharded
    from repro_torch.core.scheduler import overlay as ov
    from repro_torch.core.scheduler import planner as tp

    plan = parallel.FaultPlan.seeded(
        FLEET_N_SHARDS, seed=WORKER_FAULT_SEED, horizon=WORKER_CUT_H,
        kills=2, backend_faults=0)
    kw = dict(n_shards=FLEET_N_SHARDS, migration_threshold=250.0,
              replan_every_s=3600.0, migrate_check_every_s=900.0, obs=True,
              device=DEVICE)
    degradations, line = [], {}
    w0 = time.perf_counter()
    fleet = sharded.ShardedFleet(
        fleet_day_ftns(ov), parallel="spawn", shard_backend="fused",
        supervision=parallel.SupervisionPolicy(checkpoint_every=2),
        fault_plan=plan, **kw)
    try:
        # the first shard command starts the workers: admission, then four
        # spawned interpreters thawing the field and opening CUDA contexts
        for fn in kernel_fns.values():
            fn.launches = 0
        fleet.submit_many(fleet_day_jobs(tp, t0))
        line["admission_launches"] = {n: fn.launches
                                      for n, fn in kernel_fns.items()}
        fleet.inject_shock(t0 + 11 * 3600.0, 6.0, duration_s=6 * 3600.0,
                           zones=FLEET_SHOCK_ZONES)
        for k in range(1, WORKER_CUT_H + 1):
            fleet.pump_all(t0 + k * 3600.0, strict=True, horizon=math.inf)
            if k == 1:
                line["spawn_to_first_barrier_s"] = time.perf_counter() - w0
        c0 = time.perf_counter()
        persistence.save(persistence.capture(fleet), FLEET_CKPT)
        line["capture_save_s"] = time.perf_counter() - c0
        line["checkpoint_bytes"] = FLEET_CKPT.stat().st_size
        degradations += fleet.degradations
        line["recoveries"] = [{k: r[k] for k in ("shard", "outcome",
                                                 "reason", "wall_s")}
                              for r in fleet._runner.recoveries]
    finally:
        fleet.close()
    r0 = time.perf_counter()
    fleet = persistence.restore(persistence.load(FLEET_CKPT),
                                parallel="spawn", device=DEVICE)
    try:
        fleet.pump_all(t0 + (WORKER_CUT_H + 1) * 3600.0, strict=True,
                       horizon=math.inf)
        line["restore_to_first_barrier_s"] = time.perf_counter() - r0
        report = fleet.run()
        degradations += report.degradations
        line["coordinator_wall_s"] = time.perf_counter() - w0
        line["worker_shard_wall_s"] = [r.wall_s for r in fleet.shard_reports]
        line["coordinator_launches"] = {n: fn.launches
                                        for n, fn in kernel_fns.items()}
    finally:
        fleet.close()
        FLEET_CKPT.unlink(missing_ok=True)
    kills = sum(a.kind == "kill" for a in plan.actions)
    line.update(faults=[dataclasses.astuple(a) for a in plan.actions],
                degradations=list(degradations),
                fused_plan_batches=fused_plan_batches(report),
                n_completed=report.n_completed,
                total_actual_g=report.total_actual_g)
    only_respawns(degradations, "fleet workers")
    if len(degradations) != kills:
        raise RuntimeError(f"fleet workers: {kills} kills, "
                           f"{len(degradations)} respawns")
    same_report(report, day_report, "fleet workers vs the in-process day")
    if line["admission_launches"] != day_line["admission_launches"]:
        raise RuntimeError(f"fleet workers: admission launched "
                           f"{line['admission_launches']}, phase 6's "
                           f"{day_line['admission_launches']}")
    if line["fused_plan_batches"] != fused_plan_batches(day_report):
        raise RuntimeError(f"fleet workers: {line['fused_plan_batches']} "
                           f"fused plan_batch calls, the in-process day "
                           f"{fused_plan_batches(day_report)}")
    return line


def durable_jobs(tp, t0: float) -> list:
    return [tp.TransferJob(f"d{i}", (200 + (37 * i) % 1400) * 1e9,
                           ("uc", "site_ne") if i % 3 else ("uc",), "tacc",
                           tp.SLA(deadline_s=(8 + i % 6) * 3600.0),
                           t0 + i * 600.0) for i in range(48)]


def fleet_durable(kernel_fns: dict) -> dict:
    """Phase 6c: examples/fleet_durable.py on fork workers in this process,
    whose CUDA context is live: numpy shards on the CPU, admission on the
    fused kernels in the coordinator; the restored, faulted run must equal
    its in-process oracle."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    from repro_torch.core.controlplane import parallel, persistence, sharded
    from repro_torch.core.scheduler import overlay as ov
    from repro_torch.core.scheduler import planner as tp

    def build(**kw):
        fleet = sharded.ShardedFleet(
            fleet_day_ftns(ov), n_shards=FLEET_N_SHARDS,
            migration_threshold=250.0, shard_backend="numpy", device=DEVICE,
            **kw)
        fleet.submit_many(durable_jobs(tp, t0))
        fleet.inject_shock(t0 + 5 * 3600.0, 6.0, duration_s=5 * 3600.0,
                           zones=FLEET_SHOCK_ZONES)
        return fleet

    before = {n: fn.launches for n, fn in kernel_fns.items()}
    oracle = build().run()
    plan = parallel.FaultPlan.seeded(FLEET_N_SHARDS, seed=DURABLE_SEED,
                                     horizon=4, kills=2, backend_faults=1)
    w0 = time.perf_counter()
    fleet = build(parallel="fork", fault_plan=plan,
                  supervision=parallel.SupervisionPolicy(
                      command_timeout_s=5.0, checkpoint_every=2))
    degradations = []
    try:
        for k in range(1, 13):
            fleet.pump_all(t0 + k * 3600.0, strict=True, horizon=math.inf)
            if k == DURABLE_KILL_AT:
                persistence.save(persistence.capture(fleet), DURABLE_CKPT)
                degradations += fleet.degradations
                fleet.close()
                fleet = persistence.restore(persistence.load(DURABLE_CKPT),
                                            parallel="fork", device=DEVICE)
        report = fleet.run()
        degradations += report.degradations
    finally:
        fleet.close()
        DURABLE_CKPT.unlink(missing_ok=True)
    audit = abs(report.ledger_total_g - report.total_actual_g) \
        / max(report.total_actual_g, 1e-12)
    line = {"wall_s": time.perf_counter() - w0, "jobs": report.n_jobs,
            "faults": [dataclasses.astuple(a) for a in plan.actions],
            "degradations": list(degradations), "ledger_audit_rel_err": audit,
            "admission_launches": {n: fn.launches - before[n]
                                   for n, fn in kernel_fns.items()}}
    # examples/fleet_durable.py's acceptance (:106-113)
    if not (report.n_completed == report.n_jobs == oracle.n_jobs
            and report.total_actual_g == oracle.total_actual_g
            and report.ledger_total_g == oracle.ledger_total_g
            and report.outcomes == oracle.outcomes
            and (report.n_events, report.n_steps)
            == (oracle.n_events, oracle.n_steps) and audit < 1e-9):
        raise RuntimeError(f"fleet durable: the restored run differs from "
                           f"its oracle: {line}")
    if not any("respawned" in d for d in degradations):
        raise RuntimeError(f"fleet durable: no respawn in {degradations}")
    if not all(line["admission_launches"].values()):
        raise RuntimeError(f"fleet durable: admission launched the kernels "
                           f"{line['admission_launches']} times")
    return line


def stream_run(sharded, streaming, sc, t0: float, pipeline: str,
               threads=None) -> tuple:
    """examples/fleet_stream.py's ``_run`` on the fused backend. With
    ``threads`` (a live :class:`ThreadLaunches`) the gateway's batch
    planner is wrapped in a :class:`CallTimer`, which synchronizes the
    card around each call; without, nothing is wrapped."""
    fleet = sharded.ShardedFleet(list(sc.ftns), n_shards=FLEET_N_SHARDS,
                                 migration_threshold=250.0, device=DEVICE)
    for shock in sc.shocks:
        fleet.inject_shock(t0 + shock.t_off_s, shock.factor,
                           duration_s=shock.duration_s, zones=shock.zones)
    gw = streaming.StreamingGateway(
        fleet, window_s=STREAM_WINDOW_S, max_batch=STREAM_MAX_BATCH,
        max_inflight=STREAM_MAX_INFLIGHT, backfill=True, pipeline=pipeline,
        device=DEVICE)
    batch = None if threads is None \
        else CallTimer(gw._batch_planner, "plan_batch", threads)
    w0 = time.perf_counter()
    report = gw.run(sc.jobs(STREAM_SEED, t0))
    _sync()
    return report, gw.stats(), batch, time.perf_counter() - w0


# the order of 6d's uninstrumented runs (ABBA, so that warm-up and drift
# fall on both modes alike)
STREAM_PLAIN_ORDER = ("off", "on", "on", "off")


def fleet_stream(grid_cuda, threads) -> dict:
    """Phase 6d: the bursty_day stream through a StreamingGateway on the
    fused kernels. First the uninstrumented runs of STREAM_PLAIN_ORDER,
    which alone give each mode's wall and jobs/s; then pipeline off and on
    once each with the batch planner wrapped (``threads``, a live
    :class:`ThreadLaunches`, counts launches by thread) and CUDA events
    around each launch (a :class:`SplitTimer` on ``grid_cuda``, the
    kernels' device time with pipeline off). Gates: the example's
    acceptance, every merge bit-identical to the first, the gateway's
    batch planner launching both kernels (on its planner thread when
    pipelined)."""
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    from repro_torch.core.controlplane import sharded, streaming
    from repro_torch.core.workloads import get_scenario

    sc = get_scenario("bursty_day")
    line, reports = {"plain": {"on": [], "off": []}}, []
    for mode in STREAM_PLAIN_ORDER:
        report, st, _, wall = stream_run(sharded, streaming, sc, t0, mode)
        reports.append(report)
        line["plain"][mode].append({
            "wall_s": wall, "jobs_per_s": report.n_jobs / wall,
            "pipelined_batches": st.n_pipelined_batches,
            "plan_wall_s": st.plan_wall_s, "stall_wall_s": st.stall_wall_s,
            "overlap_fraction": st.overlap_fraction})
        if (mode == "on") != (st.n_pipelined_batches > 0):
            raise RuntimeError(f"fleet stream ({mode}, plain): "
                               f"{st.n_pipelined_batches} pipelined batches")
    with SplitTimer(grid_cuda) as split:
        for mode in ("off", "on"):
            split.reset()
            report, st, batch, wall = stream_run(sharded, streaming, sc, t0,
                                                 mode, threads)
            line[mode] = stream_line(report, st, batch, wall, mode, split)
            reports.append(report)
    if line["on"]["pipelined_batches"] <= 0:
        raise RuntimeError("fleet stream: no batch was planned on the "
                           "planner thread")
    for k, report in enumerate(reports[1:], 1):
        same_report(report, reports[0], f"fleet stream run {k} vs run 0")
    return line


def stream_line(report, st, batch, wall: float, mode: str, split) -> dict:
    """One instrumented 6d run's line, and its gates."""
    # with the planner thread launching too, two threads' event pairs on
    # the one stream bracket each other's kernels, so events time the
    # kernels only when one thread launches
    kms = sum(split.kernel_ms().values()) if mode == "off" else None
    audit = abs(report.ledger_total_g - report.total_actual_g) \
        / max(report.total_actual_g, 1e-12)
    out = {
        "wall_s": wall, "jobs_per_s": report.n_jobs / wall,
        "jobs": report.n_jobs, "batches": st.n_batches,
        "mean_batch": st.mean_batch, "max_batch": st.max_batch,
        "admission_p50_s": st.admission_p50_s,
        "admission_p95_s": st.admission_p95_s,
        "deferred": st.n_deferred, "promotions": st.n_promotions,
        "backfill_promotions": st.n_backfill_promotions,
        "sla_misses": report.sla_misses, "ledger_audit_rel_err": audit,
        "pipelined_batches": st.n_pipelined_batches,
        "plan_wall_s": st.plan_wall_s, "stall_wall_s": st.stall_wall_s,
        "overlap_fraction": st.overlap_fraction,
        "batch_planner_calls": batch.calls,
        "batch_planner_wall_s": batch.wall_s,
        "batch_planner_launches": batch.launches,
        "kernel_ms": kms,
        "device_busy_share": None if kms is None else kms / 1e3 / wall}
    # examples/fleet_stream.py's acceptance (:72-96)
    if not (report.n_completed == report.n_jobs == st.n_jobs
            and st.n_deferred > 0 and st.n_backfill_promotions > 0
            and report.sla_misses == 0 and audit < 1e-9):
        raise RuntimeError(f"fleet stream ({mode}): {out}")
    if not all(batch.launches.values()):
        raise RuntimeError(f"fleet stream ({mode}): the gateway's batch "
                           f"planner launched {batch.launches}")
    return out


def lattice_day(kernel_fns: dict, split=None) -> dict:
    """Phase 6e: examples/fleet_day.py's act three, edge_lattice_day on
    the 200-zone lattice, fused admission, then the numpy day as the
    oracle for decisions. With ``split`` (a live :class:`SplitTimer`) the
    fused day's line carries its kernel ms and the device's busy share."""
    from repro_torch.core.carbon import lattice
    from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0 as t0
    from repro_torch.core.controlplane import sharded
    from repro_torch.core.workloads import get_scenario

    sc = get_scenario("edge_lattice_day")
    jobs = list(sc.jobs(seed=LATTICE_SEED, t0=t0))
    runs = {}
    for backend in ("fused", "numpy"):
        if split is not None:
            split.reset()
        before = {n: fn.launches for n, fn in kernel_fns.items()}
        fleet = sharded.ShardedFleet(
            list(sc.ftns), n_shards=FLEET_N_SHARDS, migration_threshold=250.0,
            batch_backend=backend, shard_backend="numpy", obs=True,
            device=DEVICE)
        w0 = time.perf_counter()
        fleet.submit_many(jobs)
        _sync()
        admit_s = time.perf_counter() - w0
        report = fleet.run()
        _sync()
        stats = {"admission_s": admit_s, "wall_s": time.perf_counter() - w0,
                 "launches": {n: fn.launches - before[n]
                              for n, fn in kernel_fns.items()}}
        if split is not None and backend == "fused":
            kms = split.kernel_ms()
            stats.update(kernel_ms=kms, device_busy_share=sum(kms.values())
                         / 1e3 / stats["wall_s"])
        runs[backend] = (fleet, report, stats)
    fleet, report, stats = runs["fused"]
    audit = abs(report.ledger_total_g - report.total_actual_g) \
        / max(report.total_actual_g, 1e-12)
    by_uuid = {j.uuid: j for j in jobs}
    cross = [o for o in report.outcomes
             if o.source != by_uuid[o.job_uuid].replicas[0]
             and lattice.tier_of_endpoint(o.source)
             != lattice.tier_of_endpoint(by_uuid[o.job_uuid].replicas[0])]
    line = {**stats, "jobs": len(jobs), "zones": len(
        lattice.default_lattice(200).zones),
            "cells": fleet.planner.last_batch_cells,
            "cross_tier": len(cross), "ledger_audit_rel_err": audit,
            "numpy_day": runs["numpy"][2],
            "vs_numpy_day": compare_fleet_days(fleet, report,
                                               runs["numpy"][0],
                                               runs["numpy"][1],
                                               "lattice day")}
    # examples/fleet_day.py's act three acceptance (:170-186)
    if not (report.n_completed == len(jobs) and audit < 1e-9 and cross):
        raise RuntimeError(f"lattice day: {line}")
    if not all(stats["launches"].values()):
        raise RuntimeError(f"lattice day: admission launched the kernels "
                           f"{stats['launches']} times")
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
                   window, causal: bool = True) -> tuple:
    """Least time for one flash call on these inputs: 4*d tensor-core FLOP
    (QK^T and PV) per unmasked (q, k) pair at the bf16 dense peak, against
    q, k and v read once and o written once."""
    keys = (torch.arange(1, t + 1, dtype=torch.float64) if causal
            else torch.full((t,), float(t), dtype=torch.float64))
    if window is not None:
        keys = keys.clamp(max=window)
    ops_s = 4 * d * float(keys.sum()) * b * hq / BF16_TC_FLOPS
    bytes_s = 2 * (2 * b * t * hq * d + 2 * b * t * hkv * d) / HBM_BPS
    return 1e3 * max(ops_s, bytes_s), (
        "operations" if ops_s >= bytes_s else "bytes")


def check_flash(fa, cfg, usage=None, cases=FLASH_CASES,
                batch: int = SERVE_BATCH) -> list:
    """The flash kernel against its plain version at a model's prefill
    shapes (``batch`` sequences of ``cfg``'s heads and head_dim, bf16;
    gemma3-12b: 16 query heads over 8 kv heads of 240), or at a training
    step's; ``scaled_dot_product_attention`` on the same inputs and mask
    is timed as the library yardstick only. ``usage`` (from
    :func:`ptxas_usage`) adds the kernel's registers and shared memory."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []
    for name, t, window, causal in cases:
        q, k, v = (torch.randn((batch, t, h, d), generator=gen,
                               device=DEVICE).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal,
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
                                                      is_causal=causal)
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)

        bound, by = flash_bound_ms(batch, t, hq, hkv, d, window, causal)
        case = {"case": name, "q": list(q.shape), "kv": list(k.shape),
                "window": window, "causal": causal, **err,
                "tol_rel_rms": FLASH_REL_RMS_TOL,
                **flash_resources(fa, d, usage),
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "library_ms": median_ms(library), "bound_ms": bound,
                "bound_by": by}
        case["bound_share"] = bound / case["ms"]
        emit({"flash_check": case})
        out.append(case)
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return out


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


def serve(fa, sl, cfg, run, power_w: float, kernels=None,
          n_requests: int = N_REQUESTS):
    """The serving main path: ``Server`` answers ``n_requests`` requests
    in static batches on the card; returns the server, the probe and the
    launches over the path of each of ``kernels`` ({name: (a wrapper with
    a ``launches`` count, launches a prefill)}; the flash kernel's, one
    per layer, unless given)."""
    from repro_torch.models.params import count_params
    kernels = kernels or {"flash": (fa.flash_attention, cfg.n_layers)}
    torch.cuda.reset_peak_memory_stats()
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
        "params": n_params, "spec_params": count_params(cfg),
        "weights_gb": sum(p.numel() * p.element_size()
                          for p in srv.model.parameters()) / 1e9,
        "init_s": time.perf_counter() - t0, "site": srv.site,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "chip_power_w": power_w}})
    if n_params != count_params(cfg) \
            or len(srv.model.decoder.layers) != cfg.n_layers:
        raise RuntimeError(f"the served model is not {cfg.name} at full "
                           f"size")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (n_requests, PROMPT_LEN))
    for i in range(n_requests):
        srv.submit(sl.Request(rid=i, prompt=torch.as_tensor(prompts[i]),
                              max_new_tokens=MAX_NEW))
    sites = set(srv.cluster.sites)
    for fn, _ in kernels.values():
        fn.launches = 0
    with ServeProbe(sl, fa) as probe:
        while srv.queue:
            before = {n: fn.launches for n, (fn, _) in kernels.items()}
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
                  **{f"{n}_launches": fn.launches - before[n]
                     for n, (fn, _) in kernels.items()},
                  "flash_ms_in_prefill": flash_ms,
                  "flash_share_of_prefill": flash_ms / 1e3 / pre})
    launches = {n: fn.launches for n, (fn, _) in kernels.items()}
    n_prefill = len(probe.epochs)
    lat = sum(c.latency_s for c in srv.completions) / SERVE_BATCH
    emit({"serve_main_path": {
        "arch": cfg.name, "requests": len(srv.completions),
        "prefills": n_prefill,
        **{f"{n}_launches": v for n, v in launches.items()},
        "gen_tokens_per_s": len(srv.completions) * MAX_NEW / lat,
        "wall_s": lat}})
    for n, (_, per) in kernels.items():
        if launches[n] != per * n_prefill:
            raise RuntimeError(f"{n} launches {launches[n]} != {per} a "
                               f"prefill x {n_prefill} prefills")
    return srv, probe, launches


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def check_logits(M, srv, probe) -> dict:
    """First epoch of a ``Server``: :func:`logit_gate` on its prompts and
    the logits its loop computed."""
    ep = probe.epochs[0]
    return logit_gate(M, srv.model, srv.run, ep["tokens"], ep["logits"])


def logit_gate(M, model, run, tokens, logits, *, fed=None, full_model=None,
               label: str = "logit_check", **front) -> dict:
    """The cached path's logits (prefill's last position and every decode
    step) against a plain full forward over the prompt and the decoded
    tokens (naive attention, the chunked scan; no cache), and the kernel
    path's prefill against the plain one. A control compares each cached
    step with the full forward's next position: a cache off by one slot
    would look like it. The decoded tokens are ``fed``, or each step's
    argmax but the last (greedy, as ``Server``); ``front`` holds the
    prompt's ``frames`` or ``patches``; ``full_model`` (the same weights)
    runs the full forward."""
    naive = dataclasses.replace(run, attn_impl="naive")
    cached = torch.stack(logits, dim=1)                        # [B, n, V]
    if fed is None:
        fed = torch.stack([lg.argmax(-1) for lg in logits[:-1]], dim=1)
    seq = torch.cat([tokens, fed], dim=1)
    h = M.forward_hidden(full_model or model, naive, seq, **front)
    start = h.shape[1] - seq.shape[1] + tokens.shape[1] - 1
    full = M.unembed(model, h[:, start:start + len(logits)]).float()
    del h
    plain_prefill, cache = M.prefill(model, naive, tokens, S_MAX, **front)
    del cache
    res = {"positions": int(full.shape[1]),
           "finite": bool(torch.isfinite(cached).all()
                          and torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()),
           "cached_vs_full_rel": rel_err(cached, full),
           "cached_vs_full_prefill_pos_rel": rel_err(cached[:, 0],
                                                     full[:, 0]),
           "control_off_by_one_rel": rel_err(cached[:, 1:], full[:, :-1]),
           "flash_vs_naive_prefill_rel": rel_err(logits[0], plain_prefill),
           "argmax_agree_cached_full": float(
               (cached.argmax(-1) == full.argmax(-1)).float().mean()),
           "tol_rel": LOGIT_TOL_REL}
    emit({label: res})
    if not (res["finite"]
            and res["cached_vs_full_rel"] <= LOGIT_TOL_REL
            and res["flash_vs_naive_prefill_rel"] <= LOGIT_TOL_REL
            and res["control_off_by_one_rel"] > LOGIT_TOL_REL):
        raise RuntimeError(f"{label} failed: {res}")
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


def ssd_training_inputs(cfg, gen, batch: int = TRAIN_BATCH):
    """Inputs at the training shapes (``batch`` x TRAIN_SEQ tokens) with the
    model's ranges: x, B, C unit normals in bf16; dt = softplus(normal / 2
    + dt_bias), dt_bias drawn as the init draws it; A = -Uniform[1, 16], as
    exp(A_log) at init."""
    s = cfg.ssm
    nh, hd, n = s.n_heads(cfg.d_model), s.headdim, s.d_state
    shape = (batch, TRAIN_SEQ)
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


def check_ssd(ssd, cfg, usage=None, batch: int = TRAIN_BATCH) -> dict:
    """The SSD kernel against its plain version (``ssd_chunked``) at the
    training shapes, or at the serving prefill's with ``batch`` 4; no
    single PyTorch call computes the scan, so there is no library
    yardstick. ``usage`` (from :func:`ptxas_usage`) adds each pass's
    registers and shared memory."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    ins = ssd_training_inputs(cfg, gen, batch)
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
    # the scratch the meta trace sizes by the Python twin, against the
    # library's own count (the wrapper checks it at every launch too; an
    # older checkout timed by scripts/time_port_kernels.py has no twin)
    dims = (*x.shape, cfg.ssm.d_state, chunk)
    work = {"library": ssd._library().ssd_scan_workspace_bytes(*dims)}
    if hasattr(ssd, "workspace_bytes"):
        work["twin"] = ssd.workspace_bytes(*dims)
        if work["twin"] != work["library"]:
            raise RuntimeError(f"ssd_scan workspace: {work}")
    case = {"x": list(x.shape), "B": list(ins[3].shape), "chunk": chunk,
            "workspace_bytes": work,
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


def check_train_step(M, adamw, kernel, cfg, run, batch,
                     expect_launches: int, label: str = "train_step_check"
                     ) -> dict:
    """One train step's loss and gradient norm on the kernel path
    (``flash``) against the plain path (``blockwise``: the chunked scan,
    the reference's ``use_kernel=False``, and blockwise attention), same
    weights and batch; ``kernel`` (a wrapper with a ``launches`` count)
    must launch ``expect_launches`` times on the kernel path. Reports the
    kernel path's peak device memory."""
    model = M.build_model(cfg, seed=SEED, device=DEVICE).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel.launches
    t0 = time.perf_counter()
    loss_k, gn_k = loss_and_gnorm(M, adamw, model, run, batch)
    kernel_s = time.perf_counter() - t0
    launches = kernel.launches - before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    loss_p, gn_p = loss_and_gnorm(
        M, adamw, model, dataclasses.replace(run, attn_impl="blockwise"),
        batch)
    plain_s = time.perf_counter() - t0
    res = {"arch": cfg.name, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "gnorm_kernel": gn_k, "gnorm_plain": gn_p,
           "gnorm_rel_diff": abs(gn_k - gn_p) / abs(gn_p),
           "tol_loss_rel": STEP_LOSS_TOL_REL,
           "tol_gnorm_rel": STEP_GNORM_TOL_REL,
           "kernel_path_s": kernel_s, "plain_path_s": plain_s,
           "kernel_path_peak_gb": peak_gb,
           "launches_kernel_path": launches,
           "launches_expected": expect_launches}
    emit({label: res})
    del model
    torch.cuda.empty_cache()
    if not (math.isfinite(loss_k) and math.isfinite(gn_k)
            and res["loss_rel_diff"] <= STEP_LOSS_TOL_REL
            and res["gnorm_rel_diff"] <= STEP_GNORM_TOL_REL
            and launches == expect_launches):
        raise RuntimeError(f"the kernel path's train step disagrees with "
                           f"the plain one: {res}")
    return res


class StepProbe:
    """Instruments ``Trainer.step_fn`` without changing it: a synchronized
    host clock, each kernel wrapper's launches (``kernels``: name ->
    wrapper), the peak device memory and the site and simulated time of
    every step."""

    def __init__(self, tr, kernels: dict):
        self.tr, self.kernels, self.orig = tr, kernels, tr.step_fn
        self.rows: list = []

    def __enter__(self):
        def timed(model, opt, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = {n: k.launches for n, k in self.kernels.items()}
            t0 = time.perf_counter()
            m = self.orig(model, opt, batch)
            torch.cuda.synchronize()
            self.rows.append({
                "wall_s": time.perf_counter() - t0,
                "loss": float(m["loss"]), "aux": float(m["aux"]),
                "grad_norm": float(m["grad_norm"]),
                "launches": {n: k.launches - before[n]
                             for n, k in self.kernels.items()},
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
    with StepProbe(tr, {"ssd": ssd.ssd_scan}) as probe:
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
              "grad_norm": r["grad_norm"],
              "ssd_launches": r["launches"]["ssd"],
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
    if any(r["launches"]["ssd"] != per_step for r in probe.rows) \
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
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        in_bwd = inside(evt)
        for k in evt.kernels:
            n_kernels += 1
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
    busy = busy_ms(prof)
    return {"wall_ms": wall_ms, "device_ms": total, "busy_ms": busy,
            "device_events": n_kernels,
            "busy_share": busy / wall_ms, "idle_share": 1 - busy / wall_ms,
            **split, "top": [[k[:90], v] for k, v in top]}


# --- 11-13: SSM serving, the encoder-decoder and vision-language families ---

def cached_steps(M, model, run, tokens, fed, **front) -> tuple:
    """The model API's serving steps on the card: ``prefill`` (with the
    prompt's ``frames`` or ``patches``), then a ``decode_step`` for each
    token of ``fed`` [B, n]. Returns every step's logits, the prefill's
    seconds and a decode step's milliseconds (synchronized host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(model, run, tokens, S_MAX, **front)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    start = tokens.shape[1] + (front["patches"].shape[1]
                               if "patches" in front else 0)
    out = [logits]
    for i in range(fed.shape[1]):
        logits, cache = M.decode_step(model, run, fed[:, i:i + 1], cache,
                                      start + i)
        out.append(logits)
    torch.cuda.synchronize()
    return out, {"prefill_s": prefill_s,
                 "decode_ms_per_step": (time.perf_counter() - t0 - prefill_s)
                 / fed.shape[1] * 1e3}


def ssm_serving(ssd, fa, sl, M, cfg, run, power_w: float, usage) -> tuple:
    """mamba2-370m served: the SSD kernel against its plain version at the
    serving prefill's shapes, then ``Server`` answering N_REQUESTS
    requests (the SSD kernel in prefill, O(1) recurrent decode), its first
    epoch's cached logits against a plain full forward at chunk
    SSM_FULL_CHUNK. Returns the SSD check and the launches over the
    serving path."""
    case = check_ssd(ssd, cfg, usage, batch=SERVE_BATCH)
    srv, probe, launches = serve(
        fa, sl, cfg, run, power_w,
        kernels={"ssd": (ssd.ssd_scan, cfg.n_layers)})
    full_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk_size=SSM_FULL_CHUNK))
    full = M.Transformer(full_cfg, dict(srv.model.state_dict()))
    ep = probe.epochs[0]
    # every step's argmax, the last too: 2048 + 32 = 65 chunks of 32
    fed = torch.stack([lg.argmax(-1) for lg in ep["logits"]], dim=1)
    logit_gate(M, srv.model, srv.run, ep["tokens"], ep["logits"], fed=fed,
               full_model=full, label="ssm_logit_check")
    emit({"ssm_profile": profile_serving(M, srv, ep["tokens"])})
    del srv, probe, full, ep
    torch.cuda.empty_cache()
    return case, launches["ssd"]


def family_batches(M, cfg) -> tuple:
    """A prefill and a train batch at SERVE_BATCH x PROMPT_LEN positions
    from ``make_batch`` (seamless: 2048 tokens and 512 frames; internvl2:
    256 patches and 1792 tokens), moved to the card."""
    from repro_torch.configs.base import ShapeConfig
    gen = torch.Generator().manual_seed(SEED)
    return tuple({k: v.to(DEVICE) for k, v in M.make_batch(
        cfg, ShapeConfig(kind, PROMPT_LEN, SERVE_BATCH, kind), gen).items()}
        for kind in ("prefill", "train"))


def family_paths(fa, M, adamw, cfg, run, label: str) -> dict:
    """An encoder-decoder or vision-language model through the model API:
    prefill with its frontend (frames or patches) and MAX_NEW - 1 decode
    steps of seeded random tokens (not greedy: a random model's argmax
    can repeat one token, and the off-by-one control then compares alike
    inputs) against a plain full forward, then one train step on the
    kernel path against the plain path. Each path's flash launches are
    counted from 0: one per attention layer (decoder and encoder) a
    forward, and a train step's per-layer checkpoints run every forward
    twice."""
    prefill_batch, train_batch = family_batches(M, cfg)
    tokens = prefill_batch.pop("tokens")
    fed = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, MAX_NEW - 1),
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(DEVICE)
    per_forward = cfg.n_layers + cfg.encoder_layers
    model = M.build_model(cfg, seed=SEED, device=DEVICE)
    fa.flash_attention.launches = 0
    logits, timing = cached_steps(M, model, run, tokens, fed,
                                  **prefill_batch)
    launches = {"prefill_decode": fa.flash_attention.launches}
    emit({f"{label}_prefill_decode": {
        "arch": cfg.name, "tokens": list(tokens.shape),
        **{k: list(v.shape) for k, v in prefill_batch.items()}, **timing,
        "flash_launches": launches["prefill_decode"],
        "params": sum(p.numel() for p in model.parameters())}})
    logit_gate(M, model, run, tokens, logits, fed=fed,
               label=f"{label}_logit_check", **prefill_batch)
    del model, logits
    torch.cuda.empty_cache()
    trun = dataclasses.replace(run, remat="block")
    fa.flash_attention.launches = 0
    check_train_step(M, adamw, fa.flash_attention, cfg, trun, train_batch,
                     2 * per_forward, label=f"{label}_train_step_check")
    launches["train_step"] = fa.flash_attention.launches
    if launches["prefill_decode"] != per_forward:
        raise RuntimeError(f"{label}: flash launches {launches} != "
                           f"{per_forward} a prefill")
    return launches


# --- 14-16: the moe and hybrid families served ------------------------------
#
# The MoE logit gate. Routing makes a plain full forward unlike the cached
# path it checks: an expert's capacity depends on the dispatch's token
# count T and an assignment's rank on its flat position, so the full
# forward over prompt and decoded tokens (T = 4 x 2080) drops other
# assignments than the prefill (4 x 2048) and the decode steps (T = 4,
# capacity 8, no drops); and bf16 noise between the kernel path and the
# plain path can flip a near-tied top-k choice, which moves one token's
# output by O(1). The reference's own cached decode and full forward
# differ in the same way (tests/test_torch_moe_models.py). So the gate
# has a plain MoE of its own (router probabilities of its own, capacity
# from its formula written out again, ranks by a running count in flat
# order, one expert at a time, the dropped assignments weighted 0) and
# uses it twice:
# * every MoE call of the cached path (each layer, prefill and each
#   decode step) again, on that call's own input: the same top-k choices
#   (the router is the same f32 product), the same capacity and kept
#   assignments, exactly, and each token's output within MOE_LAYER_TOL;
# * in the plain full forward and the plain prefill, which route in the
#   cached path's groups (the prompt together, then each decode position
#   alone) and replay the cached path's choices: logits within
#   LOGIT_TOL_REL with the off-by-one control above it, as logit_gate,
#   and every replayed choice within MOE_TIE_TOL router logits of the
#   plain router's own k-th, a sanity check of the replay only (see
#   MOE_TIE_TOL); the exact check of the choices is the first one.
# tests/test_torch_moe_models.py runs it on reduced models: it fails an
# unstable sort, a combine that ignores the drops and a capacity off by 8,
# and passes the plain path against itself with its hidden state rounded
# once to bf16.

# (phase, label, arch, layers kept, requests): depth cut only as far as
# one 80 GB card forces (jamba: two 8-layer periods, 52 GB of bf16
# weights; arctic 2 layers, 55 GB; kimi 1 layer, 39 GB); widths, experts,
# top-k, capacity factor and interleave are the published configs'
MOE_PHASES = (("14", "jamba", "jamba-v0.1-52b", 16, 8),
              ("15", "arctic", "arctic-480b", 2, SERVE_BATCH),
              ("16", "kimi", "kimi-k2-1t-a32b", 1, SERVE_BATCH))
# Router logits at init are ~N(0, 1) (rms-normed input, weights at
# d_model^-1/2). A replayed choice more than this below the plain router's
# own k-th is a replay gone wrong (choices of another token or layer). It
# does not tell a flipped near tie from a wrong expert a few ranks down:
# among kimi's 384 logits neighbouring ranks near the 8th sit ~0.05 apart.
# The cached path's choices are held exactly by the per-call check.
MOE_TIE_TOL = 0.25
# One MoE call, kernel path against the plain MoE on the same input and
# choices: max over tokens of |y - y_plain| over the mean token norm. The
# two round to bf16 at the same steps and differ only by GEMM sum order
# (the capacity buffer's bmm against one expert's rows), a bf16 ulp
# (2^-8 relative) here and there. A dropped assignment combined, a lost
# choice or a wrong expert moves a token by its router weight times an
# expert's output.
MOE_LAYER_TOL = 2e-2


class MoERecorder:
    """Keeps every call of the port's MoE layer (``transformer.moe_ffn``)
    in call order: its weights, input and output, and what its dispatch
    saw and decided (top-k choices [T, k], kept assignments [T*k],
    capacity)."""

    def __init__(self, moe, transformer):
        self.moe, self.T, self.calls = moe, transformer, []

    def __enter__(self):
        self.orig = (self.moe.dispatch_indices, self.T.moe_ffn)
        dispatch, layer = self.orig

        def recorded_dispatch(top_i, n_experts, cap):
            e_flat, slot, keep = dispatch(top_i, n_experts, cap)
            self.calls[-1].update(top_i=top_i, keep=keep, cap=cap)
            return e_flat, slot, keep

        def recorded_layer(p, x, cfg, **kw):
            self.calls.append({"p": p, "x": x, "kw": kw})
            y, aux = layer(p, x, cfg, **kw)
            self.calls[-1]["y"] = y
            return y, aux

        self.moe.dispatch_indices = recorded_dispatch
        self.T.moe_ffn = recorded_layer
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_indices, self.T.moe_ffn = self.orig


def plain_capacity(n_tokens: int, cfg) -> int:
    """ceil(T * k / E * capacity_factor), then up to a multiple of 8, at
    least 8 (the reference's formula, written out again)."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, 8 * math.ceil(c / 8))


def _plain_ffn(x, wg, wu, wd, gated: bool):
    if gated:
        h = torch.nn.functional.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
    else:
        h = torch.nn.functional.gelu(x @ wu.to(x.dtype), approximate="tanh")
    return h @ wd.to(x.dtype)


def _moe_stats() -> dict:
    return {"tokens": 0, "drops": 0, "flips": 0, "tie_gap": 0.0,
            "cap_mismatch": 0, "keep_mismatch": 0}


def plain_moe_group(p, xs, cfg, gated: bool, rec, st: dict,
                    n_ranks: int = 1):
    """The plain MoE over one dispatch group xs [B, n, d]: with ``rec`` (a
    :class:`MoERecorder` call) its top-k choices, else the group's own.
    Adds the group's flips, drops and disagreements with ``rec`` to
    ``st``. With ``n_ranks`` the experts split into that many equal
    ranges (the model ranks of a mesh): each range's f32 combine is cast
    to xs's dtype before the sum over ranges, in order."""
    B, n, d = xs.shape
    T, k, E = B * n, cfg.top_k, cfg.n_experts
    xt = xs.reshape(T, d)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = xt.float() @ p["router"].float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    probs = torch.softmax(logits, dim=-1)
    own = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    top_i = own if rec is None else rec["top_i"]
    if rec is not None:
        st["flips"] += int((own.sort(-1)[0] != top_i.sort(-1)[0])
                           .any(-1).sum())
        kth = logits.gather(1, own[:, -1:])
        st["tie_gap"] = max(st["tie_gap"], float(
            (kth - logits.gather(1, top_i)).clamp_min(0).max()))
    st["tokens"] += T
    top_p = probs.gather(1, top_i)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = plain_capacity(T, cfg)
    e_flat = top_i.reshape(-1)
    onehot = torch.nn.functional.one_hot(e_flat, E)
    rank = (onehot.cumsum(0) * onehot).sum(1) - 1
    keep = rank < cap
    st["drops"] += int((~keep).sum())
    if rec is not None:
        st["cap_mismatch"] += int(rec["cap"] != cap)
        st["keep_mismatch"] += int((keep != rec["keep"]).sum())
    w = top_p.reshape(-1) * keep
    y = torch.zeros((T * k, d), dtype=torch.float32, device=xt.device)
    e_cpu, keep_cpu = e_flat.cpu(), keep.cpu()
    for e in torch.unique(e_cpu[keep_cpu]).tolist():
        sel = torch.nonzero((e_cpu == e) & keep_cpu)[:, 0].to(xt.device)
        out = _plain_ffn(xt[sel // k], p.get("wg", p["wu"])[e], p["wu"][e],
                         p["wd"][e], gated)
        y[sel] = out.float() * w[sel, None]
    y, rank = y.reshape(T, k, d), (e_flat // (E // n_ranks)).reshape(T, k)
    y = sum((y * (rank == r)[..., None]).sum(1).to(xs.dtype)
            for r in range(n_ranks))
    for pre, on in (("shared", cfg.n_shared_experts), ("dense",
                                                        cfg.dense_residual)):
        if on:
            y = y + _plain_ffn(xt, p.get(f"{pre}_wg"), p[f"{pre}_wu"],
                               p[f"{pre}_wd"], gated)
    return y.reshape(B, n, d)


def moe_layer_check(calls, cfg) -> dict:
    """Every recorded MoE call against the plain MoE on its own input and
    choices (see MOE_LAYER_TOL)."""
    st, err = _moe_stats(), 0.0
    for c in calls:
        y = plain_moe_group(c["p"], c["x"], cfg, c["kw"].get("gated", True),
                            c, st).float()
        d = y.shape[-1]
        gap = (c["y"].float() - y).reshape(-1, d).norm(dim=1)
        err = max(err, float(gap.max() / y.reshape(-1, d).norm(dim=1)
                             .mean().clamp_min(1e-30)))
    return {"layer_err": err, **{f"layer_{k}": v for k, v in st.items()}}


class MoEReplay:
    """Stands in for the port's ``moe_ffn`` in the gate's plain passes:
    MoE layer j of a forward over [B, L, d] routes positions [0, P) as
    one group with the cached prefill's choices for layer j, and each
    later position P + i alone with decode step i's (its own choices past
    the recorded steps). ``routes`` are the cached path's MoE calls in
    order (prefill: each MoE layer, then each decode step: each layer)."""

    def __init__(self, routes, n_moe: int, prompt_len: int):
        self.steps = [routes[j::n_moe] for j in range(n_moe)]
        self.n_moe, self.P = n_moe, prompt_len
        self.take_stats()

    def take_stats(self) -> list:
        """Each MoE layer's statistics since the last call; restarts the
        layer count."""
        out = getattr(self, "stats", None)
        self.calls = 0
        self.stats = [_moe_stats() for _ in range(self.n_moe)]
        return out

    def __call__(self, p, x, cfg, *, gated: bool = True):
        j = self.calls % self.n_moe
        self.calls += 1
        recs, L = self.steps[j], x.shape[1]
        groups = [(0, min(L, self.P), recs[0])] + [
            (self.P + i, self.P + i + 1,
             recs[1 + i] if 1 + i < len(recs) else None)
            for i in range(L - self.P)]
        y = torch.cat([plain_moe_group(p, x[:, a:b], cfg, gated, rec,
                                       self.stats[j])
                       for a, b, rec in groups], dim=1)
        return y, torch.zeros((), dtype=torch.float32, device=x.device)


def moe_logit_gate(M, model, run, tokens, fed, *, full_model=None,
                   label: str = "moe_logit_check") -> dict:
    """The MoE variant of :func:`logit_gate` (see above MOE_PHASES): the
    cached path (``prefill``, then a ``decode_step`` for each token of
    ``fed`` [B, n]) with its MoE calls recorded; each call against the
    plain MoE on its own input; then a plain full forward over prompt and
    ``fed`` and a plain prefill that replay the recorded choices (naive
    attention, the chunked scan, :class:`MoEReplay`); the control
    compares each cached step with the full forward's next position.
    ``full_model`` (the same weights) runs the full forward."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = model.cfg.moe
    n_moe = sum(1 for layer in model.decoder.layers
                if layer.spec.is_moe and layer.spec.has_ffn)
    with MoERecorder(moe, T) as rec:
        logits, timing = cached_steps(M, model, run, tokens, fed)
    calls = rec.calls
    if len(calls) != n_moe * len(logits) or any("top_i" not in c
                                                for c in calls):
        raise RuntimeError(f"{label}: {len(calls)} MoE calls, not "
                           f"{n_moe} MoE layers x {len(logits)} steps")
    layer = moe_layer_check(calls, cfg)
    naive = dataclasses.replace(run, attn_impl="naive")
    P = tokens.shape[1]
    replay = MoEReplay(calls, n_moe, P)
    real = T.moe_ffn
    T.moe_ffn = replay
    try:
        h = M.forward_hidden(full_model or model, naive,
                             torch.cat([tokens, fed], dim=1))
        full = M.unembed(model, h[:, P - 1:P - 1 + len(logits)]).float()
        del h
        full_stats = replay.take_stats()
        plain_prefill, cache = M.prefill(model, naive, tokens, S_MAX)
        del cache
        prefill_stats = replay.take_stats()
    finally:
        T.moe_ffn = real
    cached = torch.stack(logits, dim=1)
    by_layer = [calls[j::n_moe] for j in range(n_moe)]
    both = prefill_stats + full_stats
    res = {"positions": int(full.shape[1]), **timing,
           "finite": bool(torch.isfinite(cached).all()
                          and torch.isfinite(full).all()),
           "max_abs_logit": float(full.abs().max()),
           "cached_vs_full_rel": rel_err(cached, full),
           "cached_vs_full_prefill_pos_rel": rel_err(cached[:, 0],
                                                     full[:, 0]),
           "control_off_by_one_rel": rel_err(cached[:, 1:], full[:, :-1]),
           "flash_vs_naive_prefill_rel": rel_err(logits[0], plain_prefill),
           "argmax_agree_cached_full": float(
               (cached.argmax(-1) == full.argmax(-1)).float().mean()),
           "tol_rel": LOGIT_TOL_REL, **layer, "layer_tol": MOE_LAYER_TOL,
           "prefill_assignments": int(by_layer[0][0]["keep"].numel()),
           "prefill_capacity": by_layer[0][0]["cap"],
           "prefill_drops_by_layer": [int((~c[0]["keep"]).sum())
                                      for c in by_layer],
           "decode_drops": sum(int((~s["keep"]).sum())
                               for c in by_layer for s in c[1:]),
           "prefill_flips_by_layer": [s["flips"] for s in prefill_stats],
           "full_flips_by_layer": [s["flips"] for s in full_stats],
           "tie_gap_max": max(s["tie_gap"] for s in both),
           "tie_tol": MOE_TIE_TOL,
           "cap_mismatch": sum(s["cap_mismatch"] for s in both),
           "keep_mismatch": sum(s["keep_mismatch"] for s in both)}
    emit({label: res})
    del calls, rec
    if not (res["finite"]
            and res["cached_vs_full_rel"] <= LOGIT_TOL_REL
            and res["flash_vs_naive_prefill_rel"] <= LOGIT_TOL_REL
            and res["control_off_by_one_rel"] > LOGIT_TOL_REL
            and res["layer_err"] <= MOE_LAYER_TOL
            and res["layer_flips"] == 0
            and res["layer_cap_mismatch"] == res["cap_mismatch"] == 0
            and res["layer_keep_mismatch"] == res["keep_mismatch"] == 0
            and res["tie_gap_max"] <= MOE_TIE_TOL):
        raise RuntimeError(f"{label} failed: {res}")
    return res


def moe_serving(fa, ssd, sl, M, cfg, run, power_w: float, label: str,
                n_requests: int) -> dict:
    """A moe or hybrid model served: ``Server`` answers ``n_requests``
    requests (flash in every attention layer's prefill, the SSD kernel in
    every Mamba-2 layer's), a profile of one prefill and three decode
    steps, then :func:`moe_logit_gate` on the first epoch's prompts and
    MAX_NEW - 1 seeded random tokens (a hybrid: MAX_NEW, so that its full
    forward, 2080 = 65 x SSM_FULL_CHUNK positions, scans whole chunks),
    and for MOE_MESH_SERVE models :func:`moe_mesh_serving` on the same
    prompts. Returns each kernel's launches over the serving path, and
    over the meshed runs (None without them)."""
    from repro_torch.models.kvcache import layer_specs
    specs = layer_specs(cfg)
    n_attn = sum(s.mixer == "attn" for s in specs)
    kernels = {"flash": (fa.flash_attention, n_attn)}
    if n_attn < len(specs):
        kernels["ssd"] = (ssd.ssd_scan, len(specs) - n_attn)
    srv, probe, launches = serve(fa, sl, cfg, run, power_w, kernels=kernels,
                                 n_requests=n_requests)
    tokens = probe.epochs[0]["tokens"]
    emit({f"{label}_profile": profile_serving(M, srv, tokens)})
    hybrid = cfg.ssm is not None
    fed = torch.randint(0, cfg.vocab_size,
                        (SERVE_BATCH, MAX_NEW - (0 if hybrid else 1)),
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(DEVICE)
    full = None
    if hybrid:
        full = M.Transformer(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=SSM_FULL_CHUNK)), dict(srv.model.state_dict()))
    moe_logit_gate(M, srv.model, srv.run, tokens, fed, full_model=full,
                   label=f"{label}_logit_check")
    mesh_launches = None
    if label in MOE_MESH_SERVE:
        mesh_launches = moe_mesh_serving(M, srv.model, srv.run, tokens, fed,
                                         kernels, label)
    del srv, probe, full
    torch.cuda.empty_cache()
    return launches, mesh_launches


def moe_phases(fa, ssd, sl, M, built, power_w: float, clock, flash_cases,
               flash_paths, ssd_cases, ssd_paths) -> None:
    """Phases 14-16 (MOE_PHASES): for each model the flash kernel (and
    jamba's SSD kernel) against its plain version at the model's prefill
    shapes (causal, 4 x PROMPT_LEN), then :func:`moe_serving`. Adds to
    the kernel cases and the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    flash_usage = ptxas_usage(built[fa._SOURCE.name][1], FLASH_KERNEL)
    ssd_usage = ptxas_usage(built[ssd._SOURCE.name][1], SSD_KERNEL_PREFIX)
    for num, label, arch, layers, n_req in MOE_PHASES:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        name = f"{label}_gqa{cfg.n_heads}to{cfg.n_kv_heads}_d{cfg.head_dim}"
        flash_cases += check_flash(fa, cfg, flash_usage,
                                   ((name, PROMPT_LEN, None, True),))
        if cfg.ssm is not None:
            ssd_cases[f"serving_{label}_d{cfg.ssm.d_state}"] = check_ssd(
                ssd, cfg, ssd_usage, batch=SERVE_BATCH)
        launches, mesh = moe_serving(
            fa, ssd, sl, M, cfg,
            RunConfig(arch=arch, attn_impl="flash", remat="none", seed=SEED),
            power_w, label, n_req)
        for name, got in (("", launches), (" under the mesh", mesh or {})):
            if "flash" in got:
                flash_paths[f"{num} serve {label}{name}"] = got["flash"]
            if "ssd" in got:
                ssd_paths[f"{num} serve {label}{name}"] = got["ssd"]
        clock.mark(f"{num} {label}")


# --- 17-19: the moe and hybrid families trained -----------------------------
#
# (phase, label, arch, layers kept, experts kept, batch): widths, heads,
# the experts' width, top-k, capacity factor, shared experts and dense
# residual are the published configs'; depth and expert count are cut so
# that weights, gradients and AdamW state (16 bytes a parameter) fit one
# 80 GB card with a batch. jamba: one whole 8-layer period (the depth
# cannot go below one: block_period lcm(8, 2)), so attention + MoE, Mamba
# + MoE and Mamba + dense layers at 1:7, with 3 of 16 experts top-2 (4.11
# B parameters; 2 would leave top-2 no choice, 4 leave no room for a
# batch); arctic one layer, 8 of 128 experts top-2 and the dense residual
# (1.52 B); kimi-k2 one layer, 16 of 384 experts top-8 and the shared
# expert (3.21 B). The batch: the largest of 8, 4, 2, 1 x TRAIN_SEQ tokens
# whose step fits the card (scripts/train_fit.py).
MOE_TRAIN_PHASES = (("17", "jamba", "jamba-v0.1-52b", 8, 3, 2),
                    ("18", "arctic", "arctic-480b", 1, 8, 8),
                    ("19", "kimi", "kimi-k2-1t-a32b", 1, 16, 4))
MOE_TRAIN_STEPS = 3
MOE_TRAIN_CKPT_DIR = REPO / "build" / "chip_smoke_moe_ckpt"
# One train step, kernel path against plain path, with the plain path
# routing as the kernel path chose (RouteReplay): without the replay a
# near-tied top-k choice flipped by bf16 noise moves one token's output
# by O(1) and the aux by ~1e-4 a flipped top-1 (on the card, 0-28 tokens
# a layer at these batches, scripts/train_fit.py). With it the paths differ by bf16 rounding, as
# mamba2's (STEP_LOSS_TOL_REL, STEP_GNORM_TOL_REL), and the aux by the
# f32 router's sum order. Leaving the aux out of the loss moves the loss
# by aux_loss_weight * aux (~1e-3 relative), a router gradient zeroed
# moves the router's gradient norm by all of it
# (tests/test_torch_moe_train.py).
STEP_AUX_TOL_REL = 1e-4


def switch_aux(probs, top_i):
    """The Switch load-balancing aux E * sum(me * ce) of one token group,
    written out again: the mean router probability and the top-1 share of
    each expert."""
    T, E = probs.shape
    ce = torch.bincount(top_i[:, 0], minlength=E).float() / T
    return E * torch.sum(probs.mean(0) * ce)


class RouteReplay:
    """The port's router (``moe.route``, which ``moe_ffn`` looks up at
    call time) recorded on the kernel path and replayed on the plain path.

    :meth:`record`: every call's choices in call order (a train step
    routes each MoE layer twice: its forward, and the recompute of
    ``remat``), and how many recomputes chose otherwise than the forward
    (layers told apart by their router weight). :meth:`replay`: stands in
    for the router with its own plain version: true f32 router logits and
    probabilities, the recorded choices in call order, renormalised, and
    the Switch aux E * sum(me * ce) written out again; ``aux`` sums the
    forward calls' aux, ``flips`` counts tokens whose own top-k differs
    from the recorded one."""

    def __init__(self, moe):
        self.moe, self.real = moe, moe.route
        self.choices: list = []
        self.remat_mismatch = 0
        self.aux, self.flips, self.left = None, 0, 0

    @contextlib.contextmanager
    def record(self):
        first: dict = {}

        def recorded(w, x, cfg):
            top_p, top_i, aux = self.real(w, x, cfg)
            if id(w) in first:
                self.remat_mismatch += int(not torch.equal(first[id(w)],
                                                           top_i))
            else:
                first[id(w)] = top_i
            self.choices.append(top_i)
            return top_p, top_i, aux

        self.moe.route = recorded
        try:
            yield self
        finally:
            self.moe.route = self.real

    @contextlib.contextmanager
    def replay(self):
        calls, seen = iter(self.choices), set()

        def replayed(w, x, cfg):
            top_i = next(calls)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                logits = x.float() @ w.float()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            probs = torch.softmax(logits, dim=-1)
            top_p = probs.gather(1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
            aux = switch_aux(probs, top_i)
            if id(w) not in seen:      # the forward; a recompute repeats it
                seen.add(id(w))
                with torch.no_grad():      # saves nothing for the backward
                    own = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)[1][:, :cfg.top_k]
                    self.flips += int((own.sort(-1)[0]
                                       != top_i.sort(-1)[0]).any(-1).sum())
                self.aux = aux.detach() if self.aux is None \
                    else self.aux + aux.detach()
            return top_p, top_i, aux

        self.moe.route = replayed
        try:
            yield self
        finally:
            self.moe.route = self.real
            self.left = sum(1 for _ in calls)


def moe_step_terms(M, adamw, model, run, batch) -> dict:
    """One batch's loss, nll and aux, and the global norm of its gradient
    and of the routers' gradient (no update)."""
    names, params = zip(*model.named_parameters())
    loss, mm = M.loss_fn(model, run, batch)
    grads = torch.autograd.grad(loss, list(params))
    router = [g for n, g in zip(names, grads) if n.endswith(".router")]
    out = {"loss": float(loss.detach()), "nll": float(mm["nll"]),
           "aux": float(mm["aux"]), "gnorm": float(adamw.global_norm(grads)),
           "router_gnorm": float(adamw.global_norm(router)),
           "routers": len(router)}
    del grads, router
    torch.cuda.synchronize()
    return out


def check_moe_train_step(M, adamw, moe, cfg, run, batch, kernels: dict,
                         label: str) -> dict:
    """One train step of a moe or hybrid model on the kernel path (flash,
    the SSD kernel) against the plain path (blockwise attention, the
    chunked scan) on the same weights and batch, the plain path routing
    with the kernel path's choices and its own plain router
    (:class:`RouteReplay`): loss and aux within STEP_LOSS_TOL_REL and
    STEP_AUX_TOL_REL, the gradient's global norm and the routers' within
    STEP_GNORM_TOL_REL; the plain loss is its nll plus aux_loss_weight
    times the replay's own aux; every recompute routes as its forward;
    ``kernels`` (name -> (wrapper, launches)) launch as expected on the
    kernel path. Reports the kernel path's peak device memory."""
    model = M.build_model(cfg, seed=SEED, device=DEVICE).requires_grad_(True)
    n_moe = sum(1 for layer in model.decoder.layers
                if layer.spec.is_moe and layer.spec.has_ffn)
    replay = RouteReplay(moe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: w.launches for n, (w, _) in kernels.items()}
    t0 = time.perf_counter()
    with replay.record():
        k = moe_step_terms(M, adamw, model, run, batch)
    kernel_s = time.perf_counter() - t0
    launches = {n: w.launches - before[n] for n, (w, _) in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    with replay.replay():
        p = moe_step_terms(M, adamw, model,
                           dataclasses.replace(run, attn_impl="blockwise"),
                           batch)
    plain_s = time.perf_counter() - t0
    aux_own = float(replay.aux)
    weight = cfg.moe.aux_loss_weight
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.moe.n_experts, "tokens": list(batch["tokens"]
                                                       .shape),
           **{f"{key}_kernel": v for key, v in k.items()},
           **{f"{key}_plain": v for key, v in p.items()},
           "aux_plain_own": aux_own,
           "loss_rel_diff": _rel(k["loss"], p["loss"]),
           "gnorm_rel_diff": _rel(k["gnorm"], p["gnorm"]),
           "router_gnorm_rel_diff": _rel(k["router_gnorm"],
                                         p["router_gnorm"]),
           "aux_rel_diff": _rel(k["aux"], aux_own),
           "plain_loss_vs_nll_plus_aux": _rel(p["loss"],
                                              p["nll"] + weight * aux_own),
           "tol_loss_rel": STEP_LOSS_TOL_REL,
           "tol_gnorm_rel": STEP_GNORM_TOL_REL,
           "tol_aux_rel": STEP_AUX_TOL_REL,
           "moe_layers": n_moe, "route_calls": len(replay.choices),
           "replay_calls_left": replay.left,
           "remat_choice_mismatch": replay.remat_mismatch,
           "plain_router_flips": replay.flips,
           "kernel_path_s": kernel_s, "plain_path_s": plain_s,
           "kernel_path_peak_gb": peak_gb, "launches_kernel_path": launches,
           "launches_expected": {n: e for n, (_, e) in kernels.items()}}
    emit({label: res})
    del model, replay
    torch.cuda.empty_cache()
    if not (all(math.isfinite(res[f"{key}_kernel"])
                for key in ("loss", "gnorm", "aux"))
            and res["loss_rel_diff"] <= STEP_LOSS_TOL_REL
            and res["gnorm_rel_diff"] <= STEP_GNORM_TOL_REL
            and res["router_gnorm_rel_diff"] <= STEP_GNORM_TOL_REL
            and res["aux_rel_diff"] <= STEP_AUX_TOL_REL
            and res["plain_loss_vs_nll_plus_aux"] <= STEP_LOSS_TOL_REL
            and res["routers_kernel"] == n_moe > 0
            and res["route_calls"] == 2 * n_moe
            and res["replay_calls_left"] == 0
            and res["remat_choice_mismatch"] == 0
            and launches == res["launches_expected"]):
        raise RuntimeError(f"the kernel path's train step disagrees with "
                           f"the plain one: {res}")
    return res


def refuse_full_training(arch: str) -> dict:
    """``launch.train --arch <arch> --full`` on the card: refused before
    anything is allocated, naming the bytes of weights, gradients and
    AdamW state."""
    from repro_torch.launch import train as train_launch
    try:
        train_launch.main(["--arch", arch, "--full", "--steps", "1"])
    except MemoryError as err:
        return {"arch": arch, "refused": str(err)}
    raise RuntimeError(f"launch.train --full trained {arch}")


def moe_train(tl, ops, cfg, run, batch: int, power_w: float, label: str,
              kernels: dict) -> dict:
    """``Trainer`` runs MOE_TRAIN_STEPS steps of ``batch`` x TRAIN_SEQ
    tokens (no checkpoint: the interval is past the last step), each
    step's wall, tokens/s, loss, peak memory, launches of ``kernels``
    (name -> (wrapper, launches a step)) and gCO2 (wall x power limit x
    the site's intensity) printed, then a profile of one more step.
    Returns each kernel's launches over the three steps."""
    from repro_torch.core.carbon.intensity import calibrated_ci
    shutil.rmtree(MOE_TRAIN_CKPT_DIR, ignore_errors=True)
    loop = tl.TrainLoopConfig(total_steps=MOE_TRAIN_STEPS,
                              ckpt_every=MOE_TRAIN_STEPS + 1,
                              ckpt_dir=str(MOE_TRAIN_CKPT_DIR), log_every=1,
                              chip_power_w=power_w)
    try:
        t0 = time.perf_counter()
        tr = tl.Trainer(cfg, run, loop, batch_override=batch,
                        seq_override=TRAIN_SEQ, device=DEVICE)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tr.params.values())
        emit({f"{label}_train_setup": {
            "arch": cfg.name, "layers": len(tr.model.decoder.layers),
            "d_model": cfg.d_model, "experts": cfg.moe.n_experts,
            "top_k": cfg.moe.top_k, "params": n_params,
            "param_counts": cfg.param_counts(), "batch": batch,
            "seq": TRAIN_SEQ, "remat": run.remat,
            "init_s": time.perf_counter() - t0,
            "alloc_gb": torch.cuda.memory_allocated() / 1e9,
            "site": tr.site, "chip_power_w": power_w}})
        wrappers = {n: w for n, (w, _) in kernels.items()}
        for w in wrappers.values():
            w.launches = 0
        with StepProbe(tr, wrappers) as probe:
            out = tr.run_steps()
        launches = {n: w.launches for n, w in wrappers.items()}
        tokens = batch * TRAIN_SEQ
        for i, r in enumerate(probe.rows):
            ci = calibrated_ci(tr.cluster.zone_of(r["site"]), r["t"])
            emit({f"{label}_train_step": i + 1, "wall_s": r["wall_s"],
                  "tokens_per_s": tokens / r["wall_s"], "loss": r["loss"],
                  "aux": r["aux"], "grad_norm": r["grad_norm"],
                  "launches": r["launches"], "peak_gb": r["peak_gb"],
                  "site": r["site"], "ci_g_per_kwh": ci,
                  "g_co2": r["wall_s"] * power_w / 3.6e6 * ci})
        prof = profile_training(ops, tr)
        emit({f"{label}_train_profile": prof})
        emit({f"{label}_train_main_path": {
            "steps": len(probe.rows), "final_step": out["final_step"],
            "launches": launches, "final_loss": out["final_loss"],
            "mean_step_s": statistics.mean(r["wall_s"] for r in probe.rows),
            "device_events_a_step": prof["device_events"]}})
        if len(probe.rows) != MOE_TRAIN_STEPS \
                or out["final_step"] != MOE_TRAIN_STEPS \
                or not all(math.isfinite(r["loss"]) for r in probe.rows):
            raise RuntimeError(f"{label}: the trainer ran {len(probe.rows)} "
                               f"steps, or a loss is not finite")
        want = {n: e for n, (_, e) in kernels.items()}
        if any(r["launches"] != want for r in probe.rows):
            raise RuntimeError(f"{label}: launches a step "
                               f"{[r['launches'] for r in probe.rows]} != "
                               f"{want}")
        del tr, probe
        return launches
    finally:
        torch.cuda.empty_cache()
        shutil.rmtree(MOE_TRAIN_CKPT_DIR, ignore_errors=True)


def moe_training(fa, ssd, ops, tl, M, adamw, built, power_w: float, clock,
                 flash_cases, flash_paths, ssd_cases, ssd_paths) -> None:
    """Phases 17-19 (MOE_TRAIN_PHASES): for each cut model the refusal of
    its full size by ``launch.train``, the flash kernel (and jamba's SSD
    kernel) against its plain version at the training batch's shapes,
    :func:`check_moe_train_step`, then :func:`moe_train`. Adds to the
    kernel cases and the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import moe
    from repro_torch.models.kvcache import layer_specs
    flash_usage = ptxas_usage(built[fa._SOURCE.name][1], FLASH_KERNEL)
    ssd_usage = ptxas_usage(built[ssd._SOURCE.name][1], SSD_KERNEL_PREFIX)
    for num, label, arch, layers, experts, batch in MOE_TRAIN_PHASES:
        emit({f"{label}_full_training": refuse_full_training(arch)})
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers, moe=dataclasses
                                  .replace(full.moe, n_experts=experts))
        specs = layer_specs(cfg)
        n_attn = sum(sp.mixer == "attn" for sp in specs)
        # remat="block" runs every forward twice: the step and the
        # backward's recompute
        kernels = {"flash": (fa.flash_attention, 2 * n_attn)}
        if n_attn < len(specs):
            kernels["ssd"] = (ssd.ssd_scan, 2 * (len(specs) - n_attn))
        name = (f"{label}_train_b{batch}_gqa{cfg.n_heads}to{cfg.n_kv_heads}"
                f"_d{cfg.head_dim}")
        flash_cases += check_flash(fa, cfg, flash_usage,
                                   ((name, TRAIN_SEQ, None, True),), batch)
        if cfg.ssm is not None:
            ssd_cases[f"training_{label}_b{batch}_d{cfg.ssm.d_state}"] = \
                check_ssd(ssd, cfg, ssd_usage, batch=batch)
        run = RunConfig(arch=arch, attn_impl="flash", remat="block",
                        seed=SEED, warmup_steps=2, total_steps=MOE_TRAIN_STEPS)
        tokens = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               batch=batch, seed=SEED,
                               device=DEVICE).next_batch()
        check_moe_train_step(M, adamw, moe, cfg, run, tokens, kernels,
                             f"{label}_train_step_check")
        if label == MOE_MESH_TRAIN:
            mesh = moe_mesh_train_step(M, adamw, cfg, run, tokens, kernels,
                                       label)
            flash_paths[f"{num} train {label} under the mesh"] = \
                mesh["flash"]
        del tokens
        launches = moe_train(tl, ops, cfg, run, batch, power_w, label,
                             kernels)
        flash_paths[f"{num} train {label}"] = launches["flash"]
        if "ssd" in launches:
            ssd_paths[f"{num} train {label}"] = launches["ssd"]
        clock.mark(f"{num} train {label}")


# --- 4c, 14, 16, 19: the mesh ------------------------------------------------
#
# One card, so nothing here buys speed. A device list that repeats the card
# shows what the split paths compute: the planner's cell split is its
# unsplit lattice, and the expert-parallel MoE (models/moe.py
# ``expert_parallel``) is the single-device MoE of each token shard at that
# shard's own capacity, each rank's combine cast to the model dtype before
# the sum over ranks.
SPLIT_DEVICES = 3              # does not divide the 64-cell bucket
# Split tables against unsplit ones: stage 3 gathers each cell's rows
# alone, so equal bits are expected; 1e-9 is the sweep's own bound.
SPLIT_TOL_REL = 1e-9
MOE_MESH_SERVE = ("jamba", "kimi")
MOE_MESH_TRAIN = "kimi"


def cell_split(tp, gt, ftns, job) -> dict:
    """Phase 4c: window 0 of ``planner_scale`` (WINDOW jobs) planned with
    ``plan_batch_torch`` on ``batch_backend="torch"`` three ways, each
    run's tables recorded: unsplit; with the lattice's cell axis split over
    SPLIT_DEVICES copies of the card (``gt.cell_emissions_on``); and with
    ``shard=MeshConfig(platform="cuda", n_devices=2)``, which on one card
    resolves to one device. Each run timed (host clock) and profiled
    once (device events and ms). Gates: split tables within SPLIT_TOL_REL
    of unsplit (bit-equal cells counted) and the same plans, 32 sampled
    plans as the numpy oracle's (cells equal, emissions 1e-4), and the
    MeshConfig run on one device with the unsplit run's launches by call
    name (``device_events``) and tables bit for bit."""
    planner = tp.TorchCarbonPlanner(ftns, device=DEVICE,
                                    batch_backend="torch")
    jobs = [job(i) for i in range(WINDOW)]
    card = torch.empty(0, device=DEVICE).device
    mesh_cfg = gt.MeshConfig(platform="cuda", n_devices=2)
    real = tp.batch_cell_emissions
    tables, plans, timing = {}, {}, {}

    def split(field, cells, **kw):
        kw.pop("shard")
        return gt.cell_emissions_on(field, cells, [card] * SPLIT_DEVICES,
                                    **kw)

    runs = {"unsplit": (real, {}), "split": (split, {}),
            "mesh_config": (real, {"shard": mesh_cfg})}
    try:
        for name, (score, kw) in runs.items():
            def recorded(field, cells, _n=name, _f=score, **k):
                tables[_n] = _f(field, cells, **k)
                return tables[_n]
            tp.batch_cell_emissions = recorded
            _sync()
            t0 = time.perf_counter()
            plans[name] = planner.plan_batch_torch(jobs, **kw)
            _sync()
            wall = time.perf_counter() - t0
            timing[name] = {"wall_s": wall, **device_events(
                lambda: planner.plan_batch_torch(jobs, **kw))}
    finally:
        tp.batch_cell_emissions = real
    base = tables["unsplit"]

    def against_unsplit(got) -> dict:
        rel, equal = 0.0, 0
        for g, w in zip(got, base):
            equal += int(np.array_equal(g, w))
            rel = max(rel, float(np.max(np.abs(g - w))
                                 / max(np.max(np.abs(w)), 1e-300)))
        return {"cells": len(got), "bit_equal_cells": equal,
                "max_rel_err": rel}

    idxs = sorted({int(i) for i in np.linspace(0, WINDOW - 1,
                                               N_SAMPLED).round()})
    oracle = tp.TorchCarbonPlanner(ftns, device=DEVICE,
                                   batch_backend="numpy").plan_batch(
        [jobs[i] for i in idxs])
    res = {"jobs": WINDOW, "cells": planner.last_batch_cells,
           "split_devices": [str(card)] * SPLIT_DEVICES,
           "split_tables": against_unsplit(tables["split"]),
           "split_vs_unsplit_plans": plan_diffs(plans["split"],
                                                plans["unsplit"]),
           "split_vs_numpy_sampled": plan_diffs(
               [plans["split"][i] for i in idxs], oracle),
           "mesh_config": dataclasses.asdict(mesh_cfg),
           "mesh_config_devices": [str(d) for d in mesh_cfg.devices()],
           "mesh_config_tables": against_unsplit(tables["mesh_config"]),
           "mesh_config_vs_unsplit_plans": plan_diffs(
               plans["mesh_config"], plans["unsplit"]),
           "timing": timing, "tol_rel": SPLIT_TOL_REL}
    emit({"cell_split": res})
    n = len(base)
    if not (res["split_tables"]["cells"] == n > 0
            and res["split_tables"]["max_rel_err"] <= SPLIT_TOL_REL
            and res["split_vs_unsplit_plans"]["cell_mismatches"] == 0
            and res["split_vs_unsplit_plans"]["max_emis_rel_err"]
            <= SPLIT_TOL_REL
            and res["split_vs_numpy_sampled"]["cell_mismatches"] == 0
            and res["split_vs_numpy_sampled"]["max_emis_rel_err"] <= 1e-4
            and len(res["mesh_config_devices"])
            == torch.cuda.device_count() == 1
            and res["mesh_config_tables"]["bit_equal_cells"] == n
            and res["mesh_config_vs_unsplit_plans"]["cell_mismatches"] == 0
            and timing["mesh_config"].get("launches")
            == timing["unsplit"].get("launches")):
        raise RuntimeError(f"the cell split disagrees: {res}")
    return res


class EPRecorder:
    """Keeps every call of the port's MoE layer (``transformer.moe_ffn``)
    in call order: its weights, input, output and aux, each token shard's
    dispatch (top-k choices, kept assignments, capacity; one a shard) and
    each model rank's f32 combine (one a shard and rank, shard-major)."""

    def __init__(self, moe, transformer):
        self.moe, self.T, self.calls = moe, transformer, []

    def __enter__(self):
        self.orig = (self.moe.dispatch_indices, self.moe.combine,
                     self.T.moe_ffn)
        dispatch, combine, layer = self.orig

        def recorded_dispatch(top_i, n_experts, cap):
            e_flat, slot, keep = dispatch(top_i, n_experts, cap)
            self.calls[-1]["shards"].append({"top_i": top_i, "keep": keep,
                                             "cap": cap})
            return e_flat, slot, keep

        def recorded_combine(*a):
            out = combine(*a)
            self.calls[-1]["partials"].append(out.detach())
            return out

        def recorded_layer(p, x, cfg, **kw):
            self.calls.append({"p": p, "x": x, "kw": kw, "shards": [],
                               "partials": []})
            y, aux = layer(p, x, cfg, **kw)
            self.calls[-1].update(y=y.detach(), aux=aux.detach())
            return y, aux

        self.moe.dispatch_indices = recorded_dispatch
        self.moe.combine = recorded_combine
        self.T.moe_ffn = recorded_layer
        return self

    def __exit__(self, *exc):
        (self.moe.dispatch_indices, self.moe.combine,
         self.T.moe_ffn) = self.orig


def plain_aux(p, xs, cfg, top_i):
    """:func:`switch_aux` of one token group xs [T, d] under the choices
    top_i, with its own true-f32 router."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = xs.float() @ p["router"].float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return switch_aux(torch.softmax(logits, dim=-1), top_i)


def moe_ep_check(calls, cfg, moe) -> dict:
    """Every recorded expert-parallel MoE call (see :class:`EPRecorder`)
    against the single-device MoE of each of its token shards: the plain
    MoE (:func:`plain_moe_group`) on the shard's tokens with its own
    capacity (choices, capacities and kept assignments counted where they
    differ) and its model ranks' combines cast before their sum, the
    shards' outputs joined in shard order (within MOE_LAYER_TOL, as
    :func:`moe_layer_check`) and the mean of their aux (within
    STEP_AUX_TOL_REL); and the output against the sum over ranks, in rank
    order, of each rank's recorded combine cast to the model dtype, plus
    the shared experts and the dense residual (equal bits expected: the
    same operations on the same tensors). ``single_cast_err``: the output
    against the plain MoE that casts once, the single-device layer's order
    of rounding, also within MOE_LAYER_TOL (in bf16 the ranks' roundings
    move a token by a few ulps of its partials)."""
    st, err, aux_err, rank_sum = _moe_stats(), 0.0, 0.0, 0
    single_err, layout = 0.0, set()
    for c in calls:
        x, y, gated = c["x"], c["y"], c["kw"].get("gated", True)
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        n_b = len(c["shards"])
        t_loc, n_r = xt.shape[0] // n_b, len(c["partials"]) // n_b
        layout.add((n_b, n_r))
        plain, single, auxes, summed = [], [], [], []
        for b, rec in enumerate(c["shards"]):
            xs = xt[b * t_loc:(b + 1) * t_loc]
            plain.append(plain_moe_group(c["p"], xs[None], cfg, gated, rec,
                                         st, n_r)[0].float())
            single.append(plain_moe_group(c["p"], xs[None], cfg, gated, rec,
                                          _moe_stats())[0].float())
            auxes.append(plain_aux(c["p"], xs, cfg, rec["top_i"]))
            acc = None
            for part in c["partials"][b * n_r:(b + 1) * n_r]:
                part = part.to(x.dtype)
                acc = part if acc is None else acc + part.to(acc.device)
            summed.append(acc.to(x.device))
        for name, want in (("ranks", torch.cat(plain)),
                           ("single", torch.cat(single))):
            gap = (y.reshape(-1, d).float() - want).norm(dim=1)
            e = float(gap.max() / want.norm(dim=1).mean().clamp_min(1e-30))
            if name == "ranks":
                err = max(err, e)
            else:
                single_err = max(single_err, e)
        aux_err = max(aux_err, _rel(float(c["aux"]),
                                    float(torch.stack(auxes).mean())))
        y_sum = torch.cat(summed)
        for pre, on in (("shared", cfg.n_shared_experts),
                        ("dense", cfg.dense_residual)):
            if on:
                y_sum = y_sum + moe._branch(c["p"], pre, xt, gated)
        rank_sum += int((y_sum.reshape(y.shape) != y).sum())
    return {"calls": len(calls), "shards_x_ranks": sorted(layout),
            "ep_err": err, "ep_tol": MOE_LAYER_TOL,
            "single_cast_err": single_err, "aux_rel_err": aux_err,
            "aux_tol": STEP_AUX_TOL_REL, "rank_sum_mismatch": rank_sum,
            **{f"ep_{k}": v for k, v in st.items()}}


def moe_ep_ok(res: dict) -> bool:
    return (res["calls"] > 0
            and res["ep_err"] <= MOE_LAYER_TOL
            and res["single_cast_err"] <= MOE_LAYER_TOL
            and res["aux_rel_err"] <= STEP_AUX_TOL_REL
            and res["rank_sum_mismatch"] == 0
            and res["ep_flips"] == res["ep_cap_mismatch"]
            == res["ep_keep_mismatch"] == 0)


class CallCount:
    """Counts the calls of a module-level function that its callers look
    up when they run: the expert-parallel branch (``moe.expert_parallel``,
    looked up by ``moe_ffn``) or sequence-parallel attention
    (``layers.seq_parallel_attention``, by the attention sub-layer)."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.n = mod, name, 0

    def __enter__(self):
        self.real = getattr(self.mod, self.name)

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        setattr(self.mod, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def host_mesh(shape: tuple):
    """A (data, model) HostMesh of ``shape`` that repeats the card."""
    from repro_torch.runtime import pspec as PS
    card = torch.empty(0, device=DEVICE).device
    return PS.HostMesh(np.full(shape, card, dtype=object), ("data", "model"))


def moe_mesh_serving(M, model, run, tokens, fed, kernels: dict,
                     label: str) -> dict:
    """Phases 14 and 16 under a mesh, on the model just served: the model
    API's cached steps (prefill, then a decode step for each token of
    ``fed``) unmeshed, under a 2 x 2 mesh of the card with the ``"2d"``
    rules (every MoE call recorded and held by :func:`moe_ep_check`), and
    under a 1 x 2 mesh (one token shard, so the unmeshed capacities),
    whose cached logits must sit within LOGIT_TOL_REL of the unmeshed
    ones. The 1 x 2 run routes with the unmeshed run's choices
    (:class:`RouteReplay`, its own router's flips counted): the ranks'
    bf16 sum moves a layer's output by an ulp here and there, which flips
    near-tied choices in the layers after it, and a flipped token moves
    its logits by O(1) (as between the kernel and plain paths). Each
    run profiled (device events and ms) with its wall and each of
    ``kernels``' launches (name -> (wrapper, launches a prefill)), which
    must be the unmeshed run's. Returns the launches of the two meshed
    runs."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.runtime import pspec as PS
    n_moe = sum(1 for layer in model.decoder.layers
                if layer.spec.is_moe and layer.spec.has_ffn)
    rows, logits = {}, {}
    ep, replay = None, RouteReplay(moe)
    for name, shape in (("unmeshed", None), ("mesh_2x2", (2, 2)),
                        ("mesh_1x2", (1, 2))):
        mesh = None if shape is None else host_mesh(shape)
        before = {n: w.launches for n, (w, _) in kernels.items()}
        rec = EPRecorder(moe, T) if name == "mesh_2x2" else \
            contextlib.nullcontext()
        routing = {"unmeshed": replay.record, "mesh_1x2": replay.replay}.get(
            name, contextlib.nullcontext)()
        out = {}

        def fn():
            with PS.sharding_scope(mesh, "2d"), rec, routing, \
                    CallCount(moe, "expert_parallel") as cnt:
                out["logits"], out["timing"] = cached_steps(M, model, run,
                                                            tokens, fed)
                out["ep_calls"] = cnt.n

        ev = device_events(fn)
        logits[name] = torch.stack(out.pop("logits"), 1).float()
        rows[name] = {**out.pop("timing"), **ev, **out, "launches": {
            n: w.launches - before[n] for n, (w, _) in kernels.items()}}
        if name == "mesh_2x2":
            ep = moe_ep_check(rec.calls, model.cfg.moe, moe)
            del rec
    base = logits["unmeshed"]
    res = {"arch": model.cfg.name, "moe_layers": n_moe,
           "steps": 1 + fed.shape[1], **ep,
           "logits_1x2_vs_unmeshed_rel": rel_err(logits["mesh_1x2"], base),
           "logits_2x2_vs_unmeshed_rel": rel_err(logits["mesh_2x2"], base),
           "replayed_route_calls": len(replay.choices),
           "replay_calls_left": replay.left,
           "replay_prefill_flips": replay.flips,
           "logit_tol_rel": LOGIT_TOL_REL, "finite": all(
               bool(torch.isfinite(v).all()) for v in logits.values()),
           **rows}
    emit({f"{label}_mesh": res})
    want = rows["unmeshed"]["launches"]
    if not (moe_ep_ok(ep)
            and ep["calls"] == n_moe * res["steps"]
            and ep["shards_x_ranks"] == [(2, 2)]
            and res["finite"]
            and res["logits_1x2_vs_unmeshed_rel"] <= LOGIT_TOL_REL
            and res["replayed_route_calls"] == n_moe * res["steps"]
            and res["replay_calls_left"] == 0
            and rows["unmeshed"]["ep_calls"] == 0
            and rows["mesh_2x2"]["ep_calls"] == rows["mesh_1x2"]["ep_calls"]
            == n_moe * res["steps"]
            and all(v > 0 for v in want.values())
            and rows["mesh_2x2"]["launches"] == rows["mesh_1x2"]["launches"]
            == want):
        raise RuntimeError(f"{label} under the mesh failed: {res}")
    return {n: rows["mesh_2x2"]["launches"][n] + rows["mesh_1x2"]["launches"][n]
            for n in want}


def moe_mesh_train_step(M, adamw, cfg, run, batch, kernels: dict,
                        label: str) -> dict:
    """Phase 19 under a mesh: one train step (loss, aux and gradient norms,
    no update) of the cut model unmeshed, under a 1 x 2 mesh of the card
    with the ``"2d"`` rules (one token shard, so the single-device
    capacities; each rank runs half the experts), and under a 1 x 4 mesh
    with ``seq_attn_rules("2d")`` (4 experts a rank; attention
    sequence-parallel forward and backward, so the flash kernel is not
    launched), the last routing with the unmeshed step's choices
    (:class:`RouteReplay`: the blockwise attention's bf16 rounding would
    flip near-tied choices). Each within STEP_LOSS_TOL_REL (loss),
    STEP_AUX_TOL_REL (aux) and STEP_GNORM_TOL_REL (gradient norms) of the
    unmeshed step, each profiled with its wall and peak memory, every MoE
    call, the recompute's too, through the expert-parallel branch; the
    1 x 2 step launches ``kernels`` as the unmeshed one."""
    from repro_torch.models import layers, moe
    from repro_torch.runtime import pspec as PS
    model = M.build_model(cfg, seed=SEED, device=DEVICE).requires_grad_(True)
    n_moe = sum(1 for layer in model.decoder.layers
                if layer.spec.is_moe and layer.spec.has_ffn)
    n_attn = sum(1 for layer in model.decoder.layers
                 if layer.spec.mixer == "attn")
    rows, replay = {}, RouteReplay(moe)
    for name, shape, rules in (
            ("unmeshed", None, "2d"), ("mesh_1x2", (1, 2), "2d"),
            ("mesh_1x4_seq", SEQ_MESH, PS.seq_attn_rules("2d"))):
        mesh = None if shape is None else host_mesh(shape)
        before = {n: w.launches for n, (w, _) in kernels.items()}
        routing = {"unmeshed": replay.record,
                   "mesh_1x4_seq": replay.replay}.get(
            name, contextlib.nullcontext)()
        out = {}

        def fn():
            with PS.sharding_scope(mesh, rules), routing, \
                    CallCount(moe, "expert_parallel") as cnt, \
                    CallCount(layers, "seq_parallel_attention") as seq:
                out.update(moe_step_terms(M, adamw, model, run, batch))
            out["ep_calls"], out["seq_calls"] = cnt.n, seq.n

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ev = device_events(fn)
        rows[name] = {**out, "wall_s": time.perf_counter() - t0, **ev,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": {n: w.launches - before[n]
                                   for n, (w, _) in kernels.items()}}
    u, m, q = rows["unmeshed"], rows["mesh_1x2"], rows["mesh_1x4_seq"]

    def diffs(r, pre):
        return {f"{pre}{k}_rel_diff": _rel(r[k], u[k])
                for k in ("loss", "aux", "gnorm", "router_gnorm")}

    res = {"arch": cfg.name, "experts": cfg.moe.n_experts,
           "experts_a_rank": cfg.moe.n_experts // 2,
           "seq_experts_a_rank": cfg.moe.n_experts // SEQ_MESH[1],
           "moe_layers": n_moe, "attn_layers": n_attn,
           "tokens": list(batch["tokens"].shape),
           **diffs(m, ""), **diffs(q, "seq_"),
           "seq_replayed_route_calls": len(replay.choices),
           "seq_replay_calls_left": replay.left,
           "seq_replay_flips": replay.flips,
           "tol_loss_rel": STEP_LOSS_TOL_REL, "tol_aux_rel": STEP_AUX_TOL_REL,
           "tol_gnorm_rel": STEP_GNORM_TOL_REL, **rows}
    emit({f"{label}_mesh_train_step": res})
    del model
    torch.cuda.empty_cache()
    want = {n: e for n, (_, e) in kernels.items()}
    ok = all(all(math.isfinite(r[k]) for k in ("loss", "gnorm", "aux"))
             for r in (m, q))
    for pre in ("", "seq_"):
        ok = ok and (res[f"{pre}loss_rel_diff"] <= STEP_LOSS_TOL_REL
                     and res[f"{pre}aux_rel_diff"] <= STEP_AUX_TOL_REL
                     and res[f"{pre}gnorm_rel_diff"] <= STEP_GNORM_TOL_REL
                     and res[f"{pre}router_gnorm_rel_diff"]
                     <= STEP_GNORM_TOL_REL)
    if not (ok and u["ep_calls"] == 0 and u["seq_calls"] == 0
            and m["ep_calls"] == q["ep_calls"] == 2 * n_moe > 0
            and m["seq_calls"] == 0 and q["seq_calls"] == 2 * n_attn > 0
            and res["seq_replayed_route_calls"] == 2 * n_moe
            and res["seq_replay_calls_left"] == 0
            and m["launches"] == u["launches"] == want
            and q["launches"] == {n: 0 for n in want}):
        raise RuntimeError(f"{label} train step under the mesh disagrees "
                           f"with the unmeshed one: {res}")
    return m["launches"]


# --- 9b, 19: sequence-parallel attention ------------------------------------
#
# Under seq_attn_rules the heads do not split over 'model': self-attention
# splits its queries over the model axis instead (models/layers.py
# ``seq_parallel_attention``), each rank on the blockwise path (the flash
# kernel takes no query offset), a sliding-window layer's rank on the band
# of Sl + window keys its queries can see.
SEQ_MESH = (1, 4)              # (data, model): the sequence over 4 ranks
# Each call against the naive path in f32 on the same bf16 inputs: the
# ranks' bf16 outputs sit ~3e-3 from it (one rounding); a rank attending
# the wrong keys moves it by O(1).
SEQ_ATTN_TOL_REL_RMS = 1e-2


class SeqAttnCheck:
    """Checks every call of sequence-parallel attention as it happens
    (``layers.seq_parallel_attention``, which the attention sub-layer
    looks up at call time), storing nothing: its output against the
    naive path in f32 over the whole sequence on the same inputs
    (relative RMS), and its path, told by the key length each rank's
    attention (``layers._sdpa`` / ``_blockwise_sdpa``) sees: ``band`` (Sl
    + window keys), ``full`` (all) or ``other``. With ``shift`` every
    rank's query offset moves by that many positions (the control)."""

    def __init__(self, layers, shift: int = 0):
        self.layers, self.shift = layers, shift
        self.kinds = {"band": 0, "full": 0, "other": 0}
        self.paths: set = set()
        self.errs: list = []

    def __enter__(self):
        L = self.layers
        self.real = (L.seq_parallel_attention, L.rank_attention, L._sdpa,
                     L._blockwise_sdpa)
        seq, rank, sdpa, blockwise = self.real
        keys: list = []

        def recorded(path, fn):
            def f(q, k, *a, **kw):
                keys.append((path, k.shape[1]))
                return fn(q, k, *a, **kw)
            return f

        def shifted(*a, q_start, **kw):
            return rank(*a, q_start=q_start + self.shift, **kw)

        def checked(q, k, v, *, causal, window, impl, block_kv):
            keys.clear()
            out = seq(q, k, v, causal=causal, window=window, impl=impl,
                      block_kv=block_kv)
            S, n = q.shape[1], len(keys)
            lens = {ln for _, ln in keys}
            if window is not None and lens == {S // n + window} \
                    and S // n + window < S:
                self.kinds["band"] += 1
            elif lens == {S}:
                self.kinds["full"] += 1
            else:
                self.kinds["other"] += 1
            self.paths.update(p for p, _ in keys)
            pos = torch.arange(S, device=q.device)
            want = sdpa(q.float(), k.float(), v.float(),
                        L._mask(pos, pos, causal, window),
                        1.0 / math.sqrt(q.shape[-1]))
            self.errs.append(float((out.float() - want).norm()
                                   / want.norm()))
            del want
            return out

        L.seq_parallel_attention = checked
        if self.shift:
            L.rank_attention = shifted
        L._sdpa = recorded("naive", sdpa)
        L._blockwise_sdpa = recorded("blockwise", blockwise)
        return self

    def __exit__(self, *exc):
        L = self.layers
        (L.seq_parallel_attention, L.rank_attention, L._sdpa,
         L._blockwise_sdpa) = self.real

    def summary(self) -> dict:
        return {"calls": len(self.errs), **self.kinds,
                "paths": sorted(self.paths),
                "max_rel_rms": max(self.errs, default=math.nan),
                "min_rel_rms": min(self.errs, default=math.nan)}


def seq_prefill(M, model, run, tokens, logits, flash, card: str) -> tuple:
    """Phase 9b: the served model's prefill of ``tokens`` (gemma3-12b:
    48 layers, 4 x 2048 tokens) under a 1 x 4 mesh of the card with
    ``seq_attn_rules("2d")``: the 40 local layers on the band, the 8
    global ones on all keys. Gate 1 (:class:`SeqAttnCheck`): every call
    within SEQ_ATTN_TOL_REL_RMS of the naive path, and every call of a
    control whose ranks' query offset is off by one key block
    (``run.attn_block_kv`` positions) past it. Gate 2: the last
    position's logits within LOGIT_TOL_REL of the unmeshed prefill on the
    flash path (``logits``, the served run's), the control's past it. The
    meshed and unmeshed prefills are timed (device events and ms) on
    their own. Returns (the result, the timed unmeshed prefill's flash
    launches)."""
    from repro_torch.models import layers
    from repro_torch.runtime import pspec as PS
    rules = PS.seq_attn_rules("2d")
    mesh = host_mesh(SEQ_MESH)
    rows = {}
    for name, scope in (("unmeshed", contextlib.nullcontext),
                        ("mesh_1x4", lambda: PS.sharding_scope(mesh,
                                                               rules))):
        before = flash.launches
        out = {}

        def fn():
            with scope(), CallCount(layers, "seq_parallel_attention") as c:
                out["logits"], cache = M.prefill(model, run, tokens, S_MAX)
                del cache
            out["seq_calls"] = c.n

        ev = device_events(fn)
        rows[name] = {**ev, "seq_calls": out["seq_calls"],
                      "flash_launches": flash.launches - before,
                      "timed_vs_served_rel": rel_err(out["logits"], logits)}
    checks, got = {}, {}
    for name, shift in (("check", 0), ("control", run.attn_block_kv)):
        before = flash.launches
        with PS.sharding_scope(mesh, rules), \
                SeqAttnCheck(layers, shift) as chk:
            got[name], cache = M.prefill(model, run, tokens, S_MAX)
            del cache
        torch.cuda.synchronize()
        checks[name] = {**chk.summary(),
                        "flash_launches": flash.launches - before,
                        "logits_vs_unmeshed_flash_rel": rel_err(got[name],
                                                                logits)}
    n_layers = len(model.decoder.layers)
    n_global = sum(layer.spec.is_global for layer in model.decoder.layers)
    c, k = checks["check"], checks["control"]
    res = {"arch": model.cfg.name, "tokens": list(tokens.shape),
           "mesh": list(SEQ_MESH), "rules": "seq_attn_rules(2d)",
           "ranks_queries": tokens.shape[1] // SEQ_MESH[1],
           "window": model.cfg.sliding_window,
           "block_kv": run.attn_block_kv, "control_shift": run.attn_block_kv,
           "tol_rel_rms": SEQ_ATTN_TOL_REL_RMS,
           "logit_tol_rel": LOGIT_TOL_REL, "check": c, "control": k,
           "finite": bool(torch.isfinite(got["check"]).all()),
           "device_ms_mesh_over_unmeshed": rows["mesh_1x4"]["device_ms"]
           / rows["unmeshed"]["device_ms"], **rows, "card": card}
    emit({"seq_prefill": res})
    del got
    torch.cuda.empty_cache()
    if not (res["finite"] and c["calls"] == n_layers
            and c["band"] == n_layers - n_global and c["full"] == n_global
            and c["other"] == 0 and c["paths"] == ["blockwise"]
            and c["max_rel_rms"] <= SEQ_ATTN_TOL_REL_RMS
            and k["calls"] == n_layers
            and k["min_rel_rms"] > SEQ_ATTN_TOL_REL_RMS
            and c["logits_vs_unmeshed_flash_rel"] <= LOGIT_TOL_REL
            and k["logits_vs_unmeshed_flash_rel"] > LOGIT_TOL_REL
            and c["flash_launches"] == k["flash_launches"] == 0
            and rows["mesh_1x4"]["flash_launches"] == 0
            and rows["mesh_1x4"]["seq_calls"] == n_layers
            and rows["unmeshed"]["seq_calls"] == 0
            and rows["unmeshed"]["flash_launches"] == n_layers):
        raise RuntimeError(f"prefill under sequence-parallel attention "
                           f"failed: {res}")
    return res, rows["unmeshed"]["flash_launches"]


# phase 20: the roofline of the two unmeshed cells the card already runs,
# traced on meta tensors (steps.lower_cell + cost_analysis.analyze on a
# one-device mesh) and run on the card, each on the blockwise path and on
# the kernel path (flash: the flash kernel in gemma3's prefill, the SSD
# kernel's forward and the plain backward in mamba2's step), whose kernels
# the trace counts by their rules
ROOFLINE_CELLS = tuple(
    (arch, kind, batch, seq, impl) for arch, kind, batch, seq in (
        ("gemma3-12b", "prefill", SERVE_BATCH, PROMPT_LEN),
        (TRAIN_ARCH, "train", TRAIN_BATCH, TRAIN_SEQ))
    for impl in ("blockwise", "flash"))
ROOFLINE_TIMED = 3             # CUDA-event timings of each step (median)
# The card's peak over one call against the trace's arguments plus its peak
# of live temporaries: both follow the same eager code's allocations and
# frees; the card adds its allocator's rounding and cuBLAS workspaces, the
# trace counts a storage until it dies.
PEAK_RATIO_BOUNDS = (0.8, 1.25)


def roofline_cell(arch: str, kind: str, batch: int, seq: int, impl: str,
                  card: str) -> dict:
    """One cell of phase 20 on the ``impl`` path: its step traced on meta
    tensors (dot FLOPs, HBM bytes, the H100 roofline, each kernel's
    calls), then built at full size with random weights from SEED and run
    on the card, once under ``FlopCounterMode`` and ROOFLINE_TIMED times
    between CUDA events. Raises unless the card's count equals the
    trace's, the measured ms are at least the roofline's compute term, the
    card's peak memory is within PEAK_RATIO_BOUNDS of the trace's and each
    kernel launched, in the counted call, as often as the trace calls
    it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import pspec as PS
    from repro_torch.runtime import steps
    from repro_torch.runtime.cost_analysis import analyze
    from repro_torch.runtime.roofline import PEAK_FLOPS, roofline_report
    cfg = get_config(arch)
    run = RunConfig(arch=arch, attn_impl=impl, seed=SEED)
    shape = ShapeConfig(f"{kind}_{seq}", seq_len=seq, global_batch=batch,
                        kind=kind)
    wrappers = {"flash_attention": fa, "ssd_scan": ssd}   # name: module
    t0 = time.perf_counter()
    with PS.sharding_scope(PS.abstract_mesh((1, 1), ("data", "model")),
                           run.sharding):
        low, _ = steps.lower_cell(cfg, run, shape)
    calls: dict = {}
    hlo, mem = analyze(low, calls)
    trace_s = time.perf_counter() - t0
    trace_peak = mem["argument_bytes"] + mem["temp_bytes"]
    roof = roofline_report({"hlo": hlo, "chips": 1}, cfg, shape)

    model = M.build_model(cfg, seed=SEED, device=DEVICE)
    data = {k: v.to(DEVICE) for k, v in M.make_batch(
        cfg, shape, torch.Generator().manual_seed(SEED)).items()}
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
    torch.cuda.synchronize()
    for name, mod in wrappers.items():
        getattr(mod, name).launches = 0
    with FlopCounterMode(display=False) as fc:
        call()
    torch.cuda.synchronize()
    launches = {n: getattr(mod, n).launches for n, mod in wrappers.items()}
    card_flops = fc.get_total_flops()
    card_args, card_peak = card_memory(call)
    times = []
    for _ in range(ROOFLINE_TIMED):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    del model, data, step
    torch.cuda.empty_cache()
    res = {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
           "attn_impl": run.attn_impl, "trace_s": trace_s,
           "trace_kernel_calls": calls, "launches": launches,
           "dot_flops_per_chip": hlo["dot_flops_per_chip"],
           "card_flops": card_flops,
           "mem_bytes_per_chip": hlo["mem_bytes_per_chip"],
           "t_compute_ms": 1e3 * roof["t_compute_s"],
           "t_memory_ms": 1e3 * roof["t_memory_s"],
           "bound": roof["bound"], "measured_ms": ms, "timed_ms": times,
           "roofline_fraction": roof["roofline_fraction"],
           "measured_roofline_fraction": max(
               roof["t_compute_s"], roof["t_memory_s"]) * 1e3 / ms,
           "measured_model_flops_share": (
               roof["model_flops_global"] / (ms / 1e3) / PEAK_FLOPS),
           "useful_flops_ratio": roof["useful_flops_ratio"],
           "trace_memory": mem, "trace_peak_bytes": trace_peak,
           "card_allocated_bytes": card_args, "card_peak_bytes": card_peak,
           "peak_ratio": card_peak / trace_peak, "card": card}
    emit({"roofline_cell": res})
    print(f"roofline {arch} {kind} {impl}: {ms:.2f} ms measured, "
          f"{max(res['t_compute_ms'], res['t_memory_ms']):.2f} ms bound by "
          f"{res['bound']}, fraction {res['measured_roofline_fraction']:.3f}",
          flush=True)
    if card_flops != hlo["dot_flops_per_chip"]:
        raise RuntimeError(f"{arch} {kind}: the card ran {card_flops} dot "
                           f"FLOPs, the meta trace counts "
                           f"{hlo['dot_flops_per_chip']}")
    if not ms >= res["t_compute_ms"]:
        raise RuntimeError(f"{arch} {kind}: {ms} ms measured, under the "
                           f"roofline's compute term {res['t_compute_ms']}")
    lo, hi = PEAK_RATIO_BOUNDS
    if not lo <= res["peak_ratio"] <= hi:
        raise RuntimeError(f"{arch} {kind}: the card's peak {card_peak} B "
                           f"is {res['peak_ratio']} of the trace's "
                           f"{trace_peak} B, outside [{lo}, {hi}]")
    if any(launches[n] != calls.get(n, 0) for n in wrappers):
        raise RuntimeError(f"{arch} {kind} {impl}: the card launched "
                           f"{launches}, the trace calls {calls}")
    return res


def card_memory(call) -> tuple:
    """The card's allocated bytes just before ``call()`` and the most it
    held during that one call."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return before, torch.cuda.max_memory_allocated()


def roofline_phase(card: str) -> list:
    """Phase 20: :func:`roofline_cell` for each of ROOFLINE_CELLS."""
    torch.cuda.empty_cache()
    return [roofline_cell(*c, card) for c in ROOFLINE_CELLS]


def roofline_paths(cells: list) -> tuple:
    """Each kernel's launches in phase 20's counted calls, by cell, for
    the ``kernels`` line: (flash, SSD)."""
    paths = ({}, {})
    for r in cells:
        for got, name in zip(paths, ("flash_attention", "ssd_scan")):
            if r["launches"][name]:
                got[f"20 roofline {r['arch']} {r['kind']}"] = \
                    r["launches"][name]
    return paths


# phase 21: the dry run (python -m repro_torch.launch.dryrun) at full size
# over both production meshes on the card's host: kimi-k2's train_4k, the
# heaviest trace, mamba2-370m's long_500k, a batch of one, and
# mamba2-370m's train_4k on the kernel path (--attn-impl flash: the SSD
# kernel counted by its rule), one process a cell and mesh, all at once;
# each JSON rendered by scripts/roofline_table.py
DRYRUN_CELLS = (("kimi-k2-1t-a32b", "train_4k", "blockwise"),
                ("mamba2-370m", "long_500k", "blockwise"),
                ("mamba2-370m", "train_4k", "flash"))
DRYRUN_MESHES = ("16x16", "2x16x16")
DRYRUN_KEYS = ("arch", "shape", "kind", "mesh", "chips", "lower_s",
               "compile_s", "memory", "cost_analysis", "hlo", "roofline")
DRYRUN_MEMORY = ("argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes")
DRYRUN_TIMEOUT = 600


def dryrun_phase(out_dir: Path, python: str = sys.executable) -> list:
    """Phase 21: the dry run of each of DRYRUN_CELLS (arch, shape,
    attention path) on each mesh, one subprocess each, all started
    together (exit 0, one record with every key of the reference's), then
    ``scripts/roofline_table.py`` on each JSON (exit 0, one row). Raises on
    any failure, and stops every process it started first."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    runs = []
    try:
        for arch, shape, impl in DRYRUN_CELLS:
            for mesh in DRYRUN_MESHES:
                path = out_dir / f"dryrun_{arch}_{shape}_{impl}_{mesh}.json"
                argv = [python, "-m", "repro_torch.launch.dryrun", "--arch",
                        arch, "--shape", shape, "--attn-impl", impl,
                        "--json", str(path)]
                if mesh == "2x16x16":
                    argv.append("--multi-pod")
                runs.append((arch, shape, impl, mesh, path,
                             time.perf_counter(), subprocess.Popen(
                                 argv, env=env, cwd=str(REPO), text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)))
        recs = []
        for arch, shape, impl, mesh, path, t0, proc in runs:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"dry run {arch} {shape} {impl} {mesh} "
                                   f"exited {proc.returncode}:\n"
                                   f"{out[-2000:]}{err[-4000:]}")
            (r,) = json.loads(path.read_text())
            missing = [k for k in DRYRUN_KEYS if k not in r] + [
                k for k in DRYRUN_MEMORY if k not in r.get("memory", {})]
            if r.get("mesh") != mesh or missing:
                raise RuntimeError(f"dry run {arch} {shape} {impl} {mesh}: "
                                   f"mesh {r.get('mesh')}, no {missing} in "
                                   f"{sorted(r)}")
            table = subprocess.run(
                [python, str(REPO / "scripts" / "roofline_table.py"),
                 str(path), mesh], capture_output=True, text=True,
                timeout=60)
            rows = [line for line in table.stdout.splitlines()
                    if line.startswith(arch)]
            if table.returncode != 0 or len(rows) != 1:
                raise RuntimeError(f"roofline_table.py {mesh} exited "
                                   f"{table.returncode}, {len(rows)} rows:"
                                   f"\n{table.stdout}{table.stderr}")
            print(rows[0], flush=True)
            rf = r["roofline"]
            emit({"dryrun_cell": {
                "arch": arch, "shape": shape, "attn_impl": impl,
                "mesh": mesh, "kind": r["kind"], "bound": rf["bound"],
                **{k: rf[k] for k in ("t_compute_s", "t_memory_s",
                                      "t_collective_s")},
                "memory": r["memory"], "lower_s": r["lower_s"],
                "trace_s": r["compile_s"], "process_s": wall}})
            recs.append(r)
    finally:
        for run in runs:
            if run[-1].poll() is None:
                run[-1].kill()
                run[-1].wait()
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
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

    clock = PhaseClock()

    # 1. device
    card = gpu_line()
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    clock.mark("1 device")

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

    clock.mark("2 build")

    # 3. kernels against their plain versions
    ftns, job = planner_scale_jobs(tp)
    planner = tp.TorchCarbonPlanner(ftns, device="cuda",
                                    batch_backend="fused")
    kernels = check_kernels(planner, job, grid_cuda, gt,
                            built[grid_cuda._SOURCE.name][1])
    kernel_fns = {"rate_prefix": grid_cuda.rate_prefix,
                  "sweep": grid_cuda.sweep}

    clock.mark("3 kernels")

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

    clock.mark("4 plan_batch windows")

    # 4b. the per-leg torch scorer: plan(), plan_batch's per-job scan and
    # rescore() with backend="torch" against the numpy backend
    leg_scorer(tp)

    clock.mark("4b per-leg scorer")

    # 4c. the planner lattice's cell axis split over three copies of the
    # card, against unsplit and the numpy oracle
    cell_split(tp, gt, ftns, job)

    clock.mark("4c cell split")

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

    clock.mark("5 oracle")

    # 6-6e count the launches inside timed calls by launching thread
    with ThreadLaunches(grid_cuda._library()) as threads:
        # 6. the fleet day: ShardedFleet -> FleetController x 4 ->
        # CarbonAwareQueue -> plan_batch -> the planner kernels, then the
        # same day on the numpy oracle
        with SplitTimer(grid_cuda) as split:
            line, day_report = fleet_day(kernel_fns, threads, split)
            emit({"fleet_main_path": line})
        clock.mark("6 fleet day")

        # 6b. the same day on four spawn workers (a CUDA context each)
        # through the fused kernels, two worker kills, a checkpoint at
        # hour 12 and a restore onto fresh workers: phase 6's report bit
        # for bit
        emit({"fleet_workers": fleet_workers(line, day_report, kernel_fns)})
        clock.mark("6b fleet workers")

        # 6c. examples/fleet_durable.py on fork workers after CUDA is live
        emit({"fleet_durable": fleet_durable(kernel_fns)})
        clock.mark("6c fleet durable")

        # 6d. the bursty_day stream through the StreamingGateway, pipeline
        # off and on, the gateway's planner thread launching the kernels
        emit({"fleet_stream": fleet_stream(grid_cuda, threads)})
        clock.mark("6d fleet stream")

        # 6e. the lattice day: edge_lattice_day on 200 zones, fused
        # admission
        with SplitTimer(grid_cuda) as split:
            emit({"lattice_day": lattice_day(kernel_fns, split)})
        clock.mark("6e lattice day")

    # 7. the flash kernel against its plain version at the prefill's shapes
    cfg = get_config(ARCH)
    flash_cases = check_flash(
        fa, cfg, ptxas_usage(built[fa._SOURCE.name][1], FLASH_KERNEL))

    clock.mark("7 flash")

    # 8. the serving main path. cuBLAS reduces bf16 GEMMs in f32 (no
    # reduced-precision reduction) and f32 GEMMs in full f32 (no TF32), so
    # the logit check below compares roundings to bf16 only.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(arch=ARCH, attn_impl="flash", remat="none", seed=SEED)
    srv, probe, launches = serve(fa, sl, cfg, run, power_limit_w(card))
    flash_launches = launches["flash"]

    # 9. logits: cached path against the plain full forward
    check_logits(M, srv, probe)
    emit({"profile": profile_serving(M, srv, probe.epochs[0]["tokens"])})
    clock.mark("8-9 serving")

    # 9b. the same prefill under a 1 x 4 mesh of the card with
    # seq_attn_rules: sequence-parallel attention, the band on the local
    # layers, each call and the logits held to the unmeshed path
    _, seq_flash = seq_prefill(M, srv.model, srv.run,
                               probe.epochs[0]["tokens"],
                               probe.epochs[0]["logits"][0],
                               fa.flash_attention, card)
    del srv, probe
    torch.cuda.empty_cache()
    clock.mark("9b seq-parallel prefill")

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
    check_train_step(M, adamw, ssd.ssd_scan, tcfg, trun, batch,
                     2 * tcfg.n_layers)
    del batch
    tr, ssd_launches = train(tl, ssd, tcfg, trun, power_limit_w(card))
    emit({"train_profile": profile_training(ops, tr)})
    del tr
    torch.cuda.empty_cache()
    clock.mark("10 training")

    # 11. SSM serving: mamba2-370m through the SSD kernel in prefill and
    # O(1) recurrent decode from its final state
    scfg = get_config(SSM_ARCH)
    srun = RunConfig(arch=SSM_ARCH, attn_impl="flash", remat="none",
                     seed=SEED)
    ssd_serve_case, ssd_serve_launches = ssm_serving(
        ssd, fa, sl, M, scfg, srun, power_limit_w(card),
        ptxas_usage(built[ssd._SOURCE.name][1], SSD_KERNEL_PREFIX))
    clock.mark("11 ssm serving")

    # 12. seamless-m4t-medium: the encoder's non-causal flash and the
    # decoder's causal flash at head_dim 64, prefill with audio frames and
    # decode through the cross-attention cache, one train step
    flash_usage = ptxas_usage(built[fa._SOURCE.name][1], FLASH_KERNEL)
    ecfg = get_config(ENCDEC_ARCH)
    flash_cases += check_flash(fa, ecfg, flash_usage, ENCDEC_FLASH_CASES)
    flash_paths = {"8 serve gemma3-12b": flash_launches,
                   "9b gemma3 prefill timed beside the mesh": seq_flash}
    for path, n in family_paths(
            fa, M, adamw, ecfg, RunConfig(arch=ENCDEC_ARCH, attn_impl="flash",
                                          remat="none", seed=SEED),
            "seamless").items():
        flash_paths[f"12 seamless {path}"] = n
    clock.mark("12 seamless")

    # 13. internvl2-1b: flash at GQA 14:2, Server on text-only prompts,
    # prefill with 256 patches and decode, one train step
    vcfg = get_config(VLM_ARCH)
    flash_cases += check_flash(fa, vcfg, flash_usage, VLM_FLASH_CASES)
    vrun = RunConfig(arch=VLM_ARCH, attn_impl="flash", remat="none",
                     seed=SEED)
    srv, probe, launches = serve(fa, sl, vcfg, vrun, power_limit_w(card))
    flash_paths["13 internvl2 serve"] = launches["flash"]
    emit({"internvl2_profile": profile_serving(
        M, srv, probe.epochs[0]["tokens"])})
    del srv, probe
    torch.cuda.empty_cache()
    for path, n in family_paths(fa, M, adamw, vcfg, vrun,
                                "internvl2").items():
        flash_paths[f"13 internvl2 {path}"] = n
    clock.mark("13 internvl2")

    # 14-16. the moe and hybrid families served at full width, depth cut
    # to one card: flash at head_dim 128 and 112, the SSD kernel at
    # d_state 16 and 128 heads (jamba), then Server and the MoE logit gate
    ssd_paths = {"10 train mamba2-370m": ssd_launches,
                 "11 serve mamba2-370m": ssd_serve_launches}
    ssd_cases = {"training": ssd_case, "serving_b4": ssd_serve_case}
    moe_phases(fa, ssd, sl, M, built, power_limit_w(card), clock,
               flash_cases, flash_paths, ssd_cases, ssd_paths)

    # 17-19. the moe and hybrid families trained at full width, depth and
    # experts cut to one card: a train step on the kernel path against the
    # plain path routing as it did, then three Trainer steps
    moe_training(fa, ssd, ops, tl, M, adamw, built, power_limit_w(card),
                 clock, flash_cases, flash_paths, ssd_cases, ssd_paths)

    # 20. the roofline: gemma3-12b's served prefill and mamba2-370m's train
    # step traced on meta tensors and run on the card, blockwise and on the
    # kernel path, their dot FLOPs and kernel launches equal
    flash_roof, ssd_roof = roofline_paths(roofline_phase(gpu_line()))
    flash_paths.update(flash_roof)
    ssd_paths.update(ssd_roof)
    clock.mark("20 roofline")

    # 21. the dry run over both production meshes: kimi-k2's train_4k and
    # mamba2-370m's long_500k traced at full size, rendered as the table
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        dryrun_phase(Path(d))
    clock.mark("21 dry run")

    # results
    worst = max(flash_cases, key=lambda c: c["rel_rms_err"])
    kernels.append(
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
         "replaces": "src/repro/kernels/flash_attention.py:30",
         "launches": sum(flash_paths.values()),
         "launches_by_path": flash_paths,
         "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
         "rel_rms_err": worst["rel_rms_err"],
         **{k: flash_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
         "timed_case": flash_cases[0]["case"],
         "cases": {c["case"]: {k: c[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "max_abs_err", "rel_rms_err")} for c in flash_cases}})
    kernels.append(
        {"name": "ssd_scan", "route": "cuda", "source": SSD_SRC,
         "replaces": "src/repro/kernels/ssd_scan.py:26",
         "launches": sum(ssd_paths.values()),
         "launches_by_path": ssd_paths,
         **{k: max(c[k] for c in ssd_cases.values()) for k in (
             "max_abs_err", "y_rel_rms_err", "h_rel_rms_err")},
         **{k: ssd_case[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "timed_case": "training",
         "cases": {name: {k: c[k] for k in (
             "x", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
             "y_rel_rms_err", "h_rel_rms_err")}
             for name, c in ssd_cases.items()}})
    emit({"phase_s": clock.phases})
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
