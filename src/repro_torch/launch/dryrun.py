"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, its per-device memory and cost and the roofline terms,
as the reference's ``launch/dryrun.py`` prints them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--json out.json]

The reference lowers and compiles each cell through XLA on 512 forced host
devices. The port has no compiler to ask: ``steps.lower_cell`` builds the
cell's step over meta tensors under ``make_production_mesh``'s shape-only
mesh, and ``runtime.cost_analysis.analyze`` traces it once (forward,
backward, recompute). Meta tensors hold no data, so the dry run needs no
card and places nothing; it is a description of the production program,
not a run of it on the CPU.

Each record has the reference's keys:

- ``lower_s``: ``steps.lower_cell``'s wall; ``compile_s``: the trace's
  wall, the step the port takes in place of XLA's compile;
- ``memory``: ``argument_bytes``, ``output_bytes``, ``temp_bytes`` and
  ``alias_bytes`` per device, as ``cost_analysis.analyze`` defines them;
- ``cost_analysis``: the reference's ``flops`` and ``bytes accessed``.
  The port has no uncorrected XLA count, so they hold the trace's dot
  FLOPs and HBM bytes per chip, equal to ``hlo``'s by construction;
- ``hlo``: ``cost_analysis.analyze_cell``'s counts (the reference's keys
  but ``entry`` and ``n_computations``, which name HLO computations);
- ``roofline``: ``runtime.roofline.roofline_report`` on the H100 peaks.

A skipped cell is ``{"arch", "shape", "mesh", "skipped"}``, one that
raises ``{"arch", "shape", "mesh", "error"}`` (``main`` then prints the
failures and returns 1). Under ``--attn-impl flash`` (the kernel path the
port serves and trains, the reference's ``pallas``) a cell whose path
reaches a kernel (the SSD scan, a non-causal encoder's attention) traces
the kernel's custom op on meta tensors, which allocates what the card's
wrapper allocates and computes nothing; the trace counts its work by the
rule beside the kernel (``flash_cost``, ``ssd_cost``) and its backward as
the plain recompute it is. Sequence-parallel attention goes blockwise
there, as the reference's ``pallas`` does, and decode attends naively,
so those cells trace as they do without the flag.

``run_cell`` looks ``get_config``, ``get_shape`` and
``make_production_mesh`` up as module globals at call time.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, cells, get_config, get_shape
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import pspec
from repro_torch.runtime.cost_analysis import analyze
from repro_torch.runtime.roofline import roofline_report
from repro_torch.runtime.steps import lower_cell


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             run_overrides: dict | None = None, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    run = RunConfig(arch=arch, shape=shape_name, multi_pod=multi_pod,
                    **(run_overrides or {}))
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with pspec.sharding_scope(mesh, run.sharding):
        lowered, kind = lower_cell(cfg, run, shape)
        t_lower = time.time() - t0
        hlo, mem = analyze(lowered)
        t_compile = time.time() - t0 - t_lower
    n_chips = hlo["num_partitions"]
    rec = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": _mesh_name(multi_pod), "chips": int(n_chips),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": mem,
        "cost_analysis": {"flops": hlo["dot_flops_per_chip"],
                          "bytes accessed": hlo["mem_bytes_per_chip"]},
        "hlo": hlo,
    }
    rec["roofline"] = roofline_report(rec, cfg, shape)
    if verbose:
        dev_bytes = mem["argument_bytes"] + mem["temp_bytes"]
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']} ({kind}) "
              f"lower={t_lower:.0f}s compile={t_compile:.0f}s")
        print(f"  memory/device: args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB "
              f"total={dev_bytes/2**30:.2f}GiB")
        r = rec["roofline"]
        print(f"  roofline: compute={r['t_compute_s']:.3e}s "
              f"memory={r['t_memory_s']:.3e}s "
              f"coll={r['t_collective_s']:.3e}s "
              f"-> bound={r['bound']} "
              f"model/hlo_flops={r['useful_flops_ratio']:.3f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--attn-impl", default=None,
                    help="naive | blockwise | flash")
    ap.add_argument("--sharding", default=None)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    for k in ("attn_impl", "sharding", "remat"):
        v = getattr(args, k)
        if v:
            overrides[k] = v

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    todo = []
    if args.all:
        for arch, shape, skip in cells(include_skips=True):
            todo.append((arch, shape.name, skip))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cfgs = get_config(args.arch)
        skip = None
        if args.shape == "long_500k" and not cfgs.sub_quadratic:
            skip = "skip:full-attn"
        todo.append((args.arch, args.shape, skip))

    results, failures = [], []
    for arch, shape_name, skip in todo:
        for mp in meshes:
            if skip:
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": _mesh_name(mp), "skipped": skip})
                print(f"[dryrun] {arch} × {shape_name}: {skip}")
                continue
            try:
                results.append(run_cell(arch, shape_name, multi_pod=mp,
                                        run_overrides=overrides))
            except Exception as e:  # noqa: BLE001 - report and continue
                traceback.print_exc()
                failures.append((arch, shape_name, mp, repr(e)))
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": _mesh_name(mp), "error": repr(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")
    if failures:
        print(f"FAILURES ({len(failures)}):")
        for f in failures:
            print("  ", f)
        return 1
    print(f"dry-run OK: {len(results)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
