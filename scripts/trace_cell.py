#!/usr/bin/env python3
"""Trace one (arch x shape) cell at full size on a production mesh and
print its per-device cost and the seconds the trace took.

    python3 scripts/trace_cell.py [--arch kimi-k2-1t-a32b]
                                  [--shape train_4k] [--multi-pod]

``steps.lower_cell`` under ``make_production_mesh`` (16 x 16, or 2 x 16 x
16 with ``--multi-pod``) and the run's ``"2d"`` rules, then
``cost_analysis.analyze_cell``: a trace on meta tensors, so it needs no
device and allocates no weights, but at full size it runs every layer's
ops and takes minutes of CPU. Prints one JSON line: the lowering and
trace seconds, the counts and the H100 roofline.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))


def main() -> int:
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime import pspec as PS
    from repro_torch.runtime import steps
    from repro_torch.runtime.cost_analysis import analyze_cell
    from repro_torch.runtime.roofline import roofline_report
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kimi-k2-1t-a32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    cfg, shape = get_config(args.arch), get_shape(args.shape)
    run = RunConfig(arch=args.arch, shape=args.shape,
                    multi_pod=args.multi_pod)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    t0 = time.perf_counter()
    with PS.sharding_scope(mesh, run.sharding):
        low, kind = steps.lower_cell(cfg, run, shape)
    t_lower = time.perf_counter() - t0
    hlo = analyze_cell(low)
    t_trace = time.perf_counter() - t0 - t_lower
    chips = hlo["num_partitions"]
    print(json.dumps({"arch": args.arch, "shape": args.shape, "kind": kind,
                      "mesh": "x".join(str(n) for n in mesh.shape.values()),
                      "lower_s": t_lower, "trace_s": t_trace, "hlo": hlo,
                      "roofline": roofline_report(
                          {"hlo": hlo, "chips": chips}, cfg, shape)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
