#!/usr/bin/env python3
"""Profile the two arms of ``chip_smoke.py``'s phase 4c gate on one GPU,
several times in one process, and diff their device events by name.

    python3 scripts/cell_split_events.py [--runs 10]

Window 0 of ``planner_scale`` (4096 jobs) is planned with
``TorchCarbonPlanner.plan_batch_torch`` on ``batch_backend="torch"``
unsplit and with ``shard=MeshConfig(platform="cuda", n_devices=2)``
(one device on one card), each once to warm up, then ``--runs`` times
each under ``torch.profiler``, alternating which arm goes first. For
every profiled call it counts the device events (kernels, copies, sets)
by name and the CUDA runtime calls that start them (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) by name. Prints, per arm, the totals of each
run and the names whose count varies between runs, the per-name
difference between the arms, and the card's name and power limit; the
whole record goes to ``chiprun_out/cell_split_events.json``. Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))


def profiled(fn) -> tuple:
    """(device events by name, CUDA runtime calls by name) of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, api = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev[e.name] += 1
        elif e.name.startswith("cuda"):
            api[e.name] += 1
    return dev, api


def varying(counts: list) -> dict:
    """Names whose count is not the same in every run, with the counts."""
    names = set().union(*counts)
    return {n: [c[n] for c in counts] for n in sorted(names)
            if len({c[n] for c in counts}) > 1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_split_events: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.scheduler import grid_torch as gt
    from repro_torch.core.scheduler import planner as tp
    ftns, job = cs.planner_scale_jobs(tp)
    planner = tp.TorchCarbonPlanner(ftns, device="cuda",
                                    batch_backend="torch")
    jobs = [job(i) for i in range(cs.WINDOW)]
    arms = {"unsplit": {},
            "mesh_config": {"shard": gt.MeshConfig(platform="cuda",
                                                   n_devices=2)}}
    for kw in arms.values():
        planner.plan_batch_torch(jobs, **kw)
    dev = {a: [] for a in arms}
    api = {a: [] for a in arms}
    for i in range(args.runs):
        order = list(arms) if i % 2 == 0 else list(arms)[::-1]
        for arm in order:
            d, a = profiled(lambda: planner.plan_batch_torch(jobs,
                                                             **arms[arm]))
            dev[arm].append(d)
            api[arm].append(a)
    out = {"runs": args.runs, "jobs": len(jobs), "card": cs.gpu_line()}
    for arm in arms:
        out[arm] = {"device_events": [sum(c.values()) for c in dev[arm]],
                    "runtime_calls": [sum(c.values()) for c in api[arm]],
                    "varying_device_events": varying(dev[arm]),
                    "varying_runtime_calls": varying(api[arm])}
    diffs = []
    for du, dm in zip(dev["unsplit"], dev["mesh_config"]):
        names = set(du) | set(dm)
        diffs.append({n: dm[n] - du[n] for n in sorted(names)
                      if dm[n] != du[n]})
    out["mesh_config_minus_unsplit_by_name"] = diffs
    out["device_event_names"] = dict(sorted(dev["unsplit"][0].items()))
    out["runtime_call_names"] = dict(sorted(api["unsplit"][0].items()))
    Path(REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "cell_split_events.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in (
        "runs", "jobs", "unsplit", "mesh_config",
        "mesh_config_minus_unsplit_by_name")}), flush=True)
    print(out["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
