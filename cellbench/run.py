"""Run one cell of the benchmark once.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks
for. It makes the cell's weights and traffic from ``--seed``, warms up,
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, where the program is missing, and where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the
window has closed.

``--device cpu`` runs the kernels' plain versions on the CPU and reports
platform ``cpu``; ``--root`` reads ``BENCHMARK.json`` and the data files
from another directory. Both are for the CPU tests.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Iterable, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock, from its
    start time in /proc (the boot clock, in clock ticks), else the import
    of this module."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Top-level names among ``names`` (the loaded modules by default)
    that are JAX or the JAX package, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def model_config(cell):
    """The port's ``ModelConfig`` of the configuration file."""
    from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig
    f = cell.model_fields()
    if f.get("moe"):
        f["moe"] = MoEConfig(**f["moe"])
    if f.get("ssm"):
        f["ssm"] = SSMConfig(**f["ssm"])
    return ModelConfig(name=cell.config_name, **f)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: Optional[float] = None) -> Dict:
    """One run of a cell -> the result object (``checks`` last)."""
    t_start = process_start() if t_start is None else t_start
    import torch
    from cellbench import judge
    from cellbench.bench import Bench
    from cellbench.drivers import Ctx, driver
    from cellbench.energy import Meter
    from cellbench.trace import TraceContext
    from repro_torch.configs.base import RunConfig

    cell = Bench(root).cell(workload)
    dev = torch.device(device)
    cfg = model_config(cell)
    run = RunConfig(arch=cfg.name, seed=seed, **cell.run_fields())
    marks = [("imports", time.perf_counter())]
    meter = None
    if dev.type == "cuda":
        meter = Meter(dev)
        meter.announce()
        marks.append(("CUDA and NVML", time.perf_counter()))
    ctx = Ctx(cell=cell, cfg=cfg, run=run, seed=seed, seconds=seconds,
              trace=trace, device=dev, t_start=t_start, meter=meter)
    ctx.phases += marks
    out = driver(cell.kind).run(ctx)
    t_end = time.perf_counter()
    print(f"seconds: set-up {ctx.setup_s:.1f}, window {ctx.window_s:.1f}, "
          f"after the window {t_end - ctx.t_start - ctx.setup_s - ctx.window_s:.1f}"
          f" (the check against the reference{', the trace' if trace else ''})",
          file=sys.stderr, flush=True)
    print("set-up phases: " + ", ".join(f"{n} {s:.1f}" for n, s in
                                        ctx.phase_seconds()) + " (s)",
          file=sys.stderr, flush=True)

    if trace:
        tc = TraceContext(cell, cell.model_fields(), ctx.digest, ctx.spans,
                          dict(out.counts, window_s=ctx.window_s),
                          on_card=dev.type == "cuda")
        wanted = cell.per_layer
        values = {name: mod.read(tc) for name, mod in cell.readers().items()}
    else:
        wanted = cell.end_to_end
        values = dict(out.metrics, setup_s=ctx.setup_s)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    ok, checks = judge.verdict(out.numbers, cell.limits)
    if dev.type == "cuda":
        plat = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.chips, "memory_peak_bytes": ctx.memory_peak}
    else:
        plat = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    result = {"correct": bool(ok and out.failed == 0),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": plat}
    if trace and ctx.digest is not None:
        plat["busy_s"] = ctx.digest["busy_s"]
        plat["window_s"] = ctx.digest["window_s"]
        result["breakdown"] = ctx.digest["breakdown"]
    result["checks"] = checks
    for name, v in out.numbers.items():
        if name not in checks:
            print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    a = ap.parse_args(argv)
    t_start = process_start()
    sys.path.insert(0, str(ROOT / "src"))
    from cellbench.bench import Bench
    cell = Bench(a.root).cell(a.workload)
    import torch
    if a.device == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{n} visible", file=sys.stderr)
        return 2
    if a.device == "cuda":
        torch.set_num_threads(4)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      a.device, a.root, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {bad} (jax, jaxlib, flax "
              f"and the JAX package repro are not the system under test)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
