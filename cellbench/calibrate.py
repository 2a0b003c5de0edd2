"""The readings that a cell's limits are set from, on the card, many
seeds in one process (a run's set-up is long):

    python3 -m cellbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control 3 --seconds 6 --out chiprun_out/calibrate.json

For each seed: a run of the cell with a short window and the numbers it
compares (the lower readings). For the first ``--control`` seeds also the
control, the reference in fp8 put in the program's place, and the faults
that the cell can have:

* training: a step that returns its state unchanged (its change reads 1
  by the measure, with no run); half of each batch left out and the mean
  taken over the rest, planted in the reference put in the program's
  place;
* serving: a served token altered where it is produced (the next id), read
  in the reference's logits (the least gap such a token reads).

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stats(gaps) -> dict:
    """Spread of the served tokens' gaps: how many, the share off the
    reference's first choice, the mean and upper quantiles."""
    import numpy as np
    g = np.array([v for row in gaps for v in row])
    return {"n": int(g.size), "off_first": float((g > 0).mean()),
            "mean": float(g.mean()), "p90": float(np.quantile(g, 0.9)),
            "p99": float(np.quantile(g, 0.99)), "max": float(g.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from cellbench import judge
    from cellbench.bench import Bench
    from cellbench.drivers import Ctx, driver
    from cellbench.drivers.serve import batch_of, sample
    from cellbench.reference import decoder as R
    from cellbench.reference import family
    from cellbench.run import model_config, process_start
    from repro_torch.configs.base import RunConfig

    cell = Bench(a.root).cell(a.workload)
    dev = torch.device(a.device)
    cfg = model_config(cell)
    m = cell.model_fields()
    kinds = family(m["family"]).kinds(m)
    records = []
    for n, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = RunConfig(arch=cfg.name, seed=seed, **cell.run_fields())
        ctx = Ctx(cell=cell, cfg=cfg, run=run, seed=seed, seconds=a.seconds,
                  trace=False, device=dev, t_start=process_start())
        out = driver(cell.kind).run(ctx)
        rec = {"seed": seed, "numbers": out.numbers, "metrics": out.metrics,
               "setup_s": ctx.setup_s, "failed": out.failed,
               "memory_peak": ctx.memory_peak}
        x = out.extra
        if n < a.control and cell.kind == "train":
            rec["control"] = judge.train_numbers(
                R.train_follow(x["weights"], m, kinds, cell.run_fields(),
                               x["batches"], precision="fp8"),
                x["reference"])
            half = [(t[: t.shape[0] // 2], g[: g.shape[0] // 2])
                    for t, g in x["batches"]]
            rec["fault_half_batch"] = judge.train_numbers(
                R.train_follow(x["weights"], m, kinds, cell.run_fields(),
                               half), x["reference"])
            rec["fault_unchanged"] = {"change": 1.0}
        elif n < a.control and cell.kind == "serve":
            gaps8, alt = [], []
            V = m["vocab_size"]
            for e in sample(x["epochs"], x["reqs"], x["served"], seed,
                            int(cell.limits["sample_tokens"])):
                prompts, rows = batch_of(x["epochs"][e], x["reqs"],
                                         x["served"], int(cell.traffic[
                                             "clients"]), dev)
                ref = R.serve_follow(x["weights"], m, kinds, prompts, rows)
                gaps8 += R.serve_follow(x["weights"], m, kinds, prompts,
                                        rows, precision="fp8",
                                        judge=ref)["gaps"]
                for t, lg in enumerate(ref["logits"]):
                    for j, row in enumerate(rows):
                        if t < len(row):
                            bad = (row[t] + 1) % V
                            alt.append(float((lg[j].max() - lg[j, bad])
                                             / lg[j].std()))
                del ref
            rec["control"] = judge.serve_numbers(gaps8)
            rec["control_stats"] = stats(gaps8)
            rec["altered_token_gap_min"] = min(alt)
        if cell.kind == "serve":
            rec["stats"] = stats(x["gaps"])
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        records.append(rec)
        del out, x
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
