#!/usr/bin/env python3
"""Time the port's flash-attention and SSD kernels at the main path's
shapes, on one GPU, for any checkout of the port.

    python3 scripts/time_port_kernels.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), builds its flash and SSD kernels, holds each against its plain
version and times it with ``chip_smoke.py``'s own checks (gemma3-12b's
prefill shapes: global, window 1024 and ragged; mamba2-370m's training
shapes), and prints one JSON line per check, the device time of one
call of each by kernel name (``torch.profiler``) and a summary line. Pointing
``--src`` at an unpacked earlier commit times that commit's kernels with
the same code, so two versions are compared on one card in one run:
parent, change, change, parent. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def device_split(fa, ssd, cfg, tcfg, cs) -> dict:
    """Device time by kernel name (``torch.profiler``) of one flash call
    (global case) and one SSD call at the main path's shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v = (torch.randn((cs.SERVE_BATCH, cs.PROMPT_LEN, h, cfg.head_dim),
                           generator=gen, device="cuda").to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    ins = cs.ssd_training_inputs(tcfg, gen)
    out = {}
    for name, fn in (("flash_global", lambda: fa.flash_attention(q, k, v)),
                     ("ssd", lambda: ssd.ssd_scan(*ins,
                                                  tcfg.ssm.chunk_size))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = {e.key[:60]: e.self_device_time_total / 1e3
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not from {src}")
    from repro_torch._build import build
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    card = cs.gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build(fa._SOURCE, ssd._SOURCE)
    build_s = time.perf_counter() - t0
    for _, log in built.values():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print("ptxas:", line.strip(), flush=True)
    f_use = cs.ptxas_usage(built[fa._SOURCE.name][1], cs.FLASH_KERNEL)
    s_use = cs.ptxas_usage(built[ssd._SOURCE.name][1], cs.SSD_KERNEL_PREFIX)
    flash = cs.check_flash(fa, get_config(cs.ARCH), f_use or None)
    ssd_case = cs.check_ssd(ssd, get_config(cs.TRAIN_ARCH), s_use or None)
    split = device_split(fa, ssd, get_config(cs.ARCH),
                         get_config(cs.TRAIN_ARCH), cs)
    cs.emit({"device_ms_by_kernel": split})
    cs.emit({"label": args.label, "src": str(src), "card": card,
             "build_s": build_s,
             "flash_ms": {c["case"]: c["ms"] for c in flash},
             "sdpa_ms": {c["case"]: c["library_ms"] for c in flash},
             "ssd_ms": ssd_case["ms"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
