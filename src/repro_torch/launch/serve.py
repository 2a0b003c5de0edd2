"""Serving launcher: carbon-aware placement + batched static-batch serving
on the port's flash-attention kernel path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --requests 8 --prompt-len 32 --max-new 16 [--full] [--device cpu]

Serves the reduced config unless ``--full`` asks for the real widths and
depth; runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ARCHS, ShapeConfig, get_config, get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.models.model import make_batch
from repro_torch.runtime.serve_loop import Request, Server

DENSE_ARCHS = tuple(a for a in ARCHS if get_config(a).family == "dense")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=DENSE_ARCHS, default="gemma3-12b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size config, not the reduced one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    run = RunConfig(arch=args.arch, attn_impl="flash", remat="none")
    srv = Server(cfg, run, batch=args.batch,
                 s_max=args.prompt_len + args.max_new, device=args.device)
    print(f"serving {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {srv.device} at {srv.site}")
    prompts = make_batch(cfg, ShapeConfig("serve", args.prompt_len,
                                          args.requests, "prefill"),
                         torch.Generator().manual_seed(0))["tokens"]
    for i in range(args.requests):
        srv.submit(Request(rid=i, prompt=prompts[i],
                           max_new_tokens=args.max_new))
    while srv.queue:
        for c in srv.step_epoch():
            print(f"  req {c.rid}: {len(c.tokens)} tokens in "
                  f"{c.latency_s:.2f}s, {c.emissions_mg:.3f} mgCO2 "
                  f"@ {c.site}")
    n = len(srv.completions)
    print(f"served {n} requests")
    return 0


if __name__ == "__main__":
    sys.exit(main())
