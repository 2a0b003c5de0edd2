"""Serving launcher: carbon-aware placement + batched static-batch serving
on the port's flash-attention kernel path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --requests 8 --prompt-len 32 --max-new 16 [--full] [--device cpu]

Serves the reduced config unless ``--full`` asks for the real widths and
depth; runs on ``cuda`` unless ``--device cpu``. Any architecture of a
family the ``Server`` serves (dense, ssm, vlm text-only, moe, hybrid); a
model with Mamba-2 layers takes prompts of one scan chunk by default, as
its prefill takes whole chunks. ``--full`` on the card first checks that
the weights fit the card's free memory, and raises before allocating
anything if they do not (jamba-v0.1-52b, arctic-480b and kimi-k2 do not
fit one 80 GB card whole).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch._device import require_free, resolve_device
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.params import count_params, torch_dtype
from repro_torch.runtime.serve_loop import SERVED_FAMILIES, Request, Server

SERVED_ARCHS = tuple(a for a in ARCHS
                     if get_config(a).family in SERVED_FAMILIES)


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise ``MemoryError`` if ``cfg``'s weights exceed the free memory
    of ``device`` (a CUDA device; the CPU is not checked)."""
    require_free(device, count_params(cfg) * torch_dtype(cfg.dtype).itemsize,
                 f"{cfg.name}'s {cfg.dtype} weights")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCHS, default="gemma3-12b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 32, or an SSM's scan chunk")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size config, not the reduced one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    prompt_len = args.prompt_len or (
        cfg.ssm.chunk_size if cfg.family in ("ssm", "hybrid") else 32)
    device = resolve_device(args.device)
    check_fits(cfg, device)
    run = RunConfig(arch=args.arch, attn_impl="flash", remat="none")
    srv = Server(cfg, run, batch=args.batch,
                 s_max=prompt_len + args.max_new, device=device)
    print(f"serving {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {srv.device} at {srv.site}")
    # token ids as make_batch draws them (the reference's range)
    prompts = torch.randint(0, min(cfg.vocab_size, 255),
                            (args.requests, prompt_len),
                            generator=torch.Generator().manual_seed(0))
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
