"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --steps 200 [--full] [--seq 2048 --batch 8] [--device cpu] \
        [--no-carbon] [--faults] [--compression int8]

Trains the reduced config unless ``--full`` asks for the real widths and
depth; runs on ``cuda`` unless ``--device cpu``, on the port's kernel
path (``--attn-impl flash``) unless told otherwise. The port's ``Trainer``
trains the ``dense``, ``ssm``, ``moe`` and ``hybrid`` families (the
reference's cannot feed ``encdec`` frames or ``vlm`` patches either).
``--full`` on the card first checks that the weights, their gradients and
the AdamW state fit the card's free memory, and raises before allocating
anything if they do not (jamba-v0.1-52b, arctic-480b and kimi-k2 do not
fit one 80 GB card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from repro_torch._device import require_free, resolve_device
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import ATTN_IMPLS
from repro_torch.models.params import count_params, torch_dtype
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

TRAIN_ARCHS = tuple(a for a in ARCHS
                    if get_config(a).family in ("dense", "ssm", "moe",
                                                "hybrid"))


def train_state_bytes(cfg: ModelConfig) -> int:
    """Bytes of the weights, their gradients and the AdamW state (an f32
    master copy and two f32 moments) of ``cfg``."""
    return count_params(cfg) * (2 * torch_dtype(cfg.dtype).itemsize + 12)


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise ``MemoryError`` if ``cfg``'s training state exceeds the free
    memory of ``device`` (a CUDA device; the CPU is not checked)."""
    require_free(device, train_state_bytes(cfg),
                 f"{cfg.name}'s weights, gradients and AdamW state")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=TRAIN_ARCHS, default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="train the full-size config, not the reduced one")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--site", default="site_or")
    ap.add_argument("--no-carbon", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--compression", default="int8",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--attn-impl", default="flash", choices=ATTN_IMPLS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(
        args.arch, layers=4, d_model=128, vocab=1024)
    device = resolve_device(args.device)
    check_fits(cfg, device)
    run = RunConfig(arch=args.arch, attn_impl=args.attn_impl, remat="block",
                    grad_compression=args.compression, lr=args.lr,
                    warmup_steps=max(args.steps // 10, 5),
                    total_steps=args.steps)
    loop = TrainLoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every or max(args.steps // 5, 10),
        ckpt_dir=args.ckpt_dir, site=args.site,
        carbon_aware=not args.no_carbon, inject_faults=args.faults,
        log_every=max(args.steps // 20, 5))
    tr = Trainer(cfg, run, loop, batch_override=args.batch,
                 seq_override=args.seq, device=device)
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {tr.device} at {tr.site}")
    out = tr.run_steps()
    print(f"final loss {out['final_loss']:.4f} | "
          f"{out['emissions_kg']:.2f} kgCO2 | DCN {out['dcn_gb']:.3f} GB | "
          f"{len(out['events'])} events")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
