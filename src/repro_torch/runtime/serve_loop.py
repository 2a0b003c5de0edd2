"""Carbon-aware serving runtime: batched request queue + prefill/decode
loop + per-request carbon accounting + carbon-aware placement.

Serving is latency-bound, so the paper's TIME lever doesn't apply to the
requests themselves — but SPACE/OVERLAY do: the placement policy routes
the serving job to the greenest site with capacity (re-evaluated each
epoch), and KV-cache/model-weight movement for placement changes is bulk
traffic handed to the carbon planner, like any other transfer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.cluster.topology import Cluster, default_cluster
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0, calibrated_ci
from repro_torch.core.obs import runtime as obs
from repro_torch.models.layers import check_attn_impl
from repro_torch.models.model import (Transformer, build_model, decode_step,
                                      prefill)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor           # [S] integer token ids
    max_new_tokens: int
    submitted_t: float = 0.0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]
    latency_s: float
    emissions_mg: float
    site: str


# Families the Server serves: text prompts in, tokens out. A ``vlm`` is
# served text only, as the reference's Server passes only ``{"tokens"}``;
# an ``encdec`` model needs audio frames, which neither Server has.
SERVED_FAMILIES = ("dense", "ssm", "vlm", "moe", "hybrid")


def pick_site(cluster: Cluster, t: float) -> str:
    """Space/overlay lever for serving: greenest site hosts the replicas."""
    return min(cluster.sites.values(),
               key=lambda s: calibrated_ci(s.zone, t)).name


class Server:
    """Static-batch serving loop (continuous batching is a straightforward
    extension of the same cache layout — slots are per-sequence).

    ``run`` defaults to the kernel path (``attn_impl="flash"``). The model
    lives on ``device`` (``cuda`` unless given; without a GPU that
    raises): random weights from ``run.seed``, or ``params``, a state dict
    in the port's naming (see :mod:`repro_torch.models.convert`). Energy is
    ``chip_count * chip_power_w * wall time``; the defaults are one NVIDIA
    H100 SXM at its 700 W board limit (data sheet). It serves the
    :data:`SERVED_FAMILIES` (else ``ValueError``).
    """

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None, *,
                 batch: int = 4, s_max: int = 128,
                 cluster: Optional[Cluster] = None,
                 chip_count: int = 1, chip_power_w: float = 700.0,
                 now: float = PAPER_WINDOW_T0,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        if cfg.family not in SERVED_FAMILIES:
            raise ValueError(f"Server serves the {SERVED_FAMILIES} families "
                             f"from text prompts; {cfg.name} is "
                             f"{cfg.family!r}")
        self.run = run or RunConfig(arch=cfg.name, attn_impl="flash",
                                    remat="none")
        check_attn_impl(self.run.attn_impl)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch, self.s_max = batch, s_max
        self.cluster = cluster or default_cluster()
        self.now = now
        self.site = pick_site(self.cluster, now)
        self.chip_count, self.chip_power_w = chip_count, chip_power_w
        if params is None:
            self.model = build_model(cfg, seed=self.run.seed,
                                     device=self.device)
        else:
            self.model = Transformer(cfg, {k: v.to(self.device)
                                           for k, v in params.items()})
        self.queue: List[Request] = []
        self.completions: List[Completion] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _ci(self) -> float:
        return calibrated_ci(self.cluster.zone_of(self.site), self.now)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_epoch(self) -> List[Completion]:
        """Serve one static batch from the queue. Shorter prompts are
        right-padded with token 0 and decoding starts after the longest
        one, as in the reference. The padded prompt length of a model with
        Mamba-2 layers (``ssm``, ``hybrid``) must be a multiple of its
        scan chunk, as the reference asserts (else ``ValueError``, the
        batch left in the queue)."""
        if not self.queue:
            return []
        batch_reqs = self.queue[:self.batch]
        S = max(r.prompt.shape[0] for r in batch_reqs)
        with obs.span("serve_loop.epoch", rids=[r.rid for r in batch_reqs],
                      padded_len=S, rows=self.batch):
            return self._epoch(batch_reqs, S)

    def _epoch(self, batch_reqs: List[Request], S: int) -> List[Completion]:
        with obs.span("serve_loop.batch"):
            ssm = self.cfg.ssm
            if self.cfg.family in ("ssm", "hybrid") and S % ssm.chunk_size:
                raise ValueError(f"{self.cfg.name} prefills whole scan "
                                 f"chunks: prompt length {S} is not a "
                                 f"multiple of {ssm.chunk_size}")
            self.queue = self.queue[self.batch:]
            # re-evaluate placement each epoch (overlay lever)
            self.site = pick_site(self.cluster, self.now)

            n = len(batch_reqs)
            prompts = torch.stack([F.pad(r.prompt.to(torch.int64),
                                         (0, S - r.prompt.shape[0]))
                                   for r in batch_reqs])
            if n < self.batch:
                prompts = F.pad(prompts, (0, 0, 0, self.batch - n))
            prompts = prompts.to(self.device)
            self._sync()
        t0 = time.perf_counter()
        with obs.span("serve_loop.prefill"):
            logits, cache = prefill(self.model, self.run, prompts,
                                    self.s_max)
            tok = torch.argmax(logits, -1)[:, None]
        out_tokens = [tok]
        max_new = max(r.max_new_tokens for r in batch_reqs)
        for i in range(max_new - 1):
            with obs.span("serve_loop.decode"):
                logits, cache = decode_step(self.model, self.run, tok,
                                            cache, S + i)
                tok = torch.argmax(logits, -1)[:, None]
            out_tokens.append(tok)
        with obs.span("serve_loop.collect"):
            toks = torch.cat(out_tokens, dim=1).cpu()
            self._sync()
        dt = time.perf_counter() - t0

        with obs.span("serve_loop.account"):
            self.now += dt
            kwh = self.chip_count * self.chip_power_w * dt / 3.6e6
            mg_total = kwh * self._ci() * 1e3
            done = []
            for j, r in enumerate(batch_reqs):
                done.append(Completion(
                    rid=r.rid,
                    tokens=toks[j, :r.max_new_tokens].tolist(),
                    latency_s=dt,
                    emissions_mg=mg_total / max(n, 1),
                    site=self.site))
            self.completions.extend(done)
        return done
