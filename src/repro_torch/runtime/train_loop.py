"""Fault-tolerant, carbon-aware training loop.

The reference's ``runtime/train_loop.py::Trainer`` on torch. One class
orchestrates the full production story:
  * the train step (``runtime.steps.make_train_step``) on the model's
    device, updating parameters and optimizer state in place
  * carbon-aware data sourcing (pipeline picks greenest replica per shard)
  * atomic checkpoint/restart + carbon-scheduled mirror uploads
  * fault injection -> restore-and-replay; stragglers -> timeout-skip
  * carbon-adaptive cross-pod sync cadence (local-SGD H from live CI)
  * per-step energy/carbon ledger from the power model × site CI
  * elastic: §4.3 job migration to greener sites when the payback test
    passes.

The torch computation is real; fleet-scale aspects (multi-pod wall-clock,
failures) are simulated deterministically through ``cluster.*``, as in the
reference, so the loop's control paths are all exercised and testable on
the CPU. The simulated fleet has ``chips`` chips of ``chip_power_w`` each;
the default power is one NVIDIA H100 SXM's 700 W board limit (data sheet).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.cluster.elastic import ElasticPlanner
from repro_torch.cluster.faults import FaultInjector, StragglerModel
from repro_torch.cluster.topology import Cluster, default_cluster
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.carbon.intensity import PAPER_WINDOW_T0, calibrated_ci
from repro_torch.core.carbon.score import TransferLedger
from repro_torch.core.obs import runtime as obs
from repro_torch.core.scheduler.planner import TorchCarbonPlanner
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import Transformer, build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.localsgd import (CarbonSyncController,
                                        OuterOptState, outer_init)
from repro_torch.runtime.steps import make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    site: str = "site_or"
    chips: int = 512
    chip_power_w: float = 700.0
    step_time_s: float = 30.0          # simulated fleet step time
    start_time: float = PAPER_WINDOW_T0
    carbon_aware: bool = True
    inject_faults: bool = False
    sim_pods: int = 2                  # simulated DP pods for local-SGD
    log_every: int = 10


class Trainer:
    """The model lives on ``device`` (``cuda`` unless given; without a GPU
    that raises): random weights from ``run.seed``, or ``params``, a state
    dict in the port's naming (see :mod:`repro_torch.models.convert`)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig,
                 loop: TrainLoopConfig, *,
                 cluster: Optional[Cluster] = None,
                 batch_override: int = 0, seq_override: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg, self.run, self.loop = cfg, run, loop
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, run)
        self.cluster = cluster or default_cluster()
        self.site = loop.site
        self.t = loop.start_time

        self.batch = batch_override or 8
        self.seq = seq_override or 128
        self.pipeline = TokenPipeline(
            vocab_size=cfg.vocab_size, seq_len=self.seq, batch=self.batch,
            cluster=self.cluster, consumer_site=self.site, seed=run.seed,
            device=self.device)

        self.ckpt = CheckpointManager(
            loop.ckpt_dir, interval_steps=loop.ckpt_every,
            mirror_replicas=tuple(s for s in self.cluster.sites
                                  if s != self.site)[:1])
        self.planner = TorchCarbonPlanner(self.cluster.ftns(),
                                          device=self.device)
        self.elastic = ElasticPlanner(self.cluster,
                                      base_batch=self.batch,
                                      carbon_threshold=run.carbon_threshold)
        pods = [p.name for p in self.cluster.pods][:loop.sim_pods]
        self.faults = FaultInjector(pods, seed=run.seed)
        self.stragglers = StragglerModel(pods, seed=run.seed)
        self.sync_ctl = CarbonSyncController(h_min=max(run.local_sgd_h, 1))

        self.ledger = TransferLedger("train-job")
        self.history: List[Dict[str, Any]] = []
        self.events: List[str] = []
        self._init_state(params)

    # ------------------------------------------------------------- state --
    def _init_state(self, params: Optional[Mapping[str, torch.Tensor]]):
        if params is None:
            self.model = build_model(self.cfg, seed=self.run.seed,
                                     device=self.device)
        else:
            self.model = Transformer(self.cfg, {
                k: v.detach().to(self.device, copy=True)
                for k, v in params.items()})
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.opt = adamw_init(self.params)
        self.start_step = 0
        if self.ckpt.has_checkpoint():
            self.start_step = self._restore()
            self.events.append(f"restored@{self.start_step}")
        self._outer: Optional[OuterOptState] = None

    @property
    def outer(self) -> OuterOptState:
        """The local-SGD outer state (an f32 anchor and momentum, 8 bytes a
        parameter), built from the parameters at its first read. The
        reference builds it with the trainer and never reads it in the
        loop; on one card that would take half again the 16 bytes a
        parameter of weights, gradients and AdamW state."""
        if self._outer is None:
            self._outer = outer_init(self.params)
        return self._outer

    @torch.no_grad()
    def _restore(self) -> int:
        """Parameters, optimizer state (fresh when the checkpoint has none)
        and the pipeline cursor from the latest checkpoint; its step."""
        step, params, opt, extra = self.ckpt.restore_latest(self.params,
                                                            self.opt)
        for k, t in params.items():
            self.params[k].copy_(t)
        self.opt = opt if opt is not None else adamw_init(self.params)
        if extra.get("pipeline"):
            self.pipeline.restore(extra["pipeline"])
        return step

    def _param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.params.values())

    # -------------------------------------------------------------- run ---
    def run_steps(self, n: Optional[int] = None) -> Dict[str, Any]:
        lp = self.loop
        n = n or lp.total_steps
        step = self.start_step
        steps_since_sync = 0
        energy_kwh = 0.0
        emissions_g = 0.0
        dcn_bytes = 0.0
        fault_clock = 0     # monotonic: replayed steps see FRESH fault draws
        while step < n:
            fault_clock += 1
            ci = calibrated_ci(self.cluster.zone_of(self.site), self.t)

            # --- faults: hard failure => restore + replay ---
            if lp.inject_faults:
                evs = self.faults.events_at(fault_clock)
                hard = [e for e in evs if e.kind == "node"]
                if hard and self.ckpt.has_checkpoint():
                    s0 = self._restore()
                    self.events.append(
                        f"fault:{hard[0].pod}@{step}->restored@{s0}")
                    step = s0
                    self.t += hard[0].recover_steps * lp.step_time_s
                    continue

            # --- data (carbon-aware shard sourcing) ---
            with obs.span("train_loop.data"):
                batch = self.pipeline.next_batch(self.t)

            # --- the real computation ---
            with obs.span("train_loop.step_fn"):
                metrics = self.step_fn(self.model, self.opt, batch)

            with obs.span("train_loop.account"):
                # --- simulated fleet time w/ straggler mitigation ---
                t_step, dropped = self.stragglers.effective_step_time(
                    step, base_s=lp.step_time_s)
                if dropped:
                    self.events.append(
                        f"stragglers@{step}:{','.join(dropped)}")
                self.t += t_step

                # --- carbon accounting ---
                kwh = lp.chips * lp.chip_power_w * t_step / 3.6e6
                energy_kwh += kwh
                emissions_g += kwh * ci
                self.ledger.record(self.t, float(step + 1), ci, 0.0)

                # --- carbon-adaptive cross-pod sync (local-SGD) ---
                steps_since_sync += 1
                h = (self.sync_ctl.period(ci) if lp.carbon_aware
                     else self.sync_ctl.h_min)
                if steps_since_sync >= h:
                    factor = {"none": 1.0, "int8": 0.25,
                              "topk": 0.02}[self.run.grad_compression]
                    dcn_bytes += self._param_bytes() * factor
                    steps_since_sync = 0

                # --- checkpoint + carbon-scheduled mirror ---
                if self.ckpt.should_save(step + 1):
                    self.ckpt.save(
                        step + 1, self.params, self.opt,
                        extra={"pipeline": self.pipeline.snapshot()},
                        src_site=self.site, now=self.t)
                    for job in self.ckpt.pending_mirrors:
                        plan = self.planner.plan(job)
                        self.events.append(
                            f"mirror@{step+1}: start+"
                            f"{(plan.start_t - self.t)/3600:.1f}h "
                            f"ci={plan.predicted_avg_ci:.0f} "
                            f"{plan.predicted_emissions_g:.1f}g")
                    self.ckpt.pending_mirrors.clear()

                # --- §4.3 carbon migration of the job itself ---
                if lp.carbon_aware and (step + 1) % 20 == 0:
                    remaining_s = (n - step) * lp.step_time_s
                    plan = self.elastic.carbon_migration(
                        self.site, self.t, float(self._param_bytes()),
                        remaining_s)
                    if plan is not None:
                        self.events.append(f"migrate@{step+1}:{plan.reason}")
                        self.site = self.cluster.site_of(plan.pods[0]).name
                        self.pipeline.consumer_site = self.site

                if (step + 1) % lp.log_every == 0 or step + 1 == n:
                    self.history.append({
                        "step": step + 1,
                        "loss": float(metrics["loss"]),
                        "ci": ci,
                        "site": self.site,
                        "emissions_g": emissions_g,
                        "dcn_gb": dcn_bytes / 1e9,
                    })
            step += 1

        return {
            "final_step": step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "energy_kwh": energy_kwh,
            "emissions_g": emissions_g,
            "emissions_kg": emissions_g / 1e3,
            "dcn_gb": dcn_bytes / 1e9,
            "events": self.events,
            "history": self.history,
            "data_fetches": [dataclasses.asdict(f)
                             for f in self.pipeline.fetches],
        }
