"""The data-movement engine the scheduler drives.

Simulated discrete-time chunked transfers with the application parameters
of Table 1 (buffer size, parallelism, concurrency, pipelining) and
checkpointable offsets so an overlay migration can resume the remaining
bytes elsewhere [§4.3].

The engine is a *resumable stepper*: :meth:`TransferEngine.step` advances
one transfer by one (possibly pro-rated) time step and returns a
:class:`StepObs` — no internal while loop, no ledger/Pmeter wiring, so the
fleet control plane (``core.controlplane``) can interleave thousands of
transfers on one event clock. :meth:`TransferEngine.run` is the standalone
wrapper that keeps the old run-to-completion behaviour (CI sampling into a
``TransferLedger``, Pmeter telemetry on both end systems, ``on_step``
pause hook); :meth:`TransferEngine.run_reference` is the monolithic scalar
loop kept as the equivalence oracle for the step-composed fast path.

Per-step congestion comes from a trace hashed once per (src, dst) window
(the same ``_NoiseTable`` design as the carbon field) rather than a
blake2b call per step; the final step is pro-rated so a transfer that
finishes mid-step does not overshoot its wall clock (which would skew the
``achieved`` gbps fed back to ``ThroughputModel.observe`` and the ledger
timestamps by up to ``dt_s``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.carbon.field import (CarbonField, _NoiseTable,
                                           default_field)
from repro_torch.core.carbon.path import NetworkPath, discover_path
from repro_torch.core.carbon.score import TransferLedger
from repro_torch.core.carbon.telemetry import Pmeter, TransferMetrics
from repro_torch.core.transfer.throughput import ThroughputModel


@dataclasses.dataclass
class TransferState:
    job_uuid: str
    src: str
    dst: str
    size_bytes: float
    bytes_done: float = 0.0
    bytes_at_start: float = 0.0        # resume offset (excluded from gbps)
    t_started: float = 0.0
    t_now: float = 0.0
    parallelism: int = 4
    concurrency: int = 2
    pipelining: int = 4
    buffer_size: int = 1 << 26
    finished: bool = False
    chunks_acked: int = 0
    # feed ThroughputModel.observe on completion. A caller that throttles
    # the transfer below the path's own capacity (e.g. an FTN NIC cap on a
    # fat link) must clear this: the achieved rate then says nothing about
    # the (src, dst) pair and would poison the learned correction.
    observe_on_finish: bool = True

    @property
    def remaining(self) -> float:
        return max(self.size_bytes - self.bytes_done, 0.0)

    def checkpoint(self) -> Dict:
        """Resume token for migration (offset-based, like GridFTP restart
        markers)."""
        return {"job_uuid": self.job_uuid, "offset": self.bytes_done,
                "chunks_acked": self.chunks_acked}


@dataclasses.dataclass(frozen=True)
class StepObs:
    """What one engine step observed — the controller's raw material for
    ledger records, telemetry, emission accounting and migration checks."""
    t0: float                  # step start (sim time)
    t1: float                  # step end; t1 - t0 < dt_s on the final step
    step_s: float
    gbps: float
    bytes_delta: float
    finished: bool


class TransferEngine:
    """Discrete-time stepper; throughput varies per-step with a seeded
    congestion band and feeds back into the ThroughputModel's history."""

    def __init__(self, model: Optional[ThroughputModel] = None,
                 dt_s: float = 60.0,
                 src_profile: str = "storage_frontend",
                 dst_profile: str = "tpu_host",
                 field: Optional[CarbonField] = None):
        self.model = model or ThroughputModel()
        self.dt_s = dt_s
        self.src_profile = src_profile
        self.dst_profile = dst_profile
        self.field = field or default_field()
        # one hash per (src:dst, window) ever — the per-query blake2b the
        # carbon field removed from planning, removed from execution too
        self._congestion_trace = _NoiseTable("{k}:{h}")

    def _congestion(self, st: TransferState, t: float) -> float:
        u = self._congestion_trace.lookup_scalar(
            f"{st.src}:{st.dst}", int(t // self.dt_s))
        return 0.80 + 0.35 * u          # [0.80, 1.15)

    @staticmethod
    def _congestion_reference(st: TransferState, t: float,
                              dt_s: float) -> float:
        """The seed's per-step blake2b formula (oracle for the trace)."""
        h = hashlib.blake2b(f"{st.src}:{st.dst}:{int(t // dt_s)}".encode(),
                            digest_size=8).digest()
        u = int.from_bytes(h, "big") / 2**64
        return 0.80 + 0.35 * u

    def start(self, job_uuid: str, src: str, dst: str, size_bytes: float,
              t0: float, *, parallelism: int = 4, concurrency: int = 2,
              pipelining: int = 4, observe: bool = True,
              resume: Optional[Dict] = None) -> TransferState:
        st = TransferState(job_uuid=job_uuid, src=src, dst=dst,
                           size_bytes=size_bytes, t_started=t0, t_now=t0,
                           parallelism=parallelism, concurrency=concurrency,
                           pipelining=pipelining, observe_on_finish=observe)
        if resume:
            st.bytes_done = resume["offset"]
            st.bytes_at_start = resume["offset"]
            st.chunks_acked = resume["chunks_acked"]
        # warm the congestion trace for the expected window in one hash pass
        base = self.model.predict(src, dst, parallelism, concurrency)
        n = int(st.remaining * 8.0 / (base * 1e9) / self.dt_s) + 2
        idx0 = int(t0 // self.dt_s)
        self._congestion_trace.lookup(
            f"{src}:{dst}", idx0 + np.arange(min(n, 4096)))
        return st

    def step(self, st: TransferState, dt_s: Optional[float] = None, *,
             path: Optional[NetworkPath] = None,
             base_gbps: Optional[float] = None) -> StepObs:
        """Advance one step (pure mechanics — no ledger/telemetry side
        effects except the throughput model's completion observation).

        ``path``/``base_gbps`` let a caller that steps many transfers cache
        the route and base prediction instead of re-deriving them per step;
        the final step is pro-rated to the exact completion instant.
        """
        dt = self.dt_s if dt_s is None else dt_s
        if st.finished:
            return StepObs(st.t_now, st.t_now, 0.0, 0.0, 0.0, True)
        if path is None:
            path = discover_path(st.src, st.dst)
        if base_gbps is None:
            base_gbps = self.model.predict(st.src, st.dst, st.parallelism,
                                           st.concurrency)
        gbps = base_gbps * self._congestion(st, st.t_now)
        # pipelining hides per-chunk latency; without it small chunks
        # pay an RTT per chunk (cf. [60])
        if st.pipelining <= 1:
            gbps *= 1.0 / (1.0 + path.hops[-1].rtt_ms / 50.0)
        rate_bps = gbps * 1e9 / 8.0
        step_bytes = rate_bps * dt
        step_s = dt
        if step_bytes >= st.remaining:
            # pro-rate the partial final step to the completion instant
            step_bytes = st.remaining
            step_s = step_bytes / rate_bps if rate_bps > 0 else 0.0
        t0 = st.t_now
        st.bytes_done = min(st.bytes_done + step_bytes, st.size_bytes)
        st.chunks_acked = int(st.bytes_done // st.buffer_size)
        st.t_now += step_s
        if st.bytes_done >= st.size_bytes:
            st.finished = True
            if st.observe_on_finish:
                achieved = ((st.bytes_done - st.bytes_at_start) * 8.0 / 1e9
                            / max(st.t_now - st.t_started, 1e-9))
                self.model.observe(st.src, st.dst, st.parallelism,
                                   st.concurrency, achieved)
        return StepObs(t0=t0, t1=st.t_now, step_s=step_s, gbps=gbps,
                       bytes_delta=step_bytes, finished=st.finished)

    def run(self, st: TransferState, *, until: Optional[float] = None,
            ledger: Optional[TransferLedger] = None,
            pmeter_src: Optional[Pmeter] = None,
            pmeter_dst: Optional[Pmeter] = None,
            on_step: Optional[Callable[[TransferState, float], bool]] = None
            ) -> TransferState:
        """Advance until done (or ``until``); ``on_step(state, ci)`` may
        return False to pause (e.g. the overlay scheduler wants to migrate).

        This is the standalone run-to-completion path: a loop over
        :meth:`step` plus the observation wiring (CI sampling, ledger,
        Pmeter) that the fleet controller does itself.
        """
        path = discover_path(st.src, st.dst)
        base = self.model.predict(st.src, st.dst, st.parallelism,
                                  st.concurrency)
        while not st.finished and (until is None or st.t_now < until):
            obs = self.step(st, path=path, base_gbps=base)
            ci = float(self.field.path_ci(path, st.t_now))
            if ledger is not None:
                ledger.record(st.t_now, st.bytes_done, ci, obs.gbps)
            self._emit_pmeter(st, path, obs.gbps, pmeter_src, pmeter_dst)
            if on_step is not None and not on_step(st, ci):
                break
        return st

    def run_reference(self, st: TransferState, *,
                      until: Optional[float] = None,
                      ledger: Optional[TransferLedger] = None,
                      pmeter_src: Optional[Pmeter] = None,
                      pmeter_dst: Optional[Pmeter] = None,
                      on_step: Optional[Callable[[TransferState, float],
                                                 bool]] = None
                      ) -> TransferState:
        """Monolithic scalar loop (per-step blake2b congestion, scalar
        ``path.ci``) kept as the oracle the step-composed :meth:`run` is
        pinned to — same pro-rated final step, same observation order."""
        path = discover_path(st.src, st.dst)
        base = self.model.predict(st.src, st.dst, st.parallelism,
                                  st.concurrency)
        while not st.finished and (until is None or st.t_now < until):
            gbps = base * self._congestion_reference(st, st.t_now, self.dt_s)
            if st.pipelining <= 1:
                gbps *= 1.0 / (1.0 + path.hops[-1].rtt_ms / 50.0)
            rate_bps = gbps * 1e9 / 8.0
            step_bytes, step_s = rate_bps * self.dt_s, self.dt_s
            if step_bytes >= st.remaining:
                step_bytes = st.remaining
                step_s = step_bytes / rate_bps if rate_bps > 0 else 0.0
            st.bytes_done = min(st.bytes_done + step_bytes, st.size_bytes)
            st.chunks_acked = int(st.bytes_done // st.buffer_size)
            st.t_now += step_s
            ci = path.ci(st.t_now)
            if ledger is not None:
                ledger.record(st.t_now, st.bytes_done, ci, gbps)
            self._emit_pmeter(st, path, gbps, pmeter_src, pmeter_dst)
            if st.bytes_done >= st.size_bytes:
                st.finished = True
                if st.observe_on_finish:
                    achieved = ((st.bytes_done - st.bytes_at_start) * 8.0
                                / 1e9
                                / max(st.t_now - st.t_started, 1e-9))
                    self.model.observe(st.src, st.dst, st.parallelism,
                                       st.concurrency, achieved)
            if on_step is not None and not on_step(st, ci):
                break
        return st

    def _emit_pmeter(self, st: TransferState, path: NetworkPath, gbps: float,
                     pmeter_src: Optional[Pmeter],
                     pmeter_dst: Optional[Pmeter]) -> None:
        if pmeter_src is None and pmeter_dst is None:
            return
        tm = TransferMetrics(
            job_uuid=st.job_uuid, source_latency_ms=path.hops[0].rtt_ms,
            job_size_bytes=int(st.size_bytes),
            transfer_node_id=st.dst, buffer_size=st.buffer_size,
            parallelism=st.parallelism, concurrency=st.concurrency,
            pipelining=st.pipelining,
            bytes_received=int(st.bytes_done), bytes_sent=int(st.bytes_done))
        if pmeter_src is not None:
            pmeter_src.measure(st.t_now, cpu_util=0.1 + 0.04 * st.parallelism,
                               mem_util=0.3, tx_gbps=gbps, rx_gbps=0.0,
                               transfer=tm)
        if pmeter_dst is not None:
            pmeter_dst.measure(st.t_now, cpu_util=0.1 + 0.04 * st.parallelism,
                               mem_util=0.3, tx_gbps=0.0, rx_gbps=gbps,
                               rtt_dst_ms=path.hops[-1].rtt_ms,
                               transfer=tm)
