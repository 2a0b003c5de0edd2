"""The fleet controller: the port's ``FleetController`` against the
reference's.

The reference runs in-process on its numpy planner (on this host its jax
backends do not import, so that is its default). With
``batch_backend="numpy"`` the port's ``FleetReport`` is bit-identical to
the reference's: every field under ``==`` but the wall-clock ones, the
span trace included. On the port's ``fused`` backend (the kernels' plain
versions on the CPU) and on ``torch``, every job gets the numpy run's cell
and outcome row, with emissions within 1e-4 relative. Also: the event
loop's cases of ``tests/test_controlplane.py``.
"""
import pytest

import _torch_ref as ref
from repro.core.controlplane import FleetController as RefController
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core.controlplane import FleetController
from repro_torch.core.controlplane.events import (EventLoop, JobArrival,
                                                  StepTick)
from repro_torch.core.scheduler import overlay, planner

# case -> (arrivals from T0 + h, shock at T0 + h, shock hours): the
# reference's shocked run (its re-plan sweeps stay under the batch path's
# 8 jobs), and one whose shock re-plans all 12 queued jobs as one batch
CASES = {"shocked": (10.0, 11.0, 6.0), "queued_shock": (0.0, 2.5, 6.0)}


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


def _ref_run(case, obs=True):
    t_off, at, hours = CASES[case]
    fc = RefController(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                       migration_threshold=250.0, obs=obs)
    fc.submit_many(ref.fleet_jobs(r_planner, ref.heavy_specs(t_off_h=t_off)))
    ref.shock(fc, at, hours)
    return fc.run()


def _port_run(case, backend=None, obs=True):
    t_off, at, hours = CASES[case]
    ftns = ref.make_ftns(overlay, ref.FLEET_FTNS)
    kw = {} if backend is None else {"planner": planner.TorchCarbonPlanner(
        ftns, device="cpu", batch_backend=backend)}
    fc = FleetController(ftns, migration_threshold=250.0, obs=obs,
                         device="cpu", **kw)
    fc.submit_many(ref.fleet_jobs(planner, ref.heavy_specs(t_off_h=t_off)))
    ref.shock(fc, at, hours)
    return fc, fc.run()


@pytest.fixture(scope="module")
def reference():
    return {case: _ref_run(case) for case in CASES}


# --- event loop (tests/test_controlplane.py:28-58) ---------------------------
def test_event_loop_orders_ties_and_cancels():
    loop = EventLoop(t0=0.0)
    a = loop.push(StepTick(t=5.0, job_uuid="a"))
    loop.push(StepTick(t=1.0, job_uuid="b"))
    loop.push(StepTick(t=5.0, job_uuid="c"))     # same t: insertion order
    assert len(loop) == 3
    loop.cancel(a)
    assert len(loop) == 2
    assert loop.pop().job_uuid == "b"
    assert loop.now == 1.0
    assert loop.pop().job_uuid == "c"            # a was cancelled
    assert loop.pop() is None and loop.empty


def test_event_loop_clock_is_monotone():
    loop = EventLoop()
    loop.push(StepTick(t=10.0, job_uuid="x"))
    loop.pop()
    with pytest.raises(ValueError):
        loop.push(StepTick(t=2.0, job_uuid="y"))  # behind the clock
    assert loop.pop_due(5.0) is None              # nothing due


def test_event_loop_pop_due_respects_now():
    loop = EventLoop()
    loop.push(JobArrival(t=3.0, job=None))
    loop.push(JobArrival(t=8.0, job=None))
    assert loop.pop_due(5.0).t == 3.0
    assert loop.pop_due(5.0) is None
    assert len(loop) == 1


# --- the closed loop against the reference -----------------------------------
@pytest.mark.parametrize("obs", [True, None], ids=["obs", "no_obs"])
@pytest.mark.parametrize("case", CASES)
def test_numpy_backend_report_is_bit_identical(reference, case, obs):
    want = reference[case] if obs else _ref_run(case, obs=None)
    fc, got = _port_run(case, backend="numpy", obs=obs)
    ref.assert_reports_identical(got, want)
    assert got.n_completed == got.n_jobs == 12
    assert len(fc.queue) == 0 and fc.events.empty
    assert (len(got.trace) > 0) == bool(obs)


@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_backends_make_the_numpy_decisions(reference, monkeypatch,
                                                  case, backend):
    batches = []
    orig = planner.TorchCarbonPlanner.plan_batch_torch
    monkeypatch.setattr(planner.TorchCarbonPlanner, "plan_batch_torch",
                        lambda self, jobs: batches.append(len(jobs))
                        or orig(self, jobs))
    _, got = _port_run(case, backend=backend)
    ref.assert_same_decisions(got, reference[case])
    # the shocked queue re-plans through the batch path in one call
    assert bool(batches) == (case == "queued_shock")


def test_default_planner_is_fused_on_the_given_device():
    fc = FleetController(ref.make_ftns(overlay, ref.FLEET_FTNS),
                         device="cpu")
    assert fc.planner.batch_backend == "fused"
    assert fc.planner.device.type == "cpu"
    assert fc.queue.planner is fc.planner
    assert fc.engine.model is fc.planner.throughput


def test_shocked_run_adapts_like_the_reference():
    """The acceptance of tests/test_controlplane.py's shocked run, on the
    port's default (fused) controller."""
    fc, rep = _port_run("shocked")
    assert rep.n_completed == rep.n_jobs == 12
    assert rep.migrations >= 1 and rep.replan_events >= 1
    assert len(fc.overlay.events) == rep.migrations
    ev = fc.overlay.events[0]
    assert ev.ci_at_migration > fc.overlay.threshold
    assert ev.from_ftn != ev.to_ftn
    rel = abs(rep.ledger_total_g - rep.total_actual_g) / rep.total_actual_g
    assert rel < 1e-9
    for o in rep.outcomes:
        assert "m1" not in o.ftn_sequence[1:]
        rec = fc._records[o.job_uuid]
        bs = [s.bytes_total for s in rec.ledger.samples]
        assert all(b2 >= b1 for b1, b2 in zip(bs, bs[1:]))
        deadline = rec.job.submitted_t + rec.job.sla.deadline_s
        assert o.sla_miss == (o.completed_t > deadline + 1e-6)
