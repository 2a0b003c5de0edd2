"""The sharded fleet: the port's ``ShardedFleet`` against the reference's.

Both sides run ``tests/test_sharded.py``'s 3-shard, 12-job shocked day
in-process. With the numpy batch and shard backends the merged
``FleetReport`` is bit-identical (trace and metrics without their wall
series included); on ``fused`` (the kernels' plain versions on the CPU)
and ``torch`` every job gets the numpy run's cell and outcome row,
emissions within 1e-4. Partitioning is the reference's shard for shard.
Worker processes are held to the reference in ``test_torch_parallel.py``.
"""
from types import SimpleNamespace

import pytest

import _torch_ref as ref
from repro.core.controlplane import sharded as r_sharded
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core.controlplane import sharded
from repro_torch.core.scheduler import overlay, planner


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


def _ref_fleet(n_shards=3, **kw):
    return r_sharded.ShardedFleet(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                                  n_shards=n_shards,
                                  migration_threshold=250.0, **kw)


def _port_fleet(n_shards=3, **kw):
    return sharded.ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                                n_shards=n_shards, migration_threshold=250.0,
                                device="cpu", **kw)


def _day(fleet, planner_mod, specs=None):
    fleet.submit_many(ref.fleet_jobs(planner_mod,
                                     specs or ref.sharded_specs()))
    ref.shock(fleet)
    return fleet.run()


@pytest.fixture(scope="module")
def reference():
    return _day(_ref_fleet(obs=True), r_planner)


@pytest.mark.parametrize("obs", [True, None], ids=["obs", "no_obs"])
def test_numpy_backend_merge_is_bit_identical(reference, obs):
    want = reference if obs else _day(_ref_fleet(), r_planner)
    fleet = _port_fleet(batch_backend="numpy", obs=obs)
    got = _day(fleet, planner)
    ref.assert_reports_identical(got, want)
    assert got.n_jobs == got.n_completed == 12
    assert sum(r.n_jobs for r in fleet.shard_reports) == 12
    rel = abs(got.ledger_total_g - got.total_actual_g) / got.total_actual_g
    assert rel < 1e-9


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_kernel_backends_make_the_numpy_decisions(reference, backend):
    fleet = _port_fleet(batch_backend=backend, obs=True)
    assert fleet.shard_backend == backend
    got = _day(fleet, planner)
    # admission planned the whole window through the batch path
    assert fleet.planner.last_batch_cells > 12
    ref.assert_same_decisions(got, reference)
    # the spans differ only in what the backend captured (greedy_g, the
    # admission span's cell count), never in kind, job or instant
    assert [sp[:4] for sp in got.trace] == \
        [sp[:4] for sp in reference.trace]


def test_default_backend_is_fused_for_admission_and_shards():
    fleet = _port_fleet()
    assert fleet.planner.batch_backend == "fused"
    assert fleet.shard_backend == "fused"
    assert all(c.planner.batch_backend == "fused"
               and c.planner.device.type == "cpu"
               and c.field is fleet.field for c in fleet.controllers)
    assert fleet.n_shards == 3 and fleet.parallel == "off"


def test_shard_of_is_the_references_for_1000_uuids():
    jobs = [planner.TransferJob(f"job-{i:05d}-{i * 7919 % 1000}", 1e9,
                                (("uc", "site_ne", "site_or")[i % 3],),
                                "tacc", planner.SLA(deadline_s=3600.0),
                                ref.T0) for i in range(1000)]
    rjobs = [r_planner.TransferJob(j.uuid, j.size_bytes, j.replicas, j.dst,
                                   r_planner.SLA(deadline_s=3600.0),
                                   j.submitted_t) for j in jobs]
    for n in (3, 4):
        for part in ("hash", "source"):
            got = _port_fleet(n, partition=part).shard_of
            want = _ref_fleet(n, partition=part).shard_of
            assert [got(j) for j in jobs] == [want(j) for j in rjobs]
        assert [sharded._stable_hash(j.uuid) % n for j in jobs] == \
            [r_sharded._stable_hash(j.uuid) % n for j in jobs]
    got = _port_fleet(partition=lambda j: len(j.uuid)).shard_of(jobs[0])
    assert got == len(jobs[0].uuid) % 3


@pytest.mark.parametrize("mode", ["fork", "spawn", "auto"])
def test_worker_engines_are_not_ported(mode):
    """Named when the worker engines raised NotImplementedError; they are
    ported now (tests/test_torch_parallel.py runs them). Each mode builds
    its worker runner lazily, starting no process until the first shard
    command; a fork fleet's shards default to the numpy oracle on the
    CPU, as the reference's do."""
    start = "spawn" if mode == "spawn" else "fork"
    with _port_fleet(parallel=mode) as fleet:
        assert fleet.parallel == start
        assert fleet._runner is not None and not fleet._runner.started
        assert fleet.shard_backend == ("fused" if start == "spawn"
                                       else "numpy")
        assert fleet.degradations == ()


def test_bad_arguments_are_refused_like_the_reference():
    with pytest.raises(ValueError, match="parallel"):
        _port_fleet(parallel="threads")
    with pytest.raises(ValueError, match="partition"):
        _port_fleet(partition="zone")
    with pytest.raises(ValueError, match="n_shards"):
        _port_fleet(0)
    with pytest.raises(ValueError, match="obs"):
        from repro_torch.core.obs import FleetObserver
        _port_fleet(obs=FleetObserver())


@pytest.mark.parametrize("quanta", [None, (3600.0, 300.0, 900.0),
                                    (7200.0, 600.0, 0.0)],
                         ids=["one_quantum", "fine_band", "no_band"])
def test_pump_all_then_run_is_the_references(quanta):
    """Pumping in quanta (the streaming gateway's drive) and then draining
    gives the reference's merged report bit for bit."""
    def drive(fleet, planner_mod, q):
        fleet.submit_many(ref.fleet_jobs(planner_mod, ref.sharded_specs(9)))
        ref.shock(fleet)
        n = [fleet.pump_all(ref.T0 + k * 3 * 3600.0, quanta=q,
                            boundaries=(ref.T0 + 4000.0,))
             for k in range(1, 4)]
        return n, fleet.run()

    q = quanta and r_sharded.PumpQuanta(*quanta)
    n_want, want = drive(_ref_fleet(batch_backend="numpy", obs=True),
                         r_planner, q)
    q = quanta and sharded.PumpQuanta(*quanta)
    n_got, got = drive(_port_fleet(batch_backend="numpy", obs=True),
                       planner, q)
    assert n_got == n_want and sum(n_got) > 0
    ref.assert_reports_identical(got, want)


@pytest.mark.parametrize("args", [
    (0.0, 10000.0, (), (3600.0, 300.0, 900.0)),
    (0.0, 10000.0, (5000.0, 5100.0), (3600.0, 300.0, 900.0)),
    (100.0, 90000.0, (400.0, 30000.0, 89999.0), (7200.0, 600.0, 1800.0)),
    (5.0, 5.0, (), (3600.0, 300.0, 900.0)),
    (0.0, float("inf"), (), (3600.0, 300.0, 900.0))])
def test_quantum_schedule_is_the_references(args):
    t0, t1, bounds, q = args
    assert sharded.quantum_schedule(t0, t1, bounds, sharded.PumpQuanta(*q)) \
        == r_sharded.quantum_schedule(t0, t1, bounds,
                                      r_sharded.PumpQuanta(*q))
    for bad in ((300.0, 0.0, 0.0), (100.0, 300.0, 0.0),
                (3600.0, 300.0, -1.0)):
        with pytest.raises(ValueError):
            sharded.PumpQuanta(*bad)


def test_chip_smoke_fleet_gates_pass_the_port_and_catch_a_changed_job(
        monkeypatch):
    """``chip_smoke.py``'s fleet-day phase on a 40-job day on the CPU: the
    fused day passes its comparison with the numpy day, and the gate
    raises on one changed outcome row, on planned emissions 2e-4 off, and
    on an incomplete day."""
    import dataclasses
    import sys
    sys.path.insert(0, str(ref.REPO))
    import chip_smoke as cs
    from repro_torch.core.scheduler import grid_cuda
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "FLEET_N_JOBS", 40)
    kfns = {"rate_prefix": grid_cuda.rate_prefix, "sweep": grid_cuda.sweep}
    # stands in for ThreadLaunches, which wraps the kernel library: on the
    # CPU no kernel launches, so the wrappers' counts are the one thread's
    threads = SimpleNamespace(
        SYMBOLS=kfns, mine=lambda: {n: fn.launches for n, fn in kfns.items()})
    fleet, rep, stats = cs.run_fleet_day(sharded, overlay, planner, ref.T0,
                                         kfns, threads)
    ofleet, orep, _ = cs.run_fleet_day(sharded, overlay, planner, ref.T0,
                                       kfns, threads, batch_backend="numpy",
                                       shard_backend="numpy")
    assert stats["admission_cells"] > 40 and stats["replan_sweeps"] > 0
    assert rep.n_completed == 40
    out = cs.compare_fleet_days(fleet, rep, ofleet, orep)
    assert out["mismatches"] == 0 and out["max_planned_rel_err"] < 1e-6

    o = rep.outcomes[7]
    for bad in (dataclasses.replace(o, sla_miss=not o.sla_miss),
                dataclasses.replace(o, ftn_sequence=o.ftn_sequence + ("m1",)),
                dataclasses.replace(
                    o, planned_emissions_g=o.planned_emissions_g * 1.0002)):
        outcomes = list(rep.outcomes)
        outcomes[7] = bad
        with pytest.raises(RuntimeError, match="fleet day"):
            cs.compare_fleet_days(fleet, dataclasses.replace(
                rep, outcomes=outcomes), ofleet, orep)
    monkeypatch.setattr(cs, "FLEET_N_JOBS", 41)
    with pytest.raises(RuntimeError, match="completed 40 of 41"):
        cs.fleet_summary(fleet, rep, stats)
