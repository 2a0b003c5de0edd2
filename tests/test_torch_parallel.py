"""Worker processes: the port's ``ShardedFleet(parallel=...)`` against the
reference's.

With the numpy batch and shard backends, a fork or spawn fleet of the
port merges to the reference's in-process report bit for bit (trace and
metrics without their wall series included), and under one seeded fault
plan (worker kills, a worker-reported backend fault, a severed pipe, a
hang caught by the command deadline) the port and the reference record
the same report and the same degradation strings. A spawn fleet on
``fused`` (the kernels' plain versions on the CPU) merges to the port's
own in-process run; a fork fleet refuses shard planning on the card.
Field snapshots (``freeze``/``thaw``, ``register_field_setup``) cross
process boundaries bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro.core.carbon import field as r_field
from repro.core.controlplane import parallel as r_parallel
from repro.core.controlplane import sharded as r_sharded
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core.carbon import field, lattice
from repro_torch.core.controlplane import parallel, sharded
from repro_torch.core.scheduler import grid_cuda, overlay, planner

REPO = Path(__file__).resolve().parents[1]
INF = float("inf")
# every case that starts worker processes is bounded on its own
WORKER_TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


@pytest.fixture(autouse=True)
def _cold_fields():
    ref.fresh_default_fields()


@pytest.fixture
def bounded():
    with ref.deadline(WORKER_TIMEOUT_S):
        yield


def _ref_fleet(parallel_mode="off", **kw):
    return r_sharded.ShardedFleet(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                                  n_shards=3, migration_threshold=250.0,
                                  batch_backend="numpy",
                                  parallel=parallel_mode, **kw)


def _port_fleet(parallel_mode="off", n_shards=3, **kw):
    kw.setdefault("batch_backend", "numpy")
    return sharded.ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                                n_shards=n_shards, migration_threshold=250.0,
                                device="cpu", parallel=parallel_mode, **kw)


def _day(fleet, planner_mod):
    with fleet:
        fleet.submit_many(ref.fleet_jobs(planner_mod, ref.sharded_specs()))
        ref.shock(fleet)
        return fleet.run()


def _drive(fleet, planner_mod, quanta=8):
    """tests/test_parallel.py's ``_drive``: hourly barriered pumps, then
    the terminal run, on its 18-job shocked day."""
    with fleet:
        fleet.submit_many(ref.fleet_jobs(planner_mod, ref.obs_specs(18)))
        ref.shock(fleet)
        for k in range(1, quanta + 1):
            fleet.pump_all(ref.T0 + k * 3600.0, strict=True, horizon=INF)
        return fleet.run()


@pytest.fixture(scope="module")
def reference():
    return _day(_ref_fleet(obs=True), r_planner)


@pytest.mark.parametrize("mode", ["fork", "spawn"])
def test_worker_merge_is_bit_identical_to_the_reference(reference, mode,
                                                        bounded):
    fleet = _port_fleet(mode, shard_backend="numpy", obs=True)
    got = _day(fleet, planner)
    # the workers ran the day (their specs are built at start) and are reaped
    assert fleet.parallel == mode and fleet._runner._specs is not None
    assert fleet._runner._closed and not fleet._runner.started
    ref.assert_reports_identical(got, reference)
    assert got.degradations == ()
    assert sum(r.n_jobs for r in fleet.shard_reports) == 12


FAULTS = (("kill", 1, 0, 0.0), ("backend", 2, 1, 0.0), ("kill", 3, 2, 0.0),
          ("pipe", 4, 1, 0.0), ("hang", 5, 0, 2.0))


def _fault_plan(mod):
    return mod.FaultPlan(actions=tuple(
        mod.FaultAction(quantum=q, shard=s, kind=k, severity_s=sev)
        for k, q, s, sev in FAULTS))


def test_fault_plan_recovers_like_the_reference(bounded):
    """The whole fault ladder on fork workers, both packages under the same
    plan and policy: identical merged reports, degradation strings
    included, and both equal to the fault-free in-process run."""
    pol = dict(command_timeout_s=0.75, checkpoint_every=2)
    want = _drive(_ref_fleet(
        "fork", supervision=r_parallel.SupervisionPolicy(**pol),
        fault_plan=_fault_plan(r_parallel)), r_planner)
    fleet = _port_fleet("fork",
                        supervision=parallel.SupervisionPolicy(**pol),
                        fault_plan=_fault_plan(parallel))
    got = _drive(fleet, planner)
    ref.assert_reports_identical(got, want)
    assert got.degradations == want.degradations
    assert len(got.degradations) >= 5
    assert all("respawned" in d for d in got.degradations)
    reasons = " ".join(r["reason"] for r in fleet._runner.recoveries)
    assert "WorkerDied" in reasons and "WorkerTimeout" in reasons
    oracle = _drive(_port_fleet(), planner)
    ref.assert_reports_identical(got, oracle, ignore=(
        "wall_s", "jobs_per_s", "metrics", "degradations"))


def test_backend_fault_downgrades_a_kernel_shard_to_numpy(bounded):
    """Rung one of the ladder: a worker that reports an error on a batch
    backend other than numpy respawns on numpy, and the report says so."""
    plan = parallel.FaultPlan(actions=(
        parallel.FaultAction(quantum=0, shard=1, kind="backend"),))
    fleet = _port_fleet("fork", shard_backend="torch", fault_plan=plan)
    got = _drive(fleet, planner, quanta=2)
    assert any("batch backend torch -> numpy (worker-reported error)" in d
               for d in got.degradations), got.degradations
    assert fleet._runner._specs[1].batch_backend == "numpy"
    assert got.n_completed == got.n_jobs == 18


class _Respawned:
    def __init__(self, fail):
        self.fail = fail

    def call(self, cmd, args):
        if self.fail:
            raise parallel.WorkerDied("respawn failed")

    def hard_close(self):
        pass


def _cuda_supervisor(respawn_fails):
    spec = parallel.ShardSpec(
        ftns=tuple(ref.make_ftns(overlay, ref.FLEET_FTNS)), controller_kw=(),
        batch_backend="fused", frozen=None, device="cuda")
    runner = SimpleNamespace(
        _specs=[spec], _handles=[_Respawned(False)],
        _spawn=lambda idx: _Respawned(respawn_fails),
        proxies=[SimpleNamespace(_on_reply=lambda state, take: None)])
    sup = parallel.ShardSupervisor(runner, parallel.SupervisionPolicy(
        max_respawns=2, backoff_s=0.0))
    sup.journals[0].append(("pump", None))
    return sup, runner, spec


def test_a_kernel_shard_on_the_card_is_never_downgraded(monkeypatch):
    """A worker on the card that reports an error (a failing kernel)
    respawns on its own backend; once respawns run out, the shard runs
    in-process on the same fused/cuda spec. Nothing plans it on numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    sup, runner, spec = _cuda_supervisor(respawn_fails=False)
    sup.recover(0, parallel.WorkerFailure("kernel launch failed"))
    assert runner._specs[0] == spec
    assert [d for d in sup.degradations if "respawned" not in d] == []
    sup, runner, spec = _cuda_supervisor(respawn_fails=True)
    monkeypatch.setattr(parallel._ShardServer, "apply",
                        lambda self, cmd, args: (None, True))
    sup.recover(0, parallel.WorkerFailure("kernel launch failed"))
    assert runner._specs[0] == spec
    srv = sup.local[0]
    assert (srv.ctl.planner.batch_backend, str(srv.ctl.planner.device)) == \
        ("fused", "cuda")
    assert not any("batch backend" in d for d in sup.degradations)
    assert "parallel -> off" in sup.degradations[-1]


def test_seeded_fault_plans_are_the_reference_s():
    for kw in (dict(seed=11, horizon=4, kills=2, backend_faults=1),
               dict(seed=7, horizon=6, kills=2, backend_faults=1, hangs=1,
                    pipe_blips=1)):
        got = parallel.FaultPlan.seeded(4, **kw)
        want = r_parallel.FaultPlan.seeded(4, **kw)
        assert [dataclasses.astuple(a) for a in got.actions] == \
            [dataclasses.astuple(a) for a in want.actions]


def test_spawn_on_fused_merges_like_in_process(monkeypatch, bounded):
    """One spawn shard on the fused backend re-plans a queue of 12 jobs
    through the batch path (the kernels' plain versions on the CPU) and
    merges to the in-process run bit for bit, fused plan counter included.
    Torch runs single-threaded on both sides of the process boundary, so
    its CPU sums take one order."""
    calls = []
    batch = grid_cuda.batch_cell_best
    monkeypatch.setattr(grid_cuda, "batch_cell_best",
                        lambda *a, **k: calls.append(1) or batch(*a, **k))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for mode in ("off", "spawn"):
            fleet = _port_fleet(mode, n_shards=1, batch_backend="fused",
                                obs=True)
            with fleet:
                fleet.submit_many(ref.fleet_jobs(
                    planner, ref.heavy_specs(t_off_h=0.0)))
                ref.shock(fleet, 2.5, 6.0)
                runs[mode] = fleet.run()
            if mode == "off":
                in_process = len(calls)
    finally:
        torch.set_num_threads(threads)
    # admission plus at least one shard sweep on the batch path in-process
    assert in_process >= 2
    ref.assert_reports_identical(runs["spawn"], runs["off"])
    fused = [c for c in runs["spawn"].metrics["counters"]
             if c["name"] == "planner_plan_batches_total"
             and c["labels"].get("backend") == "fused"]
    assert fused and fused[0]["value"] > 1


def test_fork_refuses_shard_planning_on_the_card(monkeypatch):
    for kw in (dict(shard_backend="fused"),
               dict(shard_backend="fused", parallel_mode="auto")):
        mode = kw.pop("parallel_mode", "fork")
        with pytest.raises(ValueError, match="CUDA does not survive a fork"):
            _port_fleet(mode, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CUDA does not survive a fork"):
        sharded.ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                             parallel="fork", shard_backend="torch",
                             batch_backend="numpy", device="cuda")
    # "auto" on the card starts fresh interpreters for shards that plan
    # there, and forks only numpy shards
    for kw, want in ((dict(), ("spawn", "fused", "cuda")),
                     (dict(shard_backend="torch", batch_backend="numpy"),
                      ("spawn", "torch", "cuda")),
                     (dict(batch_backend="numpy"), ("fork", "numpy", "cpu"))):
        with sharded.ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                                  parallel="auto", device="cuda",
                                  **kw) as fleet:
            assert (fleet.parallel, fleet.shard_backend,
                    fleet._shard_device) == want


def test_fork_workers_plan_on_the_cpu_and_spawn_workers_where_told(
        bounded):
    with _port_fleet("fork", shard_backend="torch") as fork:
        specs = fork._shard_specs()
        assert {s.device for s in specs} == {"cpu"}
        assert {s.batch_backend for s in specs} == {"torch"}
    with _port_fleet("fork") as fork:
        assert fork.shard_backend == parallel.FORK_SAFE_BACKEND == "numpy"
    with _port_fleet("spawn", batch_backend="fused") as spawn:
        spec = spawn._shard_specs()[0]
        assert (spec.device, spec.batch_backend) == ("cpu", "fused")
        back = pickle.loads(pickle.dumps(spec))
        assert (back.device, back.ftns, back.controller_kw) == \
            (spec.device, spec.ftns, spec.controller_kw)


def test_parallel_refuses_what_workers_cannot_rebuild(bounded):
    with pytest.raises(ValueError, match="rebuild their own"):
        _port_fleet("fork", planner=object())
    with pytest.raises(ValueError, match="fault_plan"):
        _port_fleet(fault_plan=parallel.FaultPlan(actions=()))
    with pytest.raises(ValueError, match="command_timeout_s"):
        _port_fleet("fork", fault_plan=parallel.FaultPlan(actions=(
            parallel.FaultAction(quantum=0, shard=0, kind="hang",
                                 severity_s=1.0),)))


# --- field snapshots ---------------------------------------------------------
def test_freeze_thaw_answers_bit_identically_and_as_the_reference():
    ts = ref.T0 + 600.0 * np.arange(96)
    zones = ["CA-QC", "US-NY-NYIS", "US-TEX-ERCO"]
    f, rf = field.CarbonField(), r_field.CarbonField()
    want = f.ci(zones, ts)
    assert rf.ci(zones, ts).tolist() == want.tolist()
    frozen = pickle.loads(pickle.dumps(f.freeze()))
    thawed = frozen.thaw()
    assert thawed.ci(zones, ts).tolist() == want.tolist()
    assert rf.freeze().thaw().ci(zones, ts).tolist() == want.tolist()
    assert frozen.nbytes == rf.freeze().nbytes > 0
    # the pure caches are dropped from a pickle; the anchors travel
    d = f.__getstate__()
    assert d["_hop_grid_cache"] == {} and d["_weight_fn_cache"] == {}


def test_register_field_setup_replays_in_a_spawn_child(tmp_path):
    """A frozen field cut after a lattice install carries the install; a
    fresh interpreter that thaws it answers lattice zones bit for bit."""
    lat = lattice.default_lattice(8)
    zone = lat.zones[3]
    ts = ref.T0 + 3600.0 * np.arange(12)
    f = field.CarbonField()
    want = f.zone_ci(zone, ts)
    frozen = f.freeze()
    assert ("repro_torch.core.carbon.lattice:install_spec",
            (lat.spec,)) in frozen.setup
    snap = tmp_path / "frozen.pkl"
    snap.write_bytes(pickle.dumps(frozen))
    out = tmp_path / "vals.npy"
    code = f"""
import pickle, numpy as np
from repro_torch.core.carbon import field as field_mod
from repro_torch.core.carbon.intensity import REGIONS

assert {zone!r} not in REGIONS
frozen = pickle.loads(open({str(snap)!r}, "rb").read())
field_mod.install_frozen_default(frozen)
f = field_mod.default_field()
f._zone_noise._hash = lambda *a: (_ for _ in ()).throw(
    AssertionError("re-hashed inside the snapshot range"))
np.save({str(out)!r}, f.zone_ci({zone!r}, {ref.T0!r} + 3600.0 * np.arange(12)))
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout
    assert np.load(out).tolist() == want.tolist()


def test_effective_cpu_count_matches_the_reference():
    assert parallel.effective_cpu_count() == \
        r_parallel.effective_cpu_count()
    assert parallel.resolve_mode("auto") == r_parallel.resolve_mode("auto")
