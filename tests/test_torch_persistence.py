"""Checkpoints: the port's ``persistence`` against the reference's.

``tests/test_persistence.py``'s crash-kill-resume contract, held for the
port: a run captured at a quantum boundary, pickled (or saved and loaded
from disk, or left behind by a process killed with ``os._exit``) and
restored resumes bit-identical to the run that was never interrupted —
and, with numpy backends, to the reference's uninterrupted run — for a
bare ``FleetController``, a ``ShardedFleet`` in-process or on worker
processes (across modes), and a ``StreamingGateway`` riding on one. A
checkpoint names no device: ``restore(device=...)`` places every planner,
so one taken on the card restores on the CPU.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import _torch_ref as ref
from repro.core.controlplane import FleetController as RefController
from repro.core.controlplane import StreamingGateway as RefGateway
from repro.core.controlplane import sharded as r_sharded
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core.controlplane import (FleetController, ShardedFleet,
                                           StreamingGateway,
                                           SupervisionPolicy, persistence)
from repro_torch.core.scheduler import overlay, planner

REPO = Path(__file__).resolve().parents[1]
INF = float("inf")
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


def _numpy_controller(**kw):
    ftns = ref.make_ftns(overlay, ref.FLEET_FTNS)
    return FleetController(ftns, migration_threshold=250.0, device="cpu",
                           planner=planner.TorchCarbonPlanner(
                               ftns, device="cpu", batch_backend="numpy"),
                           **kw)


def _controller(mod=None, planner_mod=planner, **kw):
    if mod is None:
        ctl = _numpy_controller(**kw)
    else:
        ctl = mod(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                  migration_threshold=250.0, **kw)
    for job in ref.fleet_jobs(planner_mod, ref.sharded_specs()):
        ctl.submit(job)
    ref.shock(ctl)
    return ctl


def _sharded(**kw):
    fl = ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS), n_shards=3,
                      batch_backend="numpy", shard_backend="numpy",
                      migration_threshold=250.0, device="cpu", **kw)
    fl.submit_many(ref.fleet_jobs(planner, ref.sharded_specs()))
    ref.shock(fl)
    return fl


@pytest.fixture(scope="module")
def controller_oracle():
    """The reference's uninterrupted run, and the port's."""
    want = _controller(RefController, r_planner).run()
    got = _controller().run()
    ref.assert_reports_identical(got, want)
    return want


@pytest.fixture(scope="module")
def sharded_oracle():
    fl = r_sharded.ShardedFleet(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                                n_shards=3, batch_backend="numpy",
                                shard_backend="numpy",
                                migration_threshold=250.0)
    fl.submit_many(ref.fleet_jobs(r_planner, ref.sharded_specs()))
    ref.shock(fl)
    return fl.run()


@pytest.mark.parametrize("cut_h", [0.5, 2.0, 4.7, 9.0, 30.0])
def test_controller_round_trip_is_bit_identical(cut_h, controller_oracle):
    ctl = _controller()
    ctl.pump(ref.T0 + cut_h * 3600.0, strict=True, horizon=INF)
    ckpt = pickle.loads(pickle.dumps(persistence.capture(ctl)))
    restored = persistence.restore(ckpt, device="cpu")
    assert restored is not ctl
    ref.assert_reports_identical(restored.run(), controller_oracle)


def test_checkpoint_drops_derived_state_but_replays_it():
    ctl = _controller()
    ctl.pump(ref.T0 + 11.1 * 3600.0, strict=True, horizon=INF)
    n_active = len(ctl._active)
    assert n_active > 0
    restored = persistence.restore(persistence.capture(ctl), device="cpu")
    assert len(restored._active) == n_active
    for rec in restored._active.values():
        assert rec.power_segments, "power closures not replayed"
        assert callable(rec.power_segments[-1][1])
    # the planner's drift hook is re-wired to the restored controller
    assert restored.planner.emission_scale_fn.__self__ is restored


def test_planner_pickles_its_device_by_name_and_no_owner():
    p = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ref.FLEET_FTNS),
                                   device="cpu")
    p.emission_scale_fn = ref.drift
    state = p.__getstate__()
    assert state["emission_scale_fn"] is None and state["device"] == "cpu"
    back = pickle.loads(pickle.dumps(p))
    assert back.device == torch.device("cpu")
    assert back.emission_scale_fn is None and p.emission_scale_fn is not None
    assert back.batch_backend == "fused"


def test_a_checkpoint_taken_on_the_card_restores_on_the_cpu(
        controller_oracle, monkeypatch):
    """The planner's device travels as a name and is never queried on
    unpickling; ``restore`` places the planner where it is told, and
    without CUDA it refuses to default to the card."""
    ctl = _controller()
    ctl.pump(ref.T0 + 4.0 * 3600.0, strict=True, horizon=INF)
    ctl.planner.device = torch.device("cuda")
    ckpt = pickle.loads(pickle.dumps(persistence.capture(ctl)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ckpt.shards[0].thaw().planner.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        persistence.restore(ckpt)
    restored = persistence.restore(ckpt, device="cpu")
    assert restored.planner.device.type == "cpu"
    ref.assert_reports_identical(restored.run(), controller_oracle)


def test_fused_controller_round_trip_is_bit_identical():
    """On the fused backend (the kernels' plain versions on the CPU) a
    restored run re-plans through the batch path exactly as the
    uninterrupted one."""
    def run(cut_h=None):
        ftns = ref.make_ftns(overlay, ref.FLEET_FTNS)
        ctl = FleetController(ftns, migration_threshold=250.0, device="cpu",
                              obs=True)
        ctl.submit_many(ref.fleet_jobs(planner,
                                       ref.heavy_specs(t_off_h=0.0)))
        ref.shock(ctl, 2.5, 6.0)
        if cut_h is not None:
            ctl.pump(ref.T0 + cut_h * 3600.0, strict=True, horizon=INF)
            ctl = persistence.restore(
                pickle.loads(pickle.dumps(persistence.capture(ctl))),
                device="cpu")
        return ctl.run()

    want = run()
    assert want.replan_events > 0
    for cut_h in (1.0, 3.0):
        ref.assert_reports_identical(run(cut_h), want)


def test_sharded_sequential_round_trip(sharded_oracle):
    fl = _sharded()
    fl.pump_all(ref.T0 + 4 * 3600.0, strict=True, horizon=INF)
    ckpt = pickle.loads(pickle.dumps(persistence.capture(fl)))
    assert ckpt.kind == "sharded" and len(ckpt.shards) == 3
    assert ckpt.config["batch_backend"] == "numpy"
    assert ckpt.config["shard_backend"] == "numpy"
    assert ckpt.sim_now >= ref.T0 + 3 * 3600.0
    ref.assert_reports_identical(
        persistence.restore(ckpt, device="cpu").run(), sharded_oracle)


@pytest.mark.parametrize("mode", ["fork", "spawn"])
def test_parallel_checkpoint_restores_across_modes(sharded_oracle, mode,
                                                   bounded):
    """A checkpoint cut under worker processes restores in-process and on
    workers again, both bit-identical to the reference's in-process run."""
    fl = _sharded(parallel=mode)
    fl.pump_all(ref.T0 + 4 * 3600.0, strict=True, horizon=INF)
    ckpt = persistence.capture(fl)
    fl.close()
    assert ckpt.config["parallel"] == mode
    ref.assert_reports_identical(
        persistence.restore(ckpt, parallel="off", device="cpu").run(),
        sharded_oracle)
    with persistence.restore(ckpt, device="cpu") as fl2:
        assert fl2.parallel == mode
        ref.assert_reports_identical(fl2.run(), sharded_oracle)


def test_restore_preserves_supervision_policy(bounded):
    pol = SupervisionPolicy(command_timeout_s=4.0, checkpoint_every=2)
    fl = _sharded(parallel="fork", supervision=pol)
    fl.pump_all(ref.T0 + 3600.0, strict=True, horizon=INF)
    ckpt = persistence.capture(fl)
    fl.close()
    with persistence.restore(ckpt, device="cpu") as fl2:
        assert fl2.supervision == pol


# --- streaming gateway -------------------------------------------------------
def _gateway(**kw):
    return StreamingGateway(
        ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS), n_shards=3,
                     batch_backend="numpy", shard_backend="numpy",
                     migration_threshold=250.0, device="cpu"),
        window_s=1800.0, max_inflight=4, backfill=True, device="cpu", **kw)


def _jobs():
    return ref.fleet_jobs(planner, ref.sharded_specs())


@pytest.fixture(scope="module")
def gateway_oracle():
    gw = RefGateway(
        r_sharded.ShardedFleet(ref.make_ftns(r_overlay, ref.FLEET_FTNS),
                               n_shards=3, batch_backend="numpy",
                               shard_backend="numpy",
                               migration_threshold=250.0),
        window_s=1800.0, max_inflight=4, backfill=True)
    return gw.run(ref.fleet_jobs(r_planner, ref.sharded_specs()))


def test_gateway_checkpoint_cadence_does_not_perturb_the_run(
        gateway_oracle):
    ref.assert_reports_identical(_gateway().run(_jobs()), gateway_oracle)
    caps = []
    rep = _gateway(checkpoint_every_s=3600.0,
                   checkpoint_fn=caps.append).run(_jobs())
    ref.assert_reports_identical(rep, gateway_oracle)
    assert caps and all(c.gateway is not None for c in caps)


def test_gateway_restore_resume_equivalence(gateway_oracle):
    caps = []
    _gateway(checkpoint_every_s=3600.0, checkpoint_fn=caps.append).run(
        _jobs())
    for ckpt in (caps[0], caps[-1]):
        gw = persistence.restore_gateway(pickle.loads(pickle.dumps(ckpt)),
                                         device="cpu")
        assert gw._consumed == ckpt.gateway["_consumed"]
        assert gw._batch_planner.device.type == "cpu"
        ref.assert_reports_identical(gw.resume(_jobs()), gateway_oracle)


# --- an actual process kill --------------------------------------------------
_CHILD = """
import os, sys
sys.path.insert(0, {tests!r})
import _torch_ref as ref
from repro_torch.core.controlplane import FleetController, persistence
from repro_torch.core.scheduler import overlay, planner

ftns = ref.make_ftns(overlay, ref.FLEET_FTNS)
ctl = FleetController(ftns, migration_threshold=250.0, device="cpu",
                      planner=planner.TorchCarbonPlanner(
                          ftns, device="cpu", batch_backend="numpy"))
for job in ref.fleet_jobs(planner, ref.sharded_specs()):
    ctl.submit(job)
ref.shock(ctl)
ctl.pump(ref.T0 + 4.0 * 3600.0, strict=True, horizon=float("inf"))
persistence.save(persistence.capture(ctl), sys.argv[1])
os._exit(17)  # hard kill: no atexit, no cleanup, nothing flushed
"""


def test_checkpoint_survives_a_hard_process_kill(tmp_path, controller_oracle):
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(_CHILD.format(
        tests=str(REPO / "tests"))))
    path = tmp_path / "fleet.ckpt"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(script), str(path)], env=env,
                          capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 17, proc.stderr[-2000:]
    restored = persistence.restore(persistence.load(path), device="cpu")
    ref.assert_reports_identical(restored.run(), controller_oracle)


# --- refusal paths -----------------------------------------------------------
def test_restore_refuses_version_mismatch():
    ckpt = persistence.capture(_controller())
    stale = dataclasses.replace(ckpt, version=ckpt.version + 1)
    with pytest.raises(ValueError, match="version"):
        persistence.restore(stale, device="cpu")
    with pytest.raises(TypeError, match="cannot checkpoint"):
        persistence.capture(object())
    with pytest.raises(ValueError, match="no gateway state"):
        persistence.restore_gateway(ckpt, device="cpu")


def test_save_is_atomic_and_load_checks_what_it_reads(tmp_path):
    path = tmp_path / "ctl.ckpt"
    persistence.save(persistence.capture(_controller()), path)
    assert not list(tmp_path.glob("*.tmp.*")), "temp file left behind"
    assert persistence.load(path).kind == "controller"
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(pickle.dumps({"not": "a checkpoint"}))
    with pytest.raises(TypeError, match="FleetCheckpoint"):
        persistence.load(junk)
