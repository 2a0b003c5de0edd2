"""The planner lattice's split of the cell axis over devices
(``grid_torch.MeshConfig``, ``batch_cell_emissions(shard=)``,
``cell_emissions_on``) on the CPU.

On a device list that repeats the CPU the split is the unsplit lattice bit
for bit (stage 3 gathers each cell's rows alone), whatever the count: 2, 3
(which does not divide the 64-cell bucket) or more devices than cells. It
picks the cells of the reference's ``plan_batch_jax(shard=True)`` on 3
forced host devices (its ``shard_map``, run in a child process), with
emissions within 1e-6 relative, the bound of the fused tests (torch's and
XLA's f32 ``cos`` differ by an ulp).
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro.core.scheduler.grid_jax import MeshConfig as RefMeshConfig
from repro_torch.core.scheduler import grid_torch as gt
from repro_torch.core.scheduler import overlay
from repro_torch.core.scheduler import planner as tp

SPLIT = gt.MeshConfig(platform="cpu", n_devices=ref.SPLIT_DEVICES)


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref.run_reference("split", tmp_path_factory.mktemp("ref")
                             / "split.npz", host_devices=ref.SPLIT_DEVICES)


def _planner(backend="torch"):
    return tp.TorchCarbonPlanner(ref.make_ftns(overlay, ref.SCALE_FTNS),
                                 device="cpu", batch_backend=backend)


@pytest.fixture(scope="module")
def port():
    pl = _planner()
    jobs = ref.make_jobs(tp, ref.SCALE_CASES["planner"])
    cells, _, _ = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    unsplit = gt.batch_cell_emissions(pl.field, cells, dt_s=ref.DT_S,
                                      slot_stride=ref.STRIDE, device="cpu",
                                      shard=False)
    return pl, jobs, cells, unsplit


@pytest.mark.parametrize("n", [2, 3, 400], ids=["2", "3", "more_than_cells"])
def test_split_equals_unsplit_bit_for_bit(port, n):
    pl, _, cells, unsplit = port
    assert n != 400 or n > len(cells)
    got = gt.batch_cell_emissions(
        pl.field, cells, dt_s=ref.DT_S, slot_stride=ref.STRIDE,
        device="cpu", shard=gt.MeshConfig(platform="cpu", n_devices=n))
    assert len(got) == len(unsplit)
    for g, w in zip(got, unsplit):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_split_scores_each_device_slice_once(port, monkeypatch):
    """Stage 3 runs once a device a chunk, each on an even slice of a cell
    axis padded to lcm(64, 3); the (anchor, path) grids of stages 1-2 are
    built once and, on a repeated device, not copied."""
    pl, _, cells, _ = port
    seen = []
    real = gt._cell_rows

    def spy(prefix, ci, pair_idx, *a, **k):
        seen.append((id(prefix), id(ci), pair_idx.shape[0]))
        return real(prefix, ci, pair_idx, *a, **k)

    monkeypatch.setattr(gt, "_cell_rows", spy)
    gt.cell_emissions_on(pl.field, cells, ["cpu"] * 3, dt_s=ref.DT_S,
                         slot_stride=ref.STRIDE, device="cpu")
    n_chunks = len(list(gt._iter_chunks(cells, ref.STRIDE, gt._MAX_ELEMS)))
    assert len(seen) == 3 * n_chunks
    for c in range(n_chunks):
        part = seen[3 * c:3 * c + 3]
        assert len({(p, g) for p, g, _ in part}) == 1
        rows = part[0][2]
        assert all(r == rows for _, _, r in part) and (3 * rows) % 192 == 0
        assert 3 * rows >= len(cells) or n_chunks > 1


@pytest.mark.parametrize("shard", [
    None, True, False, gt.MeshConfig(platform="cpu"),
    gt.MeshConfig(platform="cpu", n_devices=1),
    gt.MeshConfig(platform="cuda", n_devices=2)],
    ids=["none", "true", "false", "cpu_default", "cpu_1", "cuda_none_here"])
def test_fewer_than_two_devices_run_unsplit(port, monkeypatch, shard):
    """On the CPU every visible device is one; a MeshConfig that resolves
    to fewer than two devices (here none: no card) scores unsplit on the
    planner's device."""
    pl, _, cells, unsplit = port
    calls = []
    real = gt._lattice

    def spy(d, **kw):
        calls.append(list(kw["devices"]))
        return real(d, **kw)

    monkeypatch.setattr(gt, "_lattice", spy)
    got = gt.batch_cell_emissions(pl.field, cells[:20], dt_s=ref.DT_S,
                                  slot_stride=ref.STRIDE, device="cpu",
                                  shard=shard)
    assert calls and all(c == [] for c in calls)
    for g, w in zip(got, unsplit[:20]):
        assert np.array_equal(g, w)


def test_lattice_refuses_an_uneven_split(port):
    pl, _, cells, _ = port
    t = gt._chunk_tables(pl.field, cells[:10], dt_s=ref.DT_S,
                         slot_stride=ref.STRIDE, cell_bucket=64)
    with pytest.raises(ValueError, match="do not split over 3"):
        gt._lattice(gt.tables_to_device(t, "cpu"), slot_stride=ref.STRIDE,
                    dt_s=ref.DT_S, devices=[torch.device("cpu")] * 3)


def test_split_tables_match_reference_shard_map(reference, port):
    pl, _, cells, _ = port
    got = gt.batch_cell_emissions(pl.field, cells, dt_s=ref.DT_S,
                                  slot_stride=ref.STRIDE, device="cpu",
                                  shard=SPLIT)
    assert len(got) == len(cells) == sum(
        k.startswith("split/emis/") for k in reference)
    for j, g in enumerate(got):
        np.testing.assert_allclose(g, reference[f"split/emis/{j}"],
                                   rtol=1e-6, atol=0)


def test_split_plans_match_reference_sharded_plans(reference, port):
    pl, jobs, _, _ = port
    got = pl.plan_batch_torch(jobs, shard=SPLIT)
    want = {k: reference[f"split/plans/{k}"]
            for k in ("start_t", "source", "ftn", "feasible", "emis",
                      "alternatives")}
    assert len(got) == len(want["emis"])
    for j, p in enumerate(got):
        assert (p.start_t, p.source, p.ftn, p.feasible, p.alternatives) == (
            want["start_t"][j], want["source"][j], want["ftn"][j],
            want["feasible"][j], want["alternatives"][j])
        assert p.predicted_emissions_g == pytest.approx(want["emis"][j],
                                                        rel=1e-6)


def _spy_lattice(monkeypatch):
    seen = []
    real = tp.batch_cell_emissions

    def spy(field, cells, **kw):
        seen.append(kw.get("shard", "absent"))
        return real(field, cells, **kw)

    monkeypatch.setattr(tp, "batch_cell_emissions", spy)
    return seen


def test_plan_batch_passes_no_shard_and_torch_forwards_it(monkeypatch):
    pl = _planner()
    jobs = ref.make_jobs(tp, ref.SCALE_CASES["grid"])
    seen = _spy_lattice(monkeypatch)
    default = pl.plan_batch(jobs)
    split = pl.plan_batch_torch(jobs, shard=SPLIT)
    assert seen == [None, SPLIT]
    assert [dataclasses.astuple(p) for p in split] == \
        [dataclasses.astuple(p) for p in default]


def test_fused_backend_ignores_shard(monkeypatch):
    pl = _planner("fused")
    jobs = ref.make_jobs(tp, ref.SCALE_CASES["grid"])
    seen = _spy_lattice(monkeypatch)
    got = pl.plan_batch_torch(jobs, shard=SPLIT)
    assert seen == []
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in pl.plan_batch_torch(jobs)]


@pytest.mark.parametrize("kw", [
    {}, {"axis": "x"}, {"n_devices": 3}, {"axis": ""}, {"n_devices": 0},
    {"n_devices": -2}, {"platform": "cpu", "n_devices": 2}])
def test_mesh_config_validates_as_the_reference(kw):
    try:
        RefMeshConfig(**kw)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split(",")[0]):
            gt.MeshConfig(**kw)
    else:
        cfg = gt.MeshConfig(**kw)
        assert dataclasses.astuple(cfg) == dataclasses.astuple(
            RefMeshConfig(**kw))
        assert hash(cfg) == hash(gt.MeshConfig(**kw))


def test_mesh_config_devices_and_build(monkeypatch):
    cfg = gt.MeshConfig(platform="cpu", n_devices=3)
    assert cfg.devices() == [torch.device("cpu")] * 3
    mesh = cfg.build()
    assert mesh.axis_names == ("cells",) and mesh.shape == {"cells": 3}
    assert gt.MeshConfig(platform="cpu").devices() == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert gt.MeshConfig().devices() == []
    with pytest.raises(ValueError, match="matches no devices"):
        gt.MeshConfig().build()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in gt.MeshConfig(n_devices=2).devices()] == \
        ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="platform"):
        gt.MeshConfig(platform="tpu").devices()


def test_cell_split_phase_passes_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 4c at a 64-job window on the CPU, with
    one card claimed visible (its MeshConfig then resolves to one device)
    and a device-events stub."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "WINDOW", 64)
    monkeypatch.setattr(chip_smoke, "device_events", lambda fn: (
        fn(), {"device_events": 0, "device_ms": 0.0})[1])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ftns, job = chip_smoke.planner_scale_jobs(tp)
    res = chip_smoke.cell_split(tp, gt, ftns, job)
    assert res["split_tables"]["bit_equal_cells"] == res["cells"] > 64
    assert res["mesh_config_devices"] == ["cuda:0"]
