"""The port's numpy table builder and torch lattice against the reference:
``_iter_chunks`` and ``_chunk_tables`` array for array, the lattice
``batch_cell_emissions`` against the revived ``grid_jax`` lattice (1e-6
relative) and against the numpy ``transfer_emissions_g`` oracle (1e-4)."""
import sys

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro_torch.core.carbon.energy import HOST_PROFILES
from repro_torch.core.scheduler import grid_cuda, grid_torch, overlay, planner

BUDGETS = {"default": grid_torch._MAX_ELEMS, "small": 100_000}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref.warm_up_torch()
    return ref.run_reference("grid", tmp_path_factory.mktemp("ref") / "g.npz")


@pytest.fixture(scope="module")
def port():
    pl = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ref.SCALE_FTNS),
                                    device="cpu", batch_backend="torch")
    jobs = ref.make_jobs(planner, ref.SCALE_CASES["grid"])
    cells, _, meta = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    return pl, jobs, cells, meta


def test_port_builds_the_reference_cells(reference, port):
    _, _, cells, _ = port
    assert len(cells) == int(reference["grid/n_cells"]) > 0


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_iter_chunks_matches_reference(reference, port, budget):
    _, _, cells, _ = port
    chunks = list(grid_torch._iter_chunks(cells, ref.STRIDE, BUDGETS[budget]))
    assert len(chunks) == int(reference[f"grid/{budget}/n_chunks"])
    for i, ch in enumerate(chunks):
        assert ch == reference[f"grid/{budget}/{i}/chunk"].tolist()
    if budget == "small":
        assert len(chunks) == 2


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_chunk_tables_match_reference_array_for_array(reference, port,
                                                      budget):
    pl, _, cells, _ = port
    for i, ch in enumerate(grid_torch._iter_chunks(cells, ref.STRIDE,
                                                   BUDGETS[budget])):
        t = grid_torch._chunk_tables(pl.field, [cells[j] for j in ch],
                                     dt_s=ref.DT_S, slot_stride=ref.STRIDE,
                                     cell_bucket=grid_torch._B_CELLS)
        for k, v in ref.table_arrays(t).items():
            want = reference[f"grid/{budget}/{i}/tab/{k}"]
            assert v.dtype == want.dtype, k
            assert np.array_equal(v, want), k


def test_tables_to_device_takes_the_reference_tables(reference, port):
    """The same tensors come out of the port's tables and of the
    reference's own ChunkTables."""
    pl, _, cells, _ = port
    ch = reference["grid/default/0/chunk"].tolist()
    mine = grid_torch.tables_to_device(
        grid_torch._chunk_tables(pl.field, [cells[j] for j in ch],
                                 dt_s=ref.DT_S, slot_stride=ref.STRIDE,
                                 cell_bucket=grid_torch._B_CELLS), "cpu")
    theirs = grid_torch.tables_to_device(
        ref.ref_tables(reference, "grid/default/0/tab"), "cpu")
    assert type(ref.ref_tables(reference, "grid/default/0/tab")).__module__ \
        == "repro.core.scheduler.grid_jax"
    for name in vars(mine):
        a, b = getattr(mine, name), getattr(theirs, name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def test_lattice_matches_revived_jax_lattice(reference, port):
    pl, _, cells, _ = port
    got = grid_torch.batch_cell_emissions(pl.field, cells, dt_s=ref.DT_S,
                                          slot_stride=ref.STRIDE,
                                          device="cpu")
    for j, g in enumerate(got):
        np.testing.assert_allclose(g, reference[f"grid/emis/{j}"],
                                   rtol=1e-6, atol=0)


def test_lattice_matches_numpy_oracle(port):
    pl, jobs, cells, meta = port
    got = grid_torch.batch_cell_emissions(pl.field, cells, dt_s=ref.DT_S,
                                          slot_stride=ref.STRIDE,
                                          device="cpu")
    sender = HOST_PROFILES["storage_frontend"]
    n = 0
    for job, jcells in zip(jobs, meta):
        for idx, ftn, _src, paths, gbps, _dur, ts in jcells:
            for leg, p in enumerate(paths):
                want = pl.field.transfer_emissions_g(
                    p, sender, ftn.power_model, job.size_bytes, ts, gbps,
                    parallelism=job.parallelism, concurrency=job.concurrency)
                np.testing.assert_allclose(got[idx][leg], want, rtol=1e-4)
                n += 1
    assert n > 2 * len(jobs)


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Both CUDA kernels against their plain versions on a real chunk;
    needs a GPU (``chip_smoke.py`` runs the same check on the main path's
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    pl = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ref.SCALE_FTNS),
                                    device="cuda")
    jobs = ref.make_jobs(planner, ref.SCALE_CASES["planner"])
    cells, sla_rows, _ = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    t = grid_torch._chunk_tables(pl.field, cells, dt_s=ref.DT_S,
                                 slot_stride=ref.STRIDE,
                                 cell_bucket=grid_torch._B_CELLS)
    x = grid_cuda.fused_inputs(grid_torch.tables_to_device(t, pl.device),
                               grid_cuda.sla_table(t, np.asarray(sla_rows)),
                               grid_cuda.scale_table(t, ref.SLOT_S, ref.drift))
    args = (x.pp, x.zn, x.hn, x.rel0, x.tc)
    r_k, e_k = grid_cuda.rate_prefix(*args, dt_s=ref.DT_S, t_pad=x.t_pad)
    r_p, e_p = grid_cuda.rate_prefix_plain(*args, dt_s=ref.DT_S,
                                           t_pad=x.t_pad)
    torch.testing.assert_close(r_k, r_p, rtol=1e-6, atol=0)
    total = (e_p[..., -1] + r_p[..., -1].double())[..., None]
    assert float(((e_k - e_p).abs() / total).max()) <= 1e-9
    kw = dict(stride=ref.STRIDE, dt_s=ref.DT_S, slot_s=ref.SLOT_S)
    b_k = grid_cuda.sweep(e_k, r_k, x.scl, x.pidx, x.wd, x.sla, **kw)
    b_p = grid_cuda.sweep_plain(e_k, r_k, x.scl, x.pidx, x.wd, x.sla, **kw)
    assert torch.equal(b_k[:, 2], b_p[:, 2])
    torch.testing.assert_close(b_k[:, :2], b_p[:, :2], rtol=1e-9, atol=0)


def test_reference_run_left_no_alias_here(reference):
    """The reference was revived in a child process: this process still
    has jax's own namespace, and the reference's Pallas gate stays as
    the installed jax leaves it."""
    import jax
    import jax.experimental
    assert getattr(jax.experimental, "enable_x64", None) \
        is not jax.enable_x64
    gp = sys.modules.get("repro.core.scheduler.grid_pallas")
    assert gp is None or gp.enable_x64 is not jax.enable_x64
