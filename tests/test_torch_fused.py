"""The fused path against the revived reference kernels.

The reference's own ``grid_pallas`` planner runs in interpret mode in a
child process (see ``_torch_ref``) on the edge cases of
``tests/test_grid_pallas.py`` plus a drift-scale case, and records each
chunk's tables, kernel inputs and kernel outputs. Here the port's plain
``rate_prefix`` and ``sweep`` are fed the reference's own tables through
``tables_to_device``.

Tolerances: ``r`` within 1e-6 relative — the f32 CI chain, where torch's
and XLA's f32 ``cos`` differ by an ulp (about 6e-8 relative), with a bias
that does not cancel. ``E`` sums those ``r``, so it is held to 1e-6 of each
row's total against the reference, and to 1e-9 of the row total against
the exact prefix of the port's own ``r``, which leaves only f64 summation
order. Emissions and costs are weighted sums of ``r`` and are held to
1e-6 relative; every cell must pick the same slot.
"""
import sys

import numpy as np
import pytest
import torch

import _torch_ref as ref
from repro_torch.core.scheduler import grid_cuda, grid_torch, overlay, planner

CASES = sorted(ref.EDGE_CASES) + ["drift"]
INPUTS = ("pp", "zn", "hn", "rel0", "tc", "pidx", "wd", "sla", "scl")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref.warm_up_torch()
    return ref.run_reference("fused",
                             tmp_path_factory.mktemp("ref") / "f.npz")


def _port_planner(case):
    ftns = ref.SCALE_FTNS if case == "drift" else ref.EDGE_FTNS
    pl = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ftns),
                                    device="cpu", batch_backend="fused")
    if case == "drift":
        pl.emission_scale_fn = ref.drift
    specs = ref.SCALE_CASES["drift"] if case == "drift" \
        else ref.EDGE_CASES[case]
    return pl, ref.make_jobs(planner, specs)


def _ref_inputs(reference, case, i):
    got = {k: reference[f"{case}/{i}/in/{k}"] for k in INPUTS}
    got["rel0"] = got["rel0"][:, 0]    # the reference keeps (A, 1)
    return got


@pytest.mark.parametrize("case", CASES)
def test_plain_kernels_match_pallas_interpret(reference, case):
    n_chunks = int(reference[f"{case}/n_chunks"])
    assert (n_chunks == 0) == (case == "zero_cells")
    for i in range(n_chunks):
        d = grid_torch.tables_to_device(
            ref.ref_tables(reference, f"{case}/{i}/tab"), "cpu")
        want = _ref_inputs(reference, case, i)
        x = grid_cuda.fused_inputs(d, want["sla"], want["scl"])
        for k in INPUTS:               # identical kernel inputs
            assert np.array_equal(getattr(x, k).numpy(), want[k]), k
        r, e = grid_cuda.rate_prefix(x.pp, x.zn, x.hn, x.rel0, x.tc,
                                     dt_s=ref.DT_S, t_pad=x.t_pad)
        r_ref = reference[f"{case}/{i}/out/r"]
        e_ref = reference[f"{case}/{i}/out/e"]
        np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-6, atol=0)
        total = (e_ref[..., -1] + r_ref[..., -1])[..., None]
        assert np.max(np.abs(e.numpy() - e_ref) / total) <= 1e-6
        r64 = r.double().numpy()
        exact = np.cumsum(r64, axis=2) - r64
        assert np.max(np.abs(e.numpy() - exact) / total) <= 1e-9
        best = grid_cuda.sweep(e, r, x.scl, x.pidx, x.wd, x.sla,
                               stride=ref.STRIDE, dt_s=ref.DT_S,
                               slot_s=ref.SLOT_S).numpy()
        best_ref = reference[f"{case}/{i}/out/best"]
        assert np.array_equal(best[:, 2], best_ref[:, 2])
        np.testing.assert_allclose(best[:, :2], best_ref[:, :2], rtol=1e-6,
                                   atol=0)
        if case == "all_masked":
            assert np.isinf(best[:, :2]).all() and not best[:, 2].any()


@pytest.mark.parametrize("case", CASES)
def test_port_builds_the_reference_kernel_inputs(reference, case):
    """The port's own cells, tables, SLA rows and drift table equal the
    reference's, chunk for chunk."""
    pl, jobs = _port_planner(case)
    cells, sla_rows, _ = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    chunks = list(grid_torch._iter_chunks(cells, ref.STRIDE,
                                          grid_cuda._MAX_ELEMS_PALLAS))
    assert len(chunks) == int(reference[f"{case}/n_chunks"])
    for i, ch in enumerate(chunks):
        t = grid_torch._chunk_tables(pl.field, [cells[j] for j in ch],
                                     dt_s=ref.DT_S, slot_stride=ref.STRIDE,
                                     cell_bucket=grid_torch._B_CELLS)
        for k, v in ref.table_arrays(t).items():
            assert np.array_equal(v, reference[f"{case}/{i}/tab/{k}"]), k
        want = _ref_inputs(reference, case, i)
        assert np.array_equal(
            grid_cuda.sla_table(t, np.asarray(sla_rows)[ch]), want["sla"])
        assert np.array_equal(
            grid_cuda.scale_table(t, ref.SLOT_S, pl.emission_scale_fn),
            want["scl"])


@pytest.mark.parametrize("case", CASES)
def test_port_plans_match_pallas_plans(reference, case):
    pl, jobs = _port_planner(case)
    plans = pl.plan_batch_torch(jobs)
    want = {k: reference[f"{case}/plans/{k}"]
            for k in ("start_t", "source", "ftn", "feasible", "emis", "cost",
                      "alternatives")}
    assert len(plans) == len(want["start_t"])
    for j, p in enumerate(plans):
        assert (p.start_t, p.source, p.ftn, p.feasible, p.alternatives) == (
            want["start_t"][j], want["source"][j], want["ftn"][j],
            want["feasible"][j], want["alternatives"][j])
        assert p.predicted_emissions_g == pytest.approx(want["emis"][j],
                                                        rel=1e-6)
        if p.feasible:
            assert p.cost == pytest.approx(want["cost"][j], rel=1e-6)
    if case == "all_masked":
        assert not plans[0].feasible
    if case == "single_slot":
        assert all(p.feasible for p in plans)


def test_batch_cell_best_validates_sla_rows():
    pl, _ = _port_planner("single_slot")
    with pytest.raises(ValueError, match="sla_rows"):
        grid_cuda.batch_cell_best(pl.field, [], np.zeros((1, 6)),
                                  device="cpu")
    cost, emis, slot = grid_cuda.batch_cell_best(pl.field, [],
                                                 np.zeros((0, 6)),
                                                 device="cpu")
    assert cost.shape == emis.shape == slot.shape == (0,)


def test_tables_to_device_rejects_pair_rows_out_of_range():
    pl, jobs = _port_planner("carbon_budget")
    cells, _, _ = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    t = grid_torch._chunk_tables(pl.field, cells, dt_s=ref.DT_S,
                                 slot_stride=ref.STRIDE,
                                 cell_bucket=grid_torch._B_CELLS)
    t.pair_idx[0, 0] = len(t.path_idx)
    with pytest.raises(ValueError, match="pair_idx"):
        grid_torch.tables_to_device(t, "cpu")


def test_reference_run_left_no_alias_here(reference):
    import jax
    import jax.experimental
    assert getattr(jax.experimental, "enable_x64", None) \
        is not jax.enable_x64
    gp = sys.modules.get("repro.core.scheduler.grid_pallas")
    assert gp is None or not gp.PALLAS_AVAILABLE
    assert torch.get_default_dtype() == torch.float32
