"""The port's numpy table builder and torch lattice against the reference:
``_iter_chunks`` and ``_chunk_tables`` array for array, the lattice
``batch_cell_emissions`` against the revived ``grid_jax`` lattice (1e-6
relative) and against the numpy ``transfer_emissions_g`` oracle (1e-4)."""
import math
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


def _edge_inputs(n_pairs, n_hops, t_pad, s_pad, n_cells, seed,
                 dev="cuda"):
    """Kernel inputs made with numpy from a seed, with the main path's
    ranges: CI parameters of the zone table's order, hourly noise over a
    week, anchors up to three hours apart, 57 % live hops, 1-73 steps a
    cell and every slot count from 0 (no feasible slot) to all. Cell 1
    has n_valid 0, cell 2 a second leg with no live hop."""
    rng = np.random.default_rng(seed)
    w_hours, stride = 168, ref.STRIDE
    pp = np.stack([rng.uniform(50, 700, (n_pairs, n_hops)),
                   rng.uniform(0, 120, (n_pairs, n_hops)),
                   rng.uniform(0, 150, (n_pairs, n_hops)),
                   rng.uniform(0, 40, (n_pairs, n_hops)),
                   rng.uniform(0, 24, (n_pairs, n_hops)),
                   rng.uniform(0, 1, (n_pairs, n_hops))], axis=2)
    n = rng.integers(1, 74, n_cells)
    top = np.minimum((t_pad - n) // stride + 1, s_pad)
    n_valid = np.minimum(rng.integers(0, s_pad + 1, n_cells), top)
    n_valid[1] = 0
    wd = rng.uniform(5, 200, (n_cells, 2, n_hops)) \
        * (rng.random((n_cells, 2, n_hops)) < 0.57)
    wd[2, 1] = 0.0
    sub = 1.7e9 + rng.uniform(0, 86400, n_cells)
    sla = np.stack([n, rng.uniform(0, 60, n_cells), n_valid,
                    rng.uniform(600, 90000, n_cells),
                    rng.uniform(0, 2e-4, n_cells), rng.uniform(0.5, 1, n_cells),
                    np.where(rng.random(n_cells) < 0.3,
                             rng.uniform(1, 50, n_cells), np.inf), sub],
                   axis=1)
    f32 = dict(dtype=torch.float32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    return grid_cuda.FusedInputs(
        pp=torch.tensor(pp, **f32),
        zn=torch.tensor(rng.uniform(-1, 1, (n_pairs, n_hops, w_hours)),
                        **f32),
        hn=torch.tensor(rng.uniform(-0.5, 0.5, (n_pairs, n_hops, w_hours)),
                        **f32),
        rel0=torch.tensor(rng.integers(0, 37, n_pairs) * 300.0, **f64),
        tc=torch.tensor([13.0, 46800.0, 3.0, 0.87, -8.4], **f64),
        scl=torch.tensor(rng.uniform(0.9, 1.1, (n_pairs, s_pad)), **f64),
        pidx=torch.tensor(rng.integers(0, n_pairs, (n_cells, 2)),
                          dtype=torch.int32, device=dev),
        wd=torch.tensor(wd, **f64), sla=torch.tensor(sla, **f64),
        t_pad=t_pad)


# (pairs, hops, t_pad, S_pad, cells): one CTA; a length that is no multiple
# of a segment, and one that is odd (no 16-byte stores); the first and the
# last chunk of a 4096-job window; 64 slots; two rounds of an 8-CTA
# cluster; 3 hops (idle warps) and 11 (two hop groups, more live hops than
# the sweep unrolls). Cell counts are no multiple of the 4 cells a sweep
# CTA takes.
EDGES = {"one_cta": (8, 8, 512, 16, 13),
         "ragged_t": (16, 8, 700, 48, 37),
         "odd_t": (16, 8, 701, 48, 37),
         "first_chunk": (128, 8, 2048, 48, 1713),
         "last_chunk": (64, 8, 3072, 48, 490),
         "s_pad_64": (32, 8, 3072, 64, 101),
         "two_rounds": (16, 8, 4608, 48, 66),
         "three_hops": (8, 3, 1024, 16, 21),
         "eleven_hops": (8, 11, 1536, 32, 30)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EDGES))
def test_kernels_match_plain_at_tile_edges_on_the_card(name):
    """Both kernels against their plain versions, under chip_smoke.py's
    gates, at the edges of their tiles; cell 1 (n_valid 0) gives
    [+inf, +inf, 0]. Needs a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path.insert(0, str(ref.REPO))
    import chip_smoke as cs
    x = _edge_inputs(*EDGES[name], seed=len(name))
    args = (x.pp, x.zn, x.hn, x.rel0, x.tc)
    r_k, e_k = grid_cuda.rate_prefix(*args, dt_s=ref.DT_S, t_pad=x.t_pad)
    r_p, e_p = grid_cuda.rate_prefix_plain(*args, dt_s=ref.DT_S,
                                           t_pad=x.t_pad)
    err = cs.rate_prefix_errors(r_k, e_k, r_p, e_p)
    assert cs.rate_prefix_ok(err), err
    kw = dict(stride=ref.STRIDE, dt_s=ref.DT_S, slot_s=ref.SLOT_S)
    b_k = grid_cuda.sweep(e_k, r_k, x.scl, x.pidx, x.wd, x.sla, **kw)
    b_p = grid_cuda.sweep_plain(e_k, r_k, x.scl, x.pidx, x.wd, x.sla, **kw)
    err = cs.sweep_errors(b_k, b_p)
    assert cs.sweep_ok(err), err
    assert b_k[1].tolist() == [math.inf, math.inf, 0.0]
    assert bool(torch.isfinite(b_p[:, 0]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("s_pad", [16, 48, 64])
def test_sweep_ties_go_to_the_lower_slot_on_the_card(s_pad):
    """Exact cost ties within and across tiles of 16 slots (rates of 1.0,
    so E is exact; no perf weight; the first tile made dearer by the drift
    table): every cell with a slot past the first tile picks slot 16, the
    first of the tie, and every other feasible cell slot 0, as the plain
    version's argmin does. Needs a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path.insert(0, str(ref.REPO))
    import chip_smoke as cs
    x = _edge_inputs(16, 8, 3072, s_pad, 203, seed=s_pad)
    a, h, t_pad = 16, 8, 3072
    r = torch.ones(a, h, t_pad, dtype=torch.float32, device="cuda")
    e = torch.arange(t_pad, dtype=torch.float64, device="cuda") \
        .expand(a, h, t_pad).contiguous()
    scl = torch.ones_like(x.scl)
    scl[:, :16] = 2.0
    sla = x.sla.clone()
    sla[:, 4] = 0.0
    sla[:, 6] = math.inf
    kw = dict(stride=ref.STRIDE, dt_s=ref.DT_S, slot_s=ref.SLOT_S)
    b_k = grid_cuda.sweep(e, r, scl, x.pidx, x.wd, sla, **kw)
    b_p = grid_cuda.sweep_plain(e, r, scl, x.pidx, x.wd, sla, **kw)
    err = cs.sweep_errors(b_k, b_p)
    assert cs.sweep_ok(err), err
    deep = sla[:, 2] > 16
    shallow = (sla[:, 2] > 0) & ~deep
    assert int(shallow.sum()) > 0 and (s_pad == 16 or int(deep.sum()) > 0)
    assert bool((b_k[deep, 2] == 16).all())
    assert bool((b_k[shallow, 2] == 0).all())


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
