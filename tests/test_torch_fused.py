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


# --- the CUDA kernels' order of work, and chip_smoke.py's gates -------------
#
# The kernels run only on the card; chip_smoke.py holds them to their plain
# versions there. Here their order of work is emulated in torch on the CPU,
# to show that those gates pass it and fail named faults.

RUN, LANES, SEG, MAX_CLUSTER = 16, 32, 512, 8   # planner_kernels.cu's
SLOT_TILE, HOP_UNROLL = 16, 8


def _chip_smoke():
    sys.path.insert(0, str(ref.REPO))
    import chip_smoke
    return chip_smoke


def _rate_prefix_order(r, *, inclusive=False, run_carry=True,
                       segment_carry=True, round_carry=True,
                       f32_sum=False):
    """E as ``rate_prefix_kernel`` sums the rates r (A, H, T): a cluster of
    up to 8 CTAs of 512 steps per pair and round; in a CTA one warp per
    hop, each lane summing its 16 steps serially, a Hillis-Steele scan
    over the lanes' sums, the earlier segments' totals added in rank
    order, and the earlier rounds' totals carried. Faults: an inclusive
    prefix, a carry dropped between runs, segments or rounds, the sums
    in f32."""
    a, h, t = r.shape
    acc = torch.float32 if f32_sum else torch.float64
    n_cta = min(-(-t // SEG), MAX_CLUSTER)
    rounds = -(-t // (n_cta * SEG))
    x = torch.zeros(a, h, rounds * n_cta * SEG, dtype=acc)
    x[..., :t] = r.to(acc)
    x = x.reshape(a, h, rounds, n_cta, LANES, RUN)
    lane_sum = torch.zeros(x.shape[:-1], dtype=acc)
    for j in range(RUN):
        lane_sum = lane_sum + x[..., j]
    incl = lane_sum
    for off in (1, 2, 4, 8, 16):
        up = torch.zeros_like(incl)
        up[..., off:] = incl[..., :-off]
        incl = torch.where(torch.arange(LANES) >= off, incl + up, incl)
    excl = torch.zeros_like(incl)
    if run_carry:
        excl[..., 1:] = incl[..., :-1]
    seg_tot = incl[..., -1]                               # (A,H,rounds,cta)
    before = torch.zeros_like(seg_tot)
    round_tot = torch.zeros(seg_tot.shape[:-1], dtype=acc)
    for q in range(n_cta):
        v = seg_tot[..., q]
        before[..., q + 1:] = before[..., q + 1:] + v[..., None]
        round_tot = round_tot + v
    carry = torch.zeros_like(round_tot)
    for k in range(1, rounds):
        carry[..., k] = carry[..., k - 1] + round_tot[..., k - 1]
    if not segment_carry:
        before = torch.zeros_like(before)
    if not round_carry:
        carry = torch.zeros_like(carry)
    run = (carry[..., None] + before)[..., None] + excl
    e = torch.zeros_like(x)
    for j in range(RUN):
        if not inclusive:
            e[..., j] = run
        run = run + x[..., j]
        if inclusive:
            e[..., j] = run
    return e.reshape(a, h, -1)[..., :t].double()


def _sweep_order(e, r, scl, pidx, wd, sla, *, stride, dt_s, slot_s,
                 later_ties=False, skip_live=False):
    """best (C, 3) as ``sweep_kernel`` computes it: each leg's hops with a
    non-zero weight compacted in hop order and summed in that order; tiles
    of 16 slots that stop at n_valid; the legs added as (0 + leg 0) + leg
    1; a 16-lane shuffle tree (xor 8, 4, 2, 1) taking the first minimum by
    (cost, slot); a later tile replacing the best only if strictly
    cheaper. Faults: ties going to the later slot, each leg's last live
    hop skipped."""
    a, h, t_pad = e.shape
    c, s_pad = pidx.shape[0], scl.shape[1]
    n = sla[:, 0].long()
    rem, nval, dur = sla[:, 1], sla[:, 2], sla[:, 3]
    wp, wc, budget, sub = sla[:, 4], sla[:, 5], sla[:, 6], sla[:, 7]
    p = pidx.long()
    live = wd != 0                                        # (C,2,H)
    if skip_live:
        last = torch.where(live, torch.arange(h), -1).amax(dim=2)
        live = live & (torch.arange(h) != last[..., None])
    n_tiles = -(-s_pad // SLOT_TILE)
    slots = torch.arange(n_tiles * SLOT_TILE)             # (S_t,)
    valid = (slots[None, :] < s_pad) & (slots.double()[None, :]
                                        < nval[:, None])  # (C,S_t)
    sc = slots.clamp(max=s_pad - 1)
    k = sc * stride
    hi = (k[None, :] + n[:, None] - 1).clamp(0, t_pad - 1)
    kc = k.clamp(max=t_pad - 1)
    e_f, r_f = e.reshape(-1), r.reshape(-1)
    g = []
    for leg in range(2):
        seg_w = torch.zeros(c, len(slots), dtype=torch.float64)
        last_w = torch.zeros_like(seg_w)
        for hop in range(h):                              # compacted order
            rb = ((p[:, leg] * h + hop) * t_pad)[:, None]
            w = wd[:, leg, hop][:, None]
            on = live[:, leg, hop][:, None]
            seg_w = torch.where(on, seg_w + w * (e_f[rb + hi]
                                                 - e_f[rb + kc]), seg_w)
            last_w = torch.where(on, last_w + w * r_f[rb + hi].double(),
                                 last_w)
        leg_g = (seg_w * dt_s + last_w * rem[:, None]) / 3.6e6
        g.append(leg_g * scl[p[:, leg]][:, sc])
    emis = (0.0 + g[0]) + g[1]
    ts = sub[:, None] + slot_s * slots.double()[None, :]
    cost = wc[:, None] * emis + wp[:, None] * ((ts + dur[:, None])
                                               - sub[:, None])
    feas = valid & (emis <= budget[:, None])
    cost = torch.where(feas, cost, torch.inf)
    emis = torch.where(feas, emis, torch.inf)
    shape = (c, n_tiles, SLOT_TILE)
    cost, emis = cost.reshape(shape), emis.reshape(shape)
    slot = slots.reshape(1, n_tiles, SLOT_TILE).expand(shape)
    lane = torch.arange(SLOT_TILE)
    for off in (8, 4, 2, 1):
        oc, oe, os = (v[..., lane ^ off] for v in (cost, emis, slot))
        tie = (os > slot) if later_ties else (os < slot)
        take = (oc < cost) | ((oc == cost) & tie)
        cost, emis, slot = (torch.where(take, o, v) for o, v in
                            ((oc, cost), (oe, emis), (os, slot)))
    b_cost = torch.full((c,), torch.inf, dtype=torch.float64)
    b_emis = torch.full((c,), torch.inf, dtype=torch.float64)
    b_slot = torch.zeros(c, dtype=torch.long)
    for tile in range(n_tiles):
        tc, te, ts_ = cost[:, tile, 0], emis[:, tile, 0], slot[:, tile, 0]
        better = (tc <= b_cost) & (tc < torch.inf) if later_ties \
            else tc < b_cost
        b_cost = torch.where(better, tc, b_cost)
        b_emis = torch.where(better, te, b_emis)
        b_slot = torch.where(better, ts_, b_slot)
    return torch.stack([b_cost, b_emis, b_slot.double()], dim=1)


@pytest.fixture(scope="module")
def chunk():
    """A real chunk of planner_scale cells (312 cells, 64 pairs x 8 hops,
    32 slots), built by the port's own table builders."""
    ref.warm_up_torch()
    pl = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ref.SCALE_FTNS),
                                    device="cpu", batch_backend="fused")
    jobs = ref.make_jobs(planner, ref.SCALE_CASES["planner"])
    cells, sla_rows, _ = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    t = grid_torch._chunk_tables(pl.field, cells, dt_s=ref.DT_S,
                                 slot_stride=ref.STRIDE,
                                 cell_bucket=grid_torch._B_CELLS)
    return grid_cuda.fused_inputs(
        grid_torch.tables_to_device(t, "cpu"),
        grid_cuda.sla_table(t, np.asarray(sla_rows)),
        grid_cuda.scale_table(t, ref.SLOT_S, ref.drift)), len(cells)


@pytest.mark.parametrize("t_pad", [512, 1536, 3072, 4608])
def test_rate_prefix_gate_passes_the_kernel_order_and_fails_faults(chunk,
                                                                   t_pad):
    """``chip_smoke.py``'s rate_prefix gate on the kernel's order of sums,
    at one CTA (512), a 3- and a 6-CTA cluster (the first and the last
    chunk's lengths, 1536 here) and two rounds of 8 CTAs (4608): the
    order passes; an inclusive prefix, a carry dropped between lanes'
    runs, between segments or between rounds, and f32 sums each fail."""
    cs = _chip_smoke()
    x, _ = chunk
    r, e = grid_cuda.rate_prefix_plain(x.pp, x.zn, x.hn, x.rel0, x.tc,
                                       dt_s=ref.DT_S, t_pad=t_pad)

    def ok(**fault):
        return cs.rate_prefix_ok(cs.rate_prefix_errors(
            r, _rate_prefix_order(r, **fault), r, e))

    err = cs.rate_prefix_errors(r, _rate_prefix_order(r), r, e)
    assert err["e_max_rel_err_of_row_total"] < cs.RATE_E_TOL_OF_ROW / 100
    assert ok()
    faults = [{"inclusive": True}, {"run_carry": False}, {"f32_sum": True}]
    if t_pad > SEG:
        faults.append({"segment_carry": False})
    if t_pad > SEG * MAX_CLUSTER:
        faults.append({"round_carry": False})
    for fault in faults:
        assert not ok(**fault), fault


def test_sweep_gate_passes_the_kernel_order_and_fails_faults(chunk):
    """``chip_smoke.py``'s sweep gate on the kernel's order of work on a
    real chunk with the drift hook: hop compaction, tiles of 16 slots up
    to n_valid and the grouped first-min pass; skipping a live hop
    fails."""
    cs = _chip_smoke()
    x, n_cells = chunk
    r, e = grid_cuda.rate_prefix_plain(x.pp, x.zn, x.hn, x.rel0, x.tc,
                                       dt_s=ref.DT_S, t_pad=x.t_pad)
    kw = dict(stride=ref.STRIDE, dt_s=ref.DT_S, slot_s=ref.SLOT_S)
    args = (e, r, x.scl, x.pidx, x.wd, x.sla)
    want = grid_cuda.sweep_plain(*args, **kw)
    assert 0 < int(torch.isfinite(want[:, 0]).sum()) <= n_cells
    assert bool((x.wd[:n_cells] == 0).any()) and bool(
        (x.sla[:n_cells, 2] < x.scl.shape[1]).any())
    err = cs.sweep_errors(_sweep_order(*args, **kw), want)
    assert cs.sweep_ok(err) and err["max_rel_err"] < cs.SWEEP_TOL_REL / 100
    assert not cs.sweep_ok(cs.sweep_errors(
        _sweep_order(*args, skip_live=True, **kw), want))


def test_sweep_gate_fails_ties_to_the_later_slot(chunk):
    """Exact cost ties within and across tiles of 16 slots: rates of 1.0
    (so E is exact), no perf weight and a drift table that makes the first
    tile dearer. The kernel's order picks slot 16, as the plain version's
    argmin does; ties going to the later slot fail the gate."""
    cs = _chip_smoke()
    x, n_cells = chunk
    a, h, _ = x.zn.shape
    t_pad, s_pad = x.t_pad, x.scl.shape[1]
    r = torch.ones(a, h, t_pad, dtype=torch.float32)
    e = torch.arange(t_pad, dtype=torch.float64).expand(a, h, t_pad) \
        .contiguous()
    scl = torch.ones_like(x.scl)
    scl[:, :SLOT_TILE] = 2.0
    sla = x.sla.clone()
    sla[:, 4] = 0.0                                      # w_perf
    sla[:, 6] = torch.inf                                # no budget
    kw = dict(stride=ref.STRIDE, dt_s=ref.DT_S, slot_s=ref.SLOT_S)
    args = (e, r, scl, x.pidx, x.wd, sla)
    want = grid_cuda.sweep_plain(*args, **kw)
    deep = (sla[:n_cells, 2] > SLOT_TILE + 1) & (x.wd[:n_cells] != 0) \
        .any(dim=(1, 2))
    assert int(deep.sum()) > 10
    assert bool((want[:n_cells][deep, 2] == SLOT_TILE).all())
    assert cs.sweep_ok(cs.sweep_errors(_sweep_order(*args, **kw), want))
    assert not cs.sweep_ok(cs.sweep_errors(
        _sweep_order(*args, later_ties=True, **kw), want))


@pytest.mark.parametrize("case", CASES)
def test_kernel_order_matches_pallas_interpret(reference, case):
    """The emulated kernels on the reference's own inputs give the
    reference kernels' slots, emissions and costs."""
    cs = _chip_smoke()
    for i in range(int(reference[f"{case}/n_chunks"])):
        got = _ref_inputs(reference, case, i)
        t = {k: torch.as_tensor(v) for k, v in got.items()}
        r_ref = torch.as_tensor(reference[f"{case}/{i}/out/r"])
        e = _rate_prefix_order(r_ref)
        assert cs.rate_prefix_ok(cs.rate_prefix_errors(
            r_ref, e, r_ref, torch.as_tensor(reference[f"{case}/{i}/out/e"])
            .double()))
        best = _sweep_order(e, r_ref, t["scl"], t["pidx"], t["wd"],
                            t["sla"], stride=ref.STRIDE, dt_s=ref.DT_S,
                            slot_s=ref.SLOT_S)
        want = torch.as_tensor(reference[f"{case}/{i}/out/best"])
        assert torch.equal(best[:, 2], want[:, 2])
        torch.testing.assert_close(best[:, :2], want[:, :2], rtol=1e-6,
                                   atol=0)
