"""The whole slice: ``TorchCarbonPlanner`` against the reference planner.

On 64 ``planner_scale`` jobs the port's ``fused`` and ``torch`` batch
backends pick the reference numpy ``plan_batch``'s cell for every job,
emissions within 1e-4 relative, and the cells of the revived reference
planner on its Pallas backend (emissions within 1e-6: both run an f32 CI
chain). Also: the drift hook, ``rescore_batch`` on the lattice at >= 512
cells, the ``_MAX_GRID`` per-job fallback and the metrics hook.
"""
import dataclasses

import numpy as np
import pytest

import _torch_ref as ref
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core.obs.metrics import MetricsRegistry
from repro_torch.core.scheduler import overlay, planner

BACKENDS = ("fused", "torch")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref.warm_up_torch()
    return ref.run_reference("planner",
                             tmp_path_factory.mktemp("ref") / "p.npz")


def _port(backend, specs=ref.SCALE_CASES["planner"], scaled=False):
    pl = planner.TorchCarbonPlanner(ref.make_ftns(overlay, ref.SCALE_FTNS),
                                    device="cpu", batch_backend=backend)
    if scaled:
        pl.emission_scale_fn = ref.drift
    return pl, ref.make_jobs(planner, specs)


def _ref_numpy(specs=ref.SCALE_CASES["planner"], scaled=False):
    pl = r_planner.CarbonPlanner(ref.make_ftns(r_overlay, ref.SCALE_FTNS))
    if scaled:
        pl.emission_scale_fn = ref.drift
    return pl, ref.make_jobs(r_planner, specs)


def _same_cells(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.job_uuid, g.start_t, g.source, g.ftn, g.feasible,
                g.alternatives) == (w.job_uuid, w.start_t, w.source, w.ftn,
                                    w.feasible, w.alternatives)
        assert g.predicted_emissions_g == pytest.approx(
            w.predicted_emissions_g, rel=rel)
        assert g.cost == pytest.approx(w.cost, rel=rel)
        assert g.predicted_avg_ci == pytest.approx(w.predicted_avg_ci,
                                                   rel=1e-12)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "drift"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_plans_match_reference_numpy_plan_batch(backend, scaled):
    pl, jobs = _port(backend, scaled=scaled)
    rpl, rjobs = _ref_numpy(scaled=scaled)
    got = pl.plan_batch(jobs)
    assert pl.last_batch_cells > len(jobs)     # the batch path ran
    _same_cells(got, rpl.plan_batch(rjobs), rel=1e-4)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "drift"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_plans_match_revived_reference_pallas(reference, backend, scaled):
    pl, jobs = _port(backend, scaled=scaled)
    got = pl.plan_batch(jobs)
    want = {k: reference[f"pallas/{'drift' if scaled else 'plain'}/{k}"]
            for k in ("start_t", "source", "ftn", "feasible", "emis",
                      "alternatives")}
    for j, p in enumerate(got):
        assert (p.start_t, p.source, p.ftn, p.feasible, p.alternatives) == (
            want["start_t"][j], want["source"][j], want["ftn"][j],
            want["feasible"][j], want["alternatives"][j])
        assert p.predicted_emissions_g == pytest.approx(want["emis"][j],
                                                        rel=1e-6)


def test_numpy_backend_is_the_reference_oracle_bit_for_bit():
    pl, jobs = _port("numpy")
    rpl, rjobs = _ref_numpy()
    _same_cells(pl.plan_batch(jobs), rpl.plan_batch(rjobs), rel=0)
    assert pl.last_batch_cells == 0           # never left the oracle


@pytest.fixture(scope="module")
def planned_512():
    """512 jobs planned by both oracles: the previous plans to re-score."""
    specs = [ref.scale_spec(i) for i in range(512)]
    pl, jobs = _port("numpy", specs)
    rpl, rjobs = _ref_numpy(specs)
    return specs, jobs, pl.plan_batch(jobs), rpl, rjobs, rpl.plan_batch(rjobs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rescore_batch_on_the_lattice_matches_reference_rescore(
        backend, planned_512, monkeypatch):
    """>= 512 single-slot cells re-score in one lattice call; each matches
    the reference's per-job numpy re-score within 1e-6."""
    specs, jobs, prev, rpl, rjobs, rprev = planned_512
    pl, _ = _port(backend, specs)
    calls = []
    real = planner.batch_cell_emissions
    monkeypatch.setattr(planner, "batch_cell_emissions",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # a later "now": some starts are in the past and must come back None
    late = [dataclasses.replace(j, submitted_t=j.submitted_t + 7200.0)
            for j in jobs]
    rlate = [dataclasses.replace(j, submitted_t=j.submitted_t + 7200.0)
             for j in rjobs]
    got = pl.rescore_batch(late, prev)
    assert calls == [1]
    n_live = 0
    for g, rj, rp in zip(got, rlate, rprev):
        w = rpl.rescore(rj, rp)
        assert (g is None) == (w is None)
        if w is None:
            continue
        n_live += 1
        assert g.feasible == w.feasible
        assert g.predicted_emissions_g == pytest.approx(
            w.predicted_emissions_g, rel=1e-6)
        assert g.cost == pytest.approx(w.cost, rel=1e-6)
    assert 0 < n_live < len(jobs)


def test_incremental_plan_batch_keeps_undrifted_cells():
    """With ``previous`` and ``drift_tol`` every job whose re-score moved
    by at most the tolerance keeps its cell; the rest re-plan."""
    pl, jobs = _port("fused")
    prev = pl.plan_batch(jobs)
    again = pl.plan_batch(jobs, previous=prev, drift_tol=1e-3)
    for a, b in zip(again, prev):
        assert (a.start_t, a.source, a.ftn) == (b.start_t, b.source, b.ftn)


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_grid_fallback_goes_to_the_numpy_plan(backend):
    """A job whose rate grid exceeds ``_MAX_GRID`` (a 40-day deadline) is
    planned by the numpy ``plan()``; the rest of the batch stays on the
    batch path, and every plan equals the reference's."""
    specs = [ref.scale_spec(i) for i in range(9)]
    specs[4] = ("long", 300e9, ("uc", "m1"), "tacc", 40 * 86400.0, None,
                ref.T0 + 900.0)
    pl, jobs = _port(backend, specs)
    rpl, rjobs = _ref_numpy(specs)
    got = pl.plan_batch(jobs)
    cells, _, meta = pl._batch_cells(jobs, ref.DT_S, ref.STRIDE)
    assert meta[4] is None and all(m is not None for i, m in enumerate(meta)
                                   if i != 4)
    assert pl.last_batch_cells == len(cells)
    _same_cells(got, rpl.plan_batch(rjobs), rel=1e-4)


def test_small_batches_stay_on_the_oracle():
    pl, jobs = _port("fused")
    got = pl.plan_batch(jobs[:planner.TorchCarbonPlanner._BATCH_MIN_JOBS - 1])
    assert pl.last_batch_cells == 0
    rpl, rjobs = _ref_numpy()
    _same_cells(got, rpl.plan_batch(rjobs[:len(got)]), rel=0)


def test_observe_with_records_plan_batch_metrics():
    class _Obs:
        registry = MetricsRegistry()

    pl, jobs = _port("fused")
    pl.observe_with(_Obs())
    plans = pl.plan_batch(jobs)
    assert all(p.greedy_g is not None and np.isfinite(p.greedy_g)
               for p in plans)
    snap = _Obs.registry.snapshot()
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in snap["counters"]}
    assert counters[("planner_plan_batches_total",
                     (("backend", "fused"),))] == 1
    assert counters[("planner_cells_scored_total", ())] == sum(
        p.alternatives for p in plans)
    assert [h["n"] for h in snap["histograms"]
            if h["name"] == "planner_plan_batch_wall_s"] == [1]
