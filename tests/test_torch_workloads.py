"""Workloads, the zone lattice and trace ingestion: the port's copies
against the reference's.

Every named scenario yields the reference's jobs at a seed, and so do the
arrival processes, size laws, ``merge_streams`` and ``as_stream``. The
8/64/200-zone lattice presets build the reference's zones, tiers, routes
and capacities, and the field answers their traces bit for bit;
``tests/data/lattice8_day.csv`` ingests, answers and exports as the
reference does; ``best_source_batch`` ranks as the reference and the
scalar ``best_source``; the rollup's tier column names lattice tiers; and
the first 30 jobs of ``edge_lattice_day`` run through the port's sharded
fleet (numpy backends) to the reference's report and rollup.
"""
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest

import _torch_ref as ref
from repro.core.carbon import field as r_field
from repro.core.carbon import ingest as r_ingest
from repro.core.carbon import lattice as r_lattice
from repro.core.controlplane import sharded as r_sharded
from repro.core.obs import CarbonLedgerView as RefLedgerView
from repro.core.obs import rollup as r_rollup
from repro.core.scheduler import space_shift as r_space_shift
from repro.core.workloads import generators as r_gen
from repro.core.workloads import scenarios as r_scenarios
from repro_torch.core.carbon import field, ingest, lattice
from repro_torch.core.controlplane import sharded
from repro_torch.core.obs import CarbonLedgerView
from repro_torch.core.obs import rollup
from repro_torch.core.scheduler import space_shift
from repro_torch.core.workloads import generators as gen
from repro_torch.core.workloads import scenarios

DATA = Path(__file__).resolve().parent / "data"
DAY_S = 24 * 3600.0


def _job_rows(jobs):
    return [dataclasses.astuple(j) for j in jobs]


@pytest.mark.parametrize("name", sorted(r_scenarios.SCENARIOS))
def test_every_scenario_yields_the_reference_jobs(name):
    assert sorted(scenarios.SCENARIOS) == sorted(r_scenarios.SCENARIOS)
    sc, rsc = scenarios.get_scenario(name), r_scenarios.get_scenario(name)
    assert (sc.name, sc.description, sc.horizon_s) == \
        (rsc.name, rsc.description, rsc.horizon_s)
    assert [dataclasses.astuple(f) for f in sc.ftns] == \
        [dataclasses.astuple(f) for f in rsc.ftns]
    assert [dataclasses.astuple(s) for s in sc.shocks] == \
        [dataclasses.astuple(s) for s in rsc.shocks]
    for seed in (7, 42):
        got = list(sc.jobs(seed, ref.T0))
        assert got and _job_rows(got) == _job_rows(rsc.jobs(seed, ref.T0))
    stream = list(gen.as_stream(list(reversed(got))))
    assert _job_rows(stream) == _job_rows(
        r_gen.as_stream(list(reversed(list(rsc.jobs(42, ref.T0))))))


ARRIVALS = (("PoissonArrivals", dict(rate_per_h=9.0)),
            ("DiurnalArrivals", dict(rate_per_h=12.0, amplitude=0.6)),
            ("MMPPArrivals", dict(rate_calm_per_h=4.0,
                                  rate_burst_per_h=40.0)),
            ("ReplayArrivals", dict(offsets=(5.0, 60.0, 60.0, 9000.0))))
SIZES = (("ParetoSizes", dict(alpha=1.5, scale_gb=40.0)),
         ("LognormalSizes", dict(median_gb=200.0, sigma=0.8)),
         ("UniformSizes", dict(lo_gb=50.0, hi_gb=500.0)),
         ("FixedSizes", dict(gb=123.0)))


@pytest.mark.parametrize("arrival,size", list(itertools.product(
    range(len(ARRIVALS)), range(len(SIZES)))))
def test_arrival_processes_and_size_laws_match_the_reference(arrival, size):
    def workload(mod):
        (a, akw), (s, skw) = ARRIVALS[arrival], SIZES[size]
        return mod.Workload("w", getattr(mod, a)(**akw),
                            getattr(mod, s)(**skw),
                            replica_sets=(("uc",), ("uc", "site_qc")),
                            deadline_h=(4.0, 30.0))

    got = list(workload(gen).jobs(3, ref.T0, DAY_S))
    want = list(workload(r_gen).jobs(3, ref.T0, DAY_S))
    assert got and _job_rows(got) == _job_rows(want)
    merged = gen.merge_streams(iter(got), workload(gen).jobs(4, ref.T0,
                                                             DAY_S))
    r_merged = r_gen.merge_streams(iter(want), workload(r_gen).jobs(
        4, ref.T0, DAY_S))
    assert _job_rows(merged) == _job_rows(r_merged)


@pytest.mark.parametrize("zones", [8, 64, 200])
def test_lattice_presets_match_the_reference(zones):
    lat, rlat = lattice.default_lattice(zones), r_lattice.default_lattice(
        zones)
    assert lattice.default_lattice(zones) is lat
    assert lat.spec == rlat.spec and lat.zones == rlat.zones
    assert [dataclasses.astuple(lat.regions[c]) for c in lat.cells] == \
        [dataclasses.astuple(rlat.regions[c]) for c in rlat.cells]
    assert [lat.tier(c) for c in lat.cells] == \
        [rlat.tier(c) for c in rlat.cells]
    for tier in (None, "edge", "metro", "core"):
        assert lat.endpoints(tier) == rlat.endpoints(tier)
    eps = lat.endpoints()
    pairs = list(zip(eps[::7], eps[3::11])) + [(eps[0], "tacc"),
                                               ("uc", eps[-1])]
    for a, b in pairs:
        assert lat.route_mids(a, b) == rlat.route_mids(a, b)
        assert lat.capacity(a, b) == rlat.capacity(a, b)
        assert lattice.tier_of_endpoint(a) == r_lattice.tier_of_endpoint(a)
    ts = ref.T0 + 900.0 * np.arange(96)
    got = field.CarbonField().ci(lat.zones, ts)
    assert got.tolist() == r_field.CarbonField().ci(rlat.zones, ts).tolist()
    assert ("repro_torch.core.carbon.lattice:install_spec",
            (lat.spec,)) in field._FIELD_SETUP


def test_ingest_of_the_day_csv_matches_the_reference():
    path = str(DATA / "lattice8_day.csv")
    traces, rtraces = ingest.load_csv(path), r_ingest.load_csv(path)
    assert sorted(traces) == sorted(rtraces) and len(traces) == 8
    for z, tr in traces.items():
        assert (tr.zone, tr.hour0, tr.values.tolist(), tr.filled) == \
            (rtraces[z].zone, rtraces[z].hour0, rtraces[z].values.tolist(),
             rtraces[z].filled)
    f, rf = field.CarbonField(), r_field.CarbonField()
    ingest.install_traces(traces, f)
    r_ingest.install_traces(rtraces, rf)
    text = (DATA / "lattice8_day.csv").read_text()
    assert ingest.export_csv(f, traces) == r_ingest.export_csv(rf, rtraces) \
        == text
    assert ingest.synthetic_lattice_csv(8, hours=24) == text
    ts = ref.T0 - 6 * 3600.0 + 1800.0 * np.arange(72)
    for calibrated in (True, False):
        assert f.ci(sorted(traces), ts, calibrated).tolist() == \
            rf.ci(sorted(rtraces), ts, calibrated).tolist()
    with pytest.raises(ingest.IngestError):
        ingest.parse_csv("datetime,zone,carbon_intensity_gco2_kwh\n"
                         "not-a-time,Z,1.0\n")


def test_best_source_batch_matches_the_reference_and_the_scalar():
    lat = lattice.default_lattice(200)
    eps = lat.endpoints()
    dst = lat.endpoints("core")[0]
    sets = [tuple(eps[i::40]) for i in range(12)]
    t = ref.T0 + 7 * 3600.0
    got = space_shift.best_source_batch(sets, dst, t)
    want = r_space_shift.best_source_batch(sets, dst, t)
    for reps, g, w in zip(sets, got, want):
        assert (g.source, g.expected_ci, g.ranking) == \
            (w.source, w.expected_ci, w.ranking)
        scalar = space_shift.best_source(reps, dst, t)
        assert g.source == scalar.source
        assert [s for s, _ in g.ranking] == [s for s, _ in scalar.ranking]
    with pytest.raises(ValueError, match="no replicas"):
        space_shift.best_source_batch([()], dst, t)


def test_rollup_tiers_name_lattice_tiers():
    lat = lattice.default_lattice(200)
    for ep in lat.endpoints()[::17] + ["uc", "tacc", "site_qc"]:
        assert rollup._tier_of(ep) == r_rollup._tier_of(ep)
    assert {rollup._tier_of(ep) for ep in lat.endpoints()} == \
        {"edge", "metro", "core"}
    assert rollup._tier_of("uc") == "-"


def test_edge_lattice_day_matches_the_reference():
    """The slice as a whole on the lattice: the first 30 jobs of
    ``edge_lattice_day`` through a 2-shard fleet with numpy backends make
    the reference's report (trace and metrics included) and rollup, with
    at least one cross-tier placement."""
    def day(sharded_mod, scenarios_mod, **kw):
        sc = scenarios_mod.get_scenario("edge_lattice_day")
        jobs = list(itertools.islice(sc.jobs(seed=7, t0=ref.T0), 30))
        fleet = sharded_mod.ShardedFleet(
            list(sc.ftns), n_shards=2, migration_threshold=250.0,
            batch_backend="numpy", shard_backend="numpy", obs=True, **kw)
        fleet.submit_many(jobs)
        return jobs, fleet.run()

    jobs, got = day(sharded, scenarios, device="cpu")
    _, want = day(r_sharded, r_scenarios)
    ref.assert_reports_identical(got, want)
    assert CarbonLedgerView.from_report(got).render("lattice") == \
        RefLedgerView.from_report(want).render("lattice")
    tiers = {r["key"] for r in CarbonLedgerView.from_report(got).by_tier()}
    assert tiers - {"-"}, tiers
    by_uuid = {j.uuid: j for j in jobs}
    cross = [o for o in got.outcomes
             if o.source != by_uuid[o.job_uuid].replicas[0]
             and lattice.tier_of_endpoint(o.source)
             != lattice.tier_of_endpoint(by_uuid[o.job_uuid].replicas[0])]
    assert got.n_completed == 30 and cross
