"""The fleet observatory: the port's ``core/obs`` copies against the
reference's.

Spans and their sinks write the reference's bytes; ``Pmeter`` on an
injected sim clock records the reference's records, and ``observe_pmeter``
folds them into the same series; ``CarbonLedgerView`` over the port's
numpy-backend trace gives the reference's rows, decision counts and
rendered tables; and an obs-on run reports the same physics as an obs-off
run on every backend (``tests/test_obs.py:149-161``).
"""
import dataclasses
import json

import pytest

import _torch_ref as ref
from repro.core import obs as r_obs
from repro.core.carbon import telemetry as r_telemetry
from repro.core.controlplane import FleetController as RefController
from repro.core.scheduler import overlay as r_overlay
from repro.core.scheduler import planner as r_planner
from repro_torch.core import obs
from repro_torch.core.carbon import telemetry
from repro_torch.core.controlplane import FleetController, ShardedFleet
from repro_torch.core.obs.metrics import NULL_INSTRUMENT
from repro_torch.core.scheduler import overlay, planner

SPANS = [(1.0, 1, "admit", "j1", (("ci", 100.5), ("zone", "CA-QC"))),
         (2.0, 2, "complete", "j1", (("actual_g", 5.0),)),
         (2.0, 3, "replan", "", ()),
         (2.5, 4, "plan", "", (("cause", "shock"), ("changed", 3)))]


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


def _ctl_run(controller, overlay_mod, planner_mod, **kw):
    """test_obs's ``_mk_ctl``: 12 jobs submitted one by one, a shock."""
    ctl = controller(ref.make_ftns(overlay_mod, ref.FLEET_FTNS),
                     migration_threshold=250.0, obs=True, **kw)
    for job in ref.fleet_jobs(planner_mod, ref.obs_specs(12)):
        ctl.submit(job)
    ref.shock(ctl)
    return ctl.run()


@pytest.fixture(scope="module")
def reports():
    port_planner = planner.TorchCarbonPlanner(
        ref.make_ftns(overlay, ref.FLEET_FTNS), device="cpu",
        batch_backend="numpy")
    return (_ctl_run(FleetController, overlay, planner,
                     planner=port_planner, device="cpu"),
            _ctl_run(RefController, r_overlay, r_planner))


def test_spans_and_sinks_write_the_references_bytes(tmp_path):
    spans = [obs.Span(*s) for s in SPANS]
    want = [r_obs.Span(*s) for s in SPANS]
    assert spans == want
    assert [sp.to_dict() for sp in spans] == [sp.to_dict() for sp in want]
    assert spans[0].attr("zone") == "CA-QC"
    assert spans[0].attr("missing", 7) == 7
    assert obs.Span.from_dict(spans[0].to_dict()) == spans[0]

    paths = [str(tmp_path / f"{side}.jsonl") for side in ("port", "ref")]
    for mod, sp, path in ((obs, spans, paths[0]), (r_obs, want, paths[1])):
        sink, ring = mod.JsonlSink(path), mod.RingSink(capacity=2)
        assert mod.emit_all(sp, sink, ring) == len(sp)
        sink.close()
        assert ring.spans == tuple(sp[-2:]) and ring.n_emitted == len(sp)
    text = [open(p, "rb").read() for p in paths]
    assert text[0] == text[1] and text[0]
    assert obs.load_jsonl(paths[1]) == spans
    assert isinstance(obs.JsonlSink(paths[0]), obs.TraceSink)
    with pytest.raises(ValueError):
        obs.RingSink(capacity=0)


def test_observer_normalization_and_null_instruments():
    assert obs.as_observer(None) is None and obs.as_observer(False) is None
    o = obs.as_observer(True)
    assert isinstance(o, obs.FleetObserver)
    assert obs.as_observer(o) is o
    assert obs.as_observer(obs.ObsConfig(metrics=False)).registry is None
    with pytest.raises(TypeError):
        obs.as_observer(object())
    quiet = obs.FleetObserver(obs.ObsConfig(trace=False, metrics=False))
    quiet.span("admit", 1.0, "j")
    assert quiet.trace() == ()
    assert quiet.counter("x") is NULL_INSTRUMENT
    assert quiet.metrics_snapshot() is None
    loud, r_loud = obs.FleetObserver(), r_obs.FleetObserver()
    for o in (loud, r_loud):
        o.span("admit", 3.0, "j", zone="CA-QC", ci=101.25)
        o.span("plan", 4.0, cause="shock", changed=2)
        o.counter("fleet_jobs_admitted_total").inc()
        o.histogram("fleet_queue_depth").observe(3)
        o.gauge("g", shard=1).set(2.5)
    assert loud.trace() == r_loud.trace()
    assert loud.metrics_snapshot() == r_loud.metrics_snapshot()


def _pmeter_pair(**kw):
    out = []
    for mod in (telemetry, r_telemetry):
        now = iter(ref.T0 + 30.0 * k for k in range(100))
        out.append(mod.Pmeter("ftn-uc", profile="skylake", clock=now.__next__,
                              **kw))
    return out


def test_pmeter_on_a_sim_clock_records_the_references_records():
    pm, rpm = _pmeter_pair(zone="US-NY-NYIS")
    for p, mod in ((pm, telemetry), (rpm, r_telemetry)):
        for k in range(5):
            tm = mod.TransferMetrics(
                job_uuid=mod.new_job_uuid("uc", k), source_latency_ms=0.2,
                job_size_bytes=10**9, transfer_node_id="tacc",
                buffer_size=1 << 20, parallelism=4, concurrency=2,
                pipelining=4, bytes_received=k * 10**8,
                bytes_sent=k * 10**8)
            p.measure(cpu_util=0.1 * k, mem_util=0.3, tx_gbps=2.0 + k,
                      rx_gbps=0.1, transfer=tm if k % 2 else None)
        p.measure(ref.T0 + 1e4, cpu_util=0.5, mem_util=0.3, tx_gbps=4.0,
                  rx_gbps=0.1)
    assert [r.to_json() for r in pm.records] == \
        [r.to_json() for r in rpm.records]
    assert pm.records[0].t == ref.T0 and pm.records[-1].t == ref.T0 + 1e4
    assert [pm.power_w(r) for r in pm.records] == \
        [rpm.power_w(r) for r in rpm.records]
    assert pm.emissions_g() == rpm.emissions_g() > 0.0
    assert pm.ci(ref.T0 + 77.0) == rpm.ci(ref.T0 + 77.0)
    assert telemetry.new_job_uuid("uc", 5) == \
        r_telemetry.new_job_uuid("uc", 5)
    assert telemetry.new_job_uuid("uc", 5) != telemetry.new_job_uuid("uc", 6)
    assert telemetry.new_job_uuid() != telemetry.new_job_uuid()


@pytest.mark.parametrize("since", [None, ref.T0 + 60.0])
def test_pmeter_bridge_folds_the_references_series(since):
    pm, rpm = _pmeter_pair(zone="US-NY-NYIS")
    for p in (pm, rpm):
        for k in range(6):
            p.measure(cpu_util=0.4, mem_util=0.2, tx_gbps=3.0 + k,
                      rx_gbps=0.2)
    reg, rreg = obs.MetricsRegistry(), r_obs.MetricsRegistry()
    assert obs.observe_pmeter(pm, reg, since=since) == \
        r_obs.observe_pmeter(rpm, rreg, since=since) == \
        (6 if since is None else 3)
    snap = reg.snapshot()
    assert snap == rreg.snapshot()
    counters = {e["name"]: e["value"] for e in snap["counters"]}
    assert counters["pmeter_records_total"] == (6 if since is None else 3)


def test_ledger_view_over_the_numpy_trace_is_the_references(reports):
    got, want = reports
    ref.assert_reports_identical(got, want)
    view = obs.CarbonLedgerView.from_report(got)
    rview = r_obs.CarbonLedgerView.from_report(want)
    assert [dataclasses.astuple(r) for r in view.rows] == \
        [dataclasses.astuple(r) for r in rview.rows]
    tot = view.totals()
    assert tot == rview.totals()
    for fold in ("by_zone", "by_tier", "by_decision"):
        assert getattr(view, fold)() == getattr(rview, fold)()
    assert view.render("unit run") == rview.render("unit run")
    # the reference test's acceptance (tests/test_obs.py:420-447)
    assert tot["jobs"] == got.n_completed
    assert tot["actual_g"] == pytest.approx(got.total_actual_g, rel=1e-9)
    assert tot["greedy_g"] > tot["actual_g"] and tot["saved_g"] > 0.0
    assert "time_shift" in {row["key"] for row in view.by_decision()}
    assert {row["key"] for row in view.by_tier()} == {"-"}
    assert obs.CarbonLedgerView.from_trace(got.trace).totals() == tot
    assert json.dumps(tot, sort_keys=True)


def test_controller_metrics_are_the_references(reports):
    got, want = reports
    assert ref.no_wall(got.metrics) == ref.no_wall(want.metrics)
    counters = {e["name"]: e["value"] for e in got.metrics["counters"]
                if not e["labels"]}
    assert counters["fleet_jobs_admitted_total"] == got.n_jobs
    assert counters["fleet_jobs_completed_total"] == got.n_completed


@pytest.mark.parametrize("backend", ["numpy", "fused", "torch"])
def test_obs_off_run_is_unperturbed(backend):
    """Tracing observes the simulation, never steers it: on every batch
    backend an obs-on and an obs-off fleet report identical physics."""
    def run(o):
        fleet = ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                             n_shards=3, migration_threshold=250.0,
                             batch_backend=backend, obs=o, device="cpu")
        fleet.submit_many(ref.fleet_jobs(planner, ref.obs_specs(10)))
        ref.shock(fleet)
        return fleet.run()

    on, off = run(True), run(None)
    assert off.trace == () and off.metrics is None
    assert on.trace != () and on.metrics is not None
    ref.assert_reports_identical(on, off, ignore=("wall_s", "jobs_per_s",
                                                  "trace", "metrics"))
