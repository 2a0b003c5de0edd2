"""The streaming gateway: the port's ``StreamingGateway`` against the
reference's, and the pipelined planner thread on the port's kernels.

With numpy backends the port's gateway admits a seeded arrival stream
exactly as the reference's does (``window_s`` 0, 600 and 3600 s, a
capacity gate with backfill on, a pre-announced shock): the merged
reports are bit-identical and so are the gateway stats. On ``fused``
(the kernels' plain versions on the CPU) ``pipeline="on"`` plans every
micro-batch on the planner thread and merges bit-identically to
``pipeline="off"``. The batch planner is a private ``TorchCarbonPlanner``
clone on the gateway's device. Also: the kernel library loads once from
two threads, and the wrappers' launch counters lose no update.
"""
import ctypes.util
import sys
import threading

import pytest

import _torch_ref as ref
from repro.core.controlplane import sharded as r_sharded
from repro.core.controlplane import streaming as r_streaming
from repro.core.scheduler import overlay as r_overlay
from repro.core.workloads import generators as r_gen
from repro_torch import _build
from repro_torch.core.controlplane import sharded, streaming
from repro_torch.core.scheduler import grid_cuda, overlay, planner
from repro_torch.core.workloads import generators as gen

END = ref.T0 + 24 * 3600.0
WORKER_TIMEOUT_S = 180
# the gateway stats that are not wall clock
STATS = ("n_jobs", "n_batches", "max_batch", "mean_batch", "admission_p50_s",
         "admission_p95_s", "admission_max_s", "n_deferred", "n_promotions",
         "n_backfill_promotions", "n_urgent_promotions", "pipeline",
         "n_pipelined_batches")


@pytest.fixture(scope="module", autouse=True)
def _warm():
    ref.warm_up_torch()


@pytest.fixture(autouse=True)
def _cold_fields():
    ref.fresh_default_fields()


def _jobs(mod, n=36, rate_per_h=6.0, seed=5):
    """tests/test_pipeline.py's stream: Poisson arrivals over 8 h."""
    w = mod.Workload("eq", mod.PoissonArrivals(rate_per_h=rate_per_h),
                     mod.UniformSizes(lo_gb=80.0, hi_gb=600.0),
                     replica_sets=(("uc",), ("uc", "site_qc")),
                     deadline_h=(6.0, 14.0))
    return list(w.jobs(seed, ref.T0, 8 * 3600.0))[:n]


def _run(sharded_mod, streaming_mod, overlay_mod, jobs, *, fleet_kw=(),
         **gw_kw):
    fleet = sharded_mod.ShardedFleet(
        ref.make_ftns(overlay_mod, ref.FLEET_FTNS), n_shards=3,
        migration_threshold=250.0, **dict(fleet_kw))
    ref.shock(fleet)
    gw = streaming_mod.StreamingGateway(fleet, **gw_kw)
    with fleet:
        rep = gw.run(jobs, until=END)
    return rep, gw


def _stats(gw):
    st = gw.stats()
    return tuple(getattr(st, k) for k in STATS)


@pytest.mark.parametrize("window_s", [0.0, 600.0, 3600.0])
def test_gateway_matches_the_reference(window_s):
    kw = dict(window_s=window_s, max_batch=16, max_inflight=6, backfill=True)
    want, rgw = _run(r_sharded, r_streaming, r_overlay, _jobs(r_gen),
                     fleet_kw=dict(batch_backend="numpy", obs=True), **kw)
    got, gw = _run(sharded, streaming, overlay, _jobs(gen),
                   fleet_kw=dict(batch_backend="numpy", obs=True,
                                 device="cpu"), device="cpu", **kw)
    ref.assert_reports_identical(got, want)
    assert _stats(gw) == _stats(rgw)
    assert gw.stats().n_deferred > 0 and got.n_completed == 36


def test_pipelined_gateway_over_fork_workers_matches_the_reference():
    kw = dict(window_s=900.0, max_batch=16, max_inflight=6, backfill=True,
              pipeline="on")
    fleet_kw = dict(batch_backend="numpy", shard_backend="numpy",
                    parallel="fork", obs=True)
    with ref.deadline(WORKER_TIMEOUT_S):
        want, rgw = _run(r_sharded, r_streaming, r_overlay, _jobs(r_gen),
                         fleet_kw=fleet_kw, **kw)
        got, gw = _run(sharded, streaming, overlay, _jobs(gen),
                       fleet_kw=dict(fleet_kw, device="cpu"), device="cpu",
                       **kw)
    ref.assert_reports_identical(got, want)
    assert _stats(gw) == _stats(rgw)
    assert gw.stats().n_pipelined_batches > 0


def test_pipeline_on_and_off_are_bit_identical_on_fused(monkeypatch):
    """Micro-batches of 16 and more jobs reach the batch path, so the
    planner thread runs the kernels' plain versions; the merge does not
    depend on which thread planned."""
    calls = []
    batch = grid_cuda.batch_cell_best

    def counted(*a, **k):
        calls.append(threading.current_thread().name)
        return batch(*a, **k)

    monkeypatch.setattr(grid_cuda, "batch_cell_best", counted)
    runs, gws, threads = {}, {}, {}
    for mode in ("off", "on"):
        del calls[:]
        runs[mode], gws[mode] = _run(
            sharded, streaming, overlay, _jobs(gen, n=160, rate_per_h=48.0),
            fleet_kw=dict(batch_backend="fused", obs=True, device="cpu"),
            device="cpu", window_s=1800.0, max_batch=32, pipeline=mode)
        threads[mode] = list(calls)
    ref.assert_reports_identical(runs["on"], runs["off"])
    assert gws["on"].stats().n_pipelined_batches > 0
    assert gws["off"].stats().n_pipelined_batches == 0
    assert any(t.startswith("gw-plan") for t in threads["on"])
    assert not any(t.startswith("gw-plan") for t in threads["off"])
    fused = [c for c in runs["on"].metrics["counters"]
             if c["name"] == "planner_plan_batches_total"
             and c["labels"].get("backend") == "fused"]
    assert fused and fused[0]["value"] > 0


def _fleet(**kw):
    return sharded.ShardedFleet(ref.make_ftns(overlay, ref.FLEET_FTNS),
                                n_shards=3, device="cpu", obs=True, **kw)


def test_clone_planner_is_a_private_torch_planner_on_the_source_device():
    fleet = _fleet()
    src = fleet.planner
    clone = streaming.StreamingGateway._clone_planner(src)
    assert type(clone) is planner.TorchCarbonPlanner
    assert clone.device == src.device
    assert clone.batch_backend == src.batch_backend == "fused"
    assert clone.field is not src.field
    assert clone.throughput is src.throughput
    assert clone.emission_scale_fn == src.emission_scale_fn
    assert clone._metrics is not None and clone._metrics is not src._metrics
    gw = streaming.StreamingGateway(fleet, pipeline="on", device="cpu")
    assert gw._batch_planner is not gw.planner and gw._overlap_safe
    assert gw._batch_planner.device.type == "cpu"


def test_a_planner_subclass_is_not_cloned_and_plans_inline():
    class TaggedPlanner(planner.TorchCarbonPlanner):
        pass

    ftns = ref.make_ftns(overlay, ref.FLEET_FTNS)
    jobs = _jobs(gen, n=18)

    def run(pipeline):
        fleet = _fleet(batch_backend="numpy")
        gw = streaming.StreamingGateway(
            fleet, window_s=900.0, max_batch=16, pipeline=pipeline,
            planner=TaggedPlanner(ftns, batch_backend="numpy", device="cpu"),
            device="cpu")
        return gw.run(jobs, until=END), gw

    r_off, _ = run("off")
    r_on, gw = run("on")
    assert gw._batch_planner is gw.planner and not gw._overlap_safe
    assert gw.stats().n_pipelined_batches == 0
    ref.assert_reports_identical(r_on, r_off)


def test_gateway_refuses_bad_arguments_like_the_reference():
    fleet = _fleet()
    for kw, match in ((dict(window_s=-1.0), "window_s"),
                      (dict(max_batch=0), "max_batch"),
                      (dict(max_inflight=0), "max_inflight"),
                      (dict(pipeline="maybe"), "pipeline"),
                      (dict(frontends="zone"), "frontends")):
        with pytest.raises(ValueError, match=match):
            streaming.StreamingGateway(fleet, device="cpu", **kw)
    gw = streaming.StreamingGateway(fleet, device="cpu")
    with pytest.raises(ValueError, match="not time-ordered"):
        gw.run(list(reversed(_jobs(gen, n=4))))


# --- two threads, one card ---------------------------------------------------
def test_a_library_is_built_and_declared_once_from_many_threads(monkeypatch):
    """Threads that first ask for a kernel library at the same time start
    one build and all get the one declared library."""
    libc = ctypes.util.find_library("c")
    builds, declares = [], []
    gate = threading.Barrier(8)

    def slow_build(src):
        builds.append(src.name)
        threading.Event().wait(0.2)        # a build takes a while
        return {src.name: (libc, "")}

    monkeypatch.setattr(_build, "build", slow_build)
    src = _build.KernelSource("thread_probe", ("-DPROBE",))
    got = []

    def first_use():
        gate.wait()
        got.append(_build.load(src, declares.append))

    workers = [threading.Thread(target=first_use) for _ in range(8)]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(30)
        assert not any(w.is_alive() for w in workers)
        assert builds == ["thread_probe"] and len(declares) == 1
        assert len(got) == 8 and all(lib is got[0] for lib in got)
    finally:
        _build._LOADED.pop(src, None)


def test_launch_counters_lose_no_update_under_contention():
    class Wrapper:
        launches = 0

    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [grid_cuda._count(Wrapper)
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert Wrapper.launches == n_threads * per_thread
