"""The model runtime's spans and counters (``core/obs/runtime.py``): off
unless a profiler records or ``record()`` is open, and then on the
profiler's clock, in the device trace and in the store alike, with their
parents; the serve loop's, the train loop's, the MoE layer's, the Mamba-2
block's and AdamW's spans; the MoE dispatch's counters against
``dispatch_indices``; no program span name inside a name the benchmark
uses, or the other way round."""
import collections
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_ref
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.core.obs import metrics as obs_metrics
from repro_torch.core.obs import runtime as obs
from repro_torch.models import moe
from repro_torch.runtime import serve_loop as SL
from repro_torch.runtime.train_loop import TrainLoopConfig, Trainer

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SERVE_SPANS = {"serve_loop.epoch", "serve_loop.batch", "serve_loop.prefill",
               "serve_loop.decode", "serve_loop.collect",
               "serve_loop.account"}
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
TRAIN_SPANS = {"train_loop.data", "train_loop.step_fn",
               "train_loop.account", "adamw.update"}
# the names the benchmark gives its own ranges, and the autograd node it
# tags (the benchmark's trace module, its cell runners and its readers)
BENCHMARK_NAMES = ("cellbench.window", "serve.decode_step", "serve.prefill",
                   "kernel.ssd_scan", "kernel.flash_attention",
                   "train.step_fn", "_SSDScanBackward")


@pytest.fixture(autouse=True)
def _clean():
    _torch_ref.warm_up_torch()
    obs.reset()
    yield
    obs.reset()


def hybrid_server(batch=3):
    """A reduced jamba (Mamba-2, attention and MoE layers) serving three
    requests, the longest two scan chunks."""
    cfg = get_reduced("jamba-v0.1-52b", layers=8, d_model=64, vocab=256)
    q = cfg.ssm.chunk_size
    srv = SL.Server(cfg, batch=batch, s_max=2 * q + 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for rid, (n, new) in enumerate([(q, 3), (2 * q, 4), (q, 2)]):
        srv.submit(SL.Request(rid=10 + rid, max_new_tokens=new,
                              prompt=torch.randint(0, 256, (n,),
                                                   generator=g)))
    return srv


def ssm_trainer(tmp_path):
    cfg = get_reduced("mamba2-370m", layers=2, d_model=64, vocab=256)
    run = RunConfig(arch="m", attn_impl="flash", remat="block",
                    total_steps=4, warmup_steps=1)
    return Trainer(cfg, run, TrainLoopConfig(
        total_steps=2, ckpt_every=100, ckpt_dir=str(tmp_path)),
        batch_override=2, seq_override=64, device="cpu")


def traced(fn):
    """``fn()`` under the CPU profiler, its body inside one outer range
    as the benchmark's window is -> the profiler's ranges by name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            fn()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        ranges[e.name()].append(e.start_ns())
    return ranges


def check_against_trace(snap, ranges, names):
    """Every span of ``names`` is a profiler range too, started within
    1 ms of it, and lies inside its parent."""
    by_id = {s["id"]: s for s in snap["spans"]}
    for name in names:
        kept = sorted(s["start_ns"] for s in snap["spans"]
                      if s["name"] == name)
        assert kept, name
        assert len(ranges[name]) == len(kept), name
        for a, b in zip(sorted(ranges[name]), kept):
            assert abs(a - b) < 1_000_000, (name, a, b)
    for s in snap["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (s, p)


def test_recording_reads_the_profilers_flag(monkeypatch):
    """The flag ``recording()`` reads is torch's own; a torch that renames
    it fails here instead of keeping nothing."""
    import torch.autograd.profiler as P
    assert P._is_profiler_enabled is False and not obs.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert P._is_profiler_enabled is True and obs.recording()
    assert not obs.recording()
    monkeypatch.setattr(P, "_is_profiler_enabled", True)
    assert obs.recording()


def test_recording_opens_the_profilers_fast_range(monkeypatch):
    """The range a span opens is torch's own ``_RecordFunctionFast``; a
    torch without it fails here."""
    opened = []
    fast = torch._C._profiler._RecordFunctionFast

    def counted(name):
        opened.append(name)
        return fast(name)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    with obs.record():
        with obs.span("moe.route"):
            pass
    assert opened == ["moe.route"]


def test_off_keeps_nothing_and_opens_no_range(monkeypatch, tmp_path):
    """No profiler, no ``record()``: the instruments, and a served epoch
    and two training steps through them, keep nothing and never open a
    profiler range."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened while off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    with obs.span("serve_loop.epoch", rids=[1]):
        obs.count("moe.slots", 8)
        obs.count_device("moe.kept", torch.tensor(3))
    hybrid_server().step_epoch()
    ssm_trainer(tmp_path).run_steps(2)
    snap = obs.snapshot()
    assert snap["spans"] == []
    assert snap["metrics"] == {"counters": [], "gauges": [],
                               "histograms": []}


def test_record_keeps_spans_and_counts_without_a_profiler():
    with obs.record():
        assert obs.recording()
        with obs.span("serve_loop.epoch", rids=[4, 5]):
            with obs.span("moe.route"):
                obs.count("moe.slots", 8)
                obs.count_device("moe.kept", torch.tensor(3))
                obs.count_device("moe.kept", torch.tensor(2))
        obs.count("moe.slots", 1)
    assert not obs.recording()
    snap = obs.snapshot()
    inner, outer = snap["spans"]
    assert (inner["name"], outer["name"]) == ("moe.route", "serve_loop.epoch")
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["attrs"] == {"rids": [4, 5]}
    got = {(e["name"], e["labels"]["span"]): e["value"]
           for e in snap["metrics"]["counters"]}
    assert got == {("moe.slots", "serve_loop.epoch"): 8,
                   ("moe.slots", ""): 1,
                   ("moe.kept", "serve_loop.epoch"): 5}
    text = obs_metrics.to_prometheus(snap["metrics"])
    assert 'moe.kept{span="serve_loop.epoch"} 5' in text
    assert '"moe.slots"' in obs_metrics.to_json(snap["metrics"])
    obs.reset()
    assert obs.snapshot()["spans"] == []


def test_spans_of_two_threads_keep_their_own_parents():
    import threading
    with obs.record():
        with obs.span("serve_loop.decode"):
            def child():
                with obs.span("ssm.f32"):
                    obs.count("moe.slots", 1)
            t = threading.Thread(target=child)
            t.start()
            t.join()
    snap = obs.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert by["ssm.f32"]["parent"] is None
    assert by["ssm.f32"]["thread"] != by["serve_loop.decode"]["thread"]
    (c,) = snap["metrics"]["counters"]
    assert c["labels"] == {"span": ""}


def test_many_threads_lose_no_span_or_count():
    """More threads than cores, switching often: every span and count
    kept, each span's parent on its own thread."""
    import os
    import sys
    import threading
    n_threads, n = 2 * (os.cpu_count() or 4), 200
    one = torch.tensor(1)

    def work():
        for _ in range(n):
            with obs.span("serve_loop.decode"):
                with obs.span("moe.route"):
                    obs.count("moe.slots", 1)
                    obs.count_device("moe.kept", one)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.record():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = obs.snapshot()
    assert len(snap["spans"]) == 2 * n * n_threads
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        if s["name"] == "moe.route":
            p = by_id[s["parent"]]
            assert p["name"] == "serve_loop.decode"
            assert p["thread"] == s["thread"]
    got = {e["name"]: e["value"] for e in snap["metrics"]["counters"]}
    assert got == {"moe.slots": n * n_threads, "moe.kept": n * n_threads}


def test_served_epoch_under_the_profiler():
    """One epoch of a reduced hybrid MoE: each serve-loop, MoE and
    Mamba-2 span in the trace and the store, on the trace's clock, with
    its parent; the epoch's rids are its batch's; MoE counts apart by
    phase."""
    srv = hybrid_server()
    ranges = traced(srv.step_epoch)
    snap = obs.snapshot()
    names = collections.Counter(s["name"] for s in snap["spans"])
    assert set(names) == SERVE_SPANS | MOE_SPANS | {"ssm.f32"}
    assert names["serve_loop.epoch"] == 1 and names["serve_loop.decode"] == 3
    check_against_trace(snap, ranges, set(names))
    by_id = {s["id"]: s for s in snap["spans"]}
    (epoch,) = [s for s in snap["spans"] if s["name"] == "serve_loop.epoch"]
    assert epoch["attrs"] == {"rids": [10, 11, 12], "padded_len": 64,
                              "rows": 3}
    for s in snap["spans"]:
        parent = by_id.get(s["parent"], {}).get("name")
        if s["name"] in SERVE_SPANS - {"serve_loop.epoch"}:
            assert parent == "serve_loop.epoch"
        elif s["name"] in MOE_SPANS | {"ssm.f32"}:
            assert parent in ("serve_loop.prefill", "serve_loop.decode")
    # a prefill and three decode steps through each MoE layer
    n_moe = names["moe.experts"] // 4
    assert n_moe and all(names[n] == 4 * n_moe for n in MOE_SPANS)
    cfg = srv.cfg

    def c(name, phase):
        return sum(e["value"] for e in snap["metrics"]["counters"]
                   if e["name"] == name and e["labels"]["span"] == phase)
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    assert c("moe.assignments", "serve_loop.prefill") == n_moe * 3 * 64 * k
    assert c("moe.assignments", "serve_loop.decode") == 3 * n_moe * 3 * k
    assert c("moe.slots", "serve_loop.decode") == \
        3 * n_moe * E * moe.capacity(3, cfg.moe)
    for ph in ("serve_loop.prefill", "serve_loop.decode"):
        assert c("moe.kept", ph) + c("moe.dropped", ph) == \
            c("moe.assignments", ph)


def test_train_steps_under_the_profiler(tmp_path):
    """Two steps of a reduced Mamba-2 with block remat: the Trainer's
    phases, AdamW inside the step, the f32 chains in the forward and the
    recompute, each in the trace and the store."""
    tr = ssm_trainer(tmp_path)
    ranges = traced(lambda: tr.run_steps(2))
    snap = obs.snapshot()
    names = collections.Counter(s["name"] for s in snap["spans"])
    assert set(names) == TRAIN_SPANS | {"ssm.f32"}
    assert all(names[n] == 2 for n in TRAIN_SPANS)
    # two ranges a layer a step, in the forward and again in the recompute
    assert names["ssm.f32"] == 2 * 2 * 2 * 2
    check_against_trace(snap, ranges, set(names))
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        parent = by_id.get(s["parent"], {}).get("name")
        if s["name"] == "adamw.update":
            assert parent == "train_loop.step_fn"
        elif s["name"].startswith("train_loop."):
            assert parent is None


def test_moe_counters_on_a_forced_overflow(monkeypatch):
    """Every token routed to experts 0 and 1: the counters equal what
    ``dispatch_indices`` keeps and drops."""
    cfg = get_reduced("jamba-v0.1-52b", layers=8, d_model=64, vocab=256)
    mc, T, d = cfg.moe, 40, 64
    g = torch.Generator().manual_seed(1)
    p = {"router": torch.randn(d, mc.n_experts, generator=g)}
    for n in ("wg", "wu"):
        p[n] = torch.randn(mc.n_experts, d, mc.d_ff_expert, generator=g)
    p["wd"] = torch.randn(mc.n_experts, mc.d_ff_expert, d, generator=g)
    top_i = torch.tensor([[0, 1]] * T)
    top_p = torch.full((T, 2), 0.5)
    monkeypatch.setattr(moe, "route", lambda w, x, c: (
        top_p, top_i, torch.zeros(())))
    x = torch.randn(1, T, d, generator=g)
    with obs.record():
        moe.moe_ffn(p, x, mc)
    cap = moe.capacity(T, mc)
    _, _, keep = moe.dispatch_indices(top_i, mc.n_experts, cap)
    assert int(keep.sum()) == 2 * cap < 2 * T
    got = {e["name"]: e["value"]
           for e in obs.snapshot()["metrics"]["counters"]}
    assert got == {"moe.assignments": 2 * T, "moe.slots": mc.n_experts * cap,
                   "moe.kept": int(keep.sum()),
                   "moe.dropped": 2 * T - int(keep.sum())}


def program_span_names():
    """Every name the program passes to the runtime's ``span``."""
    names = set()
    for f in SRC.rglob("*.py"):
        text = f.read_text()
        if "from repro_torch.core.obs import runtime as obs" in text:
            names |= set(re.findall(r'obs\.span\(\s*"([^"]+)"', text))
    return names


def test_no_program_span_name_and_benchmark_name_hold_one_another():
    """The benchmark's digest matches tags by substring: a program range
    named inside one of its names, or around one, would be counted as
    it."""
    from cellbench.bench import Bench, reader
    from cellbench.trace import WINDOW
    ours = program_span_names()
    assert ours == SERVE_SPANS | MOE_SPANS | TRAIN_SPANS | {"ssm.f32"}
    theirs = {WINDOW}
    for m in Bench().spec["per_layer"]:
        mod = reader(m["name"])
        theirs |= {sp.name for sp in getattr(mod, "SPANS", ())}
        theirs |= set(getattr(mod, "TAGS", ())) - ours
    assert theirs <= set(BENCHMARK_NAMES)
    for a in ours:
        for b in BENCHMARK_NAMES:
            assert a not in b and b not in a, (a, b)
