"""The readers of the program's own spans and counters at CPU-test size: a
traced run of the tiny serve and train cells prints those read from the
program's store; those read from device time are left out off the card;
and every one of them reads None from a program that has no such store."""
import sys

import pytest

from cellbench import testing
from cellbench.bench import Bench
from cellbench.run import run_cell
from cellbench.trace import Spans, TraceContext

SPAN_READ = {testing.SERVE: {"serve_host_ms.serve", "moe_slot_use.serve"},
             testing.TRAIN: {"train_host_ms.train"}}
DEVICE_READ = {testing.SERVE: {"decode_device_ms.serve",
                               "moe_experts_ms.serve"},
               testing.TRAIN: {"adamw_ms.train", "ssm_f32_ms.train"}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", [testing.SERVE, testing.TRAIN])
def test_a_traced_run_prints_what_the_program_kept(tiny, workload):
    from repro_torch.core.obs import runtime
    runtime.reset()
    res = run_cell(workload, 2**31 + 5, 0.3, True, "cpu", tiny)
    assert res["correct"]
    got = res["metrics"]
    assert SPAN_READ[workload] <= set(got)
    assert not DEVICE_READ[workload] & set(got)
    for name in SPAN_READ[workload]:
        assert got[name]["value"] > 0
    if workload == testing.SERVE:
        # 3 rows a decode step, top-2 of 4 experts at capacity(3) = 8
        assert got["moe_slot_use.serve"]["value"] <= 100 * 3 * 2 / (4 * 8)
        assert got["moe_slot_use.serve"]["unit"] == "%"


def test_readers_read_nothing_from_a_program_without_the_store(
        tiny, monkeypatch):
    """As over an older program: the module is missing, the trace holds
    none of its ranges; every new reader gives None and raises nothing."""
    import repro_torch.core.obs as core_obs
    monkeypatch.delattr(core_obs, "runtime", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.obs.runtime", None)
    for workload in (testing.SERVE, testing.TRAIN):
        cell = Bench(tiny).cell(workload)
        readers = cell.readers()
        digest = {"window_s": 1.0, "busy_s": 0.5, "kernel_s": {},
                  "tagged_s": {t: 0.0 for name in DEVICE_READ[workload]
                               for t in readers[name].TAGS},
                  "breakdown": {}}
        tc = TraceContext(cell, cell.model_fields(), digest, Spans(),
                          {"steps": 3, "window_s": 1.0}, on_card=True)
        for name in SPAN_READ[workload] | DEVICE_READ[workload]:
            assert readers[name].read(tc) is None, name
