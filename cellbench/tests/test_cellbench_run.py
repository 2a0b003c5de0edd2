"""The cell command end to end at CPU-test size (``--device cpu``, the
kernels' plain versions): the result line's keys, what the measured
process loads, a mix found from files alone, the refusals, and that the
control and each fault a cell can have come out not correct."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cellbench import judge, testing
from cellbench.bench import Bench, ROOT
from cellbench.reference import decoder as R
from cellbench.run import forbidden_modules, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
# runs the command as ``python -m cellbench.run`` would and prints, after
# it, the top-level names of every module the process loaded
WRAP = ("import json, runpy, sys\n"
        "sys.argv = ['cellbench.run'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('cellbench.run', run_name='__main__')\n"
        "finally:\n"
        "    print('MODULES ' + json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})), file=sys.stderr)\n")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("tiny"))


def command(root, workload, trace=0, seed=2**31 + 11, cwd=ROOT,
            device="cpu"):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-c", WRAP, "--workload", workload, "--seed",
         str(seed), "--seconds", "0.5", "--trace", str(trace), "--device",
         device, "--root", str(root)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("workload,trace", [(testing.TRAIN, 0),
                                            (testing.SERVE, 1)])
def test_command_prints_the_contract_keys_and_loads_no_jax(tiny, workload,
                                                           trace):
    out = command(tiny, workload, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    if not trace:
        assert set(res["metrics"]) >= {"setup_s"}
    loaded = json.loads(out.stderr.split("MODULES ")[-1])
    assert not set(loaded) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in loaded
    lines = [x for x in out.stderr.splitlines() if x.startswith("check ")]
    assert len(lines) == len(res["checks"])


def test_a_mix_is_found_from_files_alone(tiny, tmp_path):
    """A new traffic file, a workload entry and its limits: no code."""
    root = tmp_path / "root"
    shutil.copytree(tiny, root)
    mix = dict(testing.TRAFFIC["tiny-serve"], clients=2,
               output_tokens={"dist": "uniform", "lo": 1, "hi": 3})
    testing.write(root / "cellbench" / "traffic" / "tiny-burst.json", mix)
    name = "tiny-hybrid.tiny-burst"
    testing.write(root / "cellbench" / "limits" / f"{name}.json",
                  testing.LIMITS[testing.SERVE])
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": "tiny-hybrid",
                              "traffic": "tiny-burst", "chips": 1,
                              "why": "a throwaway mix"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if testing.SERVE in m.get("workloads", []):
            m["workloads"].append(name)
    testing.write(root / "BENCHMARK.json", spec)
    cell = Bench(root).cell(name)
    assert cell.traffic["clients"] == 2
    res = run_cell(name, 3, 0.3, False, "cpu", root)
    assert res["correct"] and res["attempted"] > 0
    assert {"serve_tokens_per_s", "request_latency_p95_s",
            "setup_s"} <= set(res["metrics"])


THROWAWAY_READER = '''"""prefill_calls.serve: a throwaway metric, the prefills of the window,
read from a span and a tag that it declares itself."""
from cellbench.trace import Span

SPANS = (Span("repro_torch.runtime.serve_loop", "prefill", "test.prefill"),)
TAGS = ("test.prefill",)


def read(tc):
    if "test.prefill" not in tc.trace["tagged_s"]:
        return None
    return float(len(tc.spans.get("test.prefill", ())))
'''


def test_a_metric_is_found_from_files_alone(tiny, tmp_path):
    """A reader file that declares its own span and tag, and a per_layer
    entry: no code of the harness changes, and the program's function is
    put back after the window."""
    import repro_torch.runtime.serve_loop as SL
    root = tmp_path / "root"
    shutil.copytree(tiny, root)
    (root / "cellbench" / "metrics").mkdir()
    (root / "cellbench" / "metrics" / "prefill_calls.serve.py").write_text(
        THROWAWAY_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "prefill_calls.serve", "unit": "calls", "better": "lower",
        "source": "program_span", "layer": "model entry",
        "moves": "serve_tokens_per_s", "workloads": [testing.SERVE]})
    testing.write(root / "BENCHMARK.json", spec)
    prefill = SL.prefill
    res = run_cell(testing.SERVE, 3, 0.3, True, "cpu", root)
    assert res["correct"]
    assert res["metrics"]["prefill_calls.serve"]["value"] >= 1
    assert SL.prefill is prefill


def test_readers_declaring_one_span_two_ways_are_refused():
    from types import SimpleNamespace

    from cellbench.drivers import instruments
    from cellbench.trace import Span
    a = SimpleNamespace(SPANS=(Span("m", "f", "s"),), TAGS=("t",))
    b = SimpleNamespace(SPANS=(Span("m", "f", "s"),), TAGS=("t", "u"))
    spans, tags = instruments([a, b])
    assert spans == [Span("m", "f", "s")] and tags == ("t", "u")
    c = SimpleNamespace(SPANS=(Span("m", "f", "s", sync=True),))
    with pytest.raises(ValueError):
        instruments([a, c])


def test_refuses_without_cuda_and_without_the_program(tmp_path):
    """No card: exit non-zero, no result. A directory holding only
    BENCHMARK.json and the benchmark's files: exit non-zero, no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = command(ROOT, "mamba2-370m.train-8x2048", device="cuda")
    assert out.returncode != 0 and not out.stdout.strip()
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    shutil.copytree(ROOT / "cellbench", bare / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(bare, "mamba2-370m.train-8x2048", cwd=bare)
    assert out.returncode != 0 and not out.stdout.strip()


def test_forbidden_modules_compare_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax._src", "flax",
                              "jaxlib"]) == ["flax", "jax", "jaxlib", "repro"]


# ---------------------------------------------------------------- faults --
def broken_train_step(kind):
    import repro_torch.runtime.train_loop as TL
    orig = TL.make_train_step

    def make(cfg, run):
        step = orig(cfg, run)

        def unchanged(model, opt, batch):
            from repro_torch.models.model import loss_fn
            loss, m = loss_fn(model, run, batch)
            opt.step += 1
            return {"loss": loss.detach(), **m}

        def half(model, opt, batch):
            return step(model, opt, {k: v[: v.shape[0] // 2]
                                     for k, v in batch.items()})
        return {"unchanged": unchanged, "half": half}[kind]
    return TL, make


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_training_faults_are_not_correct(tiny, monkeypatch, fault):
    """A step that returns its state unchanged; half of each batch left
    out, the mean taken over the rest."""
    TL, make = broken_train_step(fault)
    monkeypatch.setattr(TL, "make_train_step", make)
    res = run_cell(testing.TRAIN, 4, 0.3, False, "cpu", tiny)
    assert res["correct"] is False


def test_serving_fault_is_not_correct(tiny, monkeypatch):
    """A token altered where it is produced: decode's logits put another
    token first."""
    import repro_torch.runtime.serve_loop as SL
    orig = SL.decode_step

    def altered(model, run, token, cache, cur):
        lg, cache = orig(model, run, token, cache, cur)
        return lg.roll(1, dims=-1), cache
    monkeypatch.setattr(SL, "decode_step", altered)
    res = run_cell(testing.SERVE, 5, 0.3, False, "cpu", tiny)
    assert res["correct"] is False


def test_the_controls_are_not_correct(tiny):
    """The reference in fp8 put in the program's place fails the limits,
    at CPU-test size, in both kinds of cell."""
    cell = Bench(tiny).cell(testing.TRAIN)
    from cellbench.generate import pipeline_tokens
    from cellbench.reference import family
    from cellbench.run import model_config
    from cellbench.weights import make_weights
    m = cell.model_fields()
    kinds = family(m["family"]).kinds(m)
    w = make_weights(model_config(cell), 9, torch.device("cpu"))
    batches = [tuple(torch.from_numpy(a) for a in pipeline_tokens(
        9, 2, 64, m["vocab_size"], 0, i)) for i in range(3)]
    ref = R.train_follow(w, m, kinds, cell.run_fields(), batches)
    ctl = R.train_follow(w, m, kinds, cell.run_fields(), batches, "fp8")
    assert judge.verdict(judge.train_numbers(ctl, ref), cell.limits)[0] \
        is False
    cell = Bench(tiny).cell(testing.SERVE)
    m = cell.model_fields()
    kinds = family(m["family"]).kinds(m)
    w = make_weights(model_config(cell), 9, torch.device("cpu"))
    prompts = torch.randint(0, 256, (3, 64),
                            generator=torch.Generator().manual_seed(9))
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    cfg = model_config(cell)
    model, run = M.Transformer(cfg, w), RunConfig(arch=cfg.name,
                                                  attn_impl="flash")
    lg, cache = M.prefill(model, run, prompts, 72)
    fed = [lg.argmax(-1)]
    for i in range(5):
        lg, cache = M.decode_step(model, run, fed[-1][:, None], cache, 64 + i)
        fed.append(lg.argmax(-1))
    best = [[int(t[j]) for t in fed] for j in range(3)]
    ref = R.serve_follow(w, m, kinds, prompts, best)
    ctl = R.serve_follow(w, m, kinds, prompts, best, "fp8", judge=ref)
    assert judge.verdict(judge.serve_numbers(ref["gaps"]),
                         cell.limits)[0] is True
    assert judge.verdict(judge.serve_numbers(ctl["gaps"]),
                         cell.limits)[0] is False
