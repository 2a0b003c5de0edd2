"""Every cell of BENCHMARK.json once on the card, a short window: the run
ends with a result whose ``correct`` is true. Marked ``gpu``; it skips
without a card (decided in the fixture, not at import)."""
import json
import subprocess
import sys

import pytest

from cellbench.bench import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
