"""The port stands alone: it loads no jax and nothing of the reference
package, and it never carries on quietly on the CPU."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core.scheduler import grid_cuda, overlay
from repro_torch.core.scheduler.planner import TorchCarbonPlanner

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
FTNS = [overlay.FTN("uc", "skylake", 10.0),
        overlay.FTN("tacc", "cascade_lake", 10.0)]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)


def _module_name(path: Path) -> str:
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    names = [_module_name(p) for p in PORT_FILES]
    script = (f"import importlib, json, sys\n"
              f"for n in {names!r}:\n"
              f"    importlib.import_module(n)\n"
              f"print(json.dumps(sorted(m for m in sys.modules\n"
              f"    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    proc = subprocess.run([sys.executable, "-c", script],
                          env=dict(os.environ,
                                   PYTHONPATH=str(REPO / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(names) >= 15


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax_or_the_reference(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_without_cuda_the_planner_raises_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCarbonPlanner(FTNS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCarbonPlanner(FTNS, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert TorchCarbonPlanner(FTNS, device="cpu").device.type == "cpu"


def test_planner_rejects_unknown_backends():
    with pytest.raises(ValueError, match="batch_backend"):
        TorchCarbonPlanner(FTNS, device="cpu", batch_backend="pallas")
    with pytest.raises(ValueError, match="device"):
        resolve_device("meta")


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; on any other non-CUDA device they refuse."""
    a, h, w, t, c, s = 2, 3, 4, 512, 5, 16
    gen = np.random.default_rng(0)
    f32 = lambda *sh: torch.tensor(gen.random(sh), dtype=torch.float32)
    pp, zn, hn = f32(a, h, 6), f32(a, h, w), f32(a, h, w)
    rel0 = torch.zeros(a, dtype=torch.float64)
    tc = torch.tensor([3.0, 0.0, 2.0, 1.0, 0.0], dtype=torch.float64)
    before = (grid_cuda.rate_prefix.launches, grid_cuda.sweep.launches)
    r, e = grid_cuda.rate_prefix(pp, zn, hn, rel0, tc, dt_s=60.0, t_pad=t)
    sla = torch.zeros(c, 8, dtype=torch.float64)
    sla[:, 0], sla[:, 2], sla[:, 6] = 3.0, 2.0, float("inf")
    best = grid_cuda.sweep(e, r, torch.ones(a, s, dtype=torch.float64),
                           torch.zeros(c, 2, dtype=torch.int32),
                           torch.ones(c, 2, h, dtype=torch.float64), sla,
                           stride=10, dt_s=60.0, slot_s=600.0)
    assert (grid_cuda.rate_prefix.launches,
            grid_cuda.sweep.launches) == before
    assert r.shape == (a, h, t) and e.dtype == torch.float64
    assert best.shape == (c, 3) and torch.isfinite(best).all()
    with pytest.raises(ValueError, match="cuda or cpu"):
        grid_cuda.rate_prefix(pp.to("meta"), zn.to("meta"), hn.to("meta"),
                              rel0.to("meta"), tc.to("meta"), dt_s=60.0,
                              t_pad=t)
