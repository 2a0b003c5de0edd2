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
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.core.controlplane import FleetController, ShardedFleet
from repro_torch.core.scheduler import grid_cuda, overlay
from repro_torch.core.scheduler.planner import TorchCarbonPlanner
from repro_torch.launch import serve as serve_launch
from repro_torch.models import layers
from repro_torch.runtime.serve_loop import Server

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
FTNS = [overlay.FTN("uc", "skylake", 10.0),
        overlay.FTN("tacc", "cascade_lake", 10.0)]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                        re.MULTILINE)
# library attention and compilers stand in for no kernel of the port
_NOT_A_KERNEL = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                           r"cudnn|flash_attn|xformers")
SMALL = get_reduced("gemma3-12b", layers=2)


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
    assert len(names) >= 30


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


def test_without_cuda_the_control_plane_raises_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetController(FTNS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedFleet(FTNS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedFleet(FTNS, batch_backend="numpy", device="cuda")
    assert FleetController(FTNS, device="cpu").planner.device.type == "cpu"
    fleet = ShardedFleet(FTNS, device="cpu")
    assert {c.planner.device.type for c in fleet.controllers} \
        | {fleet.planner.device.type} == {"cpu"}


def test_without_cuda_workers_gateway_and_restore_raise_unless_told_cpu(
        monkeypatch):
    from repro_torch.core.controlplane import StreamingGateway, persistence
    cpu_fleet = ShardedFleet(FTNS, device="cpu")
    ckpt = persistence.capture(cpu_fleet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedFleet(FTNS, parallel="spawn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingGateway(cpu_fleet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        persistence.restore(ckpt)
    with ShardedFleet(FTNS, parallel="spawn", device="cpu") as spawn:
        assert spawn._shard_specs()[0].device == "cpu"
    gw = StreamingGateway(cpu_fleet, device="cpu")
    assert gw._batch_planner.device.type == "cpu"
    restored = persistence.restore(ckpt, device="cpu")
    assert {c.planner.device.type for c in restored.controllers} \
        | {restored.planner.device.type} == {"cpu"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_calls_library_attention_or_a_compiler(path):
    assert not _NOT_A_KERNEL.findall(path.read_text()), path


def test_without_cuda_serving_raises_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(SMALL, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launch.main(["--requests", "1", "--prompt-len", "4",
                           "--max-new", "2"])
    srv = Server(SMALL, device="cpu")
    assert srv.device.type == "cpu" and srv.run.attn_impl == "flash"
    assert serve_launch.main(["--requests", "1", "--prompt-len", "4",
                              "--max-new", "2", "--device", "cpu"]) == 0


def test_serving_refuses_the_pallas_attention_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        Server(SMALL, RunConfig(arch="gemma3-12b", attn_impl="pallas"),
               device="cpu")
    q = torch.zeros(1, 4, 2, 16)
    pos = torch.arange(4)
    with pytest.raises(ValueError, match="attn_impl"):
        layers.attention(q, q, q, q_pos=pos, kv_pos=pos, impl="pallas")


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
