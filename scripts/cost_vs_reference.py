#!/usr/bin/env python3
"""The port's per-device cost of the reduced dry-run cells beside the
reference's compiled counts, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/cost_vs_reference.py

First ``COST_CASES`` on small meshes: the reference's ``lower_cell`` +
``analyze_lowered`` in the child process of ``tests/_torch_ref.py``
(``cost``: 8 forced host devices, ``jax.sharding.Mesh``) and the port's
``lower_cell`` + ``analyze_cell`` on the same cells
(``tests/test_torch_cost.py``: layers 2, d_model 64, vocab 256, seq 64 x
batch 8). Then the dry-run cells (``tests/_torch_ref.py::dryrun_cells``) on the production meshes: the reference's
own ``launch/dryrun.py`` in the ``dryrun`` child (512 forced devices,
reduced configs, 16 experts for the MoE archs) and the port's
``launch/dryrun.py`` on the same cells. One line a cell: dot FLOPs per
chip of both (equal, or the gap), and the ratios port/reference of the
collective and HBM bytes and, for the dry run, of the output, alias and
temp bytes, which the tests do not gate (argument bytes are gated equal).
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))


def _ratio(got: dict, want: dict, k: str) -> float:
    return got[k] / want[k] if want[k] else float("nan")


def cost_cases(ref, d: Path) -> None:
    from test_torch_cost import port_cost
    want = json.loads(str(ref.run_reference(
        "cost", d / "cost.npz", timeout=600,
        host_devices=ref.COST_DEVICES)["cost"]))
    print(f"{'cell':36s} {'port FLOPs':>16s} {'reference':>16s} "
          f"{'ratio':>10s} {'coll':>7s} {'HBM':>7s}")
    for arch in ref.COST_ARCHS:
        for kind, mesh in ref.COST_CASES:
            key = ref.cost_key(arch, kind, mesh)
            got, w = port_cost(arch, kind, mesh), want[key]
            print(f"{key:36s} {got['dot_flops_per_chip']:16.0f} "
                  f"{w['dot_flops_per_chip']:16.0f} "
                  f"{_ratio(got, w, 'dot_flops_per_chip'):10.6f} "
                  f"{_ratio(got, w, 'collective_total_per_chip'):7.3f} "
                  f"{_ratio(got, w, 'mem_bytes_per_chip'):7.3f}", flush=True)


def dryrun_cells(ref, d: Path) -> None:
    from repro_torch.configs import cells, get_reduced
    from repro_torch.launch import dryrun as D
    want = json.loads(str(ref.run_reference(
        "dryrun", d / "dryrun.npz", timeout=900,
        host_devices=ref.DRYRUN_DEVICES)["dryrun"]))
    D.get_config = lambda arch: ref.dryrun_config(get_reduced, arch)
    print(f"\n{'cell':40s} {'port FLOPs':>16s} {'port - reference':>17s} "
          f"{'coll':>7s} {'HBM':>7s} {'out':>7s} {'alias':>7s} "
          f"{'temp':>7s}")
    for arch, shape, mp in ref.dryrun_cells(cells):
        key = ref.dryrun_key(arch, shape, mp)
        w = want[key]
        if "skipped" in w:
            print(f"{key:40s} {w['skipped']}")
            continue
        g = D.run_cell(arch, shape, multi_pod=mp, verbose=False)
        gap = g["hlo"]["dot_flops_per_chip"] - w["hlo"]["dot_flops_per_chip"]
        mem = [_ratio(g["memory"], w["memory"], k)
               for k in ("output_bytes", "alias_bytes", "temp_bytes")]
        print(f"{key:40s} {g['hlo']['dot_flops_per_chip']:16.0f} "
              f"{'equal' if gap == 0 else f'{gap:+.0f}':>17s} "
              f"{_ratio(g['hlo'], w['hlo'], 'collective_total_per_chip'):7.3f} "
              f"{_ratio(g['hlo'], w['hlo'], 'mem_bytes_per_chip'):7.3f} "
              + " ".join(f"{r:7.3f}" for r in mem), flush=True)


def main() -> int:
    import _torch_ref as ref
    with tempfile.TemporaryDirectory() as d:
        cost_cases(ref, Path(d))
        dryrun_cells(ref, Path(d))
    return 0


if __name__ == "__main__":
    sys.exit(main())
