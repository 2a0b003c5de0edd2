#!/usr/bin/env python3
"""The port's per-device cost of the reduced dry-run cells beside the
reference's compiled counts, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/cost_vs_reference.py

Runs the reference's ``lower_cell`` + ``analyze_lowered`` in the child
process of ``tests/_torch_ref.py`` (``cost``: 8 forced host devices,
``jax.sharding.Mesh``) and the port's ``lower_cell`` + ``analyze_cell``
on the same cells (``tests/test_torch_cost.py``: layers 2, d_model 64,
vocab 256, seq 64 x batch 8), and prints one line a cell: dot FLOPs per
chip of both and their ratio, and the ratios of the collective and HBM
byte counts, which the tests do not gate.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))


def main() -> int:
    import _torch_ref as ref
    from test_torch_cost import port_cost
    with tempfile.TemporaryDirectory() as d:
        want = json.loads(str(ref.run_reference(
            "cost", Path(d) / "cost.npz", timeout=600,
            host_devices=ref.COST_DEVICES)["cost"]))
    print(f"{'cell':36s} {'port FLOPs':>16s} {'reference':>16s} "
          f"{'ratio':>10s} {'coll':>7s} {'HBM':>7s}")
    for arch in ref.COST_ARCHS:
        for kind, mesh in ref.COST_CASES:
            key = ref.cost_key(arch, kind, mesh)
            got, w = port_cost(arch, kind, mesh), want[key]

            def ratio(k):
                return got[k] / w[k] if w[k] else float("nan")

            print(f"{key:36s} {got['dot_flops_per_chip']:16.0f} "
                  f"{w['dot_flops_per_chip']:16.0f} "
                  f"{ratio('dot_flops_per_chip'):10.6f} "
                  f"{ratio('collective_total_per_chip'):7.3f} "
                  f"{ratio('mem_bytes_per_chip'):7.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
