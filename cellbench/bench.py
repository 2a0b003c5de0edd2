"""``BENCHMARK.json`` and the data files it names, looked up by name.

Data (the configurations, mixes and limits) lives under ``<root>/cellbench``
so that a test can point the harness at another root holding a throwaway
cell. A metric's reader is ``<root>/cellbench/metrics/<name>.py``, else
this package's; the references are this package's.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# Keys of a configuration file that describe it and are not model sizes.
META_KEYS = ("name", "source", "paper", "deployment", "reduced", "published",
             "assumed", "departures", "run")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]           # the configuration file as written
    traffic_name: str
    traffic: Dict[str, Any]          # the mix's parameters
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, Any]           # {"numbers": {name: {"limit": ...}}}
    root: Path = ROOT


    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def model_fields(self) -> Dict[str, Any]:
        """The configuration's model sizes: every key but the meta ones."""
        return {k: v for k, v in self.config.items() if k not in META_KEYS}

    def run_fields(self) -> Dict[str, Any]:
        return dict(self.config.get("run", {}))

    def readers(self) -> Dict[str, ModuleType]:
        """``{metric: its reader module}`` of the cell's per-layer
        metrics."""
        return {m["name"]: reader(m["name"], self.root)
                for m in self.per_layer}


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def data(self, *parts: str) -> Path:
        return self.root.joinpath("cellbench", *parts)

    def cell(self, name: str) -> Cell:
        works = {w["name"]: w for w in self.spec["workloads"]}
        if name not in works:
            raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                           f"{sorted(works)}")
        w = works[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if name in m.get("workloads", [name])
                     and m["moves"] in moved]
        return Cell(
            name=name, chips=int(w["chips"]), config_name=w["config"],
            config=json.loads((self.root / conf["file"]).read_text()),
            traffic_name=w["traffic"],
            traffic=json.loads(self.data("traffic",
                                         f"{w['traffic']}.json").read_text()),
            end_to_end=e2e, per_layer=per_layer,
            limits=json.loads(self.data("limits", f"{name}.json").read_text()),
            root=self.root)


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module ``metrics/<metric>.py``: its ``read`` takes the trace
    context and gives the metric's value, or None where the run gave it
    nothing to read; its ``SPANS`` and ``TAGS``, where it has them, name
    the spans (:class:`cellbench.trace.Span`) and the digest's tags it
    reads."""
    path = Path(root) / "cellbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cellbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
