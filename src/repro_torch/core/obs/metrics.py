"""Dependency-free metrics registry with exact cross-shard merge.

Three instrument kinds — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — live in a :class:`MetricsRegistry` keyed by
``(name, labels)``.  Histograms use *fixed log-spaced bucket bounds*
(:func:`log_bounds`) derived from integer decade exponents, so every
process computes bit-identical bound tuples and merging shard snapshots
is exact elementwise integer addition — the same contract
``FleetReport.merged`` keeps for its counters.

Snapshots (:meth:`MetricsRegistry.snapshot`) are plain JSON-able dicts;
they ride worker pipes and checkpoints as data.  :func:`merged` folds
any number of snapshots exactly; :func:`to_prometheus` / :func:`to_json`
render a snapshot for scraping or archival.

Everything here is pure stdlib — the hot-path cost of an instrument is
one attribute add, which is what lets the ``fleet_obs`` bench keep the
instrumented/uninstrumented ratio under its 5% gate.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "log_bounds", "DEFAULT_BOUNDS", "merged", "to_prometheus", "to_json",
]


def log_bounds(lo: float = 1e-6, hi: float = 1e6,
               per_decade: int = 2) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds.

    Bounds are ``10 ** (k / per_decade)`` for integer ``k`` spanning
    ``[lo, hi]`` — computed from integers so every shard/process derives
    the identical float tuple and merges never see mismatched bounds.
    """
    k_lo = round(math.log10(lo) * per_decade)
    k_hi = round(math.log10(hi) * per_decade)
    if k_hi < k_lo:
        raise ValueError(f"empty bounds range ({lo}, {hi})")
    return tuple(10.0 ** (k / per_decade) for k in range(k_lo, k_hi + 1))


#: default bounds: 1 µ-unit .. 1 M-unit, 2 buckets per decade (25 bounds)
DEFAULT_BOUNDS = log_bounds()

_LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotone sum; merge = addition."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-set value; merged snapshots *sum* gauges (per-shard queue
    depths and inflight counts add up to the fleet-wide figure)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Fixed-bound histogram: ``len(bounds) + 1`` integer buckets (the
    last is +Inf), an observation count and a running sum."""
    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.n += 1

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation
        (conservative; +Inf bucket reports the last finite bound)."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]


class _NullInstrument:
    """No-op stand-in handed out when metrics are disabled — call sites
    keep one unconditional ``inc``/``observe`` instead of a branch."""
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


def _label_key(labels: Mapping[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store.  Plain picklable data: a registry
    inside a controller rides checkpoints and the worker pipe protocol
    unchanged, and ``snapshot()`` emits the JSON-able merge currency."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}

    def counter(self, name: str, **labels: object) -> Counter:
        return self._get("counter", name, _label_key(labels), Counter)

    def gauge(self, name: str, **labels: object) -> Gauge:
        return self._get("gauge", name, _label_key(labels), Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Tuple[float, ...]] = None,
                  **labels: object) -> Histogram:
        key = ("histogram", name, _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = Histogram(bounds if bounds is not None else DEFAULT_BOUNDS)
            self._metrics[key] = inst
        return inst  # type: ignore[return-value]

    def _get(self, kind: str, name: str, labels: _LabelKey, cls):
        key = (kind, name, labels)
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls()
            self._metrics[key] = inst
        return inst

    def absorb(self, other: "MetricsRegistry") -> None:
        """Exact in-place fold of another registry — the live-object
        counterpart of :func:`merged`: counters and gauges add, histogram
        buckets add elementwise (bounds must match, as they always do for
        :func:`log_bounds` products). ``other`` is left unmodified. This
        is how a single-writer side registry (e.g. the streaming
        gateway's batch-planner thread) folds back into the shared one at
        a quiescent point instead of sharing instruments across threads.
        """
        for key, inst in other._metrics.items():
            kind, name, labels = key
            if kind == "histogram":
                mine = self._metrics.get(key)
                if mine is None:
                    mine = Histogram(inst.bounds)
                    self._metrics[key] = mine
                if mine.bounds != inst.bounds:
                    raise ValueError(
                        f"histogram {name!r}: mismatched bounds")
                mine.counts = [a + b for a, b in
                               zip(mine.counts, inst.counts)]
                mine.sum += inst.sum
                mine.n += inst.n
            else:
                cls = Counter if kind == "counter" else Gauge
                self._get(kind, name, labels, cls).value += inst.value

    def snapshot(self) -> Dict[str, List[dict]]:
        """Deterministic JSON-able snapshot, entries sorted by
        (name, labels) within each kind."""
        out: Dict[str, List[dict]] = {
            "counters": [], "gauges": [], "histograms": []}
        for (kind, name, labels) in sorted(self._metrics):
            inst = self._metrics[(kind, name, labels)]
            entry = {"name": name, "labels": dict(labels)}
            if kind == "histogram":
                entry.update(bounds=list(inst.bounds),
                             counts=list(inst.counts),
                             sum=inst.sum, n=inst.n)
                out["histograms"].append(entry)
            elif kind == "counter":
                entry["value"] = inst.value
                out["counters"].append(entry)
            else:
                entry["value"] = inst.value
                out["gauges"].append(entry)
        return out


def _entry_key(entry: Mapping) -> Tuple[str, _LabelKey]:
    return (entry["name"], tuple(sorted(entry["labels"].items())))


def merged(snapshots: Iterable[Mapping]) -> Dict[str, List[dict]]:
    """Exact fold of registry snapshots, mirroring ``FleetReport.merged``:
    counters and gauges add; histogram buckets add elementwise (bounds
    must match exactly — they always do, being :func:`log_bounds`
    products of integers)."""
    out: Dict[str, Dict[Tuple[str, _LabelKey], dict]] = {
        "counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not snap:
            continue
        for kind in ("counters", "gauges"):
            for entry in snap.get(kind, ()):
                key = _entry_key(entry)
                acc = out[kind].get(key)
                if acc is None:
                    out[kind][key] = dict(entry)
                else:
                    acc["value"] += entry["value"]
        for entry in snap.get("histograms", ()):
            key = _entry_key(entry)
            acc = out["histograms"].get(key)
            if acc is None:
                out["histograms"][key] = {
                    "name": entry["name"], "labels": dict(entry["labels"]),
                    "bounds": list(entry["bounds"]),
                    "counts": list(entry["counts"]),
                    "sum": entry["sum"], "n": entry["n"]}
            else:
                if acc["bounds"] != list(entry["bounds"]):
                    raise ValueError(
                        f"histogram {entry['name']!r}: mismatched bounds")
                acc["counts"] = [a + b for a, b in
                                 zip(acc["counts"], entry["counts"])]
                acc["sum"] += entry["sum"]
                acc["n"] += entry["n"]
    return {kind: [out[kind][k] for k in sorted(out[kind])]
            for kind in ("counters", "gauges", "histograms")}


def _fmt_labels(labels: Mapping[str, str],
                extra: Optional[Tuple[str, str]] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def to_prometheus(snapshot: Mapping) -> str:
    """Prometheus text exposition of a snapshot (or merged snapshot)."""
    lines: List[str] = []
    typed: set = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for entry in snapshot.get("counters", ()):
        _type(entry["name"], "counter")
        lines.append(f"{entry['name']}{_fmt_labels(entry['labels'])} "
                     f"{entry['value']:g}")
    for entry in snapshot.get("gauges", ()):
        _type(entry["name"], "gauge")
        lines.append(f"{entry['name']}{_fmt_labels(entry['labels'])} "
                     f"{entry['value']:g}")
    for entry in snapshot.get("histograms", ()):
        name = entry["name"]
        _type(name, "histogram")
        acc = 0
        for bound, count in zip(entry["bounds"], entry["counts"]):
            acc += count
            le = _fmt_labels(entry["labels"], ("le", f"{bound:g}"))
            lines.append(f"{name}_bucket{le} {acc}")
        le = _fmt_labels(entry["labels"], ("le", "+Inf"))
        lines.append(f"{name}_bucket{le} {entry['n']}")
        lab = _fmt_labels(entry["labels"])
        lines.append(f"{name}_sum{lab} {entry['sum']:g}")
        lines.append(f"{name}_count{lab} {entry['n']}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(snapshot: Mapping, indent: Optional[int] = None) -> str:
    return json.dumps(snapshot, sort_keys=True, indent=indent)
