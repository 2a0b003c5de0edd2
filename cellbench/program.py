"""What the program's own instruments kept over a traced window: the
spans and counters of ``repro_torch.core.obs.runtime``, which records
while the profiler does, so in the window alone. Read after the window;
a program without that module gives None, and so do the readers.

A run of a cell is one process, so the store holds that window's spans
and counts only; a test that runs several cells in one process clears it
first (``runtime.reset()``)."""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional


def snapshot() -> Optional[Dict[str, Any]]:
    """``runtime.snapshot()``, or None where the program has no such
    module."""
    try:
        from repro_torch.core.obs import runtime
    except ImportError:
        return None
    return runtime.snapshot()


def span_count(snap: Dict[str, Any], name: str) -> int:
    """How many spans ``name`` the program kept."""
    return sum(s["name"] == name for s in snap["spans"])


def span_seconds(snap: Dict[str, Any], names: Iterable[str]) -> float:
    """Host seconds in the spans named ``names``, summed."""
    names = set(names)
    return sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
               if s["name"] in names) / 1e9


def counter(snap: Dict[str, Any], name: str, span: str) -> float:
    """The counter ``name`` counted inside the program's span ``span``."""
    return sum(e["value"] for e in snap["metrics"]["counters"]
               if e["name"] == name and e["labels"].get("span") == span)


def tagged_ms_per(tc, tag: str, n: float) -> Optional[float]:
    """Device ms of the kernels launched under the program's ranges
    ``tag`` over ``n``; None off the card, or where nothing ran under
    such a range."""
    if not tc.on_card or tc.trace is None or not n:
        return None
    s = tc.trace["tagged_s"].get(tag, 0.0)
    return s / n * 1e3 if s > 0 else None
