"""Event-sourced job tracing on the simulation clock.

A :class:`Span` is one immutable record of a fleet decision or state
transition — ``admit → plan → dispatch → step* → observe → migrate? →
complete`` per job, plus fleet-level spans (``replan``, ``shock``,
``defer``, ``promote``, ``degrade``).  Spans carry *only* deterministic
sim-clock data (no wall time, no PIDs), so traces are replay-consistent:
a checkpoint/restore or crash-kill-resume run regenerates the identical
span suffix, and parallel workers' span batches merge shard-major into a
trace bit-identical to the sequential oracle's.

``seq`` is a per-controller monotone counter breaking same-``t`` ties;
the merged fleet trace orders coordinator spans first, then shard spans
shard-major (the same rule ``FleetReport.merged`` applies to outcomes
and degradations).

Sinks are deliberately dumb consumers behind :class:`TraceSink` —
:class:`JsonlSink` streams to disk, :class:`RingSink` keeps the last N
spans in memory.  The runtime never depends on a sink being attached;
spans accumulate as controller state and ride reports/checkpoints.
"""
from __future__ import annotations

import json
from collections import deque
from typing import (Any, Deque, IO, Iterable, List, NamedTuple, Optional,
                    Tuple, Union)

try:  # py3.8+: typing.Protocol
    from typing import Protocol, runtime_checkable
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore[assignment]

    def runtime_checkable(cls):  # type: ignore[misc]
        return cls

__all__ = ["Span", "TraceSink", "JsonlSink", "RingSink", "emit_all",
           "load_jsonl"]


class Span(NamedTuple):
    """One trace record.  ``attrs`` is a sorted tuple of ``(key, value)``
    pairs — tuples hash/compare/pickle exactly, which is what the
    bit-identity contracts need (a dict would too, but tuples are
    cheaper to build in the event hot path)."""
    t: float          # sim-clock timestamp (monotone event time)
    seq: int          # per-controller monotone tiebreaker
    kind: str         # admit | plan | dispatch | step | observe | ...
    job: str          # job uuid, or "" for fleet-level spans
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key: str, default: Any = None) -> Any:
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        return {"t": self.t, "seq": self.seq, "kind": self.kind,
                "job": self.job, "attrs": dict(self.attrs)}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(float(d["t"]), int(d["seq"]), d["kind"], d["job"],
                   tuple(sorted(d.get("attrs", {}).items())))


@runtime_checkable
class TraceSink(Protocol):
    """Anything that accepts spans: ``emit`` one, ``close`` when done."""

    def emit(self, span: Span) -> None: ...

    def close(self) -> None: ...


class JsonlSink:
    """Append spans to a JSONL file (one ``Span.to_dict`` per line).
    Accepts a path or an open text file; owns (and closes) the handle
    only when given a path."""

    def __init__(self, path_or_file: Union[str, IO[str]]) -> None:
        if isinstance(path_or_file, str):
            self._fh: IO[str] = open(path_or_file, "w", encoding="utf-8")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self.n_emitted = 0

    def emit(self, span: Span) -> None:
        self._fh.write(json.dumps(span.to_dict(), sort_keys=True))
        self._fh.write("\n")
        self.n_emitted += 1

    def close(self) -> None:
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()


class RingSink:
    """Keep the most recent ``capacity`` spans in memory (crash forensics
    without unbounded growth)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._ring: Deque[Span] = deque(maxlen=capacity)
        self.n_emitted = 0

    @property
    def spans(self) -> Tuple[Span, ...]:
        return tuple(self._ring)

    def emit(self, span: Span) -> None:
        self._ring.append(span)
        self.n_emitted += 1

    def close(self) -> None:
        pass


def emit_all(spans: Iterable[Span], *sinks: TraceSink) -> int:
    """Replay a span sequence through one or more sinks; returns the
    number of spans emitted."""
    n = 0
    for span in spans:
        for sink in sinks:
            sink.emit(span)
        n += 1
    return n


def load_jsonl(path: str) -> List[Span]:
    """Read a JSONL trace back into spans (inverse of JsonlSink)."""
    out: List[Span] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(Span.from_dict(json.loads(line)))
    return out
