"""The traced run's instruments: the benchmark's own spans around calls
into the program, ``torch.profiler`` over the window, and the digest of
its trace that the per-layer readers and the breakdown read.

Spans are set only in a traced run (``--trace 1``), by wrapping an
attribute of the program for the window's length and putting it back
after; the program itself is not edited. A per-layer reader
(``metrics/<name>.py``) declares the spans it reads in ``SPANS`` and the
digest's tags in ``TAGS``; the window sets those of the cell's readers.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "cellbench.window"
# gaps between device work shorter than this are launch spacing, not idle
# time the host could be asked about
GAP_US = 50.0


@dataclasses.dataclass(frozen=True)
class Span:
    """A span that a reader declares: the function ``attr`` of the module
    ``owner`` (a dotted name) wrapped as ``name`` for the traced window;
    ``sync`` and ``calls`` as in :meth:`Spans.wrap`."""
    owner: str
    attr: str
    name: str
    sync: bool = False
    calls: bool = False


class Spans:
    """Host-clock spans ``{name: [(start_s, end_s), ...]}``, each also a
    ``record_function`` range in the trace."""

    def __init__(self):
        self.records: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.calls: Dict[str, List[list]] = collections.defaultdict(list)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner: Any, attr: str, name: str, *,
             sync: bool = False, calls: bool = False) -> None:
        """Replace ``owner.attr`` by a wrapper that records span ``name``
        around each call; ``sync`` synchronises the device on both sides,
        so the span holds the call's device time too; ``calls`` keeps each
        call's arguments in ``self.calls[name]``, tensors by their shape."""
        orig = getattr(owner, attr)
        rec = self.records[name]
        args = self.calls[name]
        sync = sync and torch.cuda.is_available()

        def wrapped(*a, **kw):
            if calls:
                args.append([tuple(x.shape) if isinstance(x, torch.Tensor)
                             else x for x in a])
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = orig(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            rec.append((t0, time.perf_counter()))
            return out

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


@contextlib.contextmanager
def profiled(on: bool):
    """``torch.profiler`` over the block when ``on`` (CPU and CUDA
    activity; no input shapes, which would slow every op), with the block
    marked as the window; yields the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def digest(prof, tags: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """What the readers take from a trace (times in seconds):

    * ``window_s``: the marked window's length; ``busy_s``: the union of
      the device's events within it;
    * ``kernel_s``: device seconds by kernel name;
    * ``tagged_s``: for each tag, the device seconds of kernels launched
      from inside a CPU range whose name holds the tag (an autograd node
      such as ``_SSDScanBackward``, or a span);
    * ``breakdown``: the ten device operations that took most time and the
      ten largest idle totals by the innermost host range open in the
      middle of each gap (gaps under 50 us pooled as launch spacing).

    It reads the profiler's raw events (``kineto_results``): a window of
    a serving cell holds millions, too many to build ``prof.events()``
    from within a run's time."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    dev, host = [], []
    w0 = w1 = None
    for e in raw:
        name = e.name()
        t0 = e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            # a record_function range shows on the device's timeline too;
            # it is no device work
            if not e.is_user_annotation():
                dev.append((t0, t1, name, e.linked_correlation_id()))
            continue
        if e.device_type() != cpu:
            continue
        if name == WINDOW:
            w0, w1 = t0, t1
            continue
        host.append((t0, t1, name, e.start_thread_id(), e.correlation_id()))
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    spans = []
    for a, b, name, _ in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernel_s[name] += (b - a) / 1e6
        spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6

    tagged_s = {t: 0.0 for t in tags}
    if tags:
        # a kernel's linked id is the correlation id of the op that
        # launched it; runtime calls (cudaLaunchKernel, ...) number theirs
        # apart, so they are left out of the map
        launched = {c: (th, a) for a, _, name, th, c in host
                    if not name.startswith("cu")}
        for t in tags:
            ranges = collections.defaultdict(list)
            for a, b, name, th, _ in host:
                if t in name:
                    ranges[th].append((a, b))
            inside = {th: _union(r) for th, r in ranges.items()}
            starts = {th: [a for a, _ in r] for th, r in inside.items()}
            for a, b, _, corr in dev:
                th, at = launched.get(corr, (None, 0.0))
                if th not in inside:
                    continue
                i = bisect.bisect_right(starts[th], at) - 1
                if i >= 0 and inside[th][i][1] >= at:
                    tagged_s[t] += (b - a) / 1e6

    gaps: Dict[str, float] = collections.defaultdict(float)
    host.sort()
    hstarts = [h[0] for h in host]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < GAP_US:
            gaps["launch spacing (gaps under 50 us)"] += (b - a) / 1e6
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(hstarts, mid) - 1
        name = "host outside any profiled range"
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += (b - a) / 1e6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "kernel_s": dict(kernel_s),
            "tagged_s": tagged_s,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}


class TraceContext:
    """What a per-layer reader reads: the digest of the traced window, the
    benchmark's spans, the driver's counts and the cell."""

    def __init__(self, cell, model: Dict[str, Any],
                 digest_: Optional[Dict[str, Any]], spans: Spans,
                 counts: Dict[str, float], on_card: bool):
        self.cell = cell
        self.on_card = on_card          # device metrics only from a card
        self.model = model              # the configuration's model sizes
        self.trace = digest_
        self.spans = spans.records
        self.calls = spans.calls
        self.counts = counts            # tokens, steps, energy_j, ...

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        if self.trace is None:
            return 0.0
        return sum(v for k, v in self.trace["kernel_s"].items() if part in k)

    def span_ms(self, name: str) -> Optional[float]:
        """Mean host ms of the benchmark's span ``name``."""
        rec = self.spans.get(name)
        if not rec:
            return None
        return sum(b - a for a, b in rec) / len(rec) * 1e3

    def op_calls(self, name: str) -> List[list]:
        """The arguments of each call of the wrapped function ``name``."""
        return self.calls.get(name, [])
