"""Drivers, one a traffic kind (``traffic/<mix>.json``'s ``kind``):
``train`` and ``serve``. Each builds the program from the cell, warms it
up, runs the measured window, reads the peak memory, frees the program
and then checks what the window produced against the reference."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from cellbench.trace import Span, Spans, digest, profiled


@dataclasses.dataclass
class Ctx:
    cell: Any                   # bench.Cell
    cfg: Any                    # the port's ModelConfig
    run: Any                    # the port's RunConfig
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float              # the process's start on perf_counter's clock
    meter: Any = None           # energy.Meter on the card, None on the CPU
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: float = 0.0
    window_s: float = 0.0
    energy_j: float = float("nan")
    memory_peak: int = 0
    digest: Optional[Dict[str, Any]] = None
    # the ends of set-up's phases on perf_counter's clock, in order
    phases: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def phase(self, name: str) -> None:
        """Mark the end of set-up's phase ``name``."""
        self.phases.append((name, time.perf_counter()))

    def phase_seconds(self) -> List[Tuple[str, float]]:
        """Each phase of set-up with its seconds, from the process's
        start to the window's."""
        out, t = [], self.t_start
        for name, at in self.phases:
            out.append((name, at - t))
            t = at
        return out


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the counts the
    per-layer readers read, the numbers the judge compares, and how many
    units of work were attempted and failed."""
    metrics: Dict[str, float]
    counts: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def driver(kind: str):
    return importlib.import_module(f"cellbench.drivers.{kind}")


def sync(ctx: Ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


class Window:
    """The measured window: energy and, in a traced run, the profiler
    from its start to its end, which waits for the device, with the spans
    and tags that the cell's per-layer readers declare."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.t0 = 0.0
        self.tags: Tuple[str, ...] = ()

    def __enter__(self) -> "Window":
        ctx = self.ctx
        sync(ctx)
        ctx.phase("warm-up")
        if ctx.trace:
            spans, self.tags = instruments(ctx.cell.readers().values())
            for sp in spans:
                ctx.spans.wrap(importlib.import_module(sp.owner), sp.attr,
                               sp.name, sync=sp.sync, calls=sp.calls)
        if ctx.meter is not None:
            ctx.meter.start()
        self._prof = profiled(ctx.trace)
        self.prof = self._prof.__enter__()
        self.t0 = time.perf_counter()
        ctx.phases.append(("window start", self.t0))
        ctx.setup_s = self.t0 - ctx.t_start
        return self

    def __exit__(self, *exc) -> None:
        ctx = self.ctx
        sync(ctx)
        t1 = time.perf_counter()
        if ctx.meter is not None:
            ctx.meter.stop()
            ctx.energy_j = ctx.meter.joules
        self._prof.__exit__(*exc)
        ctx.window_s = t1 - self.t0
        ctx.spans.restore()
        if exc[0] is None and self.prof is not None:
            t2 = time.perf_counter()
            ctx.digest = digest(self.prof, tags=self.tags)
            print(f"trace: profiler stop {t2 - t1:.1f} s, digest "
                  f"{time.perf_counter() - t2:.1f} s", file=sys.stderr)


def instruments(readers) -> Tuple[List[Span], Tuple[str, ...]]:
    """The spans (each once) and digest tags that per-layer reader
    modules declare in ``SPANS`` and ``TAGS``. Two readers that declare
    one span name alike share it; declared unalike, it is an error."""
    spans: Dict[str, Span] = {}
    tags: Dict[str, None] = {}
    for mod in readers:
        for sp in getattr(mod, "SPANS", ()):
            if spans.setdefault(sp.name, sp) != sp:
                raise ValueError(f"span {sp.name!r} is declared two ways: "
                                 f"{spans[sp.name]} and {sp}")
        tags.update(dict.fromkeys(getattr(mod, "TAGS", ())))
    return list(spans.values()), tuple(tags)


def free(ctx: Ctx) -> None:
    """After the program's state is dropped: read nothing more of it,
    collect it, and give its memory back before the reference runs."""
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def peak(ctx: Ctx) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def per_token(joules: float, tokens: int) -> Optional[float]:
    """mJ a token, or None where no card was read."""
    return None if joules != joules else joules * 1e3 / tokens


def finite(xs: List[float]) -> bool:
    return all(x == x and abs(x) != float("inf") for x in xs)
