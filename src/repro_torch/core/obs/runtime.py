"""The model runtime's own spans and counters, on the wall clock.

The fleet's half of ``core/obs`` (:mod:`.trace`) keeps spans on the
simulation clock, bit-identical across runs; wall-clock data never goes
into them. This is the runtime's half: ranges around the serve loop's and
the train loop's phases, the MoE layer's steps, the Mamba-2 block's f32
chains and AdamW, and counters of the MoE dispatch.

It records only while a ``torch.profiler`` profile records, or inside
:func:`record`. Otherwise each call below reads one flag and returns.
While recording:

* :func:`span` opens a profiler range of its name, so the range lands in
  the trace, and keeps a record of its own: name, start and end in ns on
  the profiler's clock (the Unix epoch, which ``time.time_ns`` reads),
  the thread's native id, the span open on the same thread when it began
  (its parent), and its attributes. The start is read once the range is
  open and the end before it closes, so a kept span lies inside its
  range. The range is torch's ``_RecordFunctionFast``, the profiler's
  own range without a dispatcher call: ``torch.profiler.record_function``
  enters and leaves through two operators, which a profiler recording
  the device traces as ops, and ~60 of them a decode step cost the
  traced step several ms on an H100's host.
* :func:`count` adds to a host counter of a
  :class:`~repro_torch.core.obs.metrics.MetricsRegistry`;
  :func:`count_device` adds a 0-d tensor into an accumulator on its
  device, with no host sync. Each count carries the label ``span``: the
  innermost ``serve_loop.*`` or ``train_loop.*`` span open on its thread,
  ``""`` if none (autograd's own thread, which runs a remat's recompute,
  has none).

:func:`snapshot` gives the spans and counters as plain data and
:func:`reset` clears them. Spans of two threads may interleave: the store
is shared and each thread keeps its own stack of open spans.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.autograd.profiler as _profiler

from repro_torch.core.obs.metrics import MetricsRegistry

__all__ = ["recording", "record", "span", "count", "count_device",
           "snapshot", "reset", "PHASES"]

#: prefixes of the spans whose innermost open one labels a count
PHASES = ("serve_loop.", "train_loop.")

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_forced = 0                                    # open record() blocks
_spans: List[Dict[str, Any]] = []
_registry = MetricsRegistry()
_device: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], torch.Tensor] = {}
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans and counts are kept: a profiler records, or a
    :func:`record` block is open."""
    return _profiler._is_profiler_enabled or _forced > 0


@contextlib.contextmanager
def record() -> Iterator[None]:
    """Keep spans and counts inside the block without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _stack() -> List[Tuple[int, str]]:
    st = getattr(_local, "stack", None)
    if st is None:
        # the native id is a system call, slow on some hosts: read once a
        # thread
        _local.thread = threading.get_native_id()
        st = _local.stack = []
    return st


def _phase() -> str:
    for _, name in reversed(_stack()):
        if name.startswith(PHASES):
            return name
    return ""


class _Span:
    __slots__ = ("name", "attrs", "rf", "id", "parent", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> None:
        st = _stack()
        self.parent = st[-1][0] if st else None
        self.id = next(_ids)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        st.append((self.id, self.name))

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        _stack().pop()
        self.rf.__exit__(*exc)
        rec = {"id": self.id, "name": self.name, "start_ns": self.t0,
               "end_ns": t1, "thread": _local.thread,
               "parent": self.parent, "attrs": self.attrs}
        with _lock:
            _spans.append(rec)


def span(name: str, **attrs: Any):
    """A context manager: the span ``name`` around its block while
    recording, else nothing."""
    if not (_profiler._is_profiler_enabled or _forced):
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: float, **labels: Any) -> None:
    """Add ``n`` to the host counter ``name`` while recording."""
    if not (_profiler._is_profiler_enabled or _forced):
        return
    with _lock:
        _registry.counter(name, span=_phase(), **labels).inc(n)


def count_device(name: str, value: torch.Tensor, **labels: Any) -> None:
    """Add the 0-d tensor ``value`` into the counter ``name`` on its
    device while recording; read only by :func:`snapshot`. A meta tensor
    (a cell's cost trace) holds no count and adds nothing. The counter is
    a normal tensor even when made under ``torch.inference_mode`` (as
    serving runs), so that a later count outside it may add to it."""
    if not (_profiler._is_profiler_enabled or _forced):
        return
    if value.device.type == "meta":
        return
    key = (name, tuple(sorted((k, str(v)) for k, v in
                              dict(labels, span=_phase()).items())))
    with _lock:
        acc = _device.get(key)
        if acc is None:
            dt = (torch.float64 if value.is_floating_point()
                  else torch.int64)
            with torch.inference_mode(False):
                acc = _device[key] = torch.zeros((), dtype=dt,
                                                 device=value.device)
        acc.add_(value.detach())


def snapshot() -> Dict[str, Any]:
    """``{"spans": [...], "metrics": ...}``: every kept span (keys ``id``,
    ``name``, ``start_ns``, ``end_ns``, ``thread``, ``parent``, ``attrs``)
    in the order they closed, and a registry snapshot of the counters
    (:meth:`MetricsRegistry.snapshot`, for ``to_json`` and
    ``to_prometheus``), the device counters read with one sync a
    device."""
    with _lock:
        spans = [dict(s) for s in _spans]
        reg = MetricsRegistry()
        reg.absorb(_registry)
        dev = list(_device.items())
    by_dev: Dict[torch.device, list] = collections.defaultdict(list)
    for key, acc in dev:
        by_dev[acc.device].append((key, acc))
    for items in by_dev.values():
        vals = torch.stack([a.to(torch.float64) for _, a in items]).cpu()
        for ((name, labels), _), v in zip(items, vals.tolist()):
            reg.counter(name, **dict(labels)).inc(v)
    return {"spans": spans, "metrics": reg.snapshot()}


def reset() -> None:
    """Drop every kept span and count."""
    global _registry
    with _lock:
        _spans.clear()
        _device.clear()
        _registry = MetricsRegistry()

