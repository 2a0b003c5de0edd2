"""A cell's per-device cost without HLO: the port's counterpart of the
reference's ``runtime/hlo_analysis.py``.

The reference reads its numbers from XLA's post-SPMD HLO. PyTorch has no
such program, so the port defines them on a trace instead.

**The trace.** A cell's step (``steps.lower_cell``) runs once on meta
tensors at the global shapes, under ``sharding_scope(mesh, rules)`` with a
shape-only mesh, inside :func:`analyze_cell`'s dispatch mode. It covers
the forward, the backward and the recompute of each
``torch.utils.checkpoint`` group (the reference's remat).

**Mapped regions trace one coordinate.** ``layers.shard_map`` and
``moe.expert_parallel`` are where the reference runs ``shard_map``. Under a
shape-only mesh each runs the body of one mesh coordinate on meta slices
of that coordinate's shapes and returns meta outputs of the joined shapes
(:func:`one_coordinate`); under a ``HostMesh`` they loop over every
coordinate as before. ``expert_parallel``'s body routes its own token
shard, as every rank of a real mesh does. Where the bodies of two
coordinates differ in shape the largest counts, since a device of an SPMD
program waits for the slowest: the trace runs the first and the last
coordinate (where a clipped band or an uneven edge would show) and keeps
the one with more FLOPs. The slices and the joins are shapes only and
cost nothing.

**dot_flops_per_chip** = the FLOPs of every matmul, ``bmm``, ``baddbmm``,
einsum and convolution (``torch.utils.flop_counter``'s formulas) outside
the mapped regions divided by the number of chips, plus one coordinate's
FLOPs inside each mapped region: what one device of the reference's SPMD
program runs. One exception: the MoE's always-on branches (shared experts,
dense residual) are added to the expert-parallel output, whose layout is
the region's (tokens over the batch axes, whole over 'model'), so they are
counted at that layout (:func:`counted_at`): divided by the token split
and by the split of their 'ffn' dimension, not by every chip.

**mem_bytes_per_chip** = the operand and output bytes of each op that
materializes (views and allocations count nothing), per device by the
same rule. Eager torch fuses nothing, so this is an upper bound above the
reference's fusion-aware count.

**Collectives** are analytic: one process moves nothing, so each is
counted where the reference's program communicates, from the resolved
specs, with the reference's ring factors (all-gather out·(g−1)/g,
all-reduce 2·out·(g−1)/g, reduce-scatter out·(g−1), all-to-all
out·(g−1)/g, permute out):

- at each mapped region's boundary: an input whose recorded layout splits
  a dimension over axes the region's ``in_specs`` do not is all-gathered
  over them;
- at ``expert_parallel``'s sum over the model ranks: an all-reduce of the
  rank's [T_loc, d] output, and of the aux loss over the token shards;
- at each use of a parameter that the active rules shard over the axes of
  'fsdp': an all-gather in the forward and again in each recompute, then,
  for its gradient, a reduce-scatter over those axes and an all-reduce
  over the batch axes it is replicated on;
- at each ``logical_constraint`` whose resolved spec differs from its
  input's recorded layout: an all-gather over the axes the input is split
  on and the spec is not;
- at each product whose operands both split the contracted dimension over
  the same axes (a row-parallel product): an all-reduce of its output.

Layouts are recorded on parameters (``param_shardings``), step inputs
(``batch_shardings``), constrained tensors and region outputs, and carried
through views, casts, elementwise ops and products; a tensor without one
is taken to arrive in the layout its consumer wants, and costs nothing.
Collectives over a group of one device are not counted. XLA's own
resharding choices and rematerialization are not modelled, so these bytes
are held to the reference's only as ratios, never gated.

The reference's ``entry`` and ``n_computations`` name HLO computations and
have no meaning here; :func:`analyze_cell` leaves them out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.runtime import pspec as PS

aten = torch.ops.aten

# ops that allocate without reading or writing data
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default}
# ops whose output has the layout of their one tensor input
_SAME_LAYOUT = {aten.detach.default, aten.alias.default,
                aten.clone.default, aten._to_copy.default,
                aten.lift_fresh.default}
_RESHAPES = {aten.view.default, aten._unsafe_view.default}
_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}


def wire_bytes(kind: str, payload: float, group: int) -> float:
    """Bytes one device sends for a collective of ``payload`` output
    bytes over ``group`` devices (the reference's ring factors,
    ``hlo_analysis.py:339-355``)."""
    if group <= 1:
        return 0.0
    if kind == "all-gather" or kind == "all-to-all":
        return payload * (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * payload * (group - 1) / group
    if kind == "reduce-scatter":
        return payload * (group - 1)
    return payload


@dataclasses.dataclass
class _Acc:
    """Per-device counts of one scope: the trace, or one coordinate of a
    mapped region."""
    flops: float = 0.0
    bytes: float = 0.0
    wire: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    payload: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def add(self, other: "_Acc") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for k in other.counts:
            self.wire[k] += other.wire[k]
            self.payload[k] += other.payload[k]
            self.counts[k] += other.counts[k]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CellTrace(TorchDispatchMode):
    """Counts one trace of a cell's step, per device, as the module
    docstring defines."""

    def __init__(self, mesh: PS.AbstractMesh, rules: Dict):
        super().__init__()
        self.rules = rules
        self.axes = dict(mesh.shape) if mesh is not None else {}
        self.n_chips = math.prod(self.axes.values())
        self.acc = _Acc()
        self.accs: List[_Acc] = [self.acc]       # the current scope's last
        self.layouts = WeakIdKeyDictionary()     # tensor -> resolved spec
        self.params = WeakIdKeyDictionary()      # parameter -> its own spec
        self.gathered = set()                    # (param, pass, scope) done
        self.depth = 0                           # mapped regions entered
        self.split: Optional[int] = None         # counted_at's divisor
        self.quiet = 0                           # shape-only work
        self.alive: List[object] = []            # keeps keyed ids unique

    # ---- layouts
    def size(self, axes) -> int:
        return math.prod(self.axes[a] for a in axes)

    def layout(self, t) -> Optional[Tuple]:
        return self.layouts.get(t) if isinstance(t, torch.Tensor) else None

    def set_layout(self, t: torch.Tensor, spec) -> None:
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        self.layouts[t] = spec[:t.dim()]

    def shard_bytes(self, t: torch.Tensor, spec) -> float:
        return _nbytes(t) / self.size(a for e in spec for a in _axes(e))

    def fsdp_axes(self, spec) -> List[str]:
        fsdp = set(_axes(self.rules.get("fsdp")))
        return [a for e in spec for a in _axes(e) if a in fsdp]

    def add_param(self, p: torch.Tensor, spec) -> None:
        """A parameter: its own spec kept for its gathers and its
        gradient, and as its layout the spec its products see, with the
        'fsdp' axes gathered."""
        spec = tuple(spec) + (None,) * (p.dim() - len(spec))
        self.params[p] = spec
        fsdp = set(self.fsdp_axes(spec))
        self.set_layout(p, tuple(
            tuple(a for a in _axes(e) if a not in fsdp) or None
            for e in spec))

    def regather(self, t: torch.Tensor, target) -> None:
        """An all-gather where ``t``'s recorded layout splits a dimension
        over axes that ``target`` does not."""
        have = self.layout(t)
        if have is None:
            return
        target = tuple(target) + (None,) * (t.dim() - len(target))
        gone, kept = [], []
        for h, w in zip(have, target):
            for a in _axes(h):
                (kept if a in _axes(w) else gone).append(a)
        self.collective("all-gather", _nbytes(t) / self.size(kept),
                        self.size(gone))

    # ---- counts
    def scope_acc(self) -> _Acc:
        return self.accs[-1]

    def divisor(self) -> float:
        """Undivided inside a mapped region, else by ``counted_at``'s
        split or every chip. A backward op (grad off, an autograd node
        running) takes the divisor its node was tagged with; a
        recompute's ops (grad on) run in the Python scope of their
        forward."""
        if self.depth:
            return 1.0
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled():
            tag = node.metadata.get(_TAG)
            if tag is not None:
                return float(tag)
        return float(self.split if self.split is not None else self.n_chips)

    def collective(self, kind: str, payload: float, group: int) -> None:
        if group <= 1:
            return
        acc = self.scope_acc()
        acc.wire[kind] += wire_bytes(kind, payload, group)
        acc.payload[kind] += payload
        acc.counts[kind] += 1

    def _param_uses(self, args) -> None:
        """FSDP all-gathers: the first read of a parameter in a forward
        pass: the forward (grad or inference mode on) and each recompute
        (autograd's node set, grad on), not the backward proper or the
        optimizer (grad off)."""
        if not (torch.is_grad_enabled()
                or torch.is_inference_mode_enabled()):
            return
        node = torch._C._current_autograd_node()
        for a in args:
            if not isinstance(a, torch.Tensor) or a not in self.params:
                continue
            key = (id(a), None if node is None else id(node),
                   id(self.scope_acc()))
            if key in self.gathered:
                continue
            self.gathered.add(key)
            self.alive.append(node)
            spec = self.params[a]
            fsdp = self.fsdp_axes(spec)
            other = [x for e in spec for x in _axes(e) if x not in fsdp]
            self.collective("all-gather", _nbytes(a) / self.size(other),
                            self.size(fsdp))

    def _propagate(self, func, args, out) -> None:
        if not isinstance(out, torch.Tensor):
            return
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if func in _MATMULS:
            a, b = ins[-2], ins[-1]
            la, lb = self.layout(a), self.layout(b)
            if la is None and lb is None:
                return
            la = la or (None,) * a.dim()
            lb = lb or (None,) * b.dim()
            used = {x for e in la[:-1] for x in _axes(e)}
            col = tuple(x for x in _axes(lb[-1]) if x not in used) or None
            spec = la[:-1] + (col,)
            shared = [x for x in _axes(la[-1]) if x in _axes(lb[-2])]
            self.collective("all-reduce", self.shard_bytes(out, spec),
                            self.size(shared))
            self.set_layout(out, spec)
            return
        src = ins[0] if ins else None
        have = self.layout(src)
        if func in _SAME_LAYOUT or func.is_view or func in _RESHAPES:
            if have is not None:
                spec = self._view_layout(func, args, src, have, out)
                if spec is not None:
                    self.set_layout(out, spec)
            return
        best, most = None, 1
        for a in ins:
            la = self.layout(a)
            if la is None or a.shape != out.shape:
                continue
            n = self.size(x for e in la for x in _axes(e))
            if best is None or n > most:
                best, most = la, n
        if best is not None:
            self.set_layout(out, best)

    @staticmethod
    def _view_layout(func, args, src, have, out) -> Optional[Tuple]:
        if func is aten.t.default and len(have) == 2:
            return have[::-1]
        if func is aten.transpose.int:
            d0, d1 = (d % src.dim() for d in args[1:3])
            spec = list(have)
            spec[d0], spec[d1] = spec[d1], spec[d0]
            return tuple(spec)
        if func is aten.permute.default:
            return tuple(have[d % src.dim()] for d in args[1])
        if tuple(out.shape) == tuple(src.shape):
            return have
        if func in _RESHAPES:
            return _reshape_layout(tuple(src.shape), have, tuple(out.shape))
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        # as FlopCounterMode: an op without a formula runs decomposed
        if packet not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if self.quiet:
            return out
        self._param_uses(args)
        acc, div = self.scope_acc(), self.divisor()
        if packet in flop_registry:
            acc.flops += flop_registry[packet](*args, **kwargs,
                                               out_val=out) / div
        if not func.is_view and func not in _NO_TRAFFIC:
            flat = list(args) + list(kwargs.values())
            n = sum(_nbytes(a) for a in flat if isinstance(a, torch.Tensor))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            n += sum(_nbytes(o) for o in outs if isinstance(o, torch.Tensor))
            acc.bytes += n / div
        self._propagate(func, args, out)
        return out


def _reshape_layout(src: Tuple[int, ...], have: Tuple,
                    dst: Tuple[int, ...]) -> Optional[Tuple]:
    """A reshape's layout: dimensions grouped where the running products
    of ``src`` and ``dst`` meet; a group's split (every axis its source
    dimensions are split over) goes to its outermost target dimension.
    A merge of two split dimensions is no block split in row-major order,
    but it keeps what the counts need: how many devices share the tensor,
    and over which axes a later spec must gather it."""
    out: List = []
    i = j = 0
    while i < len(src) or j < len(dst):
        gi, gj = [i], [j]
        pi = src[i] if i < len(src) else 1
        pj = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                if i >= len(src):
                    return None
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                if j >= len(dst):
                    return None
                gj.append(j)
                pj *= dst[j]
                j += 1
        axes = tuple(a for k in gi if k < len(have) for a in _axes(have[k]))
        entry = None if not axes else axes[0] if len(axes) == 1 else axes
        out.extend([entry] + [None] * (len(gj) - 1))
    return tuple(out[:len(dst)])


_ACTIVE: Optional[_CellTrace] = None
_LOCK = threading.Lock()


def active() -> Optional[_CellTrace]:
    """The trace :func:`analyze_cell` is running, if any."""
    return _ACTIVE


@contextlib.contextmanager
def _counting(acc: Optional[_Acc], split: Optional[int]):
    """Counts go to ``acc`` (None: the current scope's), undivided when
    ``split`` is None (inside a mapped region), else divided by
    ``split``."""
    tr = _ACTIVE
    if tr is None:
        yield
        return
    prev = (tr.split, tr.depth)
    tr.accs.append(acc if acc is not None else tr.scope_acc())
    if split is None:
        tr.depth += 1
    elif not tr.depth:
        tr.split = int(split)
    try:
        yield
    finally:
        tr.accs.pop()
        tr.split, tr.depth = prev


@contextlib.contextmanager
def _quiet():
    tr = _ACTIVE
    if tr is not None:
        tr.quiet += 1
    try:
        yield
    finally:
        if tr is not None:
            tr.quiet -= 1


class _Shape(torch.autograd.Function):
    """A meta tensor of another shape, and its gradient back in the
    input's: the slicing and joining around one coordinate, shapes only."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shape: Tuple[int, ...]):
        ctx.shape = x.shape
        with _quiet():
            return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with _quiet():
            return g.new_empty(ctx.shape), None


_TAG = "cost_analysis.divisor"


def _scoped(body: Callable, split: Optional[int], inputs: Sequence
            ) -> Tuple[torch.Tensor, ...]:
    """``body(*inputs)`` counted as ``split`` says (see :func:`_counting`),
    its backward too. Autograd runs a backward outside the Python scope of
    its forward, so every autograd node the body made (from its outputs
    back to ``inputs``) is tagged with the divisor, which the trace reads
    off the node it runs (``torch._C._current_autograd_node``)."""
    with _counting(None, split):
        outs = tuple(body(*inputs))
    if _ACTIVE is not None and torch.is_grad_enabled():
        stop = {t.grad_fn for t in inputs
                if isinstance(t, torch.Tensor) and t.grad_fn is not None}
        todo = [o.grad_fn for o in outs if o.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen:
                continue
            seen.add(node)
            node.metadata[_TAG] = 1 if split is None else int(split)
            todo.extend(f for f, _ in node.next_functions)
    return outs


def counted_at(split: int, body: Callable, *inputs
               ) -> Tuple[torch.Tensor, ...]:
    """``body(*inputs)`` with its ops (forward and backward) divided by
    ``split`` devices, not by every chip: work laid out by a mapped
    region's output (the MoE's shared experts and dense residual). Outside
    a trace, or inside a mapped region, it is the body itself."""
    tr = _ACTIVE
    if tr is None or tr.depth:
        return tuple(body(*inputs))
    return _scoped(body, split, inputs)


def corners(mesh: PS.AbstractMesh) -> List[Dict[str, int]]:
    """The first and the last coordinate of ``mesh`` (one if they are the
    same): the coordinates :func:`one_coordinate` traces."""
    first = {a: 0 for a in mesh.axis_names}
    last = {a: mesh.shape[a] - 1 for a in mesh.axis_names}
    return [first] if first == last else [first, last]


def _split_shape(shape, spec, mesh, undo: bool = False) -> Tuple[int, ...]:
    """``shape`` divided (or, ``undo``, multiplied) by the mesh axes its
    spec names per dimension."""
    out = list(shape)
    for d, e in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(e))
        out[d] = out[d] * n if undo else out[d] // n
    return tuple(out)


def one_coordinate(body: Callable[..., Sequence[torch.Tensor]],
                   coords: Sequence[Dict[str, int]],
                   inputs: Sequence[torch.Tensor],
                   in_specs: Sequence[Tuple],
                   out_specs: Sequence[Tuple]) -> Tuple[torch.Tensor, ...]:
    """A mapped region under the active shape-only mesh: ``body(coord,
    *locals)`` (-> a tuple of tensors) for each of ``coords`` on meta
    inputs of the shapes ``in_specs`` give one coordinate, the one with
    the most FLOPs kept (its counts, and its outputs given the shapes that
    ``out_specs`` join), the others' counts dropped. An input whose
    recorded layout splits it where its spec does not is gathered at the
    boundary; the joined outputs carry ``out_specs``. A parameter's slice
    stays a parameter, split as its own spec is and the region's is not
    (a body that uses it gathers it over 'fsdp', as the reference's
    ``local_fn`` does)."""
    tr, mesh = _ACTIVE, PS.active_mesh()
    best = None
    for coord in coords:
        acc = _Acc()
        with _counting(acc, None):
            local = []
            for t, spec in zip(inputs, in_specs):
                if tr is not None:
                    tr.regather(t, spec)
                piece = _Shape.apply(t, _split_shape(t.shape, spec, mesh))
                if tr is not None and t in tr.params:
                    own = tr.params[t]
                    tr.add_param(piece, tuple(
                        tuple(a for a in _axes(e) if a not in _axes(w))
                        or None for e, w in zip(own, tuple(spec) + (None,)
                                                * (t.dim() - len(spec)))))
                local.append(piece)

            def run(*leaves, coord=coord):
                return body(coord, *leaves)

            outs = _scoped(run, None, local)
        if tr is not None:
            tr.alive.append(acc)
        if best is None or acc.flops > best[0].flops:
            best = (acc, outs)
    acc, outs = best
    if tr is not None:
        tr.scope_acc().add(acc)
    joined = tuple(_Shape.apply(o, _split_shape(o.shape, spec, mesh,
                                                undo=True))
                   for o, spec in zip(outs, out_specs))
    if tr is not None:
        for o, spec in zip(joined, out_specs):
            tr.set_layout(o, spec)
    return joined


def record_collective(kind: str, payload: float, group: int) -> None:
    """A collective the traced program makes here (per device)."""
    if _ACTIVE is not None:
        _ACTIVE.collective(kind, payload, group)


def constrain(x: torch.Tensor, spec) -> None:
    """``logical_constraint``'s share: regather ``x`` if its recorded
    layout differs from ``spec``, then record ``spec`` on it."""
    tr = _ACTIVE
    if tr is None or tr.quiet:
        return
    tr.regather(x, spec)
    tr.set_layout(x, spec)


def trace(fn: Callable[[], object], mesh: Optional[PS.AbstractMesh],
          rules, *, params: Sequence[Tuple[torch.Tensor, Tuple]] = (),
          inputs: Sequence[Tuple[torch.Tensor, Tuple]] = (),
          gradients: bool = False) -> Dict:
    """Run ``fn()`` once under ``sharding_scope(mesh, rules)`` and the
    counting dispatch mode; ``params`` are (parameter, its spec) and
    ``inputs`` (input, its spec) pairs, whose layouts the trace starts
    from; ``gradients`` adds each parameter's gradient sync. Returns the
    reference's keys but ``entry`` and ``n_computations`` (see
    :func:`analyze_cell`). Under a shape-only mesh the mapped regions run
    one coordinate only inside this call; a ``HostMesh`` runs every
    coordinate and is refused."""
    global _ACTIVE
    if isinstance(mesh, PS.HostMesh):
        raise TypeError("a HostMesh runs every coordinate: trace a cell "
                        "under the shape of its mesh (pspec.abstract_mesh)")
    if isinstance(rules, str):
        rules = PS.RULE_SETS[rules]
    rules = dict(PS.DEFAULT_RULES if rules is None else rules)
    with _LOCK:
        tr = _CellTrace(mesh, rules)
        for p, spec in params:
            tr.add_param(p, spec)
        for t, spec in inputs:
            tr.set_layout(t, spec)
        _ACTIVE = tr
        try:
            with PS.sharding_scope(mesh, rules), tr:
                fn()
        finally:
            _ACTIVE = None
        if gradients:
            _gradient_sync(tr, [p for p, _ in params])
    acc = tr.acc
    return {
        "dot_flops_per_chip": acc.flops,
        "mem_bytes_per_chip": acc.bytes,
        "collective_wire_bytes_per_chip": dict(acc.wire),
        "collective_payload_bytes_per_chip": dict(acc.payload),
        "collective_op_counts": dict(acc.counts),
        "collective_total_per_chip": sum(acc.wire.values()),
        "num_partitions": tr.n_chips,
    }


def analyze_cell(lowered) -> Dict:
    """Trace ``lowered`` (a ``steps.LoweredCell``) once, as the module
    docstring defines, and return the reference's keys
    (``hlo_analysis.py:379-399``) but ``entry`` and ``n_computations``:
    ``dot_flops_per_chip``, ``mem_bytes_per_chip``,
    ``collective_wire_bytes_per_chip`` /
    ``collective_payload_bytes_per_chip`` / ``collective_op_counts`` (by
    kind), ``collective_total_per_chip`` and ``num_partitions``."""
    model, args = lowered.instantiate()
    shard = lowered.param_shardings
    return trace(lambda: lowered.step(model, *args), lowered.mesh,
                 lowered.rules,
                 params=[(p, () if shard[n] is None else shard[n].spec)
                         for n, p in model.named_parameters()],
                 inputs=[(t, sh.spec) for t, sh in lowered.input_layouts()
                         if sh is not None],
                 gradients=lowered.kind == "train")


def _gradient_sync(tr: _CellTrace, params: Sequence[torch.Tensor]) -> None:
    """Each gradient's reduce-scatter over the 'fsdp' axes its parameter
    is split on, and its all-reduce over the batch axes it is replicated
    on."""
    batch = [a for a in _axes(tr.rules.get("batch")) if a in tr.axes]
    for p in params:
        spec = tr.params[p]
        fsdp = tr.fsdp_axes(spec)
        shard = tr.shard_bytes(p, spec)
        tr.collective("reduce-scatter", shard, tr.size(fsdp))
        split = {a for e in spec for a in _axes(e)}
        tr.collective("all-reduce", shard,
                      tr.size(a for a in batch if a not in split))
