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

**Layouts.** Every tensor of the trace carries a layout (per dimension
the mesh axes that split it, or none): parameters their
``param_shardings``, step inputs their ``batch_shardings``, constrained
tensors the constraint's spec, region outputs their ``out_specs``. An op
gives its output the layout its inputs imply: a view maps it (reshapes
by grouping dimensions), an elementwise op takes its most split input's
(matched from the right, broadcast dimensions whole), a reduction drops
the reduced dimensions', a product ``[.., M, K] x [.., K, N]`` takes
batch and M from one operand and N from the other, the larger operand
keeping a mesh axis both ask for. A tensor without a layout is whole.

Layouts also flow backwards, as XLA's sharding propagation does: what an
op's output layout implies for its inputs (views inverted, elementwise
inputs matched from the right, a product's operands its batch, row or
column splits and the other operand's split of the contracted dimension)
is pushed back to the ops that made them, and so is what a mapped
region's ``in_specs`` ask of its inputs. An op whose output gains a
split on an axis its layout left free is counted again at the finer
layout (:meth:`_CellTrace.refine`); a product keeps its contraction's
split.

**dot_flops_per_chip** = the FLOPs of every matmul, ``bmm``, ``baddbmm``,
einsum and convolution (``torch.utils.flop_counter``'s formulas) at the
shard shapes of their layouts: each dimension split over axes counts
ceil(n / split) (``named_sharding``'s shard shape, XLA's padding), a
dimension no layout splits counts whole. A product's iteration space is
its output's shard times its contracted dimension's, split over the axes
either operand splits it on and the output does not use (slicing the
other operand, whole there, is free). Inside a mapped region one
coordinate's FLOPs count whole: what one device of the reference's SPMD
program runs. One exception: the MoE's always-on branches (shared
experts, dense residual) are added to the expert-parallel output, whose
layout is the region's (tokens over the batch axes, whole over 'model'),
so they are counted at that layout (:func:`counted_at`): divided by the
token split and by the split of their 'ffn' dimension.

**The hand-written kernels** (``repro_torch::flash_fwd``,
``repro_torch::ssd_scan_fwd``: the ``flash`` path's attention and SSD
scan, the reference's ``pallas``) run on meta tensors as their fake
implementations, which allocate what the CUDA wrappers allocate and
compute nothing. Each counts by the rule beside its kernel
(``flash_cost``, ``ssd_cost``: the reference's Pallas grid for the FLOPs,
each input read and each output written once for the bytes), at the share
of its first output, whose layout is its lead input's (q, x): the kernel
splits as the batch and heads it is given. The SSD scan's scratch is live
memory at ``workspace_bytes`` of the lead input's shard shape, not bytes
moved. :func:`analyze` can also return the calls of each kernel.

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
- at each product whose contracted dimension splits (a row-parallel
  product): an all-reduce of its output over those axes.

Here a tensor without a layout is taken to arrive in the layout its
consumer wants, and costs nothing. Collectives over a group of one device
are not counted. XLA's own resharding choices and rematerialization are
not modelled, so these bytes are held to the reference's only as ratios,
never gated.

**Memory** (:func:`analyze`): the step's arguments at their shardings'
shard shapes, and the peak of the bytes a device holds of the storages
the step allocates, each counted by the layout of the tensor that made
it until the storage itself dies.

The reference's ``entry`` and ``n_computations`` name HLO computations and
have no meaning here; :func:`analyze_cell` leaves them out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
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
# ops whose outputs are pieces of their first input
_SPLITS = {aten.split, aten.split_with_sizes, aten.chunk, aten.unbind,
           aten.unsafe_split, aten.tensor_split}
# reductions over ``dim`` (their second argument or keyword)
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.logsumexp, aten.argmax, aten.argmin,
               aten.prod, aten.var, aten.std, aten.any, aten.all}


@dataclasses.dataclass(frozen=True)
class _Kernel:
    """A hand-written kernel's op as the trace counts it: ``cost(args)``
    its (FLOPs, bytes) by the rule beside the kernel, ``outs(lead)`` its
    outputs' layouts from its lead input's (None: whole), ``ins(i, spec,
    shapes)`` the layouts that output ``i`` in ``spec`` implies for its
    inputs, ``scratch(args, lead_shape)`` the bytes of outputs that are
    scratch, by index, at the lead input's (shard) shape."""
    name: str
    cost: Callable
    outs: Callable
    ins: Callable
    scratch: Callable = lambda args, lead: {}


def _flash_ins(i: int, spec: Tuple, shapes) -> List[Tuple]:
    # q as o; k and v by batch, and by heads where they are q's heads
    kv = (spec[0], None, spec[2] if shapes[1][2] == shapes[0][2] else None,
          None)
    return [tuple(spec), kv, kv]


def _ssd_ins(i: int, spec: Tuple, shapes) -> List[Tuple]:
    if i == 2:                                   # the scratch
        return []
    if i == 1:                                   # h [B, nh, hd, N]
        spec = (spec[0], None, spec[1], spec[2])
    bc = (spec[0], spec[1], None, None)
    return [tuple(spec), tuple(spec[:3]), (spec[2],), bc, bc]


_KERNELS = {
    torch.ops.repro_torch.flash_fwd.default: _Kernel(
        "flash_attention",
        cost=lambda a: _fa.flash_cost(a[0].shape, a[1].shape,
                                      a[0].element_size()),
        outs=lambda lead: [lead],
        ins=_flash_ins),
    torch.ops.repro_torch.ssd_scan_fwd.default: _Kernel(
        "ssd_scan",
        cost=lambda a: _ssd.ssd_cost(a[0].shape, a[3].shape[3], a[5],
                                     a[0].element_size()),
        outs=lambda lead: [lead, (lead[0], lead[2], lead[3], None), None],
        ins=_ssd_ins,
        scratch=lambda a, lead: {2: _ssd.workspace_bytes(
            *lead, a[3].shape[3], a[5]) if math.prod(lead) else 0}),
}


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
    kernels: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def add(self, other: "_Acc") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for k, n in other.kernels.items():
            self.kernels[k] += n
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
        self.storages: Dict[int, object] = {}    # id -> weakref, tracked
        self.nodes = WeakIdKeyDictionary()       # tensor -> its _Node
        self.gathered_on = WeakIdKeyDictionary()  # weight -> fsdp axes
        self.unread: Dict[int, torch.Tensor] = {}  # arguments not read yet
        self.events: List[Tuple] = []            # allocations and frees

    # ---- layouts
    def size(self, axes) -> int:
        return math.prod(self.axes[a] for a in axes)

    def layout(self, t) -> Optional[Tuple]:
        return self.layouts.get(t) if isinstance(t, torch.Tensor) else None

    def set_layout(self, t: torch.Tensor, spec) -> None:
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        self.layouts[t] = spec[:t.dim()]
        nd = self.nodes.get(t)
        if nd is not None:
            nd.layout = self.layouts[t]

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
        self.gathered_on[p] = tuple(
            tuple(a for a in _axes(e) if a in fsdp) for e in spec)

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

    # ---- live bytes
    def known(self, tensors) -> None:
        """Storages that exist before the step (its arguments): not
        allocated by it, whatever updates them in place."""
        for t in tensors:
            st = t.untyped_storage()
            self.storages.setdefault(id(st), weakref.ref(
                st, lambda _, key=id(st): self.storages.pop(key, None)))
            self.unread[id(t)] = t

    def reads(self, args, kwargs) -> None:
        """Arguments an op reads: the step uses them (XLA drops the
        arguments a step never reads from its executable)."""
        if not self.unread:
            return
        for a in list(args) + list(kwargs.values()):
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor):
                    self.unread.pop(id(t), None)

    def allocated(self, outs, div: Optional[float],
                  fixed: Optional[Dict[int, float]] = None) -> None:
        """Each new storage among ``outs`` is live on a device from here
        until the storage itself dies: not when its last Python tensor
        does, since autograd's saved tensors keep storages alive past
        them. Its bytes there are :meth:`held`'s, by the layout its tensor
        ends the trace with (a later consumer can refine it), so they are
        summed in :attr:`live` and :attr:`peak` only when read; or
        ``fixed[i]`` for the ``i``-th of ``outs`` (a kernel's scratch)."""
        for i, o in enumerate(outs):
            if not isinstance(o, torch.Tensor):
                continue
            st = o.untyped_storage()
            if id(st) in self.storages or st.nbytes() == 0:
                continue
            key = id(st)
            size = (fixed[i] if fixed and i in fixed
                    else st.nbytes() / div if div is not None
                    else (st.nbytes(), _node_of(self, o)))
            self.storages[key] = weakref.ref(
                st, lambda _, key=key: self.freed(key))
            self.events.append((key, size))

    def freed(self, key: int) -> None:
        self.storages.pop(key, None)
        self.events.append((key, None))

    def _replay(self) -> Tuple[float, float]:
        live = peak = 0.0
        held: Dict[int, float] = {}
        for key, size in self.events:
            if size is None:
                live -= held.pop(key, 0.0)
                continue
            if isinstance(size, tuple):
                n, nd = size
                size = n * self.share(nd.get(self))
            held[key] = size
            live += size
            peak = max(peak, live)
        return live, peak

    @property
    def live(self) -> float:
        """Bytes a device holds of the storages the step allocated and
        that are alive now."""
        return self._replay()[0]

    @property
    def peak(self) -> float:
        """The most :attr:`live` has been so far."""
        return self._replay()[1]

    # ---- counts
    def scope_acc(self) -> _Acc:
        return self.accs[-1]

    def divisor(self) -> Optional[float]:
        """1 inside a mapped region, ``counted_at``'s split under it, else
        None: the op counts at the shard shapes of its layouts
        (:meth:`held`, :meth:`flop_share`). A backward op (grad off, an
        autograd node running) takes the divisor its node was tagged
        with; a recompute's ops (grad on) run in the Python scope of their
        forward (or re-enter it, :func:`recount`)."""
        if self.depth:
            return 1.0
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled():
            tag = node.metadata.get(_TAG)
            if tag is not None:
                return float(tag)
        return None if self.split is None else float(self.split)

    def share(self, t: torch.Tensor) -> float:
        """The fraction of ``t`` one device holds in its layout (none:
        whole): each dimension split over axes counts ceil(n / split),
        ``named_sharding``'s shard shape and XLA's padding."""
        spec = self.layout(t)
        if not spec or t.numel() == 0:
            return 1.0
        frac = 1.0
        for n, e in zip(t.shape, spec):
            k = self.size(_axes(e))
            if k > 1:
                frac *= -(-n // k) / n
        return frac

    def shard_shape(self, t: torch.Tensor) -> List[int]:
        """``t``'s shape on one device in its layout (ceil, as
        :meth:`share`)."""
        spec = self.layout(t) or (None,) * t.dim()
        return [-(-n // self.size(_axes(e))) for n, e in zip(t.shape, spec)]

    def held(self, t: torch.Tensor, div: Optional[float]) -> float:
        """``t``'s bytes on one device."""
        if div is not None:
            return _nbytes(t) / div
        return _nbytes(t) * self.share(t)

    def flop_share(self, func, args, out) -> float:
        """The fraction of an op's FLOPs one device runs: its iteration
        space at the shard shapes: a product's is its output's share (the
        layout :meth:`_propagate` gave it) times that of the contracted
        dimension (:meth:`_contracted`), a kernel's its first output's, any
        other op's its output's."""
        if func in _KERNELS:
            return self.share(out[0] if isinstance(out, list) else out)
        if func in _MATMULS:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            n = ins[-2].shape[-1]
            k = self.size(self._contracted(ins[-2], ins[-1], out))
            return self.share(out) * (-(-n // k) / n if n else 1.0)
        return self.share(out) if isinstance(out, torch.Tensor) else 1.0

    def _contracted(self, a: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor, idle: bool = True) -> List[str]:
        """The axes ``a @ b``'s contracted dimension splits over, given
        its output's layout (``idle``: with the idle axes :meth:`_idle`
        adds)."""
        la, lb = self.layout(a), self.layout(b)
        if la is None and lb is None:
            return []
        lb = self._weight_layout(b, la, lb)
        _, got = _product_layout(la or (None,) * a.dim(), lb,
                                 a.numel() >= b.numel())
        used = {x for e in self.layout(out) or () for x in _axes(e)}
        got = [x for x in got if x not in used]
        return got + (self._idle(b, la, lb, used | set(got)) if idle
                      else [])

    def _weight_layout(self, b: torch.Tensor, la, lb) -> Tuple:
        """A weight's layout in a product: its 'fsdp' split stays where
        the activation leaves those axes free (XLA gathers a weight only
        where its split is in the way)."""
        lb = lb or (None,) * b.dim()
        g = self.gathered_on.get(b)
        if g is None:
            return lb
        taken = {x for lay in (la, lb) for e in lay or () for x in _axes(e)}
        out = []
        for e, f in zip(lb, g):
            add = tuple(x for x in _axes(f) if x not in taken)
            taken.update(add)
            got = _axes(e) + add
            out.append(None if not got else got[0] if len(got) == 1
                       else got)
        return tuple(out)

    def _idle(self, b: torch.Tensor, la, lb, used) -> List[str]:
        """A weight split over 'fsdp' on its contracted dimension, which no
        other axis splits, whose 'fsdp' axes the activation uses, is not
        gathered either: XLA moves its split onto the mesh axes nothing
        uses (an all-to-all) and splits the contraction over those."""
        g = self.gathered_on.get(b)
        if g is None or len(g) < 2 or not _axes(g[-2]) or any(
                _axes(lb[-2])):
            return []
        taken = set(used) | {x for lay in (la, lb) for e in lay or ()
                             for x in _axes(e)}
        return [x for x in self.axes if x not in taken and self.axes[x] > 1]

    def contracted(self, op: "_Op") -> List[str]:
        """The axes ``op``'s operands split its contraction over: a
        refinement leaves them, not the idle axes, to the contraction."""
        a, b = (n.get(self) for n in op.inputs()[-2:])
        return self._contracted(a, b, op.outs[0].get(self), idle=False)

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

    def _propagate(self, func, args, kwargs, out) -> None:
        kern = _KERNELS.get(func)
        if kern is not None:
            lead = self.layout(args[0])
            if lead is not None:
                for o, spec in zip(out if isinstance(out, (list, tuple))
                                   else [out], kern.outs(lead)):
                    if spec is not None:
                        self.set_layout(o, spec)
            return
        if func._overloadpacket in _REDUCTIONS and not (
                len(args) > 1 and isinstance(args[1], torch.Tensor)):
            have = self.layout(args[0])
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                spec = _reduced_layout(have, args, kwargs, o)
                if spec is not None:
                    self.set_layout(o, spec)
            return
        if isinstance(out, (tuple, list)) and func._overloadpacket in _SPLITS:
            have = self.layout(args[0])
            if have is not None:
                for o in out:
                    self.set_layout(o, _piece(tuple(args[0].shape), have,
                                              tuple(o.shape)))
            return
        if not isinstance(out, torch.Tensor):
            return
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if func is aten.cat.default:
            ins = list(args[0])
        if func in _MATMULS:
            a, b = ins[-2], ins[-1]
            la, lb = self.layout(a), self.layout(b)
            if la is None and lb is None:
                return
            lb = self._weight_layout(b, la, lb)
            spec, contracted = _product_layout(
                la or (None,) * a.dim(), lb, a.numel() >= b.numel())
            used = {x for e in spec for x in _axes(e)} | set(contracted)
            contracted = contracted + self._idle(b, la, lb, used)
            self.collective("all-reduce", self.shard_bytes(out, spec),
                            self.size(contracted))
            self.set_layout(out, spec)
            return
        src = ins[0] if ins else None
        have = self.layout(src)
        if src is not None and src in self.gathered_on and (
                func in _SAME_LAYOUT or func in (aten.t.default,
                                                 aten.transpose.int,
                                                 aten.permute.default)):
            g = self._view_layout(func, args, src, self.gathered_on[src],
                                  out)
            if g is not None:
                self.gathered_on[out] = g
        if func in _SAME_LAYOUT or func.is_view or func in _RESHAPES:
            if have is not None:
                spec = self._view_layout(func, args, src, have, out)
                if spec is not None:
                    self.set_layout(out, spec)
            return
        best, most = None, 1
        for a in ins:
            la = self.layout(a)
            if la is None or a.dim() > out.dim():
                continue
            off = out.dim() - a.dim()
            la = (None,) * off + tuple(
                e if n == out.shape[off + i] else None
                for i, (n, e) in enumerate(zip(a.shape, la)))
            n = self.size(x for e in la for x in _axes(e))
            if best is None or n > most:
                best, most = la, n
        if best is not None:
            self.set_layout(out, best)

    @staticmethod
    def _view_layout(func, args, src, have, out) -> Optional[Tuple]:
        nd = src.dim()
        if func is aten.t.default and len(have) == 2:
            return have[::-1]
        if func is aten.transpose.int:
            d0, d1 = (d % nd for d in args[1:3])
            spec = list(have)
            spec[d0], spec[d1] = spec[d1], spec[d0]
            return tuple(spec)
        if func is aten.permute.default:
            return tuple(have[d % nd] for d in args[1])
        if func is aten.unsqueeze.default:
            d = args[1] % (nd + 1)
            return have[:d] + (None,) + have[d:]
        if func is aten.select.int:
            d = args[1] % nd
            return have[:d] + have[d + 1:]
        if func in (aten.expand.default, aten.slice.Tensor,
                    aten.narrow.default):
            return _piece(tuple(src.shape), have, tuple(out.shape))
        if func in (aten.squeeze.dim, aten.squeeze.dims,
                    aten.squeeze.default):
            return _squeezed(tuple(src.shape), have, tuple(out.shape))
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
        self.reads(args, kwargs)
        if self.quiet:
            return out
        self._param_uses(args)
        self._propagate(func, args, kwargs, out)
        acc, div = self.scope_acc(), self.divisor()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        op = _Op(self, func, args, kwargs, outs, acc,
                 flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0.0)
        self.count(op, div)
        if div is None and not func._schema.is_mutable:
            op.outs = [self.node(o, op) for o in outs
                       if isinstance(o, torch.Tensor)]
            self._refine([(nd, want) for o in op.outs
                          if o.layout is not None
                          for nd, want in _implied(op, o, o.layout)])
        kern = _KERNELS.get(func)
        fixed = None
        if kern is not None:
            acc.kernels[kern.name] += 1
            lead = args[0]
            fixed = kern.scratch(args, tuple(
                lead.shape if div is not None else self.shard_shape(lead)))
            if div is not None:
                fixed = {i: b / div for i, b in fixed.items()}
        if not func.is_view:
            self.allocated(outs, div, fixed)
        return out

    def node(self, t: torch.Tensor, op: Optional["_Op"] = None
             ) -> "_Node":
        """``t``'s node: made by ``op`` (a new one), else the one it has,
        else a leaf."""
        if op is None:
            got = self.nodes.get(t)
            if got is not None:
                return got
        nd = _Node(t, op, t in self.params)
        nd.layout = self.layout(t)
        self.nodes[t] = nd
        return nd

    # ---- per-op counts, and their recount at a finer layout
    def count(self, op: "_Op", div: Optional[float], sign: float = 1.0
              ) -> None:
        """Add (``sign`` -1: take back) ``op``'s FLOPs and bytes on one
        device to the accumulator it was counted in."""
        if op.flops:
            args = tuple(a.get(self) if isinstance(a, _Node) else a
                         for a in op.args)
            out = [o.get(self) for o in op.outs]
            op.acc.flops += sign * (
                op.flops / div if div is not None
                else op.flops * self.flop_share(
                    op.func, args, out[0] if len(out) == 1 else out))
        kern = _KERNELS.get(op.func)
        if kern is not None:
            args = [a.get(self) if isinstance(a, _Node) else a
                    for a in op.args]
            nbytes = kern.cost(args)[1]
            op.acc.bytes += sign * (
                nbytes / div if div is not None
                else nbytes * self.share(op.outs[0].get(self)))
        elif not op.func.is_view and op.func not in _NO_TRAFFIC:
            op.acc.bytes += sign * sum(
                self.held(t, div) for t in op.tensors(self))

    def refine(self, t: torch.Tensor, spec) -> None:
        """A consumer (a mapped region's input spec) wants ``t`` split over
        mesh axes its layout leaves free. XLA's sharding propagation runs
        the ops that made ``t`` split that way too, back through views,
        elementwise ops and products as far as the split maps: each such
        op (outside the mapped regions) is counted again at the finer
        layout."""
        self._refine([(self.node(t), spec)])

    def _refine(self, todo: List[Tuple["_Node", Tuple]]) -> None:
        while todo:
            nd, want = todo.pop()
            if nd.param:
                continue
            have = self.layout(nd.get(self))
            op = nd.op
            if op is not None and op.func in _MATMULS:
                keep = set(self.contracted(op))     # a product keeps its
                want = tuple(tuple(x for x in _axes(e) if x not in keep)
                             or None for e in want)  # contraction's split
            new = _finer(have or (None,) * len(nd.shape), want, nd.shape,
                         self.axes)
            if new is None:
                continue
            if op is not None:
                self.count(op, None, -1.0)
            nd.layout = new
            self.set_layout(nd.get(self), new)
            if op is None:
                continue
            ins = _implied(op, nd, new)
            kern = _KERNELS.get(op.func)
            if kern is not None:            # its outputs as its lead input
                sibs = kern.outs(ins[0][1]) if ins else []
            else:
                sibs = [_piece(nd.shape, new, o.shape) for o in op.outs]
            for o, spec in zip(op.outs, sibs):
                if o is not nd and spec is not None:
                    todo.append((o, spec))
            self.count(op, None)
            todo.extend(ins)

class _Node:
    """A tensor of the trace as a product of an op outside the mapped
    regions: its shape, dtype, layout and the op that made it (None for a
    leaf: an argument, a parameter, a region's output). The tensor is held
    weakly; nodes hold their ops and ops their input nodes, so the chain
    behind a live tensor stays for :meth:`_CellTrace.refine` when the
    tensors in it have died."""
    __slots__ = ("ref", "shape", "dtype", "layout", "op", "param", "dead")

    def __init__(self, t: torch.Tensor, op: Optional["_Op"], param: bool):
        self.ref = weakref.ref(t)
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self.layout, self.op, self.param, self.dead = None, op, param, None

    def get(self, tr: "_CellTrace") -> torch.Tensor:
        """The tensor, or once it has died a meta stand-in in its
        layout."""
        t = self.ref()
        if t is not None:
            return t
        if self.dead is None:
            with _quiet():                     # no allocation of the step
                self.dead = torch.empty(self.shape, dtype=self.dtype,
                                        device="meta")
            if self.layout is not None:
                tr.layouts[self.dead] = self.layout
        return self.dead


class _Op:
    """One op as counted, with its input nodes: what
    :meth:`_CellTrace.refine` counts again at a finer layout."""
    __slots__ = ("func", "acc", "flops", "args", "kw", "outs")

    def __init__(self, tr: "_CellTrace", func, args, kwargs, outs,
                 acc: "_Acc", flops: float):
        self.func, self.acc, self.flops = func, acc, flops

        def wrap(a):
            if isinstance(a, torch.Tensor):
                return _node_of(tr, a)
            if isinstance(a, (list, tuple)) and a and all(
                    isinstance(t, torch.Tensor) for t in a):
                return [_node_of(tr, t) for t in a]
            return a
        self.args = tuple(wrap(a) for a in args)
        self.kw = [_node_of(tr, v) for v in kwargs.values()
                   if isinstance(v, torch.Tensor)]
        self.outs = [_node_of(tr, o) for o in outs
                     if isinstance(o, torch.Tensor)]

    def inputs(self) -> List["_Node"]:
        return [a for a in self.args if isinstance(a, _Node)]

    def tensors(self, tr: "_CellTrace") -> List[torch.Tensor]:
        return [n.get(tr) for n in self.inputs() + self.kw + self.outs]


def _node_of(tr: "_CellTrace", t: torch.Tensor) -> _Node:
    nd = tr.nodes.get(t)
    if nd is None:
        nd = _Node(t, None, t in tr.params)
        nd.layout = tr.layout(t)
        tr.nodes[t] = nd
    return nd


def _finer(have: Tuple, want, shape, axes: Dict[str, int]
           ) -> Optional[Tuple]:
    """``have`` with the axes ``want`` splits a dimension over added where
    ``have`` uses them nowhere and the dimension is larger than one, or
    None when nothing is added."""
    want = tuple(want) + (None,) * (len(have) - len(tuple(want)))
    used = {a for e in have for a in _axes(e)}
    out, changed = [], False
    for n, h, w in zip(shape, have, want):
        add = [a for a in _axes(w) if a not in used and a in axes]
        if add and n > 1:
            used.update(add)
            got = _axes(h) + tuple(add)
            out.append(got[0] if len(got) == 1 else got)
            changed = True
        else:
            out.append(h)
    return tuple(out) if changed else None


def _implied(op: _Op, x: _Node, spec: Tuple) -> List[Tuple]:
    """(input node, the layout ``x``'s new layout ``spec`` implies for it)
    for each input of ``op``, the op that made ``x``, where the split maps
    back: views inverted, elementwise inputs matched from the right, a
    product's operands taking its batch and row or column splits and the
    other operand's split of the contracted dimension (slicing an operand
    whole there is free, and XLA prefers it to gathering the other)."""
    func = op.func
    ins = op.inputs()
    out_shape = x.shape
    kern = _KERNELS.get(func)
    if kern is not None:
        return list(zip(ins, kern.ins(op.outs.index(x), spec,
                                      [n.shape for n in ins])))
    if func is aten.cat.default:
        d = (op.args[1] if len(op.args) > 1 else 0) % len(out_shape)
        return [(n, spec[:d] + (None,) + spec[d + 1:]) for n in op.args[0]]
    if not ins:
        return []
    src = ins[0]
    nd_in = len(src.shape)
    if func in _MATMULS:
        a, b = ins[-2], ins[-1]
        la = a.layout or (None,) * len(a.shape)
        lb = b.layout or (None,) * len(b.shape)
        nb = len(spec) - 2
        return [(a, spec[:nb] + (spec[-2], lb[-2])),
                (b, spec[:nb] + (la[-1], spec[-1]))]
    if func is aten.t.default:
        return [(src, spec[::-1])]
    if func is aten.transpose.int:
        d0, d1 = (d % nd_in for d in op.args[1:3])
        back = list(spec)
        back[d0], back[d1] = back[d1], back[d0]
        return [(src, tuple(back))]
    if func is aten.permute.default:
        back = [None] * nd_in
        for i, d in enumerate(op.args[1]):
            back[d % nd_in] = spec[i]
        return [(src, tuple(back))]
    if func in _RESHAPES:
        back = _reshape_layout(out_shape, spec, src.shape)
        return [] if back is None else [(src, back)]
    if func.is_view or func in _SAME_LAYOUT or \
            func._overloadpacket in _SPLITS:
        if func is aten.select.int:
            d = op.args[1] % nd_in
            return [(src, spec[:d] + (None,) + spec[d:])]
        if nd_in == len(out_shape):
            return [(src, spec)]
        return [(src, _squeezed(out_shape, spec, src.shape))]
    if func._overloadpacket in _REDUCTIONS:
        return []
    got = []
    for u in ins:
        off = len(out_shape) - len(u.shape)
        if off < 0:
            continue
        got.append((u, tuple(
            spec[off + i] if n == out_shape[off + i] else None
            for i, n in enumerate(u.shape))))
    return got


def _squeezed(src, have: Tuple, dst) -> Tuple:
    """The layout of a view of shape ``dst`` that adds or drops size-1
    dimensions of one of shape ``src`` in layout ``have``."""
    kept = [e for n, e in zip(src, have) if n != 1]
    kept.reverse()
    return tuple(None if n == 1 or not kept else kept.pop()
                 for n in dst)


def _piece(src, have: Tuple, dst) -> Tuple:
    """The layout of a piece of shape ``dst`` of a tensor of shape ``src``
    in layout ``have``: a slice or a split keeps its dimensions' splits,
    an ``unbind`` drops its dimension, a broadcast adds whole ones."""
    if len(dst) == len(src):
        return tuple(have)
    if len(dst) < len(src):
        return _squeezed(src, have, dst)
    off = len(dst) - len(src)
    return (None,) * off + tuple(
        e if n == dst[off + i] else None
        for i, (n, e) in enumerate(zip(src, have)))


def _product_layout(la: Tuple, lb: Tuple, a_larger: bool
                    ) -> Tuple[Tuple, List[str]]:
    """The layout of ``a @ b`` (``[.., M, K] x [.., K, N]``) from its
    operands' and the axes its contracted dimension splits over. Where
    the two ask for one mesh axis on different dimensions the larger
    operand keeps its split and the smaller one is taken whole there
    (moving the smaller is cheaper, and XLA does that). The contracted
    dimension splits over the axes either operand splits it on and the
    output does not use: the other operand is whole there, and slicing it
    is free."""
    batch_a, batch_b = la[:-2], lb[:-2]
    used = set()

    def take(e):
        got = tuple(x for x in _axes(e) if x not in used)
        used.update(got)
        return (got if len(got) > 1 else got[0]) if got else None

    if a_larger:
        batch = tuple(take(e) for e in batch_a)
        m = take(la[-2])
        batch = tuple(e if e is not None else take(f)
                      for e, f in zip(batch, batch_b))
        n = take(lb[-1])
    else:
        batch = tuple(take(e) for e in batch_b)
        n = take(lb[-1])
        batch = tuple(e if e is not None else take(f)
                      for e, f in zip(batch, batch_a))
        m = take(la[-2])
    contracted = [x for x in _axes(la[-1]) + _axes(lb[-2])
                  if x not in used]
    return batch + (m, n), list(dict.fromkeys(contracted))


def _reduced_layout(have: Optional[Tuple], args, kwargs, out
                    ) -> Optional[Tuple]:
    """A reduction's layout: its input's, less (or, keeping dimensions,
    whole over) the dimensions it reduces."""
    if have is None or not isinstance(out, torch.Tensor):
        return None
    src = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        dims = range(src.dim())
    if isinstance(dims, int):
        dims = [dims]
    if not all(isinstance(d, int) for d in dims):
        return None
    dims = {d % src.dim() for d in dims} if src.dim() else set()
    keep = out.dim() == src.dim()
    spec = tuple(None if i in dims else e for i, e in enumerate(have)
                 if keep or i not in dims)
    return spec if len(spec) == out.dim() else None


def _reshape_layout(src: Tuple[int, ...], have: Tuple,
                    dst: Tuple[int, ...]) -> Optional[Tuple]:
    """A reshape's layout: dimensions grouped where the running products
    of ``src`` and ``dst`` meet; a group's split (every axis its source
    dimensions are split over) goes to its outermost target dimension
    larger than one.
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
        sizes = [dst[k] if k < len(dst) else 1 for k in gj]
        at = next((i for i, n in enumerate(sizes) if n > 1), 0)
        group = [None] * len(gj)
        group[at] = entry
        out.extend(group)
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
        ctx.layout = None if _ACTIVE is None else _ACTIVE.layout(x)
        with _quiet():
            return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with _quiet():
            grad = g.new_empty(ctx.shape)
        if _ACTIVE is not None and ctx.layout is not None:
            _ACTIVE.set_layout(grad, ctx.layout)
        return grad, None


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
                    tr.refine(t, spec)
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


def recount() -> Callable[[], contextlib.AbstractContextManager]:
    """For a checkpoint made here, a ``context_fn``-ready factory of the
    context its recompute counts in: the scope its forward counts in now.
    The recompute runs in the backward, outside any mapped region's or
    ``counted_at``'s Python scope, and its ops run with grad on, so they
    would otherwise count at the shard shapes outside the region."""
    tr = _ACTIVE
    if tr is None or (not tr.depth and tr.split is None):
        return contextlib.nullcontext
    split = None if tr.depth else tr.split
    return lambda: _counting(None, split)


def _run(fn: Callable[[], object], mesh: Optional[PS.AbstractMesh],
         rules, params: Sequence[Tuple[torch.Tensor, Tuple]],
         inputs: Sequence[Tuple[torch.Tensor, Tuple]], gradients: bool,
         arguments: Sequence[torch.Tensor] = ()) -> Tuple[_CellTrace, object]:
    """:func:`trace`'s run: the trace and what ``fn()`` returned."""
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
        tr.known([p for p, _ in params] + [t for t, _ in inputs]
                 + list(arguments))
        _ACTIVE = tr
        try:
            with PS.sharding_scope(mesh, rules), tr:
                result = fn()
        finally:
            _ACTIVE = None
        if gradients:
            _gradient_sync(tr, [p for p, _ in params])
    return tr, result


def _counts(tr: _CellTrace) -> Dict:
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
    return _counts(_run(fn, mesh, rules, params, inputs, gradients)[0])


def analyze_cell(lowered) -> Dict:
    """Trace ``lowered`` (a ``steps.LoweredCell``) once, as the module
    docstring defines, and return the reference's keys
    (``hlo_analysis.py:379-399``) but ``entry`` and ``n_computations``:
    ``dot_flops_per_chip``, ``mem_bytes_per_chip``,
    ``collective_wire_bytes_per_chip`` /
    ``collective_payload_bytes_per_chip`` / ``collective_op_counts`` (by
    kind), ``collective_total_per_chip`` and ``num_partitions``."""
    return analyze(lowered)[0]


def _flat(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return []


def _shard_bytes(t: torch.Tensor, sharding) -> int:
    shape = t.shape if sharding is None else sharding.shard_shape(t.shape)
    return math.prod(shape) * t.element_size()


_SCALAR_I32 = 4        # the reference's int32 step counter and ``cur``


def analyze(lowered, calls: Optional[Dict[str, int]] = None
            ) -> Tuple[Dict, Dict]:
    """:func:`analyze_cell`'s counts and the cell's memory per device,
    the reference's ``memory_analysis()`` keys (``calls``, if given, gets
    the count of each kernel's calls in the trace, by name: what its
    ``launches`` count on the card):

    - ``argument_bytes``: every argument the step reads at its sharding's
      shard shape (``NamedSharding.shard_shape``), the reference's
      ``in_shardings``: the parameters; train adds the optimizer state
      (its step counter an int32 scalar, as the reference's) and the
      batch, prefill the batch, decode the token, the cache and ``cur``
      (an int32 scalar, read where attention layers are). XLA drops an
      argument its step never reads, so the trace leaves out the tensors
      no op read (a decode step's encoder weights);
    - ``alias_bytes``: the donated arguments the step updates in place:
      the parameters and the optimizer state (train), the cache (decode);
    - ``output_bytes``: what the reference's step returns, at the layouts
      the trace records (none: whole): train the new parameters, the
      optimizer state and the metrics; prefill and decode the logits and
      the cache;
    - ``temp_bytes``: the peak over the trace of the bytes a device holds
      of the storages the step allocates (:meth:`_CellTrace.allocated`).
    """
    model, args = lowered.instantiate()
    shard = lowered.param_shardings
    named = list(model.named_parameters())
    kind = lowered.kind
    inputs = [(t, sh.spec) for t, sh in lowered.input_layouts()
              if sh is not None]
    if kind == "train" and lowered.mesh is not None:
        opt, osh = args[0], lowered.opt_shardings
        inputs += [(t, getattr(osh, f)[n].spec) for f in ("master", "m", "v")
                   for n, t in getattr(opt, f).items()]
    tr, result = _run(lambda: lowered.step(model, *args), lowered.mesh,
                      lowered.rules,
                      [(p, () if shard[n] is None else shard[n].spec)
                       for n, p in named],
                      inputs, kind == "train", _flat(args))
    def used(t, sharding) -> int:
        return 0 if id(t) in tr.unread else _shard_bytes(t, sharding)

    params = sum(used(p, shard[n]) for n, p in named)
    if kind == "train":
        opt, batch = args
        osh = lowered.opt_shardings
        opt_bytes = _SCALAR_I32 + sum(
            used(t, getattr(osh, f)[n])
            for f in ("master", "m", "v")
            for n, t in getattr(opt, f).items())
        inputs = sum(used(t, lowered.batch_shardings[k])
                     for k, t in batch.items())
        arguments, alias = params + opt_bytes + inputs, params + opt_bytes
        outputs = alias + sum(tr.held(t, None) for t in _flat(result))
    elif kind == "prefill":
        arguments = params + sum(
            used(t, lowered.batch_shardings[k]) for k, t in args[0].items())
        alias, outputs = 0, sum(tr.held(t, None) for t in _flat(result))
    else:
        token, cache, _ = args
        cache_bytes = sum(used(c[k], sh[k]) for c, sh in zip(
            cache, lowered.batch_shardings["cache"]) for k in c)
        # ``cur`` positions attention's keys; a model without attention
        # layers never reads it
        cur = _SCALAR_I32 if any("k" in c for c in cache) else 0
        arguments = (params + cache_bytes + cur
                     + used(token, lowered.batch_shardings["token"]))
        alias = cache_bytes
        outputs = sum(tr.held(t, None) for t in _flat(result))
    if calls is not None:
        calls.update(tr.acc.kernels)
    memory = {"argument_bytes": int(arguments),
              "output_bytes": int(round(outputs)),
              "temp_bytes": int(round(tr.peak)),
              "alias_bytes": int(alias)}
    return _counts(tr), memory


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
