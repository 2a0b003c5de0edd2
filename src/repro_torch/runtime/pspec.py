"""Logical-axis sharding rules and the host mesh they resolve against.

The reference's ``runtime/pspec.py``: model code names axes logically
('batch', 'heads', 'expert', ...) and a run-scoped rule table maps them to
physical mesh axes. Outside a mesh scope every lookup gives one device, so
model code never needs to know whether it is split.

The port's mesh is :class:`HostMesh`: one process's grid of torch devices
(repeats allowed), the counterpart of a ``jax.sharding.Mesh`` run SPMD in
one process. Code that splits over it loops over the mesh positions itself,
in rank order; there is no process group. :func:`abstract_mesh` gives a
shape-only mesh for resolving specs without devices.

Placements are kept as a description. A :class:`HostMesh` in one process
repeats its devices, so it places no tensor, and the reference's
``with_sharding_constraint`` never changes a value: :func:`named_sharding`
gives a :class:`NamedSharding` record (mesh and resolved spec, with the
shard shape it implies) and :func:`logical_constraint` resolves its spec
against the tensor and returns the tensor itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Logical = Union[str, None, Tuple[str, ...]]
Entry = Union[str, None, Tuple[str, ...]]

# physical axes referenced by rules must exist in the active mesh; entries
# whose physical axes are absent degrade to None (replicated).
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",        # sequence-parallel KV for batch=1 long decode
    "embed": None,
    "fsdp": "data",             # parameter fully-sharded axis
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "capacity": "data",
    "ssm_inner": "model",
    "seq_model": "model",       # fallback: shard cache seq over 'model' when
                                # kv_heads doesn't divide the model axis
    "pod": "pod",
}

FSDP_RULES = dict(DEFAULT_RULES, heads=None, kv_heads=None, ffn=None,
                  vocab=None, ssm_inner=None, expert="model")
DP_RULES = {k: None for k in DEFAULT_RULES} | {"batch": ("pod", "data", "model")}

RULE_SETS = {"2d": DEFAULT_RULES, "fsdp": FSDP_RULES, "dp": DP_RULES}


def seq_attn_rules(base) -> Dict:
    """Context-parallel attention layout: attention weights replicate over
    'model' (q/k/v/o projections become pure-FSDP), and self-attention
    splits the query sequence over 'model'
    (``models.layers.seq_parallel_attention``, taken wherever
    ``models.layers.use_seq_parallel`` holds)."""
    if isinstance(base, str):
        base = RULE_SETS[base]
    return dict(base, heads=None, kv_heads=None)


class AbstractMesh:
    """A mesh's axis names and sizes, no devices: resolves specs only."""

    def __init__(self, axis_sizes: Sequence[int],
                 axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} axis sizes for "
                             f"{len(axis_names)} axis names")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {tuple(axis_names)}")
        if any(int(n) < 1 for n in axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {tuple(axis_sizes)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in
                                      zip(axis_names, axis_sizes)}


class HostMesh(AbstractMesh):
    """A grid of torch devices in one process, with named axes: the
    counterpart of ``jax.sharding.Mesh``. ``devices`` is an object array
    of ``torch.device`` of the mesh's shape; a device may repeat (several
    positions on one card, or the CPU standing in for several devices)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devs[idx] = torch.device(given[idx])
        super().__init__(devs.shape, axis_names)
        self.devices = devs

    def __repr__(self) -> str:
        return (f"HostMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def abstract_mesh(axis_sizes: Tuple[int, ...],
                  axis_names: Tuple[str, ...]) -> AbstractMesh:
    """A shape-only mesh (the reference's ``abstract_mesh``)."""
    return AbstractMesh(axis_sizes, axis_names)


class _Scope(threading.local):
    def __init__(self):
        self.mesh: Optional[AbstractMesh] = None
        self.rules: Dict[str, Union[str, Tuple[str, ...], None]] = \
            DEFAULT_RULES


_SCOPE = _Scope()


@contextlib.contextmanager
def sharding_scope(mesh: Optional[AbstractMesh],
                   rules: Union[str, Dict, None] = None):
    """Activate a mesh (a :class:`HostMesh`, a shape-only mesh or None)
    and a logical rule table (a name of ``RULE_SETS`` or a dict) for model
    code, in this thread."""
    prev = (_SCOPE.mesh, _SCOPE.rules)
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    _SCOPE.mesh = mesh
    _SCOPE.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _SCOPE.mesh, _SCOPE.rules = prev


def active_mesh() -> Optional[AbstractMesh]:
    return _SCOPE.mesh


def current_scope() -> Tuple[Optional[AbstractMesh], Dict]:
    """This thread's (mesh, rules), for work that runs on another thread
    to re-enter with ``sharding_scope(*scope)`` (a checkpoint's recompute
    runs on autograd's device thread)."""
    return _SCOPE.mesh, dict(_SCOPE.rules)


def axis_size(physical: Union[str, Tuple[str, ...], None]) -> int:
    """Product of mesh sizes of the given physical axes (1 if absent)."""
    mesh = _SCOPE.mesh
    if mesh is None or physical is None:
        return 1
    if isinstance(physical, str):
        physical = (physical,)
    n = 1
    for a in physical:
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def logical_axis_size(name: str) -> int:
    return axis_size(_SCOPE.rules.get(name))


def resolve(logical: Sequence[Logical],
            shape: Optional[Sequence[int]] = None) -> Tuple[Entry, ...]:
    """Map logical axis names to the reference's ``PartitionSpec`` entries
    under the active rules and mesh: per dimension None, one physical axis
    name, or a tuple of them.

    When ``shape`` is given, any mesh axis that does not evenly divide its
    dimension is dropped (uneven dims degrade to replication on that
    axis). No physical axis is used twice."""
    mesh = _SCOPE.mesh
    axes_avail = set(mesh.axis_names) if mesh is not None else set()
    mesh_shape = dict(mesh.shape) if mesh is not None else {}
    out = []
    used = set()

    def phys(name, dim, cur):
        if name is None:
            return (), cur
        mapped = _SCOPE.rules.get(name, None)
        if mapped is None:
            return (), cur
        if isinstance(mapped, str):
            mapped = (mapped,)
        got = []
        for a in mapped:
            if a not in axes_avail or a in used:
                continue
            if dim is not None and dim % (cur * mesh_shape[a]) != 0:
                continue
            got.append(a)
            cur *= mesh_shape[a]
            used.add(a)
        return tuple(got), cur

    for i, item in enumerate(logical):
        dim = shape[i] if shape is not None else None
        subs = item if isinstance(item, tuple) else (item,)
        parts = []
        cur = 1
        for sub in subs:
            got, cur = phys(sub, dim, cur)
            parts.extend(got)
        if not parts:
            out.append(None)
        elif len(parts) == 1:
            out.append(parts[0])
        else:
            out.append(tuple(parts))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (one entry per dimension: None, a mesh
    axis name, or a tuple of them): the counterpart of
    ``jax.sharding.NamedSharding``, as a description only."""
    mesh: AbstractMesh
    spec: Tuple[Entry, ...]

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Each dimension divided by the product of the mesh axes its spec
        entry names (dimensions past the spec are whole); a dimension they
        do not divide raises, as ``jax.sharding.NamedSharding.shard_shape``
        does."""
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape "
                             f"{tuple(global_shape)} has dimensions")
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n = 1
            for a in axes:
                n *= self.mesh.shape[a]
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} "
                                 f"does not split over {axes} ({n})")
            out.append(dim // n)
        return tuple(out)


def named_sharding(logical: Sequence[Logical],
                   shape: Optional[Sequence[int]] = None
                   ) -> Optional[NamedSharding]:
    """The active mesh and ``resolve(logical, shape)``; None outside a
    mesh, as in the reference."""
    mesh = _SCOPE.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve(logical, shape=shape))


def logical_constraint(x: torch.Tensor,
                       logical: Sequence[Logical]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: under
    a mesh the spec is resolved against ``x.shape`` (the same rules run);
    ``x`` itself is returned, inside a mesh and outside one. The value is
    unchanged, which is the reference's contract, and nothing is moved:
    one process's mesh places no tensor. Under a shape-only mesh a cell's
    cost trace (``runtime.cost_analysis``) counts the resharding."""
    mesh = _SCOPE.mesh
    if mesh is not None:
        spec = resolve(logical, shape=x.shape)
        if not isinstance(mesh, HostMesh):
            from repro_torch.runtime import cost_analysis
            cost_analysis.constrain(x, spec)
    return x
