"""Durable control plane: versioned fleet checkpoints with exact restore.

A carbon-aware scheduler only saves carbon if it survives the horizons it
plans over — time-shifting a transfer into a greener window three days out
is worthless if a process crash forfeits the deferred work. This module
extends the ``FrozenField`` snapshot idea to the *whole* control plane: a
:class:`FleetCheckpoint` captures everything a run is (pending events,
in-flight :class:`TransferState`\\ s, the ledger, the throughput model's
learned corrections, the deferred-backfill queue, the hashed noise/band
anchors) such that a run **checkpointed, killed, and restored resumes
bit-identical** to the run that was never interrupted.

Why this is exact rather than approximate:

* **one pickle per shard** — a shard checkpoint is a single
  ``pickle.dumps`` of its :class:`FleetController`, so shared identity
  inside the controller graph (queue handles aliasing heap entries, the
  one :class:`ThroughputModel` read by planner and engine, the field read
  by everything) survives via the pickle memo instead of being manually
  reassembled.
* **closures are replayed, not serialized** — the only unpicklable state
  is derived: per-route device-power closures (rebuilt bit-identically
  from each record's ``route_log`` because ``_route_power`` is a pure
  function of route + field) and pure caches (dropped; they regenerate to
  the same floats because all noise is blake2b hashing, not RNG state).
* **the device is a name** — a planner pickles its device as a string
  and holds no device tensors, so :func:`restore` places every planner
  on the ``device`` it is given: a checkpoint taken on the card restores
  on the CPU, and the other way round.
* **callers re-wire, state travels** — completion hooks and the
  planner's drift hook are wiring, restored by ``__setstate__``/
  the gateway constructor; everything with run semantics is data.

``capture`` / ``restore`` understand three shapes: a bare
:class:`FleetController`, a :class:`ShardedFleet` (sequential or
process-parallel — parallel shards checkpoint through the worker protocol
and restore by preloading blobs into fresh workers; a checkpoint taken in
one ``parallel`` mode may be restored in another, including ``"off"``),
and optionally a :class:`StreamingGateway` riding on either (its
admission state — inflight set, deferred queue, consumed-arrival count —
is a plain dict in the checkpoint; ``restore_gateway`` rebuilds the
gateway and :meth:`StreamingGateway.resume` re-feeds the same arrival
stream, skipping what was already consumed).

A copy of the reference's ``core/controlplane/persistence.py``;
``tests/test_torch_persistence.py`` pins crash-kill-resume replay
equivalence: runs cut at several points (including an actual ``os._exit``
process kill) restore to a ``FleetReport`` that matches the uninterrupted
oracle, and the reference's, in every total, counter and outcome row.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

from repro_torch._device import resolve_device
from repro_torch.core.carbon.field import FrozenField
from repro_torch.core.controlplane.controller import FleetController

#: bump when the checkpoint layout changes incompatibly; ``restore``
#: refuses mismatched versions instead of resuming a silently-wrong run.
CHECKPOINT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShardState:
    """One shard's full state: a single pickle of its controller (see the
    module docstring for why one blob, not fields)."""
    blob: bytes

    def thaw(self) -> FleetController:
        return pickle.loads(self.blob)


@dataclasses.dataclass(frozen=True)
class FleetCheckpoint:
    """A versioned, picklable snapshot of a whole fleet run.

    ``kind`` — ``"controller"`` (one bare controller) or ``"sharded"``.
    ``shards`` — per-shard controller blobs, in shard order.
    ``config`` — what rebuilds the fleet *object* around the shards
    (ftns, partition, backends, parallel mode, controller kwargs).
    ``frozen`` — the warmed carbon-field snapshot (warm restore: no
    re-hashing).
    ``shocks`` — the fleet-level announced-shock schedule (admission
    pricing state; the per-controller shock state travels in the blobs).
    ``gateway`` — optional streaming-gateway admission state.
    ``sim_now`` — max controller clock at capture (informational)."""
    version: int
    kind: str
    shards: Tuple[ShardState, ...]
    config: Dict[str, Any]
    frozen: Optional[FrozenField]
    shocks: Tuple[tuple, ...]
    gateway: Optional[Dict[str, Any]]
    sim_now: float


def _require_version(ckpt: FleetCheckpoint) -> None:
    if ckpt.version != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {ckpt.version} != supported "
            f"{CHECKPOINT_VERSION} — refusing to resume a run whose "
            f"layout this code no longer understands")


# --- capture -----------------------------------------------------------------
def capture(fleet, *, gateway=None) -> FleetCheckpoint:
    """Snapshot ``fleet`` (a :class:`FleetController` or a
    :class:`ShardedFleet`) — and, if given, the :class:`StreamingGateway`
    driving it — into a :class:`FleetCheckpoint`.

    Call between pump quanta (never mid-``pump``): the barrier is what
    makes the coordinator-side view and the shard state coherent. For a
    parallel fleet each worker pickles its own controller and ships the
    blob back; for sequential fleets the controllers pickle in-process."""
    from repro_torch.core.controlplane.sharded import ShardedFleet

    if isinstance(fleet, FleetController):
        shards = (ShardState(
            blob=pickle.dumps(fleet, protocol=pickle.HIGHEST_PROTOCOL)),)
        return FleetCheckpoint(
            version=CHECKPOINT_VERSION, kind="controller", shards=shards,
            config={}, frozen=None, shocks=(),
            gateway=_gateway_state(gateway),
            sim_now=fleet.events.now)
    if not isinstance(fleet, ShardedFleet):
        raise TypeError(f"cannot checkpoint {type(fleet).__name__}; "
                        f"expected FleetController or ShardedFleet")
    if fleet._runner is not None:
        blobs = fleet._runner.checkpoint_all()
    else:
        blobs = [pickle.dumps(ctl, protocol=pickle.HIGHEST_PROTOCOL)
                 for ctl in fleet.controllers]
    config = dict(
        ftns=tuple(fleet.ftns),
        n_shards=fleet.n_shards,
        partition=fleet.partition,
        batch_backend=fleet.planner.batch_backend,
        shard_backend=fleet.shard_backend,
        parallel=fleet.parallel,
        supervision=fleet.supervision,
        controller_kw=dict(fleet._controller_kw),
    )
    if getattr(fleet, "obs", None) is not None:
        # coordinator observer (admission/gateway spans, fleet metrics):
        # snapshotted as its own blob so the live fleet's post-capture
        # spans never leak into the checkpoint. Shard observers ride the
        # controller blobs untouched. Read back with .get() — old
        # checkpoints simply restore with a fresh coordinator observer.
        config["coordinator_obs"] = pickle.dumps(
            fleet.obs, protocol=pickle.HIGHEST_PROTOCOL)
    return FleetCheckpoint(
        version=CHECKPOINT_VERSION, kind="sharded",
        shards=tuple(ShardState(blob=b) for b in blobs),
        config=config, frozen=fleet.field.freeze(),
        shocks=tuple(fleet._shocks),
        gateway=_gateway_state(gateway),
        sim_now=max((ctl.events.now for ctl in fleet.controllers),
                    default=0.0))


_GW_CONFIG = ("window_s", "max_batch", "max_inflight", "backfill",
              "urgency_margin", "backfill_lookahead", "pipeline", "quanta",
              "frontends", "checkpoint_every_s")
_GW_RUNTIME = ("_seq", "_latency", "_arrival_t", "_batch_sizes",
               "n_promotions", "n_backfill_promotions",
               "n_urgent_promotions", "_n_deferred_total", "_consumed",
               "_prev_t", "_next_ckpt_t",
               # pipelined-admission wall occupancy: restored so a
               # resumed run's stats() keep counting from the cut
               "plan_wall_s", "stall_wall_s", "n_pipelined_batches")


def _gateway_state(gw) -> Optional[Dict[str, Any]]:
    if gw is None:
        return None
    state = {
        "config": {k: getattr(gw, k) for k in _GW_CONFIG},
        "inflight": tuple(gw._inflight),
        "deferred": tuple((d.job, d.seq) for d in gw._deferred),
    }
    state.update({k: getattr(gw, k) for k in _GW_RUNTIME})
    return state


# --- restore -----------------------------------------------------------------
def _placed(ctl: FleetController, device) -> FleetController:
    ctl.planner.device = device
    return ctl


def restore(ckpt: FleetCheckpoint, *, parallel: Optional[str] = None,
            device=None):
    """Rebuild the fleet a checkpoint describes, resumed exactly where it
    was cut. Returns a :class:`FleetController` or :class:`ShardedFleet`
    matching ``ckpt.kind``.

    ``parallel`` overrides the captured execution mode — blobs are full
    controllers, so a checkpoint taken under ``parallel="fork"`` restores
    fine under ``"off"`` and vice versa (cross-mode restore is how a
    parallel run is audited against the sequential oracle). ``device``
    places every planner of the restored fleet (``cuda`` unless given;
    without a GPU pass ``"cpu"``, or restore raises), whatever device the
    checkpoint was taken on."""
    _require_version(ckpt)
    device = resolve_device(device)
    if ckpt.kind == "controller":
        return _placed(ckpt.shards[0].thaw(), device)
    if ckpt.kind != "sharded":
        raise ValueError(f"unknown checkpoint kind {ckpt.kind!r}")
    from repro_torch.core.controlplane.sharded import ShardedFleet

    cfg = ckpt.config
    mode = cfg["parallel"] if parallel is None else parallel
    field = ckpt.frozen.thaw() if ckpt.frozen is not None else None
    fleet = ShardedFleet(
        list(cfg["ftns"]), n_shards=cfg["n_shards"], field=field,
        partition=cfg["partition"], batch_backend=cfg["batch_backend"],
        parallel=mode,
        shard_backend=cfg["shard_backend"],
        supervision=cfg.get("supervision"), device=device,
        **cfg["controller_kw"])
    fleet._shocks = list(ckpt.shocks)
    obs_blob = cfg.get("coordinator_obs")
    if obs_blob is not None:
        fleet.obs = pickle.loads(obs_blob)
        # rebind the fleet planner's instrumentation to the restored
        # registry (the constructor wired it to the fresh one)
        fleet.planner.observe_with(fleet.obs)
    blobs = [s.blob for s in ckpt.shards]
    if fleet._runner is not None:
        fleet._runner.preload(blobs)
    else:
        fleet.controllers = [_placed(pickle.loads(b), device)
                             for b in blobs]
    return fleet


def restore_gateway(ckpt: FleetCheckpoint, *,
                    parallel: Optional[str] = None,
                    checkpoint_fn=None, device=None):
    """Rebuild a checkpointed streaming run: the fleet via
    :func:`restore`, then a :class:`StreamingGateway` re-wired onto it
    (completion hooks re-register on the fresh controllers) with its
    admission state — inflight set, deferred queue, latency/batch stats,
    consumed-arrival count — overwritten from the checkpoint. Continue
    with ``gateway.resume(stream, until)`` feeding the SAME arrival
    stream the interrupted run consumed. ``device`` places the restored
    fleet's planners and the gateway's batch planner, as in
    :func:`restore`. Returns the gateway; the fleet is
    ``gateway.fleet``."""
    _require_version(ckpt)
    if ckpt.gateway is None:
        raise ValueError("checkpoint carries no gateway state — it was "
                         "captured without gateway=; use restore()")
    from repro_torch.core.controlplane.streaming import (StreamingGateway,
                                                         _Deferred)

    fleet = restore(ckpt, parallel=parallel, device=device)
    state = ckpt.gateway
    gw = StreamingGateway(fleet, checkpoint_fn=checkpoint_fn,
                          device=device, **state["config"])
    gw._inflight = set(state["inflight"])
    gw._deferred = [_Deferred(job=job, seq=seq)
                    for job, seq in state["deferred"]]
    for k in _GW_RUNTIME:
        # a checkpoint from before a runtime field existed restores
        # with the constructor's default for it
        if k in state:
            setattr(gw, k, state[k])
    # containers restored by reference from the unpickled state — rebind
    # as fresh mutables so a second restore from the same ckpt is clean
    gw._latency = list(gw._latency)
    gw._arrival_t = dict(gw._arrival_t)
    gw._batch_sizes = list(gw._batch_sizes)
    return gw


# --- disk round-trip ---------------------------------------------------------
def save(ckpt: FleetCheckpoint, path) -> None:
    """Write a checkpoint to ``path`` (atomic enough for the single-writer
    case: temp file + rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(ckpt, f)
    os.replace(tmp, path)


def load(path) -> FleetCheckpoint:
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    if not isinstance(ckpt, FleetCheckpoint):
        raise TypeError(f"{path} does not hold a FleetCheckpoint "
                        f"(got {type(ckpt).__name__})")
    _require_version(ckpt)
    return ckpt
