"""Process-parallel shard execution: one worker process per shard.

``ShardedFleet`` drains its shards sequentially in-process — deterministic,
but the drain is host work (the event loop, engine steps and re-plan
sweeps in Python), one shard after another. Shards are *fully independent*
controllers, which makes them exactly the unit a worker process should
own: :class:`ParallelShardRunner` starts one persistent worker per shard,
rebuilds that shard's :class:`FleetController` inside it, and drives it
over a pipelined pipe protocol. The coordinator keeps the fleet-level
batched admission (one ``plan_batch`` sweep through the CUDA planner
kernels) and ships each shard its (job, plan) stream; workers run the
event loops concurrently and ship :class:`FleetReport`\\ s back, merged by
the exact-sum ``FleetReport.merged`` contract — totals bit-identical to
the sequential run of the same seeds on the same shard planner backend.

A copy of the reference's ``core/controlplane/parallel.py``: a worker
rebuilds its shard planner as a :class:`TorchCarbonPlanner` on the
device its :class:`ShardSpec` names.

Design contracts:

* **frozen field, not shared field** — every worker thaws the same
  :class:`~repro_torch.core.carbon.field.FrozenField` snapshot
  (``CarbonField.freeze()``), taken from the coordinator's warmed field at
  worker start. All noise is hashed once in the coordinator; workers never
  re-hash, and every CI query is bit-identical across processes because
  the traces are deterministic functions of the snapshot.
* **fork workers stay off CUDA** — a CUDA context does not survive
  ``os.fork()`` (a forked child that touches ``torch.cuda`` fails with
  "Cannot re-initialize CUDA in forked subprocess"), so fork-mode workers
  run their shard planners on the pinned *numpy oracle* backend on the
  CPU, and ``ShardedFleet`` refuses a fork fleet whose shards would need
  the card. The expensive fleet-wide admission sweep already runs in the
  coordinator, where CUDA is safe; in-run re-plan sweeps are small.
  Spawn-mode workers own a fresh interpreter and CUDA context and may use
  any backend: each loads the kernel library the coordinator built.
* **per-quantum barrier** — :meth:`ParallelShardRunner.pump_all` sends one
  bounded ``pump(until, strict, horizon)`` to every worker, then drains
  replies in shard order: a barrier per time quantum. The
  ``StreamingGateway`` watermark pump uses it verbatim, so online
  admission drives all workers concurrently while each shard's monotone
  clock (and the watermark rule built on it) is untouched — the quantum
  boundary *is* the watermark.
* **completions cross the boundary as data** — workers buffer
  ``JobComplete`` notifications and ship them with each reply; the
  coordinator-side :class:`ShardProxy` re-fires them through its own
  ``completion_hooks`` in shard-major order (the same order the
  sequential run fires them). Capacity/backfill gateways therefore
  work unchanged, with promotions landing at quantum granularity.

Durability contracts (the supervision layer):

* **every replayable command is journaled** — the coordinator keeps, per
  shard, the (cmd, args) list sent since that shard's last checkpoint.
  Because shard controllers are deterministic functions of their command
  stream over a frozen field, *checkpoint + journal replay* reconstructs
  a worker bit-identically — the same replay-equivalence contract
  ``core.controlplane.persistence`` property-tests for whole fleets.
* **failures are detected at the wire** — a dead worker surfaces as
  :class:`WorkerDied` (pipe EOF / liveness heartbeat), a hung one as
  :class:`WorkerTimeout` (command deadline with exponential poll
  backoff), a worker-reported exception as :class:`WorkerFailure` with
  the full remote traceback. All are ``RuntimeError`` subclasses.
* **the degradation ladder** — recovery respawns the worker from the
  last per-shard checkpoint and replays the journal delta, at most
  ``SupervisionPolicy.max_respawns`` times (on a CPU shard,
  worker-reported errors first downgrade the shard's batch backend to the
  numpy oracle; a shard on the card keeps its backend, so a failing
  kernel is never planned around). A shard that exhausts the ladder falls
  back to an *in-process* ``_ShardServer`` on its spec as it stands —
  ``parallel`` is effectively ``"off"`` for that shard, but the run
  completes; if that fails too, the first failure raises. Every rung is
  surfaced on ``FleetReport.degradations``.
* **faults are injectable** — a seeded :class:`FaultPlan` drives
  ``cluster/faults.py``-style worker-kill / pipe-blip / hang / backend
  faults through the same machinery at barrier quanta.

The sequential runner stays the pinned oracle: ``ShardedFleet`` defaults
to ``parallel="off"``, and ``tests/test_torch_parallel.py`` pins the
parallel merge bit-identical to it and to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import os
import pickle
import signal
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch._device import resolve_device
from repro_torch.core.carbon.field import (FrozenField,
                                           install_frozen_default)
from repro_torch.core.controlplane.controller import FleetReport

#: shard-planner backend forced on fork workers (see module docstring).
FORK_SAFE_BACKEND = "numpy"

#: commands the supervisor journals for replay — deterministic state
#: mutations. Lifecycle ("stop"), introspection ("state" sync barriers are
#: re-derived), checkpoint/restore and fault injection are excluded: a
#: replayed "_fault" would re-kill the respawned worker, and a replayed
#: "checkpoint" would clobber the recovery baseline.
_REPLAYABLE = frozenset({"submit", "submit_many", "shock", "pump", "run"})


class WorkerFailure(RuntimeError):
    """A shard worker reported an exception (remote traceback attached)."""


class WorkerDied(WorkerFailure):
    """A shard worker process exited or its pipe broke mid-conversation."""


class WorkerTimeout(WorkerFailure):
    """A shard worker is alive but unresponsive past the command
    deadline."""


def resolve_mode(parallel: str) -> str:
    """Map a ``parallel=`` knob value to a start method: ``"auto"`` picks
    fork where the platform offers it (cheapest start, copy-on-write
    snapshot sharing), spawn otherwise."""
    if parallel == "auto":
        return "fork" if "fork" in mp.get_all_start_methods() else "spawn"
    return parallel


def _cgroup_cpu_quota(cgroup_root: str = "/sys/fs/cgroup",
                      proc_self_cgroup: str = "/proc/self/cgroup"
                      ) -> Optional[Tuple[int, str]]:
    """Tightest cgroup v2 ``cpu.max`` quota binding this process, as
    ``(ceil(quota/period), cgroup path)``; ``None`` when no quota
    applies anywhere on the chain (or the files are absent — cgroup v1
    hosts, non-Linux).

    Reading only the cgroup-root ``cpu.max`` is not enough: a process in
    a nested cgroup — a systemd slice (most non-containerized CI
    runners), or a cgroup-namespaced container whose own subtree is
    mounted below the root — usually sees ``max`` at the root while its
    *own* cgroup (or an ancestor) carries the throttle. So resolve the
    process's cgroup from ``/proc/self/cgroup`` (the ``0::<path>`` v2
    entry) and read ``cpu.max`` there and at every ancestor up to the
    root, keeping the smallest ceiling — quotas only ever tighten going
    down the tree, but reading the whole chain is cheap and robust to a
    looser leaf under a tighter slice. The path parameters exist for
    tests."""
    node = ""
    try:
        with open(proc_self_cgroup) as f:
            for line in f:
                parts = line.strip().split(":", 2)
                if len(parts) == 3 and parts[0] == "0" and parts[1] == "":
                    node = parts[2].strip("/")
                    break
    except OSError:
        pass
    best: Optional[Tuple[int, str]] = None
    while True:
        sub = f"/{node}" if node else ""
        try:
            with open(f"{cgroup_root}{sub}/cpu.max") as f:
                parts = f.read().split()
            if parts and parts[0] != "max":
                q = max(int(math.ceil(int(parts[0]) / int(parts[1]))), 1)
                if best is None or q < best[0]:
                    best = (q, sub or "/")
        except (OSError, ValueError, IndexError, ZeroDivisionError):
            pass
        if not node:
            return best
        node = node.rpartition("/")[0]


def effective_cpu_count() -> Tuple[int, str]:
    """CPUs this process can *actually* run on, with a provenance note.

    ``os.cpu_count()`` reports the host's cores, which lies in two
    common deployment shapes: a CPU-affinity mask pins the process to a
    subset, and a cgroup v2 ``cpu.max`` quota (the standard container CPU
    limit) throttles it regardless of how many cores are visible — on
    the process's own cgroup or any ancestor, not just the root (see
    :func:`_cgroup_cpu_quota`). Returns
    min(visible, affinity, ceil(quota/period)) and a note saying which
    bound it is, so a measurement of worker parallelism can record how
    many CPUs its workers really had.
    """
    try:
        visible = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):   # pragma: no cover - non-Linux
        visible = os.cpu_count() or 1
    eff = max(visible, 1)
    note = f"{eff} schedulable"
    quota = _cgroup_cpu_quota()
    if quota is not None:
        q, path = quota
        note += f", cgroup cpu.max {q} at {path}"
        eff = min(eff, q)
    else:
        note += ", no cgroup quota"
    return eff, f"{eff} effective cpus ({note})"


@dataclasses.dataclass(frozen=True)
class SupervisionPolicy:
    """How hard the runner fights for a broken shard.

    ``command_timeout_s`` — how long :meth:`_WorkerHandle.drain` waits for
    one reply before declaring the worker hung (None: wait forever —
    death is still detected immediately via the liveness heartbeat, only
    *hangs* need a deadline). ``max_respawns`` — respawn-and-replay
    attempts before the in-process fallback (0 falls back immediately).
    ``checkpoint_every`` — auto-checkpoint every N barrier quanta
    (0 disables: recovery then replays the journal from construction,
    still exact, just longer). ``backoff_s`` — base of the exponential
    respawn backoff."""
    command_timeout_s: Optional[float] = None
    max_respawns: int = 2
    checkpoint_every: int = 0
    backoff_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One injected fault: at barrier ``quantum``, hit ``shard`` with
    ``kind`` — ``"kill"`` (SIGKILL the worker), ``"pipe"`` (blip: close
    the coordinator's pipe end), ``"hang"`` (worker sleeps
    ``severity_s`` — needs ``command_timeout_s`` set to be detected), or
    ``"backend"`` (worker raises, exercising the numpy-downgrade rung)."""
    quantum: int
    shard: int
    kind: str
    severity_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic fault schedule (``cluster/faults.py``
    style: blake2b draws, no RNG state), applied by the runner at each
    barrier before the quantum's commands go out. Faults target worker
    processes; a shard already degraded to the in-process fallback is
    skipped."""
    actions: Tuple[FaultAction, ...]
    seed: int = 0

    @classmethod
    def seeded(cls, n_shards: int, *, seed: int = 0, horizon: int = 8,
               kills: int = 2, backend_faults: int = 1, hangs: int = 0,
               pipe_blips: int = 0, hang_s: float = 2.0) -> "FaultPlan":
        """The requested number of each fault kind placed at
        blake2b-drawn (quantum, shard) slots inside ``horizon`` barriers
        — same schedule for a given seed, forever."""
        from repro_torch.cluster.faults import _u
        actions: List[FaultAction] = []
        for kind, n, sev in (("kill", kills, 0.0),
                             ("backend", backend_faults, 0.0),
                             ("hang", hangs, hang_s),
                             ("pipe", pipe_blips, 0.0)):
            for i in range(n):
                q = int(_u(f"{seed}:{kind}:{i}:q") * max(horizon, 1))
                s = int(_u(f"{seed}:{kind}:{i}:s") * max(n_shards, 1))
                actions.append(FaultAction(quantum=q, shard=s, kind=kind,
                                           severity_s=sev))
        actions.sort(key=lambda a: (a.quantum, a.shard, a.kind))
        return cls(actions=tuple(actions), seed=seed)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Everything a worker needs to rebuild one shard controller. Must be
    picklable (spawn ships it; fork inherits it copy-on-write).
    ``device`` names the shard planner's device (``"cpu"`` for a fork
    worker, which must never touch CUDA)."""
    ftns: Tuple
    controller_kw: Tuple[Tuple[str, Any], ...]
    batch_backend: str
    frozen: Optional[FrozenField]
    device: str = "cpu"


class _ShardServer:
    """The shard command interpreter — the one implementation both a
    worker process (:func:`_worker_main`) and the in-process degradation
    fallback run, so a shard behaves identically wherever it executes.
    Holds the controller, buffers completion notifications, and maps the
    wire commands onto it."""

    def __init__(self, spec: ShardSpec, field=None):
        from repro_torch.core.controlplane.controller import FleetController
        from repro_torch.core.scheduler.planner import TorchCarbonPlanner
        if field is None:
            if spec.frozen is not None:
                field = spec.frozen.thaw()
            else:
                from repro_torch.core.carbon.field import default_field
                field = default_field()
        ftns = list(spec.ftns)
        self.device = spec.device
        planner = TorchCarbonPlanner(ftns, field=field,
                                     batch_backend=spec.batch_backend,
                                     device=spec.device)
        self.ctl = FleetController(ftns, field=field, planner=planner,
                                   **dict(spec.controller_kw))
        self.completions: List[Tuple[float, str]] = []
        self._hook()

    def _hook(self) -> None:
        self.ctl.completion_hooks.append(
            lambda t, job: self.completions.append((t, job.uuid)))

    def apply(self, cmd: str, args: Any) -> Tuple[Any, bool]:
        """Execute one command; returns ``(extra, keep_serving)``.
        Raises on error — the caller decides whether that crosses a pipe
        as an ``("err", traceback)`` reply or propagates in-process."""
        ctl = self.ctl
        extra: Any = None
        if cmd == "submit":
            job, plan, at = args
            ctl.submit(job, plan=plan, at=at)
        elif cmd == "submit_many":
            for job, plan, at in args:
                ctl.submit(job, plan=plan, at=at)
        elif cmd == "shock":
            t, factor, duration_s, zones = args
            ctl.inject_shock(t, factor, duration_s=duration_s, zones=zones)
        elif cmd == "pump":
            until, strict, horizon = args
            extra = ctl.pump(until, strict=strict, horizon=horizon)
        elif cmd == "run":
            extra = ctl.run(args)
        elif cmd == "checkpoint":
            # one dump of the whole controller graph — shared identity
            # (queue handles aliasing heap entries, the one throughput
            # model) survives via the pickle memo; highest protocol keeps
            # the per-quantum checkpoint cost down
            extra = pickle.dumps(self.ctl,
                                 protocol=pickle.HIGHEST_PROTOCOL)
        elif cmd == "restore":
            self.ctl = pickle.loads(args)
            # a checkpoint names the device it was taken on; the shard
            # plans where its spec says
            self.ctl.planner.device = resolve_device(self.device)
            self.completions.clear()
            self._hook()
        elif cmd == "_fault":
            # test/bench-only injections (FaultPlan); never journaled
            kind, payload = args
            if kind == "sleep":
                time.sleep(float(payload))
            elif kind == "raise":
                raise RuntimeError(str(payload))
            elif kind == "exit":
                os._exit(int(payload))
            else:
                raise ValueError(f"unknown fault {kind!r}")
        elif cmd == "state":
            pass
        elif cmd == "stop":
            return None, False
        else:
            raise ValueError(f"unknown worker command {cmd!r}")
        return extra, True

    def take(self) -> Tuple[Tuple[float, str], ...]:
        done, self.completions[:] = tuple(self.completions), []
        return done

    def state(self) -> Tuple[float, Optional[float]]:
        return self.ctl.events.now, self.ctl.events.peek_t()


def _worker_main(conn, spec: ShardSpec) -> None:
    """Worker entrypoint: rebuild the shard controller over the thawed
    snapshot, then serve commands until EOF/stop. Every command gets
    exactly one reply — ``("ok", (now, peek_t), completions, extra)`` or
    ``("err", traceback_str, (), None)`` — so the coordinator can
    pipeline sends and drain acknowledgements lazily, and no completion
    notification is ever lost between quanta."""
    try:
        if spec.frozen is not None:
            field = install_frozen_default(spec.frozen)
        else:
            from repro_torch.core.carbon.field import default_field
            field = default_field()
        server = _ShardServer(spec, field=field)
    except Exception:  # noqa: BLE001 — ship the construction failure
        conn.send(("err", traceback.format_exc(), (), None))
        conn.close()
        return

    running = True
    while running:
        try:
            cmd, args = conn.recv()
        except (EOFError, OSError):
            break
        try:
            extra, running = server.apply(cmd, args)
            conn.send(("ok", server.state(), server.take(), extra))
        except Exception:  # noqa: BLE001 — report, keep serving
            conn.send(("err", traceback.format_exc(), (), None))
    conn.close()


class _ClockView:
    """Coordinator-side mirror of a worker's ``EventLoop`` clock: ``now``
    and ``peek_t()`` as of the last reply, plus exact optimistic updates
    for pipelined submits (the worker clock never advances between
    commands, so ``max(t, now)`` here equals the push the worker will
    do)."""

    def __init__(self) -> None:
        self.now = 0.0
        self._peek: Optional[float] = None

    def peek_t(self) -> Optional[float]:
        return self._peek

    def _sync(self, now: float, peek: Optional[float]) -> None:
        self.now = now
        self._peek = peek

    def _push_hint(self, t: float) -> None:
        t = max(t, self.now)
        self._peek = t if self._peek is None else min(self._peek, t)


class _WorkerHandle:
    """One worker process + its pipe, with lazy reply draining: ``send``
    pipelines a command, ``drain`` collects every outstanding reply in
    order (raising :class:`WorkerFailure`/:class:`WorkerDied`/
    :class:`WorkerTimeout` on the first problem), ``call`` is
    send-then-drain."""

    def __init__(self, ctx, spec: ShardSpec, name: str,
                 on_reply: Callable[[Tuple, Any], None],
                 timeout: Optional[float] = None):
        self.name = name
        self.timeout = timeout
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child, spec),
                                name=name, daemon=True)
        with warnings.catch_warnings():
            # Python warns that a multithreaded parent is forking; our fork
            # workers never touch CUDA (FORK_SAFE_BACKEND on the CPU),
            # which is the hazard that matters here
            warnings.simplefilter("ignore", DeprecationWarning)
            warnings.simplefilter("ignore", RuntimeWarning)
            self.proc.start()
        child.close()
        self.outstanding = 0
        self._on_reply = on_reply

    # pipelining cap: past this many unread acknowledgements the reply
    # pipe could fill and stall the worker's reply send — which would
    # stop it reading commands and deadlock both ends. Draining early
    # keeps both buffers bounded.
    _MAX_OUTSTANDING = 256

    def send(self, cmd: str, args: Any = None) -> None:
        if self.outstanding >= self._MAX_OUTSTANDING:
            self.drain()
        try:
            self.conn.send((cmd, args))
        except (BrokenPipeError, OSError) as e:
            # the worker died (or the pipe blipped): surface whatever it
            # managed to report — usually its unsolicited
            # construction-failure traceback — instead of a bare error
            self._surface_worker_error(e)
        self.outstanding += 1

    def _surface_worker_error(self, cause: BaseException) -> None:
        """Read any replies already in the pipe (solicited or the
        worker's unsolicited construction-failure report, which arrives
        with nothing outstanding) and raise the shipped traceback if one
        is found; otherwise raise :class:`WorkerDied`. Always raises."""
        try:
            while self.conn.poll(0.2):
                kind, state, done, _ = self.conn.recv()
                if self.outstanding:
                    self.outstanding -= 1
                if kind == "err":
                    raise WorkerFailure(
                        f"{self.name} failed:\n{state}") from cause
                self._on_reply(state, done)
        except (EOFError, OSError):
            pass
        raise WorkerDied(f"{self.name} died (exitcode "
                         f"{self.proc.exitcode})") from cause

    def _recv_reply(self) -> Tuple:
        """One reply, with liveness heartbeat + command deadline: polls
        with exponential backoff, detects a dead worker immediately
        (``is_alive`` heartbeat / pipe EOF) and a hung one after
        ``timeout`` seconds."""
        delay = 0.001
        deadline = None if self.timeout is None \
            else time.monotonic() + self.timeout
        while True:
            try:
                if self.conn.poll(delay):
                    return self.conn.recv()
            except (EOFError, OSError) as e:
                raise WorkerDied(
                    f"{self.name} died (exitcode {self.proc.exitcode}) "
                    f"with {self.outstanding} replies outstanding") from e
            if not self.proc.is_alive():
                # one last look: the worker may have replied, then exited
                try:
                    if self.conn.poll(0):
                        return self.conn.recv()
                except (EOFError, OSError):
                    pass
                raise WorkerDied(
                    f"{self.name} died (exitcode {self.proc.exitcode}) "
                    f"with {self.outstanding} replies outstanding")
            if deadline is not None and time.monotonic() >= deadline:
                raise WorkerTimeout(
                    f"{self.name} unresponsive for {self.timeout:.1f}s "
                    f"(heartbeat alive; {self.outstanding} replies "
                    f"outstanding)")
            delay = min(delay * 2, 0.25)

    def drain(self) -> Any:
        """Collect all outstanding replies in order; return the last
        reply's extra payload."""
        extra = None
        while self.outstanding:
            kind, state, done, extra = self._recv_reply()
            self.outstanding -= 1
            if kind == "err":
                raise WorkerFailure(f"{self.name} failed:\n{state}")
            self._on_reply(state, done)
        return extra

    def call(self, cmd: str, args: Any = None) -> Any:
        self.send(cmd, args)
        return self.drain()

    def close(self, timeout: float = 5.0) -> None:
        """Graceful stop, bounded: the stop handshake and its drain wait
        at most ``timeout``, then :meth:`_reap` escalates join →
        ``terminate()`` → ``kill()`` — a hung or dead worker can never
        wedge the coordinator's close path."""
        try:
            if self.proc.is_alive():
                saved, self.timeout = self.timeout, timeout
                try:
                    self.send("stop")
                    # drain every acknowledgement (including stop's)
                    # before closing our end: a healthy worker must never
                    # find a broken pipe under a reply it still owes
                    self.drain()
                except WorkerFailure:
                    pass
                finally:
                    self.timeout = saved
        except (OSError, ValueError):
            pass
        self._reap(timeout)

    def hard_close(self) -> None:
        """Immediate teardown of a broken worker: no stop handshake, just
        pipe close + terminate/kill escalation + fd reap."""
        self._reap(1.0)

    def _reap(self, timeout: float) -> None:
        try:
            self.conn.close()
        except (OSError, ValueError):
            pass
        try:
            self.proc.join(timeout)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(timeout)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout)
        except (OSError, ValueError, AssertionError):
            pass
        try:
            self.proc.close()      # reap the Process object and its fds
        except (OSError, ValueError):
            pass


class ShardProxy:
    """Coordinator-side stand-in for one shard's remote controller.

    Mimics exactly the slice of the :class:`FleetController` API the fleet
    callers use — ``submit`` / ``submit_many`` / ``inject_shock`` /
    ``pump`` / ``run``, an ``events`` clock view, and
    ``completion_hooks`` — so ``ShardedFleet`` routing and the
    ``StreamingGateway`` watermark pump drive a worker without knowing it
    is one. Completion notifications shipped by the worker re-fire through
    ``completion_hooks`` with the original :class:`TransferJob` (every
    submission passes through this proxy, so the job objects are at
    hand). All wire traffic routes through the runner's supervised
    ``_send``/``_drain``, so journaling and recovery are transparent
    here."""

    def __init__(self, runner: "ParallelShardRunner", idx: int):
        self._runner = runner
        self._idx = idx
        self.events = _ClockView()
        self.completion_hooks: List[Callable] = []
        self._jobs: Dict[str, Any] = {}
        self._pending: List[Tuple[float, str]] = []

    # --- wire plumbing ------------------------------------------------------
    @property
    def _handle(self) -> _WorkerHandle:
        return self._runner._handle(self._idx)

    def _on_reply(self, state: Tuple,
                  done: Tuple[Tuple[float, str], ...]) -> None:
        self.events._sync(*state)
        self._pending.extend(done)

    def _fire_completions(self) -> None:
        pending, self._pending = self._pending, []
        for t, uuid in pending:
            job = self._jobs.pop(uuid, None)
            if job is None:
                # fired before a fault — the recovery replay re-shipped
                # it; firing hooks twice would double-promote a capacity
                # slot, so completions dedupe on the popped job map
                continue
            for hook in self.completion_hooks:
                hook(t, job)

    # --- the controller API slice ------------------------------------------
    def submit(self, job, plan=None, at=None) -> None:
        self._jobs[job.uuid] = job
        self._runner._send(self._idx, "submit", (job, plan, at))
        t = job.submitted_t if at is None else max(at, job.submitted_t)
        self.events._push_hint(t)

    def submit_many(self, jobs: Sequence, plans: Optional[Sequence] = None
                    ) -> None:
        """Batched submission: ONE wire message however many jobs — the
        per-message pickle/syscall cost is what would otherwise dominate
        a large fleet's admission."""
        if plans is not None and len(plans) != len(jobs):
            raise ValueError(f"plans ({len(plans)}) must match jobs "
                             f"({len(jobs)})")
        if not jobs:
            return
        batch = []
        for i, job in enumerate(jobs):
            self._jobs[job.uuid] = job
            batch.append((job, plans[i] if plans is not None else None,
                          None))
            self.events._push_hint(job.submitted_t)
        self._runner._send(self._idx, "submit_many", batch)

    def inject_shock(self, t: float, factor: float, *,
                     duration_s: float = float("inf"),
                     zones: Optional[Sequence[str]] = None) -> None:
        self._runner._send(
            self._idx, "shock",
            (t, factor, duration_s,
             tuple(zones) if zones is not None else None))

    def pump(self, until: Optional[float] = None, *, strict: bool = False,
             horizon: Optional[float] = None) -> int:
        n = self._runner._call(self._idx, "pump", (until, strict, horizon))
        self._fire_completions()
        return n or 0

    def run(self, until: Optional[float] = None) -> FleetReport:
        report = self._runner._call(self._idx, "run", until)
        self._fire_completions()
        return report


class ShardSupervisor:
    """Per-runner recovery engine: journals, checkpoint baselines and the
    degradation ladder.

    Per-shard state machine::

        HEALTHY --(send/recv failure)--> BROKEN
        BROKEN  --(respawn + restore-from-checkpoint + journal replay,
                   worker errors downgrade batch backend -> numpy first,
                   except on a cuda shard, which keeps its backend)
                --> HEALTHY
        BROKEN  --(max_respawns exhausted)--> LOCAL
                   (the shard runs in-process from here on; faults no
                    longer apply to it; "parallel -> off" surfaced)

    Recovery is exact, not best-effort: controllers are deterministic
    functions of their command stream over a frozen field, so
    checkpoint + replay reconstructs the worker's state bit-identically,
    replies (clock syncs, completion notifications) re-flow through the
    proxy, and already-fired completions dedupe in
    :meth:`ShardProxy._fire_completions`. If even the in-process fallback
    fails (a deterministic error — e.g. bad controller kwargs — recurs on
    every rung), the *first* failure's traceback is what raises."""

    def __init__(self, runner: "ParallelShardRunner",
                 policy: SupervisionPolicy):
        self.runner = runner
        self.policy = policy
        n = len(runner.proxies)
        self.journals: List[List[Tuple[str, Any]]] = [[] for _ in range(n)]
        self.ckpts: List[Optional[bytes]] = [None] * n
        self.broken: Dict[int, WorkerFailure] = {}
        self.local: Dict[int, _ShardServer] = {}
        self._local_extra: Dict[int, Any] = {}
        self.degradations: List[str] = []
        self.recoveries: List[Dict[str, Any]] = []

    # --- in-process fallback execution --------------------------------------
    def local_apply(self, idx: int, cmd: str, args: Any) -> None:
        srv = self.local[idx]
        extra, _ = srv.apply(cmd, args)
        self.runner.proxies[idx]._on_reply(srv.state(), srv.take())
        self._local_extra[idx] = extra

    def pop_local_extra(self, idx: int) -> Any:
        return self._local_extra.pop(idx, None)

    # --- the ladder ---------------------------------------------------------
    def recover(self, idx: int, err: WorkerFailure) -> Any:
        runner, pol = self.runner, self.policy
        first = err
        t0 = time.perf_counter()
        attempts = 0
        for attempt in range(1, pol.max_respawns + 1):
            attempts = attempt
            spec = runner._specs[idx]
            if (type(err) is WorkerFailure
                    and spec.batch_backend != FORK_SAFE_BACKEND
                    and not spec.device.startswith("cuda")):
                # the worker *reported* an exception (it did not die): a
                # batch-backend fault is the expected cause — retry on the
                # pinned numpy oracle before blaming the process. A shard
                # on the card keeps its backend: planning it on numpy
                # would hide a failing kernel
                old = spec.batch_backend
                spec = dataclasses.replace(
                    spec, batch_backend=FORK_SAFE_BACKEND)
                runner._specs[idx] = spec
                self.degradations.append(
                    f"shard {idx}: batch backend {old} -> "
                    f"{FORK_SAFE_BACKEND} (worker-reported error)")
            runner._handles[idx].hard_close()
            time.sleep(pol.backoff_s * (2 ** (attempt - 1)))
            try:
                h = runner._spawn(idx)
                runner._handles[idx] = h
                if self.ckpts[idx] is not None:
                    h.call("restore", self.ckpts[idx])
                extra = None
                for cmd, args in self.journals[idx]:
                    extra = h.call(cmd, args)
                self.degradations.append(
                    f"shard {idx}: worker respawned after "
                    f"{type(err).__name__} (attempt {attempt}, replayed "
                    f"{len(self.journals[idx])} commands)")
                self.recoveries.append(dict(
                    shard=idx, outcome="respawn",
                    reason=type(first).__name__, attempts=attempt,
                    wall_s=time.perf_counter() - t0,
                    replayed=len(self.journals[idx]),
                    from_checkpoint=self.ckpts[idx] is not None))
                return extra
            except WorkerFailure as e:
                err = e
        # ladder exhausted: run the shard in the coordinator from here on
        runner._handles[idx].hard_close()
        try:
            srv = _ShardServer(runner._specs[idx])
            if self.ckpts[idx] is not None:
                srv.apply("restore", self.ckpts[idx])
            extra = None
            for cmd, args in self.journals[idx]:
                extra, _ = srv.apply(cmd, args)
        except Exception:
            # even in-process the shard cannot be rebuilt — this is a
            # deterministic failure; the first (fullest) traceback wins
            raise first
        self.local[idx] = srv
        runner.proxies[idx]._on_reply(srv.state(), srv.take())
        self.degradations.append(
            f"shard {idx}: parallel -> off (in-process fallback after "
            f"{attempts} failed respawns; first: {type(first).__name__})")
        self.recoveries.append(dict(
            shard=idx, outcome="local", reason=type(first).__name__,
            attempts=attempts, wall_s=time.perf_counter() - t0,
            replayed=len(self.journals[idx]),
            from_checkpoint=self.ckpts[idx] is not None))
        return extra


class ParallelShardRunner:
    """N persistent worker processes, one shard controller each.

    Workers start lazily at the first command, so the
    ``spec_factory`` — which freezes the coordinator field — runs *after*
    whatever warmed it (typically the fleet-level admission planning).
    ``pump_all``/``run_all`` are the barriers: one command to every
    worker, then replies drained in shard order (reports merge in shard
    order; completion hooks fire shard-major, matching the sequential
    run). A :class:`ShardSupervisor` journals every replayable command
    and walks the degradation ladder when a worker breaks; an optional
    :class:`FaultPlan` injects seeded faults at barrier quanta."""

    def __init__(self, n_shards: int,
                 spec_factory: Callable[[], Sequence[ShardSpec]], *,
                 mode: str = "auto",
                 supervision: Optional[SupervisionPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None):
        mode = resolve_mode(mode)
        if mode not in mp.get_all_start_methods():
            raise ValueError(f"start method {mode!r} not available "
                             f"(have {mp.get_all_start_methods()})")
        self.mode = mode
        self._spec_factory = spec_factory
        self.proxies = [ShardProxy(self, i) for i in range(n_shards)]
        self.supervision = supervision if supervision is not None \
            else SupervisionPolicy()
        self._sup = ShardSupervisor(self, self.supervision)
        if fault_plan is not None:
            if (any(a.kind == "hang" for a in fault_plan.actions)
                    and self.supervision.command_timeout_s is None):
                raise ValueError(
                    "hang faults need SupervisionPolicy.command_timeout_s "
                    "set — an unbounded drain would never detect them")
            for a in fault_plan.actions:
                if a.kind not in ("kill", "pipe", "hang", "backend"):
                    raise ValueError(f"unknown fault kind {a.kind!r}")
        self._fault_plan = fault_plan
        self._fault_cursor = 0
        self._quantum = 0
        self._last_ckpt_quantum = 0
        self._specs: Optional[List[ShardSpec]] = None
        self._handles: Optional[List[_WorkerHandle]] = None
        self._preload: Optional[List[Optional[bytes]]] = None
        self._closed = False

    @property
    def started(self) -> bool:
        return self._handles is not None

    @property
    def degradations(self) -> List[str]:
        """Human-readable ladder rungs taken so far, in order."""
        return list(self._sup.degradations)

    @property
    def recoveries(self) -> List[Dict[str, Any]]:
        """Structured recovery records (shard, outcome, reason, attempts,
        wall_s, replayed, from_checkpoint) — the bench's raw material."""
        return list(self._sup.recoveries)

    def _handle(self, idx: int) -> _WorkerHandle:
        if self._closed:
            raise RuntimeError(
                "ParallelShardRunner is closed — workers carry the shard "
                "state, so a closed fleet cannot be driven again; build a "
                "new ShardedFleet instead")
        if self._handles is None:
            specs = list(self._spec_factory())
            if len(specs) != len(self.proxies):
                raise ValueError(f"spec_factory returned {len(specs)} "
                                 f"specs for {len(self.proxies)} shards")
            self._specs = specs
            self._handles = [self._spawn(i) for i in range(len(specs))]
            if self._preload is not None:
                blobs, self._preload = self._preload, None
                for i, blob in enumerate(blobs):
                    if blob is not None:
                        self._handles[i].call("restore", blob)
                        self._sup.ckpts[i] = bytes(blob)
        return self._handles[idx]

    def _spawn(self, idx: int) -> _WorkerHandle:
        ctx = mp.get_context(self.mode)
        return _WorkerHandle(ctx, self._specs[idx],
                             f"shard-worker-{idx} ({self.mode})",
                             on_reply=self.proxies[idx]._on_reply,
                             timeout=self.supervision.command_timeout_s)

    # --- supervised wire plumbing -------------------------------------------
    def _send(self, idx: int, cmd: str, args: Any = None, *,
              journal: bool = True) -> None:
        sup = self._sup
        if journal and cmd in _REPLAYABLE:
            sup.journals[idx].append((cmd, args))
        if idx in sup.local:
            sup.local_apply(idx, cmd, args)
            return
        if idx in sup.broken:
            return     # journaled; recovery replays it at the drain
        h = self._handle(idx)
        try:
            h.send(cmd, args)
        except WorkerFailure as e:
            # defer recovery to the drain barrier so completion firing
            # stays shard-major and sends to healthy shards go out first
            sup.broken[idx] = e

    def _drain(self, idx: int) -> Any:
        sup = self._sup
        if idx in sup.local:
            return sup.pop_local_extra(idx)
        err = sup.broken.pop(idx, None)
        if err is not None:
            return sup.recover(idx, err)
        try:
            return self._handle(idx).drain()
        except WorkerFailure as e:
            return sup.recover(idx, e)

    def _call(self, idx: int, cmd: str, args: Any = None, *,
              journal: bool = True) -> Any:
        self._send(idx, cmd, args, journal=journal)
        return self._drain(idx)

    # --- fault injection ----------------------------------------------------
    def _apply_faults(self) -> None:
        if self._fault_plan is None:
            return
        if self._fault_cursor == 0:
            # plans may be hand-built unsorted; apply in quantum order
            self._fault_plan = dataclasses.replace(
                self._fault_plan,
                actions=tuple(sorted(self._fault_plan.actions,
                                     key=lambda a: (a.quantum, a.shard))))
        actions = self._fault_plan.actions
        while (self._fault_cursor < len(actions)
               and actions[self._fault_cursor].quantum <= self._quantum):
            a = actions[self._fault_cursor]
            self._fault_cursor += 1
            idx = a.shard % len(self.proxies)
            if idx in self._sup.local:
                continue               # faults target worker processes
            h = self._handle(idx)
            try:
                if a.kind == "kill":
                    if h.proc.is_alive():
                        os.kill(h.proc.pid, signal.SIGKILL)
                        h.proc.join(2.0)
                elif a.kind == "pipe":
                    try:
                        h.conn.close()
                    except (OSError, ValueError):
                        pass
                elif a.kind == "hang":
                    h.send("_fault", ("sleep", a.severity_s))
                elif a.kind == "backend":
                    h.send("_fault", ("raise",
                                      f"injected backend failure "
                                      f"(seed {self._fault_plan.seed})"))
            except WorkerFailure as e:
                self._sup.broken[idx] = e

    # --- checkpointing ------------------------------------------------------
    def checkpoint_all(self) -> List[bytes]:
        """Capture every shard's controller as one pickle blob each — the
        per-shard recovery baseline (journals truncate here) and
        ``persistence.capture``'s parallel path. Runs as its own barrier
        (call between quanta, not mid-pipeline), with the command sent to
        every worker before any reply is drained so the CPU-bound
        controller pickling overlaps across the pool instead of
        serializing through the coordinator."""
        n = len(self.proxies)
        for i in range(n):
            self._send(i, "checkpoint", journal=False)
        blobs = [self._finish_checkpoint(i, self._drain(i))
                 for i in range(n)]
        self._last_ckpt_quantum = self._quantum
        return blobs

    def _finish_checkpoint(self, idx: int, blob: Any,
                           _retried: bool = False) -> bytes:
        sup = self._sup
        if not isinstance(blob, (bytes, bytearray)):
            # a recovery replay hijacked the reply slot (checkpoint
            # commands are deliberately not journaled); the shard is
            # healthy again now, so one retry gets the real blob
            if _retried:
                raise RuntimeError(
                    f"shard {idx}: checkpoint produced "
                    f"{type(blob).__name__}, not bytes")
            return self._finish_checkpoint(
                idx, self._call(idx, "checkpoint", journal=False),
                _retried=True)
        sup.ckpts[idx] = bytes(blob)
        sup.journals[idx].clear()
        return bytes(blob)

    def _maybe_checkpoint(self) -> None:
        every = self.supervision.checkpoint_every
        if every and self._quantum - self._last_ckpt_quantum >= every:
            self.checkpoint_all()

    def preload(self, blobs: Sequence[Optional[bytes]]) -> None:
        """Arrange for each shard's controller to be restored from a
        checkpoint blob right after its worker starts (None entries start
        fresh) — ``persistence.restore``'s parallel path. Must be called
        before the first command."""
        if self._handles is not None or self._closed:
            raise RuntimeError("preload must run before the runner's "
                               "first command")
        if len(blobs) != len(self.proxies):
            raise ValueError(f"{len(blobs)} blobs for "
                             f"{len(self.proxies)} shards")
        self._preload = list(blobs)

    # --- barriers -----------------------------------------------------------
    def pump_all(self, until: Optional[float] = None, *,
                 strict: bool = False,
                 horizon: Optional[float] = None,
                 deadline_scale: float = 1.0) -> int:
        """One bounded time quantum across every shard: send the pump to
        all workers (they advance concurrently), then barrier on the
        replies in shard order and fire the shipped completion hooks
        shard-major. The quantum bound is exactly ``FleetController.pump``'s
        cut, so the monotone-clock contract holds per shard by
        construction.

        ``deadline_scale`` rescales each worker's per-command hang
        deadline for this barrier only — the adaptive pump schedule
        (``sharded.PumpQuanta``) covers far less sim time per quantum near
        a batch boundary, so a healthy worker replies proportionally
        faster and a hung one should be declared proportionally sooner.
        Coordinator-side bookkeeping only: nothing about it crosses the
        wire, so it cannot perturb worker determinism."""
        self._apply_faults()
        for i in range(len(self.proxies)):
            self._send(i, "pump", (until, strict, horizon))
        saved: List[Tuple[_WorkerHandle, float]] = []
        if deadline_scale != 1.0 and self._handles is not None:
            for h in self._handles:
                if h.timeout is not None:
                    saved.append((h, h.timeout))
                    # floor: even a near-empty quantum pays fixed IPC cost
                    h.timeout = max(h.timeout * deadline_scale, 0.05)
        try:
            total = 0
            for i in range(len(self.proxies)):
                total += self._drain(i) or 0
        finally:
            for h, t in saved:
                h.timeout = t
        for p in self.proxies:
            p._fire_completions()
        self._quantum += 1
        self._maybe_checkpoint()
        return total

    def run_all(self, until: Optional[float] = None) -> List[FleetReport]:
        """Drain every shard to ``until`` concurrently; reports come back
        in shard order (the sequential merge order)."""
        self._apply_faults()
        for i in range(len(self.proxies)):
            self._send(i, "run", until)
        reports: List[FleetReport] = [self._drain(i)
                                      for i in range(len(self.proxies))]
        for p in self.proxies:
            p._fire_completions()
        self._quantum += 1
        return reports

    def close(self) -> None:
        """Stop and join every worker (idempotent; escalates to
        terminate/kill on a hung worker — see ``_WorkerHandle.close``).
        The workers carry the shard state, so the runner refuses further
        commands once closed."""
        self._closed = True
        handles, self._handles = self._handles, None
        self._sup.local.clear()
        self._sup.broken.clear()
        if handles:
            for h in handles:
                h.close()

    def __del__(self) -> None:  # best-effort; close() is the real API
        # interpreter shutdown may already have None'd module globals and
        # reaped children; a half-constructed runner (__init__ raised
        # before _closed existed) must be a no-op, and nothing may escape
        try:
            if getattr(self, "_closed", True):
                return
            self.close()
        except BaseException:  # noqa: BLE001
            pass
