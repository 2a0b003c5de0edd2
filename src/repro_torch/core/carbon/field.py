"""Vectorized carbon-field engine: the port's numpy oracle.

A copy of the reference's ``CarbonField`` (``repro.core.carbon.field``)
reduced to what fleet admission planning reads: per-zone traces as numpy
ufuncs over time arrays with the blake2b weather-band noise hashed once
per (zone, hour), per-path hop CI matrices, and the prefix-sum emission
integral that scores every candidate start slot of a leg in one pass,
plus the scalar fast paths (``*_scalar``) that the fleet controller's
per-step accounting and the transfer engine's congestion trace read.
The planner's batched paths (``grid_torch``, ``grid_cuda``) read their
noise tables and device weights from here and are held against it.

Snapshots cross process boundaries: :meth:`CarbonField.freeze` cuts a
picklable :class:`FrozenField` that worker processes, the streaming
gateway's batch planner and checkpoints thaw into a field answering
bit-identically, and :func:`register_field_setup` records the topology
installs (the zone lattice, ingested traces) a spawn worker replays first.

Every method reproduces the scalar reference (``intensity.GridRegion.ci``,
``path.Hop.ci``, ``score.transfer_emissions_g_reference``) within float
tolerance. ``default_field()`` is the process-wide instance the scheduler
stack shares, so planner, time-shift and overlay hit one noise cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.carbon.energy import (HOP_CLASSES, HostPowerModel,
                                            classify_hop, hop_power_w)
from repro_torch.core.carbon.intensity import REGIONS, get_calibration
from repro_torch.core.carbon.path import NetworkPath

ArrayLike = Union[float, Sequence[float], np.ndarray]


class _NoiseTable:
    """Per-key hourly noise in [0, 1), hashed once per (key, hour).

    Each key stores one contiguous hour range [h0, h0+n) as a dense array;
    a query inside the known range is a single fancy index, a query outside
    extends the range by hashing only the missing hours. Time windows are
    contiguous, so the dense range costs no meaningful extra hashing and
    turns the hot-path lookup into pure array indexing.
    """

    def __init__(self, fmt: str):
        self._fmt = fmt                                   # e.g. "{k}:{h}"
        self._h0: Dict[str, int] = {}
        self._vals: Dict[str, np.ndarray] = {}

    def _hash(self, key: str, hour: int) -> float:
        d = hashlib.blake2b(self._fmt.format(k=key, h=hour).encode(),
                            digest_size=8).digest()
        return int.from_bytes(d, "big") / 2**64

    def _hash_range(self, key: str, lo: int, hi: int) -> np.ndarray:
        return np.array([self._hash(key, h) for h in range(lo, hi)])

    # widest dense range kept per key (one year of hours): a stray query far
    # from the working window must not trigger a megahash gap-fill on the
    # process-wide shared field.
    _MAX_SPAN = 24 * 366

    def lookup(self, key: str, hour_idx: np.ndarray) -> np.ndarray:
        h_lo = int(hour_idx.min())
        h_hi = int(hour_idx.max()) + 1
        if h_hi - h_lo > self._MAX_SPAN:
            # pathologically spread query: hash just the distinct hours,
            # leave the dense cache untouched
            uniq, inv = np.unique(hour_idx, return_inverse=True)
            vals = np.array([self._hash(key, int(h)) for h in uniq])
            return vals[inv].reshape(hour_idx.shape)
        h0 = self._h0.get(key)
        if h0 is not None and (h_lo < h0 - self._MAX_SPAN
                               or h_hi > h0 + len(self._vals[key])
                               + self._MAX_SPAN):
            # far from the cached window: re-anchor instead of gap-filling
            del self._h0[key], self._vals[key]
            h0 = None
        if h0 is None:
            self._h0[key] = h0 = h_lo
            self._vals[key] = self._hash_range(key, h_lo, h_hi)
        vals = self._vals[key]
        if h_lo < h0:
            vals = np.concatenate([self._hash_range(key, h_lo, h0), vals])
            self._h0[key], self._vals[key] = h_lo, vals
            h0 = h_lo
        if h_hi > h0 + len(vals):
            vals = np.concatenate(
                [vals, self._hash_range(key, h0 + len(vals), h_hi)])
            self._vals[key] = vals
        return vals[hour_idx - h0]

    def lookup_scalar(self, key: str, idx: int) -> float:
        """Single-index fast path for per-step hot loops (the transfer
        engine's congestion trace): a hit in the dense range is one int
        index, a miss falls back to the ranged lookup (which extends the
        cache, so the miss happens once per window)."""
        h0 = self._h0.get(key)
        if h0 is not None:
            vals = self._vals[key]
            off = idx - h0
            if 0 <= off < len(vals):
                return float(vals[off])
        return float(self.lookup(key, np.asarray([idx]))[0])

    def snapshot(self) -> Tuple[Tuple[str, int, np.ndarray], ...]:
        """The cached ranges as an immutable (key, h0, vals) tuple — the
        arrays are never mutated in place (extension rebinds), so sharing
        them with a snapshot is safe."""
        return tuple((k, self._h0[k], self._vals[k]) for k in self._h0)

    def restore(self, snap: Sequence[Tuple[str, int, np.ndarray]]) -> None:
        for key, h0, vals in snap:
            self._h0[key] = int(h0)
            self._vals[key] = np.asarray(vals)


# --- topology setup replay -------------------------------------------------
# Zones registered at runtime (the mesoscale lattice, ingested traces) are
# module state *outside* the field's caches: REGIONS entries, IP/endpoint
# registries, route providers. A spawn worker starts from a clean
# interpreter, so a FrozenField alone cannot make its queries resolve —
# the registrations must replay there. Subsystems record a deterministic,
# picklable (entrypoint, args) step here; freeze() captures the list and
# thaw() replays it (idempotently) before restoring the caches.
_FIELD_SETUP: List[Tuple[str, Tuple]] = []


def register_field_setup(entrypoint: str, *args) -> None:
    """Record a topology-install step (``"pkg.module:function"`` + args,
    all picklable) to replay in any process that thaws a frozen field cut
    after this call. Duplicate records collapse."""
    if ":" not in entrypoint:
        raise ValueError(f"entrypoint must be 'module:function', got "
                         f"{entrypoint!r}")
    entry = (entrypoint, tuple(args))
    if entry not in _FIELD_SETUP:
        _FIELD_SETUP.append(entry)


def replay_field_setup(entries: Sequence[Tuple[str, Tuple]]) -> None:
    """Run recorded setup steps (import + call; each step is idempotent by
    contract) and adopt them into this process's own record so a chained
    freeze keeps carrying them."""
    for entrypoint, args in entries:
        mod_name, fn_name = entrypoint.split(":", 1)
        getattr(importlib.import_module(mod_name), fn_name)(*args)
        entry = (entrypoint, tuple(args))
        if entry not in _FIELD_SETUP:
            _FIELD_SETUP.append(entry)


class CarbonField:
    """Broadcastable CI queries + prefix-sum emission integrals.

    One instance owns the noise/trace caches; use :func:`default_field` to
    share it across the scheduler stack.
    """

    _GRID_CACHE_MAX = 128              # ~8×3k f64 per entry ≈ 190 KiB

    def __init__(self, calibrated: bool = True):
        self.calibrated = calibrated
        self._zone_noise = _NoiseTable("{k}:{h}")      # GridRegion._noise
        self._hop_noise = _NoiseTable("{k}:{h}")       # Hop.ci hourly band
        self._hop_base: Dict[str, float] = {}          # Hop.ci per-ip band
        self._hop_grid_cache: Dict[Tuple, np.ndarray] = {}
        self._weight_fn_cache: Dict[Tuple, Callable] = {}

    # --- zone level --------------------------------------------------------
    def ci(self, zones: Union[str, Sequence[str]], ts: ArrayLike,
           calibrated: Optional[bool] = None) -> np.ndarray:
        """CI for one zone or a stack of zones: shape (n_zones,) + ts.shape
        (the leading axis is dropped when ``zones`` is a single string)."""
        if isinstance(zones, str):
            return self.zone_ci(zones, ts, calibrated)
        return np.stack([self.zone_ci(z, ts, calibrated) for z in zones])

    def zone_ci(self, zone: str, ts: ArrayLike,
                calibrated: Optional[bool] = None) -> np.ndarray:
        """Vectorized ``GridRegion.ci`` (plus optional paper calibration).

        Operation order deliberately mirrors the scalar reference so results
        agree to float rounding, not just modeling intent.
        """
        r = REGIONS[zone]
        ts = np.asarray(ts, dtype=np.float64)
        hour_idx = np.floor(ts / 3600.0).astype(np.int64)
        h_of_day = (ts / 3600.0) % 24.0
        dow = np.floor(ts / 86400.0).astype(np.int64) % 7
        v = r.base_ci + r.diurnal_amp * np.cos(
            2 * np.pi * (h_of_day - r.peak_hour) / 24.0)
        v = v - r.solar_dip * np.exp(-0.5 * ((h_of_day - 13.0) / 2.5) ** 2)
        v = np.where((dow == 5) | (dow == 6), v * 0.94, v)
        u = self._zone_noise.lookup(zone, hour_idx)
        v = v + r.noise * ((u - 0.5) * 2.0)
        v = np.maximum(v, 1.0)
        if calibrated is None:
            calibrated = self.calibrated
        if calibrated:
            a, b = get_calibration()
            v = np.maximum(a * v + b, 0.5)
        return v

    def zone_ci_scalar(self, zone: str, t: float,
                       calibrated: Optional[bool] = None) -> float:
        """Scalar fast path of :meth:`zone_ci` for per-step hot loops (the
        fleet controller's emission accounting samples one instant per
        step): pure ``math`` ops, noise via the shared cached table. Same
        formula and operation order as the array path / scalar reference.
        """
        r = REGIONS[zone]
        h_of_day = (t / 3600.0) % 24.0
        v = r.base_ci + r.diurnal_amp * math.cos(
            2 * math.pi * (h_of_day - r.peak_hour) / 24.0)
        v -= r.solar_dip * math.exp(-0.5 * ((h_of_day - 13.0) / 2.5) ** 2)
        if int(t // 86400.0) % 7 in (5, 6):
            v *= 0.94
        u = self._zone_noise.lookup_scalar(zone, int(t // 3600.0))
        v += r.noise * ((u - 0.5) * 2.0)
        v = max(v, 1.0)
        if calibrated is None:
            calibrated = self.calibrated
        if calibrated:
            a, b = get_calibration()
            v = max(a * v + b, 0.5)
        return v

    def path_ci_scalar(self, path: NetworkPath, t: float,
                       zone_scale: Optional[Callable[[str], float]] = None
                       ) -> float:
        """Scalar fast path of :meth:`path_ci` (one time point).

        ``zone_scale`` multiplies each zone's CI (the control plane's
        forecast-drift injection); None leaves the forecast trace as-is."""
        cache: Dict[str, float] = {}
        tot = 0.0
        for h in path.hops:
            ci = cache.get(h.zone)
            if ci is None:
                ci = self.zone_ci_scalar(h.zone, t)
                if zone_scale is not None:
                    ci *= zone_scale(h.zone)
                cache[h.zone] = ci
            tot += ci
        return tot / path.n_hops

    def hop_ci_scalar(self, ip: str, zone_ci: float, t: float) -> float:
        """One device's CI given its zone CI (``hop_ci_matrix`` semantics
        for a single (hop, time) cell)."""
        u = self._hop_noise.lookup_scalar(ip, int(t // 3600.0)) - 0.5
        return zone_ci * (1.0 + 0.02 * self._hop_band(ip) + 0.005 * u)

    def path_device_rate_scalar(self, path: NetworkPath,
                                weights: np.ndarray, t: float,
                                zone_scale: Optional[Callable[[str], float]]
                                = None) -> float:
        """sum_i weights_i x device-CI_i at one instant (the per-step
        emission-rate numerator, W x gCO2/kWh): the scalar counterpart of
        ``weights @ hop_ci_matrix(path, [t])``."""
        cache: Dict[str, float] = {}
        acc = 0.0
        for i, h in enumerate(path.hops):
            zci = cache.get(h.zone)
            if zci is None:
                zci = self.zone_ci_scalar(h.zone, t)
                if zone_scale is not None:
                    zci *= zone_scale(h.zone)
                cache[h.zone] = zci
            acc += float(weights[i]) * self.hop_ci_scalar(h.ip, zci, t)
        return acc

    # --- path level --------------------------------------------------------
    def path_ci(self, path: NetworkPath, ts: ArrayLike) -> np.ndarray:
        """Vectorized ``NetworkPath.ci``: mean calibrated zone CI over hops.
        Zones repeat along a path, so each unique zone is evaluated once and
        weighted by its hop count."""
        counts: Dict[str, int] = {}
        for h in path.hops:
            counts[h.zone] = counts.get(h.zone, 0) + 1
        ts = np.asarray(ts, dtype=np.float64)
        acc = np.zeros(ts.shape)
        for zone, n in counts.items():
            acc = acc + n * self.zone_ci(zone, ts, calibrated=True)
        return acc / path.n_hops

    def _hop_band(self, ip: str) -> float:
        ub = self._hop_base.get(ip)
        if ub is None:
            d = hashlib.blake2b(ip.encode(), digest_size=8).digest()
            ub = int.from_bytes(d, "big") / 2**64 - 0.5
            self._hop_base[ip] = ub
        return ub

    def hop_ci_matrix(self, path: NetworkPath, ts: ArrayLike) -> np.ndarray:
        """Per-device CI (``Hop.ci``, i.e. zone CI × sub-metering band) for
        every hop at every time: shape (n_hops, n_ts)."""
        ts = np.asarray(ts, dtype=np.float64)
        hour_idx = np.floor(ts / 3600.0).astype(np.int64)
        zone_rows = {z: self.zone_ci(z, ts, calibrated=True)
                     for z in {h.zone for h in path.hops}}
        rows: List[np.ndarray] = []
        for h in path.hops:
            u = self._hop_noise.lookup(h.ip, hour_idx) - 0.5
            rows.append(zone_rows[h.zone]
                        * (1.0 + 0.02 * self._hop_band(h.ip) + 0.005 * u))
        return np.stack(rows)

    def _hop_ci_grid(self, path: NetworkPath, t0: float, dt_s: float,
                     n: int) -> np.ndarray:
        """``hop_ci_matrix`` on the arithmetic grid t0 + dt_s·[0, n), cached
        per (path, t0, dt_s). A shorter grid is a prefix of a longer one, so
        the planner's (FTN × replica) cells that share a path leg reuse one
        evaluation even when their slot counts differ."""
        key = (path.src, path.dst, path.hops, t0, dt_s)
        arr = self._hop_grid_cache.get(key)
        if arr is None or arr.shape[1] < n:
            arr = self.hop_ci_matrix(path, t0 + dt_s * np.arange(n))
            if len(self._hop_grid_cache) >= self._GRID_CACHE_MAX:
                self._hop_grid_cache.pop(next(iter(self._hop_grid_cache)))
            self._hop_grid_cache[key] = arr
        return arr[:, :n]

    # --- scheduler-facing queries -----------------------------------------
    def expected_transfer_ci(self, path: NetworkPath, t0s: ArrayLike,
                             duration_s: float, step_s: float = 900.0
                             ) -> np.ndarray:
        """Vectorized ``time_shift.expected_transfer_ci`` over many start
        times at once (same midpoint sampling rule)."""
        t0s = np.atleast_1d(np.asarray(t0s, dtype=np.float64))
        if duration_s <= 0:
            return self.path_ci(path, t0s)
        n = max(int(duration_s // step_s), 1)
        off = (np.arange(n) + 0.5) * duration_s / n
        tt = t0s[:, None] + off[None, :]
        vals = self.path_ci(path, tt.ravel()).reshape(tt.shape)
        return vals.sum(axis=1) / n

    def transfer_emissions_g(self, path: NetworkPath, sender: HostPowerModel,
                             receiver: HostPowerModel, bytes_moved: float,
                             t0s: ArrayLike, throughput_gbps: float, *,
                             parallelism: int = 1, concurrency: int = 1,
                             dt_s: float = 60.0) -> np.ndarray:
        """gCO₂eq of the transfer for every candidate start in ``t0s``.

        The scalar reference integrates P·CI in dt_s steps per start. Here
        the weighted emission *rate* r(t) = Σ_dev P_dev·CI_dev(t)/3.6e6 is
        evaluated once on a shared dt_s grid spanning all starts; per-start
        emissions are then differences of its prefix sum plus one partial
        last step — the grid is reused across all starts of the scan.
        """
        t0s = np.atleast_1d(np.asarray(t0s, dtype=np.float64))
        if throughput_gbps <= 0:
            return np.full(t0s.shape, np.inf)
        duration_s = bytes_moved * 8.0 / (throughput_gbps * 1e9)
        n_steps = max(int(math.ceil(duration_s / dt_s - 1e-12)), 1)
        rem = duration_s - (n_steps - 1) * dt_s
        offsets = (t0s - t0s.min()) / dt_s
        k = np.rint(offsets).astype(np.int64)
        w = self._device_weights(path, sender, receiver, throughput_gbps,
                                 parallelism, concurrency)
        if offsets.size and np.max(np.abs(offsets - k)) < 1e-9:
            # starts sit on a common dt_s grid (the planner's slot scan):
            # one rate evaluation + one cumsum covers every start.
            M = self._hop_ci_grid(path, float(t0s.min()), dt_s,
                                  int(k.max()) + n_steps)
            r = (w @ M) / 3.6e6
            prefix = np.concatenate([[0.0], np.cumsum(r)])
            full = (prefix[k + n_steps - 1] - prefix[k]) * dt_s
            return full + r[k + n_steps - 1] * rem
        # unaligned starts: dense (starts × steps) evaluation, still one call
        tt = t0s[:, None] + dt_s * np.arange(n_steps)[None, :]
        rr = ((w @ self.hop_ci_matrix(path, tt.ravel())) / 3.6e6
              ).reshape(tt.shape)
        weights = np.full(n_steps, dt_s)
        weights[-1] = rem
        return rr @ weights


    def _device_weights(self, path: NetworkPath, sender: HostPowerModel,
                        receiver: HostPowerModel, throughput_gbps: float,
                        parallelism: int, concurrency: int) -> np.ndarray:
        """Per-hop power draw (W): end systems by the [14] utilization
        model, intermediate devices by per-bit line-rate share."""
        w = np.empty(path.n_hops)
        w[0] = sender.transfer_power_w(throughput_gbps,
                                       parallelism=parallelism,
                                       concurrency=concurrency)
        w[-1] = receiver.transfer_power_w(throughput_gbps,
                                          parallelism=parallelism,
                                          concurrency=concurrency)
        for i, hop in enumerate(path.hops[1:-1], start=1):
            w[i] = hop_power_w(hop.info.org, throughput_gbps)
        return w

    def device_weight_fn(self, path: NetworkPath, sender: HostPowerModel,
                         receiver: HostPowerModel, parallelism: int,
                         concurrency: int
                         ) -> Callable[[ArrayLike], np.ndarray]:
        """:meth:`_device_weights` with the route baked in: returns a
        cached ``gbps -> (n_hops,)`` (or ``(n_gbps,) -> (n_hops, n_gbps)``)
        closure over precomputed per-hop coefficient arrays. The fleet
        controller's per-step emission accounting calls this on whole step
        vectors; the scalar result is float-identical to
        :meth:`_device_weights` (same clamp and summation order).
        """
        # discover_path memoizes NetworkPath instances, so identity is a
        # stable key (hashing the hops tuple is the hot-path cost here)
        key = (id(path), sender.name, receiver.name,
               parallelism, concurrency)
        fn = self._weight_fn_cache.get(key)
        if fn is not None:
            return fn
        n = path.n_hops
        idle, cw, mw, nw = (np.zeros(n) for _ in range(4))
        den = np.ones(n)
        c0 = 0.05 + 0.02 * (parallelism * concurrency)
        for j, host in ((0, sender), (n - 1, receiver)):
            idle[j], cw[j], mw[j], nw[j] = (host.idle_w, host.cpu_w,
                                            host.mem_w, host.nic_w)
            den[j] = host.nic_speed_gbps
        for j, hop in enumerate(path.hops[1:-1], start=1):
            c = HOP_CLASSES[classify_hop(hop.info.org)]
            nw[j], den[j] = c["port_w"], c["line_gbps"]

        def w_of(gbps: ArrayLike, _idle=idle, _cw=cw, _mw=mw, _nw=nw,
                 _den=den, _c0=c0) -> np.ndarray:
            g = np.asarray(gbps, dtype=np.float64)
            if g.ndim:                 # (hops, n_gbps) for step vectors
                _idle, _cw, _mw, _nw = (x[:, None] for x in
                                        (_idle, _cw, _mw, _nw))
                _den = _den[:, None]
            u_cpu = np.minimum(_c0 + (0.4 * g) / _den, 1.0)
            u_mem = np.minimum(0.10 + (0.05 * g) / _den, 1.0)
            u_nic = np.minimum(g / _den, 1.0)
            return (_idle
                    + _cw * np.minimum(np.maximum(u_cpu, 0.0), 1.0)
                    + _mw * np.minimum(np.maximum(u_mem, 0.0), 1.0)
                    + _nw * u_nic)

        if len(self._weight_fn_cache) >= self._GRID_CACHE_MAX:
            self._weight_fn_cache.pop(next(iter(self._weight_fn_cache)))
        self._weight_fn_cache[key] = w_of
        return w_of

    def __getstate__(self) -> Dict:
        """Pickle support for checkpoints (``controlplane.persistence``):
        the noise/band anchors travel — they are what make a restored
        field's queries bit-identical without re-hashing — while the pure
        caches are dropped (the weight-fn cache holds closures, and both
        rebuild on demand to the same floats)."""
        d = self.__dict__.copy()
        d["_hop_grid_cache"] = {}
        d["_weight_fn_cache"] = {}
        return d

    def freeze(self, *, include_grids: bool = True) -> "FrozenField":
        """A pickle-cheap, read-only snapshot of this field's warmed state:
        the hashed noise ranges, per-device bands and (optionally) the
        prefix-sum hop-CI grids. A worker process thaws it into a field
        whose every query is bit-identical to this one's without re-hashing
        a single (key, hour). The snapshot aliases the live arrays (they
        are never mutated in place; cache extension rebinds), so freezing
        is O(cached keys), not O(bytes)."""
        grids: Tuple[Tuple[Tuple, np.ndarray], ...] = ()
        if include_grids:
            grids = tuple(self._hop_grid_cache.items())
        return FrozenField(
            calibrated=self.calibrated,
            zone_noise=self._zone_noise.snapshot(),
            hop_noise=self._hop_noise.snapshot(),
            hop_base=tuple(self._hop_base.items()),
            grids=grids,
            setup=tuple(_FIELD_SETUP))


@dataclasses.dataclass(frozen=True)
class FrozenField:
    """What :meth:`CarbonField.freeze` returns: immutable, picklable, and
    cheap to thaw. ``zone_noise``/``hop_noise`` are the dense hashed
    ranges ((key, h0, vals) per key), ``hop_base`` the per-IP sub-metering
    bands, ``grids`` the prefix-sum hop-CI grid cache (keyed by hashable
    path identity, so a thawed field's grid lookups hit by value), and
    ``setup`` the recorded :func:`register_field_setup` steps that thaw
    replays before any query runs."""
    calibrated: bool
    zone_noise: Tuple[Tuple[str, int, np.ndarray], ...]
    hop_noise: Tuple[Tuple[str, int, np.ndarray], ...]
    hop_base: Tuple[Tuple[str, float], ...]
    grids: Tuple[Tuple[Tuple, np.ndarray], ...] = ()
    setup: Tuple[Tuple[str, Tuple], ...] = ()

    def thaw(self) -> CarbonField:
        """Rebuild a warm :class:`CarbonField` from the snapshot."""
        replay_field_setup(self.setup)
        f = CarbonField(calibrated=self.calibrated)
        f._zone_noise.restore(self.zone_noise)
        f._hop_noise.restore(self.hop_noise)
        f._hop_base = dict(self.hop_base)
        for key, arr in self.grids:    # freeze() is bounded by the cap
            f._hop_grid_cache[key] = arr
        return f

    @property
    def nbytes(self) -> int:
        """Payload size (the spawn-worker shipping cost)."""
        return (sum(v.nbytes for _, _, v in self.zone_noise)
                + sum(v.nbytes for _, _, v in self.hop_noise)
                + sum(a.nbytes for _, a in self.grids))


_DEFAULT: Optional[CarbonField] = None
_DEFAULT_PID: Optional[int] = None
_DEFAULT_FROZEN: Optional[FrozenField] = None


def install_frozen_default(frozen: FrozenField) -> CarbonField:
    """Make ``frozen`` the source of this process's default field: thaw it
    now and remember it, so a later process boundary (a fork of *this*
    process) rebuilds from the same snapshot. Worker entrypoints call this
    before touching any scheduler code — it is what guarantees a worker's
    ``default_field()`` is warm and value-identical to the coordinator's
    instead of a silently re-hashed divergent copy."""
    global _DEFAULT, _DEFAULT_PID, _DEFAULT_FROZEN
    _DEFAULT_FROZEN = frozen
    _DEFAULT = frozen.thaw()
    _DEFAULT_PID = os.getpid()
    return _DEFAULT


def default_field() -> CarbonField:
    """The process-wide shared field (one noise/trace cache for planner,
    time/space/overlay shifting).

    Fork/spawn safety: the cache is stamped with the pid that built it. A
    worker that inherited module state across a fork rebuilds from the
    frozen snapshot registered by :func:`install_frozen_default`, if any;
    otherwise it adopts the inherited copy-on-write state as its own. A
    spawn worker starts with a clean module and gets a warm field only
    through ``install_frozen_default``, which the worker runner's
    entrypoint calls."""
    global _DEFAULT, _DEFAULT_PID
    if _DEFAULT is not None and _DEFAULT_PID != os.getpid():
        _DEFAULT = _DEFAULT_FROZEN.thaw() \
            if _DEFAULT_FROZEN is not None else _DEFAULT
        _DEFAULT_PID = os.getpid()
    if _DEFAULT is None:
        _DEFAULT = CarbonField()
        _DEFAULT_PID = os.getpid()
    return _DEFAULT
